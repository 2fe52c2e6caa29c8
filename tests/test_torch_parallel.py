"""The port's data x tensor parallelism (`parallel/`) on the CPU, gloo
ranks spawned by `parallel/dryrun.py::run_ranks` (rank bodies in
`tests/_torch_parallel_ranks.py`, one torch thread each, a FileStore under
the test's tmp_path, 60 s to form the group and a deadline to finish), each
against one rank or the JAX package:

  * `auto_mesh`'s modes and `make_mesh`'s refusal;
  * BatchNorm synced over 2 ranks against one rank on the whole batch:
    outputs, input gradients and running statistics within 1e-6;
  * a 2-rank `estimator_step` from JAX-carried weights: the all-reduced
    gradients within 1e-5 of one rank's (relative to each leaf's largest
    entry), the parameters within `test_torch_training.py`'s Adam bound
    of JAX's single-device step; a ragged batch of 3 replicated;
  * 4 ranks at data 2 x model 2: evaluation within 1e-5, estimator and
    refiner losses within rtol 1e-4 of one rank's (as JAX's
    `test_tp_sharding_correctness`), gnorm within 1e-5 relative;
  * `train()` and `segmentation_training()` with `data_parallel="on"` on 2
    ranks against "off", at JAX's own bounds (`test_parallel.py`):
    parameters within 1e-4, best_test rel 1e-4, best_iou abs 2e-2; only
    rank 0 writes;
  * `get_surfaces_batched(mesh=)` and `load_point_cloud(mesh=)`, and the
    port's view-sharded cloud against the JAX package's view-sharded cloud
    (8 virtual CPU devices) to `test_load_point_cloud_against_jax`'s
    bounds; the ICP merge at which phase 15's 12-view sharded and
    streaming runs part, bistable in both packages;
  * `parallel/trainers.py` on one rank;
  * `dryrun_multichip` on 2 and 4 ranks."""
import os
import shutil

import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import _torch_open_checks as open_checks
import _torch_parallel_ranks as ranks
from autoposeestimation_tpu.utils import synthetic as jsyn
from autoposeestimation_tpu_torch.parallel import dryrun
from autoposeestimation_tpu_torch.parallel import mesh as pmesh
from autoposeestimation_tpu_torch.parallel import trainers
from autoposeestimation_tpu_torch.reconstruction import create_pointcloud as rec
from autoposeestimation_tpu_torch.utils import io
from test_torch_reconstruction import SETTINGS, ball, mean_and_max_nn
from test_torch_training import (LR, NUM_OBJ, W, assert_updated_close,
                                 leaves, make_batch, optax_step)
from test_torch_training import setup  # noqa: F401  (a fixture)

GRAD_RTOL = 1e-5      # all-reduced against one rank, of a leaf's largest
BN_ATOL = 1e-6
LOSS_RTOL = 1e-4      # JAX's test_tp_sharding_correctness
GNORM_RTOL = 1e-5
EVAL_ATOL = 1e-5
ENTRY_ATOL = 1e-4     # JAX's test_parallel.py entry-point bounds
IOU_ATOL = 2e-2


def run(fn, n, *args, tmp_path, timeout_s=240.0):
    return dryrun.run_ranks(fn, n, args, backend="gloo", threads=1,
                            timeout_s=timeout_s, workdir=str(tmp_path))


def one_rank(fn, *args, threads=1):
    """`fn(*args)` here, with no group, on one torch thread as the ranks
    run (the same reduction orders), or on `threads`."""
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(saved)


@pytest.fixture
def no_group(monkeypatch):
    """No process group and no torchrun environment; any group a test
    starts is destroyed after it."""
    for name in ("MASTER_ADDR", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_auto_mesh_modes(no_group):
    assert pmesh.auto_mesh("off") is None
    assert pmesh.auto_mesh("auto", device="cpu") is None
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="data_parallel"):
        pmesh.auto_mesh("many")
    mesh = pmesh.auto_mesh("on", device="cpu")        # starts a group
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    assert mesh.device == torch.device("cpu")
    # one rank is up: 'auto' stays off, 'on' builds on it
    assert pmesh.auto_mesh("auto") is None
    assert pmesh.auto_mesh("on").shape == mesh.shape
    batch = {"a": np.arange(6).reshape(3, 2), "s": np.float32(2.0)}
    assert pmesh.shard_batch_data(mesh, batch)["a"].shape == (3, 2)
    assert pmesh.shard_batch(mesh, batch)["s"] == 2.0


def test_make_mesh_refuses_indivisible_model_parallel(no_group):
    with pytest.raises(ValueError, match="not divisible by model=2"):
        pmesh.make_mesh(3, model_parallel=2)
    pmesh.auto_mesh("on", device="cpu")
    with pytest.raises(ValueError, match="not divisible by model=2"):
        pmesh.make_mesh(model_parallel=2)
    with pytest.raises(ValueError, match="has 1 ranks, not 2"):
        pmesh.make_mesh(2)


def test_dropout_rows_are_the_single_device_mask():
    from autoposeestimation_tpu_torch.models.pspnet import dropout

    x = torch.randn(6, 4, 5, 5)
    whole = dropout(x, 0.3, torch.Generator().manual_seed(1))
    for lo, hi in ((0, 3), (3, 6), (2, 4)):
        part = dropout(x[lo:hi], 0.3, torch.Generator().manual_seed(1),
                       rows=(6, lo))
        assert torch.equal(part, whole[lo:hi])


def test_synced_batchnorm_equals_one_rank(tmp_path):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 3, 5, 6)) * 2 + 1).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    scale, bias = (rng.uniform(0.5, 1.5, 3).astype(np.float32),
                   rng.normal(size=3).astype(np.float32))
    want = one_rank(ranks.synced_batchnorm, x, cot, scale, bias)
    got = run(ranks.synced_batchnorm, 2, x, cot, scale, bias,
              tmp_path=tmp_path)
    for name in ("y", "x_grad"):
        np.testing.assert_allclose(np.concatenate([g[name] for g in got]),
                                   want[name], atol=BN_ATOL, err_msg=name)
    for g in got:
        for name in ("running_mean", "running_var"):
            np.testing.assert_allclose(g[name], want[name], atol=BN_ATOL,
                                       err_msg=name)
    # each rank's parameter gradient is its rows' share
    for name in ("weight_grad", "bias_grad"):
        np.testing.assert_allclose(sum(g[name] for g in got), want[name],
                                   atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def estimator_runs(setup, tmp_path_factory):  # noqa: F811
    """The estimator step from JAX's weights on one rank and on two, for
    the fixture's batch of 2 and a ragged batch of 3."""
    gnorm = float(optax.global_norm(setup["grads"]))
    batch = setup["batch"]
    ragged = {k: np.concatenate([v, v[:1]]) for k, v in batch.items()}
    args = (NUM_OBJ, setup["pose_vars"], {"even": batch, "ragged": ragged},
            LR, 2.0 * gnorm, W)
    one = one_rank(ranks.estimator_steps, *args)
    two = run(ranks.estimator_steps, 2, *args,
              tmp_path=tmp_path_factory.mktemp("est"))
    return gnorm, one, two


def test_estimator_step_two_ranks(setup, estimator_runs):  # noqa: F811
    gnorm, one, two = estimator_runs
    want_params = optax_step(setup["pose_vars"]["params"], setup["grads"],
                             2.0 * gnorm)
    for g in two:
        got = g["even"]
        for path, a, b in leaves(got["grads"], one["even"]["grads"]):
            np.testing.assert_allclose(a, b, atol=GRAD_RTOL * max(
                np.abs(b).max(), 1e-6), err_msg=str(path))
        for key in ("loss", "dis", "gnorm"):
            np.testing.assert_allclose(got["metrics"][key],
                                       one["even"]["metrics"][key],
                                       rtol=GNORM_RTOL, err_msg=key)
        np.testing.assert_allclose(got["metrics"]["gnorm"], gnorm,
                                   rtol=1e-4)
        assert_updated_close(got["vars"], setup["pose_vars"]["params"],
                             want_params, "two ranks")
    # both ranks took the same step
    for path, a, b in leaves(two[0]["even"]["vars"], two[1]["even"]["vars"]):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_ragged_batch_is_replicated(estimator_runs):
    _, one, two = estimator_runs
    for g in two:
        got, want = g["ragged"], one["ragged"]
        assert got["metrics"] == want["metrics"]
        for path, a, b in leaves(got["vars"], want["vars"]):
            np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_dp_tp_four_ranks_match_one(tmp_path):
    batch = {k: np.concatenate([v, v]) for k, v in make_batch(3).items()}
    one = one_rank(ranks.dp_tp_steps, NUM_OBJ, batch, LR, W, 1)
    four = run(ranks.dp_tp_steps, 4, NUM_OBJ, batch, LR, W, 2,
               tmp_path=tmp_path)
    for got in four:
        # every rank exports the same full weights
        for kind in ("pose_vars", "refine_vars"):
            for path, a, b in leaves(got[kind], four[0][kind]):
                np.testing.assert_array_equal(a, b, err_msg=str(path))
        assert got["conv6_rows"] == 512          # 1024 over 'model' = 2
        for name, want in one["eval"].items():
            np.testing.assert_allclose(got["eval"][name], want,
                                       atol=EVAL_ATOL, err_msg=name)
        for key in ("loss", "dis", "refine_dis"):
            np.testing.assert_allclose(got[key], one[key], rtol=LOSS_RTOL,
                                       err_msg=key)
        np.testing.assert_allclose(got["gnorm"], one["gnorm"],
                                   rtol=GNORM_RTOL)
        # the export gathers the shards: full weights within Adam's step
        for kind in ("pose_vars", "refine_vars"):
            for path, a, b in leaves(got[kind], one[kind]):
                assert a.shape == b.shape, path
                assert np.abs(a - b).max() <= 2 * LR, path


def seg_batches():
    rng = np.random.default_rng(5)
    return [{"image": rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
             "label": rng.integers(0, 3, (8, 32, 32)).astype(np.int32)}
            for _ in range(2)]


def pose_batches(num_obj, n, m, crop):
    out = []
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        out.append({
            "img": rng.normal(size=(8, crop, crop, 3)).astype(np.float32),
            "cloud": (rng.normal(size=(8, n, 3)) * 0.05).astype(np.float32),
            "choose": rng.integers(0, crop * crop, (8, n)).astype(np.int32),
            "target": (rng.normal(size=(8, m, 3)) * 0.05).astype(np.float32),
            "model_points": (rng.normal(size=(8, m, 3)) * 0.05).astype(
                np.float32),
            "obj_idx": rng.integers(0, num_obj, 8).astype(np.int32),
            "is_sym": np.zeros(8, bool)})
    return out


def test_train_on_matches_off(tmp_path):
    shape = (2, 24, 24, 16)
    batches = pose_batches(*shape)
    off = one_rank(ranks.train_pose, "off", *shape, batches,
                   str(tmp_path / "off"))
    on = run(ranks.train_pose, 2, "on", *shape, batches,
             str(tmp_path / "on"), tmp_path=tmp_path)
    assert [r["writes"] for r in on] == [off["writes"], 0]
    assert sorted(os.listdir(tmp_path / "on")) == sorted(
        os.listdir(tmp_path / "off"))
    for r in on:
        assert r["best_test"] == pytest.approx(off["best_test"], rel=1e-4)
        for path, a, b in leaves(r["vars"], off["vars"]):
            np.testing.assert_allclose(a, b, atol=ENTRY_ATOL,
                                       err_msg=str(path))


def test_segmentation_training_on_matches_off(tmp_path):
    batches = seg_batches()
    off = one_rank(ranks.train_segmentation, "off", batches,
                   str(tmp_path / "off"))
    on = run(ranks.train_segmentation, 2, "on", batches,
             str(tmp_path / "on"), tmp_path=tmp_path)
    assert [r["writes"] for r in on] == [off["writes"], 0]
    for r in on:
        assert r["best_iou"] == pytest.approx(off["best_iou"], abs=IOU_ATOL)
        for path, a, b in leaves(r["vars"], off["vars"]):
            np.testing.assert_allclose(a, b, atol=ENTRY_ATOL,
                                       err_msg=str(path))


def disk_views():
    """5 views of a disk on a bumpy plane, rotated and moved (JAX's
    `test_reconstruction_surfaces_view_sharded`)."""
    h, w = 64, 80
    yy, xx = np.mgrid[0:h, 0:w]
    labels, depths, r2cs = [], [], []
    for i in range(5):
        disk = (yy - 30 - 2 * i) ** 2 + (xx - 40 + 3 * i) ** 2 < 15 ** 2
        labels.append(disk.astype(np.int32))
        depths.append(np.where(disk, 500.0 + 5.0 * np.sin(yy * 0.3)
                               + 3.0 * np.cos(xx * 0.2), 0.0))
        ang = 0.3 * i
        t = np.eye(4)
        t[:3, :3] = [[np.cos(ang), -np.sin(ang), 0.0],
                     [np.sin(ang), np.cos(ang), 0.0], [0.0, 0.0, 1.0]]
        t[:3, 3] = [10.0 * i, -5.0 * i, 3.0]
        r2cs.append(t)
    intr = {"fx": 70.0, "fy": 70.0, "ppx": w / 2.0, "ppy": h / 2.0}
    return (labels, depths, intr, r2cs), dict(
        min_friends=5, min_dist=8.0, nb_neighbors=5, voxel_size=3.0,
        cap=1024)


def test_reconstruction_view_sharded(tmp_path):
    """V = 5 views over 2 ranks (padded to 6) equal the unsharded surfaces
    exactly; `load_point_cloud(mesh=)` of a JAX-written 160x128 dataset on
    2 ranks equals it on one rank (the same artifacts, byte for byte), and
    the streaming per-view run within the reconstruction tests' bounds."""
    views, kw = disk_views()
    want = rec.get_surfaces_batched(*views, **kw, device="cpu")
    jsyn.make_dataset(str(tmp_path / "base"), objects=[ball(jsyn)],
                      cfg=jsyn.SynthConfig(n_viewpoints=5))
    for name in ("one", "two", "stream"):
        shutil.copytree(tmp_path / "base", tmp_path / name)
    one = run(ranks.reconstruct, 1, views, kw, str(tmp_path / "one"),
              SETTINGS, tmp_path=tmp_path)[0]
    two = run(ranks.reconstruct, 2, views, kw, str(tmp_path / "two"),
              SETTINGS, tmp_path=tmp_path)
    for got in [one] + two:
        assert len(got["surfaces"]) == 5
        for a, b in zip(got["surfaces"], want):
            assert len(b) > 50
            np.testing.assert_array_equal(a, b)
    for got in two:
        np.testing.assert_array_equal(got["cloud"], one["cloud"])
    files = sorted(os.listdir(io.pc_dir(str(tmp_path / "one")) + "/ball"))
    assert len(files) == 7
    for fn in files:
        a = os.path.join(io.pc_dir(str(tmp_path / "two")), "ball", fn)
        b = os.path.join(io.pc_dir(str(tmp_path / "one")), "ball", fn)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), fn
    root = str(tmp_path / "stream")
    stream = rec.load_point_cloud("ball", io.pc_dir(root), root, **SETTINGS,
                                  device="cpu")
    assert abs(len(stream) - len(one["cloud"])) <= 0.02 * len(stream)
    assert mean_and_max_nn(one["cloud"], stream)[0] <= 0.05 * 3


def test_view_sharded_reconstruction_against_jax(tmp_path, no_group):
    """`load_point_cloud(mesh=)` of the JAX-written 160x128 ball (5 views)
    in both packages (`_torch_open_checks.sharded`): the port's on a
    one-rank group (equal to two ranks' by
    `test_reconstruction_view_sharded`), JAX's over the 8 virtual CPU
    devices (views padded to 8), its ICP through `nn_pallas(interpret=
    True)`. The clouds agree as the streaming ones do
    (`test_load_point_cloud_against_jax`: equal counts, mean NN 1e-3 mm,
    worst 1e-2 mm). Each package's own sharded-against-streaming gap is
    measured from the shell (`_torch_open_checks.py sharded 5` and `12`)."""
    out = one_rank(open_checks.sharded, str(tmp_path), 5, False, threads=2)
    got, want = out["clouds"]["port sharded"], out["clouds"]["jax sharded"]
    assert len(got) == len(want) > 300
    mean, worst = out["port_vs_jax_sharded_mm"].values()
    print(f"view-sharded, port against JAX: {len(got)} points, mean "
          f"{mean:.2e} mm, worst {worst:.2e} mm")
    assert mean <= 1e-3 and worst <= 1e-2, (mean, worst)


def test_sharded_and_streaming_part_at_a_bistable_merge(tmp_path):
    """At 12 views (phase 15's configuration) the port's view-sharded and
    streaming clouds part by 0.76 mm (symmetric mean NN) where the JAX
    package's stay within 1e-4 mm (`_torch_open_checks.py sharded 12`).
    They part at the fourth ICP merge of the run, whose inputs differ by
    6e-5 mm. That merge is bistable in both packages: on the port's inputs
    moved by 1e-5 mm of noise, JAX's ICP lands on either of two transforms
    0.032 apart, as the port's does, and every transform of the port's is
    one of JAX's (within 1e-4). Which branch a run takes is rounding: the
    gap is shared, not a fault of the sharded path."""
    tfs = one_rank(open_checks.merge_transforms,
                   *one_rank(open_checks.merge_inputs, str(tmp_path),
                             threads=2), threads=2)
    jumps = {pkg: [float(np.abs(tf - v[0]).max()) for tf in v]
             for pkg, v in tfs.items()}
    print(f"bistable merge, each transform against the unperturbed one: "
          f"{jumps}")
    for pkg in ("jax", "port"):
        assert max(jumps[pkg]) >= 1e-2, pkg
    for tf in tfs["port"]:
        assert min(float(np.abs(tf - j).max()) for j in tfs["jax"]) <= 1e-4


def test_trainers_module_on_one_rank(no_group):
    """`parallel/trainers.py::run_trainers` at toy shapes on a one-rank
    gloo group in this process: both trainers run with data_parallel 'on'
    and report their parameters, curves and samples a second, and
    `compare` of a run with itself is zero. (Two and four ranks against
    one: `python -m autoposeestimation_tpu_torch.parallel.trainers 4 toy`
    on the CPU, and on the cards; `test_train_on_matches_off` and
    `test_segmentation_training_on_matches_off` hold the trainers on 2
    ranks.)"""
    one = one_rank(trainers.run_trainers, "toy", 1, "cpu", threads=2)
    assert one["ranks"] == 1 and one["backend"] == "gloo"
    report = trainers.compare(one, one)
    for name in ("pose", "seg"):
        assert report[name]["max_param_diff"] == 0.0
        assert report[name]["leaves"] > 50
        assert all(r > 0 for r in report[name]["samples_per_s"])
        assert np.isfinite(one[name]["curves"]["epoch_seconds"]).all()
    assert report["pose"]["best_test_rel"] == 0.0
    assert np.isfinite(one["pose"]["best_test"])
    assert 0.0 <= one["seg"]["best_iou"] <= 1.0


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, tmp_path, capfd):
    out = dryrun.dryrun_multichip(n, "toy", backend="gloo", timeout_s=240,
                                  workdir=str(tmp_path))
    model = 2
    assert [r["ranks"] for r in out] == [n] * n
    assert all(r["data"] == n // model and r["model"] == model for r in out)
    for r in out[1:]:
        assert r["loss"] == out[0]["loss"]
        assert r["gnorm"] == out[0]["gnorm"]
        np.testing.assert_array_equal(r["positions"], out[0]["positions"])
    assert np.isfinite(out[0]["loss"]) and out[0]["recon_views"] == n
    assert out[0]["positions"].shape == (n, 2, 3)
    assert out[0]["out_sharded"] == (n // model > 1)
    assert f"dryrun_multichip ok: {n} devices" in capfd.readouterr().out
