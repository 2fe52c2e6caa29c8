"""The port's experiments and the App's menu against the JAX package on the
CPU: `compute_metrics`, `select_samples_for_gt_test` (with and without
`persist`) and `gt_test` equal; `train_pose_estimation_exp` of the port on
64x48 frames (N=64, M=48, batch 2, one epoch a run), then `eval_exp` of
both packages over its runs (f32 networks): results within 2e-4; the
curves' summary equal; `App.visualise` and `App.main` with scripted input
showing the same frames and printing the same menu as the JAX App."""
import functools
import os
import shutil
import sys
import types
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoposeestimation_tpu import main as jmain
from autoposeestimation_tpu.experiments import gt_test as jgt
from autoposeestimation_tpu.experiments import sweeps as jsweeps
from autoposeestimation_tpu.models import densefusion as jdf
from autoposeestimation_tpu.train import checkpoints as jcheckpoints
from autoposeestimation_tpu.train import densefusion as jdft
from autoposeestimation_tpu_torch import main as pmain
from autoposeestimation_tpu_torch.experiments import gt_test, sweeps
from autoposeestimation_tpu_torch.train import checkpoints
from autoposeestimation_tpu_torch.train import densefusion as dft
from autoposeestimation_tpu_torch.utils import io, synthetic
from test_torch_models import init_vars
from test_torch_seg_models import two_threads  # noqa: F401

DS, N, M, B = "synth", 64, 48, 2
ATOL = 2e-4     # network outputs, the torch-vs-flax figure


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Two objects, 8 views each at 64x48 (half of them in the pose
    dataset's test split), with ground-truth masks beside
    the labels: the gen labels with 2 % of their pixels flipped, the pred
    labels with 10 %."""
    root = str(tmp_path_factory.mktemp("experiments"))
    synthetic.make_dataset(root, cfg=synthetic.SynthConfig(
        n_viewpoints=8, img_h=48, img_w=64, fx=56.0, fy=56.0), p_test=0.5)
    rng = np.random.default_rng(0)
    for obj in ("red_ball", "blue_ball"):
        d = os.path.join(io.label_dir(root), obj, "foreground")
        for vp in range(8):
            stem = os.path.join(d, f"{vp:06d}")
            gen = io.read_label(stem + ".gen.label.png")
            io.write_png(stem + ".gt.label.png", np.where(
                rng.random(gen.shape) < 0.02, 255 - gen, gen).astype(np.uint8))
            io.write_png(stem + ".pred.label.png", np.where(
                rng.random(gen.shape) < 0.1, 255 - gen, gen).astype(np.uint8))
    return root


# --- gt_test -----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_compute_metrics(seed):
    rng = np.random.default_rng(seed)
    pred = (rng.random((20, 30)) < 0.3 * seed).astype(np.uint8) * 255
    gt = (rng.random((20, 30)) < 0.4).astype(np.uint8) * 255
    assert gt_test.compute_metrics(pred, gt) == jgt.compute_metrics(pred, gt)


@pytest.mark.parametrize("p,seed", [(0.2, 0), (0.5, 3), (0.01, 1)])
def test_select_samples(root, p, seed):
    objects = ["red_ball", "blue_ball"]
    assert gt_test.select_samples_for_gt_test(root, objects, p, seed) == \
        jgt.select_samples_for_gt_test(root, objects, p, seed)


def test_select_samples_persisted(root, tmp_path):
    """Each package marks its copy's metas, and its second call reuses the
    marks (a seed that would draw others)."""
    objects = ["red_ball", "blue_ball"]
    copies = {name: str(tmp_path / name) for name in ("jax", "port")}
    for path in copies.values():
        shutil.copytree(os.path.join(root, "data_generation"),
                        os.path.join(path, "data_generation"))
    first = gt_test.select_samples_for_gt_test(copies["port"], objects, 0.3,
                                               persist=True)
    assert first == jgt.select_samples_for_gt_test(copies["jax"], objects,
                                                   0.3, persist=True)
    assert gt_test.select_samples_for_gt_test(
        copies["port"], objects, 0.3, seed=9, persist=True) == first
    assert jgt.select_samples_for_gt_test(
        copies["jax"], objects, 0.3, seed=9, persist=True) == first
    for obj in objects:
        run = os.path.join(io.data_dir(copies["port"]), obj, "foreground")
        for stem in io.list_sample_ids(run):
            metas = [io.read_json(os.path.join(
                io.data_dir(c), obj, "foreground", stem + ".meta.json"))
                for c in (copies["port"], copies["jax"])]
            assert metas[0] == metas[1]
            assert metas[0].get("gt_test_sample", False) == (
                f"{obj}/foreground/{stem}" in first)


@pytest.mark.parametrize("samples", [None, "all"])
def test_gt_test(root, samples):
    objects = ["red_ball", "blue_ball"]
    if samples == "all":
        samples = [f"{o}/foreground/{vp:06d}" for o in objects
                   for vp in range(8)] + ["red_ball/foreground/000099"]
    got = gt_test.gt_test(root, objects, samples=samples)
    want = jgt.gt_test(root, objects, samples=samples)
    assert sorted(got) == sorted(want) == ["gen", "new_pred", "pred"]
    for mode in want:
        np.testing.assert_equal(got[mode], want[mode])
    assert got["pred"]["iou"] < got["gen"]["iou"] < 1.0


# --- sweeps ------------------------------------------------------------------

def jax_trainer(num_obj, cfg=None, crop=320, dtype=None, seed=0):
    """The JAX trainer in f32 whose variables are drawn with numpy (no
    flax init compile); eval_exp overwrites them from the checkpoints."""
    jpose = jdf.PoseNet(num_obj=num_obj, dtype=jnp.float32)
    jref = jdf.PoseRefineNet(num_obj=num_obj, dtype=jnp.float32)
    cloud = np.zeros((1, cfg.num_points, 3), np.float32)
    obj = np.zeros((1,), np.int32)
    pose_vars = init_vars(jpose, np.zeros((1, 48, 48, 3), np.float32), cloud,
                          np.zeros((1, cfg.num_points), np.int32), obj)
    ref_vars = init_vars(jref, cloud, np.zeros((1, cfg.num_points, 32),
                                               np.float32), obj)
    return jdft.TrainerState(cfg, jpose, jref, pose_vars, ref_vars, None,
                             None, lr=cfg.lr, w=cfg.w)


@pytest.fixture(scope="module")
def sweep(root, tmp_path_factory):
    """The port's sweep over p_viewpoints (1.0, 0.5) of 'gen' labels, one
    epoch a run, the second run with a refiner phase checkpoint."""
    out_base = str(tmp_path_factory.mktemp("runs"))
    cfg = dft.DFConfig(num_points=N, num_points_mesh=M, batch_size=B)
    stats = sweeps.train_pose_estimation_exp(
        root, DS, p_viewpoints_grid=(1.0, 0.5), label_modes=("gen",),
        epochs=2, cfg=cfg, out_base=out_base, device="cpu")
    return out_base, cfg, stats


def test_sweep_runs(sweep):
    out_base, cfg, stats = sweep
    assert [r["name"] for r in stats["runs"]] == ["pv1.0_pe0.0_gen",
                                                  "pv0.5_pe0.0_gen"]
    assert io.read_json(os.path.join(out_base, "sweep_stats.json")) == stats
    for run in stats["runs"]:
        assert np.isfinite(run["best_test"]) and run["seconds"] > 0
        ckpt = checkpoints.load_checkpoint(os.path.join(
            out_base, run["name"], "pose_model"))
        assert ckpt["meta"]["epoch"] == 1


def recording(mod, calls):
    """The package's eval_step_full, recording each batch's distances."""
    step = mod.eval_step_full

    def run(*args, **kw):
        out = step(*args, **kw)
        calls.append(np.asarray(out[0].cpu() if torch.is_tensor(out[0])
                                else out[0]))
        return out
    return run


def test_eval_exp_both_packages(root, sweep, monkeypatch):
    """eval_exp of each package over the port's runs, with a refiner
    checkpoint that the JAX package writes added to the second run: every
    distance within 2e-4, the counts equal unless a distance lies within
    2e-4 of the 2 cm threshold."""
    out_base, cfg, _ = sweep
    ref = jdf.PoseRefineNet(num_obj=2, dtype=jnp.float32)
    cloud = np.zeros((1, N, 3), np.float32)
    jcheckpoints.save_checkpoint(
        os.path.join(out_base, "pv0.5_pe0.0_gen", "pose_refine_model"),
        init_vars(ref, cloud, np.zeros((1, N, 32), np.float32),
                  np.zeros((1,), np.int32), seed=5), {"epoch": 1})
    jdis, pdis = [], []
    monkeypatch.setattr(jdft, "create_trainer", jax_trainer)
    monkeypatch.setattr(jdft, "eval_step_full", recording(jdft, jdis))
    monkeypatch.setattr(dft, "create_trainer", functools.partial(
        dft.create_trainer, dtype=torch.float32))
    monkeypatch.setattr(dft, "eval_step_full", recording(dft, pdis))
    jcfg = jdft.DFConfig(num_points=N, num_points_mesh=M, batch_size=B)
    want = jsweeps.eval_exp(root, DS, runs_dir=out_base, exp_name="j",
                            cfg=jcfg)
    got = sweeps.eval_exp(root, DS, runs_dir=out_base, exp_name="p", cfg=cfg,
                          device="cpu")
    j, p = np.concatenate(jdis), np.concatenate(pdis)
    assert p.shape == j.shape == (16,)
    np.testing.assert_allclose(p, j, atol=ATOL)
    near = bool(np.any(np.abs(j - 0.02) < ATOL))
    assert sorted(got) == sorted(want) == ["pv0.5_pe0.0_gen",
                                           "pv1.0_pe0.0_gen"]
    for run in want:
        assert sorted(got[run]) == sorted(want[run])
        for cls, vals in want[run].items():
            for key, val in vals.items():
                if key in ("dis", "t_err"):
                    np.testing.assert_allclose(got[run][cls][key], val,
                                               atol=ATOL)
                elif not near:
                    assert got[run][cls][key] == val, (run, cls, key)
    assert io.read_json(os.path.join(out_base, "p_exp_eval_results.json")) \
        == got
    assert os.path.exists(os.path.join(out_base, "j_exp_eval_results.json"))


def test_plot_pose_exp_results(sweep):
    out_base, _, _ = sweep
    got = sweeps.plot_pose_exp_results(out_base)
    assert got == jsweeps.plot_pose_exp_results(out_base)
    assert sorted(got) == ["pv0.5_pe0.0_gen", "pv1.0_pe0.0_gen"]
    assert all(v["n_epochs"] == 1 for v in got.values())


# --- the App's menu ----------------------------------------------------------

def fake_matplotlib(shown):
    """matplotlib.pyplot stand-in whose imshow records the frame."""
    plt = types.SimpleNamespace(imshow=shown.append, pause=lambda s: None)
    return {"matplotlib": types.SimpleNamespace(pyplot=plt),
            "matplotlib.pyplot": plt}


@pytest.mark.parametrize("kind", ["0", "1"])
def test_app_visualise(root, kind):
    """The kind and object chosen in the TUI; the same frames and lines."""
    outs = []
    for app_cls in (jmain.App, pmain.App):
        frames, said = [], []
        script = iter([kind, "1"])
        app = app_cls(root, input_fn=lambda q: next(script),
                      print_fn=said.append)
        n = app.visualise(show=frames.append)
        outs.append((n, frames, said))
    (n, frames, said), (jn, jframes, jsaid) = outs[1], outs[0]
    assert n == jn == 8 and said == jsaid
    for a, b in zip(frames, jframes):
        np.testing.assert_array_equal(a, b)


def test_app_main_menu(root):
    """visualise -> segmentation masks -> the first object, then quit:
    the default show draws through matplotlib (a recording stand-in)."""
    outs = []
    for app_cls in (jmain.App, pmain.App):
        shown, said = [], []
        script = iter(["7", "0", "0", "bogus", "10"])
        with mock.patch.dict(sys.modules, fake_matplotlib(shown)):
            app_cls(root, input_fn=lambda q: next(script),
                    print_fn=said.append).main()
        outs.append((shown, said))
    (shown, said), (jshown, jsaid) = outs[1], outs[0]
    assert said == jsaid and len(shown) == len(jshown) == 8
    assert said.count("Select action:") == 3 and "invalid choice" in said
    for a, b in zip(shown, jshown):
        np.testing.assert_array_equal(a, b)
