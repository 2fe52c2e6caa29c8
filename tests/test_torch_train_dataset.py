"""The port's DenseFusion training from the on-disk dataset against the JAX
package, on the CPU at a small size (2 objects, 160x128 frames, crop 32,
N=64, M=48, batch 2, f32, dropout off on both sides as in
test_torch_training.py): `train()` fed by each package's `Loader` through
both phases, with its `trainer_resume.npz` snapshots crossing between the
packages and an exact resume; `warm_start` from an upstream-named `.pth`;
`pointcloud2image` and `dump_pose_images`; and the port's
`App.train_pose_estimation` end to end."""
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from autoposeestimation_tpu.data import loader as jloader
from autoposeestimation_tpu.data import pose_dataset as jpd
from autoposeestimation_tpu.models import densefusion as jdf
from autoposeestimation_tpu.pipeline import visualize as jvis
from autoposeestimation_tpu.train import checkpoints as jcheckpoints
from autoposeestimation_tpu.train import densefusion as jdft
from autoposeestimation_tpu.utils import io as jio
from autoposeestimation_tpu.utils import synthetic as jsyn
from autoposeestimation_tpu_torch import weights
from autoposeestimation_tpu_torch.data import loader, pose_dataset
from autoposeestimation_tpu_torch.main import App
from autoposeestimation_tpu_torch.models import densefusion
from autoposeestimation_tpu_torch.pipeline import visualize
from autoposeestimation_tpu_torch.train import checkpoints
from autoposeestimation_tpu_torch.train import densefusion as dft
from test_torch_models import init_vars

DS, B, CROP, N, M, NUM_OBJ = "synth", 2, 32, 64, 48, 2
# network outputs and the curves they give, torch vs flax in f32: the
# figure of test_torch_training.py's train() comparison
ATOL = 2e-4
EPOCHS = 3          # epochs 1 (estimator) and 2 (refiner)


def config(**kw):
    return {**dict(batch_size=B, num_points=N, num_points_mesh=M,
                   refine_epoch_margin=1, sym_bf16=False), **kw}


def datasets(mod, root):
    """(train, test, test with raw frames) of package `mod`."""
    return (mod.PoseDataset(root, DS, mode="train", num_pt=N, num_pt_mesh=M,
                            crop=CROP),
            mod.PoseDataset(root, DS, mode="test", num_pt=N, num_pt_mesh=M,
                            crop=CROP),
            mod.PoseDataset(root, DS, mode="test", num_pt=N, num_pt_mesh=M,
                            crop=CROP, return_raw=True))


def loaders(mod, sets):
    train_ds, test_ds, image_ds = sets
    return dict(
        train_batches=lambda: mod.Loader(train_ds, B, num_workers=0),
        test_batches=lambda: mod.Loader(test_ds, B, shuffle=False,
                                        drop_last=False, num_workers=0),
        image_batches=lambda: mod.Loader(image_ds, B, shuffle=False,
                                         drop_last=False, num_workers=0))


def jax_state(pose_vars, ref_vars, **kw):
    """A JAX TrainerState on given variables (no flax init compile)."""
    cfg = jdft.DFConfig(data_parallel="off", **config(**kw))
    tx = jdft.make_optimizer(cfg.lr, cfg.grad_clip)
    return jdft.TrainerState(
        cfg, jdf.PoseNet(num_obj=NUM_OBJ, dtype=jnp.float32),
        jdf.PoseRefineNet(num_obj=NUM_OBJ, dtype=jnp.float32),
        jax.tree_util.tree_map(jnp.asarray, pose_vars),
        jax.tree_util.tree_map(jnp.asarray, ref_vars), tx,
        tx.init(pose_vars["params"]), lr=cfg.lr, w=cfg.w)


def port_state(pose_vars, ref_vars, **kw):
    """A port TrainerState on given variables, assembled as create_trainer
    assembles it (without its random init, which they replace)."""
    cfg = dft.DFConfig(**config(**kw))
    posenet = densefusion.PoseNet(NUM_OBJ)
    refiner = densefusion.PoseRefineNet(NUM_OBJ)
    posenet.load_state_dict(weights.posenet_state_dict(pose_vars))
    refiner.load_state_dict(weights.refiner_state_dict(ref_vars))
    posenet.cnn.dropout_rates = (0.0, 0.0, 0.0)
    return dft.TrainerState(
        cfg, posenet, refiner,
        dft.make_optimizer(posenet.parameters(), cfg.lr, cfg.grad_clip),
        torch.device("cpu"), lr=cfg.lr, w=cfg.w)


class NoDropout(nn.Module):
    """flax's Dropout at rate 0 (the JAX trainer's masks cannot be drawn
    in torch)."""
    rate: float = 0.0
    deterministic: bool = True

    def __call__(self, x, deterministic=None, rng=None):
        return x


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One dataset, carried initial weights, and two-epoch train() runs of
    both packages, each fed by its own Loader, writing where
    App.train_pose_estimation writes."""
    base = tmp_path_factory.mktemp("train_ds")
    root = str(base / "root")
    jsyn.make_dataset(root, cfg=jsyn.SynthConfig(n_viewpoints=6))
    jpose = jdf.PoseNet(num_obj=NUM_OBJ, dtype=jnp.float32)
    jref = jdf.PoseRefineNet(num_obj=NUM_OBJ, dtype=jnp.float32)
    img = np.zeros((1, CROP, CROP, 3), np.float32)
    cloud = np.zeros((1, N, 3), np.float32)
    obj = np.zeros((1,), np.int32)
    pose_vars = init_vars(jpose, img, cloud, np.zeros((1, N), np.int32), obj,
                          seed=1)
    ref_vars = init_vars(jref, cloud, np.zeros((1, N, 32), np.float32), obj,
                         seed=2)
    # the refiner's last layers as both trainers initialize them (zero
    # kernel, identity bias: an untrained refiner leaves the pose as it is)
    for head, ident in (("RefineHead_0", [1.0, 0.0, 0.0, 0.0]),
                        ("RefineHead_1", [0.0, 0.0, 0.0])):
        last = ref_vars["params"][head]["Dense_2"]
        last["kernel"] = np.zeros_like(last["kernel"])
        last["bias"] = np.tile(np.float32(ident), NUM_OBJ)
    out = {"root": root, "pose_vars": pose_vars, "ref_vars": ref_vars,
           "jpose": jpose}
    for name in ("jax", "port"):
        out_dir = str(base / name / "DenseFusion" / "trained_models" / DS)
        images = os.path.join(out_dir, "logs", "images")
        if name == "jax":
            from autoposeestimation_tpu.models import pspnet as jpspnet
            mp = pytest.MonkeyPatch()
            mp.setattr(jpspnet.nn, "Dropout", NoDropout)
            try:
                state = jdft.train(
                    jax_state(pose_vars, ref_vars),
                    out_dir=out_dir, epochs=EPOCHS, image_dump_dir=images,
                    **loaders(jloader, datasets(jpd, root)))
            finally:
                mp.undo()
        else:
            state = dft.train(port_state(pose_vars, ref_vars),
                              out_dir=out_dir, epochs=EPOCHS,
                              image_dump_dir=images,
                              **loaders(loader, datasets(pose_dataset, root)))
        out[name] = (state, out_dir)
    return out


def files_under(path):
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, fs in os.walk(path) for f in fs)


def test_train_from_dataset_matches_jax(run):
    """Both phases ran on both sides, the curves agree within ATOL, and
    the written checkpoints give the same network outputs."""
    jstate, jdir = run["jax"]
    pstate, pdir = run["port"]
    assert files_under(pdir) == files_under(jdir)
    want = jio.read_json(os.path.join(jdir, "losses.json"))["curves"]
    got = jio.read_json(os.path.join(pdir, "losses.json"))["curves"]
    assert sorted(got) == sorted(want)
    for key in ("losses", "train_dists", "grad_norm_max", "test_dists",
                "test_t_errs"):
        assert len(got[key]) == EPOCHS - 1
        np.testing.assert_allclose(got[key], want[key], atol=ATOL,
                                   err_msg=key)
    assert got["losses"][1] == 0.0 and pstate.refine_start
    assert jstate.refine_start

    # the checkpoints: the weights each epoch's test distance above was
    # measured with. Adam moves every weight by about lr whatever the size
    # of its gradient, so where a gradient is near zero the two packages'
    # f32 rounding can move it in opposite directions (test_torch_training
    # holds one step to 2 % of lr but for 1 element in 10^5, and to 2 lr
    # everywhere). Over the 5 steps of an epoch: every weight within
    # 2 lr per step, and all but 1 in 10^3 of each leaf within ATOL.
    steps = 5                            # 10 training items, batch 2
    for name, epoch in (("pose_model", 1), ("pose_refine_model", 2)):
        want = jcheckpoints.load_checkpoint(os.path.join(jdir, name))
        got = checkpoints.load_checkpoint(os.path.join(pdir, name))
        assert got["meta"]["epoch"] == want["meta"]["epoch"] == epoch
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                want["variables"])[0]:
            node = got["variables"]
            for p in path:
                node = node[p.key]
            off = np.abs(node - leaf)
            assert off.max() <= 2 * 1e-4 * steps, (name, path, off.max())
            assert (off > ATOL).mean() <= 1e-3, (name, path)


def flat_shapes(path):
    with np.load(path) as f:
        return {k: f[k].shape for k in f.files}


def test_snapshot_keys_match_jax_in_both_phases(run, tmp_path):
    """The refiner phase from the runs; the estimator phase from fresh
    trainers."""
    shapes = {}
    for name in ("jax", "port"):
        shapes[name] = flat_shapes(os.path.join(run[name][1],
                                                "trainer_resume.npz"))
    assert shapes["port"] == shapes["jax"]
    assert any(k.startswith("o/refine/1/.inner_state/0/.mu/")
               for k in shapes["port"])
    jdft.save_trainer_snapshot(
        jax_state(run["pose_vars"], run["ref_vars"]), str(tmp_path / "j"), 1)
    dft.save_trainer_snapshot(
        port_state(run["pose_vars"], run["ref_vars"]), str(tmp_path / "p"),
        1)
    est = [flat_shapes(str(tmp_path / d / "trainer_resume.npz"))
           for d in ("j", "p")]
    assert est[1] == est[0]
    assert not any(k.startswith("o/refine") for k in est[1])
    for d in ("j", "p"):
        meta = jio.read_json(str(tmp_path / d / "trainer_resume.npz"
                                 ".meta.json"))
        assert sorted(meta) == ["best_test", "decay_start", "epoch", "lr",
                                "refine_start", "w"]


def adam_of(state, phase):
    opt = state.optimizer if phase == "est" else state.refine_optimizer
    net = state.posenet if phase == "est" else state.refiner
    plan = weights.posenet_plan() if phase == "est" else \
        weights.refiner_plan()
    return checkpoints.adam_tree(opt.adam, net, plan, opt.clip)


def test_snapshots_cross_between_packages(run):
    """JAX's resume_trainer reads the port's snapshot and the port's reads
    JAX's; each restores the writer's weights and optimizer exactly."""
    pstate, pdir = run["port"]
    jstate = jdft.resume_trainer(
        jax_state(run["pose_vars"], run["ref_vars"]), pdir)
    assert jstate.refine_start and jstate.cfg.start_epoch == EPOCHS
    assert jstate.best_test == pstate.best_test
    written = checkpoints.load_checkpoint(os.path.join(pdir,
                                                       "trainer_resume"))
    for tree, got in ((written["variables"]["pose_vars"], jstate.pose_vars),
                      (written["variables"]["refine_vars"],
                       jstate.refine_vars),
                      (written["opt_state"]["est"], jstate.opt_state),
                      (written["opt_state"]["refine"],
                       jstate.refine_opt_state)):
        flat = checkpoints._flatten(tree, "")
        for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            np.testing.assert_array_equal(np.asarray(leaf), flat[key],
                                          err_msg=key)
    assert int(jstate.refine_opt_state[1].count) == 5   # 10 items / B

    jrun, jdir = run["jax"]
    back = dft.resume_trainer(port_state(run["pose_vars"], run["ref_vars"]),
                              jdir)
    assert back.refine_start and back.cfg.start_epoch == EPOCHS
    got_vars = weights.posenet_variables(back.posenet)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jrun.pose_vars)[0]:
        node = got_vars
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    for phase, jopt in (("est", jrun.opt_state),
                        ("refine", jrun.refine_opt_state)):
        flat = checkpoints._flatten(adam_of(back, phase), "")
        for path, leaf in jax.tree_util.tree_flatten_with_path(jopt)[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            np.testing.assert_array_equal(flat[key], np.asarray(leaf),
                                          err_msg=key)


@pytest.mark.parametrize("phase", ["estimator", "refiner"])
def test_resumed_run_repeats_next_step(run, tmp_path, phase):
    """A port run stopped after epoch 1 and resumed in a fresh trainer
    takes the same next step as the uninterrupted run: loss and every
    parameter equal bit for bit."""
    sets = datasets(pose_dataset, run["root"])
    margin = {"estimator": 100, "refiner": 1}[phase]
    state = dft.train(
        port_state(run["pose_vars"], run["ref_vars"],
                   refine_epoch_margin=margin),
        out_dir=str(tmp_path), epochs=2, **{
            k: v for k, v in loaders(loader, sets).items()
            if k != "image_batches"})
    resumed = dft.resume_trainer(
        port_state(run["pose_vars"], run["ref_vars"],
                   refine_epoch_margin=margin), str(tmp_path))
    assert resumed.refine_start == state.refine_start == (phase == "refiner")
    batch = dft.to_device(next(iter(loader.Loader(sets[0], B,
                                                  num_workers=0))), "cpu")
    outs = []
    for st in (state, resumed):
        if phase == "refiner":
            m = dft.refiner_step(st.posenet, st.refiner,
                                 st.refine_optimizer, batch, st.w)
            net = st.refiner
        else:
            m = dft.estimator_step(st.posenet, st.optimizer, batch, st.w,
                                   generator=torch.Generator().manual_seed(
                                       5))
            net = st.posenet
        outs.append((m, [p.detach().clone() for p in net.parameters()]))
    (m0, p0), (m1, p1) = outs
    for key in m0:
        assert torch.equal(m0[key], m1[key]), key
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def upstream_posenet(params):
    """A flax PoseNet params tree under upstream DenseFusion's state_dict
    names and layouts (DataParallel's `module.` inside the PSPNet)."""
    sd = {}

    def conv2d(name, node):
        sd[name + ".weight"] = node["kernel"].transpose(3, 2, 0, 1)
        if "bias" in node:
            sd[name + ".bias"] = node["bias"]

    def conv1d(name, node):
        sd[name + ".weight"] = node["kernel"].T[:, :, None]
        sd[name + ".bias"] = node["bias"]

    psp, p = params["PSPNet_0"], "cnn.model.module."
    res = psp["DilatedResNetNoBN_0"]
    conv2d(p + "feats.conv1", res["Conv_0"])
    for k in range(8):
        blk, name = res[f"BasicBlockPlain_{k}"], \
            f"{p}feats.layer{k // 2 + 1}.{k % 2}"
        conv2d(name + ".conv1", blk["Conv_0"])
        conv2d(name + ".conv2", blk["Conv_1"])
        if "Conv_2" in blk:
            conv2d(name + ".downsample.0", blk["Conv_2"])
    for i in range(4):
        conv2d(f"{p}psp.stages.{i}.1", psp["PSPModule_0"][f"Conv_{i}"])
    conv2d(p + "psp.bottleneck", psp["PSPModule_0"]["Conv_4"])
    for i in range(3):
        up = psp[f"PSPUpsample_{i}"]
        conv2d(f"{p}up_{i + 1}.conv.1", up["Conv_0"])
        sd[f"{p}up_{i + 1}.conv.2.weight"] = np.reshape(
            up["PReLU_0"]["negative_slope"], (1,))
    conv2d(p + "final.0", psp["Conv_0"])
    names = ["conv1", "e_conv1", "conv2", "e_conv2", "conv5", "conv6"]
    for i, n in enumerate(names):
        conv1d(f"feat.{n}", params["PoseNetFeat_0"][f"Dense_{i}"])
    for h, s in enumerate("rtc"):
        for i in range(4):
            conv1d(f"conv{i + 1}_{s}", params[f"PoseHead_{h}"][f"Dense_{i}"])
    return sd


def upstream_refiner(params):
    sd = {}
    names = ["conv1", "e_conv1", "conv2", "e_conv2", "conv5", "conv6"]
    for i, n in enumerate(names):
        node = params["PoseRefineNetFeat_0"][f"Dense_{i}"]
        sd[f"feat.{n}.weight"] = node["kernel"].T[:, :, None]
        sd[f"feat.{n}.bias"] = node["bias"]
    for h, s in enumerate("rt"):
        for i in range(3):
            node = params[f"RefineHead_{h}"][f"Dense_{i}"]
            sd[f"conv{i + 1}_{s}.weight"] = node["kernel"].T
            sd[f"conv{i + 1}_{s}.bias"] = node["bias"]
    return sd


def save_pth(sd, path):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                for k, v in sd.items()}, path)


def test_warm_start_from_pth_matches_jax(run, tmp_path):
    """Upstream weights for 5 objects into 2-object trainers: the trunk
    carried, the final heads drawn anew from default_rng(0), the same
    weights on both sides and outputs within ATOL."""
    img = np.zeros((1, CROP, CROP, 3), np.float32)
    cloud = np.zeros((1, 8, 3), np.float32)
    obj = np.zeros((1,), np.int32)
    src_pose = init_vars(jdf.PoseNet(num_obj=5, dtype=jnp.float32), img,
                         cloud, np.zeros((1, 8), np.int32), obj, seed=7)
    src_ref = init_vars(jdf.PoseRefineNet(num_obj=5, dtype=jnp.float32),
                        cloud, np.zeros((1, 8, 32), np.float32), obj, seed=8)
    save_pth(upstream_posenet(src_pose["params"]), str(tmp_path / "p.pth"))
    save_pth(upstream_refiner(src_ref["params"]), str(tmp_path / "r.pth"))

    jstate = jdft.warm_start(jax_state(run["pose_vars"], run["ref_vars"]),
                             str(tmp_path / "p.pth"), str(tmp_path / "r.pth"))
    pstate = dft.warm_start(port_state(run["pose_vars"], run["ref_vars"]),
                            str(tmp_path / "p.pth"), str(tmp_path / "r.pth"))
    for got, want in ((weights.posenet_variables(pstate.posenet),
                       jstate.pose_vars),
                      (weights.refiner_variables(pstate.refiner),
                       jstate.refine_vars)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
            node = got
            for p in path:
                node = node[p.key]
            np.testing.assert_array_equal(node, np.asarray(leaf))
    kernel = np.asarray(jstate.pose_vars["params"]["PoseNetFeat_0"][
        "Dense_0"]["kernel"])
    np.testing.assert_array_equal(
        kernel, src_pose["params"]["PoseNetFeat_0"]["Dense_0"]["kernel"])
    assert all(len(s) == 0 for s in pstate.optimizer.adam.state.values())

    batch = next(iter(loaders(jloader, datasets(jpd, run["root"]))
                      ["test_batches"]()))
    t = dft.to_device(batch, "cpu")
    want = run["jpose"].apply(
        jstate.pose_vars, batch["img"], batch["cloud"], batch["choose"],
        batch["obj_idx"])
    with torch.no_grad():
        got = pstate.posenet(t["img"], t["cloud"], t["choose"], t["obj_idx"])
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=ATOL)

    # a .npz checkpoint of the JAX package warm-starts the port too
    jcheckpoints.save_checkpoint(str(tmp_path / "j" / "pose_model"),
                                 jstate.pose_vars)
    again = dft.warm_start(port_state(run["pose_vars"], run["ref_vars"]),
                           str(tmp_path / "j" / "pose_model.npz"))
    for a, b in zip(again.posenet.state_dict().values(),
                    pstate.posenet.state_dict().values()):
        assert torch.equal(a, b)


def test_pointcloud2image_equals_jax():
    rng = np.random.default_rng(6)
    image = rng.integers(0, 256, (128, 160, 3)).astype(np.uint8)
    pts = np.stack([rng.uniform(-0.2, 0.2, 500), rng.uniform(-0.15, 0.15,
                                                            500),
                    rng.uniform(0.3, 0.8, 500)], 1)
    for intr in ({"fx": 140.0, "fy": 141.0, "ppx": 80.0, "ppy": 64.0},
                 jio.Intrinsics(width=160, height=128, ppx=79.5, ppy=63.5,
                                fx=140.0, fy=140.0)):
        for size in (1, 3, 5):
            want = jvis.pointcloud2image(image, pts, size, intr, (0, 255, 0))
            got = visualize.pointcloud2image(image, pts, size, intr,
                                             (0, 255, 0))
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("refine", [False, True])
def test_dump_pose_images_equals_jax(run, tmp_path, refine):
    """The same PNG pixels from the same weights and test frames."""
    sets_j = datasets(jpd, run["root"])
    sets_p = datasets(pose_dataset, run["root"])
    jstate = jax_state(run["pose_vars"], run["ref_vars"])
    pstate = port_state(run["pose_vars"], run["ref_vars"])
    jstate.refine_start = pstate.refine_start = refine
    jdft.dump_pose_images(jstate, loaders(jloader, sets_j)["image_batches"],
                          str(tmp_path / "j.png"))
    dft.dump_pose_images(pstate, loaders(loader, sets_p)["image_batches"],
                         str(tmp_path / "p.png"))
    want = np.asarray(Image.open(str(tmp_path / "j.png")))
    got = np.asarray(Image.open(str(tmp_path / "p.png")))
    assert got.shape == want.shape == (2 * 128, 2 * 160, 3)
    np.testing.assert_array_equal(got, want)


def test_app_train_pose_estimation_cpu(run, tmp_path):
    """The port's entry point on the CPU writes every artifact that the
    JAX App writes (the JAX train() run above, called as its App calls
    it) and resumes from its own snapshot. Frames of 64x48 keep the
    App's default crop (clamped to the frame) small."""
    root = str(tmp_path / "root")
    jsyn.make_dataset(root, cfg=jsyn.SynthConfig(
        n_viewpoints=6, img_h=48, img_w=64, fx=56.0, fy=56.0))
    asked = []
    app = App(root, input_fn=lambda q: asked.append(q) or "0",
              print_fn=lambda s: None)
    state = app.train_pose_estimation(epochs=EPOCHS, device="cpu",
                                      **config())
    assert asked and state.refine_start and state.device.type == "cpu"
    out_dir = os.path.join(root, "DenseFusion", "trained_models", DS)
    assert files_under(out_dir) == files_under(run["jax"][1])
    curves = jio.read_json(os.path.join(out_dir, "losses.json"))["curves"]
    assert np.isfinite(curves["test_dists"]).all()
    again = app.train_pose_estimation(DS, epochs=EPOCHS + 1, device="cpu",
                                      start_epoch=EPOCHS, **config())
    curves = jio.read_json(os.path.join(out_dir, "losses.json"))["curves"]
    assert again.refine_start and len(curves["test_dists"]) == 1
    assert jio.read_json(os.path.join(out_dir, "trainer_resume.npz"
                                               ".meta.json"))["epoch"] == \
        EPOCHS + 1
