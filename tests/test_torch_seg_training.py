"""The port's segmentation training against the JAX package's on the CPU in
f32, at a small size (2 objects, 96x64 frames, 64-pixel train crops,
batch 2), from one dataset and one numpy-drawn initial variable tree
carried to both: three `train_step`s with Adam (the ResNet34 U-Net) and
with SGD-Nesterov (the 7-channel, 2-class background-subtraction U-Net),
`eval_step` with the CCA metric, a two-epoch `segmentation_training` with
the plateau schedule whose curves, image dumps and checkpoints agree and
cross between the packages, `random_prediction_iou`, and the port's
`App.train_segmentation` whose checkpoint serving loads.

Losses and curves agree within 2e-4 (the torch-vs-flax figure), confusion
matrices exactly, and weights by the Adam bound of
tests/test_torch_train_dataset.py: each element within 2 lr a step, and
all but 1 in 10^3 of each leaf within 2e-4."""
import copy
import functools
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from autoposeestimation_tpu.data import loader as jloader
from autoposeestimation_tpu.data import segmentation_dataset as jsd
from autoposeestimation_tpu.models import seg_variants as jsv
from autoposeestimation_tpu.models import unet as junet
from autoposeestimation_tpu.train import checkpoints as jcheckpoints
from autoposeestimation_tpu.train import segmentation as jseg
from autoposeestimation_tpu.utils import synthetic as jsyn
from autoposeestimation_tpu_torch import weights
from autoposeestimation_tpu_torch.data import segmentation_dataset
from autoposeestimation_tpu_torch.main import App
from autoposeestimation_tpu_torch.models import densefusion, unet
from autoposeestimation_tpu_torch.models.common import init_like_flax
from autoposeestimation_tpu_torch.pipeline import predict
from autoposeestimation_tpu_torch.train import checkpoints
from autoposeestimation_tpu_torch.train import segmentation as seg
from autoposeestimation_tpu_torch.utils import png
from autoposeestimation_tpu_torch.utils import synthetic
from test_torch_models import init_vars
from test_torch_seg_models import assert_trees_close, leaves

DS, B, SIZE, CLASSES = "synth", 2, 64, 3
# a shallower encoder: the ResNet34 one, in train mode on 64-pixel crops of
# batch 2, has gradients that move by 12 % when the input moves by 1e-6
STAGES = (2, 1, 1, 1)
ATOL = 2e-4
INIT = {}     # (in_channels, classes) -> the initial variable tree


class SeededUNet(junet.UNet):
    """The JAX U-Net whose `init` returns the tree drawn for the test (no
    flax init compile), so both packages start from it."""

    def init(self, rngs, x, *args, **kwargs):
        return jax.tree_util.tree_map(np.copy,
                                      INIT[(x.shape[-1], self.classes)])


def initial(in_ch, classes, seed):
    key = (in_ch, classes)
    if key not in INIT:
        INIT[key] = init_vars(junet.UNet(classes=classes,
                                         encoder_stages=STAGES,
                                         dtype=jnp.float32),
                              np.zeros((1, SIZE, SIZE, in_ch), np.float32),
                              seed=seed)
    return INIT[key]


def jax_model(classes):
    return SeededUNet(classes=classes, encoder_stages=STAGES,
                      dtype=jnp.float32)


def assert_adam_bound(got, want, lr, steps, what):
    """Each element within 2 lr a step; all but 1 in 10^3 of each leaf
    within 2e-4."""
    got, want = leaves(got), leaves(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        d = np.abs(got[path] - w)
        assert d.max() <= 2 * lr * steps + 1e-6, (what, path, d.max())
        assert np.mean(d > ATOL) <= 1e-3, (what, path, np.mean(d > ATOL))


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this file's networks: the suite runs six
    workers at once, and their many small ops run ~10x slower when every
    worker spins 8 threads on 8 cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("seg_train"))
    jsyn.make_dataset(base, cfg=jsyn.SynthConfig(
        n_viewpoints=5, img_h=64, img_w=96, fx=84.0, fy=84.0))
    return base


@pytest.fixture(scope="module")
def data(root):
    """Two epochs of train batches (64-pixel crops) and the valid batches
    (full frames) of the JAX dataset, drawn once for both packages."""
    train = jsd.SegmentationDataset(root, DS, mode="train", output_size=SIZE,
                                    label_mode="pred")
    valid = jsd.SegmentationDataset(root, DS, mode="test", label_mode="pred")
    it = jloader.Loader(train, B, num_workers=0)
    epochs = [list(it) for _ in range(2)]
    valid_batches = list(jloader.Loader(valid, B, shuffle=False,
                                        drop_last=False, num_workers=0))
    assert len(epochs[0]) == 4 and len(valid_batches) == 1
    return {"epochs": epochs, "valid": valid_batches}


def port_model(variables, classes, in_ch=3):
    net = unet.UNet(classes, encoder_stages=STAGES, dtype=torch.float32,
                    in_ch=in_ch)
    net.load_state_dict(weights.to_state_dict(variables,
                                              weights.unet_plan(STAGES)))
    return net


def carry_state(net, optimizer, jv, opt, optimizer_name):
    """Put JAX's weights and optimizer state into the port's network and
    optimizer: Adam's count, mu and nu, or SGD's momentum trace."""
    plan = weights.unet_plan(STAGES)
    host = jax.tree_util.tree_map(np.asarray, (jv, opt))
    net.load_state_dict(weights.to_state_dict(host[0], plan))
    inner = host[1].inner_state[0]
    pplan = [(path[1:], key, kind) for path, key, kind in plan
             if path[0] == "params"]
    named = dict(net.named_parameters())
    if optimizer_name == "adam":
        checkpoints.load_adam_tree(optimizer, net, plan, {".inner_state": {
            "0": {".count": inner.count, ".mu": inner.mu, ".nu": inner.nu}}})
        return
    trace = weights.to_state_dict(inner.trace, pplan)
    for _, key, _ in pplan:
        optimizer.state[named[key]] = {"momentum_buffer": trace[key].reshape(
            named[key].shape).clone()}


def check_steps(cfg, variables, batches):
    """Three steps, each from the same weights and optimizer state in both
    packages (JAX's, carried into the port before each step): the loss
    within 2e-4, the confusion matrix equal but for pixels whose logits
    are tied within 1e-4, and the weights after the step by the Adam
    bound (SGD: within 2e-4)."""
    jm = jax_model(cfg.classes)
    tx = jseg.make_tx(cfg)
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    opt = tx.init(jv["params"])
    net = port_model(variables, cfg.classes, cfg.in_channels)
    optimizer = seg.make_optimizer(cfg, net.parameters())
    plan = weights.unet_plan(STAGES)
    for k, batch in enumerate(batches):
        if k:
            carry_state(net, optimizer, jv, opt, cfg.optimizer)
        jv, opt, want = jseg.train_step(jv, opt, batch, jm, tx, cfg.classes)
        image = seg.to_device(batch, "cpu")["image"]
        with torch.no_grad():
            top2 = copy.deepcopy(net).train()(image).topk(2, dim=1).values
        near_ties = int((top2[:, 0] - top2[:, 1] < 1e-4).sum())
        got = seg.train_step(net, optimizer, seg.to_device(batch, "cpu"),
                             cfg.classes)
        assert abs(float(got["loss"]) - float(want["loss"])) <= ATOL, k
        # a pixel may change cells only where its two best logits are
        # within 1e-4 (the two packages' logits agree to ~1e-5)
        moved = np.abs(got["conf"].numpy() - np.asarray(want["conf"]))
        assert moved.sum() // 2 <= near_ties, (k, moved, near_ties)
        pv = weights.to_variables(net.state_dict(), plan)
        jhost = jax.tree_util.tree_map(np.asarray, jv)
        if cfg.optimizer == "adam":
            assert_adam_bound(pv["params"], jhost["params"], cfg.lr, 1,
                              f"step {k}")
        else:
            assert_trees_close(pv["params"], jhost["params"], ATOL,
                               f"step {k}")
        assert_trees_close(pv["batch_stats"], jhost["batch_stats"], 5e-5,
                           f"step {k} batch_stats")
    if cfg.optimizer == "adam":
        tree = checkpoints.adam_tree(optimizer, net, plan, clip=0)
        assert int(tree[".inner_state"]["0"][".count"]) == int(
            opt.inner_state[0].count) == len(batches)


def test_train_steps_adam(data):
    check_steps(jseg.SegConfig(classes=CLASSES, batch_size=B),
                initial(3, CLASSES, 1), data["epochs"][0][:3])


def test_train_steps_sgd_7_channels():
    """The background-subtraction configuration: 7 input channels, 2
    classes, SGD with Nesterov momentum (lr 1e-2, so each step moves the
    weights measurably)."""
    rng = np.random.default_rng(5)
    batches = [{"image": rng.normal(size=(B, SIZE, SIZE, 7)).astype(
        np.float32), "label": (rng.random((B, SIZE, SIZE)) > 0.7).astype(
        np.int32)} for _ in range(3)]
    check_steps(jseg.SegConfig(classes=2, in_channels=7, optimizer="sgd",
                               lr=1e-2, batch_size=B),
                initial(7, 2, 2), batches)


def test_eval_step(data):
    variables = initial(3, CLASSES, 1)
    batch = data["valid"][0]
    want = jseg.eval_step(jax.tree_util.tree_map(jnp.asarray, variables),
                          batch, jax_model(CLASSES), CLASSES)
    got = seg.eval_step(port_model(variables, CLASSES),
                        seg.to_device(batch, "cpu"), CLASSES)
    assert sorted(got) == sorted(want) == ["conf", "loss"]
    assert abs(float(got["loss"]) - float(want["loss"])) <= ATOL
    np.testing.assert_array_equal(got["conf"].numpy(),
                                  np.asarray(want["conf"]))


class JaxLogits(nn.Module):
    """A JAX 'model' whose logits are its input."""

    @nn.compact
    def __call__(self, x, train=False):
        return x


class PortLogits(torch.nn.Module):
    def forward(self, x):
        return x


def test_eval_step_with_cca():
    """The CCA metric on given logits: per sample, the foreground
    component of the largest summed max-probability is kept, the rest of
    the foreground becomes background."""
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(2, 40, 48, CLASSES)).astype(np.float32)
    logits[..., 0] += 2.0                       # background but for blobs
    for b, blobs in enumerate(([(5, 5, 6), (25, 30, 9)],
                               [(10, 38, 7), (30, 8, 5), (20, 20, 3)])):
        yy, xx = np.mgrid[:40, :48]
        for k, (cy, cx, r) in enumerate(blobs):
            inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            logits[b, inside, 1 + k % 2] += 4.0
    labels = rng.integers(0, CLASSES, (2, 40, 48)).astype(np.int32)
    batch = {"image": logits, "label": labels}
    want = jseg.eval_step({}, batch, JaxLogits(), CLASSES, True)
    got = seg.eval_step(PortLogits(), seg.to_device(batch, "cpu"), CLASSES,
                        True)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-6
    for key in ("conf", "conf_cca"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    # the CCA dropped foreground: fewer pixels predicted foreground
    assert got["conf_cca"][:, 0].sum() > got["conf"][:, 0].sum()


def test_dump_prediction_images_equal(data, tmp_path):
    """The (input | ground truth | prediction) PNG, pixel for pixel, from
    the same weights and batch."""
    variables = initial(3, CLASSES, 1)
    batch = data["valid"][0]
    jseg.dump_prediction_images(
        jax.tree_util.tree_map(jnp.asarray, variables), jax_model(CLASSES),
        batch, str(tmp_path / "jax.png"), CLASSES)
    seg.dump_prediction_images(port_model(variables, CLASSES), batch,
                               str(tmp_path / "port.png"), CLASSES)
    want = png.read(str(tmp_path / "jax.png"))
    assert want.shape == (2 * 64, 3 * 96, 3)
    np.testing.assert_array_equal(png.read(str(tmp_path / "port.png")),
                                  want)


@pytest.fixture(scope="module")
def runs(root, data, tmp_path_factory):
    """Two-epoch `segmentation_training` of both packages on the same
    batches and the same shallower U-Net (each package's model builder
    patched), with the CCA metric, a plateau of patience 0 and the image
    dumps."""
    base = tmp_path_factory.mktemp("seg_runs")
    variables = initial(3, CLASSES, 1)
    out = {}
    for name in ("jax", "port"):
        epochs = iter(data["epochs"])
        kw = dict(out_dir=str(base / name), with_cca_metric=True,
                  image_dump_dir=str(base / name / "images"))
        cfg_kw = dict(classes=CLASSES, epochs=2, batch_size=B,
                      data_parallel="off")
        if name == "jax":
            cfg = jseg.SegConfig(**cfg_kw)
            mp = pytest.MonkeyPatch()
            mp.setattr(jseg, "build_model",
                       lambda c, dtype: jax_model(c.classes))
            try:
                res = jseg.segmentation_training(
                    lambda: next(epochs), lambda: iter(data["valid"]), cfg,
                    plateau=jseg.ReduceLROnPlateau(cfg.lr, patience=0,
                                                   mode="min"),
                    dtype=jnp.float32, sample_shape=(SIZE, SIZE), **kw)
            finally:
                mp.undo()
        else:
            cfg = seg.SegConfig(**cfg_kw)
            mp = pytest.MonkeyPatch()
            mp.setattr(seg, "build_model", lambda c, dtype: unet.UNet(
                c.classes, encoder_stages=STAGES, dtype=dtype))
            mp.setattr(seg, "model_plan", lambda c: weights.unet_plan(STAGES))
            res = seg.segmentation_training(
                lambda: next(epochs), lambda: iter(data["valid"]), cfg,
                plateau=seg.ReduceLROnPlateau(cfg.lr, patience=0,
                                              mode="min"),
                dtype=torch.float32, device="cpu", init_variables=variables,
                **kw)
            mp.undo()
        out[name] = (res, cfg, str(base / name))
    return out


def test_training_curves_agree(runs):
    """Loss curves within 2e-4; IoU curves within 2e-3, a few pixels of the
    32,768 a training epoch scores, since the runs' weights drift apart
    within the Adam bound and flip near-tied pixels; the best weights
    within that bound."""
    (jres, jcfg, _), (pres, pcfg, _) = runs["jax"], runs["port"]
    jc, pc = jres["log"]["curves"], pres["log"]["curves"]
    assert sorted(pc) == sorted(jc)
    assert pres["log"]["model_name"] == "Unet"
    for key, atol in (("train_loss", ATOL), ("valid_loss", ATOL),
                      ("lr", 0.0), ("train_iou", 2e-3), ("valid_iou", 2e-3),
                      ("valid_iou_cca", 2e-3)):
        assert len(pc[key]) == 2
        np.testing.assert_allclose(pc[key], jc[key], atol=atol, err_msg=key)
    # the plateau (mode min, patience 0) cut the rate after epoch 2
    assert pcfg.lr == jcfg.lr == pytest.approx(1e-5)
    assert abs(pres["best_iou"] - jres["best_iou"]) <= 2e-3
    # 8 steps of drift: every weight within 2 lr a step (the share of a
    # leaf beyond 2e-4 is held per step in test_train_steps_adam)
    for path, w in leaves(jres["variables"]["params"]).items():
        d = np.abs(leaves(pres["variables"]["params"])[path] - w)
        assert d.max() <= 2 * 1e-4 * 8 + 1e-6, (path, d.max())


def test_training_image_dumps(runs):
    """Each epoch's dump; input and ground-truth panels equal (the
    prediction panels come from the drifted weights)."""
    jdir, pdir = (os.path.join(runs[n][2], "images") for n in ("jax", "port"))
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir)) == ["epoch_0000.png",
                                                 "epoch_0001.png"]
    for name in names:
        got = png.read(os.path.join(pdir, name))
        want = png.read(os.path.join(jdir, name))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:, :2 * 96], want[:, :2 * 96])


def test_checkpoints_cross(runs, data):
    """Each package loads the other's best checkpoint: the JAX reader gets
    the port's tree back, and the port's network on the JAX checkpoint
    gives the JAX logits."""
    (jres, _, jdir), (pres, _, pdir) = runs["jax"], runs["port"]
    ckpt = "Unet_resnet34.ckpt"
    jread = jcheckpoints.load_checkpoint(os.path.join(pdir, ckpt))
    for path, arr in leaves(pres["variables"]).items():
        np.testing.assert_array_equal(leaves(jread["variables"])[path], arr)
    assert jread["meta"]["config"]["classes"] == CLASSES
    assert jread["meta"]["epoch"] in (0, 1)
    pread = checkpoints.load_checkpoint(os.path.join(jdir, ckpt))
    assert pread["meta"]["epoch"] == jread["meta"]["epoch"]
    net = port_model(pread["variables"], CLASSES).eval()
    batch = data["valid"][0]
    want = np.asarray(junet.UNet(classes=CLASSES, encoder_stages=STAGES,
                                 dtype=jnp.float32).apply(
        jax.tree_util.tree_map(jnp.asarray, jres["variables"]),
        batch["image"]))
    with torch.no_grad():
        got = net(seg.to_device(batch, "cpu")["image"])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=ATOL)


def test_random_prediction_iou(data):
    batches = data["valid"] + data["epochs"][0]
    for seed in (0, 3):
        want = jseg.random_prediction_iou(lambda: iter(batches), CLASSES,
                                          seed)
        got = seg.random_prediction_iou(lambda: iter(batches), CLASSES, seed)
        assert got == pytest.approx(want, abs=1e-7)


def test_registry_and_refusals(tmp_path):
    """LinkNet and PSPNet build over resnet34 (other encoders raise);
    PSPNet does not train, as in the JAX package, whose train_step gives
    its dropout no key; data_parallel='on' trains on a one-rank group
    (no batch here) and another value raises; the entry point needs a card
    unless given the CPU."""
    assert isinstance(seg.build_model(seg.SegConfig(model_name="LinkNet")),
                      torch.nn.Module)
    with pytest.raises(NotImplementedError, match="encoder"):
        seg.build_model(seg.SegConfig(encoder_name="resnet50"))
    kw = dict(train_loader=lambda: iter(()), valid_loader=lambda: iter(()),
              out_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="dropout"):
        seg.segmentation_training(cfg=seg.SegConfig(model_name="PSPNet"),
                                  **kw)
    try:
        out = seg.segmentation_training(
            cfg=seg.SegConfig(data_parallel="on", epochs=1), **kw)
        assert dist.get_world_size() == 1
        assert len(out["log"]["curves"]["valid_iou"]) == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with pytest.raises(ValueError, match="data_parallel"):
        seg.segmentation_training(cfg=seg.SegConfig(data_parallel="many"),
                                  **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            seg.segmentation_training(cfg=seg.SegConfig(epochs=0),
                                      **{**kw, "device": None})


def test_linknet_trains_and_jax_loads_it(tmp_path):
    """One LinkNet epoch through the port's loop (seeded init); its
    checkpoint is a LinkNet tree that the JAX package loads and runs."""
    rng = np.random.default_rng(6)
    batches = [{"image": rng.normal(size=(B, 32, 32, 3)).astype(
        np.float32), "label": rng.integers(0, 2, (B, 32, 32)).astype(
        np.int32)} for _ in range(2)]
    cfg = seg.SegConfig(model_name="LinkNet", epochs=1, batch_size=B)
    res = seg.segmentation_training(
        lambda: iter(batches), lambda: iter(batches[:1]), cfg,
        str(tmp_path), ckpt_name="LinkNet_resnet34.ckpt",
        dtype=torch.float32, device="cpu")
    assert np.isfinite(res["log"]["curves"]["train_loss"]).all()
    read = jcheckpoints.load_checkpoint(str(tmp_path / "LinkNet_resnet34"
                                                       ".ckpt"))
    logits = jsv.LinkNet(classes=2, dtype=jnp.float32).apply(
        jax.tree_util.tree_map(jnp.asarray, read["variables"]),
        batches[0]["image"])
    assert logits.shape == (B, 32, 32, 2)


def test_app_train_segmentation_then_serve(tmp_path, monkeypatch):
    """`App.train_segmentation(device="cpu")` on a `make_dataset` root
    writes the checkpoint that `get_prediction_models` serves a frame
    with (random pose weights beside it). The dataset's crops are cut from
    480 to 32 pixels, for the CPU's sake."""
    monkeypatch.setattr(
        segmentation_dataset, "SegmentationDataset",
        functools.partial(segmentation_dataset.SegmentationDataset,
                          output_size=32))
    root = str(tmp_path / "root")
    scfg = synthetic.SynthConfig(n_viewpoints=5, img_h=48, img_w=64,
                                 fx=56.0, fy=56.0)
    manifest = synthetic.make_dataset(root, cfg=scfg)
    asked = []
    app = App(root, input_fn=lambda q: asked.append(q) or "0",
              print_fn=lambda s: None)
    res = app.train_segmentation(epochs=1, device="cpu", batch_size=B)
    assert asked and res["model"].encoder.conv1.weight.device.type == "cpu"
    out_dir = os.path.join(root, "segmentation", "trained_models", DS)
    assert sorted(os.listdir(out_dir)) == [
        "Unet_resnet34.ckpt.npz", "Unet_resnet34.ckpt.npz.meta.json",
        "logs.json"]
    net = app._load_seg_model(DS, 3, device="cpu")
    assert not net.training
    pose_dir = os.path.join(root, "DenseFusion", "trained_models", DS)
    gen = torch.Generator().manual_seed(0)
    for name, model, to_vars in (
            ("pose_model", densefusion.PoseNet(2), weights.posenet_variables),
            ("pose_refine_model", densefusion.PoseRefineNet(2),
             weights.refiner_variables)):
        init_like_flax(model, gen)
        checkpoints.save_checkpoint(os.path.join(pose_dir, name),
                                    to_vars(model))
    models = predict.get_prediction_models(root, DS, dtype=torch.float32,
                                           device="cpu")
    for a, b in zip(models.seg_model.state_dict().values(),
                    net.state_dict().values()):
        assert torch.equal(a, b)
    color, depth, _ = synthetic.render(scfg, manifest["cams"][0],
                                       manifest["objects"])
    meta = {"intr": manifest["intr"], "depth_scale": 0.001}
    out = predict.full_prediction(color, np.round(depth).astype(np.uint16),
                                  meta, models,
                                  generator=torch.Generator().manual_seed(1))
    assert "predictions" in out


def test_vanilla_segnet_trainer(tmp_path):
    """`train_vanilla_segnet` on the CPU: the per-epoch train and test log
    files with one CE line per batch, `model_current` every `save_every`
    batches, `model_<epoch>_<cost>` whenever the test cost is at or below
    the best; the JAX SegNet loads that checkpoint and gives the port's
    logits; `resume_model` loads it back and clears the old logs."""
    from autoposeestimation_tpu.models import segnet as jsegnet
    from autoposeestimation_tpu_torch.models import segnet
    from autoposeestimation_tpu_torch.train import vanilla_segnet

    rng = np.random.default_rng(8)
    batches = [{"image": rng.normal(size=(1, 32, 32, 3)).astype(np.float32),
                "label": rng.integers(0, 3, (1, 32, 32)).astype(np.int32)}
               for _ in range(3)]
    logs, models = str(tmp_path / "logs"), str(tmp_path / "models")
    kw = dict(n_classes=3, n_epochs=3, log_dir=logs, model_save_path=models,
              save_every=1, device="cpu")
    out = vanilla_segnet.train_vanilla_segnet(
        lambda: iter(batches), lambda: iter(batches[:1]), **kw)
    assert out["epochs_run"] == 2 and np.isfinite(out["best_val_cost"])
    assert sorted(os.listdir(logs)) == [
        "epoch_1_log.txt", "epoch_1_test_log.txt", "epoch_2_log.txt",
        "epoch_2_test_log.txt"]
    with open(os.path.join(logs, "epoch_2_log.txt")) as f:
        lines = f.read().splitlines()
    assert sum("CEloss" in ln for ln in lines) == 4        # 3 + the average
    best = [n for n in os.listdir(models) if n.startswith("model_")
            and n.endswith(".npz") and n != "model_current.npz"]
    assert "model_current.npz" in os.listdir(models) and best
    name = sorted(best)[-1][:-len(".npz")]
    assert abs(float(name.split("_", 2)[2]) - out["best_val_cost"]) < 1e-12
    tree = jcheckpoints.load_checkpoint(os.path.join(models, name))
    want = np.asarray(jsegnet.SegNet(classes=3, dtype=jnp.float32).apply(
        jax.tree_util.tree_map(jnp.asarray, tree["variables"]),
        batches[0]["image"]))
    net = segnet.SegNet(3)
    net.load_state_dict(weights.to_state_dict(tree["variables"],
                                              weights.segnet_plan()))
    with torch.no_grad():
        got = net.eval()(seg.to_device(batches[0], "cpu")["image"])
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=ATOL)
    again = vanilla_segnet.train_vanilla_segnet(
        lambda: iter(batches[:1]), lambda: iter(batches[:1]),
        **{**kw, "n_epochs": 2, "resume_model": name})
    assert sorted(os.listdir(logs)) == ["epoch_1_log.txt",
                                        "epoch_1_test_log.txt"]
    assert again["epochs_run"] == 1
