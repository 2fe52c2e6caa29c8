"""The port's offline labeling functions against the JAX package's on the CPU,
on one JAX-written dataset (128x160 frames, 5 views; two objects, the
first with an extra run), each package running the whole chain in its own
copy: the classical labels (`create_labels`), the learned background
subtraction's (`create_mask_predictions`, a 7-channel U-Net), Phase A
(`create_new_pred_labels` with the extra run, a 3-class U-Net), and the
dataset lists (`make_train_and_test_dataset`). The U-Nets have encoder
stages (2, 1, 1, 1) and one numpy-drawn variable tree each, carried to
both packages.

Labels are equal but for pixels at a decision boundary: a classical
label's pixel whose score lies within 1e-4 of the threshold, a learned
label's pixel whose top two probabilities lie within 1e-4. The Phase A
stats and the dataset lists are equal (the lists byte for byte).

Then the port's `App` through a scripted `input_fn`: `create_labels`,
`create_dataset` and `create_pose_data` on a 240x320 dataset with
full-size U-Nets, and `create_pose_data(data_parallel='on')` on one rank
(its Phase B through the view-sharded surfaces) against 'off'."""
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from autoposeestimation_tpu.labeling import create_labels as jcl
from autoposeestimation_tpu.labeling import make_dataset as jmd
from autoposeestimation_tpu.models import unet as junet
from autoposeestimation_tpu.utils import io as jio
from autoposeestimation_tpu.utils import synthetic as jsyn
from autoposeestimation_tpu_torch import weights
from autoposeestimation_tpu_torch.labeling import create_labels as cl
from autoposeestimation_tpu_torch.labeling import make_dataset
from autoposeestimation_tpu_torch.main import App
from autoposeestimation_tpu_torch.models import unet
from autoposeestimation_tpu_torch.models.common import (init_like_flax,
                                                        normalize_imagenet)
from autoposeestimation_tpu_torch.ops import bg_subtraction as bgs
from autoposeestimation_tpu_torch.parallel import mesh as pmesh
from autoposeestimation_tpu_torch.reconstruction import (
    create_pointcloud as rec)
from autoposeestimation_tpu_torch.train import checkpoints
from autoposeestimation_tpu_torch.utils import io, synthetic
from test_torch_models import init_vars
from test_torch_seg_models import two_threads  # noqa: F401

STAGES = (2, 1, 1, 1)
TIE = 1e-4
OBJECTS = ("ball", "cube")
REF = np.zeros(3)


def copy_run(root, obj, src, dst):
    """A copy of an acquisition run (its labels are the labeling's to
    write)."""
    shutil.copytree(os.path.join(io.data_dir(root), obj, src),
                    os.path.join(io.data_dir(root), obj, dst))


def models():
    """(JAX module, variables, port module) for the background subtraction
    U-Net and the 3-class segmentation U-Net."""
    out = {}
    for name, classes, ch, seed in (("bs", 2, 7, 1), ("seg", 3, 3, 2)):
        jm = junet.UNet(classes=classes, encoder_stages=STAGES,
                        dtype=jnp.float32)
        variables = init_vars(jm, jnp.zeros((1, 128, 160, ch)), seed=seed)
        tm = unet.UNet(classes, encoder_stages=STAGES, in_ch=ch)
        tm.load_state_dict(weights.to_state_dict(variables,
                                                 weights.unet_plan(STAGES)))
        out[name] = (jm, variables, tm.eval())
    return out


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    base = tmp_path_factory.mktemp("labeling")
    objects = [
        jsyn.SphereObject("ball", np.asarray([30.0, 10.0, 40.0]), 40.0,
                          (210, 50, 50), parts=(((25.0, 25.0, 25.0), 18.0),)),
        jsyn.SphereObject("cube", np.asarray([-20.0, 0.0, 30.0]), 30.0,
                          (40, 60, 200))]
    jsyn.make_dataset(str(base / "jax"), objects=objects,
                      cfg=jsyn.SynthConfig(n_viewpoints=5, noise=1.0))
    copy_run(str(base / "jax"), "ball", "foreground", "extra")
    shutil.copytree(base / "jax", base / "port")
    nets = models()
    out = {"models": nets}
    for name in ("jax", "port"):
        root = str(base / name)
        counts = {}
        for obj in OBJECTS:
            if name == "jax":
                counts[obj] = (
                    jcl.create_labels(obj, root, reference_point=REF),
                    jcl.create_mask_predictions(obj, root, *nets["bs"][:2],
                                                reference_point=REF))
            else:
                counts[obj] = (
                    cl.create_labels(obj, root, reference_point=REF,
                                     device="cpu"),
                    cl.create_mask_predictions(obj, root, nets["bs"][2],
                                               reference_point=REF))
        if name == "jax":
            stats = jcl.create_new_pred_labels(
                root, list(OBJECTS), *nets["seg"][:2], REF,
                get_extra_labels=True)
        else:
            stats = cl.create_new_pred_labels(
                root, list(OBJECTS), nets["seg"][2], REF,
                get_extra_labels=True)
        out[name] = (root, counts, stats)
    return out


def label_files(root, mode):
    out = []
    for obj in OBJECTS:
        for run in sorted(os.listdir(os.path.join(io.label_dir(root), obj))):
            d = os.path.join(io.label_dir(root), obj, run)
            out += [os.path.join(obj, run, f) for f in sorted(os.listdir(d))
                    if f.endswith(f".{mode}.label.png")]
    return out


def sample_inputs(root, rel):
    obj, run, fn = rel.split(os.sep)
    stem = fn.split(".")[0]
    dd = io.data_dir(root)
    bg = os.path.join(dd, obj, "background", stem)
    fg = os.path.join(dd, obj, run, stem)
    return cl._read_pair(bg, fg, torch.device("cpu"), REF)


def test_list_objects_and_runs(chain, tmp_path):
    root = chain["port"][0]
    with open(os.path.join(io.data_dir(root), "notes.txt"), "w") as f:
        f.write("a file, not an object\n")
    assert io.list_objects(root) == jio.list_objects(root) == list(OBJECTS)
    for obj in OBJECTS + ("missing",):
        assert io.list_runs(root, obj) == jio.list_runs(root, obj)
    assert io.list_runs(root, "ball") == ["background", "extra",
                                          "foreground"]
    assert io.list_objects(str(tmp_path)) == []
    os.remove(os.path.join(io.data_dir(root), "notes.txt"))


def test_create_labels_gen(chain):
    (jroot, jcounts, _), (proot, pcounts, _) = chain["jax"], chain["port"]
    assert [c[0] for c in pcounts.values()] == [c[0] for c in
                                               jcounts.values()] == [5, 5]
    files = label_files(jroot, "gen")
    assert files == label_files(proot, "gen") and len(files) == 10
    for rel in files:
        got = io.read_label(os.path.join(io.label_dir(proot), rel))
        want = jio.read_label(os.path.join(io.label_dir(jroot), rel))
        tensors, dist = sample_inputs(proot, rel)
        _, score = bgs.label_scores(*tensors, dist, bgs.P_BOTH, False, True)
        at_threshold = np.abs(score.numpy() - 30.0) < TIE
        assert not ((got != want) & ~at_threshold).any(), rel
        assert (got > 0).sum() > 50, rel


def top2_gap(model, x):
    with torch.no_grad():
        probs = torch.softmax(model(x)[0], dim=0)
    top = torch.topk(probs, 2, dim=0).values
    return (top[0] - top[1]).numpy()


def test_create_mask_predictions(chain):
    (jroot, jcounts, _), (proot, pcounts, _) = chain["jax"], chain["port"]
    assert [c[1] for c in pcounts.values()] == [c[1] for c in
                                               jcounts.values()] == [5, 5]
    model = chain["models"]["bs"][2]
    files = label_files(jroot, "pred")
    assert files == label_files(proot, "pred")
    for rel in files:
        got = io.read_label(os.path.join(io.label_dir(proot), rel))
        want = jio.read_label(os.path.join(io.label_dir(jroot), rel))
        tensors, dist = sample_inputs(proot, rel)
        x = bgs.build_bs_input(*tensors, dist).permute(2, 0, 1)[None]
        near_tie = top2_gap(model, x) < TIE
        assert not ((got != want) & ~near_tie).any(), rel
        assert (got > 0).any(), rel


def test_create_new_pred_labels(chain):
    (jroot, _, jstats), (proot, _, pstats) = chain["jax"], chain["port"]
    assert pstats == jstats
    assert sum(pstats.values()) >= 15 and pstats["n_extra_samples"] >= 0
    model = chain["models"]["seg"][2]
    files = label_files(jroot, "new_pred")
    assert files == label_files(proot, "new_pred")
    for rel in files:
        got = io.read_label(os.path.join(io.label_dir(proot), rel))
        want = jio.read_label(os.path.join(io.label_dir(jroot), rel))
        obj, run, fn = rel.split(os.sep)
        image = io.read_color(os.path.join(io.data_dir(proot), obj, run,
                                           fn.split(".")[0] + ".color.png"))
        x = normalize_imagenet(torch.from_numpy(image).permute(2, 0, 1)[None])
        near_tie = top2_gap(model, x) < TIE
        assert not ((got != want) & ~near_tie).any(), rel
    # a dropped sample's pose-label meta is removed, as in the JAX package
    for obj in OBJECTS:
        d = os.path.join(io.label_dir(proot), obj, "foreground")
        metas = {f.split(".")[0] for f in os.listdir(d)
                 if f.endswith(".meta.json")}
        jd = os.path.join(io.label_dir(jroot), obj, "foreground")
        assert metas == {f.split(".")[0] for f in os.listdir(jd)
                         if f.endswith(".meta.json")}


@pytest.mark.parametrize("kind, mode, extra", [
    ("segmentation", "gen", False), ("segmentation", "pred", False),
    ("pose_estimation", "new_pred", True)])
def test_make_train_and_test_dataset(chain, kind, mode, extra):
    (jroot, _, _), (proot, _, _) = chain["jax"], chain["port"]
    name = f"{kind}_{mode}"
    want = jmd.make_train_and_test_dataset(jroot, OBJECTS, kind, name,
                                           p_test=0.25, mode=mode,
                                           use_extra_data=extra)
    got = make_dataset.make_train_and_test_dataset(proot, OBJECTS, kind, name,
                                                   p_test=0.25, mode=mode,
                                                   use_extra_data=extra)
    assert got == want and got["train"] > 0 and got["test"] > 0
    jd, pd = (io.dataset_dir(r, kind, name) for r in (jroot, proot))
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
    for fn in os.listdir(jd):
        with open(os.path.join(jd, fn), "rb") as a, \
                open(os.path.join(pd, fn), "rb") as b:
            assert a.read() == b.read(), fn


def scripted(answers):
    answers = list(answers)
    return lambda prompt: answers.pop(0)


def save_unet(path, classes, in_ch, seed, background_bias=0.0):
    model = unet.UNet(classes, in_ch=in_ch)
    init_like_flax(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.head.bias[0] += background_bias
    checkpoints.save_checkpoint(path, weights.unet_variables(model))


def test_app_labeling_flow(tmp_path):
    """The App's menu items 2-4 on the CPU: gen and pred labels, the
    datasets, then Phases A-C with a full-size U-Net; each written file
    matches what the module functions write."""
    root = str(tmp_path)
    ball = synthetic.SphereObject("ball", np.asarray([30.0, 10.0, 40.0]),
                                  40.0, (210, 50, 50),
                                  parts=(((25.0, 25.0, 25.0), 18.0),))
    synthetic.make_dataset(root, objects=[ball], cfg=synthetic.SynthConfig(
        img_h=240, img_w=320, fx=300.0, fy=300.0, n_viewpoints=5))
    gt = io.read_label(os.path.join(io.label_dir(root), "ball", "foreground",
                                    "000002.pred.label.png"))
    save_unet(os.path.join(root, "background_subtraction", "trained_models",
                           "Unet_resnet34.ckpt"), 2, 7, 0)
    lines = []
    app = App(root, reference_point=REF, print_fn=lines.append,
              input_fn=scripted(["a", "0", "d", "synth_gen"]))
    assert app.create_labels(mode="gen", device="cpu") == 5
    assert app.create_dataset(kind="segmentation", mode="gen") == {
        "train": 4, "test": 1, "extra": 0}
    # the App's pred labels equal the module function's with its model
    assert app.create_labels(["ball"], mode="pred", device="cpu") == 5
    pred = io.read_label(os.path.join(io.label_dir(root), "ball",
                                      "foreground", "000002.pred.label.png"))
    cl.create_mask_predictions("ball", root, app._load_bs_model("cpu"),
                               reference_point=REF)
    np.testing.assert_array_equal(pred, io.read_label(os.path.join(
        io.label_dir(root), "ball", "foreground", "000002.pred.label.png")))
    # Phase A falls back to the background subtraction label where the
    # model's mask does not overlap it: a model that sees only background,
    # and the true masks as the background subtraction labels
    for i in range(5):
        src = os.path.join(io.label_dir(root), "ball", "foreground",
                           f"{i:06d}.gen.label.png")
        shutil.copy(src, src.replace(".gen.", ".pred."))
    save_unet(os.path.join(root, "segmentation", "trained_models", "synth",
                           "Unet_resnet34.ckpt"), 2, 3, 1,
              background_bias=100.0)
    app.input_fn = scripted(["0"])          # the dataset: synth
    out = app.create_pose_data(device="cpu")
    assert sorted(out["times"]) == ["pc", "pose", "seg"]
    assert [len(out["times"][k]) for k in ("seg", "pc", "pose")] == [1, 1, 1]
    assert out["stats"] == {"n_samples": 5, "n_extra_samples": 0,
                            "bs_copied": 5, "no_depth_overlap": 0,
                            "not_in_center": 0}
    for fn in ("ball_out.ply", "ball.ply", "ball.xyz", "foreground.ply"):
        assert os.path.exists(os.path.join(io.pc_dir(root), "ball", fn)), fn
    # Phase C: every sample's object position is the reconstructed cloud's
    # bounding-box centre
    cloud = io.read_ply(os.path.join(io.pc_dir(root), "ball", "ball_out.ply"))
    centre = (cloud.min(0) + cloud.max(0)) / 2
    assert len(cloud) > 500
    for i in range(5):
        meta = io.read_pose_label_meta(os.path.join(
            io.label_dir(root), "ball", "foreground", f"{i:06d}.meta.json"))
        np.testing.assert_allclose(meta["robot2object"][:3, 3], centre,
                                   atol=1e-3)
    assert (gt > 0).sum() > 500
    # 'on' starts a one-rank group and hands its mesh to Phase B: the
    # cloud is `load_point_cloud(mesh=)`'s at create_pose_data's settings
    # (the lattice surfaces of every view, gathered), and Phase C labels it
    try:
        cl.create_pose_data(root, ["ball"], "synth", None, REF,
                            new_pred=False, data_parallel="on", device="cpu")
        assert dist.get_world_size() == 1
        want = rec.load_point_cloud(
            "ball", str(tmp_path / "direct"), root, reference_point=REF,
            mode="pred", n_viewpoints=30, min_friends=20, min_dist=5,
            nb_neighbors=20, threshold=10, voxel_size=2, voxel_size_out=5,
            icp_point2point=True, icp_point2plane=False,
            mesh=pmesh.make_mesh(), device="cpu")
    finally:
        dist.destroy_process_group()
    got = io.read_ply(os.path.join(io.pc_dir(root), "ball", "ball.ply"))
    np.testing.assert_allclose(got, want, atol=1e-4)   # the ply's digits
    cloud = io.read_ply(os.path.join(io.pc_dir(root), "ball", "ball_out.ply"))
    centre = (cloud.min(0) + cloud.max(0)) / 2
    meta = io.read_pose_label_meta(os.path.join(
        io.label_dir(root), "ball", "foreground", "000000.meta.json"))
    np.testing.assert_allclose(meta["robot2object"][:3, 3], centre,
                               atol=1e-3)
    with pytest.raises(ValueError, match="data_parallel"):
        cl.create_pose_data(root, ["ball"], "synth", None, REF,
                            new_pred=False, data_parallel="many",
                            device="cpu")


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: cl.create_labels("ball", str(tmp_path)),
                 lambda: cl.create_pose_data(str(tmp_path), [], "synth",
                                             None, REF, new_pred=False)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
