"""The port's public-benchmark loaders and evaluations against the JAX package
on the CPU: `YCBPoseDataset`, `LineModPoseDataset` and `YCBSegDataset` (both
of its branches) on miniature trees written with PIL in the real layouts,
every key equal; the gt.yml reader against `yaml.safe_load`; Pillow's
`GaussianBlur` and `Brightness` in numpy, bit for bit; `eval_ycb` and
`eval_linemod` with the JAX networks' weights carried into the port (f32,
N=64, M=48, 48-pixel crops): distances within 2e-4 and the same hits but
within 2e-4 of the threshold; an object index the PoseNet has no head for
raising before any launch."""
import functools
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as scio
import torch
import yaml
from PIL import Image, ImageEnhance, ImageFilter

from autoposeestimation_tpu.data import legacy_datasets as jlegacy
from autoposeestimation_tpu.data import loader as jloader
from autoposeestimation_tpu.experiments import legacy_eval as jlegacy_eval
from autoposeestimation_tpu.models import densefusion as jdf
from autoposeestimation_tpu.train import densefusion as jdft
from autoposeestimation_tpu.utils import io as jio
from autoposeestimation_tpu_torch import weights
from autoposeestimation_tpu_torch.data import augment as aug
from autoposeestimation_tpu_torch.data import legacy_datasets as legacy
from autoposeestimation_tpu_torch.data import loader
from autoposeestimation_tpu_torch.experiments import legacy_eval
from autoposeestimation_tpu_torch.train import densefusion as dft
from autoposeestimation_tpu_torch.utils import io
from test_torch_models import init_vars
from test_torch_seg_models import two_threads  # noqa: F401

H, W = 48, 64
N, M, B, NUM_OBJ = 64, 48, 2, 3
ATOL = 2e-4     # network outputs, the torch-vs-flax figure
YCB_CLASSES = ["002_master_chef_can", "003_cracker_box", "004_sugar_box"]
YCB_FRAMES = ["data/0001/000001", "data/0001/000002", "data/0061/000001",
              "data/0061/000002"]


def save(path, array, mode=None):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(array, mode).save(path) if mode else \
        Image.fromarray(array).save(path)


def quat_rot(q):
    w, x, y, z = np.asarray(q) / np.linalg.norm(q)
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (w * y + x * z)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (w * x + y * z), 1 - 2 * (x * x + y * y)]])


@pytest.fixture(scope="module")
def ycb_root(tmp_path_factory):
    """Four frames of two or three objects (boxes of depth in their label
    regions); colour as RGB, RGBA and grey PNGs; models of 120 points."""
    root = str(tmp_path_factory.mktemp("ycb"))
    rng = np.random.default_rng(0)
    for cls in YCB_CLASSES:
        model = rng.normal(size=(120, 3)) * 0.04
        os.makedirs(os.path.join(root, "models", cls))
        with open(os.path.join(root, "models", cls, "points.xyz"), "w") as f:
            for p in model:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
    for i, stem in enumerate(YCB_FRAMES):
        base = os.path.join(root, stem)
        ids = [1, 2, 3] if i % 2 == 0 else [3, 1]
        depth = np.zeros((H, W), np.uint16)
        label = np.zeros((H, W), np.uint8)
        for k, cid in enumerate(ids):
            r0, c0 = 4 + 10 * k, 6 + 18 * k
            label[r0:r0 + 14, c0:c0 + 16] = cid
            depth[r0:r0 + 14, c0:c0 + 16] = rng.integers(8000, 9500,
                                                         (14, 16))
        depth[label == 0] = rng.integers(0, 2, (label == 0).sum()) * 9900
        img = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
        if i == 1:
            save(base + "-color.png", img, "RGBA")
        elif i == 2:
            save(base + "-color.png", img[..., 0])
        else:
            save(base + "-color.png", img[..., :3])
        save(base + "-depth.png", depth)
        save(base + "-label.png", label)
        poses = np.stack([np.concatenate(
            [quat_rot(rng.normal(size=4)),
             rng.normal(size=(3, 1)) * 0.05 + [[0.0], [0.0], [0.9]]], 1)
            for _ in ids], axis=2)
        scio.savemat(base + "-meta.mat", {
            "cls_indexes": np.asarray(ids)[:, None], "poses": poses,
            "factor_depth": np.asarray([[10000.0]])})
    return root


GT_YML_FLOW = """\
0:
- cam_R_m2c: [{r}]
  cam_t_m2c: [{t}]
  obj_bb: [244, 150, 44, 58]
  obj_id: {obj}
"""


def linemod_gt(rng, obj, frames):
    """gt.yml in the upstream flow style; object 2's frames also list
    object 1, before it."""
    text = ""
    for fr in range(frames):
        entries = ([1, 2] if obj == 2 else [1])
        text += f"{fr}:\n"
        for o in entries:
            r = quat_rot(rng.normal(size=4)).reshape(-1)
            t = rng.normal(size=3) * 30 + [0.0, 0.0, 800.0]
            text += GT_YML_FLOW.split("\n", 1)[1].format(
                r=", ".join(f"{v:.8f}" for v in r),
                t=", ".join(f"{v:.8f}" for v in t), obj=o)
    return text


@pytest.fixture(scope="module")
def linemod_root(tmp_path_factory):
    """Objects 1 and 2, three frames each (test list: 0 and 2); masks as
    grey PNGs for object 1 and as RGB for object 2, one RGBA colour
    frame; ascii PLY models in mm."""
    root = str(tmp_path_factory.mktemp("linemod"))
    rng = np.random.default_rng(1)
    for obj in (1, 2):
        seq = os.path.join(root, "data", f"{obj:02d}")
        jio.write_ply(os.path.join(root, "models", f"obj_{obj:02d}.ply"),
                      rng.normal(size=(150, 3)) * 30)
        for fr in range(3):
            img = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
            depth = np.zeros((H, W), np.uint16)
            mask = np.zeros((H, W), np.uint8)
            r0, c0 = 6 + 4 * fr, 10 + 6 * obj
            depth[r0:r0 + 20, c0:c0 + 24] = rng.integers(750, 850, (20, 24))
            mask[r0:r0 + 20, c0:c0 + 24] = 255
            name = f"{fr:04d}.png"
            save(os.path.join(seq, "rgb", name),
                 img if fr == 1 else img[..., :3], "RGBA" if fr == 1 else None)
            save(os.path.join(seq, "depth", name), depth)
            save(os.path.join(seq, "mask", name),
                 mask if obj == 1 else np.stack([mask] * 3, -1))
        with open(os.path.join(seq, "gt.yml"), "w") as f:
            f.write(linemod_gt(rng, obj, 3))
        for mode, frames in (("train", "0000\n0001\n0002\n"),
                             ("test", "0000\n0002\n")):
            with open(os.path.join(seq, f"{mode}.txt"), "w") as f:
                f.write(frames)
    return root


def assert_items_equal(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# --- datasets ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_ycb_pose_dataset(ycb_root, seed):
    kw = dict(num_pt=N, num_pt_mesh=M, crop=32, seed=seed)
    got = legacy.YCBPoseDataset(ycb_root, YCB_FRAMES, YCB_CLASSES, **kw)
    want = jlegacy.YCBPoseDataset(ycb_root, YCB_FRAMES, YCB_CLASSES, **kw)
    assert got.get_sym_list() == want.get_sym_list() and len(got) == 4
    for cid in want.cld:
        np.testing.assert_array_equal(got.cld[cid], want.cld[cid])
    for i in [0, 1, 2, 3, 2, 0]:
        assert_items_equal(got[i], want[i])


@pytest.mark.parametrize("mode,kw", [("train", dict(num_pt=N, num_pt_mesh=M)),
                                     ("test", dict(num_pt=500, crop=32))])
def test_linemod_pose_dataset(linemod_root, mode, kw):
    got = legacy.LineModPoseDataset(linemod_root, [1, 2], mode=mode, **kw)
    want = jlegacy.LineModPoseDataset(linemod_root, [1, 2], mode=mode, **kw)
    assert got.items == want.items
    assert got.gt == want.gt
    for obj in (1, 2):
        np.testing.assert_array_equal(got.cld[obj], want.cld[obj])
    for i in list(range(len(want))) * 2:
        assert_items_equal(got[i], want[i])


def write_seg_frames(ycb_root):
    """Two synthetic frames (labels with a background) beside the real
    ones."""
    rng = np.random.default_rng(3)
    for k in (1, 2):
        base = os.path.join(ycb_root, "data_syn", f"00000{k}")
        label = np.zeros((H, W), np.uint8)
        label[5 + k:30, 8:40 + k] = k
        save(base + "-color.png",
             rng.integers(0, 256, (H, W, 3)).astype(np.uint8))
        save(base + "-label.png", label)


@pytest.mark.parametrize("use_noise", [False, True])
def test_ycb_seg_dataset(ycb_root, use_noise):
    """Thirty items of each dataset from one list of real and synthetic
    frames: every item equal, and both branches taken."""
    write_seg_frames(ycb_root)
    paths = (["data_syn/000001", "data_syn/000002"] + YCB_FRAMES) * 3
    got = legacy.YCBSegDataset(ycb_root, paths, use_noise, length=30, seed=4)
    want = jlegacy.YCBSegDataset(ycb_root, paths, use_noise, length=30,
                                 seed=4)
    loaded = []
    load = got._load
    got._load = lambda stem: loaded.append(stem) or load(stem)
    for i in range(30):
        assert_items_equal(got[i], want[i])
    assert any(s.startswith("data_syn") for s in loaded)
    assert any(s.startswith("data/") for s in loaded)
    assert got.real_path == want.real_path


def test_palette_png_raises(tmp_path):
    """A palette colour frame is not decoded halfway: it raises, naming
    the file; so does a 16-bit one."""
    path = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(path)
    with pytest.raises(ValueError, match="p.png: unsupported PNG.*colour "
                                         "type 3"):
        io.read_color(path)
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(path)
    with pytest.raises(ValueError, match="not a colour image"):
        io.read_color(path)


# --- gt.yml ------------------------------------------------------------------

def test_gt_yml_reader(linemod_root, tmp_path):
    """The upstream flow-style files, and what PyYAML itself writes (block
    lists, ints, floats with exponents, an empty frame)."""
    for obj in (1, 2):
        path = os.path.join(linemod_root, "data", f"{obj:02d}", "gt.yml")
        with open(path) as f:
            want = yaml.safe_load(f)
        assert legacy.read_gt_yml(path) == want
    rng = np.random.default_rng(7)
    data = {fr: [{"cam_R_m2c": rng.normal(size=9).tolist(),
                  "cam_t_m2c": (rng.normal(size=3) * 1e-7).tolist(),
                  "obj_bb": [int(v) for v in rng.integers(0, 640, 4)],
                  "obj_id": int(rng.integers(1, 16))} for _ in range(fr % 3)]
            for fr in range(6)}
    for flow in (False, None):
        path = str(tmp_path / f"gt_{flow}.yml")
        with open(path, "w") as f:
            yaml.safe_dump(data, f, default_flow_style=flow)
        with open(path) as f:
            assert legacy.read_gt_yml(path) == yaml.safe_load(f) == data


# --- Pillow's blur and brightness --------------------------------------------

@pytest.mark.parametrize("hw", [(7, 5), (48, 64), (97, 131)])
@pytest.mark.parametrize("seed", range(20))
def test_brightness_and_gaussian_blur(hw, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    pil = Image.fromarray(img)
    want = np.asarray(ImageEnhance.Brightness(pil).enhance(1.5).filter(
        ImageFilter.GaussianBlur(radius=0.8)))
    got = aug.gaussian_blur(aug.adjust_brightness(img, 1.5), 0.8)
    np.testing.assert_array_equal(got, want)
    sigma = float(rng.uniform(0.2, 6.0))
    np.testing.assert_array_equal(
        aug.gaussian_blur(img[..., 0], sigma),
        np.asarray(Image.fromarray(img[..., 0]).filter(
            ImageFilter.GaussianBlur(radius=sigma))))


# --- the evaluations ---------------------------------------------------------

@pytest.fixture(scope="module")
def states():
    """The JAX networks (3 objects, f32) with numpy-drawn weights, as the
    evaluations read them from a trainer, and the port's trainer with those
    weights; both in the refiner phase."""
    jpose = jdf.PoseNet(num_obj=NUM_OBJ, dtype=jnp.float32)
    jref = jdf.PoseRefineNet(num_obj=NUM_OBJ, dtype=jnp.float32)
    img = np.zeros((B, H, H, 3), np.float32)
    cloud = np.zeros((B, N, 3), np.float32)
    obj = np.zeros((B,), np.int32)
    pose_vars = init_vars(jpose, img, cloud, np.zeros((B, N), np.int32), obj,
                          seed=1)
    ref_vars = init_vars(jref, cloud, np.zeros((B, N, 32), np.float32), obj,
                         seed=2)
    cfg = dft.DFConfig(num_points=N, num_points_mesh=M, batch_size=B)
    jstate = types.SimpleNamespace(
        cfg=jdft.DFConfig(num_points=N, num_points_mesh=M, batch_size=B),
        posenet=jpose, refiner=jref, pose_vars=pose_vars,
        refine_vars=ref_vars, refine_start=True, w=cfg.w)
    pstate = dft.create_trainer(NUM_OBJ, cfg, dtype=torch.float32,
                                device="cpu")
    pstate.posenet.load_state_dict(weights.posenet_state_dict(pose_vars))
    pstate.refiner.load_state_dict(weights.refiner_state_dict(ref_vars))
    pstate.refine_start = True
    return jstate, pstate


@pytest.fixture
def one_thread_loaders(monkeypatch):
    """The datasets draw from one generator: Loader threads would take the
    draws in any order (in both packages), so the items come in order."""
    for mod in (loader, jloader):
        monkeypatch.setattr(mod, "Loader", functools.partial(
            mod.Loader, num_workers=0))


def assert_results_close(got, want, thresholds):
    assert sorted(got) == sorted(want)
    for cls in want:
        for key, val in want[cls].items():
            if key == "dis":
                np.testing.assert_allclose(got[cls][key], val, atol=ATOL)
            elif key not in ("hit", "miss", "success_rate") or \
                    not thresholds.get(cls):
                assert got[cls][key] == val, (cls, key)


def per_sample(mod, state, calls):
    """Wrap the package's eval_step to record each batch's distances."""
    step = mod.eval_step

    def recording(*args, **kw):
        dis = step(*args, **kw)
        calls.append(np.asarray(dis.cpu() if torch.is_tensor(dis) else dis))
        return dis
    return recording


def test_eval_ycb_and_linemod_against_jax(ycb_root, linemod_root, states,
                                          one_thread_loaders, monkeypatch,
                                          tmp_path):
    jstate, pstate = states
    jdis, pdis = [], []
    monkeypatch.setattr(jdft, "eval_step", per_sample(jdft, jstate, jdis))
    monkeypatch.setattr(dft, "eval_step", per_sample(dft, pstate, pdis))
    runs = [
        (lambda mod, st: mod.eval_ycb(st, ycb_root, YCB_FRAMES * 2,
                                      YCB_CLASSES, batch_size=B,
                                      out_path=str(tmp_path / "ycb.json")),
         lambda d, o: 0.02),
        (lambda mod, st: mod.eval_linemod(
            st, linemod_root, [1, 2], batch_size=B,
            out_path=str(tmp_path / "linemod.json")), None)]
    for run, threshold in runs:
        jdis.clear()
        pdis.clear()
        want = run(jlegacy_eval, jstate)
        got = run(legacy_eval, pstate)
        j, p = np.concatenate(jdis), np.concatenate(pdis)
        assert p.shape == j.shape and p.shape[0] >= 4
        np.testing.assert_allclose(p, j, atol=ATOL)
        # a class whose samples lie within ATOL of its threshold may count
        # a hit as a miss
        if threshold is None:
            ds = legacy.LineModPoseDataset(linemod_root, [1, 2], mode="test")
            near = {f"obj_{o:02d}": True for o in (1, 2) if np.any(np.abs(
                p - 0.1 * 2 * np.linalg.norm(
                    ds.cld[o] - ds.cld[o].mean(0), axis=1).max()) < ATOL)}
        else:
            near = {cls: bool(np.any(np.abs(p - 0.02) < ATOL))
                    for cls in YCB_CLASSES}
        assert_results_close(got, want, near)
    assert jio.read_json(str(tmp_path / "linemod.json")).keys() == \
        {"obj_01", "obj_02"}
    assert "overall" in jio.read_json(str(tmp_path / "ycb.json"))


def test_object_index_out_of_range_raises(ycb_root, states,
                                          one_thread_loaders, monkeypatch):
    """LineMOD id 4 is index 3 of a 3-object PoseNet: a ValueError before
    the dataset is read. YCB classes beyond a 1-object PoseNet raise
    before their batch is launched."""
    _, pstate = states
    with pytest.raises(ValueError, match=r"\[3\] out of range"):
        legacy_eval.eval_linemod(pstate, "/nonexistent", [1, 4])
    small = dft.create_trainer(1, pstate.cfg, dtype=torch.float32,
                               device="cpu")
    launched = []
    step = dft.eval_step
    monkeypatch.setattr(dft, "eval_step", lambda posenet, refiner, batch,
                        *a: launched.append(batch["obj_idx"].max().item())
                        or step(posenet, refiner, batch, *a))
    with pytest.raises(ValueError, match="out of range for a PoseNet of 1"):
        legacy_eval.eval_ycb(small, ycb_root, YCB_FRAMES * 2, YCB_CLASSES,
                             batch_size=2)
    assert all(i < 1 for i in launched)
