"""The slice as a whole, port against the JAX package on the CPU in f32:
`full_prediction` and `pose_from_mask` on a synthetic frame with the JAX
draws handed over as `uniforms`, the evaluation step and `evaluate` on the
JAX package's batch layout (img (B, S, S, 3)), the checkpoint reader and
the prediction loader. Masks, `found` and `choose` exactly; poses and
distances within 1e-4 (network outputs agree to 2e-4)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoposeestimation_tpu.experiments import eval as jeval
from autoposeestimation_tpu.models import densefusion as jdf
from autoposeestimation_tpu.pipeline import predict as jpredict
from autoposeestimation_tpu.train import checkpoints as jckpt
from autoposeestimation_tpu.train import densefusion as jtrain
from autoposeestimation_tpu.utils import synthetic as jsynth
from autoposeestimation_tpu_torch import weights
from autoposeestimation_tpu_torch.experiments import eval as peval
from autoposeestimation_tpu_torch.models.common import normalize_imagenet
from autoposeestimation_tpu_torch.models.densefusion import (PoseNet,
                                                             PoseRefineNet)
from autoposeestimation_tpu_torch.pipeline import predict
from autoposeestimation_tpu_torch.train import checkpoints
from autoposeestimation_tpu_torch.train import densefusion as dft
from autoposeestimation_tpu_torch.utils import synthetic
from autoposeestimation_tpu_torch.utils.io import Intrinsics
from test_torch_models import init_vars

H, W, CROP, NPT, K = 96, 128, 32, 64, 2
ATOL = 1e-4


@pytest.fixture(scope="module")
def variables():
    from autoposeestimation_tpu.models import unet as junet

    seg = init_vars(junet.UNet(classes=K + 1, dtype=jnp.float32),
                    np.zeros((1, H, W, 3), np.float32), seed=1)
    pose = init_vars(jdf.PoseNet(num_obj=K, dtype=jnp.float32),
                     np.zeros((K, CROP, CROP, 3), np.float32),
                     np.zeros((K, NPT, 3), np.float32),
                     np.zeros((K, NPT), np.int32), np.zeros(K, np.int32),
                     seed=2)
    refine = init_vars(jdf.PoseRefineNet(num_obj=K, dtype=jnp.float32),
                       np.zeros((K, NPT, 3), np.float32),
                       np.zeros((K, NPT, 32), np.float32),
                       np.zeros(K, np.int32), seed=3)
    return seg, pose, refine


def build_pair(variables, emb_stride):
    seg, pose, refine = variables
    mp = np.random.default_rng(0).normal(size=(K, 60, 3)).astype(
        np.float32) * 0.05
    kw = dict(num_points=NPT, crop=CROP, refine_iters=2, emb_stride=emb_stride,
              seg_vars=seg, pose_vars=pose, refine_vars=refine)
    jm = jpredict.build_models(K, mp, ("mug", "box"), dtype=jnp.float32,
                               img_hw=(H, W), **kw)
    tm = predict.build_models(K, mp, ("mug", "box"), dtype=torch.float32,
                              device="cpu", **kw)
    return jm, tm


def frame():
    """The synthetic two-sphere scene seen from the first ring camera."""
    cfg = synthetic.SynthConfig(img_h=H, img_w=W, fx=220.0, fy=220.0)
    spheres = [
        synthetic.SphereObject("mug", np.asarray([40.0, 0.0, 35.0]), 35.0,
                               (200, 40, 40)),
        synthetic.SphereObject("box", np.asarray([-50.0, 30.0, 28.0]), 28.0,
                               (40, 60, 200)),
    ]
    cam = synthetic.ring_cameras(cfg, np.zeros(3))[0]
    image, depth, owner = synthetic.render(cfg, cam, spheres)
    meta = {"intr": Intrinsics(width=W, height=H, ppx=W / 2, ppy=H / 2,
                               fx=cfg.fx, fy=cfg.fy), "depth_scale": 0.001}
    return image, depth.astype(np.float32), meta, owner, (cfg, cam, spheres)


def test_synthetic_scene_matches():
    image, depth, _, owner, (cfg, cam, spheres) = frame()
    jcfg = jsynth.SynthConfig(img_h=H, img_w=W, fx=220.0, fy=220.0)
    jspheres = [jsynth.SphereObject(s.name, s.center, s.radius, s.color)
                for s in spheres]
    jimage, jdepth, jowner = jsynth.render(jcfg, cam, jspheres)
    np.testing.assert_array_equal(image, jimage)
    np.testing.assert_array_equal(depth, jdepth.astype(np.float32))
    np.testing.assert_array_equal(owner, jowner)
    assert (owner >= 0).sum() > 500
    _, _, mp = synthetic.headline_scene()
    np.testing.assert_array_equal(mp, jsynth.headline_scene()[2])


@pytest.mark.parametrize("emb_stride", [1, 8])
def test_full_prediction(variables, emb_stride):
    jm, tm = build_pair(variables, emb_stride)
    image, depth, meta, _, _ = frame()
    key = jax.random.PRNGKey(7)
    u = np.stack([np.asarray(jax.random.uniform(k, (NPT,)))
                  for k in jax.random.split(key, K)])
    want = jpredict._full_prediction_jit(
        jm.seg_vars, jm.pose_vars, jm.refine_vars, jnp.asarray(image),
        jnp.asarray(depth), jnp.asarray(meta["intr"].as_array()),
        jnp.float32(0.001), key, jpredict.static_tuple(jm))
    with torch.inference_mode():
        frame_t = predict._frame_inputs(image, depth, meta, tm.device)
        got = predict._predict_frame(tm, *frame_t, torch.from_numpy(u))
    assert np.asarray(want["found"]).any()
    for name in ("found", "masks", "argmax", "cca_converged",
                 "masks_packed"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    for name in ("quats", "positions"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=ATOL, err_msg=name)

    # the host wrapper's contract on the same draws
    out = predict.full_prediction(image, depth, meta, tm, uniforms=u)
    jout = jpredict.full_prediction(image, depth, meta, jm, key=key)
    assert set(out) == set(jout)
    assert out["cca_converged"] == jout["cca_converged"]
    assert set(out["predictions"]) == set(jout["predictions"])
    for cls, p in out["predictions"].items():
        np.testing.assert_array_equal(p["mask"], jout["predictions"][cls][
            "mask"])
        np.testing.assert_allclose(p["position"],
                                   jout["predictions"][cls]["position"],
                                   atol=ATOL)


def test_pose_from_mask(variables):
    jm, tm = build_pair(variables, 8)
    image, depth, meta, owner, _ = frame()
    mask = owner == 1
    key = jax.random.PRNGKey(3)
    want = jpredict.pose_from_mask(image, depth, meta, jm, mask, "box",
                                   key=key)
    got = predict.pose_from_mask(image, depth, meta, tm, mask, "box",
                                 uniforms=np.asarray(
                                     jax.random.uniform(key, (NPT,))))
    assert got["count"] == want["count"] > 0
    np.testing.assert_allclose(got["position"], want["position"], atol=ATOL)
    np.testing.assert_allclose(got["rotation"], want["rotation"], atol=ATOL)


def test_pose_from_mask_repeats_without_generator(variables):
    """Without `generator` and `uniforms` the draws come from a fixed seed,
    as the JAX side's PRNGKey(0): two calls give the same pose."""
    _, tm = build_pair(variables, 8)
    image, depth, meta, owner, _ = frame()
    first, again = (predict.pose_from_mask(image, depth, meta, tm, owner == 1,
                                           "box") for _ in range(2))
    assert first["count"] == again["count"] > 0
    np.testing.assert_array_equal(first["position"], again["position"])
    np.testing.assert_array_equal(first["rotation"], again["rotation"])


def test_class_mask_sum_rule_rejects_confident_fragment():
    """The serving rule 'sum' picks the large body over a small, more
    confident fragment; 'mean_float' picks the fragment. Port and JAX agree
    at CCA scale 1 and 8."""
    h, w = 48, 64
    pred_arg = np.zeros((h, w), np.int32)
    score = np.zeros((h, w), np.float32)
    pred_arg[10:24, 8:24] = 1
    score[10:24, 8:24] = 0.98
    pred_arg[30:40, 40:52] = 1
    score[30:40, 40:52] = 0.99
    for scale in (1, 8):
        for rule, pick in (("sum", (slice(10, 24), slice(8, 24))),
                           ("mean_float", (slice(30, 40), slice(40, 52)))):
            comp, found, conv = predict._class_mask(
                torch.from_numpy(score), torch.from_numpy(pred_arg), 1,
                cca_scale=scale, cca_sweeps=3, cca_rule=rule)
            jcomp, jfound, jconv = jpredict._class_mask(
                jnp.asarray(score), jnp.asarray(pred_arg), 1,
                cca_scale=scale, cca_sweeps=3, cca_rule=rule)
            np.testing.assert_array_equal(comp.numpy(), np.asarray(jcomp))
            assert bool(found) == bool(jfound) is True
            assert bool(conv) == bool(jconv)
            assert comp.numpy()[pick].all()
            assert comp.numpy().sum() == comp.numpy()[pick].size


def test_entry_points_default_to_cuda():
    """Without a device the entry points ask for CUDA and raise where there
    is none; they never fall back to the CPU silently."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        predict.build_models(K, np.zeros((K, 4, 3), np.float32),
                             ("mug", "box"))


def eval_batch(seed, b=4, m=20):
    rng = np.random.default_rng(seed)
    model = (rng.normal(size=(b, m, 3)) * 0.05).astype(np.float32)
    cloud = (rng.normal(size=(b, NPT, 3)) * 0.05 + [0, 0, 0.6]).astype(
        np.float32)
    return {
        "img": rng.normal(size=(b, CROP, CROP, 3)).astype(np.float32),
        "cloud": cloud,
        "choose": rng.integers(0, CROP * CROP, (b, NPT)).astype(np.int32),
        "target": (model + cloud[:, :1]).astype(np.float32),
        "model_points": model,
        "obj_idx": (np.arange(b) % K).astype(np.int32),
        "is_sym": np.arange(b) % 2 == 1,
        "target_t": cloud[:, 0],
    }


def to_port(batch):
    """The numpy batch as CPU tensors, still in the JAX layout."""
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def eval_pair(variables):
    _, pose, refine = variables
    jpose = jdf.PoseNet(num_obj=K, dtype=jnp.float32)
    jref = jdf.PoseRefineNet(num_obj=K, dtype=jnp.float32)
    tpose, tref = PoseNet(K).eval(), PoseRefineNet(K).eval()
    tpose.load_state_dict(weights.posenet_state_dict(pose))
    tref.load_state_dict(weights.refiner_state_dict(refine))
    return (jpose, jref, pose, refine), (tpose, tref)


@pytest.mark.parametrize("refine_start", [False, True])
def test_eval_step_full(eval_pair, refine_start):
    (jpose, jref, pose, refine), (tpose, tref) = eval_pair
    batch = eval_batch(4)
    want = jtrain.eval_step_full(pose, refine, batch, 0.015, jpose, jref,
                                 refine_start, 2, True)
    got = dft.eval_step_full(tpose, tref, dft.to_device(batch, "cpu"),
                             0.015, refine_start, 2, True)
    for name, g, w_ in zip(("dis", "quat", "trans"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=ATOL,
                                   err_msg=name)


def assert_evaluate_matches(eval_pair, seeds, port_batch):
    """The JAX `evaluate` on the numpy batches of `seeds` against the port's
    on `port_batch` of each: counts, `p` and `overall` equal, `dis` and
    `t_err` within ATOL."""
    (jpose, jref, pose, refine), (tpose, tref) = eval_pair
    batches = [eval_batch(s) for s in seeds]
    state = jtrain.TrainerState(cfg=jtrain.DFConfig(), posenet=jpose,
                                refiner=jref, pose_vars=pose,
                                refine_vars=refine, tx=None, opt_state=None)
    want = jeval.evaluate(state, lambda: iter(batches), ("mug", "box"))
    got = peval.evaluate(dft.EvalModels(tpose, tref),
                         lambda: (port_batch(b) for b in batches),
                         ("mug", "box"))
    assert got["overall"] == want["overall"]
    assert got["overall"]["n"] == 4 * len(seeds)
    for cls in ("mug", "box"):
        for k in ("<2", ">=2", "p"):
            assert got[cls][k] == want[cls][k]
        for k in ("dis", "t_err"):
            np.testing.assert_allclose(got[cls][k], want[cls][k], atol=ATOL)


def test_evaluate(eval_pair):
    assert_evaluate_matches(eval_pair, (5, 6), to_port)

    rng = np.random.default_rng(7)
    q, pos = rng.normal(size=4), rng.normal(size=3)
    rot, tr = np.eye(3), rng.normal(size=3)
    mp = rng.normal(size=(30, 3)) * 0.05
    for sym in (False, True):
        np.testing.assert_allclose(
            peval.add_from_pose(q, pos, rot, tr, mp, sym),
            jeval.add_from_pose(q, pos, rot, tr, mp, sym), rtol=1e-6)


def test_evaluate_on_loader_batches(eval_pair):
    """The Loader's numpy batches (img (B, S, S, 3)) go unchanged to both
    `evaluate`s."""
    assert_evaluate_matches(eval_pair, (11, 12), lambda b: b)


def test_to_device_takes_channels_last():
    """A channels-last batch, as numpy arrays or as CPU tensors, becomes the
    same channels-first batch; a channels-first img is refused."""
    batch = eval_batch(13)
    from_numpy = dft.to_device(batch, "cpu")
    from_tensors = dft.to_device(to_port(batch), "cpu")
    assert set(from_numpy) == set(from_tensors) == set(batch)
    for key, val in from_numpy.items():
        assert torch.equal(val, from_tensors[key]), key
    img = from_numpy["img"]
    assert img.shape == (4, 3, CROP, CROP) and img.is_contiguous()
    np.testing.assert_array_equal(img.numpy(),
                                  np.moveaxis(batch["img"], -1, 1))
    assert from_numpy["choose"].dtype == from_numpy["obj_idx"].dtype \
        == torch.int64
    assert from_numpy["cloud"].dtype == torch.float32
    assert from_numpy["is_sym"].dtype == torch.bool
    with pytest.raises(ValueError, match="channels last"):
        dft.to_device({**batch, "img": np.moveaxis(batch["img"], -1, 1)},
                      "cpu")


def test_checkpoint_round_trip(tmp_path, eval_pair):
    """JAX save_checkpoint -> the port's reader -> identical outputs; the
    optimizer state beside the variables is read back apart, as the JAX
    reader gives it."""
    (jpose, _, pose, _), (tpose, _) = eval_pair
    path = str(tmp_path / "pose_model")
    jckpt.save_checkpoint(path, pose, meta={"epoch": 3},
                          opt_state={"count": np.int32(5)})
    ck = checkpoints.load_checkpoint(path)
    assert ck["meta"] == {"epoch": 3}
    assert set(ck) == {"variables", "opt_state", "meta"}
    assert ck["opt_state"] == {"count": 5}
    assert ck["opt_state"]["count"].dtype == np.int32
    assert set(ck["variables"]) == set(pose)
    loaded = PoseNet(K).eval()
    loaded.load_state_dict(weights.posenet_state_dict(ck["variables"]))
    b = dft.to_device(eval_batch(8), "cpu")
    with torch.no_grad():
        args = (b["img"], b["cloud"], b["choose"], b["obj_idx"])
        for g, w_ in zip(loaded(*args), tpose(*args)):
            torch.testing.assert_close(g, w_, rtol=0, atol=0)


def test_get_prediction_models(tmp_path, variables):
    """The loader reads classes, wrap-padded model clouds and the three
    checkpoints, and picks emb_stride 2 for a symmetric dataset."""
    seg, pose, refine = variables
    root = str(tmp_path)
    ds = os.path.join(root, "label_generator", "data_sets", "segmentation",
                      "ds")
    os.makedirs(ds)
    with open(os.path.join(ds, "classes.txt"), "w") as f:
        f.write("mug\nbox\n")
    rng = np.random.default_rng(9)
    for cls, n in (("mug", 7), ("box", 5)):
        d = os.path.join(root, "pc_reconstruction", "data", cls)
        os.makedirs(d)
        with open(os.path.join(d, f"{cls}.xyz"), "w") as f:
            for p in rng.normal(size=(n, 3)) * 40:
                f.write("%s\n" % p)
        run = os.path.join(root, "data_generation", "data", cls, "fg")
        os.makedirs(run)
        with open(os.path.join(run, "000000.meta.json"), "w") as f:
            f.write('{"intr": {"width": 128, "height": 96, "ppx": 64, '
                    '"ppy": 48, "fx": 110, "fy": 110}, "symmetric": %d}'
                    % (cls == "box"))
    jckpt.save_checkpoint(os.path.join(
        root, "segmentation", "trained_models", "ds", "Unet_resnet34.ckpt"),
        seg)
    pose_dir = os.path.join(root, "DenseFusion", "trained_models", "ds")
    jckpt.save_checkpoint(os.path.join(pose_dir, "pose_model"), pose)
    jckpt.save_checkpoint(os.path.join(pose_dir, "pose_refine_model"), refine)

    jm = jpredict.get_prediction_models(root, "ds", dtype=jnp.float32)
    tm = predict.get_prediction_models(root, "ds", dtype=torch.float32,
                                       device="cpu")
    assert tm.classes == jm.classes == ("mug", "box")
    assert tm.emb_stride == jm.emb_stride == 2
    assert predict.dataset_has_symmetric(root, ["mug"]) is False
    np.testing.assert_allclose(tm.model_points.numpy(),
                               np.asarray(jm.model_points), rtol=1e-6)
    want = weights.unet_state_dict(seg)
    for key, value in tm.seg_model.state_dict().items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0)
    img = torch.from_numpy(frame()[0]).permute(2, 0, 1)
    with torch.no_grad():
        logits = tm.seg_model(normalize_imagenet(img)[None])
    want_logits = jax.jit(jm.seg_model.apply)(jm.seg_vars, jnp.asarray(
        normalize_imagenet(img)[None].permute(0, 2, 3, 1).numpy()))
    np.testing.assert_allclose(logits.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_logits), atol=2e-4)
