"""The rest of serving, port against the JAX package on the CPU in f32 at
96x128, K = 2, crop 32, 64 points: the batched B*K-lane graph
(`_predict_batch` against `_full_prediction_batched_jit`), `serve_stream`
against JAX's `serve_stream` on the same key (batch 1, batch 3 with a padded
tail, an intrinsics change that dispatches the open batch), the stream
without masks and with uint16 depth, and the colour overlays of
`full_prediction`. Masks, `found`, `argmax` and `cca_converged` exactly;
poses within 1e-4; overlays pixel for pixel. The JAX draws are handed to
the port as `uniforms`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoposeestimation_tpu.pipeline import predict as jpredict
from autoposeestimation_tpu.pipeline import visualize as jviz
from autoposeestimation_tpu_torch.pipeline import predict
from autoposeestimation_tpu_torch.pipeline import visualize as viz
from autoposeestimation_tpu_torch.utils import synthetic
from autoposeestimation_tpu_torch.utils.io import Intrinsics
from test_torch_pipeline import ATOL, H, K, NPT, W, build_pair, frame
from test_torch_pipeline import variables  # noqa: F401  (a fixture)

EXACT = ("found", "masks", "argmax", "cca_converged", "masks_packed")


@pytest.fixture(scope="module")
def pair(variables):  # noqa: F811
    return build_pair(variables, 8)


def meta_for(fx):
    return {"intr": Intrinsics(width=W, height=H, ppx=W / 2, ppy=H / 2,
                               fx=fx, fy=fx), "depth_scale": 0.001}


def stream_frames(n, fx=None):
    """n views of the two-sphere scene from successive ring cameras
    (image, depth f32, meta); `fx` (a list) changes each frame's fx."""
    _, _, meta, _, (cfg, _, spheres) = frame()
    cams = synthetic.ring_cameras(cfg, np.zeros(3))
    out = []
    for i in range(n):
        image, depth, _ = synthetic.render(cfg, cams[i], spheres)
        m = meta if fx is None else meta_for(fx[i])
        out.append((image, depth.astype(np.float32), m))
    return out


def lane_draws(frame_key):
    """The (K, NPT) draws the JAX graphs take from a frame's key."""
    return np.stack([np.asarray(jax.random.uniform(k, (NPT,)))
                     for k in jax.random.split(frame_key, K)])


def stream_draws(key, metas, batch):
    """Each frame's draws in JAX's `serve_stream(key=key, batch=batch)`:
    fold_in(key, i) at batch 1; split(fold_in(key, f0), batch)[i - f0] in
    a batch that starts at frame f0, batches grouped while the
    intrinsics and depth_scale match."""
    if batch == 1:
        return [lane_draws(jax.random.fold_in(key, i))
                for i in range(len(metas))]
    keys, group = [], []

    def flush():
        k = jax.random.split(jax.random.fold_in(key, len(keys)), batch)
        keys.extend(k[:len(group)])
        group.clear()

    for meta in metas:
        ck = (tuple(meta["intr"].as_array().tolist()), meta["depth_scale"])
        if group and ck != group[-1]:
            flush()
        group.append(ck)
        if len(group) == batch:
            flush()
    if group:
        flush()
    return [lane_draws(k) for k in keys]


def assert_same_stream(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["cca_converged"] == w["cca_converged"]
        assert set(g["predictions"]) == set(w["predictions"])
        for cls, p in w["predictions"].items():
            q = g["predictions"][cls]
            assert set(q) == set(p)
            np.testing.assert_allclose(q["position"], p["position"],
                                       atol=ATOL)
            np.testing.assert_allclose(q["rotation"], p["rotation"],
                                       atol=ATOL)
            if "mask" in p:
                np.testing.assert_array_equal(q["mask"], p["mask"])


def test_predict_batch_matches_jax(pair):
    """B = 3 frames in one call: frame i with key split(key, 3)[i]."""
    jm, tm = pair
    frames = stream_frames(3)
    images = np.stack([f[0] for f in frames])
    depths = np.stack([f[1] for f in frames])
    intr = frames[0][2]["intr"].as_array()
    key = jax.random.PRNGKey(42)
    want = jpredict._full_prediction_batched_jit(
        jm.seg_vars, jm.pose_vars, jm.refine_vars, jnp.asarray(images),
        jnp.asarray(depths), jnp.asarray(intr), jnp.float32(0.001), key,
        jpredict.static_tuple(jm))
    u = np.stack([lane_draws(k) for k in jax.random.split(key, 3)])
    with torch.inference_mode():
        got = predict._predict_batch(
            tm, torch.from_numpy(images), torch.from_numpy(depths),
            torch.from_numpy(intr), torch.tensor(0.001), torch.from_numpy(u))
    assert set(got) == set(want)
    assert np.asarray(want["found"]).sum() >= 3
    for name in EXACT:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    for name in ("quats", "positions"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=ATOL, err_msg=name)


def test_predict_batch_of_one_is_predict_frame(pair):
    """At B = 1 the lane graph gives `_predict_frame`'s outputs exactly."""
    _, tm = pair
    image, depth, meta, _, _ = frame()
    u = np.random.default_rng(5).random((K, NPT)).astype(np.float32)
    with torch.inference_mode():
        img, dep, intr, scale = predict._frame_inputs(image, depth, meta,
                                                      tm.device)
        one = predict._predict_frame(tm, img, dep, intr, scale,
                                     torch.from_numpy(u))
        batched = predict._predict_batch(tm, img[None], dep[None], intr,
                                         scale, torch.from_numpy(u)[None])
    assert one["found"].any()
    assert set(one) == set(batched)
    for name, value in one.items():
        assert torch.equal(batched[name][0], value), name


@pytest.mark.parametrize("batch,in_flight,fx", [
    (1, 2, None),                              # one frame a call
    (3, 1, None),                              # a full batch, a padded tail
    (3, 2, [220.0, 220.0, 150.0, 150.0, 150.0]),  # fx changes at frame 2
])
def test_serve_stream_matches_jax(pair, batch, in_flight, fx):
    jm, tm = pair
    frames = stream_frames(5, fx)
    key = jax.random.PRNGKey(11)
    want = list(jpredict.serve_stream(iter(frames), jm, in_flight=in_flight,
                                      key=key, batch=batch))
    draws = stream_draws(key, [m for _, _, m in frames], batch)
    got = list(predict.serve_stream(iter(frames), tm, in_flight=in_flight,
                                    uniforms=draws, batch=batch))
    assert sum(len(w["predictions"]) for w in want) >= 5
    assert_same_stream(got, want)


@pytest.mark.parametrize("variant", ["no_masks", "uint16_depth"])
def test_serve_stream_variants(pair, variant):
    """`want_masks=False` gives the same poses without masks; the camera's
    uint16 depth, cast on the device, gives what the same depth in f32
    gives."""
    _, tm = pair
    frames = [(im, np.round(d), m) for im, d, m in stream_frames(5)]
    draws = list(np.random.default_rng(9).random((5, K, NPT)).astype(
        np.float32))
    want = list(predict.serve_stream(iter(frames), tm, in_flight=2,
                                     uniforms=draws, batch=3))
    if variant == "no_masks":
        got = list(predict.serve_stream(iter(frames), tm, in_flight=2,
                                        uniforms=draws, batch=3,
                                        want_masks=False))
        for w in want:
            for p in w["predictions"].values():
                del p["mask"]
    else:
        frames = [(im, d.astype(np.uint16), m) for im, d, m in frames]
        got = list(predict.serve_stream(iter(frames), tm, in_flight=2,
                                        uniforms=draws, batch=3))
    assert sum(len(w["predictions"]) for w in want) >= 5
    for g, w in zip(got, want):
        for cls, p in w["predictions"].items():
            assert set(g["predictions"][cls]) == set(p)
    assert_same_stream(got, want)


def test_full_prediction_color_matches_jax(pair):
    """The painted overlays of `full_prediction(color_prediction=True,
    with_bbox=True)`, pixel for pixel."""
    jm, tm = pair
    image, depth, meta, _, _ = frame()
    key = jax.random.PRNGKey(7)
    want = jpredict.full_prediction(image, depth, meta, jm, key=key,
                                    color_prediction=True, with_bbox=True)
    got = predict.full_prediction(image, depth, meta, tm,
                                  uniforms=lane_draws(key),
                                  color_prediction=True, with_bbox=True)
    assert want["predictions"]
    for name in ("segmented_prediction", "pose_prediction"):
        assert got[name].dtype == np.uint8
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert (got["segmented_prediction"] != image).any()


@pytest.mark.parametrize("with_bbox", [False, True])
def test_paint_prediction_matches_jax(with_bbox):
    image, _, meta, owner, _ = frame()
    rng = np.random.default_rng(3)
    prediction = {"predictions": {}}
    model_points = {}
    for i, cls in enumerate(("mug", "box")):
        q = rng.normal(size=4).astype(np.float32)
        prediction["predictions"][cls] = {
            "mask": (owner == i).astype(np.uint8) * 255,
            "rotation": q / np.linalg.norm(q),
            "position": (rng.normal(size=3) * 0.02 + [0, 0, 0.45]).astype(
                np.float32)}
        model_points[cls] = (rng.normal(size=(80, 3)) * 0.03).astype(
            np.float32)
    colors = {"mug": {"value": (255, 0, 0)}, "box": {"value": (0, 128, 128)}}
    want = jviz.paint_prediction(image, prediction, colors, meta["intr"],
                                 model_points, with_bbox=with_bbox)
    got = viz.paint_prediction(image, prediction, colors, meta["intr"],
                               model_points, with_bbox=with_bbox)
    for name in ("segmented_prediction", "pose_prediction"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert (got[name] != image).any()
