"""The U-Net's `out_stride` and serving at `seg_out_stride` > 1, port
against the JAX package on the CPU in f32: the U-Net's logits at strides
2, 4 and 8 on /32-aligned and odd frames within 2e-4 (the torch-vs-flax
figure), `_upsample_plane` exactly, the single-frame and the batched
graph at `seg_out_stride=4` at the serving tests' geometry and draws
(masks, `found`, `argmax`, `cca_converged` exactly, poses within 1e-4),
and the strides that `build_models` rejects."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoposeestimation_tpu.models import unet as junet
from autoposeestimation_tpu.pipeline import predict as jpredict
from autoposeestimation_tpu_torch import weights
from autoposeestimation_tpu_torch.models.unet import UNet
from autoposeestimation_tpu_torch.pipeline import predict
from test_torch_models import init_vars
from test_torch_pipeline import ATOL, CROP, H, K, NPT, W, frame
from test_torch_pipeline import variables  # noqa: F401  (a fixture)
from test_torch_serving import EXACT, lane_draws, stream_frames

UNET_ATOL = 2e-4
# a shallow encoder: the stride only changes the decoder
STAGES = (2, 1, 1, 1)


@pytest.mark.parametrize("hw", [(64, 96), (65, 97)])
@pytest.mark.parametrize("stride", [2, 4, 8])
def test_unet_out_stride_matches_jax(stride, hw):
    jnet = junet.UNet(classes=3, dtype=jnp.float32, encoder_stages=STAGES,
                      out_stride=stride)
    x = np.random.default_rng(stride).normal(size=(2,) + hw + (3,)).astype(
        np.float32)
    variables = init_vars(jnet, x, seed=stride)
    want = np.asarray(jax.jit(jnet.apply)(variables, x))
    net = UNet(3, encoder_stages=STAGES, out_stride=stride).eval()
    net.load_state_dict(weights.to_state_dict(variables,
                                              weights.unet_plan(STAGES)))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 3, -(-hw[0] // stride), -(-hw[1] // stride))
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want,
                               atol=UNET_ATOL)
    # the same parameters at every stride
    plain = UNet(3, encoder_stages=STAGES).state_dict()
    assert {k: v.shape for k, v in net.state_dict().items()} == {
        k: v.shape for k, v in plain.items()}


@pytest.mark.parametrize("shape,stride,hw", [
    ((2, 3, 5, 7), 4, (18, 26)),   # the ceil-mode overshoot is cropped
    ((3, 4), 2, (9, 7)),           # rows fall short (padded), cols cropped
    ((4, 6), 8, (32, 48)),         # exact
    ((5, 5), 1, (5, 5)),           # the identity
])
@pytest.mark.parametrize("dtype", [bool, np.int32])
def test_upsample_plane_matches_jax(shape, stride, hw, dtype):
    rng = np.random.default_rng(len(shape) + stride)
    p = (rng.random(shape) > 0.5 if dtype is bool
         else rng.integers(0, 6, shape)).astype(dtype)
    want = np.asarray(jpredict._upsample_plane(jnp.asarray(p), stride, hw))
    got = predict._upsample_plane(torch.from_numpy(p), stride, hw).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def pair4(variables):  # noqa: F811
    seg, pose, refine = variables
    mp = np.random.default_rng(0).normal(size=(K, 60, 3)).astype(
        np.float32) * 0.05
    kw = dict(num_points=NPT, crop=CROP, refine_iters=2, emb_stride=8,
              seg_vars=seg, pose_vars=pose, refine_vars=refine,
              seg_out_stride=4)
    jm = jpredict.build_models(K, mp, ("mug", "box"), dtype=jnp.float32,
                               img_hw=(H, W), **kw)
    tm = predict.build_models(K, mp, ("mug", "box"), dtype=torch.float32,
                              device="cpu", **kw)
    return jm, tm


def assert_outputs(got, want):
    assert set(got) == set(want)
    for name in EXACT:
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]), err_msg=name)
    for name in ("quats", "positions"):
        np.testing.assert_allclose(np.asarray(got[name]),
                                   np.asarray(want[name]), atol=ATOL,
                                   err_msg=name)


def test_predict_frame_at_stride_4_matches_jax(pair4):
    jm, tm = pair4
    image, depth, meta, _, _ = frame()
    key = jax.random.PRNGKey(3)
    intr = meta["intr"].as_array()
    want = jpredict._full_prediction_jit(
        jm.seg_vars, jm.pose_vars, jm.refine_vars, jnp.asarray(image),
        jnp.asarray(depth), jnp.asarray(intr), jnp.float32(0.001), key,
        jpredict.static_tuple(jm))
    with torch.inference_mode():
        frame_in = predict._frame_inputs(image, depth, meta, tm.device)
        got = predict._predict_frame(tm, *frame_in,
                                     torch.from_numpy(lane_draws(key)))
    assert np.asarray(want["found"]).sum() >= 1
    assert got["argmax"].shape == (H, W)
    assert_outputs({k: v.numpy() for k, v in got.items()}, want)


def test_predict_batch_at_stride_4_matches_jax(pair4):
    jm, tm = pair4
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
    assert np.asarray(want["found"]).sum() >= 3
    assert_outputs({k: v.numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize("stride", [0, 3, 16])
def test_build_models_rejects_other_strides(stride):
    mp = np.zeros((K, 4, 3), np.float32)
    with pytest.raises(ValueError, match="seg_out_stride"):
        predict.build_models(K, mp, ("mug", "box"), num_points=NPT,
                             crop=CROP, seg_out_stride=stride, device="cpu")
    with pytest.raises(AssertionError):
        jpredict.build_models(K, mp, ("mug", "box"), seg_out_stride=stride)
