"""The port's networks held against the JAX package's on the CPU in f32:
the same inputs (numpy, seeded), the same weights (flax trees moved across
by `autoposeestimation_tpu_torch.weights`), outputs within 2e-4 absolute
(the torch-vs-flax figure of tests/test_torch_import.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoposeestimation_tpu.models import common as jcommon
from autoposeestimation_tpu.models import densefusion as jdf
from autoposeestimation_tpu.models import pspnet as jpsp
from autoposeestimation_tpu.models import resnet as jresnet
from autoposeestimation_tpu.models import unet as junet
from autoposeestimation_tpu_torch import weights
from autoposeestimation_tpu_torch.models import common, densefusion, pspnet
from autoposeestimation_tpu_torch.models import resnet, unet

ATOL = 2e-4


def init_vars(module, *args, seed=0):
    """A flax variable tree for `module` drawn with numpy (no flax init
    compile): LeCun-scaled kernels and non-trivial BatchNorm statistics,
    scales, biases and PReLU slopes, so every mapped leaf shapes the
    output."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "negative_slope":
            return np.float32(rng.uniform(0.1, 0.4))
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(x), -1, -3)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), -3, -1)


def sub_state(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


# --- common ops ------------------------------------------------------------

def test_normalize_imagenet():
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    want = np.asarray(jcommon.normalize_imagenet(jnp.asarray(img)))
    got = common.normalize_imagenet(nchw(img))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6)


@pytest.mark.parametrize("in_hw,out_hw", [((5, 7), (10, 14)),
                                          ((8, 8), (3, 5)),
                                          ((6, 9), (13, 4))])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_bilinear(in_hw, out_hw, align_corners):
    x = np.random.default_rng(1).normal(size=(2,) + in_hw + (3,)).astype(
        np.float32)
    want = jcommon.resize_bilinear(jnp.asarray(x), out_hw, align_corners)
    got = common.resize_bilinear(nchw(x), out_hw, align_corners)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-6)


def test_upsample_nearest_and_adaptive_pool():
    x = np.random.default_rng(2).normal(size=(2, 11, 13, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        nhwc(common.upsample_nearest_2x(nchw(x))),
        np.asarray(jcommon.upsample_nearest_2x(jnp.asarray(x))))
    for s in (1, 2, 3, 6):
        np.testing.assert_allclose(
            nhwc(common.adaptive_avg_pool(nchw(x), s)),
            np.asarray(jcommon.adaptive_avg_pool(jnp.asarray(x), s)),
            atol=1e-6)


# --- encoders and U-Net ----------------------------------------------------

def test_resnet_encoder_odd_dims():
    """BN in inference mode, -inf max-pool padding, ceil-mode odd dims."""
    stages = (2, 1, 1, 1)
    jm = jresnet.ResNetEncoder(stage_sizes=stages, dtype=jnp.float32)
    x = np.random.default_rng(3).normal(size=(1, 45, 37, 3)).astype(
        np.float32)
    v = init_vars(jm, x, seed=4)
    want = jax.jit(jm.apply)(v, x)
    tree = {c: {"ResNetEncoder_0": v[c]} for c in v}
    plan = [e for e in weights.unet_plan(stages) if "ResNetEncoder_0" in e[0]]
    tm = resnet.ResNetEncoder(stages).eval()
    tm.load_state_dict(sub_state(weights.to_state_dict(tree, plan),
                                 "encoder."))
    with torch.no_grad():
        got = tm(nchw(x))
    assert len(got) == len(want) == 5
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w_), atol=ATOL)


@pytest.fixture(scope="module")
def unet_pair():
    jm = junet.UNet(classes=4, dtype=jnp.float32)
    v = init_vars(jm, np.zeros((1, 64, 64, 3), np.float32), seed=5)
    tm = unet.UNet(4).eval()
    tm.load_state_dict(weights.unet_state_dict(v))
    return jm, v, tm


@pytest.mark.parametrize("hw", [(64, 96), (50, 70)])
def test_unet(unet_pair, hw):
    """Logits at /32-aligned and odd sizes (decoder crops to the skips)."""
    jm, v, tm = unet_pair
    x = np.random.default_rng(6).normal(size=(1,) + hw + (3,)).astype(
        np.float32)
    want = np.asarray(jax.jit(jm.apply)(v, x))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


# --- PSPNet, PoseNet, PoseRefineNet ------------------------------------------

@pytest.fixture(scope="module")
def psp_vars():
    jm = jpsp.PSPNet(dtype=jnp.float32)
    return init_vars(jm, np.zeros((1, 32, 32, 3), np.float32), seed=7)


@pytest.mark.parametrize("stride,late", [(1, False), (2, False), (2, True),
                                         (8, False)])
def test_pspnet(psp_vars, stride, late):
    jm = jpsp.PSPNet(dtype=jnp.float32, emb_stride=stride, resize_late=late)
    x = np.random.default_rng(8).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jm.apply)(psp_vars, x))
    tree = {"params": {"PSPNet_0": psp_vars["params"]}}
    plan = [e for e in weights.posenet_plan() if e[1].startswith("cnn.")]
    tm = pspnet.PSPNet(emb_stride=stride, resize_late=late).eval()
    tm.load_state_dict(sub_state(weights.to_state_dict(tree, plan), "cnn."))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert got.shape == want.shape == (2, 32 // stride, 32 // stride, 32)
    np.testing.assert_allclose(got, want, atol=ATOL)


def pose_inputs(seed, b=2, crop=32, n=24):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(b, crop, crop, 3)).astype(np.float32)
    cloud = (rng.normal(size=(b, n, 3)) * 0.1).astype(np.float32)
    choose = rng.integers(0, crop * crop, (b, n)).astype(np.int32)
    obj = np.arange(b, dtype=np.int32) % 3
    return img, cloud, choose, obj


@pytest.fixture(scope="module")
def posenet_vars():
    jm = jdf.PoseNet(num_obj=3, dtype=jnp.float32)
    img, cloud, choose, obj = pose_inputs(0)
    return init_vars(jm, img, cloud, choose, obj, seed=9)


@pytest.mark.parametrize("stride", [1, 8])
def test_posenet(posenet_vars, stride):
    img, cloud, choose, obj = pose_inputs(10)
    jm = jdf.PoseNet(num_obj=3, dtype=jnp.float32, emb_stride=stride)
    want = jax.jit(jm.apply)(posenet_vars, img, cloud, choose, obj)
    tm = densefusion.PoseNet(3, emb_stride=stride).eval()
    tm.load_state_dict(weights.posenet_state_dict(posenet_vars))
    with torch.no_grad():
        got = tm(nchw(img), torch.from_numpy(cloud),
                 torch.from_numpy(choose).long(), torch.from_numpy(obj).long())
    for g, w_ in zip(got, want):
        assert tuple(g.shape) == w_.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=ATOL)


def test_gather_embeddings_bilinear():
    rng = np.random.default_rng(11)
    emb = rng.normal(size=(2, 8, 8, 5)).astype(np.float32)
    choose = rng.integers(0, 64 * 64, (2, 30)).astype(np.int32)
    want = jdf.gather_embeddings_bilinear(jnp.asarray(emb),
                                          jnp.asarray(choose), 64)
    got = densefusion.gather_embeddings_bilinear(
        nchw(emb), torch.from_numpy(choose).long(), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.fixture(scope="module")
def refiner_vars():
    jm = jdf.PoseRefineNet(num_obj=3, dtype=jnp.float32)
    rng = np.random.default_rng(12)
    cloud = (rng.normal(size=(2, 24, 3)) * 0.1).astype(np.float32)
    emb = rng.normal(size=(2, 24, 32)).astype(np.float32)
    # random final layers: the fresh ones are an exact no-op
    return jm, init_vars(jm, cloud, emb, np.zeros(2, np.int32), seed=14)


def test_refinenet(refiner_vars):
    jm, v = refiner_vars
    rng = np.random.default_rng(13)
    cloud = (rng.normal(size=(3, 24, 3)) * 0.1).astype(np.float32)
    emb = rng.normal(size=(3, 24, 32)).astype(np.float32)
    obj = np.asarray([2, 0, 1], np.int32)
    want = jax.jit(jm.apply)(v, cloud, emb, obj)
    tm = densefusion.PoseRefineNet(3).eval()
    tm.load_state_dict(weights.refiner_state_dict(v))
    with torch.no_grad():
        got = tm(torch.from_numpy(cloud), torch.from_numpy(emb),
                 torch.from_numpy(obj).long())
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=ATOL)


def test_fresh_refiner_is_identity():
    """A freshly initialized refiner returns the identity correction."""
    tm = densefusion.PoseRefineNet(2)
    common.init_like_flax(tm, torch.Generator().manual_seed(0))
    cloud = torch.randn(3, 10, 3)
    emb = torch.randn(3, 10, 32)
    with torch.no_grad():
        dr, dt = tm(cloud, emb, torch.tensor([0, 1, 1]))
    np.testing.assert_array_equal(dr.numpy(), [[1.0, 0, 0, 0]] * 3)
    np.testing.assert_array_equal(dt.numpy(), np.zeros((3, 3)))


def test_compute_dtype():
    """flax `dtype=` semantics: f32 parameters, bf16 compute, and the final
    PSPNet, PoseHead and U-Net layers in f32."""
    net = densefusion.PoseNet(2, dtype=torch.bfloat16, emb_stride=8).eval()
    unet_net = unet.UNet(3, encoder_stages=(1, 1, 1, 1),
                         dtype=torch.bfloat16).eval()
    assert all(p.dtype == torch.float32 for p in net.parameters())
    img = torch.randn(2, 3, 32, 32)
    with torch.no_grad():
        feat = net.cnn.feats(img.to(torch.bfloat16))
        pred_r, pred_t, pred_c, emb = net(
            img, torch.randn(2, 8, 3), torch.randint(0, 1024, (2, 8)),
            torch.tensor([0, 1]))
        logits = unet_net(torch.randn(1, 3, 32, 32))
    assert feat.dtype == torch.bfloat16
    assert {pred_r.dtype, pred_t.dtype, pred_c.dtype, emb.dtype,
            logits.dtype} == {torch.float32}
    assert torch.isfinite(pred_r).all() and torch.isfinite(logits).all()


# --- the weight bridge --------------------------------------------------------

def _leaf_paths(tree):
    return [tuple(str(getattr(k, "key", k)) for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("which", ["unet", "posenet", "refiner"])
def test_weight_bridge_maps_every_leaf_once(which, unet_pair, posenet_vars,
                                            refiner_vars):
    """Every leaf of the JAX tree lands in exactly one state_dict entry of
    the right shape, and every state_dict entry is fed."""
    variables, plan, model = {
        "unet": (unet_pair[1], weights.unet_plan(), unet.UNet(4)),
        "posenet": (posenet_vars, weights.posenet_plan(),
                    densefusion.PoseNet(3)),
        "refiner": (refiner_vars[1], weights.refiner_plan(),
                    densefusion.PoseRefineNet(3)),
    }[which]
    leaves = _leaf_paths(variables)
    plan_paths = [e[0] for e in plan]
    assert sorted(plan_paths) == sorted(leaves)
    assert len(set(plan_paths)) == len(plan_paths)
    keys = [e[1] for e in plan]
    assert len(set(keys)) == len(keys)
    state = model.state_dict()
    assert set(keys) == set(state)
    for key, tensor in weights.to_state_dict(variables, plan).items():
        assert tensor.shape == state[key].shape, key
