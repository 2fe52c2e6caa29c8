"""The train stages and serving prefixes, port against the JAX package
on the CPU, both in bf16 as they run on a chip: the seven train stages
(`utils/train_stages.py`) at 2 objects, B=2, N=64, M=32, crop 64, from
JAX's initial weights carried across by `weights.py`; the five serving
prefixes (`utils/serving_stages.py`) at 3 classes, 64 points, crop 64,
96x128 and one refine iteration, with JAX's draws handed over as
uniforms. Each JAX step is compiled once; its compiled graph also gives
the FLOP count that the port's count is held to (`utils/flops.py`).

Tolerances (bf16 compute: a rounding is 2^-8 of a value, and the two
frameworks round at different places, so the networks' outputs agree to
about 1 %; see each test):
  * the forward stages' outputs within 2e-2 of their scale;
  * the loss stages within 2e-2 relative (their inputs are the bf16
    PoseNet's outputs);
  * the steps' outputs within 2e-2 relative, and every carried parameter
    within Adam's bound of 2 lr of JAX's after one step from the same
    state (Adam's first step moves a parameter by about lr sign(g));
    dropout is off on both sides (flax draws its masks from keys the
    port cannot draw);
  * the serving prefixes: `found` equal; the bf16 U-Nets' selected
    components equal but for pixels whose two largest probabilities tie
    within rounding (at most 0.5 % of the frame); for each class whose
    component is equal, the point count equal; the translations within
    0.1 m, the extent of a class's cloud, as the confidence argmax over
    the candidates may pick another candidate in bf16; and the full
    prefix built in f32 on both sides within 1e-4 for every class.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from autoposeestimation_tpu.pipeline import predict as jpredict
from autoposeestimation_tpu.utils import serving_stages as jss
from autoposeestimation_tpu.utils import train_stages as jts
from autoposeestimation_tpu_torch import weights
from autoposeestimation_tpu_torch.models import pspnet
from autoposeestimation_tpu_torch.pipeline import predict
from autoposeestimation_tpu_torch.utils import flops
from autoposeestimation_tpu_torch.utils import serving_stages
from autoposeestimation_tpu_torch.utils import train_stages
from test_torch_seg_models import two_threads  # noqa: F401  (a fixture)

NUM_OBJ, BS, N, M, CROP = 2, 2, 64, 32, 64
PREFIX = dict(num_classes=3, num_points=64, crop=64, h=96, w=128,
              refine_iters=1)
LR = train_stages.LR
OUT_RTOL = 2e-2
TRANS_BF16_ATOL = 0.1
# the count of each graph against the JAX package's (compiled graph's
# cost_analysis) at these sizes: the graphs of convolutions within 5 %;
# the others' tolerance and why
FLOP_RTOL = {
    "pspnet_fwd": 0.05, "posenet_fwd": 0.05, "estimator_step": 0.05,
    "estimator_step_symbf16": 0.05,
    # XLA also counts the loss's elementwise work (the direct-form
    # distances of every candidate, the norms and the log), which
    # FlopCounterMode does not: the port counts 3-4 % less
    "symloss_fwd": 0.06, "symloss_fwd_bwd": 0.06,
    # XLA counts the refine loss's elementwise work and the optimizer's
    # update of every parameter: 8 % less here
    "refiner_step": 0.12,
    "seg": 0.05, "seg_cca": 0.05, "perclass": 0.05, "full": 0.05,
    # the stage returns only the translations, so XLA drops the rotation
    # head, which eager PyTorch runs: 3.5 % more here
    "estimator": 0.05,
}


# the JAX package counts its graphs at JAX's default matmul precision
# (this suite's conftest sets "highest", which changes XLA's counts)
def default_precision():
    return jax.default_matmul_precision("default")


def fast_init(seed=0):
    """flax `init` drawn with numpy (no eager init compile): the variable
    shapes from `jax.eval_shape`, LeCun-scaled kernels, BatchNorm
    variances and scales near 1, the rest small
    (`test_torch_models.init_vars`'s draws)."""
    orig = nn.Module.init
    rng = np.random.default_rng(seed)

    def init(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(lambda: orig(self, rngs, *args, **kwargs))

        def leaf(path, s):
            name = str(getattr(path[-1], "key", path[-1]))
            if name == "kernel":
                fan_in = int(np.prod(s.shape[:-1]))
                return jnp.asarray(rng.normal(size=s.shape) / np.sqrt(fan_in),
                                   s.dtype)
            if name == "var":
                return jnp.asarray(rng.uniform(0.5, 2.0, s.shape), s.dtype)
            if name == "scale":
                return jnp.asarray(rng.uniform(0.5, 1.5, s.shape), s.dtype)
            if name == "negative_slope":
                return jnp.asarray(rng.uniform(0.1, 0.4), s.dtype)
            return jnp.asarray(rng.normal(size=s.shape) * 0.1, s.dtype)

        return jax.tree_util.tree_map_with_path(leaf, shapes)

    return init


def jitted_apply(orig):
    """flax `apply` of plain positional calls through one `jax.jit` (the
    JAX `build_stages`' forwards outside its steps run op by op otherwise)."""

    def apply(self, variables, *args, **kwargs):
        if kwargs:
            return orig(self, variables, *args, **kwargs)
        return jax.jit(lambda v, *a: orig(self, v, *a))(variables, *args)

    return apply


def no_dropout(next_fun, args, kwargs, context):
    if (isinstance(context.module, nn.Dropout)
            and context.method_name == "__call__"):
        return args[0]
    return next_fun(*args, **kwargs)


def flops_of(compiled) -> float:
    ca = compiled.cost_analysis()
    return float((ca[0] if isinstance(ca, (list, tuple)) else ca)["flops"])


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_stages():
    """JAX's seven train stages, each compiled once and called once from
    its initial carry with dropout off: {name: (out, new carry, flops)},
    and the initial weights."""
    mp = pytest.MonkeyPatch()
    mp.setattr(nn.Module, "init", fast_init(1))
    mp.setattr(nn.Module, "apply", jitted_apply(nn.Module.apply))
    try:
        steps, carries = jts.build_stages(num_obj=NUM_OBJ, bs=BS, n=N, m=M,
                                          crop=CROP)
    finally:
        mp.undo()
    out = {}
    with nn.intercept_methods(no_dropout), default_precision():
        for name in jts.TRAIN_STAGE_ORDER:
            if name == "estimator_step_symbf16":
                # off the TPU the JAX package's sym_bf16 changes nothing
                # (its loss takes the f32 XLA path): one graph serves both
                out[name] = out["estimator_step"]
                continue
            compiled = jax.jit(steps[name]).lower(
                carries[name], jnp.uint32(0)).compile()
            carry, y = compiled(carries[name], jnp.uint32(0))
            out[name] = (np.asarray(y), numpy_tree(carry), flops_of(compiled))
    init = (numpy_tree(carries["estimator_step"][0]),
            numpy_tree(carries["refiner_step"][0]))
    return out, init


@pytest.fixture(scope="module")
def port_stages(jax_stages, two_threads):  # noqa: F811
    _, (pose_vars, refine_vars) = jax_stages
    mp = pytest.MonkeyPatch()
    mp.setattr(pspnet, "dropout", lambda x, rate, generator, rows=None: x)
    try:
        steps, carries = train_stages.build_stages(
            num_obj=NUM_OBJ, bs=BS, n=N, m=M, crop=CROP, device="cpu",
            pose_vars=pose_vars, refine_vars=refine_vars)
        out = {}
        for name in train_stages.TRAIN_STAGE_ORDER:
            with flops.counting() as count:
                carry, y = steps[name](carries[name], 0)
            out[name] = (y.detach().numpy(), carry, count.total)
    finally:
        mp.undo()
    return out


def test_inputs_are_the_jax_packages():
    """The port draws the inputs of the JAX package's `build_stages` in
    its order."""
    rng = np.random.default_rng(1)
    want = [rng.normal(size=(BS, CROP, CROP, 3)),
            rng.normal(size=(BS, N, 3)) * 0.1,
            rng.integers(0, CROP * CROP, (BS, N)),
            rng.normal(size=(BS, M, 3)) * 0.05,
            rng.normal(size=(BS, M, 3)) * 0.05,
            rng.integers(0, NUM_OBJ, BS)]
    got = train_stages.inputs(NUM_OBJ, BS, N, M, CROP)
    for key, w in zip(("img", "cloud", "choose", "target", "model_points",
                       "obj_idx"), want):
        np.testing.assert_array_equal(got[key], np.asarray(w, got[key].dtype))
    np.testing.assert_array_equal(got["is_sym"], [True, False])


@pytest.mark.parametrize("name", ["pspnet_fwd", "posenet_fwd",
                                  "symloss_fwd", "symloss_fwd_bwd"])
def test_forward_stage_matches_jax(jax_stages, port_stages, name):
    want = jax_stages[0][name][0]
    got = port_stages[name][0]
    assert got.shape == want.shape
    # the pspnet/posenet outputs are single elements of a map; the scale
    # is the stage's output magnitude (a log-probability, a translation,
    # a loss, a gradient element)
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_RTOL * scale,
                               err_msg=name)


@pytest.mark.parametrize("name", ["estimator_step", "estimator_step_symbf16",
                                  "refiner_step"])
def test_step_matches_jax(jax_stages, port_stages, name):
    want, want_carry, _ = jax_stages[0][name]
    got, (net, _), _ = port_stages[name]
    np.testing.assert_allclose(got, want, rtol=OUT_RTOL, err_msg=name)
    pose_vars, refine_vars = jax_stages[1]
    if name == "refiner_step":
        before, after = refine_vars, weights.refiner_variables(net)
    else:
        before, after = pose_vars, weights.posenet_variables(net)
    moved = far = size = 0
    for path, w0 in jax.tree_util.tree_flatten_with_path(
            before["params"])[0]:
        g_node, w_node = after["params"], want_carry[0]["params"]
        for p in path:
            g_node, w_node = g_node[p.key], w_node[p.key]
        off = np.abs((np.asarray(g_node) - w0) - (np.asarray(w_node) - w0))
        assert off.max() <= 2 * LR * (1 + 1e-3), (name, path, off.max())
        moved += int((np.abs(np.asarray(g_node) - w0) > 0.5 * LR).sum())
        far += int((off > 0.02 * LR).sum())
        size += off.size
    assert moved > 0, f"{name}: no parameter moved"
    # the moves differ (by up to 2 lr) only where bf16 rounding flips the
    # sign of a near-zero gradient: 1-3 % of the parameters here
    assert far <= 0.05 * size, (name, far / size)


@pytest.mark.parametrize("name", train_stages.TRAIN_STAGE_ORDER)
def test_train_stage_flops_match_jax(jax_stages, port_stages, name):
    want = jax_stages[0][name][2]
    got = port_stages[name][2]
    assert abs(got / want - 1) <= FLOP_RTOL[name], (name, got, want)


def test_dropout_drawn_from_the_step_index(two_threads):  # noqa: F811
    """With dropout on, a step's masks come from a generator seeded with
    its index: from the same weights the same i gives the same loss and
    another i another."""
    steps, carries = train_stages.build_stages(
        num_obj=NUM_OBJ, bs=BS, n=16, m=8, crop=32, device="cpu",
        dtype=torch.float32)
    carry = carries["estimator_step"]
    start = {k: v.clone() for k, v in carry[0].state_dict().items()}
    loss = []
    for i in (3, 3, 4):
        carry[0].load_state_dict(start)
        loss.append(float(steps["estimator_step"](carry, i)[1]))
    assert loss[0] == loss[1] != loss[2]


def lane_draws(i, k, npt):
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), i), k)
    return np.stack([np.asarray(jax.random.uniform(kk, (npt,)))
                     for kk in keys])


@pytest.fixture(scope="module")
def prefixes(two_threads):  # noqa: F811
    """Each prefix of both packages, called once at i = 5 with the same
    draws: {name: (JAX out, port out, JAX flops, port flops)}, and each
    package's class masks of the frame."""
    mp = pytest.MonkeyPatch()
    mp.setattr(nn.Module, "init", fast_init(2))
    try:
        jsteps, jm = jss.build_prefixes(**PREFIX)
    finally:
        mp.undo()
    k, h, w = PREFIX["num_classes"], PREFIX["h"], PREFIX["w"]
    steps, tm = serving_stages.build_prefixes(
        **PREFIX, device="cpu",
        uniforms=lambda i: lane_draws(i, k, PREFIX["num_points"]),
        seg_vars=numpy_tree(jm.seg_vars), pose_vars=numpy_tree(jm.pose_vars),
        refine_vars=numpy_tree(jm.refine_vars))
    out = {}
    for name in serving_stages.PREFIX_ORDER:
        with default_precision():
            compiled = jax.jit(jsteps[name]).lower(
                jnp.uint8(0), jnp.uint32(5)).compile()
        jc, jy = compiled(jnp.uint8(0), jnp.uint32(5))
        with flops.counting() as count:
            c, y = steps[name](serving_stages.initial_carry("cpu"), 5)
        assert int(c) == int(jc) == 0
        out[name] = (np.asarray(jy), y.numpy(), flops_of(compiled),
                     count.total)

    # the masks the prefixes select, computed alike on both sides
    rng = np.random.default_rng(0)
    rng.normal(size=(k, 1000, 3))
    image, _ = serving_stages.headline_frame(k, h, w, rng)
    cls_ids = jnp.arange(1, k + 1, dtype=jnp.int32)

    @jax.jit
    def jax_masks(img):
        probs, arg = jpredict._segment(jm.seg_model, jm.seg_vars, img)
        return jax.vmap(lambda sp, cl: jpredict._class_mask(
            sp, arg, cl, cca_scale=jm.cca_scale, cca_sweeps=jm.cca_sweeps,
            cca_rule=jm.cca_rule, seg_stride=1, full_hw=(h, w))[0])(
            jnp.transpose(probs, (2, 0, 1))[1:k + 1], cls_ids)

    with torch.inference_mode():
        probs, arg = predict._segment(
            tm.seg_model, torch.from_numpy(image).permute(2, 0, 1))
        masks = predict._class_mask(
            probs[1:k + 1], arg, torch.arange(1, k + 1),
            cca_scale=tm.cca_scale, cca_sweeps=tm.cca_sweeps,
            cca_rule=tm.cca_rule, full_hw=(h, w))[0].numpy()
    return out, np.asarray(jax_masks(jnp.asarray(image))), masks


@pytest.fixture(scope="module")
def full_prefix_f32(two_threads):  # noqa: F811
    """The full prefix of both packages in f32 (`build_prefixes`' models
    built in f32): its translations, JAX's and the port's."""
    mp = pytest.MonkeyPatch()
    mp.setattr(nn.Module, "init", fast_init(2))
    build = jpredict.build_models
    mp.setattr(jpredict, "build_models", lambda *a, **kw: build(
        *a, **{**kw, "dtype": jnp.float32}))
    try:
        jsteps, jm = jss.build_prefixes(**PREFIX)
    finally:
        mp.undo()
    k = PREFIX["num_classes"]
    steps, _ = serving_stages.build_prefixes(
        **PREFIX, device="cpu", dtype=torch.float32,
        uniforms=lambda i: lane_draws(i, k, PREFIX["num_points"]),
        seg_vars=numpy_tree(jm.seg_vars), pose_vars=numpy_tree(jm.pose_vars),
        refine_vars=numpy_tree(jm.refine_vars))
    want = jax.jit(jsteps["full"])(jnp.uint8(0), jnp.uint32(5))[1]
    return np.asarray(want), steps["full"](
        serving_stages.initial_carry("cpu"), 5)[1].numpy()


def test_prefix_seg_cca_found_matches_jax(prefixes):
    want, got = prefixes[0]["seg_cca"][:2]
    assert want.any()
    np.testing.assert_array_equal(got, want)


def test_prefix_masks_agree(prefixes):
    """The selected components of the bf16 U-Nets: a pixel whose two
    largest probabilities are within the frameworks' bf16 rounding may
    flip, no more than 0.5 % of a class's frame."""
    _, want, got = prefixes
    h, w = PREFIX["h"], PREFIX["w"]
    assert (got != want).sum(axis=(1, 2)).max() <= 0.005 * h * w


def test_prefix_perclass_counts_match_jax(prefixes):
    """The point counts are equal for every class whose component is
    equal (a flipped pixel moves its class's count)."""
    out, want_masks, masks = prefixes
    want, got = out["perclass"][:2]
    same = (masks == want_masks).all(axis=(1, 2))
    assert same.any()
    np.testing.assert_array_equal(got[same], want[same])


@pytest.mark.parametrize("name", ["estimator", "full"])
def test_prefix_translations_match_jax(prefixes, name):
    """bf16: each found class's translation within TRANS_BF16_ATOL. The
    bf16 PoseNets' confidences of the 64 candidates tie within rounding,
    so the two may pick different candidates: the bound is the extent of
    a class's cloud in the 64-pixel window at 0.6 m (0.1 m)."""
    out = prefixes[0]
    want, got = out[name][:2]
    live = out["seg_cca"][0] & (out["perclass"][0] > 0)
    assert live.any()
    np.testing.assert_allclose(got[live], want[live], rtol=0,
                               atol=TRANS_BF16_ATOL)


def test_full_prefix_f32_matches_jax(full_prefix_f32):
    """The same prefixes in f32: every class's translation within 1e-4
    (the networks' torch-vs-flax agreement)."""
    want, got = full_prefix_f32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", serving_stages.PREFIX_ORDER)
def test_prefix_flops_match_jax(prefixes, name):
    want, got = prefixes[0][name][2:]
    assert abs(got / want - 1) <= FLOP_RTOL[name], (name, got, want)


def test_prefix_labels_match_jax():
    assert serving_stages.PREFIX_ORDER == jss.PREFIX_ORDER
    assert serving_stages.STAGE_LABELS == jss.STAGE_LABELS
    assert train_stages.TRAIN_STAGE_ORDER == jts.TRAIN_STAGE_ORDER
