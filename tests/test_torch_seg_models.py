"""The port's segmentation models and losses held against the JAX package's
on the CPU in f32, from numpy seeds and numpy-drawn flax variable trees
carried across by `autoposeestimation_tpu_torch.weights`: BatchNorm in
train mode (output, gradients and both updated running statistics), the
U-Net at 3 and 7 input channels, LinkNet, PSPNet-seg (its dropout off and
with one injected mask) and SegNet (pooling ties included) in train and
eval mode, the weight bridge both ways, and the jaccard loss, confusion
matrix and IoU. Outputs and gradients within 2e-4 absolute (the
torch-vs-flax figure of tests/test_torch_import.py)."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from autoposeestimation_tpu.models import losses as jlosses
from autoposeestimation_tpu.models import seg_variants as jsv
from autoposeestimation_tpu.models import segnet as jsegnet
from autoposeestimation_tpu.models import unet as junet
from autoposeestimation_tpu_torch import weights
from autoposeestimation_tpu_torch.models import common, losses, seg_variants
from autoposeestimation_tpu_torch.models import segnet, unet
from test_torch_models import init_vars, nchw, nhwc

ATOL = 2e-4
STAGES = (2, 1, 1, 1)     # identity and projected residual blocks
B, H, W = 2, 64, 64


def leaves(tree):
    return {tuple(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_close(got, want, atol, what):
    got, want = leaves(got), leaves(want)
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=atol,
                                   err_msg=f"{what} {'/'.join(path)}")


def port_grads(model, plan):
    """The port's parameter gradients in the flax layout, {path below
    `params`: array}, for the parameters that have one."""
    named = dict(model.named_parameters())
    pplan = [e for e in plan if e[0][0] == "params"
             and named[e[1]].grad is not None]
    grads = {key: named[key].grad for _, key, _ in pplan}
    return leaves(weights.to_variables(grads, pplan)["params"])


def port_stats(model, plan):
    return weights.to_variables(model.state_dict(), plan)["batch_stats"]


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this file's networks: the suite runs six
    workers at once, and their many small ops run ~10x slower when every
    worker spins 8 threads on 8 cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- BatchNorm in train mode -------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 2, 2, 5), (3, 7, 5, 4)])
def test_batchnorm_train_mode(shape):
    """Batch mean and biased variance in f32, normalization, autograd
    through the statistics, and the running statistics moved by 0.1 with
    the biased variance."""
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = (rng.normal(size=shape) * 2 + 1).astype(np.float32)
    probe = rng.normal(size=shape).astype(np.float32)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rng.normal(size=c).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(size=c).astype(np.float32),
                         "var": rng.uniform(0.5, 2, c).astype(np.float32)}}
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9)

    def f(params, xx):
        y, upd = bn.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y * probe), (y, upd["batch_stats"])

    (_, (want_y, want_stats)), (want_gp, want_gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], x)

    tm = common.BatchNorm2d(c).train()
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        tm.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        tm.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        tm.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    tx = nchw(x).requires_grad_(True)
    y = tm(tx)
    (y * nchw(probe)).sum().backward()
    np.testing.assert_allclose(nhwc(y), want_y, atol=1e-5)
    np.testing.assert_allclose(nhwc(tx.grad), want_gx, atol=1e-5)
    np.testing.assert_allclose(tm.weight.grad.numpy(), want_gp["scale"],
                               atol=1e-4)
    np.testing.assert_allclose(tm.bias.grad.numpy(), want_gp["bias"],
                               atol=1e-4)
    np.testing.assert_allclose(tm.running_mean.numpy(), want_stats["mean"],
                               atol=1e-6)
    np.testing.assert_allclose(tm.running_var.numpy(), want_stats["var"],
                               atol=1e-6)
    # F.batch_norm would store the unbiased variance: N / (N - 1) apart
    n = int(np.prod(shape[:-1]))
    rv = torch.from_numpy(v["batch_stats"]["var"]).clone()
    F.batch_norm(nchw(x), torch.zeros(c), rv, training=True, momentum=0.1)
    biased = (want_stats["var"] - 0.9 * v["batch_stats"]["var"]) / 0.1
    np.testing.assert_allclose((rv.numpy() - 0.9 * v["batch_stats"]["var"])
                               / 0.1, biased * n / (n - 1), rtol=1e-4)
    # eval mode leaves the statistics alone
    before = tm.running_var.clone()
    tm.eval()(nchw(x))
    assert torch.equal(tm.running_var, before)


def test_batchnorm_bf16_compute():
    """dtype=bf16: statistics and normalization in f32, the output cast to
    bf16 (the U-Net's BatchNorms)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 6, 8)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                      dtype=jnp.bfloat16)
    v = bn.init(jax.random.PRNGKey(0), xb)
    want, _ = bn.apply(v, xb, mutable=["batch_stats"])
    tm = common.BatchNorm2d(8, torch.bfloat16).train()
    got = tm(nchw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(nhwc(got.float()),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


# --- the networks ------------------------------------------------------------

def jaccard_grads(jm, v, x, labels, train, **apply_kw):
    """JAX: (logits, jaccard-loss gradient tree, updated batch_stats)."""
    def f(params):
        out = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                       x, train=train, mutable=["batch_stats"], **apply_kw)
        logits, upd = out
        return jlosses.jaccard_loss(labels, logits), (logits, upd)

    (_, (logits, upd)), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(v["params"])
    return np.asarray(logits), grads, upd.get("batch_stats", {})


def check_model(jm, tm, plan, x, labels, what, grad_noise=False,
                **apply_kw):
    """Eval logits, then train-mode logits, jaccard gradients and updated
    running statistics, port against JAX. With `grad_noise` each gradient
    leaf may differ by ATOL plus twice what JAX's own gradient moves when
    the input moves by 1e-6 (the ill-conditioned gradients of a deep
    network whose train-mode BatchNorms see near-constant channels)."""
    v = init_vars(jm, x, seed=11)
    tm.load_state_dict(weights.to_state_dict(v, plan))
    want = np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx))(v, x))
    with torch.no_grad():
        got = tm.eval()(nchw(x))
    np.testing.assert_allclose(nhwc(got), want, atol=ATOL,
                               err_msg=f"{what} eval")

    want_t, want_g, want_s = jaccard_grads(jm, v, x, labels, True,
                                           **apply_kw)
    tm.train()
    tm.zero_grad()
    logits = tm(nchw(x))
    losses.jaccard_loss(torch.from_numpy(labels).long(), logits).backward()
    np.testing.assert_allclose(nhwc(logits.detach()), want_t, atol=ATOL,
                               err_msg=f"{what} train")
    got_g, want_l = port_grads(tm, plan), leaves(want_g)
    moved = {p: 0.0 for p in want_l}
    if grad_noise:
        nudge = np.random.default_rng(0).normal(size=x.shape) * 1e-6
        _, g2, _ = jaccard_grads(jm, v, (x + nudge).astype(np.float32),
                                 labels, True, **apply_kw)
        moved = {p: float(np.abs(g - want_l[p]).max())
                 for p, g in leaves(g2).items()}
    assert sorted(got_g) == sorted(want_l)
    for path, w in want_l.items():
        np.testing.assert_allclose(got_g[path], w,
                                   atol=ATOL + 2 * moved[path],
                                   err_msg=f"{what} grads {'/'.join(path)}")
    assert_trees_close(port_stats(tm, plan), want_s, 1e-5,
                       f"{what} batch_stats")


def inputs(c, seed, classes=3, hw=(H, W)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B,) + hw + (c,)).astype(np.float32)
    labels = rng.integers(0, classes, (B,) + hw).astype(np.int32)
    return x, labels


@pytest.mark.parametrize("in_ch", [3, 7])
def test_unet_train_and_eval(in_ch):
    """The U-Net at 3 and 7 input channels (the background-subtraction
    model's), the stem's width carried by the same plan."""
    jm = junet.UNet(classes=3, encoder_stages=STAGES, dtype=jnp.float32)
    tm = unet.UNet(3, encoder_stages=STAGES, in_ch=in_ch)
    assert tm.encoder.conv1.weight.shape[1] == in_ch
    x, labels = inputs(in_ch, in_ch)
    check_model(jm, tm, weights.unet_plan(STAGES), x, labels,
                f"unet in_ch={in_ch}")


def test_linknet_train_and_eval():
    jm = jsv.LinkNet(classes=3, encoder_stages=STAGES, dtype=jnp.float32)
    tm = seg_variants.LinkNet(3, encoder_stages=STAGES)
    x, labels = inputs(3, 21)
    check_model(jm, tm, weights.linknet_plan(STAGES), x, labels, "linknet")


def test_conv_transpose_matches_flax():
    """flax's SAME stride-2 4x4 ConvTranspose is `F.conv_transpose2d`
    with padding 1 over the space-flipped kernel, at odd sizes too."""
    rng = np.random.default_rng(4)
    for hw in ((4, 6), (5, 7)):
        x = rng.normal(size=(2,) + hw + (8,)).astype(np.float32)
        jm = nn.ConvTranspose(5, (4, 4), strides=(2, 2), padding="SAME",
                              use_bias=False)
        v = init_vars(jm, x, seed=5)
        want = np.asarray(jm.apply(v, x))
        tm = common.ConvTranspose2d(8, 5, 4, 2, 1, bias=False)
        tm.load_state_dict(weights.to_state_dict(
            v, [(("params", "kernel"), "weight", "convT")]))
        with torch.no_grad():
            got = tm(nchw(x))
        np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


class InjectedDropout:
    """A dropout whose keep mask is given: flax's through a method
    interceptor, the port's in place of `seg_variants.dropout`."""

    def __init__(self, keep_nhwc):
        self.keep = keep_nhwc

    def flax(self, next_fun, args, kwargs, context):
        if (isinstance(context.module, nn.Dropout)
                and context.method_name == "__call__"):
            x = args[0]
            return jnp.where(self.keep, x / 0.9, 0.0)
        return next_fun(*args, **kwargs)

    def torch(self, x, rate, generator):
        assert rate == 0.1
        return torch.where(nchw(self.keep), x / 0.9, torch.zeros_like(x))


@pytest.fixture(scope="module")
def psp():
    jm = jsv.PSPNetSeg(classes=3, encoder_stages=STAGES, dtype=jnp.float32)
    x, labels = inputs(3, 31)
    v = init_vars(jm, x, seed=12)
    tm = seg_variants.PSPNetSeg(3, encoder_stages=STAGES)
    tm.load_state_dict(weights.to_state_dict(v, weights.pspnet_seg_plan(
        STAGES)))
    return jm, v, tm, x, labels


def test_pspnet_seg_eval(psp):
    """Eval mode: the dropout is off."""
    jm, v, tm, x, _ = psp
    want = np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx))(v, x))
    with torch.no_grad():
        got = tm.eval()(nchw(x))
    np.testing.assert_allclose(nhwc(got), want, atol=ATOL)


def test_pspnet_seg_train_with_injected_mask(psp, monkeypatch):
    """Train mode with one keep mask on both sides: logits, jaccard
    gradients and the running statistics."""
    jm, v, tm, x, labels = psp
    keep = np.random.default_rng(7).random((B, H // 8, W // 8, 512)) > 0.1
    inj = InjectedDropout(keep)

    def f(params):
        with nn.intercept_methods(inj.flax):
            logits, upd = jm.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, x,
                train=True, mutable=["batch_stats"])
        return jlosses.jaccard_loss(labels, logits), (logits, upd)

    (_, (want, upd)), want_g = jax.jit(jax.value_and_grad(
        f, has_aux=True))(v["params"])
    monkeypatch.setattr(seg_variants, "dropout", inj.torch)
    tm.train()
    tm.zero_grad()
    logits = tm(nchw(x), generator=torch.Generator().manual_seed(0))
    losses.jaccard_loss(torch.from_numpy(labels).long(), logits).backward()
    plan = weights.pspnet_seg_plan(STAGES)
    np.testing.assert_allclose(nhwc(logits.detach()), np.asarray(want),
                               atol=ATOL)
    # the encoder's last stage feeds nothing: flax's gradient is 0 there,
    # torch's None; compare what the head reaches
    got_g, want_l = port_grads(tm, plan), leaves(want_g)
    for path, g in got_g.items():
        np.testing.assert_allclose(g, want_l[path], atol=ATOL,
                                   err_msg="/".join(path))
    assert all(np.all(want_l[p] == 0) for p in want_l if p not in got_g)
    assert_trees_close(port_stats(tm, plan), upd["batch_stats"], 1e-5,
                       "pspnet batch_stats")


def test_pspnet_seg_train_needs_a_generator(psp):
    _, _, tm, x, _ = psp
    with pytest.raises(ValueError, match="generator"):
        tm.train()(nchw(x))


def test_pspnet_seg_dropout_draws():
    """The port's own dropout: a tenth of the elements dropped, the rest
    scaled by 1/0.9, the same mask from the same seed."""
    x = torch.ones(1, 512, 40, 40)
    a = seg_variants.dropout(x, 0.1, torch.Generator().manual_seed(3))
    b = seg_variants.dropout(x, 0.1, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    dropped = float((a == 0).float().mean())
    assert 0.09 < dropped < 0.11
    assert torch.allclose(a[a != 0], torch.tensor(1 / 0.9))


def test_max_pool_indices_ties():
    """Windows with tied maxima: the first maximum is recorded, unpooling
    restores it there, and the gradient of the pooled maximum is shared
    among the tied elements as JAX shares it."""
    rng = np.random.default_rng(8)
    x = rng.integers(0, 3, (2, 8, 6, 3)).astype(np.float32)
    x[0, :2, :2] = 2.0                       # a window of four ties
    jp, jo = jsegnet.max_pool_with_indices(jnp.asarray(x))
    tp, to = segnet.max_pool_with_indices(nchw(x))
    np.testing.assert_array_equal(nhwc(tp), np.asarray(jp))
    np.testing.assert_array_equal(to.permute(0, 2, 3, 4, 1).numpy(),
                                  np.asarray(jo))
    assert to[0, :, 0, 0, 0].all() and not to[0, :, 0, 0, 1:].any()
    up_j = np.asarray(jsegnet.max_unpool(jp, jo))
    up_t = segnet.max_unpool(tp, to)
    np.testing.assert_array_equal(nhwc(up_t), up_j)
    probe = rng.normal(size=jp.shape).astype(np.float32)
    gj = jax.grad(lambda a: jnp.sum(
        jsegnet.max_pool_with_indices(a)[0] * probe))(jnp.asarray(x))
    tx = nchw(x).requires_grad_(True)
    (segnet.max_pool_with_indices(tx)[0] * nchw(probe)).sum().backward()
    np.testing.assert_allclose(nhwc(tx.grad), np.asarray(gj), atol=1e-6)


def test_segnet_train_and_eval():
    """SegNet at 32x32: ReLU zeros tie inside many pooling windows."""
    jm = jsegnet.SegNet(classes=4, dtype=jnp.float32)
    tm = segnet.SegNet(classes=4)
    x, labels = inputs(3, 41, classes=4, hw=(32, 32))
    check_model(jm, tm, weights.segnet_plan(), x, labels, "segnet",
                grad_noise=True)
    want = np.asarray(jsegnet.cross_entropy_loss(
        labels, jnp.asarray(np.random.default_rng(2).normal(
            size=(B, 32, 32, 4)).astype(np.float32))))
    got = segnet.cross_entropy_loss(
        torch.from_numpy(labels), nchw(np.random.default_rng(2).normal(
            size=(B, 32, 32, 4)).astype(np.float32)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --- the weight bridge -------------------------------------------------------

@pytest.mark.parametrize("which", ["unet7", "linknet", "pspnet", "segnet"])
def test_weight_bridge_both_ways(which):
    """Every leaf of the JAX tree lands in one state_dict entry of the
    right shape, every entry is fed, and a state_dict goes back to the same
    tree bit for bit."""
    jm, tm, plan, c, hw = {
        "unet7": (junet.UNet(classes=2, dtype=jnp.float32),
                  unet.UNet(2, in_ch=7), weights.unet_plan(), 7, 64),
        "linknet": (jsv.LinkNet(classes=3, dtype=jnp.float32),
                    seg_variants.LinkNet(3), weights.linknet_plan(), 3, 64),
        "pspnet": (jsv.PSPNetSeg(classes=3, dtype=jnp.float32),
                   seg_variants.PSPNetSeg(3), weights.pspnet_seg_plan(), 3,
                   64),
        "segnet": (jsegnet.SegNet(classes=5, dtype=jnp.float32),
                   segnet.SegNet(5), weights.segnet_plan(), 3, 32),
    }[which]
    v = init_vars(jm, np.zeros((1, hw, hw, c), np.float32), seed=9)
    paths = [e[0] for e in plan]
    assert sorted(paths) == sorted(leaves(v)) and len(set(paths)) == len(
        paths)
    state = tm.state_dict()
    assert {e[1] for e in plan} == set(state)
    sd = weights.to_state_dict(v, plan)
    for key, t in sd.items():
        assert t.shape == state[key].shape, key
    tm.load_state_dict(sd)
    back = weights.to_variables(tm.state_dict(), plan)
    for path, arr in leaves(v).items():
        np.testing.assert_array_equal(leaves(back)[path], arr)
    if which == "unet7":
        assert weights.unet_variables(tm)["params"]["ResNetEncoder_0"][
            "Conv_0"]["kernel"].shape == (7, 7, 7, 64)


# --- losses and metrics ------------------------------------------------------

@pytest.mark.parametrize("per_column", [False, True])
@pytest.mark.parametrize("classes_present", [(0, 1, 2, 3), (0, 2)])
def test_jaccard_loss(per_column, classes_present):
    """Both reductions, with absent classes, and the gradient."""
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(2, 9, 11, 4)).astype(np.float32)
    labels = rng.choice(classes_present, (2, 9, 11)).astype(np.int32)
    val, grad = jax.value_and_grad(
        lambda z: jlosses.jaccard_loss(labels, z, per_column=per_column))(
        jnp.asarray(logits))
    t = nchw(logits).requires_grad_(True)
    got = losses.jaccard_loss(torch.from_numpy(labels).long(), t,
                              per_column=per_column)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(val), atol=1e-6)
    np.testing.assert_allclose(nhwc(t.grad), np.asarray(grad), atol=1e-6)


def test_confusion_and_iou():
    rng = np.random.default_rng(11)
    pred = rng.integers(0, 4, (3, 10, 12))
    labels = rng.integers(0, 3, (3, 10, 12))      # class 3 never labelled
    want = np.asarray(jlosses.confusion_matrix(jnp.asarray(pred),
                                               jnp.asarray(labels), 4))
    got = losses.confusion_matrix(torch.from_numpy(pred),
                                  torch.from_numpy(labels), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    for conf in (want, np.diag([5, 0, 3, 0]), np.zeros((3, 3), int)):
        wi, wm = jlosses.iou_from_confusion(jnp.asarray(conf))
        gi, gm = losses.iou_from_confusion(torch.tensor(np.asarray(conf)))
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), atol=1e-7)
        np.testing.assert_allclose(float(gm), float(wm), atol=1e-7)
