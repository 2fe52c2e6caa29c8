"""The training side of the ADD-S moments and the pose losses, port against
the JAX package on the CPU:
  * `moments_train_plain` against `_moments_train_pallas(interpret=True)`
    in both cross dtypes, all 26 columns, at the tolerances of
    tests/test_pallas_addloss.py (1e-5 on dis, 1e-4 on std, 5e-4 on the
    precursors: a near-tie can match the other of two nearly equidistant
    targets);
  * `SymMoments` gradients against `jax.grad` through the XLA custom VJP
    (`sym_moments(..., use_pallas=False)`), with the three hard cases of
    tests/test_pallas_addloss.py;
  * `pose_loss` and two-iteration `refine_loss` gradients against
    `jax.value_and_grad` of the JAX losses.
The JAX CPU path never runs its kernel (`_use_kernel` is False), so the bf16
mode is held only against the interpret-mode kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoposeestimation_tpu.models import densefusion as jdf
from autoposeestimation_tpu.models import losses as jlosses
from autoposeestimation_tpu.ops import pallas_addloss as pa
from autoposeestimation_tpu.utils import transforms as jT
from autoposeestimation_tpu_torch import weights
from autoposeestimation_tpu_torch.models import densefusion, losses
from autoposeestimation_tpu_torch.ops import addloss

DIS_ATOL, STD_ATOL, PRE_ATOL = 1e-5, 1e-4, 5e-4
GRAD_ATOL = 5e-4


def t(x):
    return torch.from_numpy(np.array(x))


def moment_inputs(seed, n=70, m=30, offset=(0.01, 0.0, 0.02)):
    """One sample, the distribution of tests/test_pallas_addloss.py;
    `offset` moves the target (0.6 m is the camera-frame depth)."""
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    trans = (rng.normal(size=(n, 3)) * 0.01).astype(np.float32)
    points = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    model = (rng.normal(size=(m, 3)) * 0.05).astype(np.float32)
    rot = np.asarray(jT.quat_to_mat(rng.normal(size=4).astype(np.float32)))
    target = (model @ rot.T + offset).astype(np.float32)
    return quat, trans, points, model, target


def ties_inputs(seed=8, n=16, m=12):
    """Wrap-padded duplicates of model and target: exact distance ties."""
    quat, trans, points, model, target = moment_inputs(seed, n, m)
    return (quat, trans, points, np.concatenate([model[:6], model[:6]]),
            np.concatenate([target[:6], target[:6]]))


def mirror_inputs(depth, seed=12, n=24, m=40):
    """Exact ties between distinct targets at `depth`: the model lies in
    the plane x = 0, the candidates rotate about the x axis, and the
    targets come in pairs (+-a, y, z). The tie average has x = 0 where the
    first match would not."""
    rng = np.random.default_rng(seed)
    model = np.concatenate([np.zeros((m, 1)), rng.normal(size=(m, 2)) * 0.05],
                           1)
    half = rng.normal(size=(m // 2, 3)) * 0.05
    target = np.concatenate([half, half * [-1.0, 1.0, 1.0]]) + [0, 0, depth]
    theta = rng.normal(size=n) * 0.3
    quat = np.stack([np.cos(theta / 2), np.sin(theta / 2), np.zeros(n),
                     np.zeros(n)], 1)
    trans = np.concatenate([np.zeros((n, 1)),
                            rng.normal(size=(n, 2)) * 0.01], 1) + [0, 0, depth]
    return [a.astype(np.float32) for a in (quat, trans, np.zeros((n, 3)),
                                           model, target)]


def sphere_inputs(n=8, m=200, noise=2e-6, seed=5):
    """Model and target on the same sphere: near-constant matched
    distances, std ~ noise (the round-4 training collapse)."""
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0, 2 * np.pi, m)
    cth = rng.uniform(-1, 1, m)
    sth = np.sqrt(1 - cth ** 2)
    sphere = 0.05 * np.stack([sth * np.cos(phi), sth * np.sin(phi), cth], 1)
    target = sphere + rng.normal(size=(m, 3)) * noise + [0.1, 0.0, 0.0]
    quat = rng.normal(size=(n, 4))
    trans = np.tile([[0.1, 0.0, 0.0]], (n, 1))
    return [a.astype(np.float32) for a in (quat, trans, np.zeros((n, 3)),
                                           sphere, target)]


def coincident_inputs(n=8, m=64):
    """Each predicted point ~2e-4 m from its target, under the expansion
    form's rounding floor (the round-4 gradient spikes)."""
    rng = np.random.default_rng(11)
    model = rng.normal(size=(m, 3)) * 0.05
    target = model + [0.1, 0.0, 0.0]
    quat = np.tile([[1.0, 0.0, 0.0, 0.0]], (n, 1))
    trans = np.asarray([0.1, 0.0, 0.0]) + rng.normal(size=(n, 3)) * 1e-4
    return [a.astype(np.float32) for a in (quat, trans, np.zeros((n, 3)),
                                           model, target)]


def interpret_rows(quat, trans, points, model, target, cross_dtype):
    rot = jT.quat_to_mat(jnp.asarray(quat))
    dis, var, a_t, b_t, a_r, b_r = pa._moments_train_pallas(
        rot, jnp.asarray(points + trans), jnp.asarray(model),
        jnp.asarray(target), interpret=True, cross_dtype=cross_dtype)
    return np.concatenate([np.asarray(a_t), np.asarray(b_t),
                           np.asarray(a_r).reshape(-1, 9),
                           np.asarray(b_r).reshape(-1, 9),
                           np.asarray(dis)[:, None],
                           np.asarray(var)[:, None]], axis=1)


def plain_rows(quat, trans, points, model, target, bf16):
    from autoposeestimation_tpu_torch.utils import transforms as T

    rot = T.quat_to_mat(t(quat)).contiguous()
    return addloss.moments_train_plain(
        rot[None], t(points + trans)[None], t(model)[None], t(target)[None],
        bf16)[0].numpy()


def assert_rows_close(got, want):
    assert got.shape[1] == 32 and not got[:, 26:].any()
    np.testing.assert_allclose(got[:, 24], want[:, 24], atol=DIS_ATOL)
    np.testing.assert_allclose(np.sqrt(np.maximum(got[:, 25], 0)),
                               np.sqrt(np.maximum(want[:, 25], 0)),
                               atol=STD_ATOL)
    np.testing.assert_allclose(got[:, :24], want[:, :24], atol=PRE_ATOL)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", ["random", "camera_depth", "ties",
                                  "mirror_ties"])
def test_train_plain_matches_pallas_interpret(bf16, case):
    args = {"random": lambda: moment_inputs(1),
            "camera_depth": lambda: moment_inputs(2, offset=(0, 0, 0.6)),
            "ties": ties_inputs,
            # the JAX f32 mode is the bf16x3 expansion form, whose rounding
            # at 0.6 m depth alone exceeds the 1e-5 on dis; the port's f32
            # mode is the direct form, so f32 ties are held nearer the origin
            "mirror_ties": lambda: mirror_inputs(0.6 if bf16 else 0.1)}[case]()
    want = interpret_rows(*args, jnp.bfloat16 if bf16 else jnp.float32)
    got = plain_rows(*args, bf16)
    assert_rows_close(got, want)
    if case == "mirror_ties":
        # every match is a tie of a (+-a, y, z) pair: A_t and A_r's x row
        # vanish only under the tie average
        assert not want[:, [0, 6, 7, 8]].any()
        assert not got[:, [0, 6, 7, 8]].any()


def test_train_plain_chunking_and_batching(monkeypatch):
    """A batch of samples with tiny chunks equals each sample alone."""
    from autoposeestimation_tpu_torch.utils import transforms as T

    samples = [moment_inputs(s, n=23, m=11) for s in (3, 4)]
    q, tr, p, mo, tg = (t(np.stack(a)) for a in zip(*samples))
    args = (T.quat_to_mat(q).contiguous(), (p + tr).contiguous(), mo, tg)
    for bf16 in (False, True):
        want = addloss.moments_train_plain(*args, bf16)
        with monkeypatch.context() as mp:
            mp.setattr(addloss, "_CHUNK_ELEMS", 5 * 11 * 11)
            got = addloss.moments_train_plain(*args, bf16)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7)
        for i, s in enumerate(samples):
            np.testing.assert_allclose(want[i].numpy(), plain_rows(*s, bf16),
                                       rtol=1e-6, atol=1e-7)


def port_grads(quat, trans, points, model, target, gd, gs, bf16=False):
    q = t(quat).requires_grad_(True)
    tr = t(trans).requires_grad_(True)
    dis, std = addloss.sym_moments(q[None], tr[None], t(points)[None],
                                   t(model)[None], t(target)[None], bf16=bf16)
    (dis[0] * t(gd) + std[0] * t(gs)).sum().backward()
    return dis[0].detach().numpy(), std[0].detach().numpy(), \
        q.grad.numpy(), tr.grad.numpy()


def xla_grads(quat, trans, points, model, target, gd, gs):
    def loss(q, tr):
        dis, std = pa.sym_moments(q, tr, jnp.asarray(points),
                                  jnp.asarray(model), jnp.asarray(target),
                                  False)
        return jnp.sum(dis * gd + std * gs)

    g_q, g_t = jax.grad(loss, argnums=(0, 1))(jnp.asarray(quat),
                                              jnp.asarray(trans))
    return np.asarray(g_q), np.asarray(g_t)


@pytest.mark.parametrize("case", ["random", "ties"])
def test_sym_moments_grad_matches_xla_vjp(case):
    args = moment_inputs(5) if case == "random" else ties_inputs()
    n = args[0].shape[0]
    rng = np.random.default_rng(6)
    gd = rng.normal(size=n).astype(np.float32)
    gs = rng.normal(size=n).astype(np.float32)
    dis, std, g_q, g_t = port_grads(*args, gd, gs)
    want_dis, want_std = pa.sym_moments(*map(jnp.asarray, args),
                                        use_pallas=False)
    np.testing.assert_allclose(dis, np.asarray(want_dis), atol=DIS_ATOL)
    np.testing.assert_allclose(std, np.asarray(want_std), atol=STD_ATOL)
    want_q, want_t = xla_grads(*args, gd, gs)
    assert np.isfinite(g_q).all() and np.isfinite(g_t).all()
    np.testing.assert_allclose(g_t, want_t, atol=GRAD_ATOL)
    np.testing.assert_allclose(g_q, want_q, atol=GRAD_ATOL)


@pytest.mark.parametrize("bf16", [False, True])
def test_degenerate_sphere_gradient_bounded(bf16):
    """|g| stays under the O(sqrt(M)) scale of exact math (pre-fix ~1e6);
    in f32 the gradients also agree with the XLA VJP."""
    args = sphere_inputs()
    n = args[0].shape[0]
    gd, gs = np.ones(n, np.float32), np.full(n, 2.0, np.float32)
    _, _, g_q, g_t = port_grads(*args, gd, gs, bf16=bf16)
    for g in (g_q, g_t):
        assert np.isfinite(g).all()
        assert np.abs(g).max() < 50.0, np.abs(g).max()
    if not bf16:
        want_q, want_t = xla_grads(*args, gd, gs)
        np.testing.assert_allclose(g_t, want_t, atol=GRAD_ATOL)
        np.testing.assert_allclose(g_q, want_q, atol=GRAD_ATOL)


@pytest.mark.parametrize("bf16", [False, True])
def test_near_coincident_points_gradient_bounded(bf16):
    """g_t = sum u_i / M with |u_i| <= 1, so |g_t| <= 1 (pre-fix ~1e8)."""
    args = coincident_inputs()
    n = args[0].shape[0]
    _, _, g_q, g_t = port_grads(*args, np.ones(n, np.float32),
                                np.zeros(n, np.float32), bf16=bf16)
    assert np.isfinite(g_q).all() and np.isfinite(g_t).all()
    assert np.abs(g_t).max() < 2.0, np.abs(g_t).max()


def test_bf16_forward_without_grad_is_train_kernel_moments():
    """Without grad, bf16 mode returns columns 24-25 of the training rows
    (`_moments_fwd(cross_dtype=bf16)`'s function)."""
    args = moment_inputs(7, offset=(0, 0, 0.6))
    with torch.no_grad():
        dis, std = addloss.sym_moments(*(t(a)[None] for a in args),
                                       bf16=True)
    rows = plain_rows(*args, True)
    # rtol 1e-6: the same arithmetic, summed in another vector order
    np.testing.assert_allclose(dis[0].numpy(), rows[:, 24], rtol=1e-6)
    np.testing.assert_allclose(std[0].numpy(),
                               np.sqrt(np.maximum(rows[:, 25], 0)), rtol=1e-6)
    rot = jT.quat_to_mat(jnp.asarray(args[0]))
    want_dis, want_var = pa._moments_fwd(
        rot, jnp.asarray(args[2] + args[1]), jnp.asarray(args[3]),
        jnp.asarray(args[4]), interpret=True, cross_dtype=jnp.bfloat16)
    np.testing.assert_allclose(dis[0].numpy(), np.asarray(want_dis),
                               atol=DIS_ATOL)


# --- the training kernel's scan (csrc/sym_moments_train.cu) -------------------

def bf16_round(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float() \
        .numpy()


def staged_scan_values(points, target, mode):
    """(values (P, M), pp (P,) or None, staged targets (M, 3)) as the
    kernel stages and scans them. bf16 mode: q = bf16(p), the target as
    -2 bf16(t) and bf16(|t|^2), values (q.(-2t)) + |t|^2 with one rounding a
    step (bf16 x bf16 products are exact in f32, so each FMA is the product
    and an add) and d2 = fl(value + pp), pp = bf16(|p|^2). f32 mode: d2 of
    the direct form; this test holds the scan's logic for given values, so
    the f32 value needs no FMA."""
    if mode == "f32":
        d = points[:, None, :] - target[None]
        d2 = (d[..., 2] * d[..., 2] + d[..., 1] * d[..., 1]) \
            + d[..., 0] * d[..., 0]
        return d2.astype(np.float32), None, target
    q = bf16_round(points)
    tq = (-2.0 * bf16_round(target)).astype(np.float32)
    tw = bf16_round((target[:, 0] * target[:, 0]
                     + target[:, 1] * target[:, 1])
                    + target[:, 2] * target[:, 2])
    v = q[:, None, 0] * tq[None, :, 0]
    v = v + q[:, None, 1] * tq[None, :, 1]
    v = v + q[:, None, 2] * tq[None, :, 2]
    pp = bf16_round((points[:, 0] * points[:, 0]
                     + points[:, 1] * points[:, 1])
                    + points[:, 2] * points[:, 2])
    return (v + tw[None]).astype(np.float32), pp, tq


def one_scan(d2, tgt):
    """The one-pass running-tie scan (the kernel's form before the grouped
    scan): per point the minimum, reset on d2 < best, and the sum and count
    of the targets with d2 == best."""
    p = d2.shape[0]
    best = np.full(p, np.inf, np.float32)
    sums = np.zeros((p, 3), np.float32)
    cnt = np.zeros(p, np.float32)
    for j in range(d2.shape[1]):
        lt, le = d2[:, j] < best, d2[:, j] <= best
        best = np.where(lt, d2[:, j], best)
        sums = np.where(lt[:, None], np.float32(0), sums)
        sums = np.where(le[:, None], sums + tgt[j], sums)
        cnt = np.where(lt, np.float32(0), cnt)
        cnt = np.where(le, cnt + np.float32(1), cnt)
    return best, sums, cnt


def grouped_scan(values, pp, tgt, group):
    """The kernel's scan: per group of `group` targets (padded with +inf) the
    fminf minimum of the values, + pp once a group, then with selects the
    least group value bestd, the first group below all before it and the
    last group at or below bestd; after the scan, the targets from the
    first to the last group with d2 == bestd, summed in increasing j from
    zero, the minimum's bits from the first of them (with no finite value
    the first group stays 0). Returns those and each point's collected
    range."""
    p, m = values.shape
    m_pad = -(-m // group) * group
    padded = np.full((p, m_pad), np.inf, np.float32)
    padded[:, :m] = values
    bestd = np.full(p, np.inf, np.float32)
    first = np.zeros(p, np.int64)
    last = np.zeros(p, np.int64)
    for g in range(0, m_pad, group):
        low = np.fmin.reduce(padded[:, g:g + group], axis=1)
        d = low if pp is None else low + pp
        first = np.where(d < bestd, g, first)
        last = np.where(d <= bestd, g, last)
        bestd = np.fmin(bestd, d)
    lo, hi = first, np.minimum(last + group, m)
    d2 = values if pp is None else values + pp[:, None]
    best = np.full(p, np.inf, np.float32)
    sums = np.zeros((p, 3), np.float32)
    cnt = np.zeros(p, np.float32)
    for j in range(m):
        eq = (j >= lo) & (j < hi) & (d2[:, j] == bestd)
        best = np.where(eq & (cnt == 0), d2[:, j], best)
        sums = np.where(eq[:, None], sums + tgt[j], sums)
        cnt = np.where(eq, cnt + np.float32(1), cnt)
    return (best, sums, cnt), hi - lo


def tie_scan_case(name, p=48, m=100):
    """(values, pp, staged targets) of a named case of the scan test."""
    rng = np.random.default_rng(sum(map(ord, name)))
    points = (rng.normal(size=(p, 3)) * 0.05 + [0, 0, 0.6]).astype(np.float32)
    target = (rng.normal(size=(m, 3)) * 0.05 + [0, 0, 0.6]).astype(np.float32)
    if name == "random":
        return staged_scan_values(points, target, "bf16")
    if name == "random f32":
        return staged_scan_values(points, target, "f32")
    if name == "ties across groups":
        # wrap-padded duplicates: every point's minimum repeats 37 apart
        return staged_scan_values(points, target[np.arange(m) % 37], "bf16")
    if name == "ties after + pp":
        # distinct values that fl(1 + value) merges
        values = (rng.integers(0, 40, (p, m)) * 1e-8).astype(np.float32)
        return values, np.ones(p, np.float32), target
    if name == "M not a multiple of G":
        values, pp, tgt = staged_scan_values(points, target[:61], "bf16")
        values[:, 60] = values.min(1)     # a tie in the padded last group
        return values, pp, tgt
    if name == "all equal":
        return np.full((p, m), 0.25, np.float32), None, target
    if name == "+-0 minimum":
        # f32-mode values with both zeros at the minimum, in either order
        values = rng.uniform(0.1, 1.0, (p, m)).astype(np.float32)
        zero_first = rng.integers(0, m // 2 - 10, p)
        zero_then = rng.integers(m // 2 + 10, m, p)
        rows = np.arange(p)
        values[rows, zero_first] = np.where(rows % 2, -0.0, 0.0)
        values[rows, zero_then] = np.where(rows % 2, 0.0, -0.0)
        return values, None, target
    if name == "no finite value":
        # +inf ties (as one scan counts them), whole groups of NaN first,
        # and rows of NaN only (no match: count 0)
        values = np.full((p, m), np.inf, np.float32)
        values[: p // 2, ::3] = np.nan
        values[: p // 4, :16] = np.nan
        values[p - 4:] = np.nan
        return values, None, target
    raise ValueError(name)


@pytest.mark.parametrize("group", [4, 8, 16])
@pytest.mark.parametrize("name", [
    "random", "random f32", "ties across groups", "ties after + pp",
    "M not a multiple of G", "all equal", "+-0 minimum", "no finite value"])
def test_grouped_tie_scan_equals_one_scan(name, group):
    """The kernel's grouped scan with its after-scan collection gives the
    one-pass running-tie scan's minimum, target sums and count bit for bit
    (so every training row is the one-pass kernel's), and the collection
    visits one group unless exact ties span groups."""
    values, pp, tgt = tie_scan_case(name)
    d2 = values if pp is None else values + pp[:, None]
    want = one_scan(d2, tgt)
    got, span = grouped_scan(values, pp, tgt, group)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
    ties = np.sum(d2 == want[0][:, None], axis=1)
    assert (ties >= 1).all() or name == "no finite value"
    if name in ("random", "random f32"):
        assert (ties == 1).all() and (span <= group).all()
    if name in ("ties across groups", "all equal", "+-0 minimum"):
        assert (ties >= 2).all() and (span > group).all()
    if name == "ties after + pp":
        assert (ties >= 2).all() and len(np.unique(values.min(1))) > 1
    if name == "+-0 minimum":      # the first zero's sign, as in one scan
        np.testing.assert_array_equal(np.signbit(got[0]),
                                      np.arange(len(values)) % 2 == 1)


# --- losses -------------------------------------------------------------------

def loss_batch(seed, b=4, n=32, m=20):
    rng = np.random.default_rng(seed)
    model = (rng.normal(size=(b, m, 3)) * 0.05).astype(np.float32)
    rot = np.asarray(jT.quat_to_mat(rng.normal(size=(b, 4)).astype(
        np.float32)))
    target = (np.einsum("bmj,bij->bmi", model, rot)
              + rng.normal(size=(b, 1, 3)) * 0.05 + [0, 0, 0.6])
    points = target[:, rng.integers(0, m, n)] + rng.normal(size=(b, n, 3)) \
        * 0.005
    return {
        "pred_r": rng.normal(size=(b, n, 4)).astype(np.float32),
        "pred_t": (rng.normal(size=(b, n, 3)) * 0.01).astype(np.float32),
        "pred_c": rng.uniform(0.05, 1.0, (b, n, 1)).astype(np.float32),
        "target": target.astype(np.float32),
        "model_points": model,
        "points": points.astype(np.float32),
        "is_sym": np.arange(b) % 2 == 0,
    }


def test_pose_loss_gradients():
    """Loss and d loss / d (pred_r, pred_t, pred_c) with symmetric and
    non-symmetric samples in one batch, f32 moments."""
    d = loss_batch(6)
    keys = ("pred_r", "pred_t", "pred_c")

    def jloss(pr, pt, pc):
        rest = {k: jnp.asarray(v) for k, v in d.items() if k not in keys}
        return jlosses.pose_loss(pr, pt, pc, **rest, w=0.015).loss

    want, want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(d[k]) for k in keys))
    leaves = {k: t(d[k]).requires_grad_(True) for k in keys}
    out = losses.pose_loss(**leaves, **{k: t(v) for k, v in d.items()
                                        if k not in keys}, w=0.015)
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(want), rtol=1e-5)
    for k, g in zip(keys, want_g):
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(g),
                                   atol=1e-5, err_msg=k)
    assert not out.new_points.requires_grad
    assert not out.new_target.requires_grad


@pytest.fixture(scope="module")
def refiner_pair():
    """A JAX refiner with random weights everywhere (a fresh one's final
    layers are zero and pass no gradient back) and the port's copy."""
    from test_torch_models import init_vars

    jm = jdf.PoseRefineNet(num_obj=2, dtype=jnp.float32)
    v = init_vars(jm, np.zeros((1, 24, 3), np.float32),
                  np.zeros((1, 24, 32), np.float32), np.zeros(1, np.int32),
                  seed=21)
    tm = densefusion.PoseRefineNet(2)
    tm.load_state_dict(weights.refiner_state_dict(v))
    return jm, v, tm


def test_two_refine_iterations_gradients(refiner_pair):
    """Refiner-parameter gradients of two rebased refine iterations, as
    `refiner_step` sums them. The second iteration takes the first one's
    rebased clouds, whose gradient the JAX loss stops: without the port's
    detach the gradients differ."""
    jm, v, tm = refiner_pair
    d = loss_batch(12, b=4, n=24, m=20)
    rng = np.random.default_rng(13)
    emb = rng.normal(size=(4, 24, 32)).astype(np.float32)
    obj = np.asarray([0, 1, 1, 0], np.int32)
    args = (d["target"], d["model_points"], d["points"], d["is_sym"])

    def jtotal(params):
        variables = {**v, "params": params}
        new_target, model, new_points, is_sym = map(jnp.asarray, args)
        total = 0.0
        for _ in range(2):
            dr, dt = jm.apply(variables, new_points, emb, obj)
            mean_dis, _, new_points, new_target = jlosses.refine_loss(
                dr, dt, new_target, model, new_points, is_sym)
            total = total + mean_dis
        return total

    want, want_g = jax.value_and_grad(jtotal)(v["params"])
    tm.zero_grad()
    new_target, model, new_points, is_sym = map(t, args)
    total = 0.0
    for _ in range(2):
        dr, dt = tm(new_points, t(emb), t(obj).long())
        mean_dis, _, new_points, new_target = losses.refine_loss(
            dr, dt, new_target, model, new_points, is_sym)
        total = total + mean_dis
    total.backward()
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-5)
    got = weights.to_variables({k: p.grad for k, p in tm.named_parameters()},
                               weights.refiner_plan())["params"]
    for path, g in jax.tree_util.tree_flatten_with_path(want_g)[0]:
        node = got
        for p in path:
            node = node[p.key]
        scale = max(np.abs(np.asarray(g)).max(), 1e-3)
        np.testing.assert_allclose(node, np.asarray(g), atol=1e-4 * scale,
                                   err_msg=str(path))
