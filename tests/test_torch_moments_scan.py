"""The forward moments kernel's arithmetic (csrc/sym_moments.cu), emulated
in numpy f32 on the CPU: the kernel has no CPU mode, so its design is held
here and the kernel itself on the card (chip_smoke.py phase 2).

The kernel works in each candidate's own frame (p = R m, q = target - t),
scans the expansion form s = p.(-2q) + |q|^2 with a group minimum over
groups of 16 targets, keeps per point the first group that reached the
least value, and recomputes the direct form (p - q)^2 over that group's
real targets. The tests:
  * the winning-group rule picks the group of `np.argmin` over s;
  * the emulation against an f64 truth on cases at the batches' 0.6 m
    camera depth, at DIS_TOL / STD_TOL, ten times tighter than the gates
    of tests/test_pallas_addloss.py (1e-5 on dis, 1e-4 on std);
  * without the centring, or without the recompute, the emulation misses
    that tolerance on a case built for it;
  * the emulation against the JAX kernel `_moments_fwd(interpret=True)` on
    tests/test_torch_addloss.py's cases, at the gates.
fmaf is emulated through f64 (the product is exact there, the sum rounds
to f64 and then to f32): a double rounding that differs from the card's
single rounding in rare last bits, which an accuracy emulation tolerates."""
import jax.numpy as jnp
import numpy as np
import pytest

from autoposeestimation_tpu.ops import pallas_addloss as pa
from autoposeestimation_tpu.utils import transforms as jT
from test_torch_addloss import degenerate_inputs, moment_inputs

F32 = np.float32
GROUP = 16                   # kGroup in csrc/sym_moments.cu
DIS_ATOL, STD_ATOL = 1e-5, 1e-4
DIS_TOL, STD_TOL = 1e-6, 1e-5
DEPTH = (0.0, 0.0, 0.6)      # the evaluation batches' camera depth (m)


def fma32(a, b, c):
    """fmaf(a, b, c) of f32 operands, through f64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def winning_groups(s, group):
    """The scan's rule over the last axis of s: padded with +inf to a
    multiple of `group`, each group folded with fminf, then per group with
    selects the least value and the first group below all before it
    (strict <; it stays 0 when no value is finite). Returns (the winning
    group's first index, the least value)."""
    m = s.shape[-1]
    m_pad = -(-m // group) * group
    padded = np.full(s.shape[:-1] + (m_pad,), np.inf, F32)
    padded[..., :m] = s
    best = np.full(s.shape[:-1], np.inf, F32)
    first = np.zeros(s.shape[:-1], np.int64)
    for g in range(0, m_pad, group):
        low = padded[..., g]
        for u in range(1, group):
            low = np.fmin(low, padded[..., g + u])
        first = np.where(low < best, g, first)
        best = np.fmin(best, low)
    return first, best


def kernel_moments(rot, pred_t, model, target, centre=True, recompute=True,
                   group=GROUP):
    """(dis (N,), var (N,)) of one sample in the kernel's arithmetic.
    `centre=False` works in the camera frame (p = R m + t, q = target, the
    transform of the kernel before), `recompute=False` takes
    fl(least s + |p|^2) for d2: the two mutations of the design."""
    rot, pred_t, model, target = (np.asarray(a, F32) for a in
                                  (rot, pred_t, model, target))
    n, m = len(rot), len(model)
    q = target[None] - (pred_t[:, None] if centre else F32(0))  # (N, M, 3)
    qq = fma32(q[..., 0], q[..., 0],
               fma32(q[..., 1], q[..., 1], q[..., 2] * q[..., 2]))
    tq = F32(-2) * q

    def row(a):
        r = rot[:, a, :, None]
        inner = r[:, 2] * model[:, 2] if centre else fma32(
            r[:, 2], model[:, 2], pred_t[:, a, None])
        return fma32(r[:, 0], model[:, 0], fma32(r[:, 1], model[:, 1], inner))

    p = np.stack([row(a) for a in range(3)], -1)              # (N, M, 3)
    s = fma32(p[:, :, None, 0], tq[:, None, :, 0],
              fma32(p[:, :, None, 1], tq[:, None, :, 1],
                    fma32(p[:, :, None, 2], tq[:, None, :, 2],
                          qq[:, None, :])))                   # (N, M, M)
    first, low = winning_groups(s, group)
    if recompute:
        d2 = np.full((n, m), np.inf, F32)
        for u in range(group):
            j = first + u
            qj = np.take_along_axis(q, np.minimum(j, m - 1)[..., None], 1)
            d = p - qj                    # fmaf(0.5, -2q, p): p - q, rounded
            e = fma32(d[..., 0], d[..., 0],
                      fma32(d[..., 1], d[..., 1], d[..., 2] * d[..., 2]))
            d2 = np.where(j < m, np.fmin(d2, e), d2)
    else:
        d2 = low + fma32(p[..., 0], p[..., 0],
                         fma32(p[..., 1], p[..., 1], p[..., 2] * p[..., 2]))
    dmin = np.sqrt(np.maximum(d2, F32(0)))
    mean = dmin.sum(1, dtype=F32) * (F32(1) / F32(m))
    dd = dmin - mean[:, None]
    var = (dd * dd).sum(1, dtype=F32) * (F32(1) / F32(max(m - 1, 1)))
    return mean, var


def truth(rot, pred_t, model, target):
    """(dis, var) in f64, direct form, from the f32 inputs."""
    rot, pred_t, model, target = (np.asarray(a, np.float64) for a in
                                  (rot, pred_t, model, target))
    pred = np.einsum("nij,mj->nmi", rot, model) + pred_t[:, None]
    dmin = np.sqrt(np.min(np.sum(
        (pred[:, :, None] - target[None, None]) ** 2, -1), -1))
    dis = dmin.mean(1)
    return dis, np.sum((dmin - dis[:, None]) ** 2, 1) / max(len(model) - 1, 1)


def errors(got, want):
    """(max |dis error|, max |std error|)."""
    return (float(np.abs(got[0] - want[0]).max()),
            float(np.abs(np.sqrt(np.maximum(got[1], 0))
                         - np.sqrt(np.maximum(want[1], 0))).max()))


# --- (a) the winning-group rule -------------------------------------------------

def scan_values(name, p=48, m=100):
    """(P, M) f32 scan values of a named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    s = rng.normal(size=(p, m)).astype(F32)
    if name == "random":
        return s
    if name == "M not a multiple of G":
        s = s[:, :61]
        s[::2, 60] = s[::2].min(1) - 1    # the minimum in the ragged group
        s[1::4, 60] = s[1::4].min(1)      # a tie there with an earlier group
        return s
    if name == "all equal":
        return np.full((p, m), 0.25, F32)
    if name == "duplicates across groups":
        return s[:, np.arange(m) % 37]    # each minimum repeats 37 apart
    if name == "+inf before the minimum":
        s[:, :64] = np.inf
        return s
    if name == "no finite value":
        return np.full((p, m), np.inf, F32)
    raise ValueError(name)


@pytest.mark.parametrize("group", [4, 8, 16])
@pytest.mark.parametrize("name", [
    "random", "M not a multiple of G", "all equal", "duplicates across groups",
    "+inf before the minimum", "no finite value"])
def test_winning_group_is_argmin_group(name, group):
    """The first group whose value beats all before it holds the first
    minimum of s: its index is `np.argmin`'s group, bit for bit, and its
    value the minimum."""
    s = scan_values(name)
    first, best = winning_groups(s, group)
    at = np.argmin(s, axis=1)
    np.testing.assert_array_equal(first, at // group * group)
    np.testing.assert_array_equal(
        best.view(np.uint32), s[np.arange(len(s)), at].view(np.uint32))
    if name in ("all equal", "no finite value"):
        assert not first.any()


# --- (b) accuracy at the camera depth -------------------------------------------

def quat_rot(quat):
    return np.asarray(jT.quat_to_mat(np.asarray(quat, F32)), F32)


def camera_case(name, n=64, m=100):
    """(rot (N, 3, 3), pred_t (N, 3), model (M, 3), target (M, 3)), f32, of
    one sample at 0.6 m depth (chip_smoke.py builds the same at B=8,
    N=1000, M=500)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    q_true = rng.normal(size=4)
    q_true /= np.linalg.norm(q_true)
    r_true = np.asarray(jT.quat_to_mat(q_true), np.float64)
    model = (rng.normal(size=(m, 3)) * 0.05).astype(F32)
    t_true = np.asarray(DEPTH) + rng.normal(size=3) * 0.05
    target = (model @ r_true.T + t_true).astype(F32)
    if name == "camera_depth":
        # candidates scattered around the true pose, each translation a
        # cloud point plus an offset, as in pose_loss
        cloud = target[rng.integers(0, m, n)] + rng.normal(size=(n, 3)) * 2e-3
        rot = quat_rot(q_true + rng.normal(size=(n, 4)) * 0.1)
        return rot, (cloud + rng.normal(size=(n, 3)) * 0.01).astype(F32), \
            model, target
    if name == "ground_truth":
        # every candidate at the true pose: each dmin is the inputs'
        # rounding, ~1e-8 m
        return (np.tile(r_true.astype(F32), (n, 1, 1)),
                np.tile(t_true.astype(F32), (n, 1)), model, target)
    if name == "duplicated":
        # the true pose, and each target repeated 1e-4 m away in another
        # group: the scan has to tell d2 = 0 from d2 = 1e-8
        half = m // 2
        step = rng.normal(size=(half, 3))
        step *= 1e-4 / np.linalg.norm(step, axis=1, keepdims=True)
        return (np.tile(r_true.astype(F32), (n, 1, 1)),
                np.tile(t_true.astype(F32), (n, 1)),
                np.concatenate([model[:half], model[:half]]),
                np.concatenate([target[:half], (target[:half] + step)
                                .astype(F32)]))
    if name == "mirror_ties":
        # exact ties between distinct targets (chip_smoke.py's mirror_case)
        model = np.concatenate([np.zeros((m, 1)), rng.normal(size=(m, 2))
                                * 0.05], 1).astype(F32)
        half = rng.normal(size=(m // 2, 3)) * 0.05
        target = (np.concatenate([half, half * [-1.0, 1.0, 1.0]]) + DEPTH
                  ).astype(F32)
        theta = rng.normal(size=n) * 0.3
        rot = quat_rot(np.stack([np.cos(theta / 2), np.sin(theta / 2),
                                 np.zeros(n), np.zeros(n)], 1))
        pred_t = np.concatenate([np.zeros((n, 1)), rng.normal(size=(n, 2))
                                 * 0.01], 1) + DEPTH
        return rot, pred_t.astype(F32), model, target
    if name == "coincident":
        # each predicted point ~2e-4 m from its target, under the plain
        # expansion form's rounding floor at this depth
        return (np.tile(np.eye(3, dtype=F32), (n, 1, 1)),
                (np.asarray(DEPTH) + rng.normal(size=(n, 3)) * 1e-4
                 ).astype(F32), model, (model + np.asarray(DEPTH, F32)
                                        ).astype(F32))
    raise ValueError(name)


@pytest.mark.parametrize("name", ["camera_depth", "ground_truth",
                                  "duplicated", "mirror_ties", "coincident"])
def test_emulation_matches_f64_truth(name):
    """The kernel's arithmetic is within DIS_TOL / STD_TOL of the f64
    direct form on every case at the camera depth."""
    args = camera_case(name)
    err_dis, err_std = errors(kernel_moments(*args), truth(*args))
    assert err_dis <= DIS_TOL, err_dis
    assert err_std <= STD_TOL, err_std
    if name == "ground_truth":
        assert kernel_moments(*args)[0].max() <= 1e-7


# --- (c) each half of the design is needed ---------------------------------------

@pytest.mark.parametrize("mutation, name", [
    ("no centring", "duplicated"), ("no recompute", "ground_truth")])
def test_mutation_misses_tolerance(mutation, name):
    """Scanning in the camera frame picks the duplicate 1e-4 m away for
    some points (|p|^2 ~ 0.36 rounds by ~3e-8 m^2, more than the 1e-8 gap);
    taking the scan's value fl(s + |p|^2) floors dmin near the square root
    of its rounding (~1e-5 m). Either misses DIS_TOL where the design
    holds it."""
    args = camera_case(name)
    want = truth(*args)
    kw = {"centre": False} if mutation == "no centring" else {
        "recompute": False}
    assert errors(kernel_moments(*args), want)[0] <= DIS_TOL
    assert errors(kernel_moments(*args, **kw), want)[0] > DIS_TOL


# --- (d) against the JAX kernel ----------------------------------------------------

@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_emulation_matches_pallas_interpret(case):
    quat, trans, points, model, target = (
        moment_inputs(1) if case == "random" else degenerate_inputs(seed=1))
    rot = jT.quat_to_mat(jnp.asarray(quat))
    pred_t = points + trans
    want = pa._moments_fwd(rot, jnp.asarray(pred_t), jnp.asarray(model),
                           jnp.asarray(target), interpret=True)
    got = kernel_moments(np.asarray(rot), pred_t, model, target)
    err_dis, err_std = errors(got, [np.asarray(w) for w in want])
    assert err_dis <= DIS_ATOL, err_dis
    assert err_std <= STD_ATOL, err_std
