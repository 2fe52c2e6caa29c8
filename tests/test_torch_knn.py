"""The port's nearest-neighbour ops against the JAX package's on the CPU.

`nn_plain` computes the function of the TPU kernel `_nn_kernel`: it must
equal `nn_pallas(interpret=True)` exactly, indices and d2. Against `nn_xla`,
which clamps d2 to 0 before its argmin, an index may differ where both
picks have a raw d2 <= 0, each in its own function's arithmetic; and since
XLA fuses `nn_xla`'s expansion in another order than the interpret-mode
kernel's, at a near-tie (exact d2 of the two picks within 8 * 2^-24 *
(|q|^2 + |r|^2)) on at most 0.5 % of the queries. The inputs are the cases
of `chip_smoke.py`'s phase 8 at N, M <= 3000."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoposeestimation_tpu.ops import knn as jknn
from autoposeestimation_tpu_torch.ops import knn


def ball_cloud(rng, k, center):
    """k points on a 40 mm ball around `center` (mm), 0.5 mm noise."""
    v = rng.normal(size=(k, 3))
    v *= 40.0 / np.linalg.norm(v, axis=1, keepdims=True)
    return (v + center + rng.normal(size=(k, 3)) * 0.5).astype(np.float32)


NEAR = np.asarray([30.0, 10.0, 40.0])


def make_case(name):
    """(query (N, 3), ref (M, 3), ref_valid (M,) or None)."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "N=M=1024":
        return (ball_cloud(rng, 1024, NEAR), ball_cloud(rng, 1024, NEAR),
                np.arange(1024) < 920)
    if name == "N=1000 M=3000":
        return ball_cloud(rng, 1000, NEAR), ball_cloud(rng, 3000, NEAR), None
    if name == "30% invalid":
        return (ball_cloud(rng, 2048, NEAR), ball_cloud(rng, 2048, NEAR),
                rng.random(2048) >= 0.3)
    if name == "all invalid":
        return (ball_cloud(rng, 512, NEAR), ball_cloud(rng, 700, NEAR),
                np.zeros(700, bool))
    if name == "duplicated refs":
        base = ball_cloud(rng, 1024, NEAR)
        return ball_cloud(rng, 2048, NEAR), np.concatenate([base, base]), None
    if name == "self-NN":
        ref = ball_cloud(rng, 2048, NEAR)
        return ref.copy(), ref, None
    if name == "offset 500 mm":
        far = NEAR + [500.0, 0.0, 0.0]
        return ball_cloud(rng, 2048, far), ball_cloud(rng, 2048, far), None
    if name == "overlap":
        # two overlapping copies of one cloud 1e-3 mm apart, queried at the
        # first: both copies are within the expansion's rounding of each
        # query, as where ICP's clouds overlap
        base = ball_cloud(rng, 1024, NEAR)
        shifted = base + rng.normal(size=base.shape).astype(np.float32) * 1e-3
        return base.copy(), np.concatenate([base, shifted]), None
    raise KeyError(name)


CASES = ["N=M=1024", "N=1000 M=3000", "30% invalid", "all invalid",
         "duplicated refs", "self-NN", "offset 500 mm", "overlap"]


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def raw_d2(q, r, idx):
    """The kernel's d2 of each query's pick, before the clamp."""
    q, r = t(q), t(r)[torch.as_tensor(np.asarray(idx), dtype=torch.long)]
    qr = knn._fma(q[:, 2], r[:, 2], knn._fma(q[:, 1], r[:, 1],
                                             q[:, 0] * r[:, 0]))
    return ((knn._sq_norm(q) + knn._sq_norm(r)) - 2.0 * qr).numpy()


@pytest.mark.parametrize("name", CASES)
def test_nn_plain_equals_pallas_interpret(name):
    q, r, valid = make_case(name)
    want_i, want_d = jknn.nn_pallas(jnp.asarray(q), jnp.asarray(r),
                                    None if valid is None
                                    else jnp.asarray(valid), interpret=True)
    got_i, got_d = knn.nn_plain(t(q), t(r), t(valid))
    assert got_i.dtype == torch.int32 and got_d.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    if name == "all invalid":
        assert not got_i.any() and torch.isinf(got_d).all()
    if name == "duplicated refs":
        assert (got_i < len(r) // 2).all()         # the first copy wins
    if name == "self-NN":
        assert (raw_d2(q, r, got_i.numpy()) <= 0).mean() > 0.3


@pytest.mark.parametrize("name", CASES)
def test_nn_plain_against_nn_xla(name):
    q, r, valid = make_case(name)
    xi, xd = jknn.nn_xla(jnp.asarray(q), jnp.asarray(r),
                         None if valid is None else jnp.asarray(valid))
    xi, xd = np.asarray(xi), np.asarray(xd)
    pi, pd = (a.numpy() for a in knn.nn_plain(t(q), t(r), t(valid)))
    differ = pi != xi
    if name == "all invalid":
        assert not differ.any() and np.isinf(pd).all() and np.isinf(xd).all()
        return
    q64, r64 = q.astype(np.float64), r.astype(np.float64)
    band = 8 * 2.0 ** -24 * (np.sum(q64 ** 2, 1) + np.sum(r64[pi] ** 2, 1))
    clamped = (pd == 0) & (xd == 0)
    np.testing.assert_array_equal(raw_d2(q, r, pi)[clamped] <= 0, True)
    exact_p = np.sum((q64 - r64[pi]) ** 2, 1)
    exact_x = np.sum((q64 - r64[xi]) ** 2, 1)
    near_tie = np.abs(exact_p - exact_x) < band
    assert np.all((clamped | near_tie)[differ])
    assert (differ & ~clamped).sum() <= len(q) // 200
    # the same pick: d2 within the rounding band of either expansion
    assert np.all(np.abs(pd - xd)[~differ] <= band[~differ])
    if name == "overlap":
        assert (differ & clamped).sum() > 0   # clamp-before-min occurs


SPLITS = (1, 2, 3, 7)
SPLIT_CASES = ["ties across ranges", "ties at range boundaries",
               "all-invalid ranges", "all invalid", "self-NN", "M prime"]


def range_bounds(m, splits):
    """The kernel's reference ranges: [floor(s M / S), floor((s + 1) M / S))."""
    return [(s * m // splits, (s + 1) * m // splits) for s in range(splits)]


def make_split_case(name):
    """(query, ref, ref_valid or None) whose exact ties and invalid
    references fall on the ranges of every S in SPLITS."""
    rng = np.random.default_rng(100 + SPLIT_CASES.index(name))
    if name == "ties across ranges":
        # every reference twice, the copy 300 places later, queried near
        # each: the two copies' d2 are equal and the first must win
        base = ball_cloud(rng, 300, NEAR)
        near = base + rng.normal(size=base.shape).astype(np.float32) * 1e-3
        return (np.concatenate([near, ball_cloud(rng, 200, NEAR)]),
                np.concatenate([base, base]), None)
    if name == "ties at range boundaries":
        # the reference before each range's start repeated at the start
        ref = ball_cloud(rng, 601, NEAR)
        starts = sorted({a for s in SPLITS for a, _ in range_bounds(601, s)
                         if a > 0})
        for a in starts:
            ref[a] = ref[a - 1]
        near = ref[np.asarray(starts) - 1] + rng.normal(
            size=(len(starts), 3)).astype(np.float32) * 1e-3
        return np.concatenate([near, ball_cloud(rng, 300, NEAR)]), ref, None
    if name == "all-invalid ranges":
        # the first half invalid: whole ranges for S = 2, 3 and 7
        return (ball_cloud(rng, 400, NEAR), ball_cloud(rng, 700, NEAR),
                np.arange(700) >= 350)
    if name == "all invalid":
        return (ball_cloud(rng, 300, NEAR), ball_cloud(rng, 700, NEAR),
                np.zeros(700, bool))
    if name == "self-NN":
        # queried at the references themselves, with a copy 1e-3 mm off in
        # the later ranges: both raw d2 may be negative, and the more
        # negative must win though it comes later
        base = ball_cloud(rng, 500, NEAR)
        shifted = base + rng.normal(size=base.shape).astype(np.float32) * 1e-3
        return base.copy(), np.concatenate([base, shifted]), None
    if name == "M prime":
        return (ball_cloud(rng, 333, NEAR), ball_cloud(rng, 1009, NEAR),
                rng.random(1009) >= 0.1)
    raise KeyError(name)


def split_scan(q, r, valid, splits):
    """The kernel's rule emulated with `nn_plain`: each range's first index
    of its raw (unclamped) minimum, the partials merged in range order with
    strict <, then the clamp."""
    best = torch.full((len(q),), torch.inf)
    best_i = torch.zeros(len(q), dtype=torch.int32)
    for a, b in range_bounds(len(r), splits):
        if a == b:
            continue
        i, d = knn.nn_plain(t(q), t(r[a:b]),
                            None if valid is None else t(valid[a:b]))
        raw = torch.where(torch.isinf(d), torch.inf,
                          torch.from_numpy(raw_d2(q, r[a:b], i.numpy())))
        take = raw < best
        best = torch.where(take, raw, best)
        best_i = torch.where(take, i + a, best_i)
    return best_i, torch.clamp(best, min=0.0)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("name", SPLIT_CASES)
def test_split_merge_equals_one_scan(name, splits):
    """Scanning contiguous reference ranges and merging their partials in
    range order with strict < gives `nn_plain`'s indices and d2 bit for
    bit: ties across a range boundary go to the earlier range, an invalid
    range never wins, negative raw d2 merge before the clamp."""
    q, r, valid = make_split_case(name)
    got_i, got_d = split_scan(q, r, valid, splits)
    want_i, want_d = knn.nn_plain(t(q), t(r), t(valid))
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d, want_d)
    if name.startswith("ties"):
        n_near = 300 if name == "ties across ranges" else len(q) - 300
        tie = np.all(r[want_i[:n_near].numpy()]
                     == r[want_i[:n_near].numpy() + (
                         300 if name == "ties across ranges" else 1)], 1)
        assert tie.all()          # each pick has an equal later twin
    if name == "all invalid":
        assert not got_i.any() and torch.isinf(got_d).all()
    if name == "self-NN":
        assert (raw_d2(q, r, got_i.numpy()) < 0).sum() >= 10


def test_nn_dispatch_and_cpu_path():
    q, r, valid = make_case("30% invalid")
    got = knn.nn(t(q).double(), t(r), t(valid))      # cast to f32 first
    want = knn.nn_plain(t(q), t(r), t(valid))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_knn_k_and_min_dists_against_jax():
    """The port's f64 direct-form distances against the JAX f32 expansion:
    d^2 within its rounding band 8 * 2^-24 * (|q|^2 + |r|^2) (~5e-3 mm^2
    at these 70 mm coordinates) and within f32 rounding of the exact
    distance; indices equal where the neighbouring ranks' d^2 are more than
    two bands apart."""
    rng = np.random.default_rng(0)
    q = ball_cloud(rng, 500, NEAR)
    r = ball_cloud(rng, 1200, NEAR)
    valid = rng.random(1200) > 0.2
    k = 7
    ji, jd = jknn.knn_k(jnp.asarray(q), jnp.asarray(r), k, jnp.asarray(valid))
    ji, jd = np.asarray(ji), np.asarray(jd).astype(np.float64)
    pi, pd = knn.knn_k(t(q), t(r), k, t(valid))
    assert pi.dtype == torch.int32 and pd.dtype == torch.float32
    pi, pd = pi.numpy(), pd.numpy().astype(np.float64)
    assert valid[pi].all()
    q64, r64 = q.astype(np.float64), r.astype(np.float64)
    exact = np.sqrt(np.sum((q64[:, None] - r64[pi]) ** 2, -1))
    np.testing.assert_allclose(pd, exact, rtol=2 ** -23)
    band = 8 * 2.0 ** -24 * (np.sum(q64 ** 2, 1)[:, None]
                             + np.sum(r64[pi] ** 2, -1))
    assert np.all(np.abs(pd ** 2 - jd ** 2) <= band)
    d2 = np.concatenate([np.full((len(q), 1), -np.inf), jd ** 2,
                         np.full((len(q), 1), np.inf)], 1)
    off_tie = (np.diff(d2, axis=1)[:, :-1] > 2 * band) \
        & (np.diff(d2, axis=1)[:, 1:] > 2 * band)
    assert off_tie.mean() > 0.9
    np.testing.assert_array_equal(pi[off_tie], ji[off_tie])
    md = knn.min_dists(t(q), t(r), t(valid)).numpy()
    np.testing.assert_array_equal(md, pd[:, 0].astype(np.float32))
    jmd = np.asarray(jknn.min_dists_xla(jnp.asarray(q), jnp.asarray(r),
                                        jnp.asarray(valid)))
    assert np.all(np.abs(md.astype(np.float64) ** 2
                         - jmd.astype(np.float64) ** 2) <= band[:, 0])
