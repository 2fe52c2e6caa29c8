"""ADD-S moments and the pose losses, port against the JAX package on the
CPU: the plain version against the XLA path and against the Pallas kernel
in interpret mode, at the tolerances of tests/test_pallas_addloss.py (1e-5
on dis, 1e-4 on std). The CUDA kernel against the plain version is in
tests/test_torch_kernels.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoposeestimation_tpu.models import losses as jlosses
from autoposeestimation_tpu.ops import pallas_addloss as pa
from autoposeestimation_tpu.utils import transforms as jT
from autoposeestimation_tpu_torch.models import losses
from autoposeestimation_tpu_torch.ops import addloss


def t(x):
    return torch.from_numpy(np.array(x))


def moment_inputs(seed, n=40, m=30):
    """One sample, the distribution of tests/test_pallas_addloss.py."""
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    trans = (rng.normal(size=(n, 3)) * 0.01).astype(np.float32)
    points = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    model = (rng.normal(size=(m, 3)) * 0.05).astype(np.float32)
    rot = np.asarray(jT.quat_to_mat(rng.normal(size=4).astype(np.float32)))
    target = (model @ rot.T + [0.01, 0.0, 0.02]).astype(np.float32)
    return quat, trans, points, model, target


def degenerate_inputs(n=64, m=100, seed=0):
    """Wrap-padded duplicate targets on a near-degenerate sphere: the target
    is the model sphere rotated and grown by 1 mm, candidates sit near the
    identity, so every matched distance is ~1 mm and the spread is tiny
    (the centered variance's case)."""
    rng = np.random.default_rng(seed)
    i = np.arange(m) + 0.5
    phi, theta = np.arccos(1 - 2 * i / m), np.pi * (1 + 5 ** 0.5) * i
    sphere = np.stack([np.sin(phi) * np.cos(theta),
                       np.sin(phi) * np.sin(theta), np.cos(phi)], 1) * 0.05
    rot = np.asarray(jT.quat_to_mat(rng.normal(size=4).astype(np.float32)))
    target = (sphere @ rot.T) * (0.051 / 0.05)
    target = target[np.arange(m) % (m - 17)]        # wrap-padded duplicates
    quat = np.tile([1.0, 0, 0, 0], (n, 1)) + rng.normal(size=(n, 4)) * 1e-3
    trans = rng.normal(size=(n, 3)) * 1e-5
    points = np.zeros((n, 3))
    return [a.astype(np.float32) for a in (quat, trans, points, sphere,
                                           target)]


def port_moments(quat, trans, points, model, target):
    dis, std = addloss.sym_moments(t(quat)[None], t(trans)[None],
                                   t(points)[None], t(model)[None],
                                   t(target)[None])
    return dis[0].numpy(), std[0].numpy()


@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_plain_matches_xla_path(case):
    args = moment_inputs(0) if case == "random" else degenerate_inputs()
    dis, std = port_moments(*args)
    want_dis, want_std = pa.sym_moments(*map(jnp.asarray, args),
                                        use_pallas=False)
    np.testing.assert_allclose(dis, np.asarray(want_dis), atol=1e-5)
    np.testing.assert_allclose(std, np.asarray(want_std), atol=1e-4)


@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_plain_matches_pallas_interpret(case):
    quat, trans, points, model, target = (
        moment_inputs(1) if case == "random" else degenerate_inputs(seed=1))
    rot = jT.quat_to_mat(jnp.asarray(quat))
    dis_p, var_p = pa._moments_fwd(rot, jnp.asarray(points + trans),
                                   jnp.asarray(model), jnp.asarray(target),
                                   interpret=True)
    dis, std = port_moments(quat, trans, points, model, target)
    np.testing.assert_allclose(dis, np.asarray(dis_p), atol=1e-5)
    np.testing.assert_allclose(std, np.sqrt(np.maximum(np.asarray(var_p), 0)),
                               atol=1e-4)


def test_plain_chunking_and_batching(monkeypatch):
    """A batch of samples with tiny chunks equals each sample alone."""
    samples = [moment_inputs(s, n=23, m=11) for s in (2, 3)]
    batch = [t(np.stack(a)) for a in zip(*samples)]
    want = addloss.sym_moments(*batch)
    monkeypatch.setattr(addloss, "_CHUNK_ELEMS", 5 * 11 * 11)
    got = addloss.sym_moments(*batch)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-6)
    for i, s in enumerate(samples):
        dis, std = port_moments(*s)
        np.testing.assert_allclose(want[0][i].numpy(), dis, rtol=1e-6)
        np.testing.assert_allclose(want[1][i].numpy(), std, rtol=1e-6)


# --- losses --------------------------------------------------------------------

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


@pytest.mark.parametrize("with_sym", [True, False])
def test_pose_loss(with_sym):
    d = loss_batch(6)
    want = jlosses.pose_loss(**{k: jnp.asarray(v) for k, v in d.items()},
                             w=0.015, with_sym=with_sym)
    got = losses.pose_loss(**{k: t(v) for k, v in d.items()}, w=0.015,
                           with_sym=with_sym)
    for name in ("loss", "dis", "new_points", "new_target", "best_r",
                 "best_t"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("with_sym", [True, False])
def test_refine_loss(with_sym):
    d = loss_batch(7)
    rng = np.random.default_rng(8)
    dr = (np.asarray([1.0, 0, 0, 0]) + rng.normal(size=(4, 4)) * 0.1).astype(
        np.float32)
    dt = (rng.normal(size=(4, 3)) * 0.01).astype(np.float32)
    args = (dr, dt, d["target"], d["model_points"], d["points"], d["is_sym"])
    want = jlosses.refine_loss(*map(jnp.asarray, args), with_sym=with_sym)
    got = losses.refine_loss(*map(t, args), with_sym=with_sym)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-6)


@pytest.mark.parametrize("topk", [1, 3])
def test_pose_extraction(topk):
    d = loss_batch(9)
    jargs = [jnp.asarray(d[k]) for k in ("pred_r", "pred_t", "pred_c",
                                         "points")]
    quat, trans = losses.estimator_prediction(
        *[t(d[k]) for k in ("pred_r", "pred_t", "pred_c", "points")],
        topk=topk)
    jquat, jtrans = jlosses.estimator_prediction(*jargs, topk=topk)
    np.testing.assert_allclose(quat.numpy(), np.asarray(jquat), atol=1e-6)
    np.testing.assert_allclose(trans.numpy(), np.asarray(jtrans), atol=1e-6)

    got = losses.rebase_points(quat, trans, t(d["points"]))
    want = jlosses.rebase_points(jquat, jtrans, jnp.asarray(d["points"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    dr = d["pred_r"][:, 0]
    dt = d["pred_t"][:, 0]
    got = losses.compose_refined(t(dr), t(dt), quat, trans)
    want = jlosses.compose_refined(dr, dt, jquat, jtrans)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-6)

    got = losses.add_metric(quat, trans, t(d["target"]),
                            t(d["model_points"]), t(d["is_sym"]))
    want = jlosses.add_metric(jquat, jtrans, jnp.asarray(d["target"]),
                              jnp.asarray(d["model_points"]),
                              jnp.asarray(d["is_sym"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
