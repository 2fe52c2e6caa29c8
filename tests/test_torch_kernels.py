"""The port's CUDA kernels against their plain PyTorch versions. Imports
neither JAX nor the JAX package, so the tests that need the card (marker
`cuda`) also run where only the port is installed:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

On the CPU they skip; the wrapper checks run everywhere."""
import numpy as np
import pytest
import torch

from autoposeestimation_tpu_torch.ops import addloss, knn
from autoposeestimation_tpu_torch.utils import transforms as T


def moment_inputs(seed, n, m):
    """One sample: (rot (1, n, 3, 3), pred_t (1, n, 3), model, target
    (1, m, 3)), the distribution of tests/test_pallas_addloss.py."""
    rng = np.random.default_rng(seed)
    quat = torch.from_numpy(rng.normal(size=(1, n, 4)).astype(np.float32))
    pred_t = (rng.normal(size=(1, n, 3)) * 0.1
              + rng.normal(size=(1, n, 3)) * 0.01).astype(np.float32)
    model = (rng.normal(size=(1, m, 3)) * 0.05).astype(np.float32)
    rot = T.quat_to_mat(torch.from_numpy(
        rng.normal(size=4).astype(np.float32))).numpy()
    target = (model @ rot.T + [0.01, 0.0, 0.02]).astype(np.float32)
    return (T.quat_to_mat(quat).contiguous(), torch.from_numpy(pred_t),
            torch.from_numpy(model), torch.from_numpy(target))


def degenerate_inputs(n=64, m=100, seed=0):
    """Wrap-padded duplicate targets on a sphere grown by 1 mm, candidates
    near the identity: every matched distance is ~1 mm."""
    rng = np.random.default_rng(seed)
    i = np.arange(m) + 0.5
    phi, theta = np.arccos(1 - 2 * i / m), np.pi * (1 + 5 ** 0.5) * i
    sphere = np.stack([np.sin(phi) * np.cos(theta),
                       np.sin(phi) * np.sin(theta), np.cos(phi)], 1) * 0.05
    rot = T.quat_to_mat(torch.from_numpy(rng.normal(size=4))).numpy()
    target = ((sphere @ rot.T) * (0.051 / 0.05))[np.arange(m) % (m - 17)]
    quat = np.tile([1.0, 0, 0, 0], (1, n, 1)) + rng.normal(size=(1, n, 4)) \
        * 1e-3
    pred_t = rng.normal(size=(1, n, 3)) * 1e-5
    return (T.quat_to_mat(torch.from_numpy(quat.astype(np.float32)))
            .contiguous(),
            *(torch.from_numpy(a.astype(np.float32))
              for a in (pred_t, sphere[None], target[None])))


def camera_depth_inputs(seed=10, n=1000, m=500):
    """One sample at the evaluation batches' 0.6 m camera depth:
    candidates scattered around the true pose, each translation a cloud
    point plus an offset, as in `pose_loss`."""
    rng = np.random.default_rng(seed)
    q_true = rng.normal(size=4)
    q_true /= np.linalg.norm(q_true)
    rot_true = T.quat_to_mat(torch.from_numpy(q_true)).numpy()
    model = rng.normal(size=(m, 3)) * 0.05
    target = model @ rot_true.T + [0.0, 0.0, 0.6]
    cloud = target[rng.integers(0, m, n)] + rng.normal(size=(n, 3)) * 2e-3
    quat = q_true + rng.normal(size=(n, 4)) * 0.1
    pred_t = cloud + rng.normal(size=(n, 3)) * 0.01
    return (T.quat_to_mat(torch.from_numpy(quat[None].astype(np.float32)))
            .contiguous(),
            *(torch.from_numpy(a[None].astype(np.float32))
              for a in (pred_t, model, target)))


def test_kernel_wrapper_rejects_cpu_tensors():
    """The wrapper launches for CUDA tensors or raises; it never falls back
    to the plain version."""
    args = moment_inputs(4, n=40, m=30)
    launches = addloss.moments_cuda.launches
    with pytest.raises(ValueError):
        addloss.moments_cuda(*args)
    assert addloss.moments_cuda.launches == launches


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for args in (moment_inputs(5, n=1000, m=500), degenerate_inputs()):
        rot, pred_t, model, target = [a.to(dev) for a in args]
        launches = addloss.moments_cuda.launches
        dis_k, var_k = addloss.moments(rot, pred_t, model, target)
        dis_p, var_p = addloss.moments_plain(rot, pred_t, model, target)
        torch.cuda.synchronize()
        assert addloss.moments_cuda.launches == launches + 1
        np.testing.assert_allclose(dis_k.cpu(), dis_p.cpu(), atol=1e-5)
        np.testing.assert_allclose(var_k.clamp(min=0).sqrt().cpu(),
                                   var_p.clamp(min=0).sqrt().cpu(), atol=1e-4)
    # at the camera depth, against the plain version on f64 copies
    rot, pred_t, model, target = [a.to(dev) for a in camera_depth_inputs()]
    dis_k, var_k = addloss.moments(rot, pred_t, model, target)
    dis_p, var_p = addloss.moments_plain(
        *(a.double() for a in (rot, pred_t, model, target)))
    torch.cuda.synchronize()
    np.testing.assert_allclose(dis_k.cpu(), dis_p.cpu(), atol=1e-5)
    np.testing.assert_allclose(var_k.clamp(min=0).sqrt().cpu(),
                               var_p.clamp(min=0).sqrt().cpu(), atol=1e-4)


def test_train_kernel_wrapper_rejects_cpu_tensors():
    args = moment_inputs(4, n=40, m=30)
    launches = addloss.moments_train_cuda.launches
    with pytest.raises(ValueError):
        addloss.moments_train_cuda(*args, bf16=True)
    assert addloss.moments_train_cuda.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_train_kernel_matches_plain_on_card(bf16):
    """dis within 1e-5, std within 1e-4; the precursors within 1e-5 except
    for at most 0.1 % of candidates (at least one), where a near-tie flips
    a match and moves one u_i / M, so within 4 / M everywhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for args in (moment_inputs(5, n=1000, m=500), degenerate_inputs()):
        rot, pred_t, model, target = [a.to(dev) for a in args]
        m = model.shape[1]
        launches = addloss.moments_train_cuda.launches
        got = addloss.moments_train(rot, pred_t, model, target, bf16)
        want = addloss.moments_train_plain(rot, pred_t, model, target, bf16)
        torch.cuda.synchronize()
        assert addloss.moments_train_cuda.launches == launches + 1
        got, want = got.cpu().numpy()[0], want.cpu().numpy()[0]
        assert not got[:, 26:].any()
        np.testing.assert_allclose(got[:, 24], want[:, 24], atol=1e-5)
        np.testing.assert_allclose(np.sqrt(np.maximum(got[:, 25], 0)),
                                   np.sqrt(np.maximum(want[:, 25], 0)),
                                   atol=1e-4)
        off = np.abs(got[:, :24] - want[:, :24]).max(axis=1)
        assert off.max() <= 4.0 / m, off.max()
        assert (off > 1e-5).sum() <= max(1, len(off) // 1000), off


def nn_inputs(seed, n, m, invalid=0.1):
    """(query (n, 3), ref (m, 3), ref_valid (m,)) on a 40 mm ball, mm."""
    rng = np.random.default_rng(seed)

    def ball(k):
        v = rng.normal(size=(k, 3))
        v *= 40.0 / np.linalg.norm(v, axis=1, keepdims=True)
        return torch.from_numpy((v + [30.0, 10.0, 40.0]
                                 + rng.normal(size=(k, 3)) * 0.5
                                 ).astype(np.float32))

    return ball(n), ball(m), torch.from_numpy(rng.random(m) >= invalid)


def test_nn_wrapper_rejects_cpu_tensors():
    q, r, valid = nn_inputs(0, 64, 80)
    launches = knn.nn_cuda.launches
    with pytest.raises(ValueError):
        knn.nn_cuda(q, r, valid)
    assert knn.nn_cuda.launches == launches


def split_cases(dev, n=3000, m=3000):
    """Cases on the kernel's own reference ranges for an (n, m) call on
    `dev`: the reference before each range's start repeated at the start
    and queried there (exact ties across every boundary), and the ranges
    1, 2 and the last one wholly invalid."""
    q, r, _ = nn_inputs(2, n, m)
    splits = knn.nn_splits(n, m, dev)
    starts = torch.tensor([s * m // splits for s in range(1, splits)])
    tied = r.clone()
    tied[starts] = tied[starts - 1]
    near = tied[starts - 1] + torch.from_numpy(np.random.default_rng(3).normal(
        size=(len(starts), 3)).astype(np.float32)) * 1e-3
    valid = torch.ones(m, dtype=torch.bool)
    for s in (1, 2, splits - 1):
        valid[s * m // splits:(s + 1) * m // splits] = False
    return [(torch.cat([near, q[:n - len(starts)]]), tied, None),
            (q, r, valid)]


@pytest.mark.cuda
def test_nn_kernel_matches_plain_on_card():
    """The kernel rounds as the plain version does, so indices and d2 are
    equal; with every reference invalid both give index 0 and +inf; exact
    ties across the kernel's range boundaries go to the first index, and
    wholly invalid ranges never win."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    q, r, valid = nn_inputs(1, 4096, 4096)
    cases = [(q, r, valid), (q[:1000], r[:3000], None), (r, r, None),
             (q[:500], r[:700], torch.zeros(700, dtype=torch.bool)),
             (q[:900], torch.cat([r[:512], r[:512]]), None)] \
        + split_cases(dev)
    for q, r, valid in cases:
        args = [a.to(dev) if a is not None else None for a in (q, r, valid)]
        launches = knn.nn_cuda.launches
        idx_k, d2_k = knn.nn(*args)
        idx_p, d2_p = knn.nn_plain(*args)
        torch.cuda.synchronize()
        assert knn.nn_cuda.launches == launches + 1
        assert torch.equal(idx_k, idx_p)
        assert torch.equal(d2_k, d2_p)
