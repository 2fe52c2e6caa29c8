"""bf16 serving, batch 4 against four single frames, in both packages on
the CPU: the port's `_predict_batch` against `_predict_frame` and the JAX
package's `_full_prediction_batched_jit` against `_full_prediction_jit`,
with the same weights (`test_torch_pipeline.py`'s numpy-drawn flax trees,
carried by `weights.py`) and the same draws (frame i's lanes from
`split(split(key, 4)[i], 2)`, as `test_torch_serving.py` draws them), at
96x128, 2 classes, crop 64, 64 points.

Measured here: the JAX package's batched graph gives other argmax pixels
than its single-frame graph (0.03 % of them), other mask pixels (0.015 %)
and poses up to 5.2 cm apart (the bf16 rounding moves the PoseNet's
confidence argmax to another candidate); the port's gives the same argmax
and masks and poses within 3e-7 m. So on the CPU the port is at least as
batch-invariant as the reference. On the card the port's bf16 graph
differs by batch too (cuDNN and cuBLAS pick other algorithms by batch;
`chip_smoke.py` phase 11 measures it with trained weights).

Gates: the port's share of differing argmax pixels, and of differing mask
pixels, at most the JAX package's plus BATCH_MARGIN, and its largest
position move at most JAX's plus MOVE_MARGIN; `found` equal between the
port's modes; the port's batched argmax equal to the JAX package's
batched argmax on all but PACKAGE_SHARE of the pixels (bf16 rounds
differently in XLA and in PyTorch: 0.06 % measured)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoposeestimation_tpu.pipeline import predict as jpredict
from autoposeestimation_tpu_torch.pipeline import predict
from test_torch_pipeline import K, NPT, variables  # noqa: F401
from test_torch_seg_models import two_threads  # noqa: F401
from test_torch_serving import lane_draws, stream_frames

CROP = 64
B = 4
BATCH_MARGIN = 1e-3      # of the pixels
MOVE_MARGIN = 1e-3       # m
PACKAGE_SHARE = 1e-2     # of the pixels


@pytest.fixture(scope="module")
def runs(variables):  # noqa: F811
    seg, pose, refine = variables
    mp = np.random.default_rng(0).normal(size=(K, 60, 3)).astype(
        np.float32) * 0.05
    kw = dict(num_points=NPT, crop=CROP, refine_iters=2, emb_stride=8,
              seg_vars=seg, pose_vars=pose, refine_vars=refine)
    frames = stream_frames(B)
    images = np.stack([f[0] for f in frames])
    depths = np.stack([f[1] for f in frames])
    intr = frames[0][2]["intr"].as_array()
    h, w = depths.shape[1:]
    key = jax.random.PRNGKey(42)
    keys = jax.random.split(key, B)
    u = np.stack([lane_draws(k) for k in keys])

    jm = jpredict.build_models(K, mp, ("mug", "box"), dtype=jnp.bfloat16,
                               img_hw=(h, w), **kw)
    args = (jm.seg_vars, jm.pose_vars, jm.refine_vars)
    static = jpredict.static_tuple(jm)
    jax_batch = jpredict._full_prediction_batched_jit(
        *args, jnp.asarray(images), jnp.asarray(depths), jnp.asarray(intr),
        jnp.float32(0.001), key, static)
    jax_single = [jpredict._full_prediction_jit(
        *args, jnp.asarray(images[i]), jnp.asarray(depths[i]),
        jnp.asarray(intr), jnp.float32(0.001), keys[i], static)
        for i in range(B)]

    tm = predict.build_models(K, mp, ("mug", "box"), dtype=torch.bfloat16,
                              device="cpu", **kw)
    with torch.inference_mode():
        port_batch = predict._predict_batch(
            tm, torch.from_numpy(images), torch.from_numpy(depths),
            torch.from_numpy(intr), torch.tensor(0.001), torch.from_numpy(u))
        port_single = [predict._predict_frame(
            tm, torch.from_numpy(images[i]), torch.from_numpy(depths[i]),
            torch.from_numpy(intr), torch.tensor(0.001),
            torch.from_numpy(u[i])) for i in range(B)]

    def host(out):
        return {k: np.asarray(v) for k, v in out.items()}

    def stacked(outs):
        return {k: np.stack([host(o)[k] for o in outs]) for k in outs[0]}

    return {"jax": (host(jax_batch), stacked(jax_single)),
            "port": (host(port_batch), stacked(port_single))}


def share(a, b):
    return float(np.mean(a != b))


def test_batch_invariance_no_worse_than_jax(runs):
    shares = {pkg: {name: share(batch[name], single[name])
                    for name in ("argmax", "masks", "found")}
              for pkg, (batch, single) in runs.items()}
    moves = {pkg: float(np.abs(batch["positions"].astype(np.float32)
                               - single["positions"]).max())
             for pkg, (batch, single) in runs.items()}
    print(f"bf16 batch {B} against single frames, share of differing "
          f"entries: {shares}; largest position move (m): {moves}")
    for name in ("argmax", "masks"):
        assert shares["port"][name] <= shares["jax"][name] + BATCH_MARGIN
    assert moves["port"] <= moves["jax"] + MOVE_MARGIN
    assert shares["port"]["found"] == 0.0
    batch, single = runs["port"]
    assert batch["found"].any()
    np.testing.assert_array_equal(batch["found"], single["found"])


def test_batched_argmax_against_jax(runs):
    (jax_batch, jax_single), (port_batch, port_single) = (runs["jax"],
                                                          runs["port"])
    batched = share(port_batch["argmax"], jax_batch["argmax"])
    single = share(port_single["argmax"], jax_single["argmax"])
    print(f"bf16 argmax, port against JAX: batched {batched}, single frames "
          f"{single}")
    assert batched <= PACKAGE_SHARE and single <= PACKAGE_SHARE
    np.testing.assert_array_equal(port_batch["found"], jax_batch["found"])
