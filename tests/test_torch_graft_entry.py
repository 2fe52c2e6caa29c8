"""The port's `graft_entry.entry()` against the JAX package's entry
(`__graft_entry__.py::entry`) on the CPU.

- The graph: the JAX single-frame graph `_full_prediction_jit` built by
  `predict.build_models(..., dtype=jnp.float32)` at the entry's settings
  (2 classes, 500 points, crop 160, 2 refine iterations), with numpy-drawn
  flax variables carried into the port, and the port's `fn` in f32 on the
  same frame with JAX's draws of `PRNGKey(0)` split per class as
  `uniforms`. The frame is 240x320 (640x480 costs a JAX compile of the
  ResNet34 U-Net at four times the pixels); the entry's inputs are drawn as
  at 640x480. Masks, found, argmax and cca_converged exactly; poses within
  `test_torch_pipeline.py`'s 1e-4.
- The inputs: `entry()`'s example arguments at 640x480 against the JAX
  entry's (its frame, depth and model points drawn from `default_rng(0)` in
  its order; intrinsics and depth scale), the draws' shape, and the
  networks' weights as flax trees of the JAX entry's shapes.
- Without a card `entry()` raises: no fallback to the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoposeestimation_tpu.models import densefusion as jdf
from autoposeestimation_tpu.models import unet as junet
from autoposeestimation_tpu.pipeline import predict as jpredict
from autoposeestimation_tpu_torch import graft_entry, weights
from autoposeestimation_tpu_torch.parallel import dryrun
from test_torch_models import init_vars
from test_torch_pipeline import ATOL
from test_torch_seg_models import two_threads  # noqa: F401

K, N, CROP = graft_entry.NUM_CLASSES, graft_entry.NUM_POINTS, graft_entry.CROP
HW = (240, 320)
EXACT = ("found", "masks", "argmax", "cca_converged", "masks_packed")


def jax_variables():
    """Numpy-drawn flax trees of the JAX entry's three networks. Their
    shapes do not depend on the frame, the crop or the point count, so
    small dummy inputs trace them."""
    n, crop = 16, 32
    seg = init_vars(junet.UNet(classes=K + 1, dtype=jnp.float32),
                    np.zeros((1, 64, 64, 3), np.float32), seed=1)
    pose = init_vars(jdf.PoseNet(num_obj=K, dtype=jnp.float32),
                     np.zeros((K, crop, crop, 3), np.float32),
                     np.zeros((K, n, 3), np.float32),
                     np.zeros((K, n), np.int32), np.zeros(K, np.int32),
                     seed=2)
    refine = init_vars(jdf.PoseRefineNet(num_obj=K, dtype=jnp.float32),
                       np.zeros((K, n, 3), np.float32),
                       np.zeros((K, n, 32), np.float32),
                       np.zeros(K, np.int32), seed=3)
    return seg, pose, refine


def jax_entry_inputs(hw):
    """The JAX entry's draws from `default_rng(0)` (__graft_entry__.py)."""
    rng = np.random.default_rng(0)
    model_points = rng.normal(size=(K, 100, 3)).astype(np.float32) * 0.05
    image = np.asarray(jnp.asarray(rng.integers(0, 255, hw + (3,)),
                                   jnp.uint8))
    depth = np.asarray(jnp.asarray(rng.uniform(400, 900, hw), jnp.float32))
    return model_points, image, depth


def leaf_shapes(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in leaf_shapes(tree[key], prefix + (key,)).items()}
    return {prefix: tuple(np.shape(tree))}


def test_entry_graph_matches_jax_in_f32():
    seg, pose, refine = jax_variables()
    fn, args = graft_entry._entry("cpu", torch.float32, hw=HW, seg_vars=seg,
                                  pose_vars=pose, refine_vars=refine)
    models, image, depth, intr, scale, _ = args
    model_points, jimage, jdepth = jax_entry_inputs(HW)
    np.testing.assert_array_equal(image.numpy(), jimage)
    np.testing.assert_array_equal(depth.numpy(), jdepth)
    jm = jpredict.build_models(
        K, model_points, graft_entry.CLASSES, seg_vars=seg, pose_vars=pose,
        refine_vars=refine, num_points=N, crop=CROP,
        refine_iters=graft_entry.REFINE_ITERS, dtype=jnp.float32,
        img_hw=HW)
    key = jax.random.PRNGKey(0)
    want = jpredict._full_prediction_jit(
        jm.seg_vars, jm.pose_vars, jm.refine_vars, jnp.asarray(jimage),
        jnp.asarray(jdepth), jnp.asarray(intr.numpy()),
        jnp.float32(graft_entry.DEPTH_SCALE), key, jpredict.static_tuple(jm))
    u = np.stack([np.asarray(jax.random.uniform(k, (N,)))
                  for k in jax.random.split(key, K)])
    got = fn(*args[:5], torch.from_numpy(u))
    assert set(got) == set(want)
    for name in EXACT:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    for name in ("quats", "positions"):
        assert np.isfinite(np.asarray(want[name])).all()
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=ATOL, err_msg=name)
    err = max(np.abs(got[n].numpy() - np.asarray(want[n])).max()
              for n in ("quats", "positions"))
    print(f"entry graph at {HW}: found {np.asarray(want['found']).tolist()},"
          f" mask pixels {np.asarray(want['masks']).sum(axis=(1, 2))}, "
          f"largest pose difference {err:.3e}")


def test_entry_inputs_match_the_jax_entry():
    fn, args = graft_entry.entry(device="cpu")
    assert fn is graft_entry.forward
    models, image, depth, intr, scale, uniforms = args
    model_points, jimage, jdepth = jax_entry_inputs(graft_entry.FRAME_HW)
    assert image.dtype == torch.uint8 and image.shape == (480, 640, 3)
    np.testing.assert_array_equal(image.numpy(), jimage)
    assert depth.dtype == torch.float32 and depth.shape == (480, 640)
    np.testing.assert_array_equal(depth.numpy(), jdepth)
    assert intr.dtype == torch.float32
    np.testing.assert_array_equal(intr.numpy(), [600.0, 600.0, 320.0, 240.0])
    assert scale.dtype == torch.float32 and scale.shape == ()
    assert scale.item() == np.float32(0.001)
    # the key's counterpart: a (K, N) draw from a generator seeded 0
    assert uniforms.dtype == torch.float32 and uniforms.shape == (K, N)
    assert torch.equal(uniforms, torch.rand(
        (K, N), generator=torch.Generator().manual_seed(0)))
    np.testing.assert_array_equal(models.model_points.numpy(), model_points)
    assert (models.num_points, models.crop, models.refine_iters,
            models.classes) == (N, CROP, 2, graft_entry.CLASSES)
    assert models.device == torch.device("cpu")
    # the networks hold the JAX entry's variable trees, leaf for leaf
    for got, want in zip(
            (weights.unet_variables(models.seg_model),
             weights.posenet_variables(models.posenet),
             weights.refiner_variables(models.refiner)),
            jax_variables()):
        assert leaf_shapes(got) == leaf_shapes(want)
    assert models.seg_model.encoder.conv1.compute_dtype == torch.bfloat16


def test_entry_defaults_to_cuda_and_reexports_the_dry_run():
    assert graft_entry.dryrun_multichip is dryrun.dryrun_multichip
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
