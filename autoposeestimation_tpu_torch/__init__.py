"""PyTorch/CUDA port of `autoposeestimation_tpu`.

The JAX package stays the reference; this package mirrors its module paths
and holds each module to its counterpart in `tests/test_torch_*.py`. It
imports neither JAX nor anything of the JAX package.

  main.py          the App: the menu and every action, from a scan to a grasp
  config.py        the typed configuration of a workspace
  acquisition/     the robot scan loop, viewpoint paths, maintenance
  hardware/        cameras, robots, hand-eye calibration
  labeling/        background-subtraction labels, datasets, pose labels
  reconstruction/  the object clouds (Phase B)
  data/            the pose, segmentation, background-subtraction and
                   YCB-Video / LineMOD datasets, augmentations, the Loader
  models/          U-Net and its variants, PoseNet, the refiner, losses
  ops/             the geometric ops and the kernels' wrappers
  train/           DenseFusion and segmentation training, checkpoints
  pipeline/        serving, grasping, overlays, the terminal prompts
  experiments/     ADD(-S) evaluation (also YCB-Video, LineMOD), gt_test,
                   sweeps
  utils/           the on-disk contract, PNG codec, transforms, synthetic data
  weights.py       the bridge between flax variable trees and state_dicts

Entry points run on `cuda` unless the caller passes `device="cpu"`
(`utils.device.resolve_device`). Hand-written CUDA kernels live in `csrc/`
and are built at first use into `build/kernels/` at the repository root.
"""
