"""Import reference PyTorch checkpoints (upstream DenseFusion
state_dicts, as `torch.save` writes them) as the JAX package's flax
variable trees in numpy (port of `autoposeestimation_tpu/models/
torch_import.py`); `weights.py` turns a tree into the port's state_dict.

`warm_start_posenet` / `warm_start_refinenet` keep the trunk and draw the
final per-object head layers anew from `default_rng(0)` when the object
count differs from the checkpoint's, as the JAX functions do, so both
packages start from the same weights.

Layout conversions: torch Conv2d OIHW -> flax HWIO; Conv1d k=1 (O, I, 1)
and Linear (O, I) -> Dense (I, O); PReLU (1,) -> scalar negative_slope.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _np(state: Dict, name: str) -> np.ndarray:
    v = state[name]
    if hasattr(v, "numpy"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _conv2d(state: Dict, name: str) -> Dict:
    out = {"kernel": _np(state, name + ".weight").transpose(2, 3, 1, 0)}
    if name + ".bias" in state:
        out["bias"] = _np(state, name + ".bias")
    return out


def _dense_from_conv1d(state: Dict, name: str) -> Dict:
    w = _np(state, name + ".weight")[:, :, 0]  # (O, I)
    out = {"kernel": w.T}
    if name + ".bias" in state:
        out["bias"] = _np(state, name + ".bias")
    return out


def _dense_from_linear(state: Dict, name: str) -> Dict:
    out = {"kernel": _np(state, name + ".weight").T}
    if name + ".bias" in state:
        out["bias"] = _np(state, name + ".bias")
    return out


def _strip_prefix(state: Dict, prefixes=("module.",)) -> Dict:
    out = {}
    for k, v in state.items():
        for p in prefixes:
            k = k.replace(p, "")
        out[k] = v
    return out


def import_pspnet(state: Dict, prefix: str = "") -> Dict:
    """Map the reference PSPNet (lib/pspnet.py + lib/extractors.py resnet18)
    onto the flax PSPNet's params tree."""
    p = prefix
    # dilated BN-free resnet18: conv1 + 4 layers x 2 BasicBlocks
    resnet: Dict = {"Conv_0": _conv2d(state, p + "feats.conv1")}
    block_idx = 0
    for layer in range(1, 5):
        for b in range(2):
            name = f"{p}feats.layer{layer}.{b}"
            blk = {
                "Conv_0": _conv2d(state, name + ".conv1"),
                "Conv_1": _conv2d(state, name + ".conv2"),
            }
            if name + ".downsample.0.weight" in state:
                blk["Conv_2"] = _conv2d(state, name + ".downsample.0")
            resnet[f"BasicBlockPlain_{block_idx}"] = blk
            block_idx += 1

    psp = {f"Conv_{i}": _conv2d(state, f"{p}psp.stages.{i}.1")
           for i in range(4)}
    psp["Conv_4"] = _conv2d(state, p + "psp.bottleneck")

    def upsample(i):
        return {
            "Conv_0": _conv2d(state, f"{p}up_{i}.conv.1"),
            "PReLU_0": {"negative_slope": np.float32(
                _np(state, f"{p}up_{i}.conv.2.weight").reshape(()))},
        }

    return {
        "DilatedResNetNoBN_0": resnet,
        "PSPModule_0": psp,
        "PSPUpsample_0": upsample(1),
        "PSPUpsample_1": upsample(2),
        "PSPUpsample_2": upsample(3),
        "Conv_0": _conv2d(state, p + "final.0"),
    }


def import_posenet(state: Dict) -> Dict:
    """Reference PoseNet state_dict -> the flax PoseNet's {'params': ...}."""
    state = _strip_prefix(state)
    feat = {f"Dense_{i}": _dense_from_conv1d(state, f"feat.{n}")
            for i, n in enumerate(
                ["conv1", "e_conv1", "conv2", "e_conv2", "conv5", "conv6"])}

    def head(suffix):
        return {f"Dense_{i}": _dense_from_conv1d(state, f"conv{i + 1}_{suffix}")
                for i in range(4)}

    return {"params": {
        "PSPNet_0": import_pspnet(state, prefix="cnn.model."),
        "PoseNetFeat_0": feat,
        "PoseHead_0": head("r"),
        "PoseHead_1": head("t"),
        "PoseHead_2": head("c"),
    }}


def import_refinenet(state: Dict) -> Dict:
    """Reference PoseRefineNet state_dict -> the flax PoseRefineNet's variables."""
    state = _strip_prefix(state)
    feat = {f"Dense_{i}": _dense_from_conv1d(state, f"feat.{n}")
            for i, n in enumerate(
                ["conv1", "e_conv1", "conv2", "e_conv2", "conv5", "conv6"])}

    def head(suffix):
        return {f"Dense_{i}": _dense_from_linear(state, f"conv{i + 1}_{suffix}")
                for i in range(3)}

    return {"params": {
        "PoseRefineNetFeat_0": feat,
        "RefineHead_0": head("r"),
        "RefineHead_1": head("t"),
    }}


def warm_start_posenet(state: Dict, num_obj: int, rng=None) -> Dict:
    """Partial load with head re-init — the reference's upstream-YCB warm
    start (reference DenseFusion/tools/train.py:109-134): keep the
    trunk (PSPNet + fusion + head hidden layers), re-initialize the final
    per-object head layers when the object count differs from the source
    checkpoint's.

    Returns PoseNet variables for `num_obj` objects.
    """
    state = _strip_prefix(state)
    variables = import_posenet(state)
    rng = np.random.default_rng(0) if rng is None else rng
    src_num_obj = variables["params"]["PoseHead_0"]["Dense_3"][
        "kernel"].shape[1] // 4
    if src_num_obj == num_obj:
        return variables
    for head, dim in (("PoseHead_0", 4), ("PoseHead_1", 3), ("PoseHead_2", 1)):
        final = variables["params"][head]["Dense_3"]
        fan_in = final["kernel"].shape[0]
        scale = 1.0 / np.sqrt(fan_in)
        final["kernel"] = rng.uniform(
            -scale, scale, (fan_in, dim * num_obj)).astype(np.float32)
        final["bias"] = np.zeros(dim * num_obj, np.float32)
    return variables


def warm_start_refinenet(state: Dict, num_obj: int, rng=None) -> Dict:
    """Refiner warm start with final-head re-init — the reference re-inits
    conv3_r/conv3_t when loading upstream YCB refiner weights
    (reference DenseFusion/tools/train.py:126-132)."""
    state = _strip_prefix(state)
    variables = import_refinenet(state)
    rng = np.random.default_rng(0) if rng is None else rng
    src_num_obj = variables["params"]["RefineHead_0"]["Dense_2"][
        "kernel"].shape[1] // 4
    if src_num_obj == num_obj:
        return variables
    for head, dim in (("RefineHead_0", 4), ("RefineHead_1", 3)):
        final = variables["params"][head]["Dense_2"]
        fan_in = final["kernel"].shape[0]
        scale = 1.0 / np.sqrt(fan_in)
        final["kernel"] = rng.uniform(
            -scale, scale, (fan_in, dim * num_obj)).astype(np.float32)
        final["bias"] = np.zeros(dim * num_obj, np.float32)
    return variables


def load_pth(path: str) -> Dict:
    """Load a torch .pth state_dict as {name: np.ndarray} (on the CPU)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in state.items()}
