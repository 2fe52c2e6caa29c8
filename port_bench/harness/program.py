"""The measured package's objects, made by its own builders
(`pipeline/predict.py::build_models`, `train/densefusion.py::
create_trainer`) with the seed's weights in them. `build_models` takes
weights as flax variable trees on the host, so the seed's state dicts go
through the package's `weights.to_variables`; `create_trainer` takes none,
so it draws its own (on the host) and the seed's are loaded over them."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def prediction_models(cfg: Dict, states: Dict[str, Dict],
                      model_points: np.ndarray, device):
    """`build_models` at the configuration's settings, with the given
    weights; the classes are named obj0..obj{K-1}."""
    from autoposeestimation_tpu_torch import weights as PW
    from autoposeestimation_tpu_torch.pipeline import predict

    k = cfg["num_objects"]
    return predict.build_models(
        k, model_points, [f"obj{i}" for i in range(k)],
        seg_vars=PW.to_variables(states["unet"], PW.unet_plan(
            tuple(cfg["unet_encoder_stages"]))),
        pose_vars=PW.to_variables(states["posenet"], PW.posenet_plan()),
        refine_vars=PW.to_variables(states["refiner"], PW.refiner_plan()),
        num_points=cfg["num_points"], crop=cfg["crop"],
        refine_iters=cfg["refine_iters"], dtype=DTYPES[cfg["dtype"]],
        cca_scale=cfg["cca_scale"], cca_sweeps=cfg["cca_sweeps"],
        emb_stride=cfg["emb_stride"], seg_out_stride=cfg["seg_out_stride"],
        device=device)


def trainer(cfg: Dict, states: Dict[str, Dict], device):
    """`create_trainer` at the configuration's settings with the given
    weights, moved into the refine phase by its own phase machine, so that
    both networks have their `ClippedAdam`."""
    from autoposeestimation_tpu_torch.train import densefusion as dft

    t = cfg["train"]
    dcfg = dft.DFConfig(
        batch_size=t["batch_size"], lr=t["lr"], w=t["w"],
        iteration=t["iteration"], nepoch=t["nepoch"],
        refine_epoch_margin=t["refine_epoch_margin"],
        num_points=cfg["num_points"], num_points_mesh=cfg["num_points_mesh"],
        with_sym=t["with_sym"], sym_bf16=t["sym_bf16"],
        grad_clip=t["grad_clip"], data_parallel="off")
    state = dft.create_trainer(cfg["num_objects"], dcfg,
                               dtype=DTYPES[cfg["dtype"]], device=device)
    if state.posenet.emb_stride != t["emb_stride"]:
        raise ValueError(f"create_trainer's PoseNet has emb_stride "
                         f"{state.posenet.emb_stride}, the configuration "
                         f"trains at {t['emb_stride']}")
    state.posenet.load_state_dict(states["posenet"])
    state.refiner.load_state_dict(states["refiner"])
    state.maybe_transition(dcfg.refine_epoch_margin)
    return state
