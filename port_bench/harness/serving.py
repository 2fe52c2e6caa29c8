"""What the two serving entries share: the frame pool and its draws, the
program's models, a sample of served frames drawn from the seed, the
window's metrics, and the check of that sample against the plain
reference once the program is gone."""
from __future__ import annotations

import random
import statistics
import sys
from typing import Dict, List

import numpy as np
import torch

from harness import program
from harness import weights as W
from harness.stats import percentile, rate
from reference import nets as R
from reference.serve import Frame, FrameJudge
from traffic import scene


class Reservoir:
    """A uniform sample of `size` of the served frames, drawn from the seed
    whatever their number (Algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng = size, random.Random(seed)
        self.items: List = []
        self.seen = 0

    def offer(self, index: int, result) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append((index, result))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = (index, result)


class Pool:
    """The cell's frames, draws and model points, from the seed."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        k, hw = cfg["num_objects"], tuple(cfg["image_hw"])
        self.count = traffic["pool"]
        frames = scene.frame_pool(traffic["layout"], hw, self.count, seed,
                                  device)
        self.images, self.depths = frames["images"], frames["depths"]
        self.intr, self.depth_scale = frames["intr"], frames["depth_scale"]
        fx, fy, ppx, ppy = (float(v) for v in self.intr)
        self.meta = {"intr": {"fx": fx, "fy": fy, "ppx": ppx, "ppy": ppy},
                     "depth_scale": self.depth_scale}
        self.draws = scene.point_draws(self.count, k, cfg["num_points"],
                                       seed)
        self.model_points = scene.model_points(k, cfg["num_points_mesh"],
                                               seed)

    def frame(self, i: int, device) -> Frame:
        i %= self.count
        return Frame(image=torch.as_tensor(self.images[i], device=device),
                     depth=torch.as_tensor(self.depths[i].astype(np.float32),
                                           device=device),
                     intr=torch.as_tensor(self.intr, device=device),
                     depth_scale=torch.tensor(self.depth_scale,
                                              device=device),
                     uniforms=torch.as_tensor(self.draws[i], device=device))


def served_arrays(result: Dict, k: int, hw) -> Dict[str, torch.Tensor]:
    """A `full_prediction`-form result -> found (K,), masks (K, H, W),
    quats (K, 4), positions (K, 3), converged (K,) (the program's word that
    a class's component labels converged); classes are named
    obj0..obj{K-1}."""
    found = torch.zeros(k, dtype=torch.bool)
    converged = torch.zeros(k, dtype=torch.bool)
    for cls, flag in result["cca_converged"].items():
        converged[int(cls[3:])] = bool(flag)
    masks = torch.zeros((k,) + tuple(hw), dtype=torch.bool)
    quats, pos = torch.zeros(k, 4), torch.zeros(k, 3)
    for cls, p in result["predictions"].items():
        i = int(cls[3:])
        found[i] = True
        masks[i] = torch.as_tensor(np.asarray(p["mask"]) > 0)
        quats[i] = torch.as_tensor(np.asarray(p["rotation"], np.float32))
        pos[i] = torch.as_tensor(np.asarray(p["position"], np.float32))
    return {"found": found, "masks": masks, "quats": quats,
            "positions": pos, "converged": converged}


def reference_judge(cfg: Dict, seed: int, model_points: np.ndarray,
                    device, tie: float) -> FrameJudge:
    """The float32 reference networks with the seed's weights."""
    R.exact_f32()
    states = W.seeded_states(cfg, seed, device)
    nets = W.reference_nets(cfg, device)
    for name, net in nets.items():
        net.load_state_dict(states[name])
        net.eval()
    return FrameJudge((nets["unet"], nets["posenet"], nets["refiner"]),
                      torch.as_tensor(model_points, device=device), cfg, tie)


def tie_margin(limits: Dict) -> float:
    """Logits this close may fall either way under rounding: the cell's
    limit of seg_gap."""
    return limits["seg_gap"]["limit"]


def check(cfg: Dict, seed: int, pool: Pool, sample: List, device,
          tie: float) -> Dict[str, float]:
    """The widest reading of each number over the sampled frames."""
    judge = reference_judge(cfg, seed, pool.model_points, device, tie)
    worst: Dict[str, float] = {}
    for index, result in sample:
        served = served_arrays(result, cfg["num_objects"], cfg["image_hw"])
        for name, value in judge.judge(pool.frame(index, device),
                                       served).items():
            worst[name] = max(worst.get(name, 0.0), value)
    print(bounds_summary(judge.bounds), file=sys.stderr)
    return worst


def bounds_summary(bounds: List) -> str:
    """How tightly the reference pins the found set and the masses."""
    lo = torch.cat([b[0] for b in bounds])
    hi = torch.cat([b[1] for b in bounds])
    converged = torch.cat([b[2] for b in bounds])
    sure = lo > 0
    ratio = (hi[sure] / lo[sure]).tolist() or [float("nan")]
    return (f"mass bounds: {int(sure.sum())} of {lo.numel()} lanes found "
            f"either way, {int((hi == 0).sum())} absent either way, "
            f"{int((sure & converged).sum())} held to the least (labels "
            f"converged); most / least mass median "
            f"{statistics.median(ratio):.4f}, largest {max(ratio):.4f}")


class ServingDriver:
    """Set-up of a serving entry; subclasses add the loop."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = (cfg, traffic, seed,
                                                          device)
        self.pool = Pool(cfg, traffic, seed, device)
        self.models = program.prediction_models(
            cfg, W.seeded_states(cfg, seed, device), self.pool.model_points,
            device)
        self.sample = Reservoir(traffic["check_frames"], seed)
        self.next = 0

    def end_to_end(self, w: Dict) -> Dict[str, float]:
        return {"frames_per_s": rate(w["units"], w["seconds"]),
                "frame_p95_ms": percentile(w["latencies"], 95) * 1e3}

    def release(self) -> None:
        self.models = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, limits: Dict) -> Dict[str, float]:
        return check(self.cfg, self.seed, self.pool, self.sample.items,
                     self.device, tie_margin(limits))
