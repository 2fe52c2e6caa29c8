"""Count the FLOPs of a configuration's frame and training steps on the
reference networks, on the meta device (shapes only), and write them to
`flops.json`:

    python port_bench/counts/count.py

frame      the U-Net over one frame, the PoseNet over the K class lanes and
           the refiner passes over them (every lane runs, found or not, so
           the count is a constant of the configuration);
estimator  a training step: the PoseNet forward and backward over a batch,
           the estimator loss's dense distances and the symmetric moments'
           forward and backward over the whole batch (the kernel runs on
           every sample);
refiner    a refiner step: the PoseNet forward, the estimator loss forward
           with the moments' forward, and the refiner passes forward and
           backward with their losses."""
from __future__ import annotations

import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from counts import rules  # noqa: E402
from reference import nets as R  # noqa: E402
from reference import pose as P  # noqa: E402

META = torch.device("meta")


def frame_flops(cfg) -> int:
    k, (h, w) = cfg["num_objects"], cfg["image_hw"]
    n, crop = cfg["num_points"], cfg["crop"]
    with torch.device(META):
        unet, posenet = R.UNet(k + 1), R.PoseNet(k, cfg["emb_stride"])
        refiner = R.PoseRefineNet(k)
        img = torch.empty(1, 3, h, w)
        crops = torch.empty(k, 3, crop, crop)
        cloud = torch.empty(k, n, 3)
        choose = torch.zeros(k, n, dtype=torch.int64)
        obj = torch.zeros(k, dtype=torch.int64)
        with torch.no_grad(), rules.counting() as mode:
            unet(img)
            _, _, _, emb = posenet(crops, cloud, choose, obj)
            for _ in range(cfg["refine_iters"]):
                refiner(cloud, emb, obj)
    return int(mode.get_total_flops())


def _batch(cfg):
    t = cfg["train"]
    b, n, m, crop = t["batch_size"], cfg["num_points"], \
        cfg["num_points_mesh"], cfg["crop"]
    return {"img": torch.empty(b, 3, crop, crop),
            "cloud": torch.empty(b, n, 3),
            "choose": torch.zeros(b, n, dtype=torch.int64),
            "target": torch.empty(b, m, 3),
            "model_points": torch.empty(b, m, 3),
            "obj_idx": torch.zeros(b, dtype=torch.int64),
            "is_sym": torch.zeros(b, dtype=torch.bool)}


def _dense_loss_flops(b, n, m) -> int:
    """The estimator loss's dense candidate transform, the einsum
    (B, M, 3) x (B, N, 3, 3), as the counter counts it."""
    return 2 * b * n * m * 3 * 3


def step_flops(cfg):
    t = cfg["train"]
    k = cfg["num_objects"]
    b, n, m = t["batch_size"], cfg["num_points"], cfg["num_points_mesh"]
    with torch.device(META):
        posenet = R.PoseNet(k, t["emb_stride"])
        refiner = R.PoseRefineNet(k)
        batch = _batch(cfg)
        with rules.counting() as mode:
            out = posenet(batch["img"], batch["cloud"], batch["choose"],
                          batch["obj_idx"])
            loss = sum(o.sum() for o in out[:3])
            loss.backward()
        est = (int(mode.get_total_flops()) + 3 * _dense_loss_flops(b, n, m)
               + rules.moments_flops(b, n, m)
               + rules.moments_grad_flops(b, n, m))
        emb = torch.empty(b, n, 32)
        with rules.counting() as mode:
            with torch.no_grad():
                posenet(batch["img"], batch["cloud"], batch["choose"],
                        batch["obj_idx"])
            pts = batch["cloud"]
            total = 0.0
            for _ in range(t["iteration"]):
                dr, dt = refiner(pts, emb, batch["obj_idx"])
                mean_dis, _, pts, _ = P.refine_loss(
                    dr, dt, batch["target"], batch["model_points"], pts,
                    batch["is_sym"])
                total = total + mean_dis
            total.backward()
        ref = (int(mode.get_total_flops()) + _dense_loss_flops(b, n, m)
               + rules.moments_flops(b, n, m))
    return est, ref


def count(cfg) -> dict:
    est, ref = step_flops(cfg)
    return {"frame": frame_flops(cfg), "estimator_step": est,
            "refiner_step": ref}


def main() -> None:
    table = {}
    configs = os.path.join(os.path.dirname(HERE), "configs")
    for fname in sorted(os.listdir(configs)):
        with open(os.path.join(configs, fname)) as f:
            cfg = json.load(f)
        table[fname[:-5]] = count(cfg)
    table["rule"] = ("FlopCounterMode, convolutions by their taps inside the "
                     "input, forward and backward; the symmetric moments by "
                     "XLA's closed forms (counts/rules.py)")
    with open(os.path.join(HERE, "flops.json"), "w") as f:
        json.dump(table, f, indent=1)
        f.write("\n")
    print(json.dumps(table, indent=1))


if __name__ == "__main__":
    main()
