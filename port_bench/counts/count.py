"""Count FLOPs on the reference networks, on the meta device (shapes
only).

    python port_bench/counts/count.py
    python port_bench/counts/count.py --config <c> --kind <k> --traffic <t>

The first counts again the frame and the two DenseFusion steps of each
configuration that `flops.json` holds, and writes `flops.json`. The second
counts one kind of unit of one configuration by `kinds/<k>.py::flops(cfg,
traffic)` under the traffic mix `<t>`, at the sizes that the module's
`at(cfg, traffic)` names, and writes `<c>/<k>.json`: {"flops", "rule",
"at": those sizes}. A new kind
or a new configuration comes as new files; `flops.json` is not rewritten
for it. The kinds of `flops.json`:

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

import argparse
import importlib
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


RULE = ("FlopCounterMode, convolutions by their taps inside the input, "
        "forward and backward; the symmetric moments by XLA's closed forms "
        "(counts/rules.py)")


def _read(*parts) -> dict:
    with open(os.path.join(os.path.dirname(HERE), *parts)) as f:
        return json.load(f)


def count_kind(config: str, kind: str, traffic: str) -> dict:
    """{"flops", "rule", "at"} of `kind` for `config` under `traffic`."""
    cfg = _read("configs", config + ".json")
    mix = _read("traffic", traffic + ".json")
    mod = importlib.import_module(f"counts.kinds.{kind}")
    return {"flops": int(mod.flops(cfg, mix)), "rule": RULE,
            "at": {"traffic": traffic, **mod.at(cfg, mix)}}


def _write(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")
    print(json.dumps(obj, indent=1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config")
    ap.add_argument("--kind")
    ap.add_argument("--traffic")
    args = ap.parse_args(argv)
    given = [args.config, args.kind, args.traffic]
    if any(given):
        if not all(given):
            ap.error("--config, --kind and --traffic go together")
        os.makedirs(os.path.join(HERE, args.config), exist_ok=True)
        _write(os.path.join(HERE, args.config, args.kind + ".json"),
               count_kind(args.config, args.kind, args.traffic))
        return
    path = os.path.join(HERE, "flops.json")
    with open(path) as f:
        names = [k for k in json.load(f) if k != "rule"]
    table = {name: count(_read("configs", name + ".json"))
             for name in names}
    table["rule"] = RULE
    _write(path, table)


if __name__ == "__main__":
    main()
