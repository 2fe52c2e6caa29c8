"""The two trainers data-parallel on n ranks, held against one rank.

Every rank runs `train/densefusion.py::train` and
`train/segmentation.py::segmentation_training` with `data_parallel="on"`
on the same batches (drawn from a seed), for `epochs` epochs; the trainers
split each global batch of 8 over the ranks. Rank 0 returns the
parameters, the best test distance / IoU, the logged curves and each
trainer's samples a second in its last epoch (the first one warms up).

Shapes: "product" trains DenseFusion at its full width (5 objects, bf16,
crop 320, N=1000, M=500, 6 batches of 8 an epoch) and the ResNet34 U-Net
(6 classes, f32, 256x256 crops, SGD, 6 batches of 8); "toy" shrinks both
for the CPU.

    python -m autoposeestimation_tpu_torch.parallel.trainers N [toy|product]
            [--repeat]
        spawns one rank and N ranks (`dryrun.run_ranks`; with --repeat
        one rank twice), compares them and prints one `trainers ...` JSON
        line;
    python -m torch.distributed.run --standalone --nproc-per-node=N \\
        -m autoposeestimation_tpu_torch.parallel.trainers N [toy|product] \\
        [--save FILE] [--against FILE]
        runs in torchrun's ranks; rank 0 saves its result to FILE, or
        compares it with a one-rank result saved before.

The comparison gives each trainer's largest parameter difference, the
relative difference of `best_test` and the absolute one of `best_iou`, and
the first epoch's logged loss and gradient norm."""
from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as pmesh
from .dryrun import run_ranks

SHAPES = {
    "toy": dict(num_obj=2, n=24, m=16, crop=24, pose_dtype=torch.float32,
                seg_classes=3, seg_hw=32, batches=2),
    "product": dict(num_obj=5, n=1000, m=500, crop=320,
                    pose_dtype=torch.bfloat16, seg_classes=6, seg_hw=256,
                    batches=6),
}
BATCH = 8


def pose_batches(num_obj: int, n: int, m: int, crop: int, count: int):
    """`count` training batches of 8 in the JAX Loader's layout."""
    out = []
    for seed in range(count):
        rng = np.random.default_rng(seed)
        out.append({
            "img": rng.normal(size=(BATCH, crop, crop, 3)).astype(np.float32),
            "cloud": (rng.normal(size=(BATCH, n, 3)) * 0.05).astype(
                np.float32),
            "choose": rng.integers(0, crop * crop, (BATCH, n)).astype(
                np.int32),
            "target": (rng.normal(size=(BATCH, m, 3)) * 0.05).astype(
                np.float32),
            "model_points": (rng.normal(size=(BATCH, m, 3)) * 0.05).astype(
                np.float32),
            "obj_idx": rng.integers(0, num_obj, BATCH).astype(np.int32),
            "is_sym": rng.integers(0, 2, BATCH).astype(bool)})
    return out


def seg_batches(classes: int, hw: int, count: int):
    rng = np.random.default_rng(100)
    return [{"image": rng.normal(size=(BATCH, hw, hw, 3)).astype(np.float32),
             "label": rng.integers(0, classes, (BATCH, hw, hw)).astype(
                 np.int32)} for _ in range(count)]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _leaves(tree[key], f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def _rate(curves: Dict[str, list], batches: int) -> float:
    """Samples a second in the last logged epoch."""
    return BATCH * batches / curves["epoch_seconds"][-1]


def exact_f32() -> None:
    """Full-precision f32 matmuls and convolutions, deterministic cuDNN
    algorithms: without them the f32 trainer's ranks differ by TF32's
    rounding (1e-3 in its parameters after 12 steps on an H100)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def run_trainers(shapes: str = "toy", epochs: int = 2,
                 device=None) -> Dict[str, Any]:
    """Both trainers with `data_parallel="on"` on this rank's group (one
    is started when none is up), under `exact_f32`. Returns rank 0's
    results."""
    from .. import weights
    from ..train import densefusion as dft
    from ..train import segmentation as seg
    from ..utils.device import resolve_device

    s = SHAPES[shapes]
    dev = resolve_device(device)
    exact_f32()
    mesh = pmesh.auto_mesh("on", device=dev)
    out: Dict[str, Any] = {"ranks": mesh.size, "backend": dist.get_backend(),
                           "shapes": shapes, "epochs": epochs}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dft.DFConfig(num_points=s["n"], num_points_mesh=s["m"],
                           batch_size=BATCH, data_parallel="on",
                           start_epoch=0)
        state = dft.create_trainer(s["num_obj"], cfg, dtype=s["pose_dtype"],
                                   device=dev)
        batches = pose_batches(s["num_obj"], s["n"], s["m"], s["crop"],
                               s["batches"])
        pose_dir = os.path.join(tmp, "pose")
        dft.train(state, lambda: iter(batches), lambda: iter(batches[:1]),
                  pose_dir, epochs=epochs, save_resume=False)
        if pmesh.is_writer(mesh):
            with open(os.path.join(pose_dir, "losses.json")) as f:
                curves = json.load(f)["curves"]
            out["pose"] = {"best_test": state.best_test, "curves": curves,
                           "lr": cfg.lr, "steps": epochs * s["batches"],
                           "samples_per_s": _rate(curves, s["batches"]),
                           "vars": _leaves(weights.posenet_variables(
                               state.posenet))}
        del state

        scfg = seg.SegConfig(classes=s["seg_classes"], epochs=epochs,
                             batch_size=BATCH, lr=1e-3, optimizer="sgd",
                             data_parallel="on")
        sbatches = seg_batches(s["seg_classes"], s["seg_hw"], s["batches"])
        trained = seg.segmentation_training(
            lambda: iter(sbatches), lambda: iter(sbatches[:1]), scfg,
            out_dir=os.path.join(tmp, "seg"), dtype=torch.float32,
            device=dev)
        if pmesh.is_writer(mesh):
            curves = trained["log"]["curves"]
            out["seg"] = {"best_iou": trained["best_iou"], "curves": curves,
                          "samples_per_s": _rate(curves, s["batches"]),
                          "vars": _leaves(trained["variables"])}
    return out


def compare(one: Dict[str, Any], many: Dict[str, Any]) -> Dict[str, Any]:
    """n ranks against one: per trainer the largest parameter difference,
    the leaves beyond 1e-4, the first epoch's logged loss (relative) and
    the samples a second of both; for DenseFusion also Adam's bound on the
    parameters (2 lr a step), the first epoch's gradient norm and
    `best_test` (relative), for segmentation `best_iou` (absolute)."""
    report = {}
    for name, loss in (("pose", "losses"), ("seg", "train_loss")):
        a, b = one[name], many[name]
        diffs = [float(np.abs(b["vars"][k] - v).max())
                 for k, v in a["vars"].items()]
        report[name] = {
            "max_param_diff": max(diffs),
            "leaves_beyond_1e-4": sum(d > 1e-4 for d in diffs),
            "leaves": len(diffs),
            "loss_rel": abs(b["curves"][loss][0] / a["curves"][loss][0] - 1),
            "samples_per_s": [a["samples_per_s"], b["samples_per_s"]]}
    a, b = one["pose"], many["pose"]
    report["pose"].update(
        adam_bound=2 * a["lr"] * a["steps"],
        grad_norm_rel=abs(b["curves"]["grad_norm_max"][0]
                          / a["curves"]["grad_norm_max"][0] - 1),
        best_test=[a["best_test"], b["best_test"]],
        best_test_rel=abs(b["best_test"] / a["best_test"] - 1))
    report["seg"]["best_iou_abs"] = abs(many["seg"]["best_iou"]
                                        - one["seg"]["best_iou"])
    report["ranks"] = [one["ranks"], many["ranks"]]
    return report


def _rank_body(shapes: str, epochs: int, device):
    return run_trainers(shapes, epochs, device)


def trainers_multichip(n_ranks: int, shapes: str = "toy", epochs: int = 2,
                       backend: Optional[str] = None,
                       timeout_s: float = 900.0,
                       workdir: Optional[str] = None,
                       repeat: bool = False) -> Dict[str, Any]:
    """Spawned: the trainers on one rank and on `n_ranks` ranks; the
    comparison (`compare`) and both results. With `repeat` one rank runs
    a second time, and "repeat" compares the two one-rank runs: the spread
    that the card's nondeterministic kernels leave (the PSPNet's adaptive
    pooling has no deterministic backward there)."""
    backend = backend or pmesh.default_backend()
    cpu = backend == "gloo"
    counts = (1, 1, n_ranks) if repeat else (1, n_ranks)
    results = [run_ranks(_rank_body, n, (shapes, epochs,
                                         "cpu" if cpu else None),
                         backend, timeout_s=timeout_s,
                         threads=1 if cpu else None,
                         workdir=workdir)[0] for n in counts]
    out = {"compare": compare(results[0], results[-1]), "one": results[0],
           "many": results[-1]}
    if repeat:
        out["repeat"] = compare(results[0], results[1])
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)

    def option(name):
        if name not in args:
            return None
        i = args.index(name)
        value = args[i + 1]
        del args[i:i + 2]
        return value

    save, against = option("--save"), option("--against")
    repeat = "--repeat" in args
    args = [a for a in args if a != "--repeat"]
    n, shapes = int(args[0]), (args[1] if len(args) > 1 else "toy")
    if "LOCAL_RANK" not in os.environ:
        out = trainers_multichip(n, shapes, repeat=repeat)
        print("trainers " + json.dumps(
            {k: out[k] for k in ("compare", "repeat") if k in out}),
            flush=True)
        return 0
    try:           # torchrun's ranks: the group from its environment
        result = run_trainers(shapes)
        rank = dist.get_rank()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        if save:
            torch.save(result, save)
        if against:
            one = torch.load(against, weights_only=False)
            print("trainers " + json.dumps(compare(one, result)), flush=True)
        else:
            print("trainers " + json.dumps(
                {name: {"samples_per_s": result[name]["samples_per_s"]}
                 for name in ("pose", "seg")} | {"ranks": result["ranks"]}),
                flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
