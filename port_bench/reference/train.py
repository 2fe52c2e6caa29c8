"""Training steps in plain float32, and their comparison with the
program's: from the seed's weights and fresh optimizers (the first steps),
or from a state the program held (steps of the measured window).

An estimator step: PoseNet forward with dropout (masks drawn in the same
order from a generator seeded alike), the estimator loss, gradients, the
clipped Adam update. A refiner step: the estimator's forward without
dropout, `iteration` refiner passes whose mean distances are summed, the
clipped Adam update of the refiner. Each optimizer's first gradient, as
its clip hands it to Adam, and every parameter after the steps are kept
for the comparison."""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from .pose import ClippedAdam, leaf_grads, pose_loss, refine_loss


class Readings(dict):
    """kinds [per step], losses [per step], first_grad {network/leaf:
    tensor}, params {network/leaf: tensor after the steps}, start
    {network/leaf: tensor before}."""


def run_steps(posenet, refiner, batches: List[Dict[str, torch.Tensor]],
              kinds: List[str], generator: torch.Generator, cfg: Dict,
              adam: Dict = None) -> Readings:
    """The steps `kinds` ('estimator' / 'refiner') on `batches`, in order,
    from the networks' present parameters, which they update in place.
    `adam` {'posenet' / 'refiner': (t, m, v)} is each optimizer's state to
    start from (a fresh one where None). The first gradient kept is each
    network's first in these steps."""
    pose_p = dict(posenet.named_parameters())
    ref_p = dict(refiner.named_parameters())
    start = {f"posenet/{k}": p.detach().clone() for k, p in pose_p.items()}
    start.update({f"refiner/{k}": p.detach().clone()
                  for k, p in ref_p.items()})
    adam = adam or {}
    opts = {name: ClippedAdam(params, cfg["lr"], cfg["grad_clip"],
                              *adam.get(name, ()))
            for name, params in (("posenet", pose_p), ("refiner", ref_p))}
    losses, first, stepped = [], {}, set()
    for kind, b in zip(kinds, batches):
        if kind == "estimator":
            pred_r, pred_t, pred_c, _ = posenet(b["img"], b["cloud"],
                                                b["choose"], b["obj_idx"],
                                                generator)
            out = pose_loss(pred_r, pred_t, pred_c, b["target"],
                            b["model_points"], b["cloud"], b["is_sym"],
                            cfg["w"])
            loss, net, reading = out.loss, posenet, out.loss
        else:
            with torch.no_grad():
                pred_r, pred_t, pred_c, emb = posenet(
                    b["img"], b["cloud"], b["choose"], b["obj_idx"])
                est = pose_loss(pred_r, pred_t, pred_c, b["target"],
                                b["model_points"], b["cloud"], b["is_sym"],
                                cfg["w"])
            new_points, new_target = est.new_points, est.new_target
            loss = 0.0
            for _ in range(cfg["iteration"]):
                dr, dt = refiner(new_points, emb, b["obj_idx"])
                mean_dis, dis, new_points, new_target = refine_loss(
                    dr, dt, new_target, b["model_points"], new_points,
                    b["is_sym"])
                loss = loss + mean_dis
            net, reading = refiner, dis.mean()
        name = "posenet" if net is posenet else "refiner"
        taken = opts[name].step(leaf_grads(net, loss))
        if name not in stepped:
            stepped.add(name)
            first.update({f"{name}/{k}": g for k, g in taken.items()})
        losses.append(float(reading.detach()))
    params = {f"posenet/{k}": p.detach().clone() for k, p in pose_p.items()}
    params.update({f"refiner/{k}": p.detach().clone()
                   for k, p in ref_p.items()})
    return Readings(kinds=list(kinds), losses=losses, first_grad=first,
                    params=params, start=start)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]
               ) -> Dict[str, float]:
    """Each leaf's |prog - ref| over max(ref, the median leaf's ref): a gap
    of norms, not the norm of a difference."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref}


def leaf_gaps(prog: Readings, ref: Readings) -> Dict[str, Dict[str, float]]:
    """{'grad': the estimator's leaves' gaps of first-gradient norms,
    'change': the gaps of the norms of each moved leaf's change over the
    steps} (see `compare`)."""
    g_ref = {k: _norm(g) for k, g in ref["first_grad"].items()}
    g_est = {k: v for k, v in g_ref.items() if k.startswith("posenet/")}
    g_prog = {k: _norm(prog["first_grad"][k]) for k in g_est}
    med = statistics.median(g_ref.values())
    moved = [k for k in ref["params"]
             if g_ref.get(k, 0.0) >= 1e-3 * med]
    d_ref = {k: _norm(ref["params"][k] - ref["start"][k]) for k in moved}
    d_prog = {k: _norm(prog["params"][k].to(ref["start"][k].device)
                       - ref["start"][k]) for k in moved}
    return {"grad": _leaf_gaps(g_prog, g_est),
            "change": _leaf_gaps(d_prog, d_ref)}


def worst_leaves(gaps: Dict[str, Dict[str, float]], n: int = 3) -> str:
    """The `n` worst leaves of each gap, for the run's log."""
    return "; ".join(
        f"{what}: " + ", ".join(f"{k} {v:.4g}" for k, v in sorted(
            by_leaf.items(), key=lambda kv: -kv[1])[:n])
        for what, by_leaf in gaps.items())


def compare(prog: Readings, ref: Readings) -> Dict[str, float]:
    """loss_gap: the worst estimator step's relative loss gap; grad_gap:
    the worst estimator leaf's gap of first-gradient norms; change_gap: the
    worst leaf's gap of the norms of the parameters' change over the steps,
    of both networks, over the leaves whose reference first gradient is at
    least a thousandth of the median leaf's (below that Adam moves a leaf
    by round-off alone).

    The refiner step's loss and the refiner's first gradient are not
    compared: they follow the estimator's pick of its most confident point,
    which bfloat16's rounding moves among near-tied confidences, and they
    read 2-5 % and up to 29 % apart on sound runs. The refiner's leaves
    are held by change_gap."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30)
                   for kind, p, r in zip(ref["kinds"], prog["losses"],
                                         ref["losses"])
                   if kind == "estimator")
    gaps = leaf_gaps(prog, ref)
    return {"loss_gap": loss_gap, "grad_gap": max(gaps["grad"].values()),
            "change_gap": max(gaps["change"].values()),
            "grad_gap_median": statistics.median(gaps["grad"].values()),
            "change_gap_median": statistics.median(gaps["change"].values())}
