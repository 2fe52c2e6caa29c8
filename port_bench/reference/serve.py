"""The frame graph in plain float32, and the judge of served frames.

`frame_outputs` runs the whole graph on one frame: U-Net, softmax and
argmax, the best component of each class, the zoom window, the chosen
points, the PoseNet with its maximum-confidence pick, and the refiner
passes. As the program's stand-in (with `nets.set_quant`) it is the
control of `correct`.

`FrameJudge.judge` holds one frame that the program served against the
reference. Pixels where the reference's two best logits lie within the
tie margin (the cell's limit of seg_gap) may fall to either class under
rounding, and the judge accepts either:
  seg_gap    the widest gap, over every pixel of every returned mask, by
             which the reference's logit of the mask's class lies below
             its best logit there (0 where the argmax agrees);
  mass_gap   the found flags and the masks as components: each class's
             returned mask, weighed by the reference's probabilities of
             that class (0 where the class was not returned), against the
             least and the most mass that the best component can have
             under the reference, the component stage run to convergence
             on the class's pixels with the tied ones left out and with
             them taken in (each needing more than 100 pixels and one with
             depth, as the program's `found` does). The worst class's
             shortfall below the least, over it, or excess above the most,
             over the returned mass: a class left out that the reference
             finds either way, or found where it cannot be, reads 1, half
             a component about 0.5. The least holds only where the
             program's labels converged: the configuration's fixed sweeps
             (`cca_sweeps`) may leave a component of the program's class
             pixels split in parts, and the best part of a class set that
             holds the tied pixels can weigh less than the best component
             of the set without them. The program says which lanes
             converged (`cca_converged`); on the others only a class left
             out, and the most, are held;
  cell_gap   each returned mask against the cells (`cca_scale` pixels
             square) that the component stage labels: a component is
             every pixel of its class in each cell it holds, so a mask
             keeps every pixel of its class that the reference gives it
             beyond the tie margin in each of its cells. The worst share
             of those pixels that a mask leaves out;
  pose_err   the pose stage followed from the program's own mask, with
             the same draws: the worst found class's mean distance [m]
             between the model points under the returned pose and under
             the nearest of the reference's poses, each point's estimator
             pose refined as the program refines its pick. The pick
             itself, the most confident point, is not judged: with random
             weights the confidences of a lane's points lie within
             bfloat16's rounding of each other, and a sound run's pick
             lands anywhere in the reference's order."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from . import geometry as G
from .nets import normalize_imagenet
from .pose import refine_chain


class Frame(dict):
    """image uint8 (H, W, 3), depth (H, W) raw units, intr (4,),
    depth_scale (), uniforms (K, N): tensors on one device."""


def components(cls_mask: torch.Tensor, score: torch.Tensor,
               cca_scale: int, cca_sweeps: int, min_count: int = 100):
    """Best component (K, H, W) of each class's pixels `cls_mask` scored
    on `score` (K, H, W), its found flag (more than `min_count` pixels)
    and whether its labels converged. `cca_sweeps` 0 labels to
    convergence."""
    count = cls_mask.sum((-2, -1))
    h, w = cls_mask.shape[-2:]
    cells = -(-h // cca_scale) * -(-w // cca_scale)
    comp, found, converged = G.best_component_mask(
        cls_mask, torch.where(cls_mask, score, 0.0), rule="sum",
        scale=cca_scale, fixed_sweeps=cca_sweeps, max_iters=cells,
        with_flag=True)
    return comp, found & (count > min_count), converged


def class_masks(probs: torch.Tensor, arg: torch.Tensor, k: int,
                cca_scale: int, cca_sweeps: int, min_count: int = 100):
    """Best component (K, H, W) of classes 1..K, their found flags and
    whether their labels converged."""
    cls_ids = torch.arange(1, k + 1, device=arg.device)
    return components(arg == cls_ids[:, None, None], probs[1:k + 1],
                      cca_scale, cca_sweeps, min_count)


def cell_gap(masks: torch.Tensor, sure: torch.Tensor, scale: int) -> float:
    """The worst share, over masks (K, H, W), of the pixels `sure` (K, H,
    W) of each mask's class inside the mask's own `scale`-pixel cells that
    the mask leaves out."""
    h, w = masks.shape[-2:]
    pad = F.pad(masks.to(torch.float32), (0, (-w) % scale, 0, (-h) % scale))
    held = F.max_pool2d(pad[:, None], scale)[:, 0] > 0
    region = held.repeat_interleave(scale, -2).repeat_interleave(
        scale, -1)[..., :h, :w]
    due = sure & region
    missing = (due & ~masks).sum((-2, -1))
    return float((missing / due.sum((-2, -1)).clamp(min=1)).max())


def pose_inputs(frame: Frame, masks: torch.Tensor, crop: int, num_pt: int):
    """(crops (K, 3, crop, crop) normalized, cloud (K, N, 3), choose (K, N),
    count (K,)) of the masks' zoom windows."""
    img = frame["image"].permute(2, 0, 1)
    depth = frame["depth"].to(torch.float32)
    h, w = depth.shape
    r0, c0, win = G.zoom_window_bbox(masks, crop, h, w)
    cloud, choose, count = G.backproject_choose_zoom(
        depth, masks, frame["intr"], frame["depth_scale"], r0, c0, win, crop,
        num_pt, frame["uniforms"])
    crops = normalize_imagenet(G.resample_window(img, r0, c0, win, crop))
    return crops, cloud, choose, count


@torch.no_grad()
def frame_outputs(nets, frame: Frame, cfg: Dict) -> Dict[str, torch.Tensor]:
    """found (K,), masks (K, H, W), quats (K, 4), positions (K, 3),
    converged (K,)."""
    unet, posenet, refiner = nets
    k = cfg["num_objects"]
    img = frame["image"].permute(2, 0, 1)
    logits = unet(normalize_imagenet(img)[None])[0]
    probs = torch.softmax(logits, 0)
    masks, found, converged = class_masks(
        probs, probs.argmax(0), k, cfg["cca_scale"], cfg["cca_sweeps"])
    crops, cloud, choose, count = pose_inputs(frame, masks, cfg["crop"],
                                              cfg["num_points"])
    obj = torch.arange(k, device=img.device)
    pred_r, pred_t, pred_c, emb = posenet(crops, cloud, choose, obj)
    which = pred_c[..., 0].argmax(1)
    lanes = torch.arange(k, device=img.device)
    quat = G.quat_normalize(pred_r[lanes, which])
    trans = cloud[lanes, which] + pred_t[lanes, which]
    quat, trans = refine_chain(refiner, quat, trans, cloud, emb, obj,
                               cfg["refine_iters"])
    return {"found": found & (count > 0), "masks": masks, "quats": quat,
            "positions": trans, "converged": converged.expand(k)}


def mass_bounds(frame: Frame, sure: torch.Tensor, maybe: torch.Tensor,
                probs: torch.Tensor, cfg: Dict):
    """(least, most) mass (K,) of each class's best component, its tied
    pixels left out (`sure`) or taken in (`maybe`), labelled to
    convergence; 0 where it is not found."""
    k = cfg["num_objects"]
    masses = []
    for cls_mask in (sure, maybe):
        comp, found, _ = components(cls_mask, probs[1:k + 1],
                                    cfg["cca_scale"], 0)
        count = pose_inputs(frame, comp, cfg["crop"], cfg["num_points"])[3]
        found = found & (count > 0)
        masses.append(torch.where(
            found, (probs[1:k + 1] * comp).sum((-2, -1)), 0.0))
    return torch.minimum(*masses), torch.maximum(*masses)


def mask_gaps(frame: Frame, logits: torch.Tensor, masks: torch.Tensor,
              converged: torch.Tensor, cfg: Dict, tie: float):
    """mass_gap and cell_gap (see above) of the returned masks (K, H, W),
    empty where a class was not returned, against the reference's logits
    (K + 1, H, W); and the (least, most) masses."""
    k = cfg["num_objects"]
    probs = torch.softmax(logits, 0)
    top = logits.topk(2, dim=0)
    ids = torch.arange(1, k + 1, device=logits.device)[:, None, None]
    sure = (top.indices[0] == ids) & (top.values[0] - top.values[1] > tie)
    maybe = top.values[0] - logits[1:k + 1] <= tie
    lo, hi = mass_bounds(frame, sure, maybe, probs, cfg)
    mass = (probs[1:k + 1] * masks).sum((-2, -1))
    short = (lo - mass).clamp(min=0) / lo.clamp(min=1e-30)
    short = torch.where(converged | (mass == 0), short, 0.0)
    excess = (mass - hi).clamp(min=0) / mass.clamp(min=1e-30)
    return {"mass_gap": float(torch.maximum(short, excess).max()),
            "cell_gap": cell_gap(masks, sure, cfg["cca_scale"])}, (lo, hi)


def add_distance(q1, t1, q2, t2, model: torch.Tensor) -> torch.Tensor:
    """Mean distance between model points (M, 3) under two poses; q (...,
    4), t (..., 3) broadcast."""
    p1 = model @ G.quat_to_mat(q1).transpose(-1, -2) + t1[..., None, :]
    p2 = model @ G.quat_to_mat(q2).transpose(-1, -2) + t2[..., None, :]
    return torch.linalg.vector_norm(p1 - p2, dim=-1).mean(-1)


class FrameJudge:
    """The reference networks (float32, on the card that ran the program),
    the configuration's model points (K, M, 3), and the tie margin of the
    logits."""

    def __init__(self, nets, model_points: torch.Tensor, cfg: Dict,
                 tie: float, candidates: int = 4, block: int = 256):
        self.nets, self.model_points, self.cfg = nets, model_points, cfg
        self.tie, self.candidates, self.block = tie, candidates, block
        self.bounds = []       # (least, most) masses of each judged frame

    def _refined(self, quat, trans, cloud, emb, obj, tf32: bool):
        """Every candidate pose (L, C) refined: (L, C, 4), (L, C, 3), in
        blocks of lanes."""
        refiner, iters = self.nets[2], self.cfg["refine_iters"]
        l, c = quat.shape[:2]
        q, t = quat.flatten(0, 1), trans.flatten(0, 1)
        lane = torch.arange(l, device=q.device).repeat_interleave(c)
        outs_q, outs_t = [], []
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            for i in range(0, q.shape[0], self.block):
                s = lane[i:i + self.block]
                rq, rt = refine_chain(refiner, q[i:i + self.block],
                                      t[i:i + self.block], cloud[s], emb[s],
                                      obj[s], iters)
                outs_q.append(rq)
                outs_t.append(rt)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        return (torch.cat(outs_q).unflatten(0, (l, c)),
                torch.cat(outs_t).unflatten(0, (l, c)))

    def _pose_err(self, frame, masks, live, q_p, t_p) -> float:
        """The pose stage from the returned masks: every point's estimator
        pose refined (TF32), the `candidates` nearest the returned pose
        refined again in float32, the nearest of those."""
        cfg = self.cfg
        posenet = self.nets[1]
        crops, cloud, choose, _ = pose_inputs(
            Frame(frame, uniforms=frame["uniforms"][live]), masks[live],
            cfg["crop"], cfg["num_points"])
        pred_r, pred_t, _, emb = posenet(crops, cloud, choose, live)
        est_q, est_t = G.quat_normalize(pred_r), cloud + pred_t  # (L, N, .)
        model = self.model_points[live][:, None]             # (L, 1, M, 3)
        fast_q, fast_t = self._refined(est_q, est_t, cloud, emb, live, True)
        near = add_distance(q_p[:, None], t_p[:, None], fast_q, fast_t,
                            model).topk(self.candidates, dim=1,
                                        largest=False).indices
        lanes = torch.arange(live.numel(), device=near.device)[:, None]
        exact_q, exact_t = self._refined(est_q[lanes, near],
                                         est_t[lanes, near], cloud, emb,
                                         live, False)
        dist = add_distance(q_p[:, None], t_p[:, None], exact_q, exact_t,
                            model)
        return float(dist.min(1).values.max())

    @torch.no_grad()
    def judge(self, frame: Frame, served: Dict[str, torch.Tensor]
              ) -> Dict[str, float]:
        """`served`: found (K,) bool, masks (K, H, W) bool (empty where not
        found), quats (K, 4), positions (K, 3), converged (K,) bool, as
        the program returned them."""
        unet = self.nets[0]
        k = self.cfg["num_objects"]
        dev = frame["image"].device
        img = frame["image"].permute(2, 0, 1)
        logits = unet(normalize_imagenet(img)[None])[0]
        found_p = served["found"].to(dev)
        masks_p = served["masks"].to(dev) & found_p[:, None, None]
        best = logits.max(0).values
        gaps = torch.where(masks_p, best[None] - logits[1:k + 1], 0.0)
        out = {"seg_gap": float(gaps.max()) if masks_p.any() else 0.0}

        converged = served["converged"].to(dev)
        gaps, (lo, hi) = mask_gaps(frame, logits, masks_p, converged,
                                   self.cfg, self.tie)
        out.update(gaps)
        self.bounds.append((lo.cpu(), hi.cpu(), converged.cpu()))

        out["pose_err"] = 0.0
        live = torch.nonzero(found_p).flatten()
        if live.numel():
            out["pose_err"] = self._pose_err(frame, masks_p, live,
                                             served["quats"].to(dev)[live],
                                             served["positions"].to(dev)[live])
        return out
