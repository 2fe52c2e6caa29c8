"""Per-stage attribution of the served pose error of a trained
multi-object demo (`train_multi_demo`).

The evaluation path (the dataset loader's inputs: ground-truth label
mask, its bbox crop, single-object scans) and the serving path (the
U-Net's mask and CCA component, the zoom-window crop, the composite
five-object scene) differ in three stages. This script splits the served
ADD of each class into those stages on freshly rendered held-out
composite frames (the ground-truth poses are analytic):

  eval-path ADD            (from the demo's artifact: single-object scans)
    |-- scene term:        gtmask_s1 - eval      (composite scene and the
    |                       zoom-window crop, mask error excluded)
    |-- mask term:         predmask_s1 - gtmask_s1  (U-Net + CCA)
    `-- stride term:       served_sS - predmask_s1  (reduced-stride decoder)

with the mask quality of each class (IoU of the served component and of
the raw argmax plane against the ground-truth instance mask) and, with
`--ablate`, policy ablations (crop 320, 1000 points) that re-serve the
same predicted masks through a rebuilt pose graph. The held-out frames
are `--frames` new viewpoints (`heldout_cameras`), never seen in
training.

    python -m autoposeestimation_tpu_torch.scripts.attribute_serving
        --out DIR [--frames 36] [--device cuda] ...

DIR is the demo's workspace; the artifact (`--artifact`, by default
DIR/serving_attribution.json) goes there.
"""
import argparse
import json
import os
import time

import numpy as np
import torch

from .train_multi_demo import (MULTI_CROP, MULTI_IMG_HW, MULTI_NUM_PT,
                               MULTI_SYM_CLASS, SCENE_FAMILIES,
                               model_clouds)


def heldout_cameras(cfg, n_frames: int):
    """n_frames composite-scene cameras apart from every training view.

    Training views are `ring_cameras`: angles k 2 pi / n_viewpoints at one
    (radius, height). These sit at half-step angular offsets and cycle
    three (radius, height) pairs around the trained ring, so both the
    azimuths and the elevations are off the training grid.
    """
    from ..utils import synthetic

    rigs = [(cfg.ring_radius * 0.94, cfg.ring_height - 70.0),
            (cfg.ring_radius, cfg.ring_height),
            (cfg.ring_radius * 1.06, cfg.ring_height + 70.0)]
    cams = []
    for i in range(n_frames):
        ang = (i + 0.5) * 2.0 * np.pi / n_frames
        radius, height = rigs[i % len(rigs)]
        pos = np.asarray([radius * np.cos(ang), radius * np.sin(ang), height])
        cams.append(synthetic.look_at(pos, np.zeros(3)))
    return cams


def iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / float(union) if union else 0.0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True,
                   help="trained demo workspace (train_multi_demo --out)")
    p.add_argument("--frames", type=int, default=36)
    p.add_argument("--strides", default="2,1",
                   help="serving strides to run full graphs at; the first "
                        "is the product default for this (symmetric) "
                        "dataset")
    p.add_argument("--num-pt", type=int, default=MULTI_NUM_PT)
    p.add_argument("--crop", type=int, default=MULTI_CROP)
    p.add_argument("--img-h", type=int, default=MULTI_IMG_HW[0])
    p.add_argument("--img-w", type=int, default=MULTI_IMG_HW[1])
    p.add_argument("--family", default="a", choices=tuple(SCENE_FAMILIES))
    p.add_argument("--refine-iters", type=int, default=2,
                   help="refiner iterations of every graph; 0 needs no "
                        "refiner checkpoint")
    p.add_argument("--seg-out-stride", type=int, default=1,
                   choices=(1, 2, 4, 8),
                   help="the U-Net decoder's out_stride for the served "
                        "graphs; the stride-1 reference graph and the "
                        "pose_from_mask stages stay exact")
    p.add_argument("--ablate", action="store_true",
                   help="also re-serve the predicted masks with crop 320 "
                        "and 1000 points")
    p.add_argument("--serve-only", action="store_true",
                   help="only the served_s{stride} conditions: no stride-1 "
                        "reference graph, no pose_from_mask stages, no mask "
                        "IoU")
    p.add_argument("--device", default="cuda")
    p.add_argument("--demo-artifact", default=None,
                   help="the demo's artifact, for the eval-path ADD "
                        "(default OUT/demo_multi.json)")
    p.add_argument("--artifact", default=None,
                   help="default OUT/serving_attribution.json; '' writes "
                        "none")
    args = p.parse_args(argv)
    if args.demo_artifact is None:
        args.demo_artifact = os.path.join(args.out, "demo_multi.json")
    if args.artifact is None:
        args.artifact = os.path.join(args.out, "serving_attribution.json")

    from ..experiments import eval as eval_mod
    from ..pipeline import predict
    from ..train import checkpoints
    from ..utils import io, synthetic
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    root = args.out
    img_hw = (args.img_h, args.img_w)
    cfg, objects = SCENE_FAMILIES[args.family](48, img_hw)
    classes = io.read_lines(os.path.join(
        io.dataset_dir(root, "pose_estimation", "synth"), "classes.txt"))
    num_obj = len(classes)
    centers = {o.name: np.asarray(o.center, float) for o in objects}
    sym_flags = {c: c == MULTI_SYM_CLASS for c in classes}
    model_points = model_clouds(root, classes, args.num_pt)

    seg_vars = checkpoints.load_checkpoint(os.path.join(
        root, "segmentation", "trained_models", "synth",
        "Unet_resnet34.ckpt.npz"))["variables"]
    pose_dir = os.path.join(root, "DenseFusion", "trained_models", "synth")
    pose_vars = checkpoints.load_checkpoint(
        os.path.join(pose_dir, "pose_model.npz"))["variables"]
    refine_path = os.path.join(pose_dir, "pose_refine_model.npz")
    refine_vars = None
    if os.path.exists(refine_path):
        refine_vars = checkpoints.load_checkpoint(refine_path)["variables"]
    elif args.refine_iters > 0:
        # a demo whose refine phase never beat its estimator saves no
        # refiner: attribute its estimator with --refine-iters 0
        raise SystemExit(f"{refine_path} is missing; pass --refine-iters 0")

    def build(crop, num_pt, stride, refine_iters, seg_out_stride=1):
        return predict.build_models(
            num_obj, model_points, tuple(classes), seg_vars=seg_vars,
            pose_vars=pose_vars, refine_vars=refine_vars, num_points=num_pt,
            crop=crop, refine_iters=refine_iters, dtype=torch.bfloat16,
            emb_stride=stride, seg_out_stride=seg_out_stride, device=dev)

    strides = [int(s) for s in args.strides.split(",") if s]
    graph_strides = (sorted(set(strides)) if args.serve_only
                     else sorted(set(strides) | {1}))
    graphs = {s: build(args.crop, args.num_pt, s, args.refine_iters,
                       seg_out_stride=args.seg_out_stride)
              for s in graph_strides}
    m_exact = graphs.get(1)
    if args.seg_out_stride != 1 and not args.serve_only:
        # the attribution's reference stages stay exact in the U-Net too
        m_exact = build(args.crop, args.num_pt, 1, args.refine_iters)
    ablations = {}
    if args.ablate and not args.serve_only:
        ablations = {
            "crop320_s1": build(320, args.num_pt, 1, args.refine_iters),
            "pts1000_s1": build(args.crop, 1000, 1, args.refine_iters),
        }

    intr = io.Intrinsics(width=cfg.img_w, height=cfg.img_h,
                         ppx=cfg.img_w / 2.0, ppy=cfg.img_h / 2.0,
                         fx=cfg.fx, fy=cfg.fy)
    meta = {"intr": intr, "depth_scale": cfg.depth_scale}

    cams = heldout_cameras(cfg, args.frames)
    conds = [f"served_s{s}" for s in strides]
    if not args.serve_only:
        conds += ["predmask_s1", "gtmask_s1", f"gtmask_s{strides[0]}",
                  "norefine_s1"] + list(ablations)
    acc = {c: {k: {"add": [], "pos": [], "found": 0} for k in conds}
           for c in classes}
    iou_acc = {c: {"component": [], "argmax": []} for c in classes}

    t_start = time.time()
    for fi, robot2cam in enumerate(cams):
        color, depth, owner = synthetic.render(cfg, robot2cam, objects)
        depth = depth.astype(np.float32)
        seed = 100000 + fi
        cam2robot = np.linalg.inv(robot2cam)

        outs = {}
        with torch.inference_mode():
            frame = predict._frame_inputs(color, depth, meta, dev)
            for s in strides:
                m = graphs[s]
                u = predict._uniforms(
                    (num_obj, m.num_points), dev,
                    torch.Generator(device=dev).manual_seed(seed), None)
                out = predict._predict_frame(m, *frame, u)
                outs[s] = {k: v.cpu().numpy() for k, v in out.items()}

        prod = outs[strides[0]]
        for i, c in enumerate(classes):
            gt_r = cam2robot[:3, :3]
            gt_t = (cam2robot @ np.append(centers[c], 1.0))[:3] / 1000.0
            gt_mask = owner == i

            def add_of(rot, pos):
                return eval_mod.add_from_pose(rot, pos, gt_r, gt_t,
                                              model_points[i],
                                              symmetric=sym_flags[c])

            def record(cond, rot, pos):
                acc[c][cond]["found"] += 1
                acc[c][cond]["add"].append(add_of(rot, pos))
                acc[c][cond]["pos"].append(
                    float(np.linalg.norm(pos - gt_t)))

            for s in strides:
                if outs[s]["found"][i]:
                    record(f"served_s{s}", outs[s]["quats"][i],
                           outs[s]["positions"][i])

            if args.serve_only or not prod["found"][i]:
                continue
            pred_mask = predict._unpack_masks(
                prod["masks_packed"][i]) if "masks_packed" in prod \
                else prod["masks"][i]
            iou_acc[c]["component"].append(iou(pred_mask, gt_mask))
            iou_acc[c]["argmax"].append(iou(prod["argmax"] == i + 1,
                                            gt_mask))

            def pfm(models, mask, cond, refine_iters=None):
                r = predict.pose_from_mask(
                    color, depth, meta, models, mask, c,
                    generator=torch.Generator(device=dev).manual_seed(seed),
                    refine_iters=refine_iters)
                record(cond, r["rotation"], r["position"])

            pfm(m_exact, pred_mask, "predmask_s1")
            pfm(m_exact, gt_mask, "gtmask_s1")
            pfm(graphs[strides[0]], gt_mask, f"gtmask_s{strides[0]}")
            pfm(m_exact, pred_mask, "norefine_s1", refine_iters=0)
            for name, mm in ablations.items():
                pfm(mm, pred_mask, name)
        if (fi + 1) % 6 == 0:
            print(json.dumps({"frames_done": fi + 1,
                              "seconds": round(time.time() - t_start, 1)}),
                  flush=True)

    demo_eval = None
    if args.demo_artifact and os.path.exists(args.demo_artifact):
        de = io.read_json(args.demo_artifact).get("eval", {})
        table = de.get("with_refine" if de.get("use_refine") else
                       "estimator_only", {})
        demo_eval = {c: table.get(c, {}).get("dis") for c in classes}

    result = {"n_frames": args.frames, "conditions": conds,
              "crop": args.crop, "num_pt": args.num_pt,
              "seg_out_stride": args.seg_out_stride,
              "per_class": {}}
    for c in classes:
        row = {"sym": sym_flags[c],
               "mask_iou_component": round(
                   float(np.mean(iou_acc[c]["component"])), 4)
               if iou_acc[c]["component"] else None,
               "mask_iou_argmax": round(
                   float(np.mean(iou_acc[c]["argmax"])), 4)
               if iou_acc[c]["argmax"] else None,
               "eval_path_add_m": demo_eval.get(c) if demo_eval else None}
        for k in conds:
            v = acc[c][k]
            row[k] = {
                "found": v["found"], "of": args.frames,
                "add_mean_m": round(float(np.mean(v["add"])), 5)
                if v["add"] else None,
                "add_lt_2cm_pct": round(
                    100.0 * float(np.mean(np.asarray(v["add"]) < 0.02)), 2)
                if v["add"] else None,
                "pos_err_mean_m": round(float(np.mean(v["pos"])), 5)
                if v["pos"] else None,
            }
        # the three attribution terms (means, metres)
        g1 = row["gtmask_s1"]["add_mean_m"] if "gtmask_s1" in row else None
        p1 = (row["predmask_s1"]["add_mean_m"] if "predmask_s1" in row
              else None)
        s0 = row[f"served_s{strides[0]}"]["add_mean_m"]
        if demo_eval and demo_eval.get(c) and None not in (g1, p1, s0):
            row["terms_m"] = {
                "eval_path": demo_eval[c],
                "scene_crop": round(g1 - demo_eval[c], 5),
                "mask": round(p1 - g1, 5),
                "stride": round(s0 - p1, 5),
                "served_total": s0,
            }
        result["per_class"][c] = row

    result["seconds"] = round(time.time() - t_start, 1)

    def fmt(v, w=7, p=4):
        return f"{v:>{w}.{p}f}" if v is not None else " " * (w - 3) + "nan"

    hdr = (f"{'class':>8} {'eval':>7} {'gt_s1':>7} {'pred_s1':>8} "
           f"{'served':>7} {'IoU':>6} {'<2cm%':>6}")
    print(hdr, flush=True)
    for c in classes:
        r = result["per_class"][c]
        served = r[f"served_s{strides[0]}"]
        gt = r["gtmask_s1"]["add_mean_m"] if "gtmask_s1" in r else None
        pred = (r["predmask_s1"]["add_mean_m"] if "predmask_s1" in r
                else None)
        print(f"{c:>8} {fmt(r['eval_path_add_m'])} {fmt(gt)} "
              f"{fmt(pred, 8)} {fmt(served['add_mean_m'])} "
              f"{fmt(r['mask_iou_component'], 6, 3)} "
              f"{fmt(served['add_lt_2cm_pct'], 6, 2)}",
              flush=True)
    if args.artifact:
        io.write_json(os.path.abspath(args.artifact), result)
    print(json.dumps({"stage": "attribution", "n_frames": args.frames,
                      "seconds": result["seconds"]}), flush=True)
    return result


if __name__ == "__main__":
    main()
