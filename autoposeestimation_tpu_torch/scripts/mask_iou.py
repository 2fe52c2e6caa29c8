"""Mask quality of a trained demo's serving front end.

Over the held-out composite frames that `attribute_serving` serves
(`heldout_cameras`), per class:

  * component IoU: the served CCA component against the ground-truth
    instance mask,
  * argmax IoU: the raw U-Net argmax plane against it (which separates
    the U-Net's capacity from the CCA's choice of component),

for one or more U-Net decoder out_stride variants (`models/unet.py`):
the exact build and the reduced ones share one checkpoint, so the IoU
difference between them is the mask effect of the reduced stride alone.

    python -m autoposeestimation_tpu_torch.scripts.mask_iou --out DIR
        [--family b] [--frames 36] [--strides 1,4] [--device cuda]
        [--artifact PATH]

DIR is the demo's workspace; one JSON line per stride on stdout.
"""
import argparse
import json
import os

import numpy as np
import torch

from .attribute_serving import heldout_cameras, iou
from .train_multi_demo import MULTI_IMG_HW, SCENE_FAMILIES


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True,
                   help="trained demo workspace (train_multi_demo --out)")
    p.add_argument("--family", default="b", choices=tuple(SCENE_FAMILIES))
    p.add_argument("--frames", type=int, default=36)
    p.add_argument("--strides", default="1,4",
                   help="comma list of UNet out_stride variants to compare")
    p.add_argument("--img-h", type=int, default=MULTI_IMG_HW[0])
    p.add_argument("--img-w", type=int, default=MULTI_IMG_HW[1])
    p.add_argument("--device", default="cuda")
    p.add_argument("--artifact", default="")
    args = p.parse_args(argv)

    from .. import weights
    from ..models.unet import UNet
    from ..pipeline import predict
    from ..train import checkpoints
    from ..utils import io, synthetic
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    img_hw = (args.img_h, args.img_w)
    cfg, objects = SCENE_FAMILIES[args.family](48, img_hw)
    classes = io.read_lines(os.path.join(
        io.dataset_dir(args.out, "pose_estimation", "synth"), "classes.txt"))
    num_obj = len(classes)
    seg_vars = checkpoints.load_checkpoint(os.path.join(
        args.out, "segmentation", "trained_models", "synth",
        "Unet_resnet34.ckpt.npz"))["variables"]

    strides = [int(s) for s in args.strides.split(",") if s]
    cams = heldout_cameras(cfg, args.frames)
    frames = [synthetic.render(cfg, cam, objects) for cam in cams]
    defaults = predict.PredictionModels._field_defaults
    cca_scale, cca_sweeps = defaults["cca_scale"], defaults["cca_sweeps"]
    cls_ids = torch.arange(1, num_obj + 1, device=dev)

    def masks_fn(out_stride):
        seg_model = UNet(num_obj + 1, dtype=torch.bfloat16,
                         out_stride=out_stride)
        seg_model.load_state_dict(weights.unet_state_dict(seg_vars))
        seg_model.requires_grad_(False).eval().to(dev)

        @torch.inference_mode()
        def run(image):
            img = torch.as_tensor(image, device=dev).permute(2, 0, 1)
            probs, pred_arg = predict._segment(seg_model, img)
            comps, found, _ = predict._class_mask(
                probs[1:num_obj + 1], pred_arg, cls_ids,
                cca_scale=cca_scale, cca_sweeps=cca_sweeps,
                seg_stride=out_stride, full_hw=img_hw)
            return (comps.cpu().numpy(), found.cpu().numpy(),
                    predict._upsample_plane(pred_arg, out_stride,
                                            img_hw).cpu().numpy())

        return run

    result = {"n_frames": args.frames, "family": args.family,
              "per_stride": {}}
    for s in strides:
        run = masks_fn(s)
        acc = {c: {"component": [], "argmax": [], "found": 0}
               for c in classes}
        for color, _depth, owner in frames:
            comps, found, pred_arg = run(color)
            for i, c in enumerate(classes):
                gt = owner == i
                if found[i]:
                    acc[c]["found"] += 1
                    acc[c]["component"].append(iou(comps[i], gt))
                acc[c]["argmax"].append(iou(pred_arg == i + 1, gt))
        table = {}
        for c in classes:
            table[c] = {
                "found": acc[c]["found"], "of": args.frames,
                "component_iou": round(float(np.mean(acc[c]["component"])), 4)
                if acc[c]["component"] else None,
                "argmax_iou": round(float(np.mean(acc[c]["argmax"])), 4),
            }
        result["per_stride"][str(s)] = table
        print(json.dumps({"out_stride": s, **table}), flush=True)

    if args.artifact:
        io.write_json(os.path.abspath(args.artifact), result)
    return result


if __name__ == "__main__":
    main()
