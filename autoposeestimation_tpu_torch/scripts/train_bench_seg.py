"""Fit the headline serving graph's segmentation U-Net on its own scene.

The headline serving graph runs with random weights, so its argmax masks
are speckle and the CCA and crop stages do bounded worst-case work rather
than that of a tabletop. This script briefly fits the 6-class U-Net on
the headline scene itself (`utils/synthetic.headline_scene`; the served
frame is camera 0 of the ring at height 450) and saves the checkpoint as
OUT/Unet_benchscene.npz, so that a serving measurement can run with
coherent masks at the headline geometry. The pose networks stay random:
their cost does not depend on the weights (static shapes, a fixed slot
per class); only the masks change the stages' mix.

    python -m autoposeestimation_tpu_torch.scripts.train_bench_seg
        --out DIR [--max-steps 300] [--target-miou 0.97] [--device cuda]
"""
import argparse
import json
import os
import time

import numpy as np
import torch


def build_frames(num_classes: int, img_hw):
    """The headline scene from camera rings at three heights (the served
    frame is ring height 450, camera 0): images (F, H, W, 3) uint8 and
    labels (F, H, W), 0 the background."""
    from ..utils import synthetic

    cfg, spheres, _ = synthetic.headline_scene(num_classes, img_hw)
    images, labels = [], []
    for height in (380.0, 450.0, 520.0):
        c = synthetic.SynthConfig(
            img_h=cfg.img_h, img_w=cfg.img_w, fx=cfg.fx, fy=cfg.fy,
            n_viewpoints=12, ring_radius=cfg.ring_radius, ring_height=height)
        for cam in synthetic.ring_cameras(c, np.zeros(3)):
            image, _, owner = synthetic.render(c, cam, spheres)
            images.append(image)
            labels.append((owner + 1).astype(np.int32))
    return np.stack(images), np.stack(labels)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True,
                        help="directory of the checkpoint")
    parser.add_argument("--max-steps", type=int, default=300)
    parser.add_argument("--target-miou", type=float, default=0.97,
                        help="foreground mIoU on the served frame that stops "
                             "training early")
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from .. import weights
    from ..models.common import init_like_flax, normalize_imagenet
    from ..train import checkpoints as ckpt
    from ..train import segmentation as segtrain
    from ..utils.device import resolve_device
    from ..utils.flops import GRAPH_CONFIGS

    dev = resolve_device(args.device)
    hcfg = GRAPH_CONFIGS["serving_graph"]
    num_classes = hcfg["num_classes"]
    img_hw = (hcfg["h"], hcfg["w"])

    images, labels = build_frames(num_classes, img_hw)
    n_frames = len(images)
    print(f"rendered {n_frames} frames at {img_hw}", flush=True)

    cfg = segtrain.SegConfig(classes=num_classes + 1,
                             batch_size=args.batch_size)
    model = segtrain.build_model(cfg, dtype=torch.bfloat16)
    init_like_flax(model, torch.Generator().manual_seed(0))
    model.to(dev)
    optimizer = segtrain.make_optimizer(cfg, model.parameters())

    def normalized(frames: np.ndarray) -> torch.Tensor:
        return normalize_imagenet(torch.as_tensor(frames, device=dev)
                                  .permute(0, 3, 1, 2))

    # the served frame: the ring-height-450 block starts at index 12
    bench_img = normalized(images[12:13])
    bench_lbl = torch.as_tensor(labels[12], device=dev)

    @torch.no_grad()
    def eval_miou():
        model.eval()
        pred = model(bench_img)[0].argmax(0)
        ious = []
        for c in range(1, num_classes + 1):
            p, t = pred == c, bench_lbl == c
            ious.append((p & t).sum() / torch.clamp((p | t).sum(), min=1))
        return torch.stack(ious).cpu().numpy()

    rng = np.random.default_rng(1)
    t0 = time.time()
    miou = 0.0
    step = 0
    for step in range(1, args.max_steps + 1):
        pick = rng.integers(0, n_frames, args.batch_size)
        batch = {"image": normalized(images[pick]).contiguous(),
                 "label": torch.as_tensor(labels[pick], device=dev)
                 .to(torch.int64)}
        metrics = segtrain.train_step(model, optimizer, batch,
                                      num_classes + 1)
        if step % 25 == 0 or step == args.max_steps:
            miou = float(eval_miou().mean())
            print(f"step {step}: loss={float(metrics['loss']):.4f} "
                  f"bench-frame fg mIoU={miou:.4f}", flush=True)
            if miou >= args.target_miou:
                break

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "Unet_benchscene")
    ckpt.save_checkpoint(
        path, weights.to_variables(model.state_dict(),
                                   segtrain.model_plan(cfg)),
        meta={"steps": step, "bench_frame_fg_miou": miou,
              "num_classes_fg": num_classes, "img_hw": list(img_hw),
              "train_seconds": round(time.time() - t0, 1)})
    print(json.dumps({"saved": path + ".npz", "steps": step,
                      "bench_frame_fg_miou": round(miou, 4),
                      "seconds": round(time.time() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
