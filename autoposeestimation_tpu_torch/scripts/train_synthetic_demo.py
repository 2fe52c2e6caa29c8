"""The whole loop on one object: generate a synthetic scanned dataset,
train the segmentation U-Net and DenseFusion, evaluate ADD(-S), and serve
the test frames through the frame graph with the trained weights.

    python -m autoposeestimation_tpu_torch.scripts.train_synthetic_demo
        --out DIR [--device cuda] [--seg-epochs 12] [--pose-epochs 120]
        [--reuse-seg] [--reuse-pose] [--resume-pose] [--refine-only N]

The workspace, `demo_results.json` and the artifact (`--artifact`, by
default DIR/demo_results_artifact.json) go under DIR; one JSON line per
stage on stdout.
"""
import argparse
import json
import os
import time

import numpy as np
import torch

# the demo's fixture geometry
DEMO_IMG_HW = (256, 320)
DEMO_FX = 420.0
DEMO_NUM_PT = 500
DEMO_CROP = 128


def demo_config():
    """256x320 at fx 420 on a 300 mm ring: ~0.7 mm a pixel. 48 viewpoints
    give 39 training and 9 test views."""
    from ..utils import synthetic

    return synthetic.SynthConfig(img_h=DEMO_IMG_HW[0], img_w=DEMO_IMG_HW[1],
                                 fx=DEMO_FX, fy=DEMO_FX, ring_radius=300.0,
                                 ring_height=280.0, n_viewpoints=48)


def demo_object(center):
    """A ball with three bumps of distinct colours (symmetric=0): the
    flat-shaded renderer has no shading, so the colours make the rotation
    observable in RGB from every viewpoint."""
    from ..utils import synthetic

    return synthetic.SphereObject(
        "ball", center, 35.0, (210, 40, 40), symmetric=0,
        parts=(((25.0, 25.0, 25.0), 16.0, (40, 200, 60)),
               ((-30.0, 5.0, 5.0), 13.0, (50, 70, 220)),
               ((5.0, -30.0, -10.0), 11.0, (230, 210, 50))))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True,
                        help="workspace directory; every output goes here")
    parser.add_argument("--seg-epochs", type=int, default=12)
    # the refiner needs ~25-30 refine-phase epochs to beat the estimator
    parser.add_argument("--pose-epochs", type=int, default=120)
    parser.add_argument("--reuse-seg", action="store_true",
                        help="load the existing segmentation checkpoint "
                             "instead of retraining")
    parser.add_argument("--reuse-pose", action="store_true",
                        help="load the existing pose/refine checkpoints "
                             "instead of retraining")
    parser.add_argument("--resume-pose", action="store_true",
                        help="continue an interrupted pose training from the "
                             "trainer_resume snapshot")
    parser.add_argument("--refine-only", type=int, default=0, metavar="N",
                        help="keep the saved best estimator, retrain only "
                             "the refine phase for N epochs from a fresh "
                             "refiner")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--artifact", default=None,
                        help="default OUT/demo_results_artifact.json; '' "
                             "writes none")
    args = parser.parse_args(argv)
    if args.artifact is None:
        args.artifact = os.path.join(args.out, "demo_results_artifact.json")

    from .. import weights
    from ..data import loader, pose_dataset, segmentation_dataset
    from ..experiments import eval as eval_mod
    from ..pipeline import predict
    from ..train import checkpoints
    from ..train import densefusion as dft
    from ..train import segmentation as seg
    from ..utils import io, synthetic
    from ..utils import transforms as T
    from ..utils.device import resolve_device
    from .train_multi_demo import load_posenet

    dev = resolve_device(args.device)
    root = args.out
    os.makedirs(root, exist_ok=True)
    results = {}

    center = np.asarray([20.0, -10.0, 35.0])
    demo_cfg = demo_config()
    if not io.list_objects(root):
        synthetic.make_dataset(root, objects=[demo_object(center)],
                               cfg=demo_cfg)

    # --- segmentation training ---------------------------------------------
    t0 = time.time()
    seg_ckpt_dir = os.path.join(root, "segmentation", "trained_models",
                                "synth")
    if args.reuse_seg and os.path.exists(
            os.path.join(seg_ckpt_dir, "Unet_resnet34.ckpt.npz")):
        _out = checkpoints.load_checkpoint(
            os.path.join(seg_ckpt_dir, "Unet_resnet34.ckpt.npz"))
        seg_out = {"variables": _out["variables"],
                   "best_iou": _out["meta"].get("best_iou", -1.0)}
        results["segmentation"] = {"reused": True}
        print(json.dumps({"stage": "segmentation", "reused": True}),
              flush=True)
    else:
        train_ds = segmentation_dataset.SegmentationDataset(
            root, "synth", mode="train", label_mode="gen", output_size=128)
        valid_ds = segmentation_dataset.SegmentationDataset(
            root, "synth", mode="test", label_mode="gen")
        cfg = seg.SegConfig(classes=2, epochs=args.seg_epochs, batch_size=4,
                            lr=3e-3)
        seg_out = seg.segmentation_training(
            lambda: loader.Loader(train_ds, 4, seed=0),
            lambda: loader.Loader(valid_ds, 4, shuffle=False,
                                  drop_last=False),
            cfg, out_dir=seg_ckpt_dir, dtype=torch.bfloat16, device=dev)
        results["segmentation"] = {
            "best_valid_miou": round(seg_out["best_iou"], 4),
            "epochs": args.seg_epochs,
            "seconds": round(time.time() - t0, 1),
        }
        print(json.dumps({"stage": "segmentation",
                          **results["segmentation"]}), flush=True)

    # --- DenseFusion training ----------------------------------------------
    # the two-phase flow: lr and w decay when the best test ADD < 0.016,
    # the refine phase when < 0.010, with an epoch fallback only as a
    # safety net; on the refine transition the best estimator checkpoint is
    # reloaded, so the refiner trains against the estimator that serving
    # pairs it with
    t0 = time.time()
    num_pt, num_pt_mesh, crop = DEMO_NUM_PT, DEMO_NUM_PT, DEMO_CROP
    dcfg = dft.DFConfig(batch_size=4, num_points=num_pt,
                        num_points_mesh=num_pt_mesh, lr=1e-4,
                        # 5/6 of the budget, behind the decay fallback (2/3)
                        refine_epoch_margin=(5 * args.pose_epochs) // 6,
                        with_sym=False)
    state = dft.create_trainer(1, dcfg, dtype=torch.bfloat16, device=dev)
    ptrain = pose_dataset.PoseDataset(root, "synth", mode="train",
                                      num_pt=num_pt, num_pt_mesh=num_pt_mesh,
                                      crop=crop, add_noise=True,
                                      noise_trans=0.01, rot_degrees=45.0)
    ptest = pose_dataset.PoseDataset(root, "synth", mode="test",
                                     num_pt=num_pt, num_pt_mesh=num_pt_mesh,
                                     crop=crop)
    pimg = pose_dataset.PoseDataset(root, "synth", mode="test",
                                    num_pt=num_pt, num_pt_mesh=num_pt_mesh,
                                    crop=crop, return_raw=True)
    pose_dir = os.path.join(root, "DenseFusion", "trained_models", "synth")
    pose_path = os.path.join(pose_dir, "pose_model.npz")
    transitions = {}

    def _transition_cb(st, epoch, test_mean):
        # a scheduled decay at 2/3 of the budget, only while the margin has
        # not fired; it decays lr and w once, as the margin does
        if (not st.decay_start and epoch == (2 * args.pose_epochs) // 3):
            st.decay_start = True
            st.lr *= dcfg.lr_rate
            st.w *= dcfg.w_rate
            dft.set_lr(st.optimizer, st.lr)
            transitions.setdefault("decay", {"epoch": epoch,
                                             "trigger": "fallback_schedule"})
        elif st.decay_start and "decay" not in transitions:
            transitions["decay"] = {"epoch": epoch, "trigger": "margin",
                                    "best_test": round(st.best_test, 5)}
        if st.refine_start and "refine" not in transitions:
            transitions["refine"] = {
                "epoch": epoch,
                "trigger": ("margin" if st.best_test < dcfg.refine_margin
                            else "epoch_fallback"),
                "best_test": round(st.best_test, 5)}
            load_posenet(st.posenet, pose_path)

    train_kw = dict(
        out_dir=pose_dir,
        image_dump_dir=os.path.join(pose_dir, "logs", "images"),
        image_batches=lambda: loader.Loader(pimg, 4, shuffle=False,
                                            drop_last=False),
        image_every=10, epoch_callback=_transition_cb)
    tb = lambda: loader.Loader(ptrain, 4, seed=0)  # noqa: E731
    vb = lambda: loader.Loader(ptest, 4, shuffle=False,  # noqa: E731
                               drop_last=False)

    def drop_stale(names):
        for stale in names:
            for suffix in (".npz", ".npz.meta.json"):
                p = os.path.join(pose_dir, stale + suffix)
                if os.path.exists(p):
                    os.remove(p)

    if args.refine_only and os.path.exists(pose_path):
        # keep the trained estimator; retrain only the refine phase from
        # the trainer's fresh refiner, in the state the margin transition
        # leaves
        best_est = load_posenet(state.posenet, pose_path)
        state.best_test = float(best_est["meta"]["test_dis"])
        state.decay_start = True
        state.lr = dcfg.lr * dcfg.lr_rate
        state.w = dcfg.w * dcfg.w_rate
        state.refine_start = True
        state.refine_optimizer = dft.make_optimizer(
            state.refiner.parameters(), state.lr, dcfg.grad_clip)
        drop_stale(("pose_refine_model", "trainer_resume"))
        transitions["decay"] = {"trigger": "carried_from_full_run"}
        transitions["refine"] = {"trigger": "carried_from_full_run",
                                 "best_test": round(state.best_test, 5)}
        # train() runs epochs [start_epoch=1, epochs)
        state = dft.train(state, tb, vb, epochs=args.refine_only + 1,
                          **{**train_kw, "save_resume": False})
    elif args.reuse_pose and os.path.exists(pose_path):
        best_est = load_posenet(state.posenet, pose_path)
        state.best_test = float(best_est["meta"]["test_dis"])
        state.refine_start = True
    elif args.resume_pose and os.path.exists(
            os.path.join(pose_dir, "trainer_resume.npz")):
        state = dft.resume_trainer(state, pose_dir)
        results["pose_resumed_from_epoch"] = state.cfg.start_epoch
        state = dft.train(state, tb, vb, epochs=args.pose_epochs + 1,
                          **train_kw)
        best_est = load_posenet(state.posenet, pose_path)
    else:
        drop_stale(("pose_model", "pose_refine_model", "trainer_resume"))
        state = dft.train(state, tb, vb, epochs=args.pose_epochs + 1,
                          **train_kw)
        best_est = load_posenet(state.posenet, pose_path)
    results["pose_training"] = {
        "best_test_add_m": round(state.best_test, 5),
        "estimator_best_add_m": round(float(best_est["meta"]["test_dis"]), 5),
        "refine_phase_reached": state.refine_start,
        "transitions": transitions,
        "epochs": args.pose_epochs,
        "seconds": round(time.time() - t0, 1),
    }
    print(json.dumps({"stage": "pose_training", **results["pose_training"]}),
          flush=True)

    # --- ADD(-S) on the best checkpoints -----------------------------------
    refine_path = os.path.join(pose_dir, "pose_refine_model.npz")
    refine_saved = os.path.exists(refine_path)
    if refine_saved:
        state.refiner.load_state_dict(weights.refiner_state_dict(
            checkpoints.load_checkpoint(refine_path)["variables"]))
    models_eval = dft.EvalModels(state.posenet, state.refiner, state.w,
                                 dcfg.with_sym)
    add_est = eval_mod.evaluate(models_eval, vb, ["ball"], refine=False)
    add_ref = add_est
    if refine_saved:
        add_ref = eval_mod.evaluate(models_eval, vb, ["ball"], refine=True,
                                    iteration=dcfg.iteration)
    # choose by translation error: ADD-S on the near-spherical object
    # absorbs translation error, and translation is what the grasp needs;
    # ADD(-S) decides when t_err is missing
    te_est, te_ref = add_est["ball"]["t_err"], add_ref["ball"]["t_err"]
    if refine_saved and np.isfinite(te_est) and np.isfinite(te_ref):
        use_refine = te_ref <= te_est
    else:
        use_refine = (refine_saved
                      and add_ref["ball"]["dis"] <= add_est["ball"]["dis"])
    results["eval"] = {"estimator_only": add_est, "with_refine": add_ref,
                       "use_refine": use_refine}
    print(json.dumps({"stage": "eval",
                      "estimator_add_m": add_est["ball"]["dis"],
                      "refined_add_m": add_ref["ball"]["dis"],
                      "estimator_t_err_m": te_est,
                      "refined_t_err_m": te_ref,
                      "p_lt_2cm": add_est["ball"]["p"],
                      "use_refine": use_refine}), flush=True)

    # --- trained serving over the whole test split -------------------------
    iters = dcfg.iteration if use_refine else 0
    model_cloud = io.read_xyz(os.path.join(io.pc_dir(root), "ball",
                                           "ball.xyz")) / 1000.0
    build_kw = dict(
        num_classes_fg=1, model_points=model_cloud[None, :num_pt_mesh],
        classes=("ball",), seg_vars=seg_out["variables"],
        pose_vars=weights.posenet_variables(state.posenet),
        refine_vars=weights.refiner_variables(state.refiner),
        num_points=num_pt, crop=crop, refine_iters=iters,
        dtype=torch.bfloat16, device=dev)
    models = predict.build_models(**build_kw)

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    ds_dir = io.dataset_dir(root, "pose_estimation", "synth")
    test_stems = io.read_lines(os.path.join(ds_dir, "test_data_list.txt"))
    frames = []
    for stem in test_stems:
        s_meta = io.read_sample_meta(os.path.join(
            io.data_dir(root), stem + ".meta.json"))
        s_image = io.read_color(os.path.join(
            io.data_dir(root), stem + ".color.png"))
        s_depth = io.read_depth(os.path.join(
            io.data_dir(root), stem + ".depth.png")).astype(np.float32)
        s_out = predict.full_prediction(s_image, s_depth, s_meta, models,
                                        generator=seeded(0))
        robot2cam = io.robot2cam_from_meta(s_meta)
        gt_cam = (np.linalg.inv(robot2cam)
                  @ np.append(center, 1.0))[:3] / 1000.0
        if "ball" in s_out["predictions"]:
            p = s_out["predictions"]["ball"]
            frames.append({"stem": stem, "found": True,
                           "err": float(np.linalg.norm(
                               p["position"] - gt_cam)),
                           "image": s_image, "depth": s_depth,
                           "meta": s_meta, "gt_cam": gt_cam, "pred": p,
                           "robot2cam": robot2cam})
        else:
            frames.append({"stem": stem, "found": False})
    found_frames = [f for f in frames if f["found"]]
    errs = [f["err"] for f in found_frames]
    found = bool(found_frames)
    err = float(np.mean(errs)) if errs else None
    attribution = {}

    def pos_err(f, m, refine_iters=iters, seed=0):
        p = predict.pose_from_mask(f["image"], f["depth"], f["meta"], m,
                                   f["pred"]["mask"] > 0, "ball",
                                   generator=seeded(seed),
                                   refine_iters=refine_iters)
        return p["position"]

    if found:
        # the confidence-weighted top-k candidate average against the
        # argmax pick, on the same predicted masks
        attribution["agg_topk_pos_err_mean_m"] = {
            f"topk_{k}": round(float(np.mean([
                np.linalg.norm(pos_err(f, models._replace(agg_topk=k))
                               - f["gt_cam"]) for f in found_frames])), 5)
            for k in (1, 4, 16)}

        # the point draw's noise: one draw against the pose averaged over 4
        es1, es4 = [], []
        for f in found_frames:
            ps = [pos_err(f, models, seed=k) for k in range(4)]
            es1.append(float(np.linalg.norm(ps[0] - f["gt_cam"])))
            es4.append(float(np.linalg.norm(
                np.mean(ps, axis=0) - f["gt_cam"])))
        attribution["single_draw_pos_err_mean_m"] = round(
            float(np.mean(es1)), 5)
        attribution["multi_draw4_pos_err_mean_m"] = round(
            float(np.mean(es4)), 5)

        # the emb_stride=8 accuracy gate: the same weights served through
        # the full-resolution decoder (emb_stride 1), the default to stay
        # within 2 mm of it
        m_exact = predict.build_models(**build_kw, emb_stride=1)
        es_exact = [float(np.linalg.norm(pos_err(f, m_exact) - f["gt_cam"]))
                    for f in found_frames]
        attribution["emb_stride1_exact_pos_err_mean_m"] = round(
            float(np.mean(es_exact)), 5)
        attribution["emb_stride8_pos_err_mean_m"] = round(
            float(np.mean(es1)), 5)
        attribution["emb_stride8_within_2mm"] = bool(
            abs(np.mean(es1) - np.mean(es_exact)) <= 0.002)
        attribution["n_test_frames"] = len(frames)
        attribution["n_found"] = len(found_frames)
        attribution["pos_err_mean_m"] = round(float(np.mean(errs)), 5)
        attribution["pos_err_median_m"] = round(float(np.median(errs)), 5)
        attribution["pos_err_max_m"] = round(float(np.max(errs)), 5)
        attribution["pos_err_per_frame"] = {
            f["stem"]: round(f["err"], 5) for f in found_frames}

        # ---- per-stage attribution on the worst frame ---------------------
        worst = max(found_frames, key=lambda f: f["err"])
        attribution["worst_frame"] = worst["stem"]
        image, depth, meta = worst["image"], worst["depth"], worst["meta"]
        gt_cam, pred, robot2cam = (worst["gt_cam"], worst["pred"],
                                   worst["robot2cam"])
        gt_label = io.read_label(os.path.join(
            io.label_dir(root), worst["stem"] + ".gen.label.png")) > 0
        pm = pred["mask"] > 0
        inter = float((pm & gt_label).sum())
        union = float((pm | gt_label).sum())
        attribution["seg_mask_iou"] = round(inter / max(union, 1.0), 4)

        # the pose from the ground-truth mask against the predicted one,
        # estimator against refined
        for tag, mask_arr in (("pred_mask", pm), ("gt_mask", gt_label)):
            for kind, n_it in (("estimator", 0), ("refined", dcfg.iteration)):
                p = predict.pose_from_mask(image, depth, meta, models,
                                           mask_arr, "ball",
                                           refine_iters=n_it)
                attribution[f"cam_err_{tag}_{kind}"] = round(float(
                    np.linalg.norm(p["position"] - gt_cam)), 5)

        # the robot-frame composition: with exact calibration transforms
        # the position error's norm is invariant under the rigid
        # robot2cam, so equal errors show the composition adds nothing
        cam2obj = T.pose_to_tf(
            torch.as_tensor(np.asarray(pred["rotation"], np.float32)),
            torch.as_tensor(np.asarray(pred["position"], np.float32))
            * 1000.0).numpy()
        robot2obj = robot2cam @ cam2obj
        robot_err = float(np.linalg.norm(
            robot2obj[:3, 3] / 1000.0 - center / 1000.0))
        attribution["robot_frame_err_m"] = round(robot_err, 5)
        attribution["cam_frame_err_m"] = round(worst["err"], 5)
        attribution["frame_composition_exact"] = bool(
            abs(robot_err - worst["err"]) < 1e-6)
    # the host waits for every frame here: this is the latency of one
    # frame at a time, not the device's throughput (the key keeps the JAX
    # demo's name)
    ff = found_frames[0] if found_frames else None
    t0 = time.time()
    n = 30
    for i in range(n):
        if ff is not None:
            predict.full_prediction(ff["image"], ff["depth"], ff["meta"],
                                    models, generator=seeded(i))
    fps = n / (time.time() - t0)
    results["serving"] = {"object_found": found,
                          "position_error_m": err,
                          "attribution": attribution,
                          "fps_host_loop_tunnel_bound": round(fps, 1)}
    print(json.dumps({"stage": "serving", **results["serving"]}), flush=True)

    io.write_json(os.path.join(root, "demo_results.json"), results)
    if args.artifact:
        io.write_json(os.path.abspath(args.artifact), results)
    return results


if __name__ == "__main__":
    main()
