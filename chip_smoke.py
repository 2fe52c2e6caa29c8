#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`autoposeestimation_tpu_torch`) on one
NVIDIA GPU and check it. Run from the repository root:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit; build every CUDA kernel of the path,
  2. forward moments kernel: `moments_cuda` against `moments_plain` on f64
     copies of the inputs (the f64 truth) at the evaluation shape, in the
     tie and degenerate-sphere cases (there also against the plain version
     in f32), and in phase 6's camera-depth, mirror-tie and near-coincident
     cases and the ground-truth pose at 0.6 m; its ptxas report (no
     spills), scan loop SASS (no branch) and launch geometry; timed with
     the host in the loop and queued ahead,
  3. serving: `full_prediction` at the headline geometry (5 classes,
     640x480, 1000 points, crop 320, 2 refine iterations, bf16, random
     weights from a seed) at emb_stride 8 and 2, frames/s,
  4. card vs CPU: the same f32 path at a small geometry on both devices,
  5. evaluation: `evaluate` over ADD-S batches in the JAX package's layout
     (img (B, S, S, 3); B=8, N=1000, M=500, crop 320, symmetric and
     non-symmetric samples); the kernel launch counts are read from this
     run, and the step is compared with the plain version on the card,
  6. training kernel: `moments_train_cuda` against `moments_train_plain` in
     both modes (f32, bf16) at the training shape and in the tie,
     degenerate-sphere and near-coincident cases; its ptxas report (no
     spills) and launch geometry; output hashes, timed with the host in
     the loop and queued ahead,
  7. training: `estimator_step`s and `refiner_step`s at full width (5
     objects, bf16, crop 320, B=8, N=1000, M=500, `sym_bf16`), ms per step,
     launch counts, device busy share; one estimator step through the
     kernel against one through the plain version; a short two-phase
     `train()` whose checkpoint the port's reader loads back,
  8. nearest-neighbour kernel: the ptxas report of its scan and merge
     kernels (no spills); `nn_cuda` against `nn_plain` on mm-scale clouds
     (N = M = 1024, 2048, 4096, 8192; N=1000 M=3000; 30 % and all
     references invalid; duplicated references; queries equal to
     references; clouds 500 mm from the origin; exact ties across the
     kernel's reference ranges; wholly invalid ranges), indices and d2
     equal; timed at N = M = 2048, 4096, 8192 with the host in the loop and
     with the host queued ahead (device and host time per call) against its
     bound, the plain version and `torch.cdist(...).min(1)`, with the
     ranges S and the grid, beside two tiny kernels back to back (the floor
     of a call of two kernels),
  9. reconstruction: a synthetic 640x480 dataset of 30 ring views of a
     40 mm ball with an 18 mm bump, `load_point_cloud` at the production
     settings of `create_pose_data` and `create_pose_label` (seconds,
     points per stage, nn launches per object and per ICP, PNG decode ms,
     the nn kernels' device time per object, device busy share of one ICP
     merge), one `load_point_cloud` with its own defaults (point-to-plane
     ICP and normals on the card), checks of the cloud against the
     rendered spheres and of the labels, the production run on the CPU
     (every ICP's size and iteration count and the cloud equal to the
     card's), and the small configuration (160x128, 12 views) on the card
     and on the CPU,
 10. training from a dataset: `App.train_pose_estimation` at full width
     through both phases from a written 5-object 640x480 dataset, with its
     artifact, resume and card-vs-CPU dataset checks and the Loader's and
     steps' timings,
 11. serving stream: `serve_stream` at batch 1 and at batch 4 (8 frames;
     6, a padded tail) against the single-frame graph in f32 at the
     headline geometry (found and masks equal, poses within POSE_ATOL);
     its dispatch and reads with host syncs forbidden; frames/s of
     `full_prediction` and `serve_stream` at batch 1 and 4 in bf16 at
     emb_stride 8 and 2 (3 alternating rounds of 24 frames, medians),
     kernels per call, busy share, peak memory, the graph's host dispatch
     time, the U-Net's batch drift and device time by input layout; the
     live loop (`App.run_live_prediction`, blocking and pipelined) and the
     grasp flow (`grasping.get_predictions` through 5 view points, each
     `get_robot2object` against an f64 recomputation, `execute_grasp`)
     with a FakeDepthCam and a FakeRobot; after phase 16, on the demo's
     trained checkpoints, `_predict_batch` over 4 frames against
     `_predict_frame` on 8 held-out frames with the same draws: in bf16
     the shares of argmax pixels, found flags and mask pixels that differ,
     each class's mask IoU and ADD(-S) in both modes; in f32 found and
     masks equal, poses within POSE_ATOL (one `serving stream batch 4
     against single frames, trained weights {...}` line),
 12. segmentation training: `App.train_segmentation` for 2 epochs on a
     written 5-object 640x480 dataset with `SegConfig` defaults (U-Net
     ResNet34, batch 4, 480 crops, Adam 1e-4, bf16, 4 Loader threads), its
     checkpoint read back and serving one `full_prediction`; one f32
     `train_step` on the card against the same step on the CPU; a
     background-subtraction-style run (7 channels, 2 classes, SGD with the
     plateau, the CCA metric) on synthetic batches; LinkNet and PSPNet-seg
     forward against the CPU; s per epoch, Loader-fed and staged ms per
     step, Loader samples/s at 0 and 4 workers, the host's ms per sample
     (decode, jitter, rotate, crop-and-zoom), busy share, top device
     operations and peak memory (one `segmentation training {...}` line),
 13. offline labeling: on a written 5-object 640x480 dataset (20 views a
     run; obj1 also turned by 180 degrees and an `extra` run in that pose),
     `App.create_labels` in 'gen' mode (every label's IoU against the
     rendered mask above 0.6; 5 labels against the CPU's, equal but for
     pixels at the threshold or in a component whose floored mean score is
     within 1e-4 of an integer), the background-subtraction U-Net trained
     for an epoch (`BSDataset`, 7 channels, 2 classes, SGD, 4 Loader
     threads) and its 'pred' labels (3 against the CPU's, equal but for
     near-tie pixels), `App.create_dataset` and 6 epochs of
     `App.train_segmentation` (Adam 1e-3), then `App.create_pose_data`
     without and with global registration (per-phase times, nn calls per
     object, RANSAC ms and fitness, the turned run's rotation error and a
     hash of its new_pred labels), and
     the turned object's Phases B and C with global registration at
     320x240 on the card and the CPU: the same drawn hypotheses, clouds
     and labels within 1e-3 (one `offline labeling {...}` line),
 14. host shells and experiments: `collect_and_calibrate` through a
     FakeRobot's 10 stations (the board poses of a known X patched in: no
     cv2 on this machine), X within 1e-5 / 0.01 mm and its handEye_tf.json;
     `App.acquire_new_data_from_object` with a 640x480 FakeDepthCam and a
     travelling FakeRobot on a 12-view ring path with via points (views,
     extra samples, every robot2endEff_tf within 1e-3 mm of an f64
     recomputation), `fix_symmetric`, `clean_extra_data`, `App.create_labels`
     'gen' (IoU against the renders above 0.6) and `gt_test`; `eval_ycb`
     (21 objects, 16 frames of 3) and `eval_linemod` (objects 1 and 2, 16
     frames each) at DFConfig defaults on written 640x480 trees, a batch of
     each again with the plain moments (dis within 1e-5); the sweeps
     (`train_pose_estimation_exp` over p_viewpoints 1.0 and 0.5, one epoch
     each, `eval_exp`, `plot_pose_exp_results`) on phase 10's dataset; and
     `App.main` with scripted input (one `host shells and experiments
     {...}` line),
 15. the U-Net's out_stride and parallelism: the f32 frame graph at
     seg_out_stride 4 on the card against the CPU (masks equal, poses
     within POSE_ATOL); bf16 frames/s of `full_prediction` and
     `serve_stream(batch=4)` at the headline geometry at strides 1 and 4
     (3 alternating rounds) and the U-Net's device time at each; then on a
     one-rank NCCL group, whose mesh runs every collective, the full-width
     `train()` with data_parallel 'on' against 'off' (parameters equal,
     deterministic algorithms; ms per staged estimator step in each mode),
     one segmentation `train_step` with synced BatchNorm 'on' against
     'off', `load_point_cloud(mesh=)` against the streaming run on phase
     9's 160x128 configuration and `dryrun_multichip(1, "product")`; with
     two cards also `dryrun_multichip(2, "product")` on NCCL and both
     trainers on 2 NCCL ranks against one (`parallel/trainers.py` at
     product shapes: DenseFusion's parameters within Adam's 2 lr a step,
     its loss and gradient norm within 1e-2, its best test distance beside
     a second one-rank run's; the segmentation trainer's parameters within
     1e-4, its IoU within 2e-2; samples a second of each) (one `parallel
     and out_stride {...}` line, with the ranks that ran).
 16. the train stages and serving prefixes, FLOP counts and profiling,
     then the demo: the
     seven train stages (`utils/train_stages.py`) at full width (5
     objects, B=8, N=1000, M=500, crop 320, bf16) and the five serving
     prefixes (`utils/serving_stages.py`) at the headline geometry at
     seg_out_stride 1 and 4, each timed over 20 dependent calls between
     CUDA events, with its FLOPs (`utils/flops.py`), TF/s and rows 1-2's
     launches; the loss stages' kernels against their plain versions on
     the stages' inputs; the counts beside the JAX package's
     (`artifacts/flops_cache.json`, read as data), the convolution-bound
     ones within 5 %; `maybe_profile` around one estimator step (its trace
     names the training kernel); `scripts/train_multi_demo` at the
     headline geometry cut to 8 views, 1 segmentation and 2 pose epochs,
     then `attribute_serving` and `mask_iou` over 4 held-out frames (one
     `stages and demo {...}` line),
 17. the graft entry: `graft_entry.entry()` on the card in bf16 (the
     flagship frame graph at 2 classes, 500 points, crop 160, 640x480),
     its outputs checked as a served frame's, its time with the host in
     the loop, device time and launches a call (profiler); `entry()` in
     f32 on the card against the CPU (found equal, poses within
     POSE_ATOL, argmax and masks equal but at a 1e-4 tie) (one `graft
     entry {...}` line, with the card's name and power limit).
With `--nn-timing ROOT` it runs only phase 8's timing, of the port in the
checkout at ROOT, and prints it as one JSON line: run it on two checkouts
back to back on one card to compare them alike. `--train-timing ROOT` does
the same for phase 6's training kernel, with a SHA-256 of its output on
every case in both modes (equal hashes: equal outputs, bit for bit), and
`--moments-timing ROOT` for phase 2's forward kernel, with its errors
against the f64 truth on every case.
Then one JSON line with the kernels' numbers, and last the JSON result line.
Needs no network; imports nothing of JAX.
"""
import contextlib
import functools
import hashlib
import itertools
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

# cuBLAS is deterministic under torch.use_deterministic_algorithms only with
# a fixed workspace, set before its first use (phase 10's resume check)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch  # noqa: E402

# f32 comparisons need full-precision matmuls and convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True

DIS_ATOL = 1e-5   # the moments' tolerances of tests/test_pallas_addloss.py
STD_ATOL = 1e-4
PRE_ATOL = 1e-5   # training precursors, but for near-tie flips (<= 0.1 %)
POSE_ATOL = 1e-4  # card vs CPU, f32 with TF32 off


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of `fn` on the card over `reps` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int, clock_mhz: float, warmup: int = 2):
    """(device ms, host ms) per call of `fn` over `reps` calls queued back
    to back (CUDA events; host clock). A sleep kernel holds the stream
    until the host has queued every call, so the device time leaves out the
    host's own time per call (the wrapper, the launches), which is the
    second number."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    sleep_s = 3 * (time.perf_counter() - t0) + 2e-3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # the sleep counts SM clocks: at most the maximum clock, so it lasts at
    # least sleep_s
    torch.cuda._sleep(int(sleep_s * clock_mhz * 1e6))
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queued_s = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    check(queued_s < sleep_s, f"the host queued for {queued_s} s, longer "
          f"than the {sleep_s} s head start")
    return start.elapsed_time(end) / reps, 1e3 * queued_s / reps


def profile(fn, label: str, per: int, wall_ms: float,
            kernels: tuple = ()):
    """Device time that torch.profiler sees during `fn`, per unit (`per`
    units in the call), with the kernel count, the top kernels and the
    device's busy share of `wall_ms`, the unit's time measured without the
    profiler; and the device time and count of the kernels whose names
    contain one of `kernels`. Returns (device ms, kernels) per unit, None
    when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernels only: the CPU-side aten ops carry their kernels' time too,
    # and a user annotation's span on the device (`Optimizer.step#...`)
    # covers its kernels and the gaps between them
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    if not events:
        print(f"profile {label}: the profiler saw no device time")
        return None
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / per
    launched = sum(e.count for e in events) / per
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profile {label}: device busy {device_ms:.4f} ms of "
          f"{wall_ms:.4f} ms ({100 * device_ms / wall_ms:.1f}% busy), "
          f"{launched:.0f} kernels per unit; top: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3 / per:.4f} ms"
              for e in top))
    for name in kernels:
        hits = [e for e in events if name in e.key]
        count = sum(e.count for e in hits) / per
        hit_ms = sum(e.self_device_time_total for e in hits) / 1e3 / per
        print(f"profile {label}: {name} {count:.0f} launches, {hit_ms:.4f} "
              f"ms device time per unit")
    return device_ms, launched


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --- phase 2: kernels --------------------------------------------------------

def moment_cases(dev):
    """(name, rot, pred_t, model, target) at the evaluation shape, plus a
    wrap-padded tie case and a near-degenerate sphere."""
    from autoposeestimation_tpu_torch.utils import transforms as T

    rng = np.random.default_rng(0)
    b, n, m = 8, 1000, 500

    def tensors(quat, trans, points, model, target):
        ts = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
              .contiguous() for a in (quat, trans, points, model, target)]
        rot = T.quat_to_mat(ts[0]).contiguous()
        return rot, (ts[2] + ts[1]).contiguous(), ts[3], ts[4]

    model = rng.normal(size=(b, m, 3)) * 0.05
    rot = T.quat_to_mat(torch.as_tensor(rng.normal(size=(b, 4)))).numpy()
    target = np.einsum("bmj,bij->bmi", model, rot) + [0.01, 0.0, 0.02]
    cases = [("eval_shape",) + tensors(
        rng.normal(size=(b, n, 4)), rng.normal(size=(b, n, 3)) * 0.01,
        rng.normal(size=(b, n, 3)) * 0.1, model, target)]
    ties = target[:, np.arange(m) % 383]
    cases.append(("ties",) + tensors(
        rng.normal(size=(b, n, 4)), rng.normal(size=(b, n, 3)) * 0.01,
        rng.normal(size=(b, n, 3)) * 0.1, model, ties))
    i = np.arange(m) + 0.5
    phi, theta = np.arccos(1 - 2 * i / m), np.pi * (1 + 5 ** 0.5) * i
    sphere = np.stack([np.sin(phi) * np.cos(theta),
                       np.sin(phi) * np.sin(theta), np.cos(phi)], 1) * 0.05
    grown = sphere @ rot[0].T * (0.051 / 0.05)
    quat = np.tile([1.0, 0, 0, 0], (1, n, 1)) + rng.normal(size=(1, n, 4)) \
        * 1e-3
    cases.append(("degenerate",) + tensors(
        quat, rng.normal(size=(1, n, 3)) * 1e-5, np.zeros((1, n, 3)),
        sphere[None], grown[None]))
    return cases


PLAIN_GATED = ("eval_shape", "ties", "degenerate")   # moment_cases' names


def forward_cases(dev):
    """Phase 2's cases: `moment_cases`, then phase 6's camera-depth,
    mirror-tie and near-coincident cases and the ground-truth pose."""
    return moment_cases(dev) + [camera_case(dev), mirror_case(dev),
                                coincident_case(dev), ground_truth_case(dev)]


def f64_truth(rot, pred_t, model, target):
    """(dis, var) of `moments_plain` on f64 copies of the inputs."""
    from autoposeestimation_tpu_torch.ops import addloss

    return addloss.moments_plain(*(a.double() for a in (rot, pred_t, model,
                                                        target)))


def moment_errors(got, want) -> tuple:
    """(max |dis error|, max |std error|) of two (dis, var) pairs."""
    (dis_a, var_a), (dis_b, var_b) = got, want
    return ((dis_a.double() - dis_b.double()).abs().max().item(),
            (var_a.double().clamp(min=0).sqrt()
             - var_b.double().clamp(min=0).sqrt()).abs().max().item())


MOMENTS_TIMED = ("eval_shape", "camera_depth")   # both at B=8, N=1000, M=500


def clock_under_load(fn, calls: int) -> str:
    """nvidia-smi's SM clock and power draw, read while `calls` queued calls
    of `fn` keep the card busy (the queue fills, so the read falls in the
    last few hundred calls)."""
    for _ in range(calls):
        fn()
    reading = nvidia_smi("clocks.sm,power.draw")
    torch.cuda.synchronize()
    return reading


def moments_timing(dev, clock_mhz: float, moments_cuda) -> dict:
    """`moments_cuda`'s largest errors against the f64 truth on each case of
    `forward_cases`, and its time on the cases in MOMENTS_TIMED with the
    host in the loop (`cuda_ms`) and with the host queued ahead
    (`queued_ms`: `device_ms`, `host_ms`). Uses only `moments_cuda`, so it
    times earlier versions of the port too (`--moments-timing`)."""
    errors, times = {}, {}
    for name, rot, pred_t, model, target in forward_cases(dev):
        def call():
            return moments_cuda(rot, pred_t, model, target)

        err = moment_errors(call(), f64_truth(rot, pred_t, model, target))
        errors[name] = {"dis": err[0], "std": err[1]}
        if name in MOMENTS_TIMED:
            device_ms, host_ms = queued_ms(call, 20, clock_mhz)
            times[name] = {"cuda_ms": cuda_ms(call, 20),
                           "device_ms": device_ms, "host_ms": host_ms,
                           "clock_under_load": clock_under_load(call, 4000)}
    return {"errors": errors, "timing": times}


def moments_kernel_report(b: int, n: int, m: int) -> dict:
    """ptxas's report of the forward kernel (no spills), its scan loop's
    SASS (no branch), and the launch's geometry at (b, n, m)."""
    import ctypes
    import re

    from autoposeestimation_tpu_torch.ops import addloss, kernel_build

    path = kernel_build.build(addloss.KERNEL)
    report = re.findall(
        r"Compiling entry function '\w*sym_moments_kernel\w*'"
        r".*?(\d+) bytes spill stores, (\d+) bytes spill loads"
        r".*?Used (\d+) registers",
        path.with_name(path.name + ".log").read_text(), re.S)
    check(len(report) == 1, f"ptxas report {report}")
    stores, loads, regs = report[0]
    check(stores == loads == "0", f"sym_moments: spills {stores}, {loads}")
    loop = scan_loop_sass(path).get("forward")
    if loop:
        print(f"sass sym_moments: scan loop of {loop['instructions']} "
              f"instructions for {loop['pairs']} pairs ({loop['per_pair']:.2f}"
              f" a pair), {loop['branches']} conditional branches besides "
              f"its back edge; {loop['ops']}")
        check(loop["branches"] == 0, "sym_moments: a branch in the scan loop")
    lib = ctypes.CDLL(str(path))
    per_sm = lib.sym_moments_blocks_per_sm(m)
    check(per_sm > 0, f"sym_moments_blocks_per_sm: {per_sm}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib.sym_moments_smem_bytes.restype = ctypes.c_size_t
    smem_bytes = lib.sym_moments_smem_bytes(m)
    print(f"ptxas sym_moments: {regs} registers, 0 bytes spilled; at B={b} "
          f"N={n} M={m}: {smem_bytes} bytes of dynamic shared memory, "
          f"{per_sm} blocks per SM, grid ({n}, {b}) x 128 threads, "
          f"{b * n / (per_sm * sms):.2f} waves")
    return {"registers": int(regs), "smem_bytes": smem_bytes,
            "blocks_per_sm": per_sm, "grid": [n, b],
            "waves": b * n / (per_sm * sms),
            "sass_per_pair": loop["per_pair"] if loop else None}


def kernel_phase(dev, clock_mhz: float):
    from autoposeestimation_tpu_torch.ops import addloss

    worst = 0.0
    for name, rot, pred_t, model, target in forward_cases(dev):
        got = addloss.moments_cuda(rot, pred_t, model, target)
        plain = addloss.moments_plain(rot, pred_t, model, target)
        exact = f64_truth(rot, pred_t, model, target)
        torch.cuda.synchronize()
        check(torch.isfinite(got[0]).all().item(), f"{name}: non-finite dis")
        err_dis, err_std = moment_errors(got, exact)
        plain_dis, plain_std = moment_errors(plain, exact)
        check(err_dis <= DIS_ATOL, f"{name}: dis error {err_dis} (f64)")
        check(err_std <= STD_ATOL, f"{name}: std error {err_std} (f64)")
        line = (f"kernel sym_moments {name} {tuple(rot.shape[:2])} "
                f"M={model.shape[1]}: against the f64 truth max|dis err| "
                f"{err_dis:.3e} max|std err| {err_std:.3e} (plain f32: "
                f"{plain_dis:.3e}, {plain_std:.3e})")
        worst = max(worst, err_dis, err_std)
        if name in PLAIN_GATED:
            vs_dis, vs_std = moment_errors(got, plain)
            check(vs_dis <= DIS_ATOL, f"{name}: dis error {vs_dis}")
            check(vs_std <= STD_ATOL, f"{name}: std error {vs_std}")
            line += (f"; against the plain version max|dis err| "
                     f"{vs_dis:.3e} max|std err| {vs_std:.3e}")
            worst = max(worst, vs_dis, vs_std)
        print(line)

    _, rot, pred_t, model, target = moment_cases(dev)[0]
    b, n = rot.shape[:2]
    m = model.shape[1]
    geometry = moments_kernel_report(b, n, m)
    timing = moments_timing(dev, clock_mhz, addloss.moments_cuda)["timing"]
    for name, t in timing.items():
        print(f"kernel sym_moments {name} timing: {t['cuda_ms']:.4f} ms with "
              f"the host in the loop, {t['device_ms']:.4f} ms device and "
              f"{t['host_ms']:.4f} ms host time queued ahead; SM clock and "
              f"power under load {t['clock_under_load']}")
    ms = timing["eval_shape"]["cuda_ms"]
    device_ms = timing["eval_shape"]["device_ms"]
    plain_ms = cuda_ms(
        lambda: addloss.moments_plain(rot, pred_t, model, target), 3, 1)
    # least work: 4 FP32 instructions per point pair (the expansion form's
    # 3 FMA + 1 min) at 128 FP32 lanes per SM per clock, the FP32 peak
    # outside the tensor cores (67 TFLOP/s at 1980 MHz, an FMA counted as 2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ops = 4.0 * b * n * m * m
    ops_ms = ops / (sms * 128 * clock_mhz * 1e6) * 1e3
    nbytes = 4 * (b * n * 12 + 2 * b * m * 3 + 2 * b * n)
    bytes_ms = nbytes / 3.35e12 * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"kernel sym_moments timing at B={b} N={n} M={m}: {ms:.4f} ms, "
          f"device {device_ms:.4f} ms ({100 * bound_ms / device_ms:.1f}% of "
          f"the bound), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({ops:.3e} ops at {sms} SMs x 128 lanes x {clock_mhz} MHz)")
    return {
        "name": "sym_moments", "route": "cuda",
        "source": "autoposeestimation_tpu_torch/csrc/sym_moments.cu",
        "replaces": "autoposeestimation_tpu/ops/pallas_addloss.py:71",
        "launches": None, "max_abs_err": worst, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None, "device_ms": device_ms,
        "sass_per_pair": geometry["sass_per_pair"], "geometry": geometry,
    }


# --- phase 3: serving --------------------------------------------------------

def headline_frames():
    from autoposeestimation_tpu_torch.utils import synthetic
    from autoposeestimation_tpu_torch.utils.io import Intrinsics

    cfg, spheres, model_points = synthetic.headline_scene()
    cams = synthetic.ring_cameras(cfg, np.zeros(3))[:4]
    frames = []
    for cam in cams:
        color, depth, owner = synthetic.render(cfg, cam, spheres)
        frames.append((color, np.round(depth).astype(np.uint16), owner))
    meta = {"intr": Intrinsics(width=640, height=480, ppx=320.0, ppy=240.0,
                               fx=cfg.fx, fy=cfg.fy),
            "depth_scale": cfg.depth_scale}
    return frames, meta, model_points, tuple(s.name for s in spheres)


def check_prediction(out, hw) -> None:
    check(set(out) == {"predictions", "cca_converged", "elapsed_times"},
          f"full_prediction keys {set(out)}")
    for cls, p in out["predictions"].items():
        check(p["mask"].shape == hw, f"{cls}: mask shape")
        check(np.isfinite(p["position"]).all(), f"{cls}: position")
        check(abs(np.linalg.norm(p["rotation"]) - 1.0) < 1e-3,
              f"{cls}: quaternion norm")


def serving_phase(dev) -> None:
    from autoposeestimation_tpu_torch.pipeline import predict

    frames, meta, model_points, classes = headline_frames()
    for stride in (8, 2):
        models = predict.build_models(
            len(classes), model_points, classes, num_points=1000, crop=320,
            refine_iters=2, dtype=torch.bfloat16, emb_stride=stride,
            device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        for color, depth, _ in frames[:2]:          # warm-up
            predict.full_prediction(color, depth, meta, models,
                                    generator=gen)
        # three windows of 8 frames: their spread is the host's noise
        n_frames, fps = 8, []
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [predict.full_prediction(frames[i % 4][0],
                                            frames[i % 4][1], meta, models,
                                            generator=gen)
                    for i in range(n_frames)]
            fps.append(n_frames / (time.perf_counter() - t0))
            for out in outs:
                check_prediction(out, (480, 640))
        clocks = nvidia_smi("clocks.sm,power.draw")
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        color, depth, owner = frames[0]
        for i, cls in enumerate(classes):
            p = predict.pose_from_mask(color, depth, meta, models,
                                       owner == i, cls, generator=gen)
            check(p["count"] > 0, f"{cls}: empty mask")
            check(np.isfinite(p["position"]).all(), f"{cls}: position")
            check(abs(np.linalg.norm(p["rotation"]) - 1.0) < 1e-3,
                  f"{cls}: quaternion norm")
        median = float(np.median(fps))
        print(f"serving emb_stride={stride}: 640x480 frames/s in 3 windows "
              f"of {n_frames} frames {[round(f, 4) for f in fps]}, median "
              f"{median:.4f} ({1e3 / median:.4f} ms/frame), found per frame "
              f"{[len(o['predictions']) for o in outs[:4]]}, peak memory "
              f"{peak_gib:.3f} GiB, SM clock and power after: {clocks}")
        profile(lambda: [predict.full_prediction(c, d, meta, models,
                                                 generator=gen)
                         for c, d, _ in frames],
                f"serving emb_stride={stride}, per frame", len(frames),
                1e3 / median)


# --- phase 4: card vs CPU ----------------------------------------------------

def card_vs_cpu_phase(dev, seg_out_stride: int = 1) -> float:
    """The f32 frame graph at 96x128 on the card and the CPU: masks,
    found, argmax equal, poses within POSE_ATOL; the largest pose error."""
    from autoposeestimation_tpu_torch.pipeline import predict
    from autoposeestimation_tpu_torch.utils import synthetic
    from autoposeestimation_tpu_torch.utils.io import Intrinsics

    h, w = 96, 128
    cfg = synthetic.SynthConfig(img_h=h, img_w=w, fx=220.0, fy=220.0)
    spheres = [synthetic.SphereObject("a", np.asarray([40.0, 0.0, 35.0]),
                                      35.0, (200, 40, 40)),
               synthetic.SphereObject("b", np.asarray([-50.0, 30.0, 28.0]),
                                      28.0, (40, 60, 200))]
    color, depth, owner = synthetic.render(
        cfg, synthetic.ring_cameras(cfg, np.zeros(3))[0], spheres)
    meta = {"intr": Intrinsics(width=w, height=h, ppx=w / 2, ppy=h / 2,
                               fx=cfg.fx, fy=cfg.fy), "depth_scale": 0.001}
    mp = np.random.default_rng(1).normal(size=(2, 60, 3)) * 0.05
    u = np.random.default_rng(2).random((2, 64)).astype(np.float32)
    outs = {}
    for d in (dev, torch.device("cpu")):
        models = predict.build_models(2, mp, ("a", "b"), num_points=64,
                                      crop=32, dtype=torch.float32, seed=3,
                                      seg_out_stride=seg_out_stride,
                                      device=d)
        with torch.inference_mode():
            frame = predict._frame_inputs(color, depth, meta, d)
            raw = predict._predict_frame(models, *frame,
                                         torch.as_tensor(u, device=d))
        outs[d.type] = (
            {k: v.cpu().numpy() for k, v in raw.items()},
            predict.pose_from_mask(color, depth, meta, models, owner == 1,
                                   "b", uniforms=u[1]))
    (gpu, gpu_pfm), (cpu, cpu_pfm) = outs["cuda"], outs["cpu"]
    for name in ("found", "masks", "argmax", "cca_converged"):
        check(np.array_equal(gpu[name], cpu[name]), f"card vs CPU: {name}")
    for name in ("quats", "positions"):
        err = np.abs(gpu[name] - cpu[name]).max()
        check(err <= POSE_ATOL, f"card vs CPU: {name} error {err}")
    check(gpu_pfm["count"] == cpu_pfm["count"], "card vs CPU: count")
    for name in ("position", "rotation"):
        err = np.abs(gpu_pfm[name] - cpu_pfm[name]).max()
        check(err <= POSE_ATOL, f"card vs CPU: pose_from_mask {name} {err}")
    err = max(np.abs(gpu[n] - cpu[n]).max() for n in ("quats", "positions"))
    print(f"card vs CPU (f32, 96x128, seg_out_stride={seg_out_stride}): "
          f"masks/found/argmax equal, found {gpu['found'].tolist()}, max "
          f"pose error {err:.3e}")
    return float(err)


# --- phase 5: evaluation -----------------------------------------------------

def eval_batches(dev, model_points, n_batches=4, b=8, n=1000, m=500,
                 crop=320):
    """ADD(-S) test batches in the JAX package's layout (img (B, S, S, 3)),
    as tensors on `dev`: objects at ~0.6 m in the camera frame, every other
    sample symmetric."""
    from autoposeestimation_tpu_torch.utils import transforms as T

    rng = np.random.default_rng(4)
    batches = []
    for _ in range(n_batches):
        obj = np.arange(b) % len(model_points)
        model = model_points[obj][:, :m]
        rot = T.quat_to_mat(torch.as_tensor(rng.normal(size=(b, 4)))).numpy()
        trans = rng.normal(size=(b, 3)) * 0.05 + [0.0, 0.0, 0.6]
        target = np.einsum("bmj,bij->bmi", model, rot) + trans[:, None]
        cloud = target[:, rng.integers(0, m, n)] \
            + rng.normal(size=(b, n, 3)) * 0.002
        # the Loader's layout: img channels last
        arrays = {"img": np.ascontiguousarray(np.moveaxis(
                      rng.normal(size=(b, 3, crop, crop)), 1, -1)),
                  "cloud": cloud, "target": target, "model_points": model,
                  "target_t": trans}
        batch = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                 for k, v in arrays.items()}
        batch["choose"] = torch.as_tensor(
            rng.integers(0, crop * crop, (b, n)), device=dev)
        batch["obj_idx"] = torch.as_tensor(obj, device=dev)
        batch["is_sym"] = torch.as_tensor(np.arange(b) % 2 == 0, device=dev)
        batches.append(batch)
    return batches


def eval_phase(dev):
    from autoposeestimation_tpu_torch.experiments.eval import evaluate
    from autoposeestimation_tpu_torch.models.common import init_like_flax
    from autoposeestimation_tpu_torch.models.densefusion import (
        PoseNet, PoseRefineNet)
    from autoposeestimation_tpu_torch.ops import addloss
    from autoposeestimation_tpu_torch.train import densefusion as dft
    from autoposeestimation_tpu_torch.utils import synthetic

    _, spheres, model_points = synthetic.headline_scene()
    classes = tuple(s.name for s in spheres)
    gen = torch.Generator().manual_seed(5)
    posenet, refiner = PoseNet(5, torch.bfloat16), PoseRefineNet(
        5, torch.bfloat16)
    for net in (posenet, refiner):
        init_like_flax(net, gen)
        net.requires_grad_(False).eval().to(dev)
    state = dft.EvalModels(posenet, refiner)
    batches = eval_batches(dev, model_points)

    # the main path: counts from 0 just before, read just after
    addloss.moments_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = evaluate(state, lambda: iter(batches), classes)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    launches = addloss.moments_cuda.launches
    check(launches == len(batches), f"sym_moments launches {launches}")
    check(results["overall"]["n"] == 8 * len(batches), "evaluated samples")
    for cls in classes:
        check(np.isfinite(results[cls]["dis"]), f"{cls}: dis")

    t0 = time.perf_counter()
    evaluate(state, lambda: iter(batches), classes)
    torch.cuda.synchronize()
    steady_ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    profile(lambda: evaluate(state, lambda: iter(batches), classes),
            "evaluation, per batch", len(batches), steady_ms)
    batch = dft.to_device(batches[0], dev)
    got = dft.eval_step_full(posenet, refiner, batch, state.w)
    with mock.patch.object(addloss, "moments_cuda", addloss.moments_plain):
        want = dft.eval_step_full(posenet, refiner, batch, state.w)
    err = (got[0] - want[0]).abs().max().item()
    check(err <= DIS_ATOL, f"eval step, kernel vs plain: dis error {err}")
    for g, w_ in zip(got[1:], want[1:]):
        check(torch.equal(g, w_), "eval step, kernel vs plain: pose")
    print(f"evaluation B=8 N=1000 M=500 crop 320 bf16, {len(batches)} "
          f"batches: first run {first_ms:.4f} ms/batch, second run "
          f"{steady_ms:.4f} ms/batch, sym_moments launches {launches} in "
          f"the first run, overall p "
          f"{results['overall']['p']}, kernel vs plain max|dis err| "
          f"{err:.3e}")
    return launches, err


# --- phase 6: training kernel ------------------------------------------------

def camera_case(dev, b=8, n=1000, m=500):
    """Training-like candidates at the batches' 0.6 m camera depth: the
    poses scatter around the true one and each translation is a cloud
    point plus a small offset, as in `pose_loss`. In bf16 mode bf16(0.6)
    steps by 3.9e-3, so exact ties across targets are common here."""
    from autoposeestimation_tpu_torch.utils import transforms as T

    rng = np.random.default_rng(10)
    q_true = rng.normal(size=(b, 4))
    q_true /= np.linalg.norm(q_true, axis=1, keepdims=True)
    rot_true = T.quat_to_mat(torch.as_tensor(q_true)).numpy()
    model = rng.normal(size=(b, m, 3)) * 0.05
    target = np.einsum("bmj,bij->bmi", model, rot_true) + [0.0, 0.0, 0.6]
    cloud = np.take_along_axis(target, rng.integers(0, m, (b, n, 1)), 1) \
        + rng.normal(size=(b, n, 3)) * 0.002
    quat = q_true[:, None] + rng.normal(size=(b, n, 4)) * 0.1
    pred_t = cloud + rng.normal(size=(b, n, 3)) * 0.01
    f32 = [torch.as_tensor(np.asarray(a, np.float32), device=dev).contiguous()
           for a in (quat, pred_t, model, target)]
    return ("camera_depth", T.quat_to_mat(f32[0]).contiguous(), *f32[1:])


def mirror_case(dev, b=8, n=1000, m=500):
    """Exact ties between distinct targets at camera depth: the model lies
    in the plane x = 0, the candidates rotate about the x axis, and the
    targets come in pairs (+-a, y, z), so every predicted point is exactly
    as far from both members of its nearest pair, in either mode's
    arithmetic. The tie average then has x = 0, where the first match
    would not."""
    rng = np.random.default_rng(11)
    model = np.concatenate([np.zeros((b, m, 1)),
                            rng.normal(size=(b, m, 2)) * 0.05], 2)
    half = rng.normal(size=(b, m // 2, 3)) * 0.05
    target = np.concatenate([half, half * [-1.0, 1.0, 1.0]], 1) \
        + [0.0, 0.0, 0.6]
    theta = rng.normal(size=(b, n)) * 0.3
    c, s = np.cos(theta), np.sin(theta)
    one, zero = np.ones_like(c), np.zeros_like(c)
    rot = np.stack([one, zero, zero, zero, c, -s, zero, s, c], -1) \
        .reshape(b, n, 3, 3)
    pred_t = np.concatenate([np.zeros((b, n, 1)),
                             rng.normal(size=(b, n, 2)) * 0.01], 2) \
        + [0.0, 0.0, 0.6]
    return ("mirror_ties",) + tuple(
        torch.as_tensor(np.asarray(a, np.float32), device=dev).contiguous()
        for a in (rot, pred_t, model, target))


def coincident_case(dev):
    """Each predicted point ~2e-4 m from its target, under the expansion
    form's rounding floor."""
    rng = np.random.default_rng(9)
    model = rng.normal(size=(1, 500, 3)) * 0.05
    pred_t = np.asarray([0.1, 0.0, 0.0]) + rng.normal(size=(1, 1000, 3)) \
        * 1e-4
    return ("coincident",
            torch.eye(3, device=dev).expand(1, 1000, 3, 3).contiguous(),
            *(torch.as_tensor(a.astype(np.float32), device=dev)
              for a in (pred_t, model, model + [0.1, 0.0, 0.0])))


def ground_truth_case(dev, b=8, n=1000, m=500):
    """Every candidate at its sample's true pose at the 0.6 m camera depth:
    each matched distance is the f32 rounding of the inputs (~1e-8 m),
    where the expansion form in the camera frame floors near 1e-4 m."""
    from autoposeestimation_tpu_torch.utils import transforms as T

    rng = np.random.default_rng(13)
    rot = T.quat_to_mat(torch.as_tensor(rng.normal(size=(b, 4)))).numpy()
    model = rng.normal(size=(b, m, 3)) * 0.05
    trans = rng.normal(size=(b, 3)) * 0.05 + [0.0, 0.0, 0.6]
    target = np.einsum("bmj,bij->bmi", model, rot) + trans[:, None]
    return ("ground_truth",) + tuple(
        torch.as_tensor(np.asarray(a, np.float32), device=dev).contiguous()
        for a in (np.broadcast_to(rot[:, None], (b, n, 3, 3)),
                  np.broadcast_to(trans[:, None], (b, n, 3)), model, target))


def train_cases(dev):
    """(name, rot, pred_t, model, target): phase 6's cases, the training
    shape (B=8, N=1000, M=500) first."""
    return moment_cases(dev) + [camera_case(dev), mirror_case(dev),
                                coincident_case(dev)]


TRAIN_TIMED = ("eval_shape", "camera_depth")   # both at B=8, N=1000, M=500


def train_timing(dev, clock_mhz: float, moments_train_cuda) -> dict:
    """The SHA-256 of `moments_train_cuda`'s output bytes on each case of
    `train_cases` in both modes (f32, bf16), and its time on the cases in
    TRAIN_TIMED with the host in the loop (`cuda_ms`) and with the host
    queued ahead (`queued_ms`: `device_ms`, `host_ms`). Uses only
    `moments_train_cuda`, so it times earlier versions of the port too
    (`--train-timing`); equal hashes are equal outputs, bit for bit."""
    import hashlib

    hashes, times = {}, {}
    for name, rot, pred_t, model, target in train_cases(dev):
        for bf16 in (False, True):
            key = f"{name} {'bf16' if bf16 else 'f32'}"

            def call():
                return moments_train_cuda(rot, pred_t, model, target, bf16)

            hashes[key] = hashlib.sha256(
                call().cpu().numpy().tobytes()).hexdigest()
            if name in TRAIN_TIMED:
                device_ms, host_ms = queued_ms(call, 20, clock_mhz)
                times[key] = {"cuda_ms": cuda_ms(call, 20),
                              "device_ms": device_ms, "host_ms": host_ms}
    return {"sha256": hashes, "timing": times}


def scan_loop_sass(path) -> dict:
    """The scan loop of a built moments kernel (`cuobjdump -sass`): per mode
    of the training kernel ("bf16", "f32") or of the forward kernel
    ("forward"), its static instructions (every path of its body), point
    pairs, instructions a pair, conditional branches other than its back
    edge, and its opcodes. A pair costs one FMUL in the training kernel's
    modes and in the direct form, and three FFMA in the expansion form
    without an FMUL; pairs = max(FMUL, FFMA / 3) counts either. Empty
    without cuobjdump."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    found = {}

    def pairs_of(names):
        return max(names.count("FMUL"), names.count("FFMA") // 3)

    for body in re.split(r"\n\s*Function : ", text)[1:]:
        head = body.split()[0]
        mode = re.search(r"sym_moments_train_kernelILb(\d)", head)
        if mode:
            key = "bf16" if mode.group(1) == "1" else "f32"
        elif "sym_moments_kernel" in head:
            key = "forward"
        else:
            continue
        code, at = [], {}
        for line in body.splitlines():
            ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if ins:
                at[int(ins.group(1), 16)] = len(code)
                code.append(ins.group(2))
        # a loop: a branch back to an earlier (or its own) address
        loops = []
        for end, ins in enumerate(code):
            jump = re.search(r"\bBRA\s+(?:`\()?(0x[0-9a-f]+)", ins)
            if jump and at.get(int(jump.group(1), 16), end + 1) <= end:
                loops.append((at[int(jump.group(1), 16)], end))

        def ops(loop):
            return [re.sub(r"^@!?U?P\w+\s+", "", code[k]).split()[0]
                    .split(".")[0] for k in range(loop[0], loop[1] + 1)]

        # the scan: an innermost loop that reads shared memory and neither
        # stages (LDG, STS) nor divides or reduces (MUFU, SHFL)
        scans = [lp for lp in loops
                 if not any(lp[0] <= a and e <= lp[1] and (a, e) != lp
                            for a, e in loops)
                 and "LDS" in ops(lp)
                 and not {"LDG", "STS", "MUFU", "SHFL"} & set(ops(lp))]
        check(bool(scans), f"no scan loop in the SASS of {path}")
        loop = max(scans, key=lambda lp: pairs_of(ops(lp)))
        names = ops(loop)
        pairs = pairs_of(names)
        found[key] = {
            "instructions": len(names), "pairs": pairs,
            "per_pair": len(names) / max(pairs, 1),
            "branches": sum(code[k].startswith("@") and " BRA " in code[k]
                            for k in range(loop[0], loop[1])),
            "ops": dict(collections.Counter(names))}
    return found


def train_kernel_report(b: int, n: int, m: int) -> dict:
    """ptxas's report of the training kernel per mode (no spills), its scan
    loop's SASS (no branch), and the launch's geometry at (b, n, m):
    blocks per SM, the grid and its waves."""
    import ctypes
    import re

    from autoposeestimation_tpu_torch.ops import addloss, kernel_build

    path = kernel_build.build(addloss.TRAIN_KERNEL)
    report = re.findall(
        r"Compiling entry function '\w*sym_moments_train_kernelILb(\d)\w*'"
        r".*?(\d+) bytes spill stores, (\d+) bytes spill loads"
        r".*?Used (\d+) registers",
        path.with_name(path.name + ".log").read_text(), re.S)
    check(sorted(mode for mode, *_ in report) == ["0", "1"],
          f"ptxas report {report}")
    sass = scan_loop_sass(path)
    for name, loop in sass.items():
        print(f"sass sym_moments_train {name}: scan loop of "
              f"{loop['instructions']} instructions for {loop['pairs']} "
              f"pairs ({loop['per_pair']:.2f} a pair), {loop['branches']} "
              f"conditional branches besides its back edge; {loop['ops']}")
        check(loop["branches"] == 0,
              f"sym_moments_train {name}: a branch in the scan loop")
    lib = ctypes.CDLL(str(path))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geometry = {}
    for mode, stores, loads, regs in report:
        name = "bf16" if mode == "1" else "f32"
        check(stores == loads == "0",
              f"sym_moments_train {name}: spills {stores}, {loads}")
        per_sm = lib.sym_moments_train_blocks_per_sm(m, int(mode))
        check(per_sm > 0, f"sym_moments_train_blocks_per_sm: {per_sm}")
        # one block per (candidate, sample)
        geometry[name] = {"registers": int(regs), "blocks_per_sm": per_sm,
                          "grid": [n, b], "waves": b * n / (per_sm * sms),
                          "sass_per_pair": sass.get(name, {}).get("per_pair")}
        print(f"ptxas sym_moments_train {name}: {regs} registers, 0 bytes "
              f"spilled; at B={b} N={n} M={m}: {per_sm} blocks per SM, grid "
              f"({n}, {b}) x 128 threads, {b * n / (per_sm * sms):.2f} waves")
    return geometry


def train_kernel_phase(dev, clock_mhz: float):
    from autoposeestimation_tpu_torch.ops import addloss

    cases = train_cases(dev)
    worst = 0.0
    for name, rot, pred_t, model, target in cases:
        m = model.shape[1]
        for bf16 in (False, True):
            got = addloss.moments_train_cuda(rot, pred_t, model, target, bf16)
            want = addloss.moments_train_plain(rot, pred_t, model, target,
                                               bf16)
            torch.cuda.synchronize()
            check(torch.isfinite(got).all().item(), f"{name}: non-finite")
            check(not got[..., 26:].any().item(), f"{name}: columns 26-31")
            err_dis = (got[..., 24] - want[..., 24]).abs().max().item()
            err_std = (got[..., 25].clamp(min=0).sqrt()
                       - want[..., 25].clamp(min=0).sqrt()).abs().max().item()
            mode = "bf16" if bf16 else "f32"
            # candidates whose matched distances are all the same (std at
            # the f32 rounding floor of dis)
            floor = want[..., 25].clamp(min=0).sqrt() <= 1e-4 * want[..., 24]
            n_floor = int(floor.sum().item())
            off = (got[..., :24] - want[..., :24]).abs().amax(dim=-1)
            note = ""
            if name == "coincident":
                # B_* = sum of (dmin - dis)/((M-1) std) weighted terms is
                # rounding noise there in any implementation: it is held to
                # its bound |B| <= M / sqrt(M-1) * max(1, |model|), and A_*
                # to the tolerance
                a_cols = [0, 1, 2] + list(range(6, 15))
                off = torch.where(floor, (got[..., a_cols]
                                          - want[..., a_cols]).abs().amax(-1),
                                  off)
                b_cap = m / (m - 1) ** 0.5 * max(1.0,
                                                 model.abs().max().item())
                b_max = got[..., [3, 4, 5] + list(range(15, 24))] \
                    .abs().amax(-1).max().item()
                check(b_max <= b_cap, f"{name} {mode}: |B| bound")
                note = (f"; {n_floor} with std at the rounding floor (B_* "
                        f"held to its bound, max |B| {b_max:.3e} <= "
                        f"{b_cap:.3e})")
            else:
                check(n_floor == 0, f"{name} {mode}: {n_floor} candidates "
                      "with std at the rounding floor")
            n_off = int((off > PRE_ATOL).sum().item())
            err_pre = off.max().item()
            check(err_dis <= DIS_ATOL, f"{name} {mode}: dis error {err_dis}")
            check(err_std <= STD_ATOL, f"{name} {mode}: std error {err_std}")
            check(err_pre <= 4.0 / m,
                  f"{name} {mode}: precursor error {err_pre}")
            check(n_off <= max(1, off.numel() // 1000),
                  f"{name} {mode}: {n_off} candidates outside {PRE_ATOL}")
            print(f"kernel sym_moments_train {name} {mode} "
                  f"{tuple(rot.shape[:2])} M={m}: max|dis err| "
                  f"{err_dis:.3e} max|std err| {err_std:.3e} max|precursor "
                  f"err| {err_pre:.3e}, {n_off} of {off.numel()} "
                  f"candidates outside {PRE_ATOL}{note}")
            worst = max(worst, err_dis, err_std, err_pre)

    _, rot, pred_t, model, target = cases[0]
    b, n = rot.shape[:2]
    m = model.shape[1]
    geometry = train_kernel_report(b, n, m)
    timing = train_timing(dev, clock_mhz, addloss.moments_train_cuda)
    for key, sha in timing["sha256"].items():
        print(f"kernel sym_moments_train {key}: output sha256 {sha}")
    for key, t in timing["timing"].items():
        print(f"kernel sym_moments_train {key} timing: {t['cuda_ms']:.4f} "
              f"ms with the host in the loop, {t['device_ms']:.4f} ms device "
              f"and {t['host_ms']:.4f} ms host time queued ahead")
    times = {}
    for bf16 in (False, True):
        times[bf16] = (
            timing["timing"][f"eval_shape {'bf16' if bf16 else 'f32'}"]
            ["cuda_ms"],
            cuda_ms(lambda: addloss.moments_train_plain(
                rot, pred_t, model, target, bf16), 3, 1))
    # least work per point pair (the per-point work is O(N M)), FP32 lanes
    # at 128 per SM per clock (67 TFLOP/s at 1980 MHz, an FMA counted as 2):
    # f32 mode, 4 instructions (the expansion form's 3 FMA and a min); bf16
    # mode, the K=5 product (padded to the tensor cores' K=16) at the dense
    # bf16 peak of 989 TFLOP/s, and on the lanes the min and the tie
    # compare, 2 instructions
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pairs = float(b * n * m * m)
    lane_rate = sms * 128 * clock_mhz * 1e6
    nbytes = 4 * (b * n * 12 + 2 * b * m * 3 + 32 * b * n)
    bytes_ms = nbytes / 3.35e12 * 1e3
    ops_ms = {False: 4 * pairs / lane_rate * 1e3,
              True: max(2 * 16 * pairs / 989e12, 2 * pairs / lane_rate) * 1e3}
    for bf16, (ms, plain_ms) in times.items():
        print(f"kernel sym_moments_train {'bf16' if bf16 else 'f32'} timing "
              f"at B={b} N={n} M={m}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {max(ops_ms[bf16], bytes_ms):.4f} ms (operations "
              f"{ops_ms[bf16]:.4f}, bytes {bytes_ms:.4f})")
    ms, plain_ms = times[True]       # bf16: the training default
    return {
        "name": "sym_moments_train", "route": "cuda",
        "source": "autoposeestimation_tpu_torch/csrc/sym_moments_train.cu",
        "replaces": "autoposeestimation_tpu/ops/pallas_addloss.py:209",
        "launches": None, "max_abs_err": worst, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(ops_ms[True], bytes_ms),
        "bound_by": "operations" if ops_ms[True] >= bytes_ms else "bytes",
        "library_ms": None, "geometry": geometry,
    }


# --- phase 7: training -------------------------------------------------------

def timed_steps(step, count: int) -> float:
    """ms per call of `step` over `count` calls, host clock, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(count):
        step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / count


def training_phase(dev):
    import tempfile

    from autoposeestimation_tpu_torch import weights
    from autoposeestimation_tpu_torch.ops import addloss
    from autoposeestimation_tpu_torch.train import checkpoints
    from autoposeestimation_tpu_torch.train import densefusion as dft
    from autoposeestimation_tpu_torch.utils import synthetic

    _, _, model_points = synthetic.headline_scene()
    cfg = dft.DFConfig(sym_bf16=True, refine_epoch_margin=1)
    state = dft.create_trainer(5, cfg, dtype=torch.bfloat16, seed=6,
                               device=dev)
    batches = eval_batches(dev, model_points, n_batches=2)
    steps = [dft.to_device(b, dev) for b in batches]     # the steps' layout
    gen = torch.Generator(device=dev).manual_seed(0)
    metrics, ref_metrics = [], []
    est_batches, ref_batches = (itertools.cycle(steps) for _ in range(2))

    def est_step():
        metrics.append(dft.estimator_step(
            state.posenet, state.optimizer, next(est_batches), state.w,
            cfg.with_sym, cfg.sym_bf16, gen))

    for _ in range(2):                                   # warm-up
        est_step()
    # the main path, estimator phase: counts from 0 just before, read after
    torch.cuda.reset_peak_memory_stats(dev)
    addloss.moments_train_cuda.launches = addloss.moments_cuda.launches = 0
    est_ms = timed_steps(est_step, 4)
    train_launches = addloss.moments_train_cuda.launches
    fwd_in_est = addloss.moments_cuda.launches
    est_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(train_launches == 4, f"sym_moments_train launches {train_launches}")
    check(fwd_in_est == 0, f"sym_moments launches in estimator {fwd_in_est}")
    for mt in metrics:
        check(all(torch.isfinite(v).item() for v in mt.values()),
              f"estimator metrics {mt}")

    refine_opt = dft.make_optimizer(state.refiner.parameters(), state.lr,
                                    cfg.grad_clip)

    def ref_step():
        ref_metrics.append(dft.refiner_step(
            state.posenet, state.refiner, refine_opt, next(ref_batches),
            state.w, cfg.iteration, cfg.with_sym))

    ref_step()                                           # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    addloss.moments_train_cuda.launches = addloss.moments_cuda.launches = 0
    ref_ms = timed_steps(ref_step, 4)
    fwd_launches = addloss.moments_cuda.launches
    train_in_ref = addloss.moments_train_cuda.launches
    ref_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(fwd_launches == 4, f"sym_moments launches in refiner {fwd_launches}")
    check(train_in_ref == 0, f"sym_moments_train in refiner {train_in_ref}")
    check(all(torch.isfinite(mt["dis"]).item() for mt in ref_metrics),
          "refiner metrics")
    profile(lambda: [est_step() for _ in range(2)],
            "training estimator step", 2, est_ms, ("sym_moments_train",))
    profile(lambda: [ref_step() for _ in range(2)],
            "training refiner step", 2, ref_ms)
    print(f"training B=8 N=1000 M=500 crop 320 bf16 sym_bf16: estimator "
          f"{est_ms:.4f} ms/step (4 steps, peak memory {est_peak:.3f} GiB, "
          f"sym_moments_train launches {train_launches}), refiner "
          f"{ref_ms:.4f} ms/step (4 steps, peak {ref_peak:.3f} GiB, "
          f"sym_moments launches {fwd_launches}); estimator loss "
          f"{[round(mt['loss'].item(), 6) for mt in metrics]}, gnorm "
          f"{[round(mt['gnorm'].item(), 4) for mt in metrics]}")

    # one estimator step through the kernel, one through the plain version
    weights0 = {k: v.clone() for k, v in state.posenet.state_dict().items()}
    got = []
    for plain in (False, True):
        state.posenet.load_state_dict(weights0)
        opt = dft.make_optimizer(state.posenet.parameters(), cfg.lr)
        step_gen = torch.Generator(device=dev).manual_seed(11)
        with (mock.patch.object(addloss, "moments_train_cuda",
                                addloss.moments_train_plain) if plain
              else contextlib.nullcontext()):
            got.append(dft.estimator_step(state.posenet, opt, steps[0],
                                          state.w, True, True, step_gen))
    (k, p) = got
    loss_rel = abs(k["loss"].item() / p["loss"].item() - 1)
    gnorm_rel = abs(k["gnorm"].item() / p["gnorm"].item() - 1)
    check(loss_rel <= 1e-5, f"estimator step kernel vs plain: loss {loss_rel}")
    check(gnorm_rel <= 1e-3,
          f"estimator step kernel vs plain: gnorm {gnorm_rel}")
    print(f"estimator step kernel vs plain (same weights, same dropout "
          f"seed): loss {k['loss'].item():.7f} vs {p['loss'].item():.7f} "
          f"(rel {loss_rel:.3e}), gnorm {k['gnorm'].item():.5f} vs "
          f"{p['gnorm'].item():.5f} (rel {gnorm_rel:.3e})")

    # a short two-phase train(): epoch 1 estimator, epoch 2 refiner
    fresh = dft.create_trainer(5, cfg, dtype=torch.bfloat16, seed=7,
                               device=dev)
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        fresh = dft.train(fresh, lambda: iter(batches),
                          lambda: iter(batches[:1]), out_dir, epochs=3)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        check(fresh.refine_start, "train(): refiner phase not reached")
        with open(os.path.join(out_dir, "losses.json")) as f:
            curves = json.load(f)["curves"]
        check(len(curves["test_dists"]) == 2
              and all(np.isfinite(curves["test_dists"])), f"curves {curves}")
        ckpt = checkpoints.load_checkpoint(os.path.join(out_dir,
                                                        "pose_model"))
        check(ckpt["meta"]["epoch"] == 1, f"checkpoint meta {ckpt['meta']}")
        loaded = weights.posenet_state_dict(ckpt["variables"])
        for key, val in fresh.posenet.state_dict().items():
            check(torch.equal(loaded[key], val.cpu()), f"checkpoint {key}")
    print(f"train(): 2 epochs (estimator, refiner) of 2 batches in "
          f"{train_s:.2f} s, test dists {curves['test_dists']}, "
          f"pose_model.npz reloaded equal")
    return train_launches


# --- phase 8: nearest-neighbour kernel ---------------------------------------

def ball_cloud(rng, k: int, center) -> np.ndarray:
    """k points on a 40 mm ball around `center` (mm) with 0.5 mm noise, the
    kind of cloud ICP registers."""
    v = rng.normal(size=(k, 3))
    v *= 40.0 / np.linalg.norm(v, axis=1, keepdims=True)
    return (v + center + rng.normal(size=(k, 3)) * 0.5).astype(np.float32)


def nn_cases(dev):
    """(name, query (N, 3), ref (M, 3), ref_valid (M,) or None) on `dev`."""
    from autoposeestimation_tpu_torch.ops import knn

    rng = np.random.default_rng(12)
    near = np.asarray([30.0, 10.0, 40.0])
    cases = []
    for n in (1024, 2048, 4096, 8192):
        # a padded bucket: the last 10 % of the references invalid
        cases.append((f"N=M={n}", ball_cloud(rng, n, near),
                      ball_cloud(rng, n, near), np.arange(n) < n * 9 // 10))
    cases.append(("N=1000 M=3000", ball_cloud(rng, 1000, near),
                  ball_cloud(rng, 3000, near), None))
    cases.append(("30% invalid", ball_cloud(rng, 2048, near),
                  ball_cloud(rng, 2048, near), rng.random(2048) >= 0.3))
    cases.append(("all invalid", ball_cloud(rng, 1024, near),
                  ball_cloud(rng, 1024, near), np.zeros(1024, bool)))
    base = ball_cloud(rng, 1024, near)
    cases.append(("duplicated refs", ball_cloud(rng, 2048, near),
                  np.concatenate([base, base]), None))
    ref = ball_cloud(rng, 4096, near)
    cases.append(("self-NN", ref.copy(), ref, None))
    far = near + [500.0, 0.0, 0.0]
    cases.append(("offset 500 mm", ball_cloud(rng, 4096, far),
                  ball_cloud(rng, 4096, far), None))
    # the kernel's own reference ranges at a production merge size: the
    # reference before each range's start repeated at the start and queried
    # there (exact ties across every boundary), and ranges 1, 2 and the last
    # wholly invalid
    n = m = 3000
    splits = knn.nn_splits(n, m, dev)
    starts = np.asarray([s * m // splits for s in range(1, splits)])
    ref = ball_cloud(rng, m, near)
    ref[starts] = ref[starts - 1]
    tied = ref[starts - 1] + rng.normal(size=(len(starts), 3)).astype(
        np.float32) * 1e-3
    cases.append(("ties at range boundaries", np.concatenate(
        [tied, ball_cloud(rng, n - len(starts), near)]), ref, None))
    valid = np.ones(m, bool)
    for s in (1, 2, splits - 1):
        valid[s * m // splits:(s + 1) * m // splits] = False
    cases.append(("invalid ranges", ball_cloud(rng, n, near),
                  ball_cloud(rng, m, near), valid))
    return [(name, torch.as_tensor(q, device=dev), torch.as_tensor(r, device=dev),
             None if v is None else torch.as_tensor(v, device=dev))
            for name, q, r, v in cases]


def check_nn(name, q, r, valid, got, want) -> float:
    """Indices and d2 equal to the plain version's (the kernel rounds as it
    does); prints the distance to the exact d2. Returns max |d2 - plain
    d2|."""
    (idx_k, d2_k), (idx_p, d2_p) = got, want
    r64 = r.double().cpu().numpy()
    ik, ip = idx_k.long().cpu().numpy(), idx_p.long().cpu().numpy()
    dk, dp = d2_k.double().cpu().numpy(), d2_p.double().cpu().numpy()
    flips = int((ik != ip).sum())
    err = float(np.abs(dk - dp)[dk != dp].max(initial=0.0))
    check(flips == 0, f"nn {name}: {flips} indices differ")
    check(err == 0.0, f"nn {name}: d2 differs by up to {err}")
    if valid is not None and not valid.any().item():
        check(not ik.any() and np.isinf(dk).all(),
              f"nn {name}: expected index 0 and +inf")
        print(f"kernel nn {name} N={len(ik)} M={len(r64)}: index 0, d2 +inf "
              f"everywhere, as the plain version")
        return err
    if valid is not None:
        check(valid.cpu().numpy()[ik].all(), f"nn {name}: invalid pick")
    if name == "duplicated refs":
        check(np.all(ik < len(r64) // 2), f"nn {name}: a later copy won")
    exact = np.sum((q.double().cpu().numpy() - r64[ik]) ** 2, 1)
    print(f"kernel nn {name} N={len(ik)} M={len(r64)}: 0 index flips, "
          f"max|d2 err| {err}, max|d2 - exact d2| "
          f"{np.abs(dk - np.maximum(exact, 0)).max():.3e}")
    return err


NN_TIMED = (2048, 4096, 8192)
NN_BLOCK_QUERIES = 512    # queries per scan block: kThreads * kQueries, nn.cu


def nn_timing(dev, clock_mhz: float) -> dict:
    """`nn_cuda` at N = M in NN_TIMED (mm-scale balls, the last 10 % of the
    references invalid, as a padded bucket), checked equal to `nn_plain`,
    with three clocks: `loop_ms`, calls back to back with the host in the
    loop (what ICP's loop sees); `device_ms` and `host_ms`, the device's
    and the host's time per call with the host queued ahead (`queued_ms`);
    and the plain version and `torch.cdist(...).min(1)` alike. Uses only
    `nn_cuda` and `nn_plain`, so it times earlier versions of the port
    too (`--nn-timing`)."""
    from autoposeestimation_tpu_torch.ops import knn

    rows = {}
    for n in NN_TIMED:
        rng = np.random.default_rng(n)
        near = np.asarray([30.0, 10.0, 40.0])
        q, r = (torch.as_tensor(ball_cloud(rng, n, near), device=dev)
                for _ in range(2))
        valid = torch.arange(n, device=dev) < n * 9 // 10
        r_valid = r[valid].contiguous()
        got, want = knn.nn_cuda(q, r, valid), knn.nn_plain(q, r, valid)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"nn at N=M={n}: differs from the plain version")

        def kernel():
            return knn.nn_cuda(q, r, valid)

        def library():
            return torch.cdist(q, r_valid).min(1)

        dev_ms, host_ms = queued_ms(kernel, 100, clock_mhz)
        lib_dev_ms, _ = queued_ms(library, 50, clock_mhz)
        rows[n] = {"loop_ms": cuda_ms(kernel, 100), "device_ms": dev_ms,
                   "host_ms": host_ms,
                   "plain_ms": cuda_ms(lambda: knn.nn_plain(q, r, valid),
                                       3, 1),
                   "library_ms": cuda_ms(library, 50),
                   "library_device_ms": lib_dev_ms}
    return rows


def nn_phase(dev, clock_mhz: float):
    import re

    from autoposeestimation_tpu_torch.ops import kernel_build, knn

    # nvcc's -Xptxas -v report: per entry function, its spills and registers
    lib = kernel_build.build(knn.KERNEL)
    report = re.findall(
        r"Compiling entry function '\w*?(nn_(?:partial|merge)_kernel)\w*'"
        r".*?(\d+) bytes spill stores, (\d+) bytes spill loads"
        r".*?Used (\d+) registers",
        lib.with_name(lib.name + ".log").read_text(), re.S)
    check(sorted(k for k, *_ in report) == ["nn_merge_kernel",
                                            "nn_partial_kernel"],
          f"ptxas report {report}")
    for name, stores, loads, regs in report:
        check(stores == loads == "0", f"{name}: spills {stores}, {loads}")
        print(f"ptxas {name}: {regs} registers, 0 bytes spilled")

    worst = 0.0
    for name, q, r, valid in nn_cases(dev):
        got = knn.nn_cuda(q, r, valid)
        want = knn.nn_plain(q, r, valid)
        torch.cuda.synchronize()
        worst = max(worst, check_nn(name, q, r, valid, got, want))

    # the floor of a call of two kernels: two tiny PyTorch kernels queued
    # back to back, timed alike
    a, b = torch.zeros(16, device=dev), torch.zeros(16, device=dev)
    floor_ms, floor_host_ms = queued_ms(lambda: (a.add_(1), b.add_(1)), 200,
                                        clock_mhz)
    print(f"two tiny kernels back to back: {floor_ms:.4f} ms device time, "
          f"{floor_host_ms:.4f} ms host time")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = nn_timing(dev, clock_mhz)
    for n, t in rows.items():
        # 5 lane instructions per pair (fmul, 2 fma, fadd and the last
        # fma of the expansion; the compare rides along) at 128 FP32 lanes
        # per SM per clock; bytes: 12 per query and 13 per reference in, 8
        # out
        ops_ms = 5.0 * n * n / (sms * 128 * clock_mhz * 1e6) * 1e3
        bytes_ms = (20.0 * n + 13.0 * n) / 3.35e12 * 1e3
        t["bound_ms"] = max(ops_ms, bytes_ms)
        t["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        splits = knn.nn_splits(n, n, dev)
        blocks = -(-n // NN_BLOCK_QUERIES)
        print(f"kernel nn timing at N=M={n}: {t['loop_ms']:.4f} ms a call "
              f"with the host in the loop; {t['device_ms']:.4f} ms device "
              f"time ({100 * t['bound_ms'] / t['device_ms']:.1f}% of the "
              f"bound) and {t['host_ms']:.4f} ms host time with the host "
              f"queued ahead; plain {t['plain_ms']:.4f} ms, torch.cdist+min "
              f"(2 calls) {t['library_ms']:.4f} ms ({t['library_device_ms']:.4f}"
              f" ms device time), bound {t['bound_ms']:.4f} ms (operations "
              f"{ops_ms:.4f}, bytes {bytes_ms:.4f}); S={splits} ranges of "
              f"~{n / splits:.1f} references, scan grid ({blocks}, {splits}) "
              f"x 128 threads ({blocks * splits / sms:.2f} blocks per SM), "
              f"merge grid {-(-8 * n // 256)} x 256 (8 threads a query)")
    t = rows[4096]
    return {
        "name": "nn", "route": "cuda",
        "source": "autoposeestimation_tpu_torch/csrc/nn.cu",
        "replaces": "autoposeestimation_tpu/ops/knn.py:119",
        "launches": None, "max_abs_err": worst, "ms": t["loop_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "device_ms": t["device_ms"],
    }


def nn_timing_main(root: str) -> int:
    """`--nn-timing ROOT`: phase 8's timing of the port in the checkout at
    ROOT (an earlier commit, say), printed as one JSON line, so that two
    versions are timed alike, back to back on one card."""
    sys.path.insert(0, os.path.abspath(root))
    from autoposeestimation_tpu_torch.ops import kernel_build, knn

    check(knn.__file__.startswith(os.path.abspath(root)),
          f"imported {knn.__file__}, not the port under {root}")
    kernel_build.build_all([knn.KERNEL])
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    rows = nn_timing(torch.device("cuda"), clock_mhz)
    print(json.dumps({"root": root, "card": nvidia_smi("name,power.limit"),
                      "nn": rows}))
    return 0


def train_timing_main(root: str) -> int:
    """`--train-timing ROOT`: the training kernel of the port in the
    checkout at ROOT (an earlier commit, say) on phase 6's cases, built by
    this script: output hashes and times, printed as one JSON line, so
    that two versions are compared alike, back to back on one card."""
    sys.path.insert(0, os.path.abspath(root))
    from autoposeestimation_tpu_torch.ops import addloss, kernel_build

    check(addloss.__file__.startswith(os.path.abspath(root)),
          f"imported {addloss.__file__}, not the port under {root}")
    path = kernel_build.build(addloss.TRAIN_KERNEL)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    result = train_timing(torch.device("cuda"), clock_mhz,
                          addloss.moments_train_cuda)
    print(json.dumps({"root": root, "card": nvidia_smi("name,power.limit"),
                      **result, "sass": scan_loop_sass(path)}))
    return 0


def moments_timing_main(root: str) -> int:
    """`--moments-timing ROOT`: the forward kernel of the port in the
    checkout at ROOT (an earlier commit, say) on phase 2's cases, built by
    this script: its largest errors against the f64 truth and its times,
    printed as one JSON line, so that two versions are compared alike, back
    to back on one card."""
    sys.path.insert(0, os.path.abspath(root))
    from autoposeestimation_tpu_torch.ops import addloss, kernel_build

    check(addloss.__file__.startswith(os.path.abspath(root)),
          f"imported {addloss.__file__}, not the port under {root}")
    path = kernel_build.build(addloss.KERNEL)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    result = moments_timing(torch.device("cuda"), clock_mhz,
                            addloss.moments_cuda)
    print(json.dumps({"root": root, "card": nvidia_smi("name,power.limit"),
                      **result, "sass": scan_loop_sass(path)}))
    return 0


# --- phase 9: reconstruction -------------------------------------------------

BALL_CENTERS = np.asarray([[30.0, 10.0, 40.0], [55.0, 35.0, 65.0]])
BALL_RADII = np.asarray([40.0, 18.0])
PRODUCTION = dict(mode="gen", n_viewpoints=30, min_friends=20, min_dist=5,
                  nb_neighbors=20, threshold=10, voxel_size=2,
                  voxel_size_out=5, icp_point2point=True,
                  icp_point2plane=False)
SMALL = dict(mode="gen", n_viewpoints=12, min_friends=5, min_dist=8,
             nb_neighbors=10, threshold=10, voxel_size=3, voxel_size_out=6,
             icp_point2plane=False)


def write_ball_dataset(root: str, **cfg_kw) -> None:
    from autoposeestimation_tpu_torch.utils import synthetic

    ball = synthetic.SphereObject(
        "ball", BALL_CENTERS[0], float(BALL_RADII[0]), (210, 50, 50),
        parts=((tuple(BALL_CENTERS[1] - BALL_CENTERS[0]),
                float(BALL_RADII[1])),))
    synthetic.make_dataset(root, objects=[ball],
                           cfg=synthetic.SynthConfig(**cfg_kw))


def surface_error(points: np.ndarray) -> np.ndarray:
    """min over the spheres of | |p - c_i| - r_i | (mm)."""
    return np.min(np.abs(np.linalg.norm(
        points[:, None] - BALL_CENTERS[None], axis=-1) - BALL_RADII), axis=1)


def mean_nn(a: np.ndarray, b: np.ndarray) -> float:
    """Mean distance from each point of a to its nearest point of b (f64)."""
    return float(np.concatenate([np.sqrt(np.min(np.sum(
        (a[i:i + 512, None] - b[None]) ** 2, -1), 1))
        for i in range(0, len(a), 512)]).mean())


def reconstruction_phase(dev):
    import tempfile

    from autoposeestimation_tpu_torch.labeling import pose_labels
    from autoposeestimation_tpu_torch.ops import addloss, icp, knn
    from autoposeestimation_tpu_torch.reconstruction import (
        create_pointcloud as rec)
    from autoposeestimation_tpu_torch.utils import io

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_ball_dataset(root, img_h=480, img_w=640, fx=600.0, fy=600.0,
                           n_viewpoints=30)
        write_s = time.perf_counter() - t0
        data = os.path.join(io.data_dir(root), "ball", "foreground")
        labels = os.path.join(io.label_dir(root), "ball", "foreground")
        t0 = time.perf_counter()
        for i in range(30):
            io.read_label(os.path.join(labels, f"{i:06d}.gen.label.png"))
            io.read_depth(os.path.join(data, f"{i:06d}.depth.png"))
        decode_ms = 1e3 * (time.perf_counter() - t0) / 30

        icps, merged_sizes = [], []
        real_icp = icp.registration_icp

        def counted_icp(source, *args, **kw):
            res = real_icp(source, *args, **kw)
            icps.append((source.shape[0], res.num_iterations))
            return res

        # the main path: counts from 0 just before, read just after
        knn.nn_cuda.launches = 0
        addloss.moments_cuda.launches = 0
        addloss.moments_train_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(icp, "registration_icp", counted_icp):
            down = rec.load_point_cloud(
                "ball", io.pc_dir(root), root, **PRODUCTION,
                progress=lambda run, idx, k: merged_sizes.append(k),
                device=dev)
        n_labels = pose_labels.create_pose_label(root, "ball", device=dev)
        torch.cuda.synchronize()
        object_s = time.perf_counter() - t0
        launches = knn.nn_cuda.launches
        others = (addloss.moments_cuda.launches,
                  addloss.moments_train_cuda.launches)
        check(launches > 0 and launches == sum(it + 1 for _, it in icps),
              f"nn launches {launches} for ICPs {icps}")
        check(others == (0, 0), f"sym_moments launches in reconstruction "
              f"{others}")

        pdir = os.path.join(io.pc_dir(root), "ball")
        for fn in ("foreground.ply", "foreground.pcd", "ball_out.ply",
                   "ball_out.pcd", "ball.ply", "ball.pcd", "ball.xyz"):
            check(os.path.exists(os.path.join(pdir, fn)), f"missing {fn}")
        out = io.read_ply(os.path.join(pdir, "ball_out.ply"))
        xyz = io.read_xyz(os.path.join(pdir, "ball.xyz"))
        err = surface_error(out)
        near = float(np.mean(err <= 2 * PRODUCTION["voxel_size"]))
        check(len(out) >= 1000, f"ball_out.ply has {len(out)} points")
        card_icps = list(icps)
        check(near >= 0.95, f"{near:.4f} of ball_out.ply within "
              f"{2 * PRODUCTION['voxel_size']} mm of the spheres")
        check(0 < len(xyz) < 1000, f"ball.xyz has {len(xyz)} points")
        check(n_labels == 30, f"create_pose_label wrote {n_labels}")
        center = (out.min(0) + out.max(0)) / 2
        worst_pos = 0.0
        for i in range(30):
            lab = io.read_pose_label_meta(os.path.join(
                labels, f"{i:06d}.meta.json"))
            cam2robot = np.linalg.inv(io.robot2cam_from_meta(
                io.read_sample_meta(os.path.join(data,
                                                 f"{i:06d}.meta.json"))))
            check(np.allclose(lab["cam2robot"], cam2robot, atol=1e-9),
                  f"label {i}: cam2robot")
            want = cam2robot @ np.append(center, 1.0)
            worst_pos = max(worst_pos,
                            float(np.abs(lab["position"] - want[:3]).max()))
        check(worst_pos <= 1e-3, f"label position error {worst_pos} mm")
        sizes = [len(s) for s in (down, xyz)]
        print(f"reconstruction 640x480, 30 views, production settings: "
              f"{object_s:.2f} s per object (load_point_cloud + "
              f"create_pose_label; dataset written in {write_s:.2f} s), PNG "
              f"decode {decode_ms:.2f} ms per view (label + depth); points: "
              f"merged after each view {merged_sizes}, ball_out.ply "
              f"{len(out)}, ball.ply {sizes[0]}, ball.xyz {sizes[1]}; "
              f"{near:.4f} of ball_out.ply within 4 mm of the spheres "
              f"(median {np.median(err):.3f} mm); nn launches {launches} per "
              f"object in {len(icps)} ICPs ({launches / len(icps):.2f} per "
              f"ICP; sizes and iterations {icps}); label positions within "
              f"{worst_pos:.2e} mm")

        # where an object's time goes: the production run again, with host
        # clocks around the per-view surfaces and the ICP merges (each ends
        # in a copy to the host), and under the profiler for its busy share
        spent = {"get_surface": 0.0, "_icp_merge": 0.0}
        pixels, surfaces = [], []

        def clocked(name):
            real = getattr(rec, name)

            def call(*args, **kw):
                t = time.perf_counter()
                out = real(*args, **kw)
                spent[name] += time.perf_counter() - t
                if name == "get_surface":   # (label, depth, ...) -> cloud
                    pixels.append(int(np.count_nonzero(
                        (args[0] != 0) & (args[1] != 0))))
                    surfaces.append(len(out))
                return out
            return call

        def production():
            rec.load_point_cloud("ball", os.path.join(root, "again"), root,
                                 **PRODUCTION, device=dev)

        t0 = time.perf_counter()
        with mock.patch.object(rec, "get_surface", clocked("get_surface")), \
                mock.patch.object(rec, "_icp_merge", clocked("_icp_merge")):
            production()
        again_s = time.perf_counter() - t0
        print(f"reconstruction time split (production run again, "
              f"{again_s:.2f} s): per-view surfaces "
              f"{spent['get_surface']:.2f} s (30 views), ICP merges "
              f"{spent['_icp_merge']:.2f} s (29), the rest (PNG decode, view "
              f"selection, files, the .xyz voxel search) "
              f"{again_s - sum(spent.values()):.2f} s); points per view: "
              f"masked depth pixels {pixels}, cleaned surface {surfaces}")
        profile(production, "reconstruction, one object", 1, 1e3 * again_s,
                kernels=("nn_partial_kernel", "nn_merge_kernel"))

        # one ICP merge: its time, device busy share, and the share of the
        # 3x3 SVD and determinant that each point-to-point step runs
        views = []
        for i in (0, 1):
            meta = io.read_sample_meta(os.path.join(data,
                                                    f"{i:06d}.meta.json"))
            views.append(rec.get_surface(
                io.read_label(os.path.join(labels, f"{i:06d}.gen.label.png")),
                io.read_depth(os.path.join(data, f"{i:06d}.depth.png")
                              ).astype(np.float64), meta["intr"],
                io.robot2cam_from_meta(meta), 20, 5, 20, 2, dev))

        def merge():
            icps.clear()
            with mock.patch.object(icp, "registration_icp", counted_icp):
                return rec._icp_merge(views[0], views[1], 2, 10, device=dev)

        merge()
        merge_ms = timed_steps(merge, 3)
        iters = sum(it for _, it in icps)
        pts = torch.randn(len(views[0]), 3, device=dev)
        w = torch.ones(len(views[0]), dtype=torch.float64, device=dev)
        svd_ms = timed_steps(lambda: icp._kabsch(pts, pts, w).sum().item(),
                             50)
        a6 = torch.eye(6, dtype=torch.float64, device=dev) * 2
        solve_ms = timed_steps(lambda: torch.linalg.solve(
            a6, a6[0]).sum().item(), 50)
        profile(merge, "one ICP merge (point-to-point)", 1, merge_ms)
        print(f"ICP merge of two {len(views[0])}/{len(views[1])}-point views: "
              f"{merge_ms:.4f} ms, {iters} iterations; a Kabsch step (the "
              f"points to the host, sums and SVD there) {svd_ms:.4f} ms "
              f"each, "
              f"{100 * svd_ms * iters / merge_ms:.1f}% of the merge; the "
              f"point-to-plane step's 6x6 solve + read {solve_ms:.4f} ms")

        # load_point_cloud with its own defaults: point-to-plane ICP, normals
        t0 = time.perf_counter()
        launches0 = knn.nn_cuda.launches
        cloud = rec.load_point_cloud("ball", os.path.join(root, "defaults"),
                                     root, device=dev)
        torch.cuda.synchronize()
        check(len(cloud) > 0 and np.isfinite(cloud).all(),
              "defaults: empty or non-finite cloud")
        near = float(np.mean(surface_error(io.read_ply(os.path.join(
            root, "defaults", "ball", "ball_out.ply"))) <= 10.0))
        print(f"load_point_cloud with its defaults (10 views, voxel 5, "
              f"point-to-point then point-to-plane ICP): "
              f"{time.perf_counter() - t0:.2f} s, {len(cloud)} points, "
              f"{near:.4f} of ball_out.ply within 10 mm of the spheres, nn "
              f"launches {knn.nn_cuda.launches - launches0}")

        # the production run on the CPU: the pipeline is deterministic
        # across devices, so every ICP (size, iterations) and the cloud
        # equal the card's
        icps.clear()
        t0 = time.perf_counter()
        with mock.patch.object(icp, "registration_icp", counted_icp):
            rec.load_point_cloud("ball", os.path.join(root, "cpu"), root,
                                 **PRODUCTION, device=torch.device("cpu"))
        cpu_s = time.perf_counter() - t0
        cpu_out = io.read_ply(os.path.join(root, "cpu", "ball",
                                           "ball_out.ply"))
        check(icps == card_icps and np.array_equal(out, cpu_out),
              f"card vs CPU at the production settings: ICPs {card_icps} vs "
              f"{icps}, {len(out)} vs {len(cpu_out)} points")
        print(f"reconstruction card vs CPU at the production settings: the "
              f"same {len(icps)} ICPs (sizes and iterations) and equal "
              f"clouds of {len(cpu_out)} points; {cpu_s:.2f} s on the CPU")

    # card against CPU, the small configuration
    outs = []
    with tempfile.TemporaryDirectory() as root:
        write_ball_dataset(root)
        for d in (dev, torch.device("cpu")):
            t0 = time.perf_counter()
            rec.load_point_cloud("ball", os.path.join(root, str(len(outs))),
                                 root, **SMALL, device=d)
            outs.append((io.read_ply(os.path.join(
                root, str(len(outs)), "ball", "ball_out.ply")),
                time.perf_counter() - t0))
    (gpu, gpu_s), (cpu, cpu_s) = outs
    count_rel = abs(len(gpu) - len(cpu)) / len(cpu)
    sym = (mean_nn(gpu, cpu) + mean_nn(cpu, gpu)) / 2
    check(count_rel <= 0.01, f"card vs CPU: {len(gpu)} vs {len(cpu)} points")
    check(sym < 0.1 * SMALL["voxel_size"],
          f"card vs CPU: symmetric mean NN distance {sym} mm")
    print(f"reconstruction card vs CPU (160x128, 12 views, voxel 3): "
          f"{len(gpu)} vs {len(cpu)} points, symmetric mean NN distance "
          f"{sym:.3e} mm, equal clouds: {np.array_equal(gpu, cpu)}; "
          f"{gpu_s:.2f} s on the card, {cpu_s:.2f} s on the CPU")
    return launches


# --- phase 10: training from a dataset ---------------------------------------

POSE_DS = "pose5"
POSE_VIEWS = 20          # 16 training views an object: 80 samples, 10 batches
POSE_WRITE_BUDGET_S = 60.0
POSE_COLORS = ((200, 40, 40), (40, 160, 60), (40, 60, 200), (200, 170, 30),
               (150, 50, 170))
# the card-vs-CPU dataset check runs this in a process without a card
CPU_ITEMS = """
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from autoposeestimation_tpu_torch.data import pose_dataset
items = {}
for mode in ("test", "train"):
    ds = pose_dataset.PoseDataset(sys.argv[2], sys.argv[3], mode=mode,
                                  num_pt=int(sys.argv[5]),
                                  num_pt_mesh=int(sys.argv[6]),
                                  return_raw=mode == "test")
    for i in range(8):
        for key, val in ds[i].items():
            items[f"{mode}/{i}/{key}"] = val
np.savez(sys.argv[4], **items)
"""


def pose_objects():
    """Five objects on the table: spheres of 30-42 mm, the odd ones with a
    coloured part (asymmetric), the even ones marked symmetric."""
    from autoposeestimation_tpu_torch.utils import synthetic

    out = []
    for i, color in enumerate(POSE_COLORS):
        r = 30.0 + 3.0 * i
        parts = () if i % 2 == 0 else (
            (np.asarray([0.0, r, 10.0]), 0.45 * r, (230, 200, 30)),)
        out.append(synthetic.SphereObject(
            f"obj{i}", np.asarray([0.0, 0.0, r]), r, color,
            symmetric=int(i % 2 == 0), parts=parts))
    return out


def write_pose_dataset(root: str) -> int:
    """The 5-object dataset at 640x480, fx = fy = 600, from the port's
    `make_dataset`: POSE_VIEWS views an object unless one view's render
    (background and foreground) says that would take over
    POSE_WRITE_BUDGET_S. Returns the views written."""
    from autoposeestimation_tpu_torch.utils import synthetic

    objects = pose_objects()
    cfg = synthetic.SynthConfig(img_h=480, img_w=640, fx=600.0, fy=600.0,
                                n_viewpoints=POSE_VIEWS, noise=1.0)
    cam = synthetic.ring_cameras(cfg, np.zeros(3))[0]
    t0 = time.perf_counter()
    for spheres in ([], objects[:1]):
        synthetic.render(cfg, cam, spheres)
    # ~1.3x for the PNGs and metas beside the renders
    per_view = 1.3 * (time.perf_counter() - t0) * len(objects)
    views = POSE_VIEWS
    if per_view * views > POSE_WRITE_BUDGET_S:
        views = max(int(POSE_WRITE_BUDGET_S / per_view), 2)
        print(f"pose dataset: cut from {POSE_VIEWS} to {views} views an "
              f"object ({per_view:.2f} s a view)")
    cfg.n_viewpoints = views
    t0 = time.perf_counter()
    synthetic.make_dataset(root, objects=objects, cfg=cfg,
                           dataset_name=POSE_DS)
    print(f"pose dataset: 5 objects x {views} views at 640x480 written in "
          f"{time.perf_counter() - t0:.2f} s")
    return views


def sample_split_ms(ds, count: int) -> dict:
    """ms per sample of the dataset's three steps, one thread."""
    spent = {"decode": 0.0, "augment": 0.0, "choose_backproject": 0.0}
    for i in range(count):
        t0 = time.perf_counter()
        img, depth, label, image_meta, meta = ds.load(i)
        t1 = time.perf_counter()
        img, label, depth, rot = ds.augment(img, label, depth)
        t2 = time.perf_counter()
        ds.sample(i, img, depth, label, image_meta, meta, rot)
        t3 = time.perf_counter()
        spent["decode"] += t1 - t0
        spent["augment"] += t2 - t1
        spent["choose_backproject"] += t3 - t2
    return {k: round(1e3 * v / count, 4) for k, v in spent.items()}


def loader_rate(ds, workers: int, samples: int, batch_size: int = 8
                ) -> float:
    """Samples a second the Loader assembles (train mode)."""
    from autoposeestimation_tpu_torch.data import loader

    t0 = time.perf_counter()
    n = 0
    for _ in loader.Loader(ds, batch_size, num_workers=workers):
        n += batch_size
        if n >= samples:
            break
    return n / (time.perf_counter() - t0)


def fed_ms(step, batches_fn, dev, prefetch: bool = False):
    """(ms per step fed by the Loader: assembly and copy in the loop, or
    with `prefetch` through `device_prefetch`; the batches, on the card)."""
    from autoposeestimation_tpu_torch.data import loader
    from autoposeestimation_tpu_torch.train import densefusion as dft

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    source = batches_fn()
    if prefetch:
        source = loader.device_prefetch(source, dev)
    staged = []
    for batch in source:
        staged.append(dft.to_device(batch, dev))
        step(staged[-1])
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / len(staged), staged


def fed_and_staged_ms(step, batches_fn, dev):
    """ms per step fed by the Loader, and over the same batches staged on
    the card first; the number of steps."""
    fed, staged = fed_ms(step, batches_fn, dev)
    again = iter(staged)
    return fed, timed_steps(lambda: step(next(again)), len(staged)), \
        len(staged)


def dataset_training_phase(dev, root=None):
    """Phase 10: `App.train_pose_estimation` at full width through both
    phases from a dataset written into `root` (a temporary directory unless
    given); returns the launches of (sym_moments_train, sym_moments) in
    that run."""
    import copy
    import shutil
    import tempfile

    from autoposeestimation_tpu_torch import weights
    from autoposeestimation_tpu_torch.data import loader, pose_dataset
    from autoposeestimation_tpu_torch.main import App
    from autoposeestimation_tpu_torch.models.densefusion import (
        PoseNet, PoseRefineNet)
    from autoposeestimation_tpu_torch.ops import addloss
    from autoposeestimation_tpu_torch.train import checkpoints
    from autoposeestimation_tpu_torch.train import densefusion as dft

    with contextlib.ExitStack() as stack:
        if root is None:
            root = stack.enter_context(tempfile.TemporaryDirectory())
        views = write_pose_dataset(root)
        out_dir = os.path.join(root, "DenseFusion", "trained_models", POSE_DS)
        after_1 = os.path.join(root, "after_epoch_1")
        kept = {}
        save_snapshot = dft.save_trainer_snapshot

        def snapshot(state, out, next_epoch):
            save_snapshot(state, out, next_epoch)
            if next_epoch == 2:     # the run as it stood after epoch 1
                os.makedirs(after_1)
                for name in ("trainer_resume.npz",
                             "trainer_resume.npz.meta.json"):
                    shutil.copy(os.path.join(out, name), after_1)
                kept["state"] = copy.deepcopy(state)

        # the main path: counts from 0 just before, read just after
        addloss.moments_train_cuda.launches = 0
        addloss.moments_cuda.launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(dft, "save_trainer_snapshot", snapshot):
            state = App(root).train_pose_estimation(
                POSE_DS, epochs=3, refine_epoch_margin=1, device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        train_launches = addloss.moments_train_cuda.launches
        fwd_launches = addloss.moments_cuda.launches
        check(state.refine_start, "dataset training: refiner phase not "
              "reached")
        check(train_launches >= 8, f"sym_moments_train launches "
              f"{train_launches} (>= 8 estimator steps expected)")
        check(fwd_launches >= 8, f"sym_moments launches {fwd_launches}")

        # the artifacts, each read back into the networks
        with open(os.path.join(out_dir, "losses.json")) as f:
            curves = json.load(f)["curves"]
        for key in ("losses", "train_dists", "test_dists"):
            check(len(curves[key]) == 2 and all(np.isfinite(curves[key])),
                  f"losses.json {key}: {curves[key]}")
        images = os.path.join(out_dir, "logs", "images")
        for name in ("test_images_epoch_1.png", "test_images_epoch_2.png",
                     "losses.png"):
            check(os.path.getsize(os.path.join(images, name)) > 0, name)
        resume = checkpoints.load_checkpoint(
            os.path.join(out_dir, "trainer_resume"))
        check(resume["meta"]["refine_start"] is True
              and resume["meta"]["epoch"] == 3,
              f"trainer_resume meta {resume['meta']}")
        net, ref = PoseNet(5), PoseRefineNet(5)
        for path, model, to_sd in (
                ("pose_model", net, weights.posenet_state_dict),
                ("pose_refine_model", ref, weights.refiner_state_dict)):
            model.load_state_dict(to_sd(checkpoints.load_checkpoint(
                os.path.join(out_dir, path))["variables"]))
        net.load_state_dict(weights.posenet_state_dict(
            resume["variables"]["pose_vars"]))
        ref.load_state_dict(weights.refiner_state_dict(
            resume["variables"]["refine_vars"]))

        # resume the epoch-1 snapshot (refiner phase) into a fresh trainer:
        # its next refiner step is the uninterrupted run's, bit for bit
        cfg = dft.DFConfig(refine_epoch_margin=1)
        fresh = dft.create_trainer(5, cfg, device=dev)
        dft.resume_trainer(fresh, after_1)
        check(fresh.refine_start and fresh.cfg.start_epoch == 2,
              "resumed trainer: phase or epoch")
        sizes = dict(num_pt=cfg.num_points, num_pt_mesh=cfg.num_points_mesh)
        test_ds = pose_dataset.PoseDataset(root, POSE_DS, mode="test",
                                           **sizes)
        batch = dft.to_device(next(iter(loader.Loader(
            test_ds, 8, shuffle=False, num_workers=0))), dev)
        torch.use_deterministic_algorithms(True)
        try:
            steps = [dft.refiner_step(s.posenet, s.refiner,
                                      s.refine_optimizer, batch, s.w,
                                      s.cfg.iteration, s.cfg.with_sym)
                     for s in (kept["state"], fresh)]
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        check(torch.equal(steps[0]["dis"], steps[1]["dis"]),
              f"resumed refiner step: dis {steps[0]['dis'].item()} vs "
              f"{steps[1]['dis'].item()}")
        for a, b in itertools.chain(
                zip(kept["state"].refiner.parameters(),
                    fresh.refiner.parameters()),
                zip(kept["state"].posenet.parameters(),
                    fresh.posenet.parameters())):
            check(torch.equal(a, b), "resumed refiner step: parameters")
        print(f"dataset training resume: the epoch-1 snapshot (refiner "
              f"phase) in a fresh trainer repeats the next refiner step "
              f"bit for bit (deterministic algorithms): dis "
              f"{steps[0]['dis'].item():.9f}, every parameter equal")

        # the dataset on the card's process against a process without one
        with tempfile.TemporaryDirectory() as tmp:
            npz = os.path.join(tmp, "items.npz")
            env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
            subprocess.run([sys.executable, "-c", CPU_ITEMS,
                            os.path.dirname(os.path.abspath(__file__)),
                            root, POSE_DS, npz, str(cfg.num_points),
                            str(cfg.num_points_mesh)], env=env, check=True,
                           timeout=300)
            with np.load(npz) as cpu_items:
                n_keys = 0
                for mode in ("test", "train"):
                    ds = pose_dataset.PoseDataset(root, POSE_DS, mode=mode,
                                                  return_raw=mode == "test",
                                                  **sizes)
                    for i in range(8):
                        for key, val in ds[i].items():
                            check(np.array_equal(
                                val, cpu_items[f"{mode}/{i}/{key}"]),
                                f"dataset card vs CPU: {mode} {i} {key}")
                            n_keys += 1
        print(f"dataset card vs CPU: 8 test and 8 train items, {n_keys} "
              f"arrays equal")

        # where the time goes
        train_ds = pose_dataset.PoseDataset(root, POSE_DS, mode="train",
                                            **sizes)
        split = sample_split_ms(train_ds, 16)
        rates = {w: loader_rate(train_ds, w, 32) for w in (0, 4)}

        def est(batch):
            dft.estimator_step(state.posenet, state.optimizer, batch,
                               state.w, True, True, gen)

        def ref(batch):
            dft.refiner_step(state.posenet, state.refiner,
                             state.refine_optimizer, batch, state.w)

        gen = torch.Generator(device=dev).manual_seed(3)
        batches = lambda: loader.Loader(train_ds, 8)    # noqa: E731
        est_fed, est_staged, n_est = fed_and_staged_ms(est, batches, dev)
        ref_fed, ref_staged, _ = fed_and_staged_ms(ref, batches, dev)
        pre_fed, _ = fed_ms(est, batches, dev, prefetch=True)
        profile(lambda: fed_ms(est, batches, dev),
                "dataset estimator epoch, Loader-fed", 1, est_fed * n_est,
                ("sym_moments_train",))
        print("dataset training " + json.dumps({
            "views_per_object": views, "train_samples": len(train_ds),
            "test_samples": len(test_ds),
            "run_s": round(run_s, 3),
            "epoch_s": [round(v, 3) for v in curves["epoch_seconds"]],
            "sample_ms": split,
            "loader_samples_per_s": {str(w): round(r, 3)
                                     for w, r in rates.items()},
            "estimator_ms": {"loader_fed": round(est_fed, 4),
                             "staged": round(est_staged, 4),
                             "prefetch_fed": round(pre_fed, 4)},
            "refiner_ms": {"loader_fed": round(ref_fed, 4),
                           "staged": round(ref_staged, 4)},
            "launches": {"sym_moments_train": train_launches,
                         "sym_moments": fwd_launches},
            "curves": {k: [round(v, 6) for v in curves[k]]
                       for k in ("losses", "train_dists", "test_dists")}}))
    return train_launches, fwd_launches


# --- phase 11: serving stream ------------------------------------------------

STREAM_MODEL = dict(num_points=1000, crop=320, refine_iters=2)
STREAM_FRAMES = 24       # a timed window: the 4 ring views, cycled
STREAM_MODES = ("full_prediction", "serve_stream batch 1",
                "serve_stream batch 4")


@contextlib.contextmanager
def no_host_sync():
    """Any CUDA call that makes the host wait for the stream raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def stream_inputs(frames, meta, count: int):
    return [(frames[i % len(frames)][0], frames[i % len(frames)][1], meta)
            for i in range(count)]


def compare_stream(name, got, want) -> int:
    """Checks `serve_stream`'s results against the single-frame graph's,
    frame by frame (found, masks equal; poses within POSE_ATOL); returns
    the largest count of differing mask pixels (0 when it passes)."""
    check(len(got) == len(want), f"{name}: {len(got)} results for "
          f"{len(want)} frames")
    worst, errs = 0, [0.0]
    for i, (g, w) in enumerate(zip(got, want)):
        check(set(g["predictions"]) == set(w["predictions"]),
              f"{name}, frame {i}: found {sorted(g['predictions'])} against "
              f"{sorted(w['predictions'])}")
        check(g["cca_converged"] == w["cca_converged"],
              f"{name}, frame {i}: cca_converged")
        for cls, p in w["predictions"].items():
            q = g["predictions"][cls]
            worst = max(worst, int((q["mask"] != p["mask"]).sum()))
            errs.append(float(max(np.abs(q[k] - p[k]).max()
                                  for k in ("position", "rotation"))))
    found = [len(g["predictions"]) for g in got]
    print(f"{name}: {len(got)} frames, found {found}, most differing mask "
          f"pixels in a frame {worst}, max pose error {max(errs):.3e}")
    check(worst == 0, f"{name}: masks differ in up to {worst} pixels")
    check(max(errs) <= POSE_ATOL, f"{name}: pose error {max(errs)}")
    return worst


def unet_inputs(frames, dev):
    """The 4 frames' U-Net input as `_predict_batch` gives it (NCHW) and
    channels-last, and `_predict_frame`'s one frame at a time."""
    from autoposeestimation_tpu_torch.models.common import normalize_imagenet

    imgs = torch.as_tensor(np.stack([f[0] for f in frames]), device=dev)
    x = normalize_imagenet(imgs.permute(0, 3, 1, 2))
    singles = [normalize_imagenet(im.permute(2, 0, 1))[None] for im in imgs]
    return {"NCHW": x.contiguous(),
            "channels-last": x.contiguous(
                memory_format=torch.channels_last)}, singles


def segmentation_drift(models, frames) -> str:
    """The U-Net over the 4 frames in one batch, in `_predict_batch`'s NCHW
    and in channels-last, against `_predict_frame`'s one frame at a time:
    the largest logit difference and the argmax pixels that differ."""
    parts = []
    with torch.inference_mode():
        batches, singles = unet_inputs(frames, models.device)
        single = torch.cat([models.seg_model(x) for x in singles])
        for layout, x in batches.items():
            batched = models.seg_model(x)
            diff = (batched - single).abs().max().item()
            flips = (batched.argmax(1) != single.argmax(1)).sum().item()
            parts.append(f"{layout} input: logits max difference "
                         f"{diff:.3e}, argmax pixels differing {flips} of "
                         f"{single[:, 0].numel()}")
    return "; ".join(parts)


def stream_correctness(dev, frames, meta, model_points, classes) -> None:
    """f32 (TF32 off, deterministic cuDNN): `serve_stream` at batch 1 and
    at batch 4 (8 frames; 6 frames, a padded tail of 2) against
    `full_prediction` on the same draws."""
    from autoposeestimation_tpu_torch.pipeline import predict

    models = predict.build_models(len(classes), model_points, classes,
                                  dtype=torch.float32, emb_stride=8,
                                  device=dev, **STREAM_MODEL)
    print(f"serving stream, U-Net in f32 at batch 4 against one frame at a "
          f"time: "
          f"{segmentation_drift(models, frames)}")
    inputs = stream_inputs(frames, meta, 8)
    draws = np.random.default_rng(11).random(
        (8, len(classes), models.num_points)).astype(np.float32)
    want = [predict.full_prediction(im, d, m, models, uniforms=u)
            for (im, d, m), u in zip(inputs, draws)]
    for name, batch, count in (("batch 1", 1, 8), ("batch 4", 4, 8),
                               ("batch 4, padded tail of 2", 4, 6)):
        got = list(predict.serve_stream(inputs[:count], models, in_flight=2,
                                        batch=batch, uniforms=draws[:count]))
        compare_stream(f"serving stream f32 {name}", got, want[:count])


def stream_modes(models, gen):
    """Each timed mode: a function serving `inputs` to the end."""
    from autoposeestimation_tpu_torch.pipeline import predict

    def blocking(frames):
        return [predict.full_prediction(im, d, m, models, generator=gen)
                for im, d, m in frames]

    def streamed(batch):
        return lambda frames: list(predict.serve_stream(
            frames, models, in_flight=4, batch=batch, generator=gen))

    return dict(zip(STREAM_MODES, (blocking, streamed(1), streamed(4))))


def graph_dispatch_ms(models, frames, meta, batch: int, reps: int = 8):
    """Host ms to queue one call of the frame graph (`_predict_frame`, or
    `_predict_batch` over `batch` frames) on inputs already on the card:
    the part of a served call that is the graph's launches."""
    from autoposeestimation_tpu_torch.pipeline import predict

    dev = models.device
    with torch.inference_mode():
        imgs = torch.as_tensor(np.stack([f[0] for f in frames[:batch]]),
                               device=dev)
        deps = torch.as_tensor(np.stack([f[1] for f in frames[:batch]]),
                               device=dev)
        intr = torch.as_tensor(meta["intr"].as_array(), device=dev)
        scale = torch.tensor(meta["depth_scale"], device=dev)
        u = torch.rand((batch, len(models.classes), models.num_points),
                       device=dev)
        if batch == 1:
            call = lambda: predict._predict_frame(  # noqa: E731
                models, imgs[0], deps[0], intr, scale, u[0])
        else:
            call = lambda: predict._predict_batch(  # noqa: E731
                models, imgs, deps, intr, scale, u)
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    return 1e3 * host_s / reps


def stream_timing(dev, frames, meta, model_points, classes, stride) -> dict:
    """bf16 at the headline geometry: frames/s of each mode over
    STREAM_FRAMES frames in 3 rounds that alternate the modes, the medians,
    kernels per call, busy share, peak memory, the host's time to queue the
    graph alone, the U-Net's device time at batch 4 by input layout; each
    stream's dispatch and reads run with host syncs forbidden."""
    from autoposeestimation_tpu_torch.pipeline import predict

    models = predict.build_models(len(classes), model_points, classes,
                                  dtype=torch.bfloat16, emb_stride=stride,
                                  device=dev, **STREAM_MODEL)
    print(f"serving stream emb_stride={stride}, U-Net in bf16 at batch 4 "
          f"against one frame at a time (not gated): "
          f"{segmentation_drift(models, frames)}")
    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = stream_inputs(frames, meta, STREAM_FRAMES)
    modes = stream_modes(models, gen)
    for run in modes.values():                      # warm-up
        run(inputs[:8])
    torch.cuda.synchronize()
    with no_host_sync():
        for batch in (1, 4):
            outs = list(predict.serve_stream(inputs[:8], models, in_flight=4,
                                             batch=batch, generator=gen))
            check(len(outs) == 8, f"batch {batch}: {len(outs)} results")
    print(f"serving stream emb_stride={stride}: serve_stream at batch 1 and "
          f"4 ran under torch.cuda.set_sync_debug_mode('error'): no host "
          f"sync")
    fps = {name: [] for name in modes}
    for _ in range(3):
        for name, run in modes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = run(inputs)
            fps[name].append(len(inputs) / (time.perf_counter() - t0))
            check(len(outs) == len(inputs), f"{name}: {len(outs)} results")
            for out in outs:
                check_prediction(dict(out, elapsed_times=None),
                                 frames[0][0].shape[:2])
    result = {}
    for (name, run), per_call in zip(modes.items(), (1, 1, 4)):
        median = float(np.median(fps[name]))
        torch.cuda.reset_peak_memory_stats(dev)
        prof = profile(lambda: run(inputs[:8]),
                       f"serving stream emb_stride={stride} {name}, per call",
                       8 // per_call, 1e3 * per_call / median)
        result[name] = {
            "frames_per_s": [round(f, 4) for f in fps[name]],
            "median": round(median, 4),
            "ms_per_frame": round(1e3 / median, 4),
            "frames_per_call": per_call,
            "kernels_per_call": None if prof is None else round(prof[1], 1),
            "busy_ms_per_call": None if prof is None else round(prof[0], 4),
            "busy_share": None if prof is None else round(
                prof[0] * median / (1e3 * per_call), 4),
            "peak_gib": round(torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                              3),
            "graph_dispatch_ms_per_call": round(graph_dispatch_ms(
                models, frames, meta, per_call), 4)}
    # the U-Net at batch 4 in each input layout: with the host in the loop
    # it is host-bound, so its device time comes from the profiler
    result["unet_batch4"] = {}
    with torch.inference_mode():
        batches, _ = unet_inputs(frames, dev)
        for layout, x in batches.items():
            wall = cuda_ms(lambda: models.seg_model(x), 4)
            prof = profile(lambda: [models.seg_model(x) for _ in range(4)],
                           f"serving stream emb_stride={stride} U-Net at "
                           f"batch 4, {layout} input, per call", 4, wall)
            result["unet_batch4"][layout] = {
                "ms": round(wall, 4),
                "device_ms": None if prof is None else round(prof[0], 4)}
    b1, b4 = (result[m]["kernels_per_call"] for m in STREAM_MODES[1:])
    if b1 is not None and b4 is not None:
        check(b4 < 2 * b1, f"kernels per call grow with the batch: {b1} at "
              f"batch 1, {b4} at batch 4")
    result["sm_clock_power_after"] = nvidia_smi("clocks.sm,power.draw")
    print(f"serving stream emb_stride={stride} " + json.dumps(result))
    return result


def live_and_grasp(dev, model_points, classes) -> None:
    """`App.run_live_prediction` over a FakeDepthCam of the headline scene,
    blocking and pipelined (batch 4), and `grasping.get_predictions` /
    `execute_grasp` with a FakeRobot whose camera follows it."""
    import tempfile

    from autoposeestimation_tpu_torch.hardware import camera, robot
    from autoposeestimation_tpu_torch.main import App
    from autoposeestimation_tpu_torch.pipeline import grasping, predict
    from autoposeestimation_tpu_torch.utils import synthetic

    cfg, spheres, _ = synthetic.headline_scene()
    cams = synthetic.ring_cameras(cfg, np.zeros(3))[:4]
    models = predict.build_models(len(classes), model_points, classes,
                                  dtype=torch.bfloat16, emb_stride=8,
                                  device=dev, **STREAM_MODEL)
    with tempfile.TemporaryDirectory() as root:
        for kw in ({}, {"pipelined": True, "batch": 4, "in_flight": 4}):
            lines = []
            app = App(root, camera_factory=lambda: camera.FakeDepthCam(
                cfg=cfg, spheres=spheres, robot2cam_fn=lambda: cams[0]),
                print_fn=lines.append)
            t0 = time.perf_counter()
            n = app.run_live_prediction(max_frames=8, models=models, **kw)
            wall = time.perf_counter() - t0
            check(n == 8 and len(lines) == 8 and all(
                line.startswith("fps:") for line in lines),
                f"live loop {kw}: {n} frames, lines {lines}")
            print(f"live loop {kw or 'blocking'}: 8 frames in {wall:.3f} s "
                  f"(the FakeDepthCam renders each on the host); last line "
                  f"{lines[-1]!r}")

        hand_eye = np.eye(4)
        hand_eye[:3, 3] = [0.0, 40.0, 60.0]
        fr = robot.FakeRobot(fk_fn=robot.ring_fk(cams, hand_eye))
        cam = camera.FakeDepthCam(
            cfg=cfg, spheres=spheres,
            robot2cam_fn=lambda: fr.robot2end() @ hand_eye)
        check(grasping.move_to_grasp_position(fr, poll=0.0),
              "the robot is not home")
        views = []
        to_robot = predict.get_robot2object

        def recorded(prediction, controller, end2cam):
            cam_frame = {c: dict(p) for c, p in
                         prediction["predictions"].items()}
            pose = controller.get_pose(return_mm=True)
            out = to_robot(prediction, controller, end2cam)
            views.append((cam_frame, pose, out["predictions"]))
            return out

        with mock.patch.object(predict, "get_robot2object", recorded):
            ok, final = grasping.get_predictions(fr, cam, hand_eye, models,
                                                 poll=0.0)
        check(ok and len(views) == 5, f"get_predictions: {ok}, "
              f"{len(views)} views")
        worst = 0.0
        for cam_frame, pose, robot_frame in views:
            check(set(cam_frame) == set(robot_frame), "robot-frame classes")
            robot2cam = rigid_f64(np.asarray([pose[c] for c in "abc"]),
                                  [pose[c] for c in "xyz"]) @ hand_eye
            for cls, p in cam_frame.items():
                q = np.asarray(p["rotation"], np.float64)
                cam2obj = np.eye(4)
                cam2obj[:3, :3] = quat_mat_f64(q / np.linalg.norm(q))
                cam2obj[:3, 3] = np.asarray(p["position"], np.float64) * 1e3
                want = robot2cam @ cam2obj
                got = robot_frame[cls]
                worst = max(worst, float(np.abs(
                    got["position"] - want[:3, 3] / 1e3).max()), float(
                    np.abs(quat_mat_f64(np.asarray(got["rotation"],
                                                   np.float64))
                           - want[:3, :3]).max()))
        check(worst <= POSE_ATOL, f"get_robot2object against f64: {worst}")
        for cls, p in final.items():
            check(np.isfinite(p["position"]).all()
                  and np.isfinite(p["rotation"]).all(),
                  f"{cls}: averaged pose not finite")
        grasping.save_grasping_delta(root, "ds", classes[0], np.zeros(3),
                                     [1.0, 0.0, 0.0, 0.0], fr.get_pose(
                                         return_mm=False))
        grasped = grasping.execute_grasp(fr, cam, hand_eye, models, root,
                                         "ds", classes[0],
                                         confirm=lambda m: True, poll=0.0)
        check(isinstance(grasped, bool), "execute_grasp")
        print(f"grasping: 5 views, found per view "
              f"{[len(v[0]) for v in views]}, averaged {sorted(final)}, "
              f"get_robot2object within {worst:.3e} of f64 (m / rotation), "
              f"execute_grasp -> {grasped}, robot moves "
              f"{len(fr.history)}")


def rigid_f64(rotvec, trans) -> np.ndarray:
    """4x4 from a rotation vector and a translation, in f64 (Rodrigues)."""
    angle = np.linalg.norm(rotvec)
    k = rotvec / angle if angle > 1e-12 else np.asarray([1.0, 0.0, 0.0])
    kx = np.asarray([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    tf = np.eye(4)
    tf[:3, :3] = (np.eye(3) + np.sin(angle) * kx
                  + (1 - np.cos(angle)) * kx @ kx)
    tf[:3, 3] = trans
    return tf


def quat_mat_f64(q) -> np.ndarray:
    w, x, y, z = q
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (w * y + x * z)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (w * x + y * z), 1 - 2 * (x * x + y * y)]])


def serving_stream_phase(dev) -> None:
    """Phase 11: the batched graph and `serve_stream` against the
    single-frame graph in f32, their speed in bf16 at emb_stride 8 and 2,
    the live loop and the grasp flow on the card. Its batch part on
    trained weights (`trained_batch_invariance`) runs after phase 16, on
    the demo's checkpoints."""
    frames, meta, model_points, classes = headline_frames()
    stream_correctness(dev, frames, meta, model_points, classes)
    for stride in (8, 2):
        stream_timing(dev, frames, meta, model_points, classes, stride)
    live_and_grasp(dev, model_points, classes)


BATCH_FRAMES = 8          # held-out frames of the demo's scene: 2 batches


def batch_and_single(models, images, depths, intr, scale, draws):
    """`_predict_batch` over 4 frames at a time and `_predict_frame` one
    frame at a time on the same draws: each frame's outputs on the host,
    in both modes."""
    from autoposeestimation_tpu_torch.pipeline import predict

    batch, single = [], []
    with torch.inference_mode():
        for lo in range(0, len(images), 4):
            out = predict._predict_batch(models, images[lo:lo + 4],
                                         depths[lo:lo + 4], intr, scale,
                                         draws[lo:lo + 4])
            batch += [{name: t[j].float().cpu().numpy()
                       for name, t in out.items()} for j in range(4)]
        for i in range(len(images)):
            out = predict._predict_frame(models, images[i], depths[i], intr,
                                         scale, draws[i])
            single.append({name: t.float().cpu().numpy()
                           for name, t in out.items()})
    return batch, single


def trained_batch_invariance(dev, demo_root: str) -> dict:
    """Phase 11's batch part, on the trained checkpoints of phase 16's demo
    (`train_multi_demo` under `demo_root`; served as the demo serves:
    emb_stride 2, crop 160, 500 points, 2 refine iterations when the
    refiner was saved): BATCH_FRAMES held-out frames of the demo's scene
    (`heldout_cameras`) through `batch_and_single`, in bf16 and in f32.
    In bf16: the shares of argmax pixels, found flags and mask pixels that
    differ between the modes, each class's mask IoU against the rendered
    mask and its ADD(-S) against the analytic pose in both modes, the
    largest move of a frame's ADD(-S) and the frames whose ADD(-S) crosses
    2 cm, and the U-Net's drift (`segmentation_drift`). In f32 the modes
    must agree: found and masks equal, poses within POSE_ATOL."""
    from autoposeestimation_tpu_torch.experiments import eval as eval_mod
    from autoposeestimation_tpu_torch.pipeline import predict
    from autoposeestimation_tpu_torch.scripts.attribute_serving import (
        heldout_cameras, iou)
    from autoposeestimation_tpu_torch.scripts.train_multi_demo import (
        MULTI_CROP, MULTI_IMG_HW, MULTI_NUM_PT, MULTI_SYM_CLASS,
        SCENE_FAMILIES, model_clouds)
    from autoposeestimation_tpu_torch.train import checkpoints
    from autoposeestimation_tpu_torch.utils import io, synthetic

    t0 = time.perf_counter()
    cfg, objects = SCENE_FAMILIES["a"](48, MULTI_IMG_HW)
    classes = io.read_lines(os.path.join(
        io.dataset_dir(demo_root, "pose_estimation", "synth"),
        "classes.txt"))
    k = len(classes)
    centers = {o.name: np.asarray(o.center, float) for o in objects}
    model_points = model_clouds(demo_root, classes, MULTI_NUM_PT)
    pose_dir = os.path.join(demo_root, "DenseFusion", "trained_models",
                            "synth")
    refine_path = os.path.join(pose_dir, "pose_refine_model.npz")
    refine = os.path.exists(refine_path)
    variables = dict(
        seg_vars=checkpoints.load_checkpoint(os.path.join(
            demo_root, "segmentation", "trained_models", "synth",
            "Unet_resnet34.ckpt.npz"))["variables"],
        pose_vars=checkpoints.load_checkpoint(os.path.join(
            pose_dir, "pose_model.npz"))["variables"],
        refine_vars=checkpoints.load_checkpoint(refine_path)["variables"]
        if refine else None)
    intr = torch.tensor([cfg.fx, cfg.fy, cfg.img_w / 2.0, cfg.img_h / 2.0],
                        dtype=torch.float32, device=dev)
    scale = torch.tensor(cfg.depth_scale, dtype=torch.float32, device=dev)
    views = []
    for robot2cam in heldout_cameras(cfg, BATCH_FRAMES):
        color, depth, owner = synthetic.render(cfg, robot2cam, objects)
        views.append((color, depth.astype(np.float32), owner, robot2cam))
    images = torch.as_tensor(np.stack([v[0] for v in views]), device=dev)
    depths = torch.as_tensor(np.stack([v[1] for v in views]), device=dev)
    draws = torch.rand((BATCH_FRAMES, k, MULTI_NUM_PT),
                       generator=torch.Generator().manual_seed(5)).to(dev)
    runs = {}
    for dtype in (torch.bfloat16, torch.float32):
        models = predict.build_models(
            k, model_points, tuple(classes), **variables,
            num_points=MULTI_NUM_PT, crop=MULTI_CROP,
            refine_iters=2 if refine else 0, dtype=dtype, emb_stride=2,
            device=dev)
        runs[dtype] = batch_and_single(models, images, depths, intr, scale,
                                       draws)
        if dtype == torch.bfloat16:
            drift = segmentation_drift(models, [v[:2] for v in views[:4]])
    batch, single = runs[torch.bfloat16]
    modes = {"batch 4": batch, "single": single}
    add = {m: {c: [] for c in classes} for m in modes}
    ious = {m: {c: [] for c in classes} for m in modes}
    moves, crossings = [], 0
    for f, (_, _, owner, robot2cam) in enumerate(views):
        cam2robot = np.linalg.inv(robot2cam)
        for i, c in enumerate(classes):
            gt_t = (cam2robot @ np.append(centers[c], 1.0))[:3] / 1000.0
            got = {}
            for m, outs in modes.items():
                o = outs[f]
                ious[m][c].append(iou(o["masks"][i] > 0, owner == i))
                if o["found"][i]:
                    got[m] = eval_mod.add_from_pose(
                        o["quats"][i], o["positions"][i], cam2robot[:3, :3],
                        gt_t, model_points[i],
                        symmetric=c == MULTI_SYM_CLASS)
                    add[m][c].append(got[m])
            if len(got) == 2:
                moves.append(abs(got["batch 4"] - got["single"]))
                crossings += (got["batch 4"] < 0.02) != (got["single"] < 0.02)

    def share(name, pairs):
        return float(np.mean([np.mean(b[name] != s[name]) for b, s in pairs]))

    pairs = list(zip(batch, single))
    f32_pairs = list(zip(*runs[torch.float32]))
    f32_pose_err = max(float(np.abs(b[n] - s[n]).max())
                       for b, s in f32_pairs for n in ("quats", "positions"))
    report = {
        "frames": BATCH_FRAMES, "classes": k, "refine_iters":
        2 if refine else 0, "argmax_share": share("argmax", pairs),
        "found_share": share("found", pairs),
        "mask_pixel_share": share("masks", pairs),
        "largest_position_move_m": max(float(np.abs(
            b["positions"] - s["positions"]).max()) for b, s in pairs),
        "add_s_m": {m: {c: round(float(np.mean(v)), 5) if v else None
                        for c, v in add[m].items()} for m in modes},
        "found": {m: {c: len(v) for c, v in add[m].items()} for m in modes},
        "mask_iou": {m: {c: round(float(np.mean(v)), 4)
                         for c, v in ious[m].items()} for m in modes},
        "largest_add_move_m": round(max(moves, default=0.0), 6),
        "add_2cm_crossings": crossings, "unet_drift": drift,
        "f32": {"found_share": share("found", f32_pairs),
                "mask_pixel_share": share("masks", f32_pairs),
                "max_pose_err": f32_pose_err},
        "card": nvidia_smi("name,power.limit"),
        "s": round(time.perf_counter() - t0, 2)}
    print("serving stream batch 4 against single frames, trained weights "
          + json.dumps(report))
    for b, s in pairs + f32_pairs:
        for name in ("quats", "positions"):
            check(np.isfinite(b[name]).all() and np.isfinite(s[name]).all(),
                  f"batch against single: {name} not finite")
    check(report["f32"]["found_share"] == 0.0
          and report["f32"]["mask_pixel_share"] == 0.0
          and f32_pose_err <= POSE_ATOL,
          f"f32 batch 4 against single frames: {report['f32']}")
    return report


# --- phase 12: segmentation training -----------------------------------------

SEG_DS = "seg5"
SEG_VIEWS = 8            # 7 training views an object: 35 samples, 8 steps of 4
SEG_EPOCHS = 2
SEG_CLASSES = 6          # 5 objects and the background


def seg_sample_split_ms(ds, count: int) -> dict:
    """ms per training sample of the segmentation dataset's steps, one
    thread: decode, colour jitter, rotation, crop-and-zoom."""
    from autoposeestimation_tpu_torch.data import augment as aug

    spent = dict.fromkeys(("decode", "jitter", "rotate", "crop_and_zoom"),
                          0.0)
    for i in range(count):
        t0 = time.perf_counter()
        img, label = ds.load(i)
        t1 = time.perf_counter()
        img = aug.color_jitter(img, rng=ds.rng)
        t2 = time.perf_counter()
        img, label = aug.rotate_joint(ds.rng.uniform(-180.0, 180.0), img,
                                      label)
        t3 = time.perf_counter()
        aug.CropAndZoom(ds.output_size, rng=ds.rng)(img, label)
        t4 = time.perf_counter()
        for key, a, b in (("decode", t0, t1), ("jitter", t1, t2),
                          ("rotate", t2, t3), ("crop_and_zoom", t3, t4)):
            spent[key] += b - a
    return {k: round(1e3 * v / count, 4) for k, v in spent.items()}


def seg_fed_and_staged_ms(net, optimizer, batches_fn, dev):
    """(ms per train_step fed by the Loader through `device_prefetch`, as
    `segmentation_training` feeds it; ms per step over the same batches
    staged on the card; the steps; the staged batches)."""
    from autoposeestimation_tpu_torch.data import loader
    from autoposeestimation_tpu_torch.train import segmentation as seg

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = []
    for batch in loader.device_prefetch(batches_fn(), dev):
        staged.append(seg.to_device(batch, dev))
        seg.train_step(net, optimizer, staged[-1], SEG_CLASSES)
    torch.cuda.synchronize()
    fed = 1e3 * (time.perf_counter() - t0) / len(staged)
    again = iter(staged)
    staged_ms = timed_steps(lambda: seg.train_step(
        net, optimizer, next(again), SEG_CLASSES), len(staged))
    return fed, staged_ms, len(staged), staged


def flat_pairs(a: dict, b: dict, prefix: str = ""):
    """(path, a leaf, b leaf) over two nested dicts of one layout."""
    for key, node in a.items():
        if isinstance(node, dict):
            yield from flat_pairs(node, b[key], f"{prefix}{key}/")
        else:
            yield prefix + key, np.asarray(node), np.asarray(b[key])


def seg_card_vs_cpu(dev, variables, batch) -> dict:
    """One f32 train_step (TF32 off) from the same weights on the card and
    on the CPU: the loss within 2e-4, the confusion equal but for pixels
    whose two best logits are within 1e-4, every weight within 2 lr and
    all but 1 in 10^3 of the weights within 2e-4 (Adam's first step is
    about lr * sign(gradient), so a gradient at rounding level can move a
    weight either way), the running statistics within 1e-4 relative."""
    import copy

    from autoposeestimation_tpu_torch import weights
    from autoposeestimation_tpu_torch.models.unet import UNet
    from autoposeestimation_tpu_torch.train import segmentation as seg

    cfg = seg.SegConfig(classes=SEG_CLASSES)
    out = {}
    near_ties = 0
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        net = UNet(SEG_CLASSES, dtype=torch.float32)
        net.load_state_dict(weights.unet_state_dict(variables))
        net.to(d)
        optimizer = seg.make_optimizer(cfg, net.parameters())
        on = seg.to_device(batch, d)
        if name == "card":
            with torch.no_grad():
                top2 = copy.deepcopy(net).train()(on["image"]).topk(
                    2, dim=1).values
            near_ties = int((top2[:, 0] - top2[:, 1] < 1e-4).sum())
        m = seg.train_step(net, optimizer, on, SEG_CLASSES)
        out[name] = (float(m["loss"]), m["conf"].cpu().numpy(),
                     weights.unet_variables(net))
    (lc, cc, vc), (lp, cp, vp) = out["card"], out["cpu"]
    moved = int(np.abs(cc - cp).sum()) // 2
    check(abs(lc - lp) <= 2e-4, f"segmentation step card vs CPU: loss {lc} "
          f"vs {lp}")
    check(moved <= near_ties, f"segmentation step card vs CPU: {moved} "
          f"pixels moved, {near_ties} near ties")
    stats = max(float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max())
                for _, a, b in flat_pairs(vc["batch_stats"],
                                          vp["batch_stats"]))
    check(stats <= 1e-4, f"segmentation step card vs CPU: running "
          f"statistics {stats} relative")
    worst, beyond, total = 0.0, 0, 0
    for path, a, b in flat_pairs(vc["params"], vp["params"]):
        d = np.abs(a - b)
        check(d.max() <= 2 * cfg.lr + 1e-6, f"segmentation step card vs "
              f"CPU: {path} max {d.max()}")
        worst = max(worst, float(d.max()))
        beyond += int((d > 2e-4).sum())
        total += d.size
    check(beyond <= 1e-3 * total, f"segmentation step card vs CPU: "
          f"{beyond} of {total} weights beyond 2e-4")
    return {"loss_card": lc, "loss_cpu": lp, "pixels_moved": moved,
            "near_ties": near_ties, "weight_max_diff": worst,
            "weights_beyond_2e-4": beyond, "weights": total,
            "stats_max_rel_diff": stats}


def seg_blob_batches(rng, count: int, channels: int, hw=(480, 640)):
    """Synthetic batches of 4: normal images with elliptic blob labels,
    the blobs brighter in channel 0."""
    out = []
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    for _ in range(count):
        label = np.zeros((4,) + hw, np.int32)
        for b in range(4):
            cy, cx = rng.uniform(0, hw[0]), rng.uniform(0, hw[1])
            ry, rx = rng.uniform(20, 120, 2)
            label[b, ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = 1
        image = rng.normal(size=(4,) + hw + (channels,)).astype(np.float32)
        image[..., 0] += 2.0 * label
        out.append({"image": image, "label": label})
    return out


def seg_variants_card_vs_cpu(dev) -> dict:
    """LinkNet and PSPNet-seg forward (eval mode, f32, seeded weights) on
    the card and the CPU at 480x640: logits within 2e-4."""
    from autoposeestimation_tpu_torch.models import seg_variants
    from autoposeestimation_tpu_torch.models.common import init_like_flax

    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=(1, 3, 480, 640)).astype(np.float32))
    errs = {}
    for name, cls in (("LinkNet", seg_variants.LinkNet),
                      ("PSPNetSeg", seg_variants.PSPNetSeg)):
        net = cls(SEG_CLASSES)
        init_like_flax(net, torch.Generator().manual_seed(4))
        net.eval()
        with torch.no_grad():
            want = net(x)
            got = net.to(dev)(x.to(dev)).cpu()
        errs[name] = float((got - want).abs().max())
        check(got.shape == (1, SEG_CLASSES, 480, 640)
              and errs[name] <= 2e-4, f"{name} card vs CPU: {errs[name]}")
    return errs


def segmentation_training_phase(dev) -> None:
    """Phase 12: `App.train_segmentation` at full width on a written 640x480
    dataset (SegConfig defaults: Unet-resnet34, batch 4, 480 crops, Adam
    1e-4, bf16, 4 Loader threads), its checkpoint serving a frame; one f32
    step against the CPU; a background-subtraction-style run; LinkNet and
    PSPNet-seg against the CPU; where the time goes."""
    import tempfile

    from autoposeestimation_tpu_torch import weights
    from autoposeestimation_tpu_torch.data import loader, segmentation_dataset
    from autoposeestimation_tpu_torch.main import App
    from autoposeestimation_tpu_torch.models.common import init_like_flax
    from autoposeestimation_tpu_torch.models.densefusion import (
        PoseNet, PoseRefineNet)
    from autoposeestimation_tpu_torch.models.unet import UNet
    from autoposeestimation_tpu_torch.pipeline import predict
    from autoposeestimation_tpu_torch.train import checkpoints
    from autoposeestimation_tpu_torch.train import segmentation as seg
    from autoposeestimation_tpu_torch.utils import synthetic

    with tempfile.TemporaryDirectory() as root:
        cfg = synthetic.SynthConfig(img_h=480, img_w=640, fx=600.0, fy=600.0,
                                    n_viewpoints=SEG_VIEWS, noise=1.0)
        t0 = time.perf_counter()
        manifest = synthetic.make_dataset(root, objects=pose_objects(),
                                          cfg=cfg, dataset_name=SEG_DS)
        print(f"segmentation dataset: 5 objects x {SEG_VIEWS} views at "
              f"640x480 written in {time.perf_counter() - t0:.2f} s")

        # the main path
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = App(root).train_segmentation(SEG_DS, epochs=SEG_EPOCHS,
                                           device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        curves = res["log"]["curves"]
        for key in ("train_loss", "valid_loss", "train_iou", "valid_iou"):
            check(len(curves[key]) == SEG_EPOCHS
                  and all(np.isfinite(curves[key])),
                  f"segmentation logs.json {key}: {curves[key]}")
        out_dir = os.path.join(root, "segmentation", "trained_models", SEG_DS)
        ckpt = checkpoints.load_checkpoint(os.path.join(
            out_dir, "Unet_resnet34.ckpt"))
        check(ckpt["meta"]["config"]["classes"] == SEG_CLASSES
              and ckpt["meta"]["valid_iou"] == res["best_iou"],
              f"segmentation checkpoint meta {ckpt['meta']}")
        UNet(SEG_CLASSES).load_state_dict(
            weights.unet_state_dict(ckpt["variables"]))

        # the trained checkpoint serves a frame (random pose weights)
        gen = torch.Generator().manual_seed(0)
        pose_dir = os.path.join(root, "DenseFusion", "trained_models", SEG_DS)
        for name, net, to_vars in (
                ("pose_model", PoseNet(5), weights.posenet_variables),
                ("pose_refine_model", PoseRefineNet(5),
                 weights.refiner_variables)):
            init_like_flax(net, gen)
            checkpoints.save_checkpoint(os.path.join(pose_dir, name),
                                        to_vars(net))
        models = predict.get_prediction_models(root, SEG_DS, device=dev)
        color, depth, _ = synthetic.render(cfg, manifest["cams"][0],
                                           manifest["objects"][:1])
        served = predict.full_prediction(
            color, np.round(depth).astype(np.uint16),
            {"intr": manifest["intr"], "depth_scale": 0.001}, models,
            generator=torch.Generator(device=dev).manual_seed(1))
        for p in served["predictions"].values():
            check(np.isfinite(np.asarray(p["position"])).all(),
                  "served prediction not finite")
        print(f"segmentation serving: the trained checkpoint served one "
              f"frame, classes found {sorted(served['predictions'])}")

        # one f32 step, card against CPU
        train_ds = segmentation_dataset.SegmentationDataset(
            root, SEG_DS, mode="train", label_mode="pred")
        batch = next(iter(loader.Loader(train_ds, 2, num_workers=0)))
        step_check = seg_card_vs_cpu(dev, ckpt["variables"], batch)
        print("segmentation step card vs CPU " + json.dumps(step_check))

        # the background-subtraction configuration on synthetic batches
        rng = np.random.default_rng(7)
        bs_train = seg_blob_batches(rng, 3, 7)
        bs_valid = seg_blob_batches(rng, 1, 7)
        bs_cfg = seg.SegConfig(classes=2, in_channels=7, epochs=2, lr=1e-2,
                               optimizer="sgd")
        bs = seg.segmentation_training(
            lambda: iter(bs_train), lambda: iter(bs_valid), bs_cfg,
            os.path.join(root, "background_subtraction", "trained_models"),
            plateau=seg.ReduceLROnPlateau(bs_cfg.lr, patience=0),
            with_cca_metric=True, device=dev)
        bs_curves = bs["log"]["curves"]
        check(all(np.isfinite(bs_curves[k]).all() for k in
                  ("train_loss", "valid_iou", "valid_iou_cca")),
              f"background-subtraction run curves {bs_curves}")
        variants = seg_variants_card_vs_cpu(dev)

        # where the time goes
        split = seg_sample_split_ms(train_ds, 8)
        rates = {w: loader_rate(train_ds, w, 16, batch_size=4)
                 for w in (0, 4)}
        net = res["model"]
        optimizer = seg.make_optimizer(seg.SegConfig(classes=SEG_CLASSES),
                                       net.parameters())
        batches = lambda: loader.Loader(train_ds, 4)    # noqa: E731
        fed, staged_ms, n, staged = seg_fed_and_staged_ms(net, optimizer,
                                                          batches, dev)
        again = iter(staged)
        seen = profile(lambda: [seg.train_step(net, optimizer, next(again),
                                               SEG_CLASSES)
                                for _ in range(n)],
                       "segmentation step, staged", n, staged_ms)
        device_ms = seen[0] if seen else float("nan")
        print("segmentation training " + json.dumps({
            "card": nvidia_smi("name,power.limit"),
            "train_samples": len(train_ds), "epochs": SEG_EPOCHS,
            "run_s": round(run_s, 3),
            "epoch_s": [round(v, 3) for v in curves["epoch_seconds"]],
            "step_ms": {"loader_fed": round(fed, 4),
                        "staged": round(staged_ms, 4), "steps": n,
                        "device": round(device_ms, 4)},
            "busy_share": {"loader_fed": round(device_ms / fed, 4),
                           "staged": round(device_ms / staged_ms, 4)},
            "sample_ms": split,
            "loader_samples_per_s": {str(w): round(r, 3)
                                     for w, r in rates.items()},
            "peak_memory_gib": round(peak_gib, 3),
            "curves": {k: [round(v, 6) for v in curves[k]]
                       for k in ("train_loss", "valid_loss", "train_iou",
                                 "valid_iou")},
            "background_subtraction": {
                k: [round(v, 6) for v in bs_curves[k]]
                for k in ("train_loss", "valid_iou", "valid_iou_cca",
                          "lr")},
            "variants_card_vs_cpu_max_abs": variants}))


# --- phase 13: offline labeling ----------------------------------------------

LABEL_DS = "label5"
LABEL_VIEWS = 20         # a background and a foreground run of 20 views
EXTRA_VIEWS = 8
TURNED = "obj1"          # asymmetric: the coloured part shows the turn
TURNED_RUN = "foreground180"
BS_LR = 1e-2             # the JAX package's background-subtraction runs
# Phase A's U-Net: 6 epochs at Adam 1e-3. After one epoch (at 1e-3 or
# 1e-4) some runs keep a speckle component as every view's mask (IoU 0.0-
# 0.08 against the rendered masks on an H100); such a run has no surface,
# and Phase B fails on it in both packages (align_point_clouds of no
# cloud). After 4 epochs the validation IoU reached 0.46-0.69 and single
# views still held speckles; after 6 it was 0.90, every run's masks at
# IoU >= 0.73.
PHASE_A_EPOCHS = 6
PHASE_A_LR = 1e-3
GEN_CPU_SAMPLES = 5
PRED_CPU_SAMPLES = 3
TIE = 1e-4               # a score or probability this close may decide
LABEL_IOU = 0.6          # tests/test_labeling_reconstruction.py:38
LABEL_ATOL = 1e-3        # mm, phase 9's card-vs-CPU bound


def turn_pose(degrees: float = 180.0) -> np.ndarray:
    """The acquisition `object_pose` of a turn about the vertical axis (an
    `{"c": degrees}` run): the f32 euler matrix, as acquisition writes it."""
    from autoposeestimation_tpu_torch.utils import transforms as T

    tf = np.eye(4)
    tf[:3, :3] = T.euler_to_mat(*(torch.tensor(np.float32(a)) for a in
                                  np.deg2rad([0.0, 0.0, degrees]))).numpy()
    return tf


def turned_object(obj, object_pose: np.ndarray):
    """`obj` with its parts turned by the pose's rotation about the vertical
    axis through its centre: the renderer's spheres moved."""
    import dataclasses

    rot = object_pose[:3, :3]
    return dataclasses.replace(obj, parts=tuple(
        (tuple(rot @ np.asarray(p[0], float)),) + tuple(p[1:])
        for p in obj.parts))


def write_run(root: str, obj, run: str, cfg, object_pose: np.ndarray) -> None:
    """One acquisition run of `obj` (its spheres as given) from the ring of
    `cfg`, as `synthetic.make_dataset` writes a foreground run: colour,
    depth, the meta with the run's `object_pose`, and the rendered mask as
    the gen, pred and new_pred labels."""
    from autoposeestimation_tpu_torch.utils import io, synthetic

    intr = io.Intrinsics(width=cfg.img_w, height=cfg.img_h,
                         ppx=cfg.img_w / 2.0, ppy=cfg.img_h / 2.0,
                         fx=cfg.fx, fy=cfg.fy)
    run_dir = os.path.join(io.data_dir(root), obj.name, run)
    label_dir = os.path.join(io.label_dir(root), obj.name, run)
    for vp, robot2cam in enumerate(synthetic.ring_cameras(cfg, np.zeros(3))):
        color, depth, owner = synthetic.render(cfg, robot2cam, [obj])
        meta = {"joints": [0.0] * 6,
                "pose": {"x": float(robot2cam[0, 3]),
                         "y": float(robot2cam[1, 3]),
                         "z": float(robot2cam[2, 3]),
                         "a": 0.0, "b": 0.0, "c": 0.0},
                "object_pose": object_pose, "robot2endEff_tf": robot2cam,
                "intr": intr, "depth_scale": cfg.depth_scale,
                "symmetric": obj.symmetric,
                "hand_eye_calibration": np.eye(4), "view_point_id": vp}
        stem = f"{vp:06d}"
        io.write_png(os.path.join(run_dir, stem + ".color.png"), color)
        io.write_png(os.path.join(run_dir, stem + ".depth.png"),
                     np.round(depth).astype(np.uint16))
        io.write_sample_meta(os.path.join(run_dir, stem + ".meta.json"), meta)
        for mode in ("gen", "pred", "new_pred"):
            io.write_png(os.path.join(label_dir, f"{stem}.{mode}.label.png"),
                         (owner == 0).astype(np.uint8) * 255)


def write_labeling_dataset(root: str, cfg) -> list:
    """Phase 10's five objects, a background and a foreground run each
    (`make_dataset`), and for TURNED a run turned by 180 degrees about the
    vertical axis and an `extra` run in that pose from a lower ring.
    Returns the objects."""
    from autoposeestimation_tpu_torch.utils import synthetic

    objects = pose_objects()
    synthetic.make_dataset(root, objects=objects, cfg=cfg,
                           dataset_name="written")
    pose = turn_pose()
    turned = turned_object(next(o for o in objects if o.name == TURNED),
                           pose)
    write_run(root, turned, TURNED_RUN, cfg, pose)
    extra = synthetic.SynthConfig(**{**cfg.__dict__,
                                     "n_viewpoints": EXTRA_VIEWS,
                                     "ring_height": 300.0})
    write_run(root, turned, "extra", extra, pose)
    return objects


def label_paths(root: str, mode: str):
    """(object, run, stem, path) of every `mode` label but the extra run's."""
    from autoposeestimation_tpu_torch.utils import io

    out = []
    for obj in io.list_objects(root):
        for run in io.list_runs(root, obj):
            d = os.path.join(io.label_dir(root), obj, run)
            if run in ("background", "extra") or not os.path.isdir(d):
                continue
            out += [(obj, run, f.split(".")[0], os.path.join(d, f))
                    for f in sorted(os.listdir(d))
                    if f.endswith(f".{mode}.label.png")]
    return out


def iou(a: np.ndarray, b: np.ndarray) -> float:
    return float((a & b).sum() / max((a | b).sum(), 1))


def gen_label_on_cpu(root: str, obj: str, run: str, stem: str) -> dict:
    """The classical label of one sample computed on the CPU, with what may
    decide a pixel either way: the scores within TIE of the threshold, and
    the components of the thresholded, opened and closed score whose
    floored mean lies within TIE of an integer."""
    from autoposeestimation_tpu_torch.labeling import create_labels as cl
    from autoposeestimation_tpu_torch.ops import bg_subtraction as bgs
    from autoposeestimation_tpu_torch.ops import cca
    from autoposeestimation_tpu_torch.utils import io

    dd = io.data_dir(root)
    cpu = torch.device("cpu")
    tensors, dist = cl._read_pair(os.path.join(dd, obj, "background", stem),
                                  os.path.join(dd, obj, run, stem), cpu,
                                  np.zeros(3))
    label = bgs.create_label_rgbd(*tensors, dist, threshold=30.0, hsv=False,
                                  both=True, open_k=6, close_k=6,
                                  remove_one_std=True).numpy()
    _, score = bgs.label_scores(*tensors, dist, bgs.P_BOTH, False, True)
    kept = bgs._opened_closed(torch.where(score < 30.0, 0.0, score), 6, 6)
    mask = kept > 0
    labels = cca.connected_components(mask)
    counts, sums = cca.component_stats(labels, mask, kept)
    mean = sums / torch.clamp(counts, min=1.0)
    near = (counts > 0) & (torch.abs(mean - torch.round(mean)) < TIE)
    near_pixels = mask & near[torch.where(mask, labels, labels.numel())]
    return {"label": label, "score": score.numpy(),
            "near": (torch.abs(score - 30.0) < TIE).numpy()
            | near_pixels.numpy()}


def flips(got: np.ndarray, want: np.ndarray, allowed: np.ndarray) -> tuple:
    """(pixels that differ, of them outside `allowed`)."""
    differ = got != want
    return int(differ.sum()), int((differ & ~allowed).sum())


def labeling_phase(dev) -> int:
    """Phase 13: the offline labeling path on the card through the App's
    entry points, on a written 5-object 640x480 dataset with a turned and
    an extra run: classical labels, the background-subtraction U-Net
    trained for an epoch and its labels, a segmentation dataset and
    PHASE_A_EPOCHS epochs of its U-Net, then Phases A-C with and without
    global registration; each checked against the ground truth or the CPU.
    Returns the nn kernel's calls in the phase."""
    import tempfile

    from autoposeestimation_tpu_torch.data import bs_dataset, loader
    from autoposeestimation_tpu_torch.labeling import create_labels as cl
    from autoposeestimation_tpu_torch.labeling import pose_labels
    from autoposeestimation_tpu_torch.main import App
    from autoposeestimation_tpu_torch.ops import addloss, bg_subtraction
    from autoposeestimation_tpu_torch.ops import global_registration as greg
    from autoposeestimation_tpu_torch.ops import knn
    from autoposeestimation_tpu_torch.reconstruction import (
        create_pointcloud as rec)
    from autoposeestimation_tpu_torch.train import segmentation as seg
    from autoposeestimation_tpu_torch.utils import io, synthetic

    report = {"card": nvidia_smi("name,power.limit")}
    with tempfile.TemporaryDirectory() as root:
        cfg = synthetic.SynthConfig(img_h=480, img_w=640, fx=600.0, fy=600.0,
                                    n_viewpoints=LABEL_VIEWS, noise=1.0)
        t0 = time.perf_counter()
        objects = write_labeling_dataset(root, cfg)
        names = [o.name for o in objects]
        report["write_s"] = round(time.perf_counter() - t0, 3)
        # the rendered masks, before the labeling overwrites them
        truth = {(o, r, s): io.read_label(p) > 0
                 for o, r, s, p in label_paths(root, "gen")}
        app = App(root, reference_point=np.zeros(3), print_fn=lambda s: None)

        # the main path: counts from 0 just before, read just after
        knn.nn_cuda.launches = 0
        addloss.moments_cuda.launches = 0
        addloss.moments_train_cuda.launches = 0
        torch.cuda.synchronize()
        phase_t0 = time.perf_counter()

        # 1. classical labels
        t0 = time.perf_counter()
        n_gen = app.create_labels(names, mode="gen", device=dev)
        torch.cuda.synchronize()
        gen_ms = 1e3 * (time.perf_counter() - t0) / n_gen
        check(n_gen == len(truth), f"gen labels {n_gen} of {len(truth)}")
        gen_ious = [iou(io.read_label(p) > 0, truth[(o, r, s)])
                    for o, r, s, p in label_paths(root, "gen")]
        check(min(gen_ious) > LABEL_IOU, f"gen label IoU against the "
              f"rendered masks: least {min(gen_ious):.4f}")
        turned_samples = sum(r == TURNED_RUN for _, r, _ in truth)
        seen = profile(lambda: cl.create_labels(
            TURNED, root, reference_point=np.zeros(3), device=dev),
            "gen labels", LABEL_VIEWS + turned_samples, gen_ms)
        gen_cpu = []
        for o, r, s, p in label_paths(root, "gen")[::LABEL_VIEWS][
                :GEN_CPU_SAMPLES]:
            cpu = gen_label_on_cpu(root, o, r, s)
            n, bad = flips(io.read_label(p), cpu["label"], cpu["near"])
            gen_cpu.append({"sample": f"{o}/{r}/{s}", "differ": n,
                            "outside_ties": bad})
            check(bad == 0, f"gen label {o}/{r}/{s}: {bad} of {n} pixels "
                  f"differ from the CPU's away from a tie")
        print(f"offline labeling: gen labels done at "
              f"{time.perf_counter() - phase_t0:.1f} s")
        report["gen"] = {
            "samples": n_gen, "ms_per_sample": round(gen_ms, 4),
            "kernels_per_sample": round(seen[1], 1) if seen else None,
            "device_ms_per_sample": round(seen[0], 4) if seen else None,
            "busy_share": round(seen[0] / gen_ms, 4) if seen else None,
            "iou_min": round(min(gen_ious), 4),
            "iou_mean": round(float(np.mean(gen_ious)), 4),
            "card_vs_cpu": gen_cpu}
        print("offline labeling gen " + json.dumps(report["gen"]))

        # 2. the background-subtraction U-Net: an epoch, then its labels
        bs_train = bs_dataset.BSDataset(root, mode="train")
        bs_valid = bs_dataset.BSDataset(root, mode="test")
        bs_cfg = seg.SegConfig(in_channels=7, classes=2, optimizer="sgd",
                               epochs=1, lr=BS_LR)
        t0 = time.perf_counter()
        bs = seg.segmentation_training(
            lambda: loader.Loader(bs_train, bs_cfg.batch_size,
                                  num_workers=4),
            lambda: loader.Loader(bs_valid, bs_cfg.batch_size, shuffle=False,
                                  drop_last=False, num_workers=4),
            bs_cfg, os.path.join(root, "background_subtraction",
                                 "trained_models"), device=dev)
        torch.cuda.synchronize()
        bs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_pred = app.create_labels(names, mode="pred", device=dev)
        torch.cuda.synchronize()
        pred_ms = 1e3 * (time.perf_counter() - t0) / n_pred
        pred_ious = [iou(io.read_label(p) > 0, truth[(o, r, s)])
                     for o, r, s, p in label_paths(root, "pred")]
        cpu_model = app._load_bs_model("cpu")
        pred_cpu = []
        for o, r, s, p in label_paths(root, "pred")[::LABEL_VIEWS][
                :PRED_CPU_SAMPLES]:
            dd = io.data_dir(root)
            tensors, dist = cl._read_pair(
                os.path.join(dd, o, "background", s),
                os.path.join(dd, o, r, s), torch.device("cpu"), np.zeros(3))
            x = bg_subtraction.build_bs_input(*tensors, dist)
            want = cl.bs_mask(cpu_model, x).numpy()
            with torch.inference_mode():
                probs = torch.softmax(cpu_model(x.permute(2, 0, 1)[None])[0],
                                      dim=0)
            top = torch.topk(probs, 2, dim=0).values
            n, bad = flips(io.read_label(p) > 0, want,
                           (top[0] - top[1]).numpy() < TIE)
            pred_cpu.append({"sample": f"{o}/{r}/{s}", "differ": n,
                             "outside_ties": bad})
            check(bad == 0, f"pred label {o}/{r}/{s}: {bad} of {n} pixels "
                  f"differ from the CPU's away from a near-tie")
        print(f"offline labeling: pred labels done at "
              f"{time.perf_counter() - phase_t0:.1f} s")
        report["pred"] = {
            "bs_train_samples": len(bs_train), "bs_epoch_s": round(bs_s, 3),
            "bs_curves": {k: [round(v, 6) for v in bs["log"]["curves"][k]]
                          for k in ("train_loss", "valid_iou")},
            "samples": n_pred, "ms_per_sample": round(pred_ms, 4),
            "iou_min": round(min(pred_ious), 4),
            "iou_mean": round(float(np.mean(pred_ious)), 4),
            "card_vs_cpu": pred_cpu}
        print("offline labeling pred " + json.dumps(report["pred"]))

        # 3. the segmentation dataset from the pred labels, its U-Net for
        # Phase A
        t0 = time.perf_counter()
        lists = app.create_dataset(names, kind="segmentation",
                                   save_name=LABEL_DS, mode="pred")
        trained = app.train_segmentation(LABEL_DS, epochs=PHASE_A_EPOCHS,
                                         device=dev, lr=PHASE_A_LR)
        torch.cuda.synchronize()
        print(f"offline labeling: Phase A's U-Net trained at "
              f"{time.perf_counter() - phase_t0:.1f} s")
        report["segmentation"] = {
            "lists": lists, "epochs": PHASE_A_EPOCHS, "lr": PHASE_A_LR,
            "train_s": round(time.perf_counter() - t0, 3),
            "valid_iou": [round(v, 4) for v in
                          trained["log"]["curves"]["valid_iou"]]}

        # 4. Phases A-C, without and then with global registration
        calls, greg_ms, first = {}, {}, []
        current = {"object": None}
        real_load, real_greg = rec.load_point_cloud, greg.global_registration

        def counted_load(obj, *args, **kw):
            current["object"] = obj
            before = knn.nn_cuda.launches
            out = real_load(obj, *args, **kw)
            calls[obj] = knn.nn_cuda.launches - before
            return out

        def timed_greg(*args, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = real_greg(*args, **kw)
            torch.cuda.synchronize()
            greg_ms.setdefault(current["object"], []).append(
                (1e3 * (time.perf_counter() - t1), float(res.fitness)))
            if current["object"] == TURNED and not first:
                first.append(args)
            return res

        phases = {}
        for flag in (False, True):
            calls.clear()
            with mock.patch.object(rec, "load_point_cloud", counted_load), \
                    mock.patch.object(greg, "global_registration",
                                      timed_greg):
                t0 = time.perf_counter()
                out = app.create_pose_data(LABEL_DS, global_regression=flag,
                                           device=dev)
                torch.cuda.synchronize()
                total_s = time.perf_counter() - t0
            stats, times = out["stats"], out["times"]
            check(stats["n_samples"] > 0 and len(times["pc"]) == len(names),
                  f"create_pose_data stats {stats}")
            rot_err = turned_rotation_error(root)
            # the turned object's labels differ between calls: the U-Nets
            # that make them train through 4-thread Loaders, which do not
            # repeat
            turned_labels = hashlib.sha256()
            for o, _, _, p in label_paths(root, "new_pred"):
                if o == TURNED:
                    turned_labels.update(io.read_label(p).tobytes())
            phase_a_ious = [iou(io.read_label(p) > 0, truth[(o, r, s)])
                            for o, r, s, p in label_paths(root, "new_pred")]
            good = {}
            for (o, r, _, _), v in zip(label_paths(root, "new_pred"),
                                       phase_a_ious):
                good[(o, r)] = good.get((o, r), 0) + (v >= 0.3)
            phases[flag] = {"s": round(total_s, 3), "stats": stats,
                            "phase_a_s": round(times["seg"][0], 3),
                            "phase_b_s": dict(zip(names, (round(v, 3) for v
                                                          in times["pc"]))),
                            "phase_c_s": dict(zip(names, (round(v, 3) for v
                                                          in times["pose"]))),
                            "nn_calls": dict(calls),
                            "phase_a_iou_min": round(min(phase_a_ious), 4),
                            "phase_a_iou_mean": round(float(np.mean(
                                phase_a_ious)), 4),
                            # the fewest views of a run with IoU >= 0.3:
                            # Phase B needs one
                            "phase_a_good_views_min": min(good.values()),
                            "turned_rotation_error_deg": rot_err,
                            "turned_new_pred_sha256":
                            turned_labels.hexdigest()[:16]}
            print(f"offline labeling create_pose_data global_regression="
                  f"{flag} " + json.dumps(phases[flag]))
        # the turned object's labels with the extra run, on the card
        pose_labels.create_pose_label(root, TURNED, with_extra=True,
                                      global_regression=True, device=dev)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - phase_t0
        nn_calls = knn.nn_cuda.launches
        others = (addloss.moments_cuda.launches,
                  addloss.moments_train_cuda.launches)
        check(nn_calls > 0, "no nn launch in the offline labeling")
        check(others == (0, 0), f"sym_moments launches in the offline "
              f"labeling {others}")
        turned_greg = greg_ms.get(TURNED, [])
        report["global_registration"] = {
            "turned_calls": len(turned_greg),
            "turned_ms_mean": round(float(np.mean([m for m, _ in
                                                   turned_greg])), 4),
            "turned_ms_max": round(max(m for m, _ in turned_greg), 4),
            "turned_fitness_min": round(min(f for _, f in turned_greg), 4),
            "turned_fitness_median": round(float(np.median(
                [f for _, f in turned_greg])), 4),
            "calls_all_objects": sum(len(v) for v in greg_ms.values())}

        # 5. the turned object, global registration included, on the card
        # and the CPU at a smaller scale: the same hypotheses, cloud and
        # labels
        turned = turned_card_vs_cpu(dev)
        fpfh = fpfh_card_vs_cpu(first[0])
        report["turned_card_vs_cpu"] = {**turned, **fpfh}
        report["create_pose_data"] = {str(k): v for k, v in phases.items()}
        report["main_path_s"] = round(main_s, 3)
        report["nn_calls"] = nn_calls
        report["cuts"] = (f"{LABEL_VIEWS} views a run of a scan's hundreds; "
                          "synthetic scenes; the U-Nets trained 1 and "
                          f"{PHASE_A_EPOCHS} epochs of 500")
        print("offline labeling " + json.dumps(report))
    return nn_calls


def turned_card_vs_cpu(dev) -> dict:
    """TURNED alone at 320x240 (fx = fy = 300), 8 views a run and 3 extra
    views, its rendered masks as the new_pred labels: Phases B and C with
    global registration at the production settings on the card and on the
    CPU, which must draw the same hypotheses and give clouds and labels
    within LABEL_ATOL. (At 640x480 and 20 views the CPU's run takes over
    800 s on the card machine's host.)"""
    import tempfile

    from autoposeestimation_tpu_torch.labeling import pose_labels
    from autoposeestimation_tpu_torch.ops import global_registration as greg
    from autoposeestimation_tpu_torch.reconstruction import (
        create_pointcloud as rec)
    from autoposeestimation_tpu_torch.utils import io, synthetic

    draws = []
    real_draw = greg.draw_samples

    def recorded_draw(*args, **kw):
        out = real_draw(*args, **kw)
        draws[-1].append(out)
        return out

    with tempfile.TemporaryDirectory() as base:
        cfg = synthetic.SynthConfig(img_h=240, img_w=320, fx=300.0, fy=300.0,
                                    n_viewpoints=8, noise=1.0)
        obj = next(o for o in pose_objects() if o.name == TURNED)
        pose = turn_pose()
        seconds = []
        for d in (dev, torch.device("cpu")):
            root = os.path.join(base, d.type)
            synthetic.make_dataset(root, objects=[obj], cfg=cfg)
            write_run(root, turned_object(obj, pose), TURNED_RUN, cfg, pose)
            write_run(root, turned_object(obj, pose), "extra",
                      synthetic.SynthConfig(**{**cfg.__dict__,
                                               "n_viewpoints": 3,
                                               "ring_height": 300.0}), pose)
            draws.append([])
            t0 = time.perf_counter()
            with mock.patch.object(greg, "draw_samples", recorded_draw):
                rec.load_point_cloud(
                    TURNED, io.pc_dir(root), root, mode="new_pred",
                    reference_point=np.zeros(3), n_viewpoints=30,
                    min_friends=20, min_dist=5, nb_neighbors=20, threshold=10,
                    voxel_size=2, voxel_size_out=5, global_regression=True,
                    icp_point2point=True, icp_point2plane=False, device=d)
                n_labels = pose_labels.create_pose_label(
                    root, TURNED, with_extra=True, global_regression=True,
                    device=d)
            if d.type == "cuda":
                torch.cuda.synchronize()
            seconds.append(round(time.perf_counter() - t0, 3))
        card, cpu = (os.path.join(base, k) for k in (dev.type, "cpu"))
        same_draws = (len(draws[0]) == len(draws[1]) > 0 and all(
            torch.equal(a, b) for a, b in zip(*draws)))
        check(same_draws, f"the CPU drew other hypotheses: {len(draws[1])} "
              f"draws against the card's {len(draws[0])}")
        cloud_err = {}
        for fn in (f"{TURNED}_out.ply", f"{TURNED}.ply", "foreground.ply",
                   f"{TURNED_RUN}.ply"):
            a = io.read_ply(os.path.join(io.pc_dir(card), TURNED, fn))
            b = io.read_ply(os.path.join(io.pc_dir(cpu), TURNED, fn))
            check(a.shape == b.shape, f"{fn}: {a.shape} on the card, "
                  f"{b.shape} on the CPU")
            cloud_err[fn] = float(np.abs(a - b).max())
            check(cloud_err[fn] <= LABEL_ATOL, f"{fn}: card vs CPU "
                  f"{cloud_err[fn]} mm")
        label_err = 0.0
        for run in io.list_runs(card, TURNED)[1:]:         # background first
            d = os.path.join(io.label_dir(card), TURNED, run)
            for f in sorted(os.listdir(d)):
                if f.endswith(".meta.json"):
                    a, b = (io.read_pose_label_meta(os.path.join(
                        io.label_dir(r), TURNED, run, f)) for r in (card, cpu))
                    label_err = max(label_err, max(float(np.abs(
                        np.asarray(a[k]) - np.asarray(b[k])).max())
                        for k in ("position", "rotation", "robot2object",
                                  "cam2robot")))
        check(label_err <= LABEL_ATOL, f"turned object labels: card vs CPU "
              f"{label_err}")
        return {"scale": "320x240, 8 views a run, 3 extra",
                "draws": len(draws[1]), "same_draws": same_draws,
                "cloud_points": len(io.read_ply(os.path.join(
                    io.pc_dir(cpu), TURNED, f"{TURNED}_out.ply"))),
                "cloud_max_abs_mm": cloud_err, "labels": n_labels,
                "label_max_abs": label_err, "card_s": seconds[0],
                "cpu_s": seconds[1]}


def turned_rotation_error(root: str) -> float:
    """The largest angle (degrees) between a turned-run label's rotation
    (robot2object) and the run's written object_pose."""
    from autoposeestimation_tpu_torch.utils import io

    d = os.path.join(io.label_dir(root), TURNED, TURNED_RUN)
    written = turn_pose()[:3, :3]
    worst = 0.0
    for f in sorted(os.listdir(d)):
        if f.endswith(".meta.json"):
            rot = io.read_pose_label_meta(os.path.join(d, f))[
                "robot2object"][:3, :3]
            c = (np.trace(rot.T @ written) - 1.0) / 2.0
            worst = max(worst, float(np.degrees(np.arccos(np.clip(c, -1, 1)))))
    return round(worst, 4)


def fpfh_card_vs_cpu(args) -> dict:
    """The first global registration of the turned object, its FPFH and
    correspondences on the card and on the CPU: how many points' features
    differ (beyond 1e-4) and how many correspondences."""
    from autoposeestimation_tpu_torch.ops import global_registration as greg
    from autoposeestimation_tpu_torch.ops import pointcloud as pc

    source, svalid, target, tvalid, voxel = args[:5]
    out = []
    for d in (source.device, torch.device("cpu")):
        s, sv, t, tv = (x.to(d) for x in (source, svalid, target, tvalid))
        fs = greg.compute_fpfh(s, sv, 5.0 * voxel,
                               normals=pc.estimate_normals(s, sv))
        ft = greg.compute_fpfh(t, tv, 5.0 * voxel,
                               normals=pc.estimate_normals(t, tv))
        out.append((fs.cpu(), ft.cpu(),
                    greg.feature_match(fs, ft, tv).cpu()))
    (fs, ft, m), (cfs, cft, cm) = out
    valid = svalid.cpu()
    return {"points": int(valid.sum()),
            "fpfh_points_differ": int((~torch.isclose(
                torch.cat([fs, ft]), torch.cat([cfs, cft]), rtol=1e-4,
                atol=1e-4).all(1)).sum()),
            "correspondences_differ": int((m != cm)[valid].sum())}


# --- phase 14: host shells and experiments --------------------------------

ACQ_VIEWS = 12           # generate_ring_path(12, n_via=1): 24 moves a run
ACQ_MOVE_S = 0.4         # a move of the travelling fake robot
ACQ_SWITCH_S = 0.15      # when its joints reach the move's target
ACQ_ATOL_MM = 1e-3       # robot2endEff_tf against an f64 recomputation
HAND_EYE_STATIONS = 10
HAND_EYE_ROT_ATOL = 1e-5
HAND_EYE_T_ATOL_MM = 0.01
YCB_CLASSES = 21
YCB_FRAMES = 16          # 3 objects a frame
YCB_POINTS = 2620        # points.xyz of a YCB-Video model
LINEMOD_OBJECTS = (1, 2)
LINEMOD_FRAMES = 16
LINEMOD_POINTS = 2000
SWEEP_P_VIEWPOINTS = (1.0, 0.5)


def rotvec_mat_f64(rv) -> np.ndarray:
    """Rodrigues' rotation of a rotation vector, f64."""
    rv = np.asarray(rv, np.float64)
    angle = np.linalg.norm(rv)
    if angle < 1e-12:
        return np.eye(3)
    k = rv / angle
    kx = np.asarray([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * kx @ kx


def rigid_mat(rot, trans) -> np.ndarray:
    tf = np.eye(4)
    tf[:3, :3], tf[:3, 3] = rot, trans
    return tf


def travelling_robot(fk_fn):
    """A FakeRobot whose joints reach a move's target ACQ_SWITCH_S into a
    move of ACQ_MOVE_S. The scan loop's extra-sample thread reads the
    start pose as the move begins and the target's while the robot still
    moves, so it captures one extra sample a move of >= 25 mm."""
    from autoposeestimation_tpu_torch.hardware import robot

    class TravellingRobot(robot.FakeRobot):
        @property
        def joints_deg(self):
            return (self._target if time.time() >= self._switch_at
                    else self._start)

        @joints_deg.setter
        def joints_deg(self, value):
            self._start = getattr(self, "_target", value)
            self._target = np.asarray(value, float)
            self._switch_at = time.time() + ACQ_SWITCH_S

    return TravellingRobot(fk_fn=fk_fn, move_duration=ACQ_MOVE_S)


def hand_eye_part(root: str) -> dict:
    """`collect_and_calibrate` through a FakeRobot and HAND_EYE_STATIONS
    stations, with `estimate_board_pose` patched to return the cam->board
    pose a known end->cam X implies (no board is rendered: OpenCV, which
    would find one, may be missing here); X recovered, written into the
    workspace's handEye_tf.json and read back."""
    import importlib.util

    from autoposeestimation_tpu_torch.hardware import camera, hand_eye, robot
    from autoposeestimation_tpu_torch.utils import synthetic

    try:
        hand_eye.get_board()
        cv2_state = "present"
    except ImportError:
        cv2_state = "absent: get_board raises ImportError, as the JAX " \
                    "package's would"
    rng = np.random.default_rng(14)
    x_true = rigid_mat(rotvec_mat_f64([0.1, -0.2, 0.3]), [20.0, -15.0, 40.0])
    board = rigid_mat(rotvec_mat_f64([0.05, 0.02, 0.4]), [300.0, 100.0, 10.0])
    ends = [rigid_mat(rotvec_mat_f64(rng.uniform(-0.8, 0.8, 3)),
                      rng.uniform(-300.0, 300.0, 3))
            for _ in range(HAND_EYE_STATIONS)]
    ctrl = robot.FakeRobot(fk_fn=lambda j: ends[int(round(j[0])) % len(ends)])
    cam = camera.FakeDepthCam(cfg=synthetic.SynthConfig(
        img_h=48, img_w=64, fx=56.0, fy=56.0))

    def board_pose(image, intr, board_def=None):
        return np.linalg.inv(ctrl.robot2end() @ x_true) @ board

    path = os.path.join(root, "hand_eye_calibration", "data",
                        "handEye_tf.json")
    targets = [np.deg2rad([i, 0, 0, 0, 0, 0]) for i in range(len(ends))]
    t0 = time.perf_counter()
    with mock.patch.object(hand_eye, "estimate_board_pose", board_pose):
        out = hand_eye.collect_and_calibrate(cam, ctrl, targets,
                                             out_path=path)
    secs = time.perf_counter() - t0
    x = out["end2cam"]
    rot_err = float(np.abs(x[:3, :3] - x_true[:3, :3]).max())
    t_err = float(np.abs(x[:3, 3] - x_true[:3, 3]).max())
    check(out["n_stations"] == HAND_EYE_STATIONS,
          f"hand-eye stations {out['n_stations']}")
    check(rot_err <= HAND_EYE_ROT_ATOL, f"hand-eye rotation error {rot_err}")
    check(t_err <= HAND_EYE_T_ATOL_MM, f"hand-eye translation error {t_err}")
    check(np.array_equal(hand_eye.load_hand_eye(path), x),
          "handEye_tf.json read back")
    print(f"host shells: hand-eye X from {HAND_EYE_STATIONS} stations in "
          f"{secs:.3f} s, rotation error {rot_err:.3e}, translation error "
          f"{t_err:.3e} mm; cv2 {cv2_state}")
    return {"x_true": x_true, "x": x, "s": round(secs, 4),
            "rotation_err": rot_err, "translation_err_mm": t_err,
            "host_modules": {m: importlib.util.find_spec(m) is not None
                             for m in ("cv2", "yaml", "PIL", "matplotlib")}}


def acquisition_part(root: str, x_true: np.ndarray, dev) -> dict:
    """`App.acquire_new_data_from_object` with a 640x480 FakeDepthCam and
    a travelling FakeRobot on `generate_ring_path(ACQ_VIEWS, n_via=1)`
    (the object placed when the App asks for the foreground run), then
    `fix_symmetric`, `clean_extra_data` and `App.create_labels` 'gen' on
    the card, checked against the renders; `gt_test` of the labels
    against the rendered masks."""
    from autoposeestimation_tpu_torch.acquisition import maintenance, paths
    from autoposeestimation_tpu_torch.experiments import gt_test
    from autoposeestimation_tpu_torch.hardware import camera, robot
    from autoposeestimation_tpu_torch.main import App
    from autoposeestimation_tpu_torch.utils import io, synthetic

    obj = pose_objects()[1]
    cfg = synthetic.SynthConfig(img_h=480, img_w=640, fx=600.0, fy=600.0,
                                n_viewpoints=ACQ_VIEWS)
    cams = synthetic.ring_cameras(cfg, np.zeros(3))
    fk = robot.ring_fk(cams, hand_eye=x_true)
    ctrl = travelling_robot(fk)
    cam = camera.FakeDepthCam(cfg=cfg, spheres=[],
                              robot2cam_fn=lambda: ctrl.robot2end() @ x_true)
    path = paths.generate_ring_path(ACQ_VIEWS, n_via=1)
    # a capture a move that travels >= 25 mm, from home, in both runs
    joints = [robot.HOME_JOINTS_DEG] + path["joints"]
    moves = sum(np.linalg.norm(fk(np.asarray(b))[:3, 3]
                               - fk(np.asarray(a))[:3, 3]) >= 25.0
                for a, b in zip(joints, joints[1:]))
    said = []

    def print_fn(line):
        said.append(line)
        if line.startswith("place/turn object"):
            cam.spheres = [obj]

    app = App(root, camera_factory=lambda: cam,
              controller_factory=lambda: ctrl, print_fn=print_fn,
              reference_point=np.zeros(3), device=str(dev))
    t0 = time.perf_counter()
    n = app.acquire_new_data_from_object(obj.name, path_data=path)
    acq_s = time.perf_counter() - t0
    data = os.path.join(io.data_dir(root), obj.name)
    extras = io.list_sample_ids(os.path.join(data, "extra"))
    check(n == 2 * ACQ_VIEWS, f"acquired views {n}")
    for run in ("background", "foreground"):
        check(len(io.list_sample_ids(os.path.join(data, run))) == ACQ_VIEWS,
              f"{run} views")
    check(len(extras) == 2 * moves, f"extra samples {len(extras)}, "
          f"{2 * moves} expected")
    hand_eye = app._load_hand_eye()
    worst = 0.0
    for run in ("background", "foreground", "extra"):
        for stem in io.list_sample_ids(os.path.join(data, run)):
            meta = io.read_sample_meta(os.path.join(data, run,
                                                    stem + ".meta.json"))
            pose = meta["pose"]
            want = rigid_mat(rotvec_mat_f64([pose["a"], pose["b"],
                                             pose["c"]]),
                             [pose["x"], pose["y"], pose["z"]])
            worst = max(worst, float(np.abs(meta["robot2endEff_tf"]
                                            - want).max()))
            check(np.array_equal(meta["hand_eye_calibration"], hand_eye),
                  f"{run}/{stem}: hand_eye_calibration")
    check(worst <= ACQ_ATOL_MM, f"robot2endEff_tf against f64: {worst}")
    fixed = maintenance.fix_symmetric(root, obj.name, symmetric=1)
    check(fixed == n + len(extras), f"fix_symmetric rewrote {fixed}")
    cleaned = maintenance.clean_extra_data(root, obj.name)
    check(cleaned == {"kept": len(extras), "deleted": 0},
          f"clean_extra_data {cleaned}")

    t0 = time.perf_counter()
    n_gen = app.create_labels([obj.name], mode="gen")
    torch.cuda.synchronize()
    gen_ms = 1e3 * (time.perf_counter() - t0) / max(n_gen, 1)
    check(n_gen == ACQ_VIEWS, f"gen labels {n_gen}")
    labels = os.path.join(io.label_dir(root), obj.name, "foreground")
    ious = []
    for k in range(ACQ_VIEWS):
        truth = synthetic.render(cfg, cams[k], [obj])[2] == 0
        label = io.read_label(os.path.join(labels, f"{k:06d}.gen.label.png"))
        ious.append(iou(label > 0, truth))
        io.write_png(os.path.join(labels, f"{k:06d}.gt.label.png"),
                     truth.astype(np.uint8) * 255)
    check(min(ious) > LABEL_IOU, f"gen label IoU, least {min(ious):.4f}")
    samples = gt_test.select_samples_for_gt_test(root, [obj.name], p=1.0)
    scores = gt_test.gt_test(root, [obj.name], modes=("gen",),
                             samples=samples)["gen"]
    check(scores["n"] == ACQ_VIEWS and scores["iou>=0.5"] == 1.0,
          f"gt_test {scores}")
    print(f"host shells: acquisition {n} views and {len(extras)} extra "
          f"samples in {acq_s:.2f} s, gen labels {gen_ms:.2f} ms a sample, "
          f"least IoU {min(ious):.4f}")
    return {"object": obj.name, "views": n, "extra_samples": len(extras),
            "s": round(acq_s, 3), "s_per_view": round(acq_s / n, 4),
            "robot2end_max_err_mm": worst, "fix_symmetric": fixed,
            "clean_extra_data": cleaned, "gen_labels": n_gen,
            "gen_ms_per_sample": round(gen_ms, 4),
            "gen_iou_min": round(min(ious), 4),
            "gt_test_gen": {"iou": round(scores["iou"], 4),
                            "iou>=0.5": scores["iou>=0.5"],
                            "n": scores["n"]}}


def write_ycb_tree(root: str, rng) -> tuple:
    """A YCB-Video tree at 640x480: YCB_CLASSES models of YCB_POINTS points
    (m), YCB_FRAMES frames of 3 objects (boxes of depth 0.83-0.97 m at
    factor_depth 10000 on a 1.2 m table; poses at their centres), half of
    them in videos >= 0060 (the second camera). Returns (frames,
    classes)."""
    import scipy.io as scio

    from autoposeestimation_tpu_torch.data import legacy_datasets
    from autoposeestimation_tpu_torch.utils import io

    classes = [f"{i:03d}_object" for i in range(1, YCB_CLASSES + 1)]
    for cls in classes:
        pts = rng.normal(size=(YCB_POINTS, 3)) * [0.04, 0.03, 0.05]
        os.makedirs(os.path.join(root, "models", cls))
        np.savetxt(os.path.join(root, "models", cls, "points.xyz"), pts,
                   fmt="%.6f")
    frames = []
    for f in range(YCB_FRAMES):
        stem = f"data/{(1 if f < YCB_FRAMES // 2 else 60):04d}/{f:06d}"
        fx, fy, ppx, ppy = (legacy_datasets.YCBPoseDataset.CAM_1 if
                            f < YCB_FRAMES // 2 else
                            legacy_datasets.YCBPoseDataset.CAM_2)
        ids = rng.choice(YCB_CLASSES, 3, replace=False) + 1
        label = np.zeros((480, 640), np.uint8)
        depth = np.full((480, 640), 12000, np.uint16)
        poses = []
        for k, cid in enumerate(ids):
            r0, c0 = 120 + 40 * k, 60 + 190 * k
            z = rng.uniform(0.83, 0.97)
            label[r0:r0 + 140, c0:c0 + 160] = cid
            depth[r0:r0 + 140, c0:c0 + 160] = np.round(
                (z + rng.normal(size=(140, 160)) * 0.002) * 10000)
            t = [(c0 + 80 - ppx) * z / fx, (r0 + 70 - ppy) * z / fy, z]
            poses.append(np.concatenate(
                [rotvec_mat_f64(rng.normal(size=3)), np.asarray(t)[:, None]],
                axis=1))
        base = os.path.join(root, stem)
        io.write_png(base + "-color.png",
                     rng.integers(0, 256, (480, 640, 3)).astype(np.uint8))
        io.write_png(base + "-depth.png", depth)
        io.write_png(base + "-label.png", label)
        scio.savemat(base + "-meta.mat", {
            "cls_indexes": ids[:, None].astype(np.float64),
            "poses": np.stack(poses, axis=2),
            "factor_depth": np.asarray([[10000.0]])})
        frames.append(stem)
    return frames, classes


def write_linemod_tree(root: str, rng) -> None:
    """A LineMOD tree at 640x480: objects LINEMOD_OBJECTS, ascii PLY models
    of LINEMOD_POINTS points (mm), LINEMOD_FRAMES test frames each with RGB
    masks and gt.yml in the upstream flow style (object 2's frames list
    object 1 too)."""
    from autoposeestimation_tpu_torch.data import legacy_datasets
    from autoposeestimation_tpu_torch.utils import io

    fx, fy, ppx, ppy = legacy_datasets.LineModPoseDataset.INTR
    for obj in LINEMOD_OBJECTS:
        io.write_ply(os.path.join(root, "models", f"obj_{obj:02d}.ply"),
                     rng.normal(size=(LINEMOD_POINTS, 3)) * [40, 30, 50])
        seq = os.path.join(root, "data", f"{obj:02d}")
        gt = []
        for fr in range(LINEMOD_FRAMES):
            r0, c0 = 150 + 3 * fr, 200 + 10 * obj
            z = rng.uniform(750.0, 900.0)
            depth = np.zeros((480, 640), np.uint16)
            depth[r0:r0 + 130, c0:c0 + 150] = np.round(
                z + rng.normal(size=(130, 150)) * 2.0)
            mask = np.zeros((480, 640, 3), np.uint8)
            mask[r0:r0 + 130, c0:c0 + 150] = 255
            name = f"{fr:04d}.png"
            io.write_png(os.path.join(seq, "rgb", name), rng.integers(
                0, 256, (480, 640, 3)).astype(np.uint8))
            io.write_png(os.path.join(seq, "depth", name), depth)
            io.write_png(os.path.join(seq, "mask", name), mask)
            gt.append(f"{fr}:")
            for o in ((1, 2) if obj == 2 else (1,)):
                rot = rotvec_mat_f64(rng.normal(size=3)).reshape(-1)
                t = [(c0 + 75 - ppx) * z / fx, (r0 + 65 - ppy) * z / fy, z]
                gt += [f"- cam_R_m2c: [{', '.join(f'{v:.8f}' for v in rot)}]",
                       f"  cam_t_m2c: [{', '.join(f'{v:.8f}' for v in t)}]",
                       f"  obj_bb: [{c0}, {r0}, 150, 130]",
                       f"  obj_id: {o}"]
        io.write_lines(os.path.join(seq, "gt.yml"), gt)
        frames = [f"{fr:04d}" for fr in range(LINEMOD_FRAMES)]
        io.write_lines(os.path.join(seq, "test.txt"), frames)
        io.write_lines(os.path.join(seq, "train.txt"), frames)


def legacy_part(root: str, dev, recorded: dict):
    """`eval_ycb` (PoseNet and refiner of 21 objects) and `eval_linemod`
    (15 objects) at DFConfig defaults (N=1000, M=500, batch 8, refiner
    phase, 2 iterations) on written trees, with random weights from a seed;
    the first batch of each and its distances kept in `recorded`. Returns
    the report and, by name, a call that runs each evaluation again and one
    that makes its dataset."""
    from autoposeestimation_tpu_torch.data import legacy_datasets
    from autoposeestimation_tpu_torch.experiments import legacy_eval
    from autoposeestimation_tpu_torch.train import densefusion as dft

    rng = np.random.default_rng(141)
    ycb_root, lm_root = (os.path.join(root, d) for d in ("ycb", "linemod"))
    t0 = time.perf_counter()
    frames, classes = write_ycb_tree(ycb_root, rng)
    write_linemod_tree(lm_root, rng)
    write_s = time.perf_counter() - t0
    eval_step = dft.eval_step

    def recording(name):
        def step(posenet, refiner, batch, *args):
            dis = eval_step(posenet, refiner, batch, *args)
            if name not in recorded:
                recorded[name] = (posenet, refiner, batch, args, dis.clone())
            return dis
        return step

    out = {"write_s": round(write_s, 3)}
    states = {}
    runs = (("ycb", YCB_CLASSES, lambda st: legacy_eval.eval_ycb(
                st, ycb_root, frames, classes,
                out_path=os.path.join(root, "ycb.json"))),
            ("linemod", 15, lambda st: legacy_eval.eval_linemod(
                st, lm_root, list(LINEMOD_OBJECTS),
                out_path=os.path.join(root, "linemod.json"))))
    for name, num_obj, run in runs:
        state = dft.create_trainer(num_obj, dft.DFConfig(), seed=14,
                                   device=dev)
        state.refine_start = True
        with mock.patch.object(dft, "eval_step", recording(name)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run(state)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        n = (res["overall"]["n"] if "overall" in res
             else sum(v["hit"] + v["miss"] for v in res.values()))
        batches = -(-n // 8)
        check(n == (YCB_FRAMES if name == "ycb"
                    else LINEMOD_FRAMES * len(LINEMOD_OBJECTS)),
              f"{name}: evaluated samples {n}")
        for cls, v in res.items():
            if cls != "overall" and v["hit"] + v["miss"]:
                check(np.isfinite(v["dis"]), f"{name} {cls}: dis {v['dis']}")
        out[name] = {"samples": n, "batches": batches,
                     "ms_per_batch": round(1e3 * secs / batches, 4),
                     "samples_per_s": round(n / secs, 3)}
        states[name] = state
    sizes = dict(num_pt=1000, num_pt_mesh=500)      # the evaluations' own
    datasets = {
        "ycb": lambda: legacy_datasets.YCBPoseDataset(
            ycb_root, frames, classes, **sizes),
        "linemod": lambda: legacy_datasets.LineModPoseDataset(
            lm_root, list(LINEMOD_OBJECTS), mode="test", **sizes)}
    return out, {name: functools.partial(run, states[name])
                 for name, _, run in runs}, datasets


def legacy_kernel_vs_plain(recorded: dict) -> float:
    """Each recorded batch again with the plain moments: `dis` within
    DIS_ATOL, and the same hits but within DIS_ATOL of a threshold (YCB's
    2 cm; LineMOD's 10 % of a diameter, none of which is near 2 cm)."""
    from autoposeestimation_tpu_torch.ops import addloss
    from autoposeestimation_tpu_torch.train import densefusion as dft

    worst = 0.0
    for name, (posenet, refiner, batch, args, got) in recorded.items():
        with mock.patch.object(addloss, "moments_cuda", addloss.moments_plain):
            want = dft.eval_step(posenet, refiner, batch, *args)
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        check(err <= DIS_ATOL, f"{name}: kernel vs plain dis error {err}")
        if name == "ycb":
            near = (want - 0.02).abs() <= DIS_ATOL
            check(torch.equal((got < 0.02) | near, (want < 0.02) | near),
                  f"{name}: hits, kernel vs plain")
    return worst


def sweeps_part(root: str, pose_root: str, dev) -> dict:
    """`train_pose_estimation_exp` over p_viewpoints SWEEP_P_VIEWPOINTS x
    label mode 'gen', one epoch a run at DFConfig defaults (bf16 sym), on
    phase 10's dataset; then `eval_exp` over the runs and
    `plot_pose_exp_results`; each run's pose_model.npz read back."""
    from autoposeestimation_tpu_torch import weights
    from autoposeestimation_tpu_torch.experiments import sweeps
    from autoposeestimation_tpu_torch.models.densefusion import PoseNet
    from autoposeestimation_tpu_torch.train import checkpoints
    from autoposeestimation_tpu_torch.train import densefusion as dft

    runs_dir = os.path.join(root, "pose_runs")
    cfg = dft.DFConfig()
    t0 = time.perf_counter()
    stats = sweeps.train_pose_estimation_exp(
        pose_root, POSE_DS, p_viewpoints_grid=SWEEP_P_VIEWPOINTS,
        label_modes=("gen",), epochs=2, cfg=cfg, out_base=runs_dir,
        device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = sweeps.eval_exp(pose_root, POSE_DS, runs_dir=runs_dir,
                              exp_name="phase14", cfg=cfg, device=dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    best = sweeps.plot_pose_exp_results(runs_dir)
    names = [r["name"] for r in stats["runs"]]
    check(len(names) == len(SWEEP_P_VIEWPOINTS), f"sweep runs {names}")
    check(os.path.exists(os.path.join(runs_dir, "sweep_stats.json")),
          "sweep_stats.json")
    check(os.path.exists(os.path.join(runs_dir,
                                      "phase14_exp_eval_results.json")),
          "phase14_exp_eval_results.json")
    check(sorted(results) == sorted(names) == sorted(best),
          f"eval_exp runs {sorted(results)}, curves {sorted(best)}")
    for name in names:
        check(np.isfinite(results[name]["overall"]["p"])
              and results[name]["overall"]["n"] > 0, f"{name}: eval_exp")
        check(best[name]["n_epochs"] == 1, f"{name}: curves {best[name]}")
        PoseNet(5).load_state_dict(weights.posenet_state_dict(
            checkpoints.load_checkpoint(os.path.join(
                runs_dir, name, "pose_model"))["variables"]))
    return {"runs": {r["name"]: {"s": round(r["seconds"], 3),
                                 "best_test": round(r["best_test"], 6)}
                     for r in stats["runs"]},
            "train_s": round(train_s, 3), "eval_exp_s": round(eval_s, 3),
            "eval_exp_overall": {k: v["overall"] for k, v in results.items()}}


def menu_part(root: str, dev) -> dict:
    """`App.main` with a scripted `input_fn`: visualise -> segmentation
    masks -> the acquired object; acquire new data from object with no
    path (the action fails, the menu goes on); quit. The default show
    draws through a recording matplotlib stand-in."""
    import types

    from autoposeestimation_tpu_torch.hardware import camera, robot
    from autoposeestimation_tpu_torch.main import App
    from autoposeestimation_tpu_torch.utils import synthetic

    shown, said = [], []
    plt = types.SimpleNamespace(imshow=shown.append, pause=lambda s: None)
    script = iter(["7", "0", "0", "0", "menu_object", "10"])
    app = App(root, camera_factory=lambda: camera.FakeDepthCam(
        cfg=synthetic.SynthConfig(img_h=48, img_w=64, fx=56.0, fy=56.0)),
        controller_factory=robot.FakeRobot, input_fn=lambda q: next(script),
        print_fn=said.append, device=str(dev))
    t0 = time.perf_counter()
    with mock.patch.dict(sys.modules, {
            "matplotlib": types.SimpleNamespace(pyplot=plt),
            "matplotlib.pyplot": plt}):
        app.main()
    secs = time.perf_counter() - t0
    failed = [line for line in said if line.startswith("action failed")]
    check(len(shown) == ACQ_VIEWS, f"menu: {len(shown)} frames shown")
    check(len(failed) == 1 and said.count("Select action:") == 3,
          f"menu: {failed}, {said.count('Select action:')} menus")
    print(f"host shells: the menu showed {len(shown)} frames, printed "
          f"{len(said)} lines; acquire without a path: {failed[0]}")
    return {"frames_shown": len(shown), "lines": len(said),
            "failed": failed[0], "s": round(secs, 3)}


def host_shells_phase(dev, pose_root=None):
    """Phase 14: the host shells and the experiments through their entry
    points on the card: hand-eye calibration, a scan's acquisition,
    maintenance and labels, `gt_test`, the YCB-Video and LineMOD ADD(-S)
    evaluations at full width, the training sweeps and their evaluation on
    phase 10's dataset (written into `pose_root`, or here when None), and
    the App's menu. Returns the launches of (sym_moments,
    sym_moments_train) in that run."""
    import tempfile

    from autoposeestimation_tpu_torch.ops import addloss
    from autoposeestimation_tpu_torch.train import densefusion as dft

    report = {"card": nvidia_smi("name,power.limit")}
    recorded = {}
    with contextlib.ExitStack() as stack:
        tmp = stack.enter_context(tempfile.TemporaryDirectory())
        if pose_root is None:
            pose_root = os.path.join(tmp, "pose")
            write_pose_dataset(pose_root)
        workspace = os.path.join(tmp, "workspace")

        # the main path: counts from 0 just before, read just after
        addloss.moments_cuda.launches = 0
        addloss.moments_train_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hand_eye = hand_eye_part(workspace)
        report["acquisition"] = acquisition_part(workspace,
                                                 hand_eye.pop("x_true"), dev)
        hand_eye.pop("x")
        report["hand_eye"] = hand_eye
        fwd0 = addloss.moments_cuda.launches
        legacy, reruns, datasets = legacy_part(os.path.join(tmp, "legacy"),
                                               dev, recorded)
        fwd_legacy = addloss.moments_cuda.launches - fwd0
        fwd0 = addloss.moments_cuda.launches
        report["sweeps"] = sweeps_part(tmp, pose_root, dev)
        report["menu"] = menu_part(workspace, dev)
        torch.cuda.synchronize()
        report["main_path_s"] = round(time.perf_counter() - t0, 3)
        fwd = addloss.moments_cuda.launches
        train = addloss.moments_train_cuda.launches
        # one a batch, in the estimator's loss
        check(fwd_legacy == legacy["ycb"]["batches"]
              + legacy["linemod"]["batches"],
              f"legacy sym_moments launches {fwd_legacy}")
        check(fwd - fwd0 > 0, "sweeps: sym_moments not launched")
        check(train > 0, "sweeps: sym_moments_train not launched")
        report["launches"] = {"sym_moments": fwd, "sym_moments_legacy":
                              fwd_legacy, "sym_moments_sweeps": fwd - fwd0,
                              "sym_moments_train": train}

        # outside the main path: the plain moments on the recorded
        # batches; each evaluation again, warm, and where eval_ycb's time goes
        report["legacy_kernel_vs_plain_max_dis_err"] = \
            legacy_kernel_vs_plain(recorded)
        for name, rerun in reruns.items():
            t0 = time.perf_counter()
            rerun()
            torch.cuda.synchronize()
            legacy[name]["warm_ms_per_batch"] = round(
                1e3 * (time.perf_counter() - t0) / legacy[name]["batches"],
                4)
        ycb = legacy["ycb"]
        seen = profile(reruns["ycb"], "legacy eval_ycb, per batch",
                       ycb["batches"], ycb["warm_ms_per_batch"],
                       ("sym_moments",))
        if seen:
            ycb["device_ms_per_batch"] = round(seen[0], 4)
            ycb["kernels_per_batch"] = round(seen[1], 1)
            ycb["busy_share"] = round(seen[0] / ycb["warm_ms_per_batch"], 4)
        # an evaluation batch split: the dataset a sample on one thread, the
        # Loader's rate, the step on a batch staged on the card
        for name, make in datasets.items():
            ds = make()
            t0 = time.perf_counter()
            for i in range(len(ds)):
                ds[i]
            legacy[name]["sample_ms"] = round(
                1e3 * (time.perf_counter() - t0) / len(ds), 4)
            legacy[name]["loader_samples_per_s"] = {
                str(w): round(loader_rate(ds, w, len(ds)), 3)
                for w in (0, 4)}
            posenet, refiner, batch, args, _ = recorded[name]
            legacy[name]["staged_step_ms"] = round(timed_steps(
                lambda: dft.eval_step(posenet, refiner, batch, *args), 8), 4)
        report["legacy"] = legacy
    print("host shells and experiments " + json.dumps(report))
    return fwd, train


# --- phase 15: the U-Net's out_stride and parallelism -------------------------

PARALLEL_STEPS = 4       # staged steps timed per data_parallel mode
PARALLEL_BACKEND = "nccl"
STRIDE_FRAMES = 12       # a timed window of phase 15: the 4 views, cycled


def out_stride_timing(dev) -> dict:
    """bf16 at the headline geometry (emb_stride 8): frames/s of
    `full_prediction` and `serve_stream(batch=4)` at seg_out_stride 1 and 4
    in 3 rounds that alternate the strides, and the U-Net's time a frame at
    each stride (CUDA events; device time from the profiler)."""
    from autoposeestimation_tpu_torch.models.common import normalize_imagenet
    from autoposeestimation_tpu_torch.pipeline import predict

    frames, meta, model_points, classes = headline_frames()
    inputs = stream_inputs(frames, meta, STRIDE_FRAMES)
    gen = torch.Generator(device=dev).manual_seed(0)
    names = (STREAM_MODES[0], STREAM_MODES[2])
    runs = {}
    for stride in (1, 4):
        models = predict.build_models(
            len(classes), model_points, classes, dtype=torch.bfloat16,
            seg_out_stride=stride, device=dev, **STREAM_MODEL)
        modes = stream_modes(models, gen)
        runs[stride] = (models, {name: modes[name] for name in names})
        for run in runs[stride][1].values():            # warm-up
            run(inputs[:4])
    fps = {(stride, name): [] for stride in runs for name in names}
    for _ in range(3):
        for name in names:
            for stride in (1, 4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = runs[stride][1][name](inputs)
                fps[stride, name].append(
                    len(inputs) / (time.perf_counter() - t0))
                check(len(outs) == len(inputs),
                      f"seg_out_stride={stride} {name}: {len(outs)} results")
                for out in outs:
                    check_prediction(dict(out, elapsed_times=None),
                                     (480, 640))
    x = normalize_imagenet(torch.as_tensor(
        frames[0][0], device=dev).permute(2, 0, 1))[None]
    result = {}
    for stride, (models, _) in runs.items():
        with torch.inference_mode():
            wall = cuda_ms(lambda: models.seg_model(x), 8)
            prof = profile(lambda: [models.seg_model(x) for _ in range(4)],
                           f"U-Net seg_out_stride={stride}, per frame", 4,
                           wall)
        result[f"seg_out_stride={stride}"] = dict(
            {name: {"frames_per_s": [round(f, 4) for f in fps[stride, name]],
                    "median": round(float(np.median(fps[stride, name])), 4)}
             for name in names},
            unet_ms=round(wall, 4),
            unet_device_ms=None if prof is None else round(prof[0], 4),
            unet_kernels=None if prof is None else round(prof[1], 1))
    return result


def parallel_one_rank(dev, tmp: str) -> dict:
    """A one-rank NCCL group, on which a mesh runs every collective: the
    full-width `train()` (5 objects, bf16, crop 320, B=8, N=1000, M=500)
    with data_parallel 'on' against 'off' (parameters equal under
    deterministic algorithms) and the staged estimator step's ms in each
    mode; one segmentation `train_step` (U-Net ResNet34, synced BatchNorm,
    SGD) 'on' against 'off'; `load_point_cloud(mesh=)` against the
    streaming run on phase 9's 160x128 configuration; and
    `dryrun_multichip(1, "product")`. The kernel launches of the run, from
    0."""
    import datetime

    import torch.distributed as dist

    from autoposeestimation_tpu_torch import weights
    from autoposeestimation_tpu_torch.models.common import (init_like_flax,
                                                            sync_batchnorm)
    from autoposeestimation_tpu_torch.ops import addloss, knn
    from autoposeestimation_tpu_torch.parallel import dryrun
    from autoposeestimation_tpu_torch.parallel import mesh as pmesh
    from autoposeestimation_tpu_torch.reconstruction import (
        create_pointcloud as rec)
    from autoposeestimation_tpu_torch.train import densefusion as dft
    from autoposeestimation_tpu_torch.train import segmentation as seg
    from autoposeestimation_tpu_torch.utils import io, synthetic

    report = {}
    pmesh.init_group(0, 1, os.path.join(tmp, "store"), PARALLEL_BACKEND,
                     datetime.timedelta(seconds=60))
    try:
        check(dist.get_backend() == PARALLEL_BACKEND,
              f"backend {dist.get_backend()}")
        mesh = pmesh.make_mesh()
        _, _, model_points = synthetic.headline_scene()
        batches = eval_batches(dev, model_points, n_batches=3)
        # the main path: counts from 0 just before, read just after
        addloss.moments_cuda.launches = 0
        addloss.moments_train_cuda.launches = 0
        knn.nn_cuda.launches = 0
        # 'off' twice: the PSPNet's adaptive pooling has no deterministic
        # backward on the card, so two runs of one mode differ at rounding
        # level, which Adam's first steps turn into moves of up to 2 lr
        # (Adam is blind to the gradient's scale: the logged loss and
        # gradient norm are held too)
        states, curves = {}, {}
        for mode in ("off", "on", "off again"):
            cfg = dft.DFConfig(data_parallel=mode.split()[0], start_epoch=0)
            state = dft.create_trainer(5, cfg, device=dev)
            t0 = time.perf_counter()
            out_dir = os.path.join(tmp, mode.replace(" ", "_"))
            dft.train(state, lambda: iter(batches[:2]),
                      lambda: iter(batches[2:]), out_dir, epochs=1,
                      save_resume=False)
            torch.cuda.synchronize()
            states[mode] = state
            with open(os.path.join(out_dir, "losses.json")) as f:
                curves[mode] = json.load(f)["curves"]
            report[f"train_{mode.replace(' ', '_')}_s"] = round(
                time.perf_counter() - t0, 4)
        leaves = {m: tree_leaves(weights.posenet_variables(
            states[m].posenet)) for m in states}
        for other in ("on", "off again"):
            moved = max(float(np.abs(a - b).max())
                        for a, b in zip(leaves[other], leaves["off"]))
            far = sum(int((np.abs(a - b) > 0.02 * cfg.lr).sum())
                      for a, b in zip(leaves[other], leaves["off"]))
            rel = {key: abs(curves[other][key][0] / curves["off"][key][0]
                            - 1)
                   for key in ("losses", "grad_norm_max", "test_dists")}
            report[f"train_{other.replace(' ', '_')}_vs_off"] = {
                "max_param_diff": moved, "params_beyond_2pct_lr": far,
                "rel_diff": rel}
            # two steps of Adam: each move within 2 lr of the other's
            check(moved <= 2 * 2 * cfg.lr and rel["losses"] <= 1e-2
                  and rel["grad_norm_max"] <= 1e-2,
                  f"train(): '{other}' against 'off': parameters {moved} "
                  f"apart, {rel}")
        # the staged estimator step with and without the mesh
        state = states["on"]
        steps = [dft.to_device(b, dev) for b in batches[:2]]
        gen = torch.Generator(device=dev).manual_seed(0)
        cycle = itertools.cycle(steps)
        for m in (None, mesh):
            dft.estimator_step(state.posenet, state.optimizer, next(cycle),
                               state.w, True, True, gen, m)
        report["estimator_step_ms"] = {
            key: [round(timed_steps(lambda: dft.estimator_step(
                state.posenet, state.optimizer, next(cycle), state.w, True,
                True, gen, m), PARALLEL_STEPS), 4) for _ in range(2)]
            for key, m in (("off", None), ("on", mesh))}

        # one segmentation step, synced BatchNorm over the one-rank group
        cfg = seg.SegConfig(classes=6, lr=1e-3, optimizer="sgd")
        rng = np.random.default_rng(9)
        batch = seg.to_device({
            "image": rng.normal(size=(4, 256, 256, 3)).astype(np.float32),
            "label": rng.integers(0, 6, (4, 256, 256))}, dev)
        nets = {}
        for mode in ("off", "on"):
            net = seg.build_model(cfg, dtype=torch.float32)
            init_like_flax(net, torch.Generator().manual_seed(2))
            net.to(dev)
            if mode == "on":
                sync_batchnorm(net, mesh.groups["data"])
            opt = seg.make_optimizer(cfg, net.parameters())
            t0 = time.perf_counter()
            out = seg.train_step(net, opt, batch, cfg.classes,
                                 mesh if mode == "on" else None)
            torch.cuda.synchronize()
            nets[mode] = (net, float(out["loss"]), out["conf"].cpu(),
                          time.perf_counter() - t0)
        err = max((a - b).abs().max().item() for a, b in zip(
            nets["on"][0].parameters(), nets["off"][0].parameters()))
        check(err <= 1e-4, f"segmentation step: parameters {err} apart")
        check(abs(nets["on"][1] - nets["off"][1]) <= 1e-5 * nets["off"][1],
              f"segmentation step: loss {nets['on'][1]} vs "
              f"{nets['off'][1]}")
        report["segmentation_step"] = {
            "max_param_diff": err, "loss": [nets["off"][1], nets["on"][1]],
            "confusion_equal": bool(torch.equal(nets["on"][2],
                                                nets["off"][2])),
            "first_step_s": [round(nets[m][3], 4) for m in ("off", "on")]}

        # reconstruction, views over the mesh, against the streaming run
        root = os.path.join(tmp, "ball")
        write_ball_dataset(root)
        clouds = []
        for m in (None, mesh):
            t0 = time.perf_counter()
            rec.load_point_cloud("ball", os.path.join(root, str(len(clouds))),
                                 root, **SMALL, mesh=m, device=dev)
            clouds.append((io.read_ply(os.path.join(
                root, str(len(clouds)), "ball", "ball_out.ply")),
                time.perf_counter() - t0))
        (stream, stream_s), (sharded, sharded_s) = clouds
        sym = (mean_nn(stream, sharded) + mean_nn(sharded, stream)) / 2
        count_rel = abs(len(sharded) - len(stream)) / len(stream)
        check(count_rel <= 0.02 and sym < SMALL["voxel_size"],
              f"load_point_cloud(mesh=): {len(sharded)} vs {len(stream)} "
              f"points, symmetric mean NN {sym} mm")
        report["load_point_cloud"] = {
            "points": [len(stream), len(sharded)],
            "sym_mean_nn_mm": round(float(sym), 4),
            "s": [round(stream_s, 4), round(sharded_s, 4)]}

        t0 = time.perf_counter()
        summary = dryrun.dryrun_multichip(1, "product")[0]
        check(np.isfinite(summary["loss"]) and np.isfinite(
            summary["refine_dis"]) and summary["recon_views"] == 1,
            f"dryrun_multichip(1): {summary}")
        report["dryrun_1_s"] = round(time.perf_counter() - t0, 4)
        torch.cuda.synchronize()
        report["launches"] = {
            "sym_moments": addloss.moments_cuda.launches,
            "sym_moments_train": addloss.moments_train_cuda.launches,
            "nn": knn.nn_cuda.launches}
    finally:
        dist.destroy_process_group()
    for name, count in report["launches"].items():
        check(count > 0, f"phase 15: {name} not launched")
    return report


# --- phase 16: train stages, prefixes, FLOP counts, profiling, the demo -----

STAGE_CHAIN = 20          # dependent calls timed per train stage and prefix
# graphs whose count must be within FLOP_GATE of the JAX package's (the
# convolution-bound ones; the others' gaps are elementwise work that XLA
# counts and FlopCounterMode does not)
FLOP_GATED = ("train_stage_pspnet_fwd", "train_stage_posenet_fwd",
              "serving_prefix_seg", "serving_graph")
FLOP_GATE = 0.05
# the multi-object demo cut to fit the phase: the headline geometry
# (640x480, 5 objects, 500 points, crop 160) with 8 views an object (of
# 48), 1 segmentation epoch (of 10) and 2 pose epochs (of 120), then the
# attribution and the mask IoU over 4 held-out frames (of 36)
DEMO_VIEWS = 8
DEMO_SEG_EPOCHS = 1
DEMO_POSE_EPOCHS = 2
DEMO_FRAMES = 4


def chain_ms(step, carry, count: int):
    """(ms per call, carry, out) of `count` dependent calls of
    `step(carry, i)` between CUDA events, after one call that warms up."""
    carry, out = step(carry, 0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(1, count + 1):
        carry, out = step(carry, i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count, carry, out


def jax_flop_counts() -> dict:
    """The JAX package's counts of the benchmarked graphs, read as data
    from `artifacts/flops_cache.json` (XLA's CPU cost analysis): name ->
    FLOPs, for the entries whose config is the port's."""
    from autoposeestimation_tpu_torch.utils import flops

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "artifacts", "flops_cache.json")
    with open(path) as f:
        table = json.load(f)
    out = {}
    for key, value in table.items():
        name = key.split(":", 1)[0]
        if key == name + ":" + json.dumps(flops.GRAPH_CONFIGS.get(name),
                                          sort_keys=True):
            out[name] = float(value)
    return out


def launch_counts():
    from autoposeestimation_tpu_torch.ops import addloss

    return addloss.moments_cuda.launches, addloss.moments_train_cuda.launches


def flop_row(name: str, count: int, jax_counts: dict,
             ms: float = None) -> dict:
    """The graph's GFLOPs (and TF/s at `ms` a call) beside the JAX
    package's count; a gated graph must be within FLOP_GATE of it."""
    row = {"gflop": round(count / 1e9, 4)}
    if ms is not None:
        row["tflops"] = round(count / (ms * 1e-3) / 1e12, 3)
    want = jax_counts.get(name)
    check(want is not None or name not in FLOP_GATED,
          f"{name}: no count of the JAX package")
    if want is not None:
        row["jax_gflop"] = round(want / 1e9, 4)
        row["ratio"] = round(count / want, 4)
        if name in FLOP_GATED:
            check(abs(count / want - 1) <= FLOP_GATE,
                  f"{name}: {count} FLOPs against the JAX package's {want}")
    return row


def stage_kernels_vs_plain(steps, carries) -> dict:
    """Rows 1 and 2 at the loss stages' inputs (B=8, N=1000, M=500): each
    kernel's output against its plain version on the same inputs, and the
    stages' outputs through the kernels against the plain versions."""
    from autoposeestimation_tpu_torch.ops import addloss
    from autoposeestimation_tpu_torch.utils import flops

    recorded = {"fwd": [], "train": []}
    keys = {addloss.moments_cuda: "fwd", addloss.moments_train_cuda: "train"}
    hand_kernel = flops.hand_kernel

    def recording(count, fn, *args):
        out = hand_kernel(count, fn, *args)
        recorded[keys[fn]].append((args, out))
        return out

    outs = {}
    with mock.patch.object(flops, "hand_kernel", recording):
        for name in ("symloss_fwd", "symloss_fwd_bwd"):
            outs[name] = steps[name](carries[name], 0)[1]
    with mock.patch.object(addloss, "moments_cuda", addloss.moments_plain), \
            mock.patch.object(addloss, "moments_train_cuda",
                              addloss.moments_train_plain):
        plain = {name: steps[name](carries[name], 0)[1]
                 for name in ("symloss_fwd", "symloss_fwd_bwd")}
    check(len(recorded["fwd"]) == 1 and len(recorded["train"]) == 1,
          f"loss stages' kernel calls: {[len(v) for v in recorded.values()]}")
    (args, (dis, var)), = recorded["fwd"]
    want_dis, want_var = addloss.moments_plain(*args)
    err_dis = (dis - want_dis).abs().max().item()
    err_std = (var.clamp(min=0).sqrt()
               - want_var.clamp(min=0).sqrt()).abs().max().item()
    check(err_dis <= DIS_ATOL and err_std <= STD_ATOL,
          f"symloss_fwd: sym_moments dis {err_dis}, std {err_std}")
    (args, got), = recorded["train"]
    want = addloss.moments_train_plain(*args)
    m = args[2].shape[1]
    err_tdis = (got[..., 24] - want[..., 24]).abs().max().item()
    off = (got[..., :24] - want[..., :24]).abs().amax(dim=-1)
    n_off = int((off > PRE_ATOL).sum().item())
    check(err_tdis <= DIS_ATOL, f"symloss_fwd_bwd: dis {err_tdis}")
    check(off.max().item() <= 4.0 / m and n_off <= max(1, off.numel() // 1000),
          f"symloss_fwd_bwd: precursors {off.max().item()}, {n_off} "
          f"candidates outside {PRE_ATOL}")
    loss_err = abs(outs["symloss_fwd"].item() - plain["symloss_fwd"].item())
    check(loss_err <= 1e-4, f"symloss_fwd loss: kernel against plain "
          f"{loss_err}")
    report = {"shape": list(args[0].shape[:2]) + [m],
              "sym_moments": {"max_dis_err": err_dis,
                              "max_std_err": err_std},
              "sym_moments_train": {"max_dis_err": err_tdis,
                                    "max_precursor_err": off.max().item(),
                                    "outside_pre_atol": n_off},
              "symloss_fwd_loss_err": loss_err,
              "symloss_fwd_bwd_grad": [outs["symloss_fwd_bwd"].item(),
                                       plain["symloss_fwd_bwd"].item()]}
    print("stage kernels against plain " + json.dumps(report))
    return report


def train_stages_part(steps, carries, jax_counts: dict) -> dict:
    """Every train stage at full width: its FLOPs (one call, counted),
    then STAGE_CHAIN dependent calls timed, with rows 1-2's launches."""
    from autoposeestimation_tpu_torch.utils import flops, train_stages

    report = {}
    for name in train_stages.TRAIN_STAGE_ORDER:
        with flops.counting() as count:
            carries[name], _ = steps[name](carries[name], 0)
        fwd0, train0 = launch_counts()
        ms, carries[name], out = chain_ms(steps[name], carries[name],
                                          STAGE_CHAIN)
        fwd, train = launch_counts()
        check(bool(torch.isfinite(out).all().item()), f"{name}: {out}")
        row = {"ms": round(ms, 4), **flop_row(
            f"train_stage_{name}", count.total, jax_counts, ms),
            "kernel_gflop": round(count.kernels / 1e9, 4),
            "launches": {"sym_moments": fwd - fwd0,
                         "sym_moments_train": train - train0}}
        report[name] = row
        print(f"train stage {name}: {json.dumps(row)}")
    check(report["symloss_fwd"]["launches"]["sym_moments"] > 0
          and report["symloss_fwd_bwd"]["launches"]["sym_moments_train"] > 0
          and report["estimator_step"]["launches"]["sym_moments_train"] > 0,
          "the loss stages did not launch rows 1-2")
    return report


def serving_prefixes_part(dev, jax_counts: dict) -> dict:
    """Every prefix of the frame graph at the headline geometry, at
    seg_out_stride 1 and 4: FLOPs, ms per call over STAGE_CHAIN dependent
    calls, and each stage's cost as the difference of consecutive
    prefixes."""
    from autoposeestimation_tpu_torch.utils import flops, serving_stages

    report = {}
    for stride in (1, 4):
        steps, models = serving_stages.build_prefixes(seg_out_stride=stride,
                                                      device=dev)
        suffix = "" if stride == 1 else "_u4"
        rows, last = {}, 0.0
        for name in serving_stages.PREFIX_ORDER:
            with flops.counting() as count:
                steps[name](serving_stages.initial_carry(dev), 0)
            ms, _, out = chain_ms(steps[name],
                                  serving_stages.initial_carry(dev),
                                  STAGE_CHAIN)
            check(out.numel() > 0, f"prefix {name}: empty output")
            if out.is_floating_point():
                check(bool(torch.isfinite(out).all().item()),
                      f"prefix {name}: {out}")
            rows[name] = {"ms": round(ms, 4),
                          "stage_ms": round(ms - last, 4),
                          "stage": serving_stages.STAGE_LABELS[name],
                          **flop_row(f"serving_prefix_{name}{suffix}",
                                     count.total, jax_counts, ms)}
            last = ms
            print(f"serving prefix {name} seg_out_stride={stride}: "
                  f"{json.dumps(rows[name])}")
        report[f"seg_out_stride_{stride}"] = rows
        del steps, models
    for name in ("serving_graph", "serving_graph_u4"):
        report[name] = flop_row(name, flops.cached_flops(name, dev),
                                jax_counts)
    print("serving graphs " + json.dumps(
        {k: report[k] for k in ("serving_graph", "serving_graph_u4")}))
    return report


def profile_part(steps, carries) -> dict:
    """`maybe_profile` around one estimator step: its Chrome trace exists
    and names the training kernel."""
    import tempfile

    from autoposeestimation_tpu_torch.utils import timing

    with tempfile.TemporaryDirectory() as tmp:
        with timing.maybe_profile(tmp):
            steps["estimator_step"](carries["estimator_step"], 1000)
        path = os.path.join(tmp, "trace.json")
        check(os.path.exists(path), "maybe_profile wrote no trace")
        with open(path) as f:
            trace = json.load(f)
    kernels = [e for e in trace.get("traceEvents", [])
               if e.get("cat") == "kernel"]
    hits = [e for e in kernels if "sym_moments_train" in e.get("name", "")]
    check(bool(hits), f"the trace names no sym_moments_train kernel "
          f"({len(kernels)} kernel events)")
    report = {"kernel_events": len(kernels),
              "sym_moments_train_events": len(hits),
              "sym_moments_train_us": round(sum(e.get("dur", 0)
                                                for e in hits), 3)}
    print("maybe_profile " + json.dumps(report))
    return report


def demo_part(dev, root: str) -> dict:
    """The multi-object demo, cut down (DEMO_*), under a temporary --out,
    then `attribute_serving` and `mask_iou` on its checkpoints."""
    from autoposeestimation_tpu_torch.scripts import (attribute_serving,
                                                      mask_iou,
                                                      train_multi_demo)

    out = os.path.join(root, "demo")
    cuts = {"viewpoints": f"{DEMO_VIEWS} of 48",
            "seg_epochs": f"{DEMO_SEG_EPOCHS} of 10",
            "pose_epochs": f"{DEMO_POSE_EPOCHS} of 120",
            "frames": f"{DEMO_FRAMES} of 36"}
    fwd0, train0 = launch_counts()
    t0 = time.perf_counter()
    results = train_multi_demo.main([
        "--out", out, "--viewpoints", str(DEMO_VIEWS),
        "--seg-epochs", str(DEMO_SEG_EPOCHS),
        "--pose-epochs", str(DEMO_POSE_EPOCHS)])
    demo_s = time.perf_counter() - t0
    fwd1, train1 = launch_counts()
    check(os.path.exists(os.path.join(out, "demo_multi.json")),
          "train_multi_demo wrote no artifact")
    refine = os.path.exists(os.path.join(
        out, "DenseFusion", "trained_models", "synth",
        "pose_refine_model.npz"))
    t1 = time.perf_counter()
    attribution = attribute_serving.main([
        "--out", out, "--frames", str(DEMO_FRAMES),
        "--refine-iters", "2" if refine else "0"])
    attribution_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    ious = mask_iou.main(["--out", out, "--family", "a",
                          "--frames", str(DEMO_FRAMES)])
    mask_iou_s = time.perf_counter() - t2
    fwd2, train2 = launch_counts()
    table = results["eval"]["with_refine" if results["eval"]["use_refine"]
                            else "estimator_only"]
    report = {
        "cuts": cuts,
        "seconds": {"train_multi_demo": round(demo_s, 2),
                    **{stage: results[stage].get("seconds")
                       for stage in ("segmentation", "pose_training",
                                     "serving")},
                    "attribute_serving": round(attribution_s, 2),
                    "mask_iou": round(mask_iou_s, 2)},
        "add_s_m": {c: table[c]["dis"] for c in table if c != "overall"},
        "use_refine": results["eval"]["use_refine"],
        "refine_checkpoint": refine,
        "served_found": {c: row["found"] for c, row in
                         results["serving"]["per_class"].items()},
        "attribution_served_add_m": {
            c: row[attribution["conditions"][0]]["add_mean_m"]
            for c, row in attribution["per_class"].items()},
        "mask_iou_component": {
            s: {c: row["component_iou"] for c, row in table_s.items()}
            for s, table_s in ious["per_stride"].items()},
        "launches": {"sym_moments": fwd2 - fwd0,
                     "sym_moments_train": train2 - train0,
                     "demo_sym_moments_train": train1 - train0}}
    check(report["launches"]["demo_sym_moments_train"] > 0
          and fwd1 - fwd0 > 0, f"the demo launched no kernel: "
          f"{report['launches']}")
    for c, d in report["add_s_m"].items():
        check(np.isfinite(d), f"demo ADD(-S) of {c}: {d}")
    print("demo " + json.dumps(report))
    return report


def stages_and_demo_phase(dev, root=None):
    """Phase 16: the train stages and serving prefixes at full width,
    their FLOPs against the JAX package's counts, `maybe_profile`, and the
    cut-down multi-object demo with its attribution, its workspace in
    `root`/demo (a temporary directory when None). Returns the launches of
    (sym_moments, sym_moments_train) in its main path."""
    import tempfile

    from autoposeestimation_tpu_torch.ops import addloss
    from autoposeestimation_tpu_torch.utils import train_stages

    t0 = time.perf_counter()
    jax_counts = jax_flop_counts()
    card = nvidia_smi("name,power.limit")
    # defaults: 5 objects, B=8, N=1000, M=500, crop 320, bf16
    steps, carries = train_stages.build_stages(device=dev)
    build_s = time.perf_counter() - t0
    compared = stage_kernels_vs_plain(steps, carries)
    # the main path: counts from 0 just before, read just after
    addloss.moments_cuda.launches = addloss.moments_train_cuda.launches = 0
    stages = train_stages_part(steps, carries, jax_counts)
    prefixes = serving_prefixes_part(dev, jax_counts)
    prof = profile_part(steps, carries)
    del steps, carries
    torch.cuda.empty_cache()
    if root is None:
        with tempfile.TemporaryDirectory() as tmp:
            demo = demo_part(dev, tmp)
    else:
        demo = demo_part(dev, root)
    launches = launch_counts()
    report = {"card": card, "build_s": round(build_s, 2),
              "train_stages": stages, "kernels_vs_plain": compared,
              "serving_prefixes": prefixes, "maybe_profile": prof,
              "demo": demo, "launches": {"sym_moments": launches[0],
                                         "sym_moments_train": launches[1]},
              "phase_s": round(time.perf_counter() - t0, 2)}
    print("stages and demo " + json.dumps(report))
    check(min(launches) > 0, f"phase 16: launches {launches}")
    return launches

# --- phase 17: the graft entry ------------------------------------------------

ENTRY_REPS = 8           # calls timed with the host in the loop


def graft_entry_phase(dev) -> dict:
    """Phase 17: `graft_entry.entry()` on the card in bf16 (its outputs
    checked as `check_prediction` checks a served frame), timed with the
    host in the loop (`cuda_ms`), its device time and launches from the
    profiler; then
    `entry(dtype=torch.float32)` on the card against the same on the CPU
    at phase 4's bound (found and cca_converged equal, poses within
    POSE_ATOL), argmax and masks equal but at pixels whose two largest
    probabilities on the CPU are within TIE (phase 13's rule)."""
    from autoposeestimation_tpu_torch import graft_entry
    from autoposeestimation_tpu_torch.pipeline import predict

    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    check(args[1].device.type == "cuda", f"entry() on {args[1].device}")
    out = fn(*args)
    torch.cuda.synchronize()
    models, hw = args[0], tuple(args[2].shape)
    host = {name: out[name].cpu().numpy()
            for name in predict._fetched(out, True)}
    check_prediction(dict(predict._materialize(host, models),
                          elapsed_times=None), hw)
    for name in ("quats", "positions"):
        check(bool(torch.isfinite(out[name]).all().item()),
              f"graft entry: {name} not finite")
    ms = cuda_ms(lambda: fn(*args), ENTRY_REPS)
    # its device time from the profiler: `queued_ms` cannot hold even one
    # call behind its sleep kernel, as a call's ~2,000 launches overflow
    # CUDA's queue of pending launches and the host blocks (it queued one
    # call in 0.194 s behind a 0.164 s head start on an H100)
    prof = profile(lambda: [fn(*args) for _ in range(4)],
                   "graft entry bf16, per call", 4, ms)
    check(prof is not None, "graft entry: the profiler saw no device time")

    outs = []
    for d in (dev, torch.device("cpu")):
        fn32, args32 = graft_entry.entry(device=d, dtype=torch.float32)
        outs.append({k: v.cpu().numpy() for k, v in fn32(*args32).items()})
        with torch.inference_mode():
            probs = predict._segment(args32[0].seg_model,
                                     args32[1].permute(2, 0, 1))[0]
    card, cpu = outs
    # the random frame puts ~1,000 of its 307,200 pixels within TIE of a
    # tie between two classes: an argmax pixel, and its mask pixel, may
    # differ there (phase 13's rule)
    top2 = torch.topk(probs, 2, dim=0).values.numpy()
    tie = (top2[0] - top2[1]) <= TIE
    flips = card["argmax"] != cpu["argmax"]
    mask_flips = (card["masks"] != cpu["masks"]).any(axis=0)
    check(not (flips & ~tie).any() and not (mask_flips & ~tie).any(),
          f"graft entry card vs CPU: argmax / masks differ off a tie "
          f"({int((flips & ~tie).sum())}, {int((mask_flips & ~tie).sum())} "
          f"pixels)")
    for name in ("found", "cca_converged"):
        check(np.array_equal(card[name], cpu[name]),
              f"graft entry card vs CPU: {name}")
    err = max(float(np.abs(card[n] - cpu[n]).max())
              for n in ("quats", "positions"))
    check(err <= POSE_ATOL, f"graft entry card vs CPU: pose error {err}")
    report = {"card": nvidia_smi("name,power.limit"), "dtype": "bfloat16",
              "frame": list(hw), "classes": len(models.classes),
              "num_points": models.num_points, "crop": models.crop,
              "found": host["found"].tolist(),
              "cuda_ms": round(ms, 4), "device_ms": round(prof[0], 4),
              "busy_share": round(prof[0] / ms, 4),
              "kernels_per_call": round(prof[1]),
              "f32_card_vs_cpu": {"found": card["found"].tolist(),
                                  "argmax_pixels_differ": int(flips.sum()),
                                  "mask_pixels_differ": int(
                                      mask_flips.sum()),
                                  "pixels_at_a_tie": int(tie.sum()),
                                  "max_pose_err": err},
              "phase_s": round(time.perf_counter() - t0, 2)}
    print("graft entry " + json.dumps(report))
    return report


def tree_leaves(tree):
    """A flax tree's leaves in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    return [np.asarray(tree)]


# two ranks against one on the card: the segmentation trainer (f32, SGD,
# TF32 off) within ENTRY_ATOL, its IoU within IOU_ATOL (tests/
# test_torch_parallel.py's bounds); the DenseFusion trainer (bf16, Adam)
# within Adam's 2 lr a step and its first epoch's logged loss and gradient
# norm within TRAINER_REL. Its PSPNet's adaptive pooling has no
# deterministic backward on the card, so two one-rank runs differ so too
# (51 of 73 leaves beyond 1e-4, best test distance 0.2-9.3 % apart on an
# H100): its best test distance is printed beside that of a second
# one-rank run, not held
ENTRY_ATOL = 1e-4
TRAINER_REL = 1e-2
IOU_ATOL = 2e-2


def trainers_two_ranks() -> dict:
    """`parallel/trainers.py` at product shapes on one NCCL rank, on one
    again and on two: the comparisons and samples a second of each."""
    from autoposeestimation_tpu_torch.parallel import trainers

    out = trainers.trainers_multichip(2, "product", backend="nccl",
                                      repeat=True)
    report = {"two_vs_one": out["compare"], "one_vs_one": out["repeat"]}
    pose, seg = out["compare"]["pose"], out["compare"]["seg"]
    print("parallel trainers, 2 ranks against 1 " + json.dumps(report))
    check(pose["max_param_diff"] <= pose["adam_bound"]
          and max(pose["loss_rel"], pose["grad_norm_rel"]) <= TRAINER_REL,
          f"train() on 2 ranks against 1: {pose}")
    check(seg["max_param_diff"] <= ENTRY_ATOL
          and seg["best_iou_abs"] <= IOU_ATOL,
          f"segmentation_training on 2 ranks against 1: {seg}")
    return report


def parallel_phase(dev):
    """Phase 15: the U-Net's out_stride (card against CPU in f32; frames/s
    and the U-Net's time at strides 1 and 4), then the parallel paths on
    a one-rank NCCL group, and `dryrun_multichip(2, "product")` when the
    machine has two cards. Returns the launches of (sym_moments,
    sym_moments_train, nn) in the one-rank run."""
    import tempfile

    from autoposeestimation_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    report = {"card": nvidia_smi("name,power.limit"),
              "card_vs_cpu_stride4_max_pose_err":
              card_vs_cpu_phase(dev, seg_out_stride=4)}
    report["out_stride"] = out_stride_timing(dev)
    with tempfile.TemporaryDirectory() as tmp:
        report["one_rank"] = parallel_one_rank(dev, tmp)
    report["ranks"] = 1
    if torch.cuda.device_count() >= 2:
        t1 = time.perf_counter()
        out = dryrun.dryrun_multichip(2, "product", backend="nccl")
        check(all(np.isfinite(r["loss"]) for r in out)
              and out[0]["loss"] == out[1]["loss"],
              f"dryrun_multichip(2): {[r['loss'] for r in out]}")
        report["ranks"] = 2
        report["dryrun_2_s"] = round(time.perf_counter() - t1, 4)
        t1 = time.perf_counter()
        report["trainers_2"] = trainers_two_ranks()
        report["trainers_2_s"] = round(time.perf_counter() - t1, 4)
    report["phase_s"] = round(time.perf_counter() - t0, 4)
    print("parallel and out_stride " + json.dumps(report))
    launches = report["one_rank"]["launches"]
    return (launches["sym_moments"], launches["sym_moments_train"],
            launches["nn"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--nn-timing"] and len(sys.argv) == 3:
        return nn_timing_main(sys.argv[2])
    if sys.argv[1:2] == ["--train-timing"] and len(sys.argv) == 3:
        return train_timing_main(sys.argv[2])
    if sys.argv[1:2] == ["--moments-timing"] and len(sys.argv) == 3:
        return moments_timing_main(sys.argv[2])
    check(len(sys.argv) == 1, f"usage: {sys.argv[0]} [--nn-timing ROOT | "
          f"--train-timing ROOT | --moments-timing ROOT]")
    import tempfile

    from autoposeestimation_tpu_torch.ops import kernel_build

    dev = torch.device("cuda")
    print(nvidia_smi("name,power.limit"))
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    t0 = time.perf_counter()
    libs = kernel_build.build_all(["sym_moments", "sym_moments_train", "nn"])
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for path in libs.values():
        for line in path.with_name(path.name + ".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {path.name}:", line.strip())

    kernel = kernel_phase(dev, clock_mhz)
    serving_phase(dev)
    card_vs_cpu_phase(dev)
    launches, err = eval_phase(dev)
    kernel["launches"] = launches
    kernel["max_abs_err"] = max(kernel["max_abs_err"], err)
    train_kernel = train_kernel_phase(dev, clock_mhz)
    train_kernel["launches"] = training_phase(dev)
    nn_kernel = nn_phase(dev, clock_mhz)
    nn_calls = {"reconstruction": reconstruction_phase(dev)}
    # training from a dataset and the sweeps of phase 14 (on the dataset
    # phase 10 writes) run both moments kernels: their launches there join
    # those of phases 5 and 7
    with tempfile.TemporaryDirectory() as pose_root:
        ds_train, ds_fwd = dataset_training_phase(dev, pose_root)
        serving_stream_phase(dev)
        segmentation_training_phase(dev)
        nn_calls["offline_labeling"] = labeling_phase(dev)
        shells_fwd, shells_train = host_shells_phase(dev, pose_root)
    par_fwd, par_train, nn_calls["parallel"] = parallel_phase(dev)
    with tempfile.TemporaryDirectory() as demo_root:
        stages_fwd, stages_train = stages_and_demo_phase(dev, demo_root)
        # phase 11's batch part, on the demo's trained checkpoints
        trained_batch_invariance(dev, os.path.join(demo_root, "demo"))
    graft_entry_phase(dev)
    # each call is two kernels, a scan and its merge
    nn_kernel["calls_by_phase"] = nn_calls
    nn_kernel["calls"] = sum(nn_calls.values())
    nn_kernel["launches"] = 2 * nn_kernel["calls"]
    nn_kernel["kernels_per_call"] = 2
    kernel["launches_by_phase"] = {"evaluation": kernel["launches"],
                                   "dataset_training": ds_fwd,
                                   "host_shells": shells_fwd,
                                   "parallel": par_fwd,
                                   "stages_and_demo": stages_fwd}
    kernel["launches"] += ds_fwd + shells_fwd + par_fwd + stages_fwd
    train_kernel["launches_by_phase"] = {"training": train_kernel["launches"],
                                         "dataset_training": ds_train,
                                         "host_shells": shells_train,
                                         "parallel": par_train,
                                         "stages_and_demo": stages_train}
    train_kernel["launches"] += (ds_train + shells_train + par_train
                                 + stages_train)
    print(json.dumps({"kernels": [kernel, train_kernel, nn_kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
