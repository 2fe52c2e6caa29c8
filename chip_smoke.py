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
     and on the CPU.
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
            kernels: tuple = ()) -> None:
    """Device time that torch.profiler sees during `fn`, per unit (`per`
    units in the call), with the kernel count, the top kernels and the
    device's busy share of `wall_ms`, the unit's time measured without the
    profiler; and the device time and count of the kernels whose names
    contain one of `kernels`."""
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
        return
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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --- phase 2: kernels ----------------------------------------------------------

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


# --- phase 3: serving ------------------------------------------------------------

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


# --- phase 4: card vs CPU ----------------------------------------------------------

def card_vs_cpu_phase(dev) -> None:
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
    print(f"card vs CPU (f32, 96x128): masks/found/argmax equal, "
          f"found {gpu['found'].tolist()}, max pose error "
          f"{max(np.abs(gpu[n] - cpu[n]).max() for n in ('quats', 'positions')):.3e}")


# --- phase 5: evaluation ------------------------------------------------------------

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


# --- phase 6: training kernel -------------------------------------------------

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


# --- phase 7: training --------------------------------------------------------

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


# --- phase 8: nearest-neighbour kernel -------------------------------------------

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


# --- phase 9: reconstruction ------------------------------------------------------

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
        h = torch.randn(3, 3, dtype=torch.float64, device=dev)
        svd_ms = timed_steps(lambda: torch.sign(torch.linalg.det(
            torch.linalg.svd(h)[0])).item(), 50)
        a6 = torch.eye(6, dtype=torch.float64, device=dev) * 2
        solve_ms = timed_steps(lambda: torch.linalg.solve(
            a6, a6[0]).sum().item(), 50)
        profile(merge, "one ICP merge (point-to-point)", 1, merge_ms)
        print(f"ICP merge of two {len(views[0])}/{len(views[1])}-point views: "
              f"{merge_ms:.4f} ms, {iters} iterations; 3x3 SVD + det + read "
              f"on the card {svd_ms:.4f} ms each, "
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


# --- phase 10: training from a dataset ---------------------------------------------

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


def loader_rate(ds, workers: int, samples: int) -> float:
    """Samples a second the Loader assembles (train mode, batch 8)."""
    from autoposeestimation_tpu_torch.data import loader

    t0 = time.perf_counter()
    n = 0
    for batch in loader.Loader(ds, 8, num_workers=workers):
        n += len(batch["img"])
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


def dataset_training_phase(dev):
    """Phase 10: `App.train_pose_estimation` at full width through both
    phases from a written dataset; returns the launches of
    (sym_moments_train, sym_moments) in that run."""
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

    with tempfile.TemporaryDirectory() as root:
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
    # each call is two kernels, a scan and its merge
    nn_kernel["calls"] = reconstruction_phase(dev)
    nn_kernel["launches"] = 2 * nn_kernel["calls"]
    nn_kernel["kernels_per_call"] = 2
    # training from a dataset runs both moments kernels: their launches
    # there join those of phases 5 and 7
    ds_train, ds_fwd = dataset_training_phase(dev)
    kernel["launches_by_phase"] = {"evaluation": kernel["launches"],
                                   "dataset_training": ds_fwd}
    kernel["launches"] += ds_fwd
    train_kernel["launches_by_phase"] = {"training": train_kernel["launches"],
                                         "dataset_training": ds_train}
    train_kernel["launches"] += ds_train
    print(json.dumps({"kernels": [kernel, train_kernel, nn_kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
