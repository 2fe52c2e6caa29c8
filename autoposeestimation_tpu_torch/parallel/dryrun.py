"""Ranks of a process group on one host, and the multi-rank dry run (the
counterpart of `__graft_entry__.py::dryrun_multichip`).

`run_ranks(fn, n)` starts n processes (`torch.multiprocessing`, spawned),
joins them into one group on a `FileStore` in a temporary directory
(NCCL on the card, rank r on `cuda:r`; gloo on the CPU), calls `fn(*args)`
on every rank and returns the ranks' results in rank order. A rank that
raises, a group that does not form within `init_timeout_s` and a run past
`timeout_s` all raise here, and every process is stopped.

`dryrun_multichip(n)` runs the DenseFusion training path on a data x
tensor mesh of n ranks (model = 2 when n is even and above 1): one
`estimator_step` and one `refiner_step` with the wide layers column-sharded,
batched serving with the frames split over 'data' (each rank runs
`_predict_batch` on its frames with its rows of one global draw, and the
positions are gathered), and the view-sharded `get_surfaces_batched`. It
prints one `dryrun_multichip ok: ...` line. Called inside a group of n
ranks it runs there; otherwise it starts one. From the shell:

    python -m autoposeestimation_tpu_torch.parallel.dryrun N [toy|product]
    torchrun --nproc-per-node=N -m \
        autoposeestimation_tpu_torch.parallel.dryrun N [toy|product]

the first spawns the N ranks, the second runs one rank in each of
torchrun's processes (the group from its environment).
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import mesh as pmesh

INIT_TIMEOUT_S = 60.0


def _rank_main(rank: int, n: int, store: str, backend: str, fn: Callable,
               args: Sequence, out_dir: str, threads: Optional[int],
               init_timeout_s: float) -> None:
    if threads:
        torch.set_num_threads(threads)
    try:
        pmesh.init_group(rank, n, store, backend,
                         datetime.timedelta(seconds=init_timeout_s))
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, n: int, args: Sequence = (),
              backend: Optional[str] = None, timeout_s: float = 600.0,
              init_timeout_s: float = INIT_TIMEOUT_S,
              threads: Optional[int] = None,
              workdir: Optional[str] = None) -> List[Any]:
    """`fn(*args)` on each of n spawned ranks of one group; their results
    (saved with `torch.save`) in rank order. `fn` must be importable by
    name (a module-level function). `threads` sets each rank's
    `torch.set_num_threads`. The store and the results live in a temporary
    directory under `workdir`, removed afterwards."""
    backend = backend or pmesh.default_backend()
    tmp = tempfile.mkdtemp(prefix="ape_ranks_", dir=workdir)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, n, os.path.join(tmp, "store"), backend, fn, tuple(args), tmp,
        threads, init_timeout_s)) for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
            if p.exitcode is None:
                raise TimeoutError(f"{n} ranks of {fn.__name__} still ran "
                                   f"after {timeout_s} s")
            if p.exitcode != 0:
                errors = [open(os.path.join(tmp, f)).read()
                          for f in sorted(os.listdir(tmp))
                          if f.endswith(".err")]
                raise RuntimeError(
                    f"a rank of {fn.__name__} exited with {p.exitcode}:\n"
                    + "\n".join(errors))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        for p in procs:
            if p.pid is None:          # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)


def _dryrun(n: int, shapes: str) -> Dict[str, Any]:
    """The dry run on this rank of a group of n ranks; its summary."""
    from ..pipeline import predict
    from ..reconstruction import create_pointcloud as rec
    from ..train import densefusion as dft

    model_parallel = 2 if n % 2 == 0 and n > 1 else 1
    mesh = pmesh.make_mesh(n, model_parallel=model_parallel)
    dev = mesh.device
    data = mesh.shape["data"]
    if shapes == "product":
        num_obj, npts, m, crop, batch = 5, 1000, 500, 320, 8
    else:
        num_obj, npts, m, crop, batch = 2, 32, 32, 32, max(data, 1) * 2
    cfg = dft.DFConfig(num_points=npts, num_points_mesh=m)
    state = dft.create_trainer(num_obj, cfg, dtype=torch.bfloat16,
                               device=dev)
    rng = np.random.default_rng(0)
    raw = {
        "img": rng.normal(size=(batch, crop, crop, 3)).astype(np.float32),
        "cloud": (rng.normal(size=(batch, npts, 3)) * 0.05).astype(
            np.float32),
        "choose": rng.integers(0, crop * crop, (batch, npts)),
        "target": (rng.normal(size=(batch, m, 3)) * 0.05).astype(np.float32),
        "model_points": (rng.normal(size=(batch, m, 3)) * 0.05).astype(
            np.float32),
        "obj_idx": rng.integers(0, num_obj, batch),
        "is_sym": rng.integers(0, 2, batch).astype(bool),
    }
    batch_t = dft.to_device(raw, dev)
    # dp: the batch's rows over 'data'; tp: the wide Linears over 'model'
    for net in (state.posenet, state.refiner):
        pmesh.replicate_params(mesh, net)
    pmesh.shard_params_tp(mesh, state.posenet, state.optimizer.adam)
    gen = torch.Generator(device=dev).manual_seed(0)
    metrics = dft.estimator_step(state.posenet, state.optimizer, batch_t,
                                 cfg.w, True, cfg.sym_bf16, gen, mesh)
    refine_opt = dft.make_optimizer(state.refiner.parameters(), cfg.lr,
                                    cfg.grad_clip)
    pmesh.shard_params_tp(mesh, state.refiner, refine_opt.adam)
    rmetrics = dft.refiner_step(state.posenet, state.refiner, refine_opt,
                                batch_t, cfg.w, iteration=2, with_sym=True,
                                mesh=mesh)

    # serving with the frames over 'data' (the multi-camera mode)
    if shapes == "product":
        simg_hw, scrop, spts, smp = (480, 640), 320, 1000, 500
    else:
        simg_hw, scrop, spts, smp = (64, 64), 32, 64, 32
    smodels = predict.build_models(
        num_obj, (rng.normal(size=(num_obj, smp, 3)) * 0.05).astype(
            np.float32), tuple(f"obj{i}" for i in range(num_obj)),
        num_points=spts, crop=scrop, refine_iters=1, dtype=torch.bfloat16,
        device=dev)
    frames = n
    images = rng.integers(0, 255, (frames,) + simg_hw + (3,)).astype(
        np.uint8)
    depths = rng.uniform(400, 900, (frames,) + simg_hw).astype(np.float32)
    intr = torch.tensor([simg_hw[1] * 0.9, simg_hw[1] * 0.9,
                         simg_hw[1] / 2.0, simg_hw[0] / 2.0], device=dev)
    uniforms = torch.rand((frames, num_obj, spts),
                          generator=torch.Generator().manual_seed(0))
    block = pmesh.row_block(mesh, frames)
    lo, hi = block or (0, frames)
    with torch.inference_mode():
        out = predict._predict_batch(
            smodels, torch.from_numpy(images[lo:hi]).to(dev),
            torch.from_numpy(depths[lo:hi]).to(dev), intr,
            torch.tensor(0.001, device=dev), uniforms[lo:hi].to(dev))
        positions = (pmesh.all_gather_rows(mesh, out["positions"])
                     if block is not None else out["positions"])

    # offline reconstruction: the per-view surfaces over 'data'
    vh, vw = 32, 40
    yy, xx = np.mgrid[0:vh, 0:vw]
    disk = ((yy - 16) ** 2 + (xx - 20) ** 2 < 10 ** 2).astype(np.int32)
    surfaces = rec.get_surfaces_batched(
        [disk] * n, [np.where(disk, 300.0 + yy, 0.0)] * n,
        {"fx": 40.0, "fy": 40.0, "ppx": vw / 2.0, "ppy": vh / 2.0},
        [np.eye(4)] * n, min_friends=3, min_dist=8.0, nb_neighbors=3,
        voxel_size=3.0, mesh=mesh, cap=512, device=dev)
    summary = {
        "ranks": n, "backend": dist.get_backend(), "data": data,
        "model": model_parallel, "loss": float(metrics["loss"]),
        "gnorm": float(metrics["gnorm"]), "refine_dis": float(rmetrics["dis"]),
        "frames": frames, "positions": positions.float().cpu().numpy(),
        "out_sharded": block is not None and data > 1,
        "recon_views": sum(1 for s in surfaces if len(s)),
        "recon_points": [len(s) for s in surfaces]}
    if mesh.rank == 0:
        print(f"dryrun_multichip ok: {n} devices (data={data}, "
              f"model={model_parallel}), loss={summary['loss']:.4f}, "
              f"refine_dis={summary['refine_dis']:.4f}, "
              f"serving_batched={frames} frames data-sharded "
              f"(out_sharded={summary['out_sharded']}), "
              f"recon_surfaces={summary['recon_views']} views "
              f"view-sharded, backend={summary['backend']}", flush=True)
    return summary


def dryrun_multichip(n_ranks: int, shapes: str = "toy",
                     backend: Optional[str] = None,
                     timeout_s: float = 900.0,
                     workdir: Optional[str] = None) -> List[Dict[str, Any]]:
    """The dry run over n ranks at `shapes` "toy" (proves the collectives
    fast) or "product" (training at crop 320, 1000 points, 500 model
    points, batch 8, bf16; serving at 640x480). Inside a group of n ranks
    it runs on this rank and returns [its summary]; else it spawns the
    ranks (`run_ranks`) and returns their summaries in rank order."""
    if shapes not in ("toy", "product"):
        raise ValueError(f"shapes must be 'toy' or 'product': {shapes!r}")
    if dist.is_initialized() and dist.get_world_size() == n_ranks:
        return [_dryrun(n_ranks, shapes)]
    backend = backend or pmesh.default_backend()
    return run_ranks(_dryrun, n_ranks, (n_ranks, shapes), backend,
                     timeout_s=timeout_s,
                     threads=1 if backend == "gloo" else None,
                     workdir=workdir)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    n, shapes = int(args[0]), (args[1] if len(args) > 1 else "toy")
    if not dist.is_initialized() and pmesh.auto_mesh("auto") is not None:
        try:        # torchrun's ranks: the group came from its environment
            dryrun_multichip(n, shapes)
        finally:
            dist.destroy_process_group()
    else:
        dryrun_multichip(n, shapes)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
