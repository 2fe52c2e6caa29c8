"""Parity checks of the port against the JAX package on the CPU, at a size
for the tests and, from the shell, at the card runs' own size.

`sharded`: `load_point_cloud(mesh=)` of `chip_smoke.py`'s ball (the
JAX-written 160x128 dataset) in both packages, the port's on a one-rank
gloo group, JAX's over the 8 virtual CPU devices, each package's streaming
run beside it; `tests/test_torch_parallel.py` runs it at 5 views without
the streaming runs. Phase 15's configuration (12 views, `chip_smoke.SMALL`) from the shell:

    JAX_PLATFORMS=cpu python tests/_torch_open_checks.py sharded 12

`merge`: the ICP merge at which phase 15's 12-view streaming and sharded
reconstructions part (the fourth merge of the ball's foreground run): its
inputs from the port's streaming run, and both packages' ICP transforms
of it under perturbations of the inputs by 1e-5 mm;
`tests/test_torch_parallel.py` runs it.

`turned`: global registration on a turned run:
`load_point_cloud(global_regression=True)` and
`create_pose_label(with_extra=True, global_regression=True)` of
`chip_smoke.py` phase 13's turned object (obj1 of `pose_objects`, its
coloured part turned 180 degrees about the vertical axis in run
`foreground180`, an `extra` run of 3 views in that pose from a lower ring;
the rendered masks as the `new_pred` labels), at phase 13's reconstruction
settings, in one dataset copied for each package.

Both packages draw the same RANSAC hypotheses: the port's `draw_samples` is
replaced by JAX's draw (`jax.random.categorical` over the valid
correspondences with `PRNGKey(0)`, as JAX's `global_registration` seeds
it), and JAX's `knn_k` takes direct-form distances as the port's does
(`test_torch_global_registration.exact_knn_k`; its own expansion form moves
FPFH's bins). JAX's ICP finds correspondences through the TPU kernel's
function, `nn_pallas(interpret=True)`.

`tests/test_torch_global_registration.py` runs `turned` at 160x120, 3
views a run. Phase 13's own scale (320x240, 8 views), from the shell:

    JAX_PLATFORMS=cpu python tests/_torch_open_checks.py turned 240 320 8

Each prints one JSON line. `merge`: each package's transforms' largest
difference from its unperturbed one. `turned`: each package's largest
label rotation error on the turned run (degrees, against the written
turn), its fitness per global registration, and the seconds. `sharded`: the clouds' point
counts, the port's sharded cloud against JAX's (mean and worst NN
distance, mm) and each package's sharded-against-streaming gap (symmetric
mean NN distance, mm)."""
import functools
import json
import os
import shutil
import sys
import tempfile
import time
from unittest import mock

# run as a script: the settings of tests/conftest.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS",
                                                                 ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + (
        " --xla_force_host_platform_device_count=8")).strip()

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch.distributed as dist

import chip_smoke
from autoposeestimation_tpu.labeling import pose_labels as jpl
from autoposeestimation_tpu.ops import global_registration as jgreg
from autoposeestimation_tpu.ops import knn as jknn
from autoposeestimation_tpu.parallel import mesh as jmesh
from autoposeestimation_tpu.reconstruction import create_pointcloud as jrec
from autoposeestimation_tpu.utils import synthetic as jsyn
from autoposeestimation_tpu_torch.labeling import pose_labels
from autoposeestimation_tpu_torch.ops import global_registration as greg
from autoposeestimation_tpu_torch.parallel import mesh as pmesh
from autoposeestimation_tpu_torch.reconstruction import create_pointcloud as rec
from autoposeestimation_tpu_torch.utils import io, synthetic
from test_torch_global_registration import exact_knn_k

# phase 13's production reconstruction (chip_smoke.turned_card_vs_cpu)
SETTINGS = dict(mode="new_pred", reference_point=np.zeros(3),
                n_viewpoints=30, min_friends=20, min_dist=5, nb_neighbors=20,
                threshold=10, voxel_size=2, voxel_size_out=5,
                global_regression=True, icp_point2point=True,
                icp_point2plane=False)
EXTRA_VIEWS = 3


def write_dataset(root: str, hw, views: int) -> None:
    """The turned object's background, foreground, turned and extra runs
    at phase 13's fx = fy = 300: the object covers as many pixels in a
    smaller frame."""
    h, w = hw
    cfg = synthetic.SynthConfig(img_h=h, img_w=w, fx=300.0, fy=300.0,
                                n_viewpoints=views, noise=1.0)
    obj = next(o for o in chip_smoke.pose_objects()
               if o.name == chip_smoke.TURNED)
    pose = chip_smoke.turn_pose()
    turned = chip_smoke.turned_object(obj, pose)
    synthetic.make_dataset(root, objects=[obj], cfg=cfg)
    chip_smoke.write_run(root, turned, chip_smoke.TURNED_RUN, cfg, pose)
    chip_smoke.write_run(root, turned, "extra", synthetic.SynthConfig(
        **{**cfg.__dict__, "n_viewpoints": EXTRA_VIEWS,
           "ring_height": 300.0}), pose)


def jax_draw(corr_ok, num_hypotheses, ransac_n, generator=None):
    """JAX's RANSAC draw for the port's `draw_samples`."""
    logits = jnp.where(jnp.asarray(corr_ok.cpu().numpy()), 0.0, -1e9)
    return torch.from_numpy(np.asarray(jax.random.categorical(
        jax.random.PRNGKey(0), logits[None, :],
        shape=(num_hypotheses, ransac_n))).astype(np.int64))


def fitness_recorder(module, fitness: list):
    """`module.global_registration`, recording each call's fitness."""
    real = module.global_registration

    def recorded(*args, **kw):
        res = real(*args, **kw)
        fitness.append(round(float(res.fitness), 6))
        return res
    return recorded


def run_package(name: str, root: str) -> dict:
    """One package's Phases B and C on the dataset at `root`."""
    fitness = []
    t0 = time.perf_counter()
    if name == "jax":
        with mock.patch.object(jknn, "knn_k", exact_knn_k), \
                mock.patch.object(jknn, "nn", functools.partial(
                    jknn.nn_pallas, interpret=True)), \
                mock.patch.object(jgreg, "global_registration",
                                  fitness_recorder(jgreg, fitness)):
            jax.clear_caches()
            jrec.load_point_cloud(chip_smoke.TURNED, io.pc_dir(root), root,
                                  **SETTINGS)
            labels = jpl.create_pose_label(root, chip_smoke.TURNED,
                                           with_extra=True,
                                           global_regression=True)
        jax.clear_caches()
    else:
        with mock.patch.object(greg, "draw_samples", jax_draw), \
                mock.patch.object(greg, "global_registration",
                                  fitness_recorder(greg, fitness)):
            rec.load_point_cloud(chip_smoke.TURNED, io.pc_dir(root), root,
                                 **SETTINGS, device="cpu")
            labels = pose_labels.create_pose_label(
                root, chip_smoke.TURNED, with_extra=True,
                global_regression=True, device="cpu")
    return {"labels": labels, "fitness": fitness,
            "rotation_error_deg": chip_smoke.turned_rotation_error(root),
            "seconds": round(time.perf_counter() - t0, 2)}


def turned(base: str, hw=(120, 160), views: int = 3) -> dict:
    """Both packages on one dataset written under `base`."""
    write_dataset(os.path.join(base, "data"), hw, views)
    out = {"hw": list(hw), "views": views}
    for name in ("jax", "port"):
        root = os.path.join(base, name)
        shutil.copytree(os.path.join(base, "data"), root)
        out[name] = run_package(name, root)
    return out


def mean_and_max_nn(a: np.ndarray, b: np.ndarray):
    """Mean and largest distance from each point of a to b (mm)."""
    d = np.concatenate([np.sqrt(np.min(np.sum(
        (a[i:i + 512, None].astype(np.float64) - b[None]) ** 2, -1), 1))
        for i in range(0, len(a), 512)])
    return float(d.mean()), float(d.max())


def sym_mean_nn(a: np.ndarray, b: np.ndarray) -> float:
    return (mean_and_max_nn(a, b)[0] + mean_and_max_nn(b, a)[0]) / 2


def sharded(base: str, views: int = 5, streams: bool = True) -> dict:
    """`load_point_cloud` view-sharded (and with `streams` streaming) in
    both packages on one JAX-written dataset of the ball under `base`, at
    `chip_smoke.SMALL` with `n_viewpoints=views`. The port's sharded run
    starts a one-rank gloo group and destroys it."""
    settings = dict(chip_smoke.SMALL, n_viewpoints=views)
    ball = jsyn.SphereObject(
        "ball", chip_smoke.BALL_CENTERS[0], float(chip_smoke.BALL_RADII[0]),
        (210, 50, 50), parts=((tuple(chip_smoke.BALL_CENTERS[1]
                                     - chip_smoke.BALL_CENTERS[0]),
                               float(chip_smoke.BALL_RADII[1])),))
    jsyn.make_dataset(os.path.join(base, "data"), objects=[ball],
                      cfg=jsyn.SynthConfig(n_viewpoints=views))
    clouds, seconds = {}, {}
    with mock.patch.object(jknn, "nn", functools.partial(jknn.nn_pallas,
                                                         interpret=True)):
        jax.clear_caches()
        for name in (("jax sharded", "jax stream", "port sharded",
                      "port stream") if streams else ("jax sharded",
                                                       "port sharded")):
            root = os.path.join(base, name.replace(" ", "_"))
            shutil.copytree(os.path.join(base, "data"), root)
            args = ("ball", io.pc_dir(root), root)
            t0 = time.perf_counter()
            if name == "jax sharded":
                clouds[name] = jrec.load_point_cloud(
                    *args, **settings, mesh=jmesh.make_mesh(
                        len(jax.devices()), model_parallel=1))
            elif name == "jax stream":
                clouds[name] = jrec.load_point_cloud(*args, **settings)
            elif name == "port sharded":
                try:
                    clouds[name] = rec.load_point_cloud(
                        *args, **settings, device="cpu",
                        mesh=pmesh.auto_mesh("on", device="cpu"))
                finally:
                    dist.destroy_process_group()
            else:
                clouds[name] = rec.load_point_cloud(*args, **settings,
                                                    device="cpu")
            seconds[name] = round(time.perf_counter() - t0, 2)
        jax.clear_caches()
    mean, worst = mean_and_max_nn(clouds["port sharded"],
                                  clouds["jax sharded"])
    out = {"views": views, "jax_devices": len(jax.devices()),
           "points": {k: len(v) for k, v in clouds.items()},
           "port_vs_jax_sharded_mm": {"mean": mean, "worst": worst},
           "seconds": seconds, "clouds": clouds}
    if streams:
        out["sharded_vs_stream_sym_mean_nn_mm"] = {
            pkg: sym_mean_nn(clouds[f"{pkg} sharded"],
                             clouds[f"{pkg} stream"])
            for pkg in ("jax", "port")}
    return out


class _Stop(Exception):
    pass


def merge_inputs(root: str, views: int = 12, merge: int = 3):
    """(target, source) of the `merge`-th ICP merge (from 0) of the port's
    streaming `load_point_cloud` of the ball at `chip_smoke.SMALL` with
    `views` views, on a dataset written under `root`."""
    chip_smoke.write_ball_dataset(root, n_viewpoints=views)
    seen = []

    def stop_after(target, source, *args, **kw):
        seen.append((target.copy(), source.copy()))
        if len(seen) > merge:
            raise _Stop
        return real(target, source, *args, **kw)

    real = rec._icp_merge
    try:
        with mock.patch.object(rec, "_icp_merge", stop_after):
            rec.load_point_cloud("ball", io.pc_dir(root), root,
                                 **dict(chip_smoke.SMALL,
                                        n_viewpoints=views), device="cpu")
    except _Stop:
        return seen[merge]
    raise ValueError(f"fewer than {merge + 1} merges")


def merge_transforms(target, source, count: int = 6, scale: float = 1e-5,
                     seed: int = 0) -> dict:
    """Both packages' `icp_regression` of source onto target (SMALL's
    voxel 3 and threshold 10, point to point), unperturbed and on `count`
    - 1 copies of both clouds moved by normal noise of `scale` mm: the
    transforms per package."""
    from autoposeestimation_tpu.ops import icp as jicp
    from autoposeestimation_tpu.ops import pointcloud as jpc
    from autoposeestimation_tpu_torch.ops import icp
    from autoposeestimation_tpu_torch.ops import pointcloud as pc

    size = max(1024, len(target), len(source))
    rng = np.random.default_rng(seed)
    kw = dict(voxel_size=chip_smoke.SMALL["voxel_size"],
              threshold=chip_smoke.SMALL["threshold"], icp_point2point=True,
              icp_point2plane=False)
    out = {"jax": [], "port": []}
    with mock.patch.object(jknn, "nn", functools.partial(jknn.nn_pallas,
                                                         interpret=True)):
        jax.clear_caches()
        for k in range(count):
            t, s = ((x + (rng.normal(size=x.shape) * scale if k else 0.0))
                    .astype(np.float32) for x in (target, source))
            (tp, tv), (sp, sv) = (jpc.pad_bucket(x, min_size=size)
                                  for x in (t, s))
            out["jax"].append(np.asarray(jicp.icp_regression(
                jnp.asarray(tp), jnp.asarray(tv), jnp.asarray(sp),
                jnp.asarray(sv), **kw)[-1]))
            out["port"].append(icp.icp_regression(
                *pc.to_device(tp, tv, "cpu"), *pc.to_device(sp, sv, "cpu"),
                **kw)[-1].numpy())
        jax.clear_caches()
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as tmp:
        if sys.argv[1] == "merge":
            tfs = merge_transforms(*merge_inputs(tmp))
            out = {pkg: [float(np.abs(tf - v[0]).max()) for tf in v]
                   for pkg, v in tfs.items()}
        elif sys.argv[1] == "turned":
            h, w, v = (int(a) for a in sys.argv[2:5])
            out = turned(tmp, (h, w), v)
        else:
            out = sharded(tmp, int(sys.argv[2]))
            out.pop("clouds")
        print(json.dumps(out))
