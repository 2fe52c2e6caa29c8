"""Multi-view object point-cloud reconstruction (port of
`autoposeestimation_tpu/reconstruction/create_pointcloud.py`).

Per object (`load_point_cloud`): per run, pick `n_viewpoints` views whose
cameras cover the view sphere; backproject each view's labelled depth to
the robot frame, voxel-downsample it and remove radius and statistical
outliers on the device; merge the views one by one with ICP and a voxel
downsample; rotate the run cloud by its object_pose rotation about its
centre. Across runs, `align_point_clouds` nudges, registers and cleans.
Writes <run>.ply/.pcd, <obj>_out.ply/.pcd, <obj>.ply/.pcd (AABB-centred,
`voxel_size_out`) and <obj>.xyz (downsampled below 1000 points). All
geometry is in robot-frame mm. The host orchestrates file IO and the
variable-size -> padded-bucket conversions; the cloud ops run on `device`
(CUDA unless the caller passes another).

With a `mesh` (`parallel/mesh.py`) the per-view surfaces are split over its
'data' ranks in contiguous blocks of views (padded with empty views to a
multiple of the ranks) and gathered in view order on every rank; the
sequential ICP merge then runs on rank 0, which writes the artifacts and
broadcasts the result.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import icp as icp_ops
from ..ops import pointcloud as pc
from ..ops import projection as proj
from ..parallel import mesh as pmesh
from ..utils import io
from ..utils.device import resolve_device


def _np_voxel_count(points: np.ndarray, voxel: float) -> int:
    lo = points.min(axis=0)
    ijk = np.floor((points - lo) / voxel).astype(np.int64)
    return len(np.unique(ijk, axis=0))


def _np_voxel_centroids(points: np.ndarray, voxel: float) -> np.ndarray:
    lo = points.min(axis=0)
    ijk = np.floor((points - lo) / voxel).astype(np.int64)
    _, inv = np.unique(ijk, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    k = inv.max() + 1
    sums = np.zeros((k, 3))
    counts = np.zeros(k)
    np.add.at(sums, inv, points)
    np.add.at(counts, inv, 1)
    return sums / counts[:, None]


def get_view_distribution(data_path: str, run: str, n: int, n_viewpoints: int,
                          rng: Optional[np.random.Generator] = None
                          ) -> np.ndarray:
    """`n_viewpoints` sample indices whose camera positions cover the view
    sphere: the voxel size of the camera-position set that yields exactly
    `n_viewpoints` voxels is searched, the voxel centroids mapped back to
    their nearest cameras, and those ordered greedily by nearest neighbour
    from the min-norm position (host numpy)."""
    rng = rng or np.random.default_rng(0)
    points = []
    for idx in range(n):
        meta = io.read_sample_meta(
            os.path.join(data_path, run, f"{idx:06d}.meta.json"))
        points.append(io.robot2cam_from_meta(meta)[:3, 3])
    points = np.asarray(points)
    if n <= n_viewpoints:
        order = [int(np.argmin(np.linalg.norm(points, axis=1)))]
        while len(order) < n:
            last = points[order[-1]]
            rest = [j for j in range(n) if j not in order]
            order.append(min(rest, key=lambda j: np.linalg.norm(
                points[j] - last)))
        return np.asarray(order)

    # initial voxel = min pairwise distance (int), then +-1 search
    d2 = np.linalg.norm(points[:, None] - points[None, :], axis=-1)
    np.fill_diagonal(d2, np.inf)
    voxel = max(int(d2.min()), 1)
    while True:
        k = _np_voxel_count(points, voxel)
        if k == n_viewpoints:
            selected = _np_voxel_centroids(points, voxel)
            break
        if k < n_viewpoints:
            voxel -= 1
            if voxel <= 0:
                selected = points[rng.choice(n, n_viewpoints, replace=False)]
                break
            cents = _np_voxel_centroids(points, voxel)
            pick = rng.choice(len(cents), size=n_viewpoints, replace=False)
            selected = cents[pick]
            break
        voxel += 1

    selection = [int(np.argmin(np.linalg.norm(points - p, axis=1)))
                 for p in selected]
    sel_points = points[selection]
    order = [int(np.argmin(np.linalg.norm(sel_points, axis=1)))]
    while len(order) < n_viewpoints:
        last = sel_points[order[-1]]
        rest = [j for j in range(n_viewpoints) if j not in order]
        order.append(min(rest, key=lambda j: np.linalg.norm(
            sel_points[j] - last)))
    return np.asarray(selection)[order]


def _masked_std(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Population std (f64) over the valid entries only (padding must not
    shrink the spread)."""
    x = x.to(torch.float64)
    w = valid.to(torch.float64)
    n = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(x * w) / n
    return torch.sqrt(torch.clamp(torch.sum(w * (x - mu) ** 2) / n, min=0.0))


def _clean_chain(pts: torch.Tensor, valid: torch.Tensor, min_friends: int,
                 min_dist: float, nb_neighbors: int) -> torch.Tensor:
    """Radius, then statistical outlier removal with the std of the
    Mahalanobis distances as its ratio."""
    valid = pc.remove_radius_outliers(pts, valid, min_friends, min_dist)
    std_ratio = _masked_std(pc.mahalanobis(pts, valid), valid)
    return pc.remove_statistical_outliers(pts, valid, nb_neighbors,
                                          torch.clamp(std_ratio, min=1e-6))


def _intr_vector(intr) -> np.ndarray:
    if hasattr(intr, "as_array"):
        return intr.as_array()
    return np.asarray([intr["fx"], intr["fy"], intr["ppx"], intr["ppy"]],
                      np.float32)


def get_surface(label: np.ndarray, depth: np.ndarray, intr, robot2cam,
                min_friends: int, min_dist: float, nb_neighbors: int,
                voxel_size: float, device=None) -> np.ndarray:
    """One view's cleaned robot-frame surface (K, 3): the labelled depth
    pixels backprojected, voxel-downsampled, radius and statistical
    outliers removed."""
    dev = resolve_device(device)
    ys, xs = np.nonzero((label != 0) & (depth != 0))
    if len(ys) == 0:
        return np.zeros((0, 3))
    z = depth[ys, xs].astype(np.float32)
    cam = proj.pixels_to_points(
        torch.as_tensor(ys, device=dev), torch.as_tensor(xs, device=dev),
        torch.as_tensor(z, device=dev),
        torch.as_tensor(_intr_vector(intr), device=dev)).cpu().numpy()
    r2c = np.asarray(robot2cam)
    pts, valid = pc.to_device(*pc.pad_bucket(cam @ r2c[:3, :3].T
                                             + r2c[:3, 3]), dev)
    pts, valid = pc.voxel_downsample(pts, valid, voxel_size)
    # the voxel means are the valid prefix: the quadratic outlier chain runs
    # on the smallest bucket that holds them (padding changes no result)
    size = pc.bucket_size(int(valid.sum()))
    pts, valid = pts[:size], valid[:size]
    valid = _clean_chain(pts, valid, min_friends, min_dist, nb_neighbors)
    return pc.compact(pts, valid)


def get_surfaces_batched(labels: Sequence[np.ndarray],
                         depths: Sequence[np.ndarray], intrs, robot2cams,
                         min_friends: int, min_dist: float, nb_neighbors: int,
                         voxel_size: float, mesh: Optional[pmesh.Mesh] = None,
                         cap: int = 4096, device=None) -> List[np.ndarray]:
    """Every view's surface on the full pixel lattice: the H*W lattice is
    backprojected under its mask, voxel-downsampled exactly, and the first
    `cap` voxel means (all of them whenever K <= cap) go through the
    outlier chain. A view with more than `cap` voxels is recomputed by
    `get_surface`. Matches per-view `get_surface` up to float association
    order. With `mesh` each 'data' rank runs its block of the views (the
    list padded with empty views to a multiple of the ranks) and every rank
    returns all of them, in order."""
    dev = resolve_device(device)
    v = len(labels)
    views = list(zip(labels, depths,
                     intrs if isinstance(intrs, (list, tuple))
                     else [intrs] * v, robot2cams))
    if mesh is None:
        return [_lattice_surface(*view, min_friends, min_dist, nb_neighbors,
                                 voxel_size, cap, dev) for view in views]
    pad = (-v) % mesh.shape[mesh.axes[0]]
    if pad and views:
        empty = np.zeros_like(np.asarray(views[0][0]))
        views += [(empty, np.zeros(empty.shape, np.float32), views[0][2],
                   np.eye(4))] * pad
    lo, hi = pmesh.row_block(mesh, len(views)) or (0, len(views))
    mine = [_lattice_surface(*view, min_friends, min_dist, nb_neighbors,
                             voxel_size, cap, dev) for view in views[lo:hi]]
    gathered = pmesh.all_gather_objects(mesh, mine)
    return [s for block in gathered for s in block][:v]


def _columns(views, k: int) -> List[list]:
    """The first k fields of a list of view tuples, as k lists."""
    return [[view[i] for view in views] for i in range(k)]


def _lattice_surface(label, depth, intr, r2c, min_friends: int,
                     min_dist: float, nb_neighbors: int, voxel_size: float,
                     cap: int, dev) -> np.ndarray:
    """One view of `get_surfaces_batched`."""
    h, w = label.shape
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None] \
        .expand(h, w).reshape(-1)
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :] \
        .expand(h, w).reshape(-1)
    z = torch.as_tensor(np.asarray(depth, np.float32), device=dev
                        ).reshape(-1)
    valid = (torch.as_tensor(np.asarray(label), device=dev).reshape(-1)
             != 0) & (z > 0)
    cam = proj.pixels_to_points(
        rows, cols, z, torch.as_tensor(_intr_vector(intr), device=dev))
    r2c_t = torch.as_tensor(np.asarray(r2c, np.float32), device=dev)
    robot = cam @ r2c_t[:3, :3].T + r2c_t[:3, 3]
    pts, v = pc.voxel_downsample(robot, valid, voxel_size)
    if int(v.sum()) > cap:
        # slicing would drop a contiguous block of high voxel ids
        return get_surface(np.asarray(label), np.asarray(depth), intr,
                           r2c, min_friends, min_dist, nb_neighbors,
                           voxel_size, dev)
    pts, v = pts[:cap], v[:cap]
    v = _clean_chain(pts, v, min_friends, min_dist, nb_neighbors)
    return pc.compact(pts, v)


def _icp_merge(target_np: np.ndarray, source_np: np.ndarray,
               voxel_size: float, threshold: float,
               icp_point2point: bool = True,
               icp_point2plane: bool = False,
               global_regression: bool = False,
               device=None) -> np.ndarray:
    """icp_regression, then the merge of the downsampled clouds (the
    registration runs on the voxel-downsampled clouds and the merged cloud
    is built from them)."""
    dev = resolve_device(device)
    size = max(1024, len(target_np), len(source_np))
    t, tv = pc.to_device(*pc.pad_bucket(target_np, min_size=size), dev)
    s, sv = pc.to_device(*pc.pad_bucket(source_np, min_size=size), dev)
    tgt, tvalid, src, svalid, tf = icp_ops.icp_regression(
        t, tv, s, sv, voxel_size=voxel_size, threshold=threshold,
        icp_point2point=icp_point2point, icp_point2plane=icp_point2plane,
        global_regression=global_regression)
    tf = tf.cpu().numpy()
    moved = pc.compact(src, svalid) @ tf[:3, :3].T + tf[:3, 3]
    merged = np.concatenate([moved, pc.compact(tgt, tvalid)])
    mp, mv = pc.voxel_downsample(*pc.to_device(*pc.pad_bucket(merged), dev),
                                 voxel_size)
    return pc.compact(mp, mv)


def align_point_clouds(clouds: List[np.ndarray], min_friends: int,
                       min_dist: float, nb_neighbors: int,
                       voxel_size: float = 5.0, threshold: float = 50.0,
                       device=None) -> np.ndarray:
    """Cross-run alignment: y-offset nudge, point-to-point ICP, merge, voxel
    downsample, radius and statistical outlier removal."""
    dev = resolve_device(device)
    target = clouds[0]
    for source in clouds[1:]:
        diff = source.mean(axis=0) - target.mean(axis=0)
        if diff[1] > -30:
            source = source + np.asarray([0.0, -30.0 - diff[1], 0.0])
        target = _icp_merge(target, source, voxel_size, threshold,
                            device=dev)
        tp, tv = pc.to_device(*pc.pad_bucket(target), dev)
        target = pc.compact(tp, _clean_chain(tp, tv, min_friends, min_dist,
                                             nb_neighbors))
    return target


def get_surface_positions(root: str, object_name: str, run: str,
                          min_friends: int, min_dist: float,
                          nb_neighbors: int, mode: str = "gen",
                          voxel_size: float = 5.0,
                          mesh: Optional[pmesh.Mesh] = None,
                          device=None) -> np.ndarray:
    """Per-sample (surface centroid, camera position) pairs in the robot
    frame, the inputs of `ops/pointcloud.triangulate_position`; one view in
    memory at a time, or with `mesh` all views through
    `get_surfaces_batched` split over its 'data' ranks."""
    dev = resolve_device(device)
    label_root = os.path.join(io.label_dir(root), object_name, run)
    data_root = os.path.join(io.data_dir(root), object_name, run)

    def read_view(fn):
        stem = fn[: -len(f".{mode}.label.png")]
        meta = io.read_sample_meta(os.path.join(data_root,
                                                stem + ".meta.json"))
        return (io.read_label(os.path.join(label_root, fn)),
                io.read_depth(os.path.join(data_root, stem + ".depth.png")
                              ).astype(np.float64),
                meta["intr"], io.robot2cam_from_meta(meta))

    fns = [fn for fn in sorted(os.listdir(label_root))
           if fn.endswith(f".{mode}.label.png")]
    if mesh is not None:
        views = [read_view(fn) for fn in fns]
        surfaces = get_surfaces_batched(
            *_columns(views, 4), min_friends, min_dist, nb_neighbors,
            voxel_size, mesh=mesh, device=dev)
        r2cs = [view[3] for view in views]
    else:
        surfaces, r2cs = [], []
        for fn in fns:
            label, depth, intr, r2c = read_view(fn)
            surfaces.append(get_surface(label, depth, intr, r2c, min_friends,
                                        min_dist, nb_neighbors, voxel_size,
                                        dev))
            r2cs.append(r2c)
    return np.asarray([[s.mean(axis=0), r2c[:3, 3]]
                       for s, r2c in zip(surfaces, r2cs) if len(s)])


def load_point_cloud(object_name: str, save_dir: str, root: str,
                     reference_point=np.zeros(3), mode: str = "gen",
                     n_viewpoints: int = 10, min_friends: int = 10,
                     voxel_size: float = 5.0, voxel_size_out: float = 10.0,
                     threshold: float = 50.0, min_dist: float = 10.0,
                     nb_neighbors: int = 5, global_regression: bool = False,
                     icp_point2point: bool = True,
                     icp_point2plane: bool = True,
                     progress=None, mesh: Optional[pmesh.Mesh] = None,
                     device=None) -> np.ndarray:
    """Reconstruct one object from its labelled runs and write every
    artifact; returns the final centred cloud (mm) at `voxel_size_out`.
    Runs on `device` (CUDA unless the caller passes another). With `mesh`
    every rank calls it: each run's surfaces come from
    `get_surfaces_batched` split over the 'data' ranks, rank 0 merges and
    writes, and every rank returns its cloud."""
    dev = resolve_device(device)
    writer = pmesh.is_writer(mesh)
    label_root = os.path.join(io.label_dir(root), object_name)
    runs = [d for d in sorted(os.listdir(label_root)) if d != "extra"]
    if not runs:
        raise ValueError("no labels obtained yet")
    data_path = os.path.join(io.data_dir(root), object_name)
    pcd_path = os.path.join(save_dir, object_name)
    if writer:
        os.makedirs(pcd_path, exist_ok=True)

    run_clouds: List[np.ndarray] = []
    for run in runs:
        n = len([f for f in os.listdir(os.path.join(label_root, run))
                 if f.endswith(f".{mode}.label.png")])

        def read_view(idx):
            meta = io.read_sample_meta(
                os.path.join(data_path, run, f"{idx:06d}.meta.json"))
            label = io.read_label(os.path.join(
                label_root, run, f"{idx:06d}.{mode}.label.png"))
            depth = io.read_depth(os.path.join(
                data_path, run, f"{idx:06d}.depth.png")).astype(np.float64)
            return (label, depth, meta["intr"], io.robot2cam_from_meta(meta),
                    np.asarray(meta["object_pose"])[:3, :3])

        selection = get_view_distribution(data_path, run, n,
                                          min(n_viewpoints, n))
        rotation = np.eye(3)
        surfaces = None
        if mesh is not None:
            views = [read_view(idx) for idx in selection]
            if views:
                rotation = views[-1][4]
            surfaces = get_surfaces_batched(
                *_columns(views, 4), min_friends, min_dist, nb_neighbors,
                voxel_size, mesh=mesh, device=dev)
            if not writer:         # the sequential merge is rank 0's
                continue
        merged: Optional[np.ndarray] = None
        for view_i, idx in enumerate(selection):
            if surfaces is not None:
                source = surfaces[view_i]
            else:
                label, depth, intr, r2c, rotation = read_view(idx)
                source = get_surface(label, depth, intr, r2c, min_friends,
                                     min_dist, nb_neighbors, voxel_size, dev)
            if len(source) == 0:
                continue
            if merged is None:
                merged = source
            else:
                merged = _icp_merge(merged, source, voxel_size, threshold,
                                    icp_point2point, icp_point2plane,
                                    global_regression, dev)
            if progress is not None:
                progress(run, int(idx), len(merged))

        if merged is None:
            continue
        # rotate the run cloud by its object_pose rotation about its centre
        center = merged.mean(axis=0)
        merged = (merged - center) @ rotation.T + center
        io.write_ply(os.path.join(pcd_path, f"{run}.ply"), merged)
        io.write_pcd(os.path.join(pcd_path, f"{run}.pcd"), merged)
        run_clouds.append(merged)

    if not writer:
        return pmesh.broadcast_object(mesh, None)
    cloud = align_point_clouds(run_clouds, min_friends, min_dist,
                               nb_neighbors, voxel_size, threshold, dev)
    io.write_ply(os.path.join(pcd_path, f"{object_name}_out.ply"), cloud)
    io.write_pcd(os.path.join(pcd_path, f"{object_name}_out.pcd"), cloud)

    # the centred cloud at voxel_size_out
    cp, cv = pc.to_device(*pc.pad_bucket(cloud), dev)
    center = pc.aabb_center(cp, cv).cpu().numpy()
    dp, dv = pc.voxel_downsample(cp, cv, voxel_size_out)
    down = pc.compact(dp, dv) - center
    io.write_ply(os.path.join(pcd_path, f"{object_name}.ply"), down)
    io.write_pcd(os.path.join(pcd_path, f"{object_name}.pcd"), down)

    # .xyz: grow the voxel until fewer than 1000 points remain
    big = cloud - center
    vs = voxel_size
    out = big
    while len(out) >= 1000:
        vs += 0.1
        out = _np_voxel_centroids(big, vs)
    io.write_xyz(os.path.join(pcd_path, f"{object_name}.xyz"), out)
    return pmesh.broadcast_object(mesh, down)
