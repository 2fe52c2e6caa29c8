"""The live multi-object prediction path (port of
`autoposeestimation_tpu/pipeline/predict.py`).

  normalize -> U-Net -> softmax/argmax -> per-class best-component CCA
  -> zoom window crop + choose + backproject (per class) -> one PoseNet
  forward over all class slots -> iterative refiner -> per-class pose.

Every class has a slot; `found` marks the live ones. `_predict_frame` runs
one frame; `_predict_batch` runs B frames with the batch and class axes
fused into B*K lanes, so a call launches as many kernels for B frames as
for one. `full_prediction` serves one frame and waits for it;
`serve_stream` keeps frames in flight on the card and returns them in
order. The random draws of the point selection come from a
`torch.Generator`, or are given as `uniforms` (K, num_points) per frame in
[0, 1) so that a caller can reproduce another implementation's draws
exactly. `get_robot2object` moves camera-frame poses into the robot frame.

With `build_models(seg_out_stride=s)` (s in 2, 4, 8) the U-Net's decoder
stops on the 1/s lattice (`models/unet.py`): the class planes and the CCA
run there, with the CCA's pooling divided by s and the found-gate's pixel
count multiplied by s^2, and each selected component is upsampled to the
frame before the crop, so the pose stage sees full-resolution masks; the
returned argmax is upsampled alike.
"""
from __future__ import annotations

import collections
import os
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import weights
from ..models import losses
from ..models.common import init_like_flax, normalize_imagenet
from ..models.densefusion import PoseNet, PoseRefineNet
from ..models.unet import UNet
from ..ops import cca
from ..ops import projection as proj
from ..train import checkpoints
from ..utils import io
from ..utils import transforms as T
from ..utils.device import resolve_device
from ..utils.timing import StageTimer, count, span
from . import frame_graphs


class PredictionModels(NamedTuple):
    seg_model: UNet
    posenet: PoseNet
    refiner: PoseRefineNet
    classes: tuple               # class names; index 0 = first foreground
    model_points: torch.Tensor   # (K, M, 3) per-class model clouds [m]
    device: torch.device
    num_points: int
    crop: int
    refine_iters: int
    # > 1: confidence-weighted top-k candidate averaging; 1 = argmax pick
    agg_topk: int = 1
    # CCA pooling factor and unrolled sweep count (ops/cca.py)
    cca_scale: int = 8
    cca_sweeps: int = 3
    # PSPNet embedding decoder stride (8 non-symmetric, 2 symmetric sets)
    emb_stride: int = 8
    emb_resize_late: bool = False
    # component rule: "sum" (probability mass) serves; "mean_float" is the
    # original live path's mean-probability rule
    cca_rule: str = "sum"


def _pack_masks(masks: torch.Tensor) -> torch.Tensor:
    """Bool masks (..., H, W) -> (..., H, W//8) uint8, MSB first
    (np.unpackbits order); W % 8 == 0."""
    m = masks.reshape(masks.shape[:-1] + (-1, 8)).to(torch.int32)
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=masks.device)
    return (m << shifts).sum(-1).to(torch.uint8)


def _unpack_masks(packed: np.ndarray) -> np.ndarray:
    """Host inverse of `_pack_masks`."""
    return np.unpackbits(packed, axis=-1).astype(bool)


def _segment(seg_model: UNet, image: torch.Tensor):
    """image uint8 (3, H, W) -> (probs (C, h, w), argmax (h, w)) on the
    U-Net's output lattice, (H, W) divided by its `out_stride`, rounded
    up."""
    logits = seg_model(normalize_imagenet(image)[None])[0]
    probs = torch.softmax(logits, dim=0)
    return probs, torch.argmax(probs, dim=0)


def _upsample_plane(p: torch.Tensor, s: int, hw) -> torch.Tensor:
    """Nearest-upsample the last two axes by s and fit them to hw: the
    ceil-mode overshoot is cropped, a shortfall padded with zeros (False).
    The exact inverse of the lattice reduction for block-constant
    planes."""
    if s == 1:
        return p
    p = p.repeat_interleave(s, dim=-2).repeat_interleave(s, dim=-1)
    h, w = hw
    if p.shape[-2] >= h and p.shape[-1] >= w:
        return p[..., :h, :w]
    out = p.new_zeros(p.shape[:-2] + (h, w))
    hh, ww = min(h, p.shape[-2]), min(w, p.shape[-1])
    out[..., :hh, :ww] = p[..., :hh, :ww]
    return out


def _class_mask(score_plane, pred_arg, cls_id, min_count: int = 100,
                cca_scale: int = 1, cca_sweeps: int = 0,
                cca_rule: str = "sum", seg_stride: int = 1, full_hw=None):
    """Best connected component of class `cls_id` (1-based; a tensor of
    shape S for planes (S, H, W)) scored on its probability plane. Returns
    (component (S, H, W), found (S,), converged); `found` also needs more
    than `min_count` class pixels. `pred_arg` broadcasts against the
    planes: (B, 1, H, W) with planes (B, S, H, W) gives B*S components in
    one call.

    `seg_stride` s > 1: the planes lie on the U-Net's 1/s lattice. The
    CCA's pooling shrinks by s (the same component grid in frame pixels),
    the count is scaled back to frame pixels, and the component is
    upsampled to `full_hw`."""
    cls_id = torch.as_tensor(cls_id, device=pred_arg.device)
    cls_mask = pred_arg == cls_id[..., None, None]
    count = cls_mask.sum((-2, -1)) * (seg_stride * seg_stride)
    score = torch.where(cls_mask, score_plane, 0.0)
    comp, found, converged = cca.best_component_mask(
        cls_mask, score, min_size=0.0, rule=cca_rule,
        scale=max(1, cca_scale // seg_stride), fixed_sweeps=cca_sweeps,
        with_flag=True)
    comp = _upsample_plane(comp, seg_stride, full_hw)
    return comp, found & (count > min_count), converged


def _pose_stage(models: PredictionModels, crops, clouds, chooses, obj_idx,
                refine_iters: int):
    with span("graph.pose"):
        pred_r, pred_t, pred_c, emb = models.posenet(crops, clouds, chooses,
                                                     obj_idx)
        quat, trans = losses.estimator_prediction(
            pred_r, pred_t, pred_c, clouds, topk=models.agg_topk)
        new_points = losses.rebase_points(quat, trans, clouds)
    with span("graph.refine"):
        for _ in range(refine_iters):
            dr, dt = models.refiner(new_points, emb, obj_idx)
            quat, trans = losses.compose_refined(dr, dt, quat, trans)
            new_points = losses.rebase_points(quat, trans, clouds)
    return quat, trans


def _predict_frame(models: PredictionModels, image, depth, intr,
                   depth_scale, uniforms) -> Dict[str, torch.Tensor]:
    """One frame on the models' device: image uint8 (H, W, 3), depth
    (H, W), intr (4,), uniforms (K, num_points)."""
    img = image.permute(2, 0, 1)
    depth = depth.to(torch.float32)
    h, w = depth.shape
    k = len(models.classes)
    stride = models.seg_model.out_stride
    with span("graph.segment"):
        probs, pred_arg = _segment(models.seg_model, img)
    with span("graph.cca"):
        cls_ids = torch.arange(1, k + 1, device=img.device)
        masks, found, converged = _class_mask(
            probs[1:k + 1], pred_arg, cls_ids, cca_scale=models.cca_scale,
            cca_sweeps=models.cca_sweeps, cca_rule=models.cca_rule,
            seg_stride=stride, full_hw=(h, w))

    with span("graph.crop"):
        r0, c0, win = proj.zoom_window_bbox(masks, models.crop, h, w)
        clouds, chooses, counts = proj.backproject_choose_zoom(
            depth, masks, intr, depth_scale, r0, c0, win, models.crop,
            models.num_points, uniforms)
        crops = normalize_imagenet(
            proj.resample_window(img, r0, c0, win, models.crop))
        found = found & (counts > 0)

    obj_idx = torch.arange(k, device=img.device)
    quat, trans = _pose_stage(models, crops, clouds, chooses, obj_idx,
                              models.refine_iters)
    out = {"found": found, "masks": masks, "quats": quat,
           "positions": trans,
           "argmax": _upsample_plane(pred_arg, stride, (h, w)),
           "cca_converged": converged.expand(k)}
    if w % 8 == 0:
        out["masks_packed"] = _pack_masks(masks)
    return out


def _predict_batch(models: PredictionModels, images, depths, intr,
                   depth_scale, uniforms) -> Dict[str, torch.Tensor]:
    """B frames on the models' device: images uint8 (B, H, W, 3), depths
    (B, H, W) in the camera's dtype, intr (4,), uniforms (B, K,
    num_points). The outputs of `_predict_frame` with a leading batch axis;
    frame i equals `_predict_frame` on frame i with draws uniforms[i].

    The batch and class axes are fused into B*K lanes: one U-Net forward,
    one CCA over all lanes, one windowed gather over all lanes (each from
    its own frame) and one PoseNet + refiner forward over the lanes, so the
    kernels launched do not grow with B."""
    imgs = images.permute(0, 3, 1, 2)                        # (B, 3, H, W)
    depths = depths.to(torch.float32)
    b, h, w = depths.shape
    k = len(models.classes)
    dev = imgs.device
    stride = models.seg_model.out_stride
    # NCHW, as the single-frame graph's input reaches cuDNN (its strides
    # are not channels-last): at one layout the f32 logits of a frame do
    # not depend on the batch, while channels-last algorithms round
    # otherwise and flip argmax pixels
    with span("graph.segment"):
        logits = models.seg_model(normalize_imagenet(imgs).contiguous())
        probs = torch.softmax(logits, dim=1)
        pred_arg = torch.argmax(probs, dim=1)            # (B, H/s, W/s)
    with span("graph.cca"):
        cls_ids = torch.arange(1, k + 1, device=dev)
        masks, found, converged = _class_mask(
            probs[:, 1:k + 1], pred_arg[:, None], cls_ids,
            cca_scale=models.cca_scale, cca_sweeps=models.cca_sweeps,
            cca_rule=models.cca_rule, seg_stride=stride, full_hw=(h, w))
        masks, found = masks.flatten(0, 1), found.flatten(0, 1)  # B*K lanes

    with span("graph.crop"):
        lane_frame = torch.arange(b, device=dev).repeat_interleave(k)
        r0, c0, win = proj.zoom_window_bbox(masks, models.crop, h, w)
        clouds, chooses, counts = proj.backproject_choose_zoom(
            depths, masks, intr, depth_scale, r0, c0, win, models.crop,
            models.num_points, uniforms.reshape(b * k, -1),
            frame=lane_frame)
        crops = normalize_imagenet(proj.resample_window(
            imgs, r0, c0, win, models.crop, frame=lane_frame))
        found = found & (counts > 0)

    obj_idx = torch.arange(k, device=dev).repeat(b)
    quat, trans = _pose_stage(models, crops, clouds, chooses, obj_idx,
                              models.refine_iters)

    def per_frame(t):
        return t.reshape((b, k) + t.shape[1:])

    masks = per_frame(masks)
    out = {"found": per_frame(found), "masks": masks,
           "quats": per_frame(quat), "positions": per_frame(trans),
           "argmax": _upsample_plane(pred_arg, stride, (h, w)),
           "cca_converged": converged.expand(b, k)}
    if w % 8 == 0:
        out["masks_packed"] = _pack_masks(masks)
    return out


def _intr_vec(meta: Dict) -> np.ndarray:
    intr = meta["intr"]
    return (intr.as_array() if hasattr(intr, "as_array") else np.asarray(
        [intr["fx"], intr["fy"], intr["ppx"], intr["ppy"]], np.float32))


def _given_uniforms(shape, uniforms) -> torch.Tensor:
    """Given draws as an f32 tensor (on the host unless given elsewhere),
    checked against `shape`."""
    u = (uniforms.to(torch.float32) if isinstance(uniforms, torch.Tensor)
         else torch.from_numpy(np.array(uniforms, np.float32)))
    if tuple(u.shape) != tuple(shape):
        raise ValueError(f"uniforms must be {tuple(shape)}: "
                         f"{tuple(u.shape)}")
    return u


def _uniforms(shape, device: torch.device,
              generator: Optional[torch.Generator],
              uniforms) -> torch.Tensor:
    """The point-selection draws on `device`: given, or from `generator`
    (seeded from the clock when None)."""
    if uniforms is not None:
        return _given_uniforms(shape, uniforms).to(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            time.time_ns() % (2 ** 31))
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


def _frame_arrays(image, depth, meta):
    """A frame's inputs on the host as the graph takes them: image uint8,
    depth f32, intrinsics (4,), depth scale f32 ()."""
    return (np.asarray(image, np.uint8), np.asarray(depth, np.float32),
            _intr_vec(meta), np.array(float(meta["depth_scale"]), np.float32))


def _pinned(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t`, copied to pinned memory where it lies on the host and `device`
    is a card, so that the copy to the card is asynchronous."""
    return (t.pin_memory() if device.type == "cuda" and not t.is_cuda
            else t)


def _frame_inputs(image, depth, meta, device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _frame_arrays(image, depth, meta))


def _materialize(host: Dict[str, np.ndarray], models: PredictionModels,
                 want_masks: bool = True) -> Dict:
    """One frame's outputs, on the host -> the class-keyed prediction
    dict; `want_masks=False` leaves the masks out."""
    found, quats = host["found"], host["quats"]
    positions, cca_conv = host["positions"], host["cca_converged"]
    if want_masks:
        masks = (_unpack_masks(host["masks_packed"])
                 if "masks_packed" in host else host["masks"])
    predictions = {}
    for i, cls in enumerate(models.classes):
        if found[i]:
            predictions[cls] = {"position": positions[i],
                                "rotation": quats[i]}
            if want_masks:
                predictions[cls]["mask"] = masks[i].astype(np.uint8) * 255
    return {"predictions": predictions,
            "cca_converged": {cls: bool(cca_conv[i])
                              for i, cls in enumerate(models.classes)}}


def _fetched(out: Dict, want_masks: bool):
    """The outputs that `_materialize` reads: the packed masks where the
    graph made them (8x fewer bytes to copy)."""
    names = ["found", "quats", "positions", "cca_converged"]
    if want_masks:
        names.append("masks_packed" if "masks_packed" in out else "masks")
    return names


def full_prediction(image: np.ndarray, depth: np.ndarray, meta: Dict,
                    models: PredictionModels,
                    generator: Optional[torch.Generator] = None,
                    uniforms=None, color_prediction: bool = False,
                    color_dict: Optional[Dict] = None,
                    with_bbox: bool = False) -> Dict:
    """{'predictions': {cls: {'mask', 'position', 'rotation'}},
    'cca_converged': {cls: bool},
    'elapsed_times': {'segmentation', 'pose_estimation', 'total'}}, and
    with `color_prediction` the painted overlays 'segmented_prediction'
    and 'pose_prediction' (`color_dict` maps a class to a `main.
    COLOR_DICT` entry; by default the classes take its colours in turn;
    `with_bbox` adds each mask's quantized bbox).

    `image` uint8 RGB (H, W, 3); `depth` raw units (H, W); `meta` gives
    `intr` (Intrinsics or dict) and `depth_scale` (to meters).
    'segmentation' times the whole frame on the device (its upload, the
    graph and the read of `found`), 'pose_estimation' the copy of its other
    outputs to the host (`StageTimer`, as the JAX version). On the card the
    graph is replayed (`frame_graphs.py`), its host inputs staged through
    pinned memory.

    Spans (`utils/timing.py`), one unit 'frame': 'frame.compute' ('frame.
    upload', the graph's 'graph.*' or, on the card, 'graph.replay', 'frame.
    wait' on `found`) and 'frame.readback'; each blocking read counts one
    'host_syncs'."""
    timer = StageTimer()
    k, dev = len(models.classes), models.device
    shape = (k, models.num_points)
    with span("frame", unit=True):
        with torch.inference_mode():
            with timer.stage("segmentation", span="frame.compute"):
                with span("frame.upload"):
                    u = (_uniforms(shape, dev, generator, None)
                         if uniforms is None
                         else _given_uniforms(shape, uniforms))
                    sources = tuple(
                        _pinned(t, dev) for t in
                        [torch.from_numpy(a) for a in
                         _frame_arrays(image, depth, meta)] + [u])
                    run = frame_graphs.load(_predict_frame, models, sources)
                out = run()
                with span("frame.wait"):
                    out["found"] = out["found"].cpu()
                    count("host_syncs")
            with timer.stage("pose_estimation", span="frame.readback"):
                names = _fetched(out, True)
                host = {name: out[name].cpu().numpy() for name in names}
                count("host_syncs", len(names) - 1)   # `found`: read above
                out_dict = _materialize(host, models)
        if color_prediction:
            from ..main import COLOR_DICT
            from . import visualize as viz

            colors = list(COLOR_DICT.values())
            cd = color_dict or {cls: colors[i % len(colors)]
                                for i, cls in enumerate(models.classes)}
            mp = {cls: models.model_points[i].cpu().numpy()
                  for i, cls in enumerate(models.classes)}
            out_dict.update(viz.paint_prediction(image, out_dict, cd,
                                                 meta["intr"], mp,
                                                 with_bbox=with_bbox))
    out_dict["elapsed_times"] = timer.total()
    return out_dict


def serve_stream(frames, models: PredictionModels, in_flight: int = 4,
                 want_masks: bool = True,
                 generator: Optional[torch.Generator] = None,
                 uniforms=None, batch: int = 1):
    """Serve a stream of frames with `in_flight` device calls outstanding
    (a generator). `frames` yields (image, depth, meta) as
    `full_prediction` takes them; the results come back in order, one
    `full_prediction`-form dict per frame (without 'elapsed_times'), with
    no masks when `want_masks` is False.

    `batch` > 1 runs that many frames per call through `_predict_batch`.
    Frames are grouped while their intrinsics and depth_scale match (a
    change dispatches the open batch); a short tail is padded by repeating
    its last frame, and the padding's results are dropped.

    The draws come from `generator` (on the device; seeded from the clock
    when None) or from `uniforms`, an iterable of one (K, num_points) array
    per frame in stream order. JAX's `serve_stream(key=...)` gives frame i
    the draws of key `fold_in(key, i)` at batch 1 and of key
    `split(fold_in(key, f0), batch)[i - f0]` in a batch that starts at
    frame f0.

    Dispatching does not wait for the device. Each call's inputs are
    written to pinned host buffers, a ring of `in_flight` + 1 sets, and
    copied to the card asynchronously (into the static inputs of the
    replayed graph, `frame_graphs.py`); the depth goes in the camera's
    dtype and is cast on the card. The outputs that the host reads are
    copied into pinned host tensors asynchronously, right behind the
    replay and before the next call's inputs, and an event recorded
    behind them; a call's results are read after its event has completed,
    and only then is its buffer set filled again. Everything runs on the
    current stream, so no tensor is reused while a copy still reads it
    and no replay overwrites outputs still being copied: an upload stream
    would overlap ~0.1 ms of copies a frame with compute and is not worth
    its ordering.

    Spans (`utils/timing.py`), one unit a call: 'stream.dispatch' (with
    'stream.upload' and the graph's 'graph.*' or, on the card,
    'graph.replay'; attributes `frames`, `batch`, `in_flight`), then
    'stream.wait' on its event (one 'host_syncs') and a 'stream.readback'
    for each frame."""
    dev = models.device
    k, npt = len(models.classes), models.num_points
    batch = max(1, batch)
    on_card = dev.type == "cuda"
    draws = None if uniforms is None else iter(uniforms)
    if draws is None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(
            time.time_ns() % (2 ** 31))
    ring = [{} for _ in range(in_flight + 1)]
    small = {}     # (intr, depth_scale) -> their tensors on the device
    pending = collections.deque()
    dispatched = 0

    def upload(slot, name, arrays):
        """`arrays` (one a frame) in the slot's pinned buffer."""
        dtype = torch.from_numpy(arrays[0][:0]).dtype
        shape = (batch,) + arrays[0].shape
        buf = slot.get(name)
        if buf is None or tuple(buf.shape) != shape or buf.dtype != dtype:
            buf = slot[name] = torch.empty(shape, dtype=dtype,
                                           pin_memory=on_card)
        host = buf.numpy()
        for i in range(batch):       # the padding repeats the last frame
            host[i] = arrays[min(i, len(arrays) - 1)]
        return buf

    def dispatch(items, key):
        nonlocal dispatched
        slot = ring[dispatched % len(ring)]
        dispatched += 1
        with span("stream.dispatch", unit=True, frames=len(items),
                  batch=batch, in_flight=len(pending)) as call, \
                torch.inference_mode():
            with span("stream.upload"):
                images = upload(slot, "images", [np.asarray(im, np.uint8)
                                                 for im, _, _ in items])
                depths = upload(slot, "depths",
                                [np.asarray(d) for _, d, _ in items])
                if draws is not None:
                    u = upload(slot, "uniforms", [v for _, _, v in items])
                else:
                    u = torch.rand((batch, k, npt), generator=generator,
                                   device=generator.device).to(dev)
                intr, scale = small[key]
                if batch == 1:
                    run = frame_graphs.load(
                        _predict_frame, models,
                        (images[0], depths[0], intr, scale, u[0]))
                else:
                    run = frame_graphs.load(
                        _predict_batch, models,
                        (images, depths, intr, scale, u))
            out = run()
            if batch == 1:
                out = {name: t[None] for name, t in out.items()}
            host = {name: out[name].to("cpu", non_blocking=True)
                    for name in _fetched(out, want_masks)}
            event = None
            if on_card:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
        # `out` stays referenced until the results are read
        return host, len(items), event, out, call.unit

    def collect():
        """A call's results, each frame's readback a span closed before
        its `yield`."""
        host, n_valid, event, _, unit = pending.popleft()
        with span("stream.wait", unit=unit):
            if event is not None:
                event.synchronize()
                count("host_syncs")
        arrays = {}
        for i in range(n_valid):
            with span("stream.readback", unit=unit):
                arrays = arrays or {name: t.numpy()
                                    for name, t in host.items()}
                result = _materialize({name: a[i] for name, a in
                                       arrays.items()}, models, want_masks)
            yield result

    def submit(items, key):
        while len(pending) > in_flight:   # frees the buffer set to reuse
            yield from collect()
        pending.append(dispatch(items, key))

    open_key, open_items = None, []
    for image, depth, meta in frames:
        intr = _intr_vec(meta)
        key = (tuple(np.asarray(intr).tolist()), float(meta["depth_scale"]))
        if key not in small:
            vals = torch.tensor(list(key[0]) + [key[1]], dtype=torch.float32)
            if on_card:
                vals = vals.pin_memory()
            vals = vals.to(dev, non_blocking=True)
            small[key] = (vals[:4], vals[4])
        if open_items and key != open_key:
            yield from submit(open_items, open_key)
            open_items = []
        open_key = key
        drawn = None
        if draws is not None:
            drawn = np.asarray(next(draws), np.float32)
            if drawn.shape != (k, npt):
                raise ValueError(f"uniforms must be {(k, npt)} a frame: "
                                 f"{drawn.shape}")
        open_items.append((image, depth, drawn))
        if len(open_items) == batch:
            yield from submit(open_items, open_key)
            open_items = []
        while len(pending) > in_flight:
            yield from collect()
    if open_items:
        yield from submit(open_items, open_key)
    while pending:
        yield from collect()


def pose_from_mask(image, depth, meta: Dict, models: PredictionModels, mask,
                   cls_name: str, generator: Optional[torch.Generator] = None,
                   uniforms=None, refine_iters: Optional[int] = None) -> Dict:
    """Pose stage only, for a given mask (H, W) of class `cls_name`:
    {'position', 'rotation', 'count'}. `uniforms` is (num_points,). With
    neither `generator` nor `uniforms` the draws come from a generator
    seeded with 0, as the JAX side's PRNGKey(0), so repeated calls give the
    same pose."""
    dev = models.device
    iters = models.refine_iters if refine_iters is None else refine_iters
    if generator is None and uniforms is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        image_t, depth_t, intr, scale = _frame_inputs(image, depth, meta, dev)
        m = torch.as_tensor(np.asarray(mask, bool), device=dev)[None]
        u = _uniforms((1, models.num_points), dev, generator,
                      None if uniforms is None
                      else np.asarray(uniforms).reshape(1, -1))
        h, w = depth_t.shape
        img = image_t.permute(2, 0, 1)
        r0, c0, win = proj.zoom_window_bbox(m, models.crop, h, w)
        cloud, choose, count = proj.backproject_choose_zoom(
            depth_t, m, intr, scale, r0, c0, win, models.crop,
            models.num_points, u)
        crops = normalize_imagenet(
            proj.resample_window(img, r0, c0, win, models.crop))
        obj = torch.tensor([models.classes.index(cls_name)], device=dev)
        quat, trans = _pose_stage(models, crops, cloud, choose, obj, iters)
    return {"position": trans[0].cpu().numpy(),
            "rotation": quat[0].cpu().numpy(), "count": int(count[0])}


def build_models(num_classes_fg: int, model_points: np.ndarray, classes,
                 seg_vars=None, pose_vars=None, refine_vars=None,
                 num_points: int = 1000, crop: int = 320,
                 refine_iters: int = 2, dtype: torch.dtype = torch.bfloat16,
                 seed: int = 0, agg_topk: int = 1, cca_scale: int = 8,
                 cca_sweeps: int = 3, emb_stride: int = 8,
                 emb_resize_late: bool = False, cca_rule: str = "sum",
                 seg_out_stride: int = 1, device=None) -> PredictionModels:
    """The networks in inference mode on `device` (cuda by default). The
    `*_vars` are the JAX package's flax variable trees (numpy); a missing
    one is initialized from `seed` the way flax initializes it, on the CPU,
    so a seed gives the same weights on every device. `seg_out_stride` in
    {1, 2, 4, 8} runs the U-Net's decoder tail on that lattice (the same
    weights; see the module's docstring)."""
    if seg_out_stride not in (1, 2, 4, 8):
        raise ValueError(f"seg_out_stride must be 1, 2, 4 or 8: "
                         f"{seg_out_stride}")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    nets = [
        (UNet(num_classes_fg + 1, dtype=dtype, out_stride=seg_out_stride),
         seg_vars, weights.unet_state_dict),
        (PoseNet(num_classes_fg, dtype=dtype, emb_stride=emb_stride,
                 emb_resize_late=emb_resize_late), pose_vars,
         weights.posenet_state_dict),
        (PoseRefineNet(num_classes_fg, dtype=dtype), refine_vars,
         weights.refiner_state_dict),
    ]
    for net, variables, to_state in nets:
        if variables is None:
            init_like_flax(net, gen)
        else:
            net.load_state_dict(to_state(variables))
        net.requires_grad_(False).eval().to(dev)
    return PredictionModels(
        nets[0][0], nets[1][0], nets[2][0], tuple(classes),
        torch.as_tensor(np.asarray(model_points, np.float32), device=dev),
        dev, num_points, crop, refine_iters, agg_topk, cca_scale, cca_sweeps,
        emb_stride, emb_resize_late, cca_rule)


def dataset_has_symmetric(root: str, classes) -> bool:
    """True if any class's first acquisition meta carries symmetric=1."""
    data_root = io.data_dir(root)
    for cls in classes:
        obj_dir = os.path.join(data_root, cls)
        try:
            run_dir = os.path.join(obj_dir, sorted(os.listdir(obj_dir))[0])
            metas = sorted(f for f in os.listdir(run_dir)
                           if f.endswith(".meta.json"))
            meta = io.read_sample_meta(os.path.join(run_dir, metas[0]))
        except (OSError, IndexError):
            continue
        if bool(meta.get("symmetric", 0)):
            return True
    return False


def get_prediction_models(root: str, data_set_name: str,
                          dtype: torch.dtype = torch.bfloat16,
                          emb_stride: Optional[int] = None,
                          seg_out_stride: int = 1,
                          device=None) -> PredictionModels:
    """Classes, per-class model clouds (mm -> m, wrap-padded to one M) and
    the trained weights of a dataset. `emb_stride=None` picks 2 when any
    class is symmetric (those regress at coarser strides), else 8;
    `seg_out_stride` goes to `build_models`."""
    classes = io.read_lines(os.path.join(
        io.dataset_dir(root, "segmentation", data_set_name), "classes.txt"))
    if emb_stride is None:
        emb_stride = 2 if dataset_has_symmetric(root, classes) else 8
    clouds = [io.read_xyz(os.path.join(io.pc_dir(root), cls,
                                       f"{cls}.xyz")) / 1000.0
              for cls in classes]
    max_m = max(len(p) for p in clouds)
    model_points = np.zeros((len(classes), max_m, 3), np.float32)
    for i, pts in enumerate(clouds):
        # wrap-pad so padded rows are real surface points
        model_points[i] = pts[np.arange(max_m) % max(len(pts), 1)]
    pose_dir = os.path.join(root, "DenseFusion", "trained_models",
                            data_set_name)
    seg_vars = checkpoints.load_checkpoint(os.path.join(
        root, "segmentation", "trained_models", data_set_name,
        "Unet_resnet34.ckpt.npz"))["variables"]
    pose_vars = checkpoints.load_checkpoint(
        os.path.join(pose_dir, "pose_model.npz"))["variables"]
    refine_vars = checkpoints.load_checkpoint(
        os.path.join(pose_dir, "pose_refine_model.npz"))["variables"]
    return build_models(len(classes), model_points, classes,
                        seg_vars=seg_vars, pose_vars=pose_vars,
                        refine_vars=refine_vars, dtype=dtype,
                        emb_stride=emb_stride,
                        seg_out_stride=seg_out_stride, device=device)


def get_robot2object(prediction: Dict, controller, end2cam: np.ndarray
                     ) -> Dict:
    """Move a prediction's camera-frame poses into the robot frame, in
    place: the controller's end-effector pose (mm, rotation vector) and the
    hand-eye transform `end2cam` (mm). The transforms are built in f32 and
    multiplied in f64, in mm, as the JAX version does."""
    if not prediction["predictions"]:
        return prediction
    pose = controller.get_pose(return_mm=True)
    rv = torch.tensor([pose["a"], pose["b"], pose["c"]], dtype=torch.float32)
    robot2end = T.make_tf(T.rotvec_to_mat(rv), torch.tensor(
        [pose["x"], pose["y"], pose["z"]], dtype=torch.float32)).numpy()
    robot2cam = robot2end @ end2cam
    for p in prediction["predictions"].values():
        cam2obj = T.pose_to_tf(
            torch.as_tensor(np.asarray(p["rotation"], np.float32)),
            torch.as_tensor(np.asarray(p["position"], np.float32))
            * 1000.0).numpy()
        robot2obj = robot2cam @ cam2obj
        p["position"] = robot2obj[:3, 3] / 1000.0
        p["rotation"] = T.mat_to_quat(torch.as_tensor(
            robot2obj[:3, :3], dtype=torch.float32)).numpy()
    return prediction
