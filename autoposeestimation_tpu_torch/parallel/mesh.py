"""The ('data', 'model') device mesh over `torch.distributed` (port of
`autoposeestimation_tpu/parallel/mesh.py`).

The JAX package is one controller: a `jax.sharding.Mesh` splits the batch
over the visible devices and XLA inserts the collectives. Here every device
is a process of its own (one rank each, started by `torchrun` or by
`parallel/dryrun.py`), and the collectives are written out:

  * data parallelism: every rank iterates the same global batches and keeps
    its own contiguous block of rows (`shard_batch_data`); a leading
    dimension that does not divide the 'data' axis is replicated. The
    gradients are averaged over 'data' before the optimizer's clip, so
    every rank takes the same step, and BatchNorm's batch statistics are
    the global batch's (`models/common.py::BatchNorm2d`);
  * tensor parallelism: the wide DenseFusion pointwise layers (a `Linear`
    with 512 or more output features) keep their slice of the output
    features on each 'model' rank (`shard_params_tp`, which swaps in
    `models/common.py::ColumnParallelLinear`);
  * the two compose: rank r sits at data index r // model_parallel and
    model index r % model_parallel.

The group is NCCL on the card and gloo on the CPU. Only rank 0 writes
files; the others wait at a barrier.
"""
from __future__ import annotations

import atexit
import datetime
import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models.common import ColumnParallelLinear, Linear

AXES = ("data", "model")


def default_backend(device=None) -> str:
    """NCCL for a CUDA device (the card by default when one is there),
    gloo for the CPU."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(rank: int, world_size: int, store_path: str,
               backend: Optional[str] = None,
               timeout: Optional[datetime.timedelta] = None) -> None:
    """Join a process group of `world_size` ranks that meet in a
    `FileStore` at `store_path`. For NCCL the rank's card (`cuda:rank`, or
    `LOCAL_RANK`) is made current first, so that `utils/device.py::
    resolve_device(None)` lands on it. A failed init raises."""
    backend = backend or default_backend()
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, store=dist.FileStore(store_path,
                                                          world_size),
                            rank=rank, world_size=world_size, **kw)


def _torchrun_world() -> int:
    if "MASTER_ADDR" not in os.environ:
        return 1
    return int(os.environ.get("WORLD_SIZE", "1"))


def _start_group(device) -> None:
    """torchrun's group from its environment, else a one-rank group on a
    FileStore in a temporary directory."""
    backend = default_backend(device)
    if _torchrun_world() > 1:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(backend, init_method="env://")
        return
    tmp = tempfile.mkdtemp(prefix="ape_group_")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    init_group(0, 1, os.path.join(tmp, "store"), backend)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, model) grid of the world group."""

    axes: Tuple[str, str]
    shape: Dict[str, int]        # ranks along each axis
    coords: Dict[str, int]       # this rank's index along each axis
    groups: Dict[str, Any]       # the subgroup of this rank along each axis
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return self.shape[self.axes[0]] * self.shape[self.axes[1]]


# model_parallel -> (data group, model group), for the world group in
# "world" (a group started after another was destroyed starts afresh)
_GROUPS: Dict[Any, Any] = {}


def _subgroups(n: int, model_parallel: int) -> Tuple[Any, Any]:
    """(data group, model group) of this rank, made once per world group
    (every rank creates every subgroup, in one order). An axis that spans
    the world is the world group, so a one-rank mesh still runs its
    collectives; an axis of one rank in a larger world has no group, and
    nothing is exchanged along it."""
    if _GROUPS.get("world") is not dist.group.WORLD:
        _GROUPS.clear()
        _GROUPS["world"] = dist.group.WORLD
    key = model_parallel
    if key not in _GROUPS:
        nd, mp = n // model_parallel, model_parallel

        def split(axis_size, ranks_of):
            if axis_size == n:
                return dist.group.WORLD
            if axis_size == 1:
                return None
            return dist.new_subgroups_by_enumeration(ranks_of)[0]

        data = split(nd, [[d * mp + m for d in range(nd)]
                          for m in range(mp)])
        model = split(mp, [[d * mp + m for m in range(mp)]
                           for d in range(nd)])
        _GROUPS[key] = (data, model)
    return _GROUPS[key]


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = AXES,
              model_parallel: int = 1) -> Mesh:
    """The mesh over the ranks of the process group that is up: 'model'
    gets `model_parallel` ranks, 'data' the rest. Raises ValueError when
    `model_parallel` does not divide the ranks, or `n_devices` is not the
    group's size."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model="
                         f"{model_parallel}")
    if len(axes) != 2:
        raise ValueError(f"a mesh has two axes (data, model): {axes}")
    if not dist.is_initialized():
        raise RuntimeError("no process group is up: start one with "
                           "auto_mesh('on'), torchrun or init_group")
    if n != dist.get_world_size():
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, not {n}")
    rank = dist.get_rank()
    data, model = _subgroups(n, model_parallel)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(tuple(axes), {axes[0]: n // model_parallel,
                              axes[1]: model_parallel},
                {axes[0]: rank // model_parallel,
                 axes[1]: rank % model_parallel},
                {axes[0]: data, axes[1]: model}, rank, device)


def auto_mesh(mode: str = "auto", model_parallel: int = 1,
              n_devices: Optional[int] = None, device=None
              ) -> Optional[Mesh]:
    """The trainers' data-parallel knob (`SegConfig` / `DFConfig.
    data_parallel`). 'off' returns None. 'auto' builds the mesh when a
    process group of more than one rank is up, or when torchrun's
    environment gives more than one (the group is then started from it),
    else returns None. 'on' always builds it, starting a one-rank group
    when none is up. `device` picks the backend of a group started here
    (NCCL for CUDA, gloo for the CPU)."""
    if mode == "off":
        return None
    if mode not in ("auto", "on"):
        raise ValueError(f"data_parallel must be 'auto', 'on' or 'off', "
                         f"not {mode!r}")
    if not dist.is_initialized():
        if mode == "auto" and _torchrun_world() <= 1:
            return None
        _start_group(device)
    if dist.get_world_size() <= 1 and mode != "on":
        return None
    return make_mesh(n_devices, model_parallel=model_parallel)


# --- placements --------------------------------------------------------------

class Placement(NamedTuple):
    """Where an array lives on the mesh: `axis` None holds all of it on
    every rank; 'data' holds this rank's block of its leading rows."""

    axis: Optional[str]


def replicated(mesh: Mesh) -> Placement:
    return Placement(None)


def batch_sharding(mesh: Mesh) -> Placement:
    """Leading-axis (batch) sharding over 'data'."""
    return Placement(mesh.axes[0])


def row_block(mesh: Mesh, n: int) -> Optional[Tuple[int, int]]:
    """This rank's rows [lo, hi) of a leading dimension `n`, or None when
    `n` does not divide over 'data' (the array is then replicated)."""
    nd = mesh.shape[mesh.axes[0]]
    if n <= 0 or n % nd:
        return None
    per = n // nd
    lo = mesh.coords[mesh.axes[0]] * per
    return lo, lo + per


def place(mesh: Mesh, x, placement: Placement):
    """`x` as `placement` holds it on this rank; raises ValueError when a
    sharded leading dimension does not divide."""
    if placement.axis is None:
        return x
    block = row_block(mesh, x.shape[0])
    if block is None:
        raise ValueError(f"leading dimension {x.shape[0]} does not divide "
                         f"over {mesh.shape[placement.axis]} "
                         f"'{placement.axis}' ranks")
    return x[block[0]:block[1]]


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _ndim(x) -> int:
    return len(getattr(x, "shape", ()))


def shard_batch(mesh: Mesh, batch):
    """Every array of a batch (dicts, lists, tuples of arrays or tensors)
    with its leading axis over 'data'; scalars replicated."""
    return _tree_map(lambda x: place(
        mesh, x, batch_sharding(mesh) if _ndim(x) >= 1 else replicated(mesh)),
        batch)


def shard_batch_data(mesh: Mesh, batch):
    """The training loops' placement: arrays whose leading dimension
    divides 'data' keep this rank's rows, everything else (scalars, a
    ragged last batch) is replicated, so every batch is right."""
    def put(x):
        if _ndim(x) >= 1 and row_block(mesh, x.shape[0]) is not None:
            return place(mesh, x, batch_sharding(mesh))
        return x

    return _tree_map(put, batch)


# --- parameters --------------------------------------------------------------

def replicate_params(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Broadcast every parameter and buffer from data index 0 of this
    rank's 'data' group (rank 0 for replicated tensors when the model axis
    is 1), so that all ranks start alike."""
    data = mesh.groups[mesh.axes[0]]
    if data is not None:
        src = dist.get_global_rank(data, 0)
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=data)
    return module


def _tp_spec_for(path: str, leaf) -> Optional[str]:
    """The tensor-parallel rule: a 2-D `Linear` weight (out, in) with 512
    or more output features shards its output rows over 'model' (its bias
    with it); everything else is replicated (None). This covers the
    DenseFusion fusion stacks (512/1024) and head layers (640), which hold
    most of the pointwise FLOPs."""
    shape = tuple(leaf.shape)
    if path.endswith("weight") and len(shape) == 2 and shape[0] >= 512:
        return "model"
    return None


def shard_params_tp(mesh: Mesh, module: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None
                    ) -> nn.Module:
    """Swap every `Linear` of `module` that `_tp_spec_for` shards for a
    `ColumnParallelLinear` over this rank's 'model' group, in place. The
    parameters stay the same objects (their data becomes this rank's
    rows), so an optimizer built on them keeps working; `optimizer`'s state
    for them, if any, is sliced alike. Returns `module`."""
    axis = mesh.axes[1]
    size = mesh.shape[axis]
    if size == 1:
        return module
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            if (isinstance(child, Linear)
                    and not isinstance(child, ColumnParallelLinear)
                    and _tp_spec_for(f"{name}.weight", child.weight)):
                setattr(parent, name, ColumnParallelLinear.from_linear(
                    child, mesh.groups[axis], size, mesh.coords[axis],
                    optimizer))
    return module


# --- collectives -------------------------------------------------------------

def _average(grads: List[torch.Tensor], group, size: int) -> None:
    """Average `grads` over `group` (`size` ranks) in one bucket."""
    if group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat.div_(size)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def all_reduce_grads(mesh: Mesh, params) -> None:
    """Average the gradients of `params` over 'data'. Every rank then holds
    the global batch's gradient: its own rows of a column-sharded weight,
    and of a replicated parameter the same tensor on every rank (those are
    averaged over the whole mesh, 'model' too, so that rounding differences
    between the 'model' ranks, such as the order of a kernel's atomic adds,
    never let the replicas drift apart)."""
    live = [p for p in params if p.grad is not None]
    data = mesh.axes[0]
    _average([p.grad for p in live if hasattr(p, "tp_shard")],
             mesh.groups[data], mesh.shape[data])
    _average([p.grad for p in live if not hasattr(p, "tp_shard")],
             dist.group.WORLD, mesh.size)


def data_mean(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """The mean of a per-rank tensor over 'data' (a global-batch mean of
    per-block means)."""
    if mesh is None or mesh.groups[mesh.axes[0]] is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=mesh.groups[mesh.axes[0]])
    return out / mesh.shape[mesh.axes[0]]


def data_sum(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """The sum of a per-rank tensor over 'data'."""
    if mesh is None or mesh.groups[mesh.axes[0]] is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=mesh.groups[mesh.axes[0]])
    return out


def all_gather_rows(mesh: Optional[Mesh], t: torch.Tensor,
                    axis: str = "data") -> torch.Tensor:
    """Every rank's `t` along `axis`, concatenated on the leading dimension
    in index order (equal shapes on every rank)."""
    if mesh is None or mesh.groups[axis] is None:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, t.contiguous(), group=mesh.groups[axis])
    return torch.cat(parts)


def all_gather_objects(mesh: Optional[Mesh], obj, axis: str = "data"
                       ) -> List[Any]:
    """Every rank's picklable `obj` along `axis`, in index order."""
    if mesh is None or mesh.groups[axis] is None:
        return [obj]
    out: List[Any] = [None] * mesh.shape[axis]
    dist.all_gather_object(out, obj, group=mesh.groups[axis])
    return out


def broadcast_object(mesh: Optional[Mesh], obj):
    """Rank 0's picklable `obj` on every rank."""
    if mesh is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def is_writer(mesh: Optional[Mesh]) -> bool:
    """True on the rank that writes files (rank 0; always without a
    mesh)."""
    return mesh is None or mesh.rank == 0


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        dist.barrier()
