"""The served frame graph replayed as a CUDA graph (`torch.cuda.CUDAGraph`).

Eager PyTorch queues each of a frame's ~2,000 kernels from Python; on the
card the host's launches, not the kernels, set a live frame's pace.
`load(fn, models, sources)` copies a call's inputs in and returns the call
that runs `fn(models, *inputs)` (`predict._predict_frame` or
`_predict_batch`, whose shapes are static for given input shapes):

  * On a CUDA device, through one captured graph a signature: `fn`, the
    models' networks and model points (by identity) and settings, and each
    source's shape and dtype. The first call of a signature runs `fn`
    eagerly on a side stream (cuDNN's algorithm choice, the allocator's
    pools), then captures it; its graph.* spans are recorded then and not
    on a replay, which runs no Python of the graph. Every call copies its
    sources (tensors on the host or on any device; pinned host memory
    makes the copy asynchronous) into the graph's static inputs in stream
    order and replays it in the span 'graph.replay', counting one
    'graph_replays'; a capture counts one 'graph_captures'. Copies,
    capture and replay run on the models' device, whichever is current.
  * Elsewhere, and where the graph reads the device mid-way (`cca_sweeps`
    0 sweeps the CCA until it converges), eagerly on the sources moved to
    the device, as `fn` always ran.

A replay overwrites the static outputs that the previous call returned:
read them, or queue their copies on the device's current stream, before
the next call of the same signature. One caller at a time: the static
buffers are shared. The graph reads the networks' parameters where they
lie, so weights loaded in place (`load_state_dict`) are seen by the next
replay; parameters rebound to new tensors (`.to()` to another device or
dtype) need new models from `build_models`. A graph goes when its U-Net
does."""
from __future__ import annotations

import functools
import weakref
from typing import Callable, Dict, Sequence

import torch
from torch import nn

from ..utils.timing import count, span

WARMUP = 3     # eager runs on a side stream before the capture

# U-Net -> {signature: _Graph}
_GRAPHS: "weakref.WeakKeyDictionary[nn.Module, Dict]" = (
    weakref.WeakKeyDictionary())


def _by_identity(v) -> bool:
    return isinstance(v, (nn.Module, torch.Tensor))


class _Graph:
    """One signature's static inputs, graph and outputs."""

    def __init__(self, fn, models, sources: Sequence[torch.Tensor]):
        self.fn = fn
        self.refs = [weakref.ref(v) for v in models if _by_identity(v)]
        self.inputs = [torch.empty(s.shape, dtype=s.dtype,
                                   device=models.device) for s in sources]
        self.graph = None
        self.outputs: Dict[str, torch.Tensor] = {}

    def alive(self) -> bool:
        """The networks and model points it reads still exist (so their
        ids in its signature are theirs)."""
        return all(r() is not None for r in self.refs)

    def load(self, sources: Sequence[torch.Tensor]) -> None:
        for dst, src in zip(self.inputs, sources):
            dst.copy_(src, non_blocking=True)

    def run(self, models) -> Dict[str, torch.Tensor]:
        with torch.cuda.device(models.device):
            if self.graph is None:
                self._capture(models)
            with span("graph.replay"):
                self.graph.replay()
                count("graph_replays")
        return dict(self.outputs)

    def _capture(self, models) -> None:
        # captured on a stream of the models' device: torch.cuda.graph's
        # default stream lies on the card that was current at its first use
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self.fn(models, *self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            self.outputs = self.fn(models, *self.inputs)
        self.graph = graph
        count("graph_captures")


def load(fn, models, sources: Sequence[torch.Tensor]
         ) -> Callable[[], Dict[str, torch.Tensor]]:
    """`sources` (tensors) in `fn`'s argument order after `models` -> the
    call that runs `fn` on them and returns its outputs (see the module's
    docstring)."""
    dev = models.device
    if dev.type != "cuda" or not models.cca_sweeps:
        return functools.partial(
            fn, models, *(s.to(dev, non_blocking=True) for s in sources))
    key = ((fn,) + tuple(id(v) if _by_identity(v) else v for v in models)
           + tuple((tuple(s.shape), s.dtype) for s in sources))
    graphs = _GRAPHS.setdefault(models.seg_model, {})
    graph = graphs.get(key)
    with torch.cuda.device(dev):
        if graph is None or not graph.alive():
            graph = graphs[key] = _Graph(fn, models, sources)
        graph.load(sources)
    return functools.partial(graph.run, models)
