"""Batching and device prefetch (port of `autoposeestimation_tpu/data/
loader.py`).

`collate` and `Loader` are the JAX package's: numpy batches assembled by a
thread pool, samples that come back None (degenerate masks) skipped, `img`
channels last as `train/densefusion.py::to_device` takes it.
`device_prefetch` copies batches to the card ahead of use from pinned
memory on a side stream."""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch


def collate(samples) -> Dict[str, np.ndarray]:
    """Stack a list of sample dicts into a batch dict."""
    out = {}
    for key in samples[0]:
        out[key] = np.stack([s[key] for s in samples])
    return out


class Loader:
    """Shuffling batch iterator over an indexable dataset. Samples returning
    None (degenerate masks) are skipped and replaced."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.num_workers = num_workers

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        pool = ThreadPoolExecutor(self.num_workers) if self.num_workers else None
        try:
            batch = []
            fetch = (pool.map if pool else map)
            for sample in fetch(self.dataset.__getitem__, order.tolist()):
                if sample is None:
                    continue
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield collate(batch)
                    batch = []
            if batch and not self.drop_last:
                yield collate(batch)
        finally:
            if pool:
                pool.shutdown(wait=False, cancel_futures=True)


def device_prefetch(iterator, device, size: int = 2
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of tensors on `device`, `size` ahead of the consumer.

    On a CUDA device a producer thread pins each batch's arrays and copies
    them on a side stream; the consumer's stream waits on the copy's event,
    and the tensors are recorded to the consumer's stream so that their
    memory outlives the copy. Elsewhere the arrays are wrapped as they are.
    Dtypes and layout are kept (`to_device` converts)."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: torch.as_tensor(np.asarray(v)).to(device)
                   for k, v in batch.items()}
        return

    side = torch.cuda.Stream(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()

    def producer():
        try:
            for batch in iterator:
                if stop.is_set():
                    break
                with torch.cuda.stream(side):
                    out = {k: torch.from_numpy(np.ascontiguousarray(v))
                           .pin_memory().to(device, non_blocking=True)
                           for k, v in batch.items()}
                    done = torch.cuda.Event()
                    done.record(side)
                q.put((out, done))
        except Exception as exc:        # raised in the consumer
            q.put(exc)
        finally:
            q.put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, Exception):
                raise item
            out, done = item
            stream = torch.cuda.current_stream(device)
            stream.wait_event(done)
            for t in out.values():
                t.record_stream(stream)
            yield out
    finally:
        stop.set()
        while thread.is_alive():        # unblock a producer waiting on put
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
