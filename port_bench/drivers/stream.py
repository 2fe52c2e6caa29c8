"""The pipelined loop: `pipeline/predict.py::serve_stream` at the traffic's
batch and calls in flight, closed loop over the pool's frames.

A frame's latency runs from the moment `serve_stream` takes it from the
source to the moment its result is yielded; the source stops at the end of
the window, the frames in flight are drained, and the rate is every frame
over the whole time up to the last result."""
from __future__ import annotations

import itertools
import time
from typing import Dict

from harness.serving import ServingDriver


class Driver(ServingDriver):
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        from autoposeestimation_tpu_torch.pipeline import predict

        super().__init__(cfg, traffic, seed, device)
        self.serve_stream = predict.serve_stream
        self._run(count=traffic["warmup"])

    def _run(self, count: int = None, deadline: float = None,
             on_result=None):
        """Serve frames from the pool until `count` frames have been taken
        or `deadline` has passed; returns (taken, hand times)."""
        handed = []
        first = self.next
        pool = self.pool

        def source():
            while True:
                if count is not None and len(handed) >= count:
                    return
                if deadline is not None and time.perf_counter() >= deadline:
                    return
                i = (first + len(handed)) % pool.count
                handed.append(time.perf_counter())
                yield pool.images[i], pool.depths[i], pool.meta

        draws = itertools.cycle(pool.draws[(first + j) % pool.count]
                                for j in range(pool.count))
        for j, result in enumerate(self.serve_stream(
                source(), self.models, in_flight=self.traffic["in_flight"],
                uniforms=draws, batch=self.traffic["batch"])):
            if on_result is not None:
                on_result(first + j, handed[j], result)
        self.next = first + len(handed)
        return len(handed)

    def window(self, seconds: float) -> Dict:
        latencies = []
        last = [0.0]

        def on_result(index, handed, result):
            last[0] = time.perf_counter()
            latencies.append(last[0] - handed)
            self.sample.offer(index, result)

        t0 = time.perf_counter()
        taken = self._run(deadline=t0 + seconds, on_result=on_result)
        return {"units": len(latencies), "seconds": last[0] - t0,
                "latencies": latencies, "attempted": taken,
                "failed": taken - len(latencies)}

    def traced_units(self) -> int:
        return self._run(count=self.traffic["trace_units"])
