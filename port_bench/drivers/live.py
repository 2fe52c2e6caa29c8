"""The live loop: `pipeline/predict.py::full_prediction`, one client, one
frame at a time, closed loop over the pool's frames, masks materialised.

A frame's latency runs from the call to its result on the host; the rate
is every frame over the whole window."""
from __future__ import annotations

import time
from typing import Dict

from harness.serving import ServingDriver


class Driver(ServingDriver):
    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        from autoposeestimation_tpu_torch.pipeline import predict

        super().__init__(cfg, traffic, seed, device)
        self.predict = predict.full_prediction
        for _ in range(traffic["warmup"]):
            self._serve()

    def _serve(self):
        i = self.next % self.pool.count
        self.next += 1
        return self.predict(self.pool.images[i], self.pool.depths[i],
                            self.pool.meta, self.models,
                            uniforms=self.pool.draws[i])

    def window(self, seconds: float) -> Dict:
        latencies = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        end = t0
        while end < deadline:
            index = self.next
            start = time.perf_counter()
            result = self._serve()
            end = time.perf_counter()
            latencies.append(end - start)
            self.sample.offer(index, result)
        return {"units": len(latencies), "seconds": end - t0,
                "latencies": latencies, "attempted": len(latencies),
                "failed": 0}

    def traced_units(self) -> int:
        n = self.traffic["trace_units"]
        for _ in range(n):
            self._serve()
        return n
