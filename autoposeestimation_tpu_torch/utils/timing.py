"""Per-epoch JSON curve logs (copy of `JsonCurveLog` of
`autoposeestimation_tpu/utils/timing.py`): the file the live dashboards
re-read whole on every update."""
from __future__ import annotations

import json
import os
from typing import Dict, Optional


class JsonCurveLog:
    """Epoch-curve log rewritten wholesale each update."""

    def __init__(self, path: Optional[str],
                 config: Optional[Dict] = None) -> None:
        self.path = path
        self.data: Dict = dict(config or {})
        self.data.setdefault("curves", {})

    def append(self, **values) -> None:
        for key, val in values.items():
            self.data["curves"].setdefault(key, []).append(
                float(val) if hasattr(val, "__float__") else val
            )
        self.flush()

    def flush(self) -> None:
        if self.path is None:    # kept in memory (a rank that does not write)
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self.data, f)
