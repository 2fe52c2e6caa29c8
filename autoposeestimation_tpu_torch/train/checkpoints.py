"""Reader for the JAX package's checkpoints (`train/checkpoints.py` there):
`<path>.npz` holds the flax variable tree flattened to `v/`-prefixed,
`/`-joined names (`o/` for optimizer state), `<path>.npz.meta.json` the
metadata. Returns numpy trees; `weights.py` turns them into state_dicts."""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np


def load_checkpoint(path: str) -> Dict[str, Any]:
    """{'variables': nested numpy tree, 'meta': dict}; `.npz` is appended
    to `path` if absent. The optimizer state is left unread."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    variables: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as f:
        for key in f.files:
            if not key.startswith("v/"):
                continue
            parts = key[2:].split("/")
            node = variables
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = f[key]
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return {"variables": variables, "meta": meta}
