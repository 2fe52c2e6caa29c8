"""The JAX package's checkpoint format (`train/checkpoints.py` there), read
and written: `<path>.npz` holds the flax variable tree flattened to
`v/`-prefixed, `/`-joined names (`o/` for optimizer state),
`<path>.npz.meta.json` the metadata. Trees are nested dicts of numpy
arrays; `weights.py` turns them into state_dicts and back."""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np


def _flatten(tree: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, node in tree.items():
        if isinstance(node, dict):
            flat.update(_flatten(node, f"{prefix}{key}/"))
        else:
            flat[prefix + key] = np.asarray(node)
    return flat


def save_checkpoint(path: str, variables: Dict[str, Any],
                    meta: Optional[Dict] = None) -> None:
    """Writes `<path>` (.npz appended if absent) and `<path>.meta.json`, as
    the JAX package's `save_checkpoint` does, so its `load_checkpoint`
    reads what the port trains."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(variables, "v/"))
    with open(path + ".meta.json", "w") as f:
        json.dump(meta or {}, f)


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
