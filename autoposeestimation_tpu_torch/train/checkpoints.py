"""The JAX package's checkpoint format (`train/checkpoints.py` there), read
and written: `<path>.npz` holds the flax variable tree flattened to
`v/`-prefixed, `/`-joined names (`o/` for optimizer state),
`<path>.npz.meta.json` the metadata. Trees are nested dicts of numpy
arrays; `weights.py` turns them into state_dicts and back.

The optimizer state is written in the layout of the JAX trainer's optax
`chain(clip_by_global_norm, inject_hyperparams(adam))` state, so that a
snapshot written by either package resumes in the other:
`adam_tree` / `load_adam_tree` map `torch.optim.Adam`'s `step`, `exp_avg`
and `exp_avg_sq` onto optax's `count`, `mu` and `nu` (with the layouts of
`weights.py`'s plans) and the learning rate onto `hyperparams`."""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import weights
from ..models.common import full_tensor


def _flatten(tree: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, node in tree.items():
        if isinstance(node, dict):
            flat.update(_flatten(node, f"{prefix}{key}/"))
        else:
            flat[prefix + key] = np.asarray(node)
    return flat


def save_checkpoint(path: str, variables: Dict[str, Any],
                    meta: Optional[Dict] = None,
                    opt_state: Optional[Dict[str, Any]] = None) -> None:
    """Writes `<path>` (.npz appended if absent) and `<path>.meta.json`, as
    the JAX package's `save_checkpoint` does, so its `load_checkpoint`
    reads what the port trains. `opt_state` (nested dicts, see `adam_tree`)
    goes under `o/`."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = _flatten(variables, "v/")
    if opt_state is not None:
        arrays.update(_flatten(opt_state, "o/"))
    np.savez(path, **arrays)
    with open(path + ".meta.json", "w") as f:
        json.dump(meta or {}, f)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """{'variables': nested numpy tree, 'opt_state': nested numpy tree or
    None, 'meta': dict}; `.npz` is appended to `path` if absent."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    trees: Dict[str, Dict[str, Any]] = {"v": {}, "o": {}}
    with np.load(path, allow_pickle=False) as f:
        for key in f.files:
            top, _, rest = key.partition("/")
            if top not in trees:
                continue
            parts = rest.split("/")
            node = trees[top]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = f[key]
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return {"variables": trees["v"], "opt_state": trees["o"] or None,
            "meta": meta}


_ADAM_HYPER = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}


def _param_plan(plan: List[weights.Entry]) -> List[weights.Entry]:
    """The plan's parameter entries, paths relative to `params`."""
    return [(path[1:], key, kind) for path, key, kind in plan
            if path[0] == "params"]


def adam_tree(adam: torch.optim.Adam, model: torch.nn.Module,
              plan: List[weights.Entry], clip: float) -> Dict[str, Any]:
    """The optax state tree of the JAX trainer's optimizer for `model`'s
    parameters under `adam`: `{"1": inject}` behind a clip (the clip's
    state holds nothing), `inject` alone without one; inject =
    {".count", ".hyperparams", ".inner_state": {"0": {".count", ".mu",
    ".nu"}}}, mu and nu in the flax layout (a tensor-parallel shard's
    gathered back to its full rows, a collective over its group)."""
    pplan = _param_plan(plan)
    named = dict(model.named_parameters())
    mu, nu, steps = {}, {}, set()
    for _, key, _ in pplan:
        st = adam.state.get(named[key], {})
        p = named[key]
        mu[key] = full_tensor(p, st.get("exp_avg", torch.zeros_like(p)))
        nu[key] = full_tensor(p, st.get("exp_avg_sq", torch.zeros_like(p)))
        steps.add(int(st["step"]) if "step" in st else 0)
    if len(steps) != 1:
        raise ValueError(f"parameters at different Adam steps: {steps}")
    count = np.int32(steps.pop())
    hyper = {k: np.float32(v) for k, v in _ADAM_HYPER.items()}
    hyper["learning_rate"] = np.float32(adam.param_groups[0]["lr"])
    inject = {".count": count, ".hyperparams": hyper,
              ".inner_state": {"0": {
                  ".count": count,
                  ".mu": weights.to_variables(mu, pplan),
                  ".nu": weights.to_variables(nu, pplan)}}}
    return {"1": inject} if clip and clip > 0 else inject


def load_adam_tree(adam: torch.optim.Adam, model: torch.nn.Module,
                   plan: List[weights.Entry], tree: Dict[str, Any]) -> None:
    """Set `adam`'s per-parameter state from an optax state tree as
    `adam_tree` writes it (either package's snapshot). The learning rate
    is left to the caller (`set_lr`)."""
    inject = tree["1"] if "1" in tree else tree
    inner = inject[".inner_state"]["0"]
    pplan = _param_plan(plan)
    mu = weights.to_state_dict(inner[".mu"], pplan)
    nu = weights.to_state_dict(inner[".nu"], pplan)
    count = int(np.asarray(inner[".count"]))
    named = dict(model.named_parameters())
    for _, key, _ in pplan:
        p = named[key]
        adam.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[key].to(p.device, p.dtype).reshape(p.shape),
            "exp_avg_sq": nu[key].to(p.device, p.dtype).reshape(p.shape)}
