"""Checkpoint and resume of long-running optimization state.

Counterpart of ``mvrecon_tpu/runtime/checkpoint.py``'s npz backend: a tree
of arrays (dicts, lists, tuples and named tuples of numpy arrays, tensors
or scalars) goes to one ``.npz`` file with its structure, written to a
temporary name and renamed into place, so a reader never sees half a file.
Loading checks the saved structure against the caller's template and
returns numpy arrays. The orbax backend of the JAX package is JAX-only and
is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _flatten(tree: Any) -> tuple[list, str]:
    """(leaves, structure string) of ``tree``; dict keys are taken sorted."""
    if isinstance(tree, dict):
        leaves, parts = [], []
        for k in sorted(tree):
            sub, spec = _flatten(tree[k])
            leaves += sub
            parts.append(f"{k!r}: {spec}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        leaves, parts = [], []
        for v in tree:
            sub, spec = _flatten(v)
            leaves += sub
            parts.append(spec)
        return leaves, f"{type(tree).__name__}(" + ", ".join(parts) + ")"
    if tree is None:
        return [], "None"
    return [tree], "*"


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure filled from the iterator ``leaves``."""
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        vals = [_unflatten(v, leaves) for v in like]
        if hasattr(like, "_fields"):
            return type(like)(*vals)
        return type(like)(vals)
    if like is None:
        return None
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any, step: int | None = None) -> None:
    """Write the tree of arrays to ``path`` (.npz) with its structure and
    ``step``; atomic rename."""
    leaves, spec = _flatten(tree)
    payload = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    meta = {"structure": spec, "n_leaves": len(leaves), "step": step}
    tmp = path + ".tmp.npz"
    np.savez(tmp, __meta__=json.dumps(meta), **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, like: Any) -> tuple[Any, int | None]:
    """(tree, step) saved by :func:`save_checkpoint`, as numpy arrays in the
    structure of ``like`` (whose leaf values are ignored). A file whose
    structure differs from ``like``'s raises ``ValueError``."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        leaves_like, spec = _flatten(like)
        if meta["n_leaves"] != len(leaves_like):
            raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, expected "
                             f"{len(leaves_like)}")
        if meta["structure"] != spec:
            raise ValueError("checkpoint tree structure does not match `like`:\n"
                             f"  saved:    {meta['structure']}\n  expected: {spec}")
        leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    return _unflatten(like, iter(leaves)), meta.get("step")


def checkpoint_backend(name: str):
    """(save, load, exists) of the backend ``name``: "npz" here; "orbax"
    is the JAX package's and raises ``NotImplementedError``."""
    if name == "npz":
        return save_checkpoint, load_checkpoint, os.path.exists
    if name == "orbax":
        raise NotImplementedError("the orbax checkpoint backend is JAX-only; the port "
                                  "writes npz checkpoints")
    raise ValueError(f"unknown checkpoint backend {name!r}")
