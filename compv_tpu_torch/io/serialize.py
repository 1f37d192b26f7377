"""Array and tree serialization, checkpoints (mirror of
``compv_tpu/io/serialize.py``).

Mat <-> JSON as the reference's CompVJSON (base/include/compv/base/
compv_json.h:22-27); trees of arrays to ``.npz``; checkpoints of SLAM state
with ``torch.save`` / ``torch.load(weights_only=True)`` of plain tensors,
where the JAX package uses orbax.

A tree is a dict (flattened in sorted key order, as ``jax.tree_util``
does), list or tuple of arrays or tensors, nested; ``save_npz`` stores its
leaves as ``leaf_0``, ``leaf_1``, ... in that order, so a file either
package wrote from the same structure loads in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

__all__ = ["array_to_json", "array_from_json", "save_mat_json",
           "load_mat_json", "save_checkpoint", "load_checkpoint",
           "save_npz", "load_npz"]


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def array_to_json(arr) -> dict:
    """Mat -> JSON object with dtype / shape / data (CompVJSON::write)."""
    a = _numpy(arr)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": a.ravel().tolist()}


def array_from_json(obj: dict) -> np.ndarray:
    return np.asarray(obj["data"], dtype=obj["dtype"]).reshape(obj["shape"])


def save_mat_json(path: str, **arrays) -> None:
    with open(path, "w") as f:
        json.dump({k: array_to_json(v) for k, v in arrays.items()}, f)


def load_mat_json(path: str) -> dict:
    with open(path) as f:
        return {k: array_from_json(v) for k, v in json.load(f).items()}


def _flatten(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _flatten(t)]
    return [tree]


def _unflatten(like: Any, leaves) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(t, leaves) for t in like)
    return next(leaves)


def save_npz(path: str, tree: Any) -> None:
    """The leaves of a tree of arrays, in flattening order, to an .npz."""
    np.savez(path, **{f"leaf_{i}": _numpy(leaf)
                      for i, leaf in enumerate(_flatten(tree))})


def load_npz(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (numpy leaves)."""
    with np.load(path) as data:
        n = len(_flatten(like))
        return _unflatten(like, iter([data[f"leaf_{i}"] for i in range(n)]))


def save_checkpoint(directory: str, step: int, tree: dict) -> str:
    """``tree`` (a dict of arrays or tensors) to ``directory/step_<step>.pt``
    as CPU tensors. Returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}.pt")
    torch.save({k: torch.as_tensor(_numpy(v)) for k, v in tree.items()},
               path)
    return path


def load_checkpoint(path: str, like: Any = None) -> Any:
    """A checkpoint of ``save_checkpoint`` as a dict of CPU tensors (plain
    tensors only: ``weights_only=True``); an ``.npz`` path is read with
    ``load_npz`` into the structure of ``like``."""
    if path.endswith(".npz"):
        return load_npz(path, like)
    return torch.load(path, map_location="cpu", weights_only=True)
