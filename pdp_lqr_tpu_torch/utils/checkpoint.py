"""Checkpoint / resume for solver state (PyTorch port of
``pdp_lqr_tpu/utils/checkpoint.py``).

The reference's closest concept is factorization caching across ADMM
iterations (the *_without_factorization API, lqr_solver.hpp:65-70);
persistent checkpointing does not exist there.  Here every piece of
solver state (``ADMMState``, any backend's factor cache) is a frozen
dataclass of tensors, possibly nested in tuples, lists or dicts, so a
checkpoint is a flat ``.npz``: the tensors in order, their dtypes, and a
structure string built from the class and field names.  It warm-starts an
MPC loop across process restarts or moves a batch between hosts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np
import torch


def _flatten(tree, leaves: List[torch.Tensor]) -> str:
    """Append the tensors of ``tree`` to ``leaves`` (fields in order) and
    return its structure string (a tensor is ``*``)."""
    if tree is None:
        return "None"
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return "*"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        inner = ",".join(f"{f.name}={_flatten(getattr(tree, f.name), leaves)}"
                         for f in dataclasses.fields(tree))
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, (tuple, list)):
        inner = ",".join(_flatten(x, leaves) for x in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    if isinstance(tree, dict):
        inner = ",".join(f"{k!r}:{_flatten(tree[k], leaves)}"
                         for k in sorted(tree))
        return "{" + inner + "}"
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _unflatten(like, leaves):
    """``like`` with its tensors replaced, in order, from the iterator
    ``leaves``."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _unflatten(getattr(like, f.name), leaves)
            for f in dataclasses.fields(like)})
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return {k: _unflatten(like[k], leaves) for k in sorted(like)}


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:      # numpy has no bfloat16: keep the bits
        x = x.view(torch.int16)
    return x.numpy()


def save_pytree(path, tree: Any) -> None:
    """Serialize a tree of tensors (dataclasses, tuples, lists, dicts) to
    ``path`` (.npz)."""
    leaves: List[torch.Tensor] = []
    structure = _flatten(tree, leaves)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    np.savez(path, treedef=np.frombuffer(structure.encode(), dtype=np.uint8),
             dtypes=np.array([str(x.dtype) for x in leaves], dtype=str),
             **arrays)


def load_pytree(path, like: Any) -> Any:
    """Restore a tree saved by ``save_pytree``.

    ``like`` provides the structure (e.g. a freshly-initialized state of
    the same shape) and the device of each tensor; values and dtypes come
    from the file.  A structure or shape that differs raises ValueError.
    """
    leaves: List[torch.Tensor] = []
    structure = _flatten(like, leaves)
    with np.load(path) as data:
        stored = bytes(data["treedef"]).decode()
        if stored != structure:
            raise ValueError(
                "checkpoint tree structure does not match `like`:\n"
                f"  stored:   {stored}\n  expected: {structure}")
        dtypes = [str(d) for d in data["dtypes"]]
        loaded = []
        for i, ref in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            if tuple(ref.shape) != arr.shape:
                raise ValueError(f"checkpoint leaf shape {arr.shape} != "
                                 f"expected {tuple(ref.shape)}")
            x = torch.from_numpy(arr.copy())
            if dtypes[i] == "torch.bfloat16":
                x = x.view(torch.bfloat16)
            loaded.append(x.to(ref.device))
    return _unflatten(like, iter(loaded))
