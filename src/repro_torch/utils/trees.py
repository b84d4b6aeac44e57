"""Pytree utilities over nested dicts/lists/tuples of tensors and arrays.

The port keeps its state as plain nested dicts carrying the JAX package's
leaf names.  ``tree_flatten_with_names`` visits dict keys in SORTED order,
exactly like ``jax.tree_util`` (``torch.utils._pytree`` keeps insertion
order instead), so slash-joined names, ``FlatLayout`` offsets, shard plans
and manifests come out identical in both frameworks.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class TreeDef:
    """Structure of a pytree: ``kind`` is "dict", "list", "tuple", "none"
    or "leaf"; ``keys`` the sorted dict keys; ``children`` the sub-defs."""

    kind: str
    keys: tuple = ()
    children: tuple = ()


def tree_structure(tree: Any) -> TreeDef:
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys, tuple(tree_structure(tree[k])
                                           for k in keys))
    if isinstance(tree, (list, tuple)):
        return TreeDef("list" if isinstance(tree, list) else "tuple", (),
                       tuple(tree_structure(x) for x in tree))
    if tree is None:
        return TreeDef("none")
    return TreeDef("leaf")


def _flatten(tree: Any, path: tuple, out: list) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], path + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            _flatten(x, path + (str(i),), out)
    elif tree is not None:
        out.append(("/".join(path), tree))


def tree_flatten_with_names(tree: Any) -> list[tuple[str, Any]]:
    """Flatten into (slash/path/name, leaf) pairs in jax.tree_util order."""
    out: list = []
    _flatten(tree, (), out)
    return out


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_flatten_with_names(tree)]


def tree_unflatten(treedef: TreeDef, leaves: list) -> Any:
    it = iter(leaves)

    def build(td: TreeDef) -> Any:
        if td.kind == "leaf":
            return next(it)
        if td.kind == "none":
            return None
        kids = [build(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.keys, kids))
        return kids if td.kind == "list" else tuple(kids)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    return tree_unflatten(tree_structure(tree),
                          [fn(leaf) for leaf in tree_leaves(tree)])


# ---------------------------------------------------------------------------
# dtype / device helpers shared by the checkpoint plane
# ---------------------------------------------------------------------------

_TORCH_TO_NP = {
    torch.float32: np.float32, torch.float64: np.float64,
    torch.float16: np.float16, torch.int8: np.int8, torch.uint8: np.uint8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.bool: np.bool_,
}


def np_dtype(x: Any) -> np.dtype:
    """numpy dtype of a tensor, array or ``.dtype``-carrying spec."""
    dt = x.dtype if hasattr(x, "dtype") else x
    if isinstance(dt, torch.dtype):
        if dt not in _TORCH_TO_NP:
            raise TypeError(f"no numpy dtype for {dt}")
        return np.dtype(_TORCH_TO_NP[dt])
    return np.dtype(dt)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy that never aliases ``t`` (a CPU tensor is copied too:
    the caller may keep the array while the tensor is mutated)."""
    return t.detach().to("cpu", copy=True).numpy()


def to_tensor(x: Any, device: Any) -> torch.Tensor:
    """numpy array (possibly read-only, e.g. ``np.frombuffer``) -> a fresh
    tensor on ``device`` that shares no memory with ``x``."""
    arr = np.asarray(x)
    if not arr.flags.c_contiguous:   # (ascontiguousarray would make 0-d 1-d)
        arr = np.ascontiguousarray(arr)
    with warnings.catch_warnings():
        # from_numpy warns on read-only arrays; the copy below makes the
        # tensor writable and independent of the buffer
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    return t.to(device, copy=True)


def tree_bytes(tree: Any) -> int:
    """Total bytes of a tree's tensor or array leaves (8 for any other
    leaf, as the reference counts)."""
    total = 0
    for leaf in tree_leaves(tree):
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            total += int(np.prod(tuple(leaf.shape))) * np_dtype(leaf).itemsize
        else:
            total += 8
    return total


def resolve_device(device: Optional[Any]) -> torch.device:
    """The port's device rule: the CUDA device unless the caller asks for
    another one.  With no CUDA device and no explicit choice this raises
    rather than carrying on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)
