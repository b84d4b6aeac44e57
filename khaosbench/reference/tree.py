"""Parameter and state trees as nested dicts, flattened to (slash/name,
leaf) pairs in sorted key order: the order the benchmark draws weights
in and compares leaves by."""
from __future__ import annotations


def flatten(tree: dict, prefix: str = "") -> list:
    """(slash/name, leaf) pairs with dict keys in sorted order."""
    out = []
    for k in sorted(tree):
        name = f"{prefix}{k}"
        v = tree[k]
        if isinstance(v, dict):
            out.extend(flatten(v, name + "/"))
        else:
            out.append((name, v))
    return out


def unflatten(pairs: list) -> dict:
    root: dict = {}
    for name, leaf in pairs:
        node = root
        *path, last = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf
    return root
