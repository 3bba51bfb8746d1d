"""Small shared helpers: a pytree flatten that matches ``jax.tree.flatten``
order, and the device rule of the port's entry points."""
from __future__ import annotations

import torch

# A treedef is a hashable nested tuple: ("*",) for a leaf, ("dict", keys,
# children) for a dict (keys SORTED, as jax sorts them), ("tuple" |
# "list", children) for sequences.  None is an empty node, as in jax.
_LEAF = ("*",)


def tree_flatten(tree, is_leaf=None):
    """(leaves, treedef) with leaves in ``jax.tree.flatten`` order."""
    leaves: list = []

    def walk(x):
        if is_leaf is not None and is_leaf(x):
            leaves.append(x)
            return _LEAF
        if isinstance(x, dict):
            keys = tuple(sorted(x))
            return ("dict", keys, tuple(walk(x[k]) for k in keys))
        if isinstance(x, (tuple, list)):
            return (type(x).__name__, tuple(walk(v) for v in x))
        if x is None:
            return ("none",)
        leaves.append(x)
        return _LEAF

    treedef = walk(tree)
    return leaves, treedef


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "*":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        vals = [build(c) for c in d[1]]
        return tuple(vals) if kind == "tuple" else vals

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_leaves(tree, is_leaf=None):
    return tree_flatten(tree, is_leaf=is_leaf)[0]


def tree_map(fn, tree, *rest, is_leaf=None):
    leaves, treedef = tree_flatten(tree, is_leaf=is_leaf)
    others = [tree_flatten(r, is_leaf=is_leaf)[0] for r in rest]
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others, strict=True)])


def resolve_device(device=None) -> torch.device:
    """The port's device rule: an explicit device is used as given;
    ``None`` means the card, and raises when CUDA is absent — the port
    never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' explicitly to "
                           "run the port's plain PyTorch path on the CPU")
    return torch.device("cuda")
