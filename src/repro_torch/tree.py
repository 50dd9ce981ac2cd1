"""Parameter trees: nested dicts, lists, tuples and NamedTuples of tensors.

The port's stand-in for ``jax.tree_util`` and ``jax.value_and_grad``, with
JAX's leaf order (dict keys sorted, sequences and NamedTuple fields in
order; ``None`` holds no leaf) and its key-path strings
(``['params']['embed']``, ``['opt'].mu``), so a checkpoint's leaves and
manifest read the same in either package.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> List[Tuple[str, Any]]:
    """(key-path piece, child) pairs in JAX's order, or [] for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return []


def _is_leaf(node) -> bool:
    return node is not None and not isinstance(node, (dict, list, tuple))


def tree_flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(key-path string, leaf)] in JAX's flatten order."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(tree_flatten_with_path(child, prefix + key))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped as ``like`` whose leaves are ``leaves`` in order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if _is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        kids = [build(c) for _, c in _children(node)]
        if _is_namedtuple(node):
            return type(node)(*kids)
        return type(node)(kids)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    others = [tree_leaves(r) for r in rest]
    leaves = tree_leaves(tree)
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("trees differ in their number of leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)])


def treedef_str(tree) -> str:
    """The structure in the form of JAX's ``str(treedef)``."""
    def show(node):
        if node is None:
            return "None"
        if _is_leaf(node):
            return "*"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {show(node[k])}"
                                   for k in sorted(node)) + "}"
        kids = ", ".join(show(c) for _, c in _children(node))
        if _is_namedtuple(node):
            return (f"CustomNode(namedtuple[{type(node).__name__}], "
                    f"[{kids}])")
        if isinstance(node, list):
            return f"[{kids}]"
        return f"({kids}{',' if len(node) == 1 else ''})"
    return f"PyTreeDef({show(tree)})"


def value_and_grad(fn: Callable, params, *args):
    """(fn(params, *args), d fn / d params) for a scalar ``fn``: the
    gradients come as a tree shaped as ``params``, in each leaf's dtype."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        value = fn(tree_unflatten(params, live), *args)
        grads = torch.autograd.grad(value, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return value.detach(), tree_unflatten(params, grads)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bf16 as ``ml_dtypes.bfloat16``, the type
    JAX gives its bf16 arrays."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def numpy_to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A copy of a numpy array (bf16 as JAX gives it) on ``device``."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)
