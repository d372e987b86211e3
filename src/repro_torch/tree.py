"""The port's trees: nests of dicts, lists, tuples and ``None`` over
tensor, array or scalar leaves (the reference's pytrees; parameter and
optimizer-state trees hold the layer axis unstacked into lists).

:func:`tree_flatten` lists the leaves in JAX's order (dict keys sorted,
``None`` a node with no leaf) with a :class:`TreeDef` whose ``str()`` is
JAX's ``PyTreeDef`` string (:mod:`repro_torch.checkpoint.ckpt` writes it
into its manifests). :func:`tree_map` calls ``fn`` on the leaves in that
order, so ``tree_map(lambda _: next(it), tree)`` rebuilds a tree from a
list of leaves made by :func:`tree_leaves`. :func:`stacked_paths` names
each leaf's counterpart in the reference's layer-stacked tree.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

__all__ = ["LAYER_AXIS", "TreeDef", "stacked_paths", "tree_flatten",
           "tree_leaves", "tree_map"]

LAYER_AXIS = "*"


class TreeDef:
    """The structure of a flattened tree: ``str()`` is JAX's ``PyTreeDef``
    string for the same tree, :meth:`unflatten` rebuilds it."""

    def __init__(self, node):
        self._node = node       # "*" | None | ("dict", keys, kids) | (type, kids)

    def __str__(self) -> str:
        return f"PyTreeDef({_render(self._node)})"

    def unflatten(self, leaves: Sequence[Any]):
        it = iter(leaves)
        out = _build(self._node, it)
        if next(it, _END) is not _END:
            raise ValueError("more leaves than the tree has")
        return out


_END = object()


def _node_of(tree, leaves: list):
    if tree is None:
        return None
    t = type(tree)
    if t is dict:
        keys = sorted(tree)                      # JAX's order
        return ("dict", tuple(keys),
                tuple(_node_of(tree[k], leaves) for k in keys))
    if t is list or t is tuple:
        return (t, tuple(_node_of(v, leaves) for v in tree))
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic,
                         int, float, complex)):
        leaves.append(tree)
        return "*"
    raise TypeError(f"trees are nests of dicts, lists, tuples and None "
                    f"over tensor, array or scalar leaves; got "
                    f"{t.__name__}")


def _render(node) -> str:
    if node == "*":
        return "*"
    if node is None:
        return "None"
    if node[0] == "dict":
        _, keys, kids = node
        return "{" + ", ".join(f"{k!r}: {_render(c)}"
                               for k, c in zip(keys, kids)) + "}"
    t, kids = node
    body = ", ".join(_render(c) for c in kids)
    if t is list:
        return f"[{body}]"
    return f"({body},)" if len(kids) == 1 else f"({body})"


def _build(node, it):
    if node == "*":
        leaf = next(it, _END)
        if leaf is _END:
            raise ValueError("fewer leaves than the tree has")
        return leaf
    if node is None:
        return None
    if node[0] == "dict":
        _, keys, kids = node
        return {k: _build(c, it) for k, c in zip(keys, kids)}
    t, kids = node
    return t(_build(c, it) for c in kids)


def tree_flatten(tree: Any) -> tuple[list, TreeDef]:
    """(the leaves of ``tree`` in JAX's order, its :class:`TreeDef`)."""
    leaves: list = []
    treedef = TreeDef(_node_of(tree, leaves))
    return leaves, treedef


def tree_leaves(tree) -> list:
    """Every leaf of ``tree``, in JAX's order."""
    return tree_flatten(tree)[0]


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each leaf, in :func:`tree_leaves`
    order."""
    leaves, treedef = tree_flatten(tree)
    return treedef.unflatten([fn(x) for x in leaves])


def stacked_paths(tree, path: tuple = ()) -> list[tuple]:
    """Per leaf of a tree of dicts and lists, in :func:`tree_leaves`
    order: its path of dict keys, with :data:`LAYER_AXIS` for each list
    level. The leaves that share a path are the per-layer slices of one
    leaf of the reference's tree, which stacks them on
    ``path.count(LAYER_AXIS)`` leading axes."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in stacked_paths(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for v in tree
                for x in stacked_paths(v, path + (LAYER_AXIS,))]
    return [path]
