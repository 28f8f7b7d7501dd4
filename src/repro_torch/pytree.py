"""Nested dicts, lists and tuples of tensors: the trees of weights,
gradients and optimiser state that ``optim``, ``train`` and ``checkpoint``
walk, in the order and under the names the JAX package gives them.

* ``flatten`` lists the leaves depth first, a dict's items **in sorted key
  order** (as ``jax.tree`` flattens a dict), lists and tuples in order;
  ``None`` is an empty subtree, as in JAX, and anything that is not a
  dict, list, tuple or ``None`` is a leaf. ``unflatten`` rebuilds a tree
  of the same structure from new leaves.
* ``leaf_names`` names each leaf by its path as
  ``jax.tree_util.keystr`` writes it (``[1]['opt']['m'][0]``), with every
  character outside ``[A-Za-z0-9_.-]`` made ``_``
  (``_1___opt____m___0_``): the checkpoint store's file names, the same
  in both packages.

``torch.utils._pytree`` keeps a dict's insertion order, so its leaf order
and names would differ from the JAX package's; it is not used here.
"""
from __future__ import annotations

import re
from typing import Any, Callable, List, Optional, Tuple

_NAME_CHARS = re.compile(r"[^A-Za-z0-9_.-]")


class TreeDef:
    """The structure of a tree: ``kind`` is "leaf", "none", "dict", "list"
    or "tuple"; a dict's ``keys`` are sorted; ``children`` are the subtrees
    in that order."""

    __slots__ = ("kind", "keys", "children", "n_leaves")

    def __init__(self, kind: str, keys: tuple = (), children: tuple = ()):
        self.kind = kind
        self.keys = keys
        self.children = children
        self.n_leaves = 1 if kind == "leaf" else sum(c.n_leaves
                                                     for c in children)

    def __eq__(self, other) -> bool:
        return (isinstance(other, TreeDef) and self.kind == other.kind
                and self.keys == other.keys
                and self.children == other.children)

    def _body(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c._body()}"
                                   for k, c in zip(self.keys, self.children)) + "}"
        inner = ", ".join(c._body() for c in self.children)
        if self.kind == "list":
            return f"[{inner}]"
        return f"({inner},)" if len(self.children) == 1 else f"({inner})"

    def __repr__(self) -> str:
        """As ``str`` of a JAX ``PyTreeDef`` of the same structure."""
        return f"PyTreeDef({self._body()})"


def _node(tree, is_leaf: Optional[Callable[[Any], bool]]):
    """(kind, keys, children) of one node of ``tree``."""
    if is_leaf is not None and is_leaf(tree):
        return "leaf", (), ()
    if tree is None:
        return "none", (), ()
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return "dict", keys, tuple(tree[k] for k in keys)
    if isinstance(tree, list):
        return "list", (), tuple(tree)
    if isinstance(tree, tuple):
        return "tuple", (), tuple(tree)
    return "leaf", (), ()


def _walk(tree, path: str, is_leaf, out: list) -> TreeDef:
    kind, keys, children = _node(tree, is_leaf)
    if kind == "leaf":
        out.append((path, tree))
        return TreeDef("leaf")
    if kind == "none":
        return TreeDef("none")
    steps = [f"[{k!r}]" for k in keys] if kind == "dict" else \
        [f"[{i}]" for i in range(len(children))]
    return TreeDef(kind, keys, tuple(_walk(c, path + s, is_leaf, out)
                                     for c, s in zip(children, steps)))


def flatten_with_paths(tree, is_leaf=None) -> Tuple[List[Tuple[str, Any]],
                                                   TreeDef]:
    """``([(path, leaf), ...], treedef)``, each path as ``keystr`` writes it."""
    out: list = []
    treedef = _walk(tree, "", is_leaf, out)
    return out, treedef


def flatten(tree, is_leaf=None) -> Tuple[list, TreeDef]:
    """``(leaves, treedef)``; ``is_leaf(node)`` True stops the walk there."""
    pairs, treedef = flatten_with_paths(tree, is_leaf)
    return [leaf for _, leaf in pairs], treedef


def leaves(tree, is_leaf=None) -> list:
    return flatten(tree, is_leaf)[0]


def _build(td: TreeDef, it):
    if td.kind == "leaf":
        return next(it)
    if td.kind == "none":
        return None
    children = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.keys, children))
    return children if td.kind == "list" else tuple(children)


def unflatten(treedef: TreeDef, leaves_) -> Any:
    """The tree of ``treedef``'s structure holding ``leaves_`` in order.
    (Built by a module-level recursion: a nested function that calls
    itself would be a reference cycle holding the leaves until the garbage
    collector runs, a whole gradient tree of a DLRM step on the card.)"""
    leaves_ = list(leaves_)
    if len(leaves_) != treedef.n_leaves:
        raise ValueError(f"{treedef} holds {treedef.n_leaves} leaves, got "
                         f"{len(leaves_)}")
    return _build(treedef, iter(leaves_))


def tree_map(fn: Callable, tree, *rest, is_leaf=None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (of the same structure), into a tree of that
    structure."""
    flat, treedef = flatten(tree, is_leaf)
    others = []
    for r in rest:
        r_flat, r_def = flatten(r, is_leaf)
        if r_def != treedef:
            raise ValueError(f"tree structures differ: {treedef} and {r_def}")
        others.append(r_flat)
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])


def leaf_names(tree, is_leaf=None) -> List[str]:
    """Each leaf's path, as ``jax.tree_util.keystr`` writes it, with every
    character outside ``[A-Za-z0-9_.-]`` made ``_``: the checkpoint
    store's file names, the JAX package's (``checkpoint/store.py``)."""
    return [_NAME_CHARS.sub("_", path)
            for path, _ in flatten_with_paths(tree, is_leaf)[0]]
