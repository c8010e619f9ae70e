"""Trees of tensors: the nested dicts the port's parameters are
(``models/model.py``), and NamedTuples of such trees (``AdamWState``,
``EFState``), walked in the JAX package's pytree order: a dict's keys
sorted, a NamedTuple's fields in declaration order. Anything else is a
leaf. The checkpoint names its files by this order
(:func:`flatten_with_path`), so the port and the JAX package read each
other's checkpoints.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Tuple[list, Any]:
    """(the (path entry, child) pairs of a node, a function that rebuilds
    the node from its children) or (None, None) for a leaf. A dict key's
    entry is the key; a NamedTuple field's is ``.field``, as JAX prints a
    ``GetAttrKey``."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ([(str(k), tree[k]) for k in keys],
                lambda vals: dict(zip(keys, vals)))
    if is_namedtuple(tree):
        return ([(f".{f}", getattr(tree, f)) for f in tree._fields],
                lambda vals: type(tree)(*vals))
    return None, None


def flatten_with_path(tree) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path, leaf)] in pytree order; a path is its entries from the
    root."""
    kids, _ = _children(tree)
    if kids is None:
        return [((), tree)]
    return [((entry,) + path, leaf) for entry, child in kids
            for path, leaf in flatten_with_path(child)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and, leaf for leaf, of ``rest``
    (trees of the same structure); returns a tree of that structure."""
    kids, build = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r)[0] for r in rest]
    for o in others:
        if o is None or [e for e, _ in o] != [e for e, _ in kids]:
            raise ValueError("tree_map: the trees differ in structure")
    return build([tree_map(fn, child, *[o[i][1] for o in others])
                  for i, (_e, child) in enumerate(kids)])


def describe(tree) -> str:
    """The tree's structure, leaves as ``*`` (the checkpoint manifest's
    ``treedef``)."""
    kids, _ = _children(tree)
    if kids is None:
        return "*"
    inner = ", ".join(f"{e!r}: {describe(c)}" if isinstance(tree, dict)
                      else f"{e[1:]}={describe(c)}" for e, c in kids)
    if isinstance(tree, dict):
        return "{" + inner + "}"
    return f"{type(tree).__name__}({inner})"
