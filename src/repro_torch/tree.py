"""Nested dicts and tuples of tensors (the port's pytrees).

Flattened in the reference's order, JAX's: dict keys sorted, tuples (a
``MomentState``) in field order, ``None`` dropped.  A checkpoint's
``arr_<i>.npy`` numbering and the gradients of a train step follow it.
"""
from __future__ import annotations

from typing import Any, Iterable


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in the reference's flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [] if tree is None else [tree]


def rebuild(tree: Any, values: Iterable) -> Any:
    """``tree``'s structure with its leaves replaced by ``values``, taken
    in the order of :func:`leaves`."""
    return _walk(tree, iter(values))


def _walk(t: Any, it) -> Any:
    # module-level, not a closure: a recursive closure is a reference
    # cycle, which would keep ``values`` (a gradient tree, say) alive
    # until the cyclic collector runs
    if isinstance(t, dict):
        new = {k: _walk(t[k], it) for k in sorted(t)}
        return {k: new[k] for k in t}
    if isinstance(t, tuple):
        items = [_walk(x, it) for x in t]
        return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
    if isinstance(t, list):
        return [_walk(x, it) for x in t]
    return None if t is None else next(it)
