"""The port's pytree walk (its counterpart of ``jax.tree_util``), shared by
the optimizers, the checkpoints and the train step.

A tree is nested dicts, NamedTuples (``OptState``), tuples and lists with
tensors (or arrays, or numbers) at the leaves; ``None`` is an empty
subtree.  The order is jax's: a dict's keys sorted, a sequence's items in
order, so a sum over leaves adds in the reference's order and a leaf's
path names the same leaf in both packages.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


# The walks are module functions, not nested ones: a nested recursive
# function is a reference cycle, and one holding the leaves would keep a
# model's tensors alive until the cycle collector runs.

def _walk(node, path: Path, out: list) -> None:
    if node is None:
        return
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], path + (k,), out)
    elif _is_namedtuple(node):
        for f in node._fields:
            _walk(getattr(node, f), path + (f,), out)
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            _walk(v, path + (i,), out)
    else:
        out.append((path, node))


def flatten_with_path(tree) -> List[Tuple[Path, Any]]:
    """``(path, leaf)`` for every leaf in order; a path holds dict keys,
    NamedTuple field names and sequence indices."""
    out: List[Tuple[Path, Any]] = []
    _walk(tree, (), out)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def _build(node, it):
    if node is None:
        return None
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}       # the caller's key order
    if _is_namedtuple(node):
        return type(node)(*(_build(getattr(node, f), it)
                            for f in node._fields))
    if isinstance(node, (tuple, list)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def unflatten_like(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and of trees of its structure)."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees differ in structure")
    return unflatten_like(tree, [fn(*xs) for xs in zip(*flat)])
