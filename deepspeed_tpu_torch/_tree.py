"""Minimal pytree helpers over the containers the port's param trees use:
dicts (keys visited in sorted order, as ``jax.tree`` does), lists, tuples
and NamedTuples.  Every other object is a leaf; ``None`` is an empty
subtree, as in JAX.  The recursions are module-level functions, not
closures that call themselves: such a closure is a reference cycle, which
would keep every leaf it saw (gigabytes of gradients and optimizer state
on the card) alive until the cyclic garbage collector happens to run."""

from __future__ import annotations

from typing import Any, Callable, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(x, out: List[Any]) -> None:
    if x is None:
        return
    if isinstance(x, dict):
        for k in sorted(x):
            _walk(x[k], out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _walk(v, out)
    else:
        out.append(x)


def tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    _walk(tree, out)
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure), keeping the containers."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _rebuild(x, it):
    if x is None:
        return None
    if isinstance(x, dict):
        built = {k: _rebuild(x[k], it) for k in sorted(x)}
        return {k: built[k] for k in x}
    if _is_namedtuple(x):
        return type(x)(*(_rebuild(v, it) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_rebuild(v, it) for v in x)
    return next(it)


def tree_unflatten_like(tree: Any, leaves: List[Any]) -> Any:
    """A tree of ``tree``'s structure whose leaves are ``leaves``, in
    :func:`tree_leaves` order."""
    return _rebuild(tree, iter(leaves))


def _walk_paths(x, prefix: str, out: List[Any]) -> None:
    if x is None:
        return
    if isinstance(x, dict):
        for k in sorted(x):
            _walk_paths(x[k], f"{prefix}{k}/", out)
    elif _is_namedtuple(x):
        for name, v in zip(x._fields, x):
            _walk_paths(v, f"{prefix}{name}/", out)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _walk_paths(v, f"{prefix}{i}/", out)
    else:
        out.append((prefix[:-1], x))


def tree_leaves_with_path(tree: Any) -> List[Any]:
    """``(path, leaf)`` pairs in :func:`tree_leaves` order; a path joins
    the dict keys, NamedTuple field names and sequence indices on the way
    with ``/`` (``"blocks/wq"``), as the JAX package names checkpoint
    leaves."""
    out: List[Any] = []
    _walk_paths(tree, "", out)
    return out
