"""Trees of tensors as the reference's pytrees see them: nested dicts (keys in
sorted order), NamedTuples (fields in order), lists and tuples; anything else
is a leaf.  The training state (parameters, optimizer states, gradients)
is such a tree, and the checkpoint names each leaf by its path as
``jax.tree_util.keystr`` writes it (``['opt'].mu['embed']``), so either
package restores the other's checkpoints."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Optional


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_items(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) of every leaf in the reference's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}[{k!r}]")
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from tree_items(v, f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``
    (trees of the same structure), the structure kept.  ``is_leaf`` marks
    further nodes as leaves (a NamedTuple that ``fn`` takes whole)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *vs, is_leaf=is_leaf) for vs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs, is_leaf=is_leaf) for vs in zip(tree, *rest))
    return fn(tree, *rest)
