"""Trees of the port's training state: nested dicts, lists and NamedTuples
(``optimizer.QMoment``) of tensors.

The JAX package walks its state with ``jax.tree_util``; the port walks
its own with these few functions, in the same order JAX uses (dict keys
sorted, lists and NamedTuple fields in order), and names a leaf by its
path as ``jax.tree_util.keystr`` writes one (``['blocks'][0]['attn']
['wq']``, ``.q`` for a NamedTuple field).
"""
from __future__ import annotations

from typing import Any, Callable

from ..core.integrity import STACKED


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree: Any, path: str = "") -> list:
    """[(path, leaf)] in JAX's order; a leaf is anything but a dict, a
    list or a NamedTuple (None included)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten(tree[k], f"{path}[{k!r}]")]
    if _is_namedtuple(tree):
        return [item for f in tree._fields
                for item in flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like: Any, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in
    :func:`flatten`'s order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}      # the caller's key order
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of ``rest`` (trees of the
    same structure), in a tree of ``tree``'s structure."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])


def stack_counts(params) -> dict:
    """{key: layers} of the top-level lists that the JAX package stacks on
    a leading axis (``core.integrity.STACKED``: ``blocks``, an
    encoder–decoder's ``encoder`` and ``decoder``)."""
    return {k: len(params[k]) for k in STACKED
            if isinstance(params, dict) and isinstance(params.get(k), list)}


def stacked_shape(path: str, leaf, counts: dict) -> tuple:
    """The shape this leaf of a parameter tree has in the JAX package,
    which stacks the layers of each list of ``counts``
    (:func:`stack_counts`) on a leading axis (an MoE model's
    ``first_blocks`` stay a list there too).  ``leaf``: a tensor, or the
    whole leaf's shape where a mesh rank holds a shard of it
    (``sharding.partition.whole_shape``)."""
    shape = tuple(leaf if isinstance(leaf, tuple) else leaf.shape)
    for k, n in counts.items():
        if path.startswith(f"['{k}']"):
            return (n,) + shape
    return shape
