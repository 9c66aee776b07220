"""Nested containers of tensors, walked in the reference's leaf order.

A tree is a dict (its keys in sorted order, as ``jax.tree`` walks a
dict), a tuple or list (in order), a NamedTuple (field by field), or a
leaf. ``keystr`` paths are ``jax.tree_util.keystr``'s: ``['layers']['attn']
['wq']['w']`` for dict keys, ``[0]`` for sequence items, ``.m`` for a
NamedTuple's fields, so a checkpoint keyed by them reads the same on both
sides.
"""

from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key string, child) of one node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def flatten_with_path(tree, prefix: str = "") -> list:
    """[(keystr, leaf)] in the reference's order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(flatten_with_path(child, prefix + key))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, values):
    """A tree of ``like``'s structure holding ``values`` (in leaf order)."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, same
    structure), keeping ``tree``'s structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
