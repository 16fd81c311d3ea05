"""Nested tuples, lists and dicts of leaves (the subset of JAX's pytrees the
port's trees use): flattened in JAX's leaf order, dicts by sorted key and
``None`` an empty subtree, so that a tree flattens to the same leaves in
both packages."""

from __future__ import annotations


def flatten(tree) -> tuple[list, tuple]:
    """The leaves of ``tree`` and its structure, a hashable tuple."""
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for x in tree:
            sub, d = flatten(x)
            leaves.extend(sub)
            defs.append(d)
        kind = (type(tree).__qualname__ if hasattr(tree, "_fields")
                else type(tree).__name__)
        return leaves, (kind, tuple(defs))
    if isinstance(tree, dict):
        leaves, defs = [], []
        keys = sorted(tree)
        for k in keys:
            sub, d = flatten(tree[k])
            leaves.extend(sub)
            defs.append(d)
        return leaves, ("dict", tuple(keys), tuple(defs))
    if tree is None:
        return [], ("none",)
    return [tree], "*"


def unflatten(treedef, leaves, like=None):
    """The inverse of :func:`flatten`. Lists, tuples and dicts come back
    as such; with ``like`` (a tree of that structure) a namedtuple or
    another tuple type comes back as ``like``'s."""
    it = iter(leaves)

    def build(d, ref):
        if d == "*":
            return next(it)
        if d[0] == "none":
            return None
        if d[0] == "dict":
            return {k: build(sd, None if ref is None else ref[k])
                    for k, sd in zip(d[1], d[2])}
        items = [build(sd, None if ref is None else ref[i])
                 for i, sd in enumerate(d[1])]
        if isinstance(ref, tuple) and type(ref) is not tuple:
            return (type(ref)(*items) if hasattr(ref, "_fields")
                    else type(ref)(items))
        return items if d[0] == "list" else tuple(items)

    return build(treedef, like)
