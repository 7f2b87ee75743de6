"""Trees of tensors flattened as JAX flattens its pytrees.

The training substrate (the optimizer, checkpoints, the train step) walks
parameter and optimizer trees leaf by leaf.  For a checkpoint written by
one package to load into the other, both must visit the same leaves in
the same order under the same names.  JAX's rules, kept here:

* a ``dict`` is visited in sorted-key order, each child named ``[key!r]``
  (``['blocks']['attn']['wq']``);
* a ``NamedTuple`` in field order, each child named ``.field``
  (``.m``, ``.step``);
* a ``tuple`` or ``list`` in index order, each child named ``[i]``;
* ``None`` is an empty subtree (no leaf);
* a :class:`~repro_torch.models.common.ParamTree` is the nested dict it
  holds (:meth:`ParamTree.tree` yields children first, in insertion
  order; the sort above gives JAX's order);
* anything else is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable

from .models.common import ParamTree

__all__ = ["leaves", "leaves_with_names", "unflatten_like", "map",
           "prefix_leaves", "plain"]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(name, child) pairs of an inner node in JAX's order; None for a
    leaf."""
    if isinstance(node, ParamTree):
        node = node.tree()
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    if node is None:
        return []
    return None


def leaves_with_names(tree) -> tuple[list[str], list[Any]]:
    """The leaves of ``tree`` and their JAX ``keystr`` names, in JAX's
    order."""
    names, out = [], []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            names.append(path)
            out.append(node)
            return
        for name, child in kids:
            walk(child, path + name)

    walk(tree, "")
    return names, out


def leaves(tree) -> list[Any]:
    """The leaves of ``tree`` in JAX's order."""
    return leaves_with_names(tree)[1]


def unflatten_like(like, new_leaves):
    """A tree of ``like``'s structure holding ``new_leaves`` (in JAX's
    order).  Dicts keep ``like``'s key order; a ``ParamTree`` comes back as
    a new ``ParamTree`` over the new tensors."""
    it = iter(new_leaves)
    end = object()

    def take():
        leaf = next(it, end)
        if leaf is end:
            raise ValueError("fewer leaves than the tree holds")
        return leaf

    def build(node):
        if isinstance(node, ParamTree):
            return ParamTree(build(node.tree()))
        if isinstance(node, dict):
            done = {k: build(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (tuple, list)):
            return type(node)(build(c) for c in node)
        if node is None:
            return None
        return take()

    out = build(like)
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree holds")
    return out


def map(fn: Callable, tree, *rest):  # noqa: A001 (jax.tree.map's name)
    """``fn`` over the leaves of ``tree`` and of the like trees ``rest``,
    as a tree of ``tree``'s structure."""
    others = [leaves(t) for t in rest]
    return unflatten_like(tree, [fn(*xs) for xs in zip(leaves(tree),
                                                         *others,
                                                         strict=True)])


def prefix_leaves(like, other) -> list[Any]:
    """The nodes of ``other`` at the positions of ``like``'s leaves, in
    JAX's order: ``like``'s structure is a prefix of ``other``'s (JAX's
    rule for the extra trees of ``tree.map``), and what ``other`` holds
    there is taken whole (a spec tuple, a ``NamedSharding``)."""
    out = []

    def walk(node, there, path):
        kids = _children(node)
        if kids is None:
            out.append(there)
            return
        theirs = _children(there) or []
        if [n for n, _ in kids] != [n for n, _ in theirs]:
            raise ValueError(f"at {path or 'the root'}: {[n for n, _ in kids]}"
                             f" against {[n for n, _ in theirs]}")
        for (name, child), (_, t) in zip(kids, theirs):
            walk(child, t, path + name)

    walk(like, other, "")
    return out


def plain(tree):
    """``tree`` with every :class:`ParamTree` replaced by the nested dict
    it holds (the same leaves, names and order): a structure that can
    hold leaves of any type, as a tree of shardings does."""
    if isinstance(tree, ParamTree):
        tree = tree.tree()
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(plain(getattr(tree, f)) for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(plain(c) for c in tree)
    return tree
