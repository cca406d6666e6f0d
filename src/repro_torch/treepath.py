"""Key paths and the nested-dict pytrees the port keeps its params in.

``path_str`` renders a key path exactly as the JAX package does
(``"conv1/w"``), so segment names, checkpoint keys and telemetry agree
between the two packages.

``tree_flatten_with_path`` visits dict keys in SORTED order — the order
``jax.tree_util.tree_flatten_with_path`` uses. The packed superbuffer's
row order follows the leaf order, so any other order (e.g. Python's
insertion order) would give a different buffer than the reference.
Only nested ``dict``s with string keys are trees here; every other
value is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable

Pytree = Any
TreeDef = tuple  # tuple of key paths, one per leaf, in flatten order


def path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _walk(node, path: tuple, out: list) -> None:
    # module level, not a closure: a nested function that calls itself is
    # a reference cycle, and it would keep every leaf it appended to
    # ``out`` alive until the cyclic garbage collector ran
    if isinstance(node, dict):
        for k in sorted(node):
            if not isinstance(k, str):
                raise TypeError(f"tree keys must be str, got {k!r}")
            _walk(node[k], path + (k,), out)
    else:
        out.append((path, node))


def tree_flatten_with_path(tree: Pytree) -> tuple[list, TreeDef]:
    """-> ([(path, leaf), ...], treedef) with dict keys in sorted order."""
    out: list = []
    _walk(tree, (), out)
    return out, tuple(p for p, _ in out)


def tree_leaves(tree: Pytree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)[0]]


def flatten_up_to(treedef: TreeDef, tree: Pytree) -> list:
    """Leaves of ``tree`` at the paths of ``treedef`` (a same-structure
    tree, e.g. a stacked marker or a gradient tree)."""
    got = tree_flatten_with_path(tree)[1]
    if got != treedef:
        raise ValueError(f"tree structure mismatch: {got} vs {treedef}")
    return tree_leaves(tree)


def tree_unflatten(treedef: TreeDef, leaves) -> Pytree:
    leaves = list(leaves)
    if len(leaves) != len(treedef):
        raise ValueError(f"{len(leaves)} leaves for {len(treedef)} paths")
    if treedef == ((),):
        return leaves[0]            # the tree is a single leaf
    root: dict = {}
    for path, leaf in zip(treedef, leaves):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    leaves, treedef = tree_flatten_with_path(tree)
    others = [flatten_up_to(treedef, r) for r in rest]
    return tree_unflatten(treedef, [fn(leaf, *(o[i] for o in others))
                                    for i, (_, leaf) in enumerate(leaves)])
