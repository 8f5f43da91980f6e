"""Trees of tensors: nested dicts, lists and tuples, with ``None`` holding
no leaf and anything else a leaf (a tensor, a numpy array, a scalar).

The port's stand-in for ``jax.tree_util`` where the reference walks
pytrees (checkpoints, the optimizer): leaves come in JAX's order (dict
keys sorted, list and tuple entries by index), and key paths follow
``jax.tree_util.tree_flatten_with_path``.
"""

from __future__ import annotations


def flatten_with_paths(tree, path=()) -> list:
    """``[(key path tuple, leaf)]`` in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_paths(tree[k], path + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += flatten_with_paths(sub, path + (str(i),))
        return out
    return [(path, tree)]


def leaves(tree) -> list:
    """The leaves of ``tree``, in the reference's order."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(tree_like, leaves_iter):
    """``tree_like``'s structure with its leaves taken in order from the
    iterator ``leaves_iter``."""
    if tree_like is None:
        return None
    if isinstance(tree_like, dict):
        out = {k: unflatten(tree_like[k], leaves_iter)
               for k in sorted(tree_like)}
        return {k: out[k] for k in tree_like}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(unflatten(sub, leaves_iter)
                               for sub in tree_like)
    return next(leaves_iter)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest`` (the reference's ``flatten_up_to``: where ``tree`` has a leaf,
    ``rest`` may hold a whole subtree, such as an int8 moment's
    ``{q, scale}``); returns a tree shaped like ``tree``. Calls ``fn`` in
    the order of :func:`leaves`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, sub, *(r[i] for r in rest))
                          for i, sub in enumerate(tree))
    return fn(tree, *rest)


def value_and_grad(fn, params):
    """``fn(params)`` (a scalar tensor) and its gradient in every leaf of
    ``params``, a tree shaped like ``params``: the reference's
    ``jax.value_and_grad``, by autograd. A leaf ``fn`` does not reach gets
    zeros, as JAX gives; ``params`` is left as it is."""
    import torch

    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    flat = leaves(live)
    with torch.enable_grad():
        value = fn(live)
        grads = torch.autograd.grad(value, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return value.detach(), unflatten(params, iter(grads))
