"""Nested dicts / lists of tensors (the port's parameter trees)."""
from __future__ import annotations

from typing import Callable

import torch


def leaves(tree) -> list:
    """Every tensor leaf, in a fixed order (dict insertion, list index)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); other leaves pass through."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest) if isinstance(tree, torch.Tensor) else tree
