"""Leafwise selection, cloning and copying over the port's tensor
dataclasses."""
from __future__ import annotations

import torch


def bcast_to(pred: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """View a per-element predicate [N, C] with singleton axes inserted so
    it broadcasts against a leaf [N, feature..., C]."""
    extra = leaf.dim() - pred.dim()
    if extra <= 0:
        return pred
    return pred.view(pred.shape[:1] + (1,) * extra + pred.shape[1:])


def tree_where(pred: torch.Tensor, on_true, on_false):
    """Leafwise ``where(pred, a, b)`` (etcd_tpu/utils/tree.py). ``pred`` is
    [N, C]; leaves are [N, ..., C]. A leaf that is the same tensor on both
    sides is passed through untouched, which is what ``replace`` leaves
    for every field it did not set."""
    out = {}
    for name, a in on_true.items():
        b = getattr(on_false, name)
        out[name] = a if a is b else torch.where(bcast_to(pred, a), a, b)
    return type(on_true)(**out)


def leaves(x) -> list:
    """The tensors of a tensor dataclass, a tuple of them, a tensor or None
    (none), nested, in a fixed order."""
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in leaves(v)]
    return [t for _, v in x.items() for t in leaves(v)]


def tree_clone(x):
    """The same structure with every tensor cloned."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(tree_clone(v) for v in x)
    return x.map(lambda _, v: tree_clone(v))


def tree_load(dst, src) -> None:
    """Copy every tensor of ``src`` into the same tensor of ``dst`` (the
    same structure), skipping those that already are it."""
    for d, s in zip(leaves(dst), leaves(src)):
        if d is not s:
            d.copy_(s)
