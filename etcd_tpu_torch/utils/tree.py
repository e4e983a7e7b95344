"""Leafwise selection over the port's tensor dataclasses."""
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
