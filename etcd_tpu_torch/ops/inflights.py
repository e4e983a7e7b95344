"""Inflights: the leader's per-follower window of in-flight MsgApps
(etcd_tpu/ops/inflights.py). ``infl_ends`` [N, M*W, C] is viewed as
[N, M, W, C]; start and count are [N, M, C]. Every op is gated by a
destination mask [N, M, C].
"""
from __future__ import annotations

import torch

from etcd_tpu_torch.models.state import NodeState
from etcd_tpu_torch.types import Spec


def _ends(spec: Spec, n: NodeState) -> torch.Tensor:
    N, _, C = n.infl_ends.shape
    return n.infl_ends.view(N, spec.M, spec.W, C)


def _w(spec: Spec, n: NodeState) -> torch.Tensor:
    return torch.arange(spec.W, dtype=torch.int32,
                        device=n.infl_start.device).view(1, 1, spec.W, 1)


def _valid(spec: Spec, n: NodeState) -> torch.Tensor:
    rel = (_w(spec, n) - n.infl_start.unsqueeze(2)) % spec.W
    return rel < n.infl_count.unsqueeze(2)


def _per_dest(x: torch.Tensor) -> torch.Tensor:
    """A per-node [N, C] or per-destination [N, M, C] value as [N, M|1, 1, C]."""
    return (x.unsqueeze(1) if x.dim() == 2 else x).unsqueeze(2)


def add(spec: Spec, n: NodeState, mask, end) -> NodeState:
    """Inflights.Add (inflights.go:56-75) for destinations in ``mask``."""
    pos = (n.infl_start + n.infl_count) % spec.W
    do = mask & (n.infl_count < spec.W)
    sel = do.unsqueeze(2) & (_w(spec, n) == pos.unsqueeze(2))
    ends = torch.where(sel, _per_dest(end), _ends(spec, n))
    return n.replace(infl_ends=ends.reshape(n.infl_ends.shape),
                     infl_count=n.infl_count + do.to(torch.int32))


def free_le(spec: Spec, n: NodeState, mask, idx) -> NodeState:
    """Inflights.FreeLE (inflights.go:95-122): pop the sorted prefix <= idx."""
    le = _valid(spec, n) & (_ends(spec, n) <= _per_dest(idx))
    freed = torch.where(mask, le.sum(2, dtype=torch.int32), 0)
    return n.replace(infl_start=(n.infl_start + freed) % spec.W,
                     infl_count=n.infl_count - freed)


def free_first_one(spec: Spec, n: NodeState, mask) -> NodeState:
    """Inflights.FreeFirstOne (inflights.go:126-132)."""
    do = mask & (n.infl_count > 0)
    return n.replace(
        infl_start=torch.where(do, (n.infl_start + 1) % spec.W, n.infl_start),
        infl_count=n.infl_count - do.to(torch.int32),
    )


def reset(n: NodeState, mask) -> NodeState:
    """Inflights.reset (tracker/progress.go:84-90)."""
    return n.replace(infl_start=torch.where(mask, 0, n.infl_start),
                     infl_count=torch.where(mask, 0, n.infl_count))


def full(max_inflight: int, n: NodeState) -> torch.Tensor:
    """Inflights.Full (inflights.go:78-81): [N, M] bool."""
    return n.infl_count >= max_inflight
