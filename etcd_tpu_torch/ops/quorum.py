"""Quorum tallies over majority and joint configs (etcd_tpu/ops/quorum.py).

Batched over nodes: configs and per-member values are [N, M, C], results
[N, C]. The k-th smallest acked index is found by rank counting over the
[M, M] comparison triangle with ties broken by member id, as the JAX
function does, so equal acks pick the same element.
"""
from __future__ import annotations

import torch

from etcd_tpu_torch.types import INT32_MAX, VOTE_LOST, VOTE_PENDING, VOTE_WON


def committed_index(voters: torch.Tensor, acked: torch.Tensor) -> torch.Tensor:
    """Largest index acked by a quorum of ``voters``; INT32_MAX for an empty
    config (quorum/majority.go:126-172)."""
    i32 = torch.int32
    n = voters.sum(1, dtype=i32)
    vals = torch.where(voters, acked, INT32_MAX)
    pos = torch.clamp(n - (n // 2 + 1), min=0)
    M = vals.shape[1]
    ids = torch.arange(M, dtype=i32, device=vals.device)
    vi, vj = vals.unsqueeze(2), vals.unsqueeze(1)          # [N, i, 1, C], [N, 1, j, C]
    tie = (ids.view(1, 1, M, 1) < ids.view(1, M, 1, 1))
    lt = (vj < vi) | ((vj == vi) & tie)
    rank = lt.sum(2, dtype=i32)                             # [N, M, C]
    kth = torch.where(rank == pos.unsqueeze(1), vals, 0).sum(1, dtype=i32)
    return torch.where(n == 0, INT32_MAX, kth)


def joint_committed_index(voters_incoming, voters_outgoing, acked):
    """min of both halves (quorum/joint.go:70-75)."""
    return torch.minimum(committed_index(voters_incoming, acked),
                         committed_index(voters_outgoing, acked))


def vote_result(voters, responded, granted) -> torch.Tensor:
    """VOTE_WON / VOTE_LOST / VOTE_PENDING for one majority config; an empty
    config wins (quorum/majority.go:178-210)."""
    i32 = torch.int32
    n = voters.sum(1, dtype=i32)
    q = n // 2 + 1
    yes = (voters & responded & granted).sum(1, dtype=i32)
    no = (voters & responded & ~granted).sum(1, dtype=i32)
    missing = n - yes - no
    won = (yes >= q) | (n == 0)
    pending = ~won & (yes + missing >= q)
    return torch.where(won, VOTE_WON,
                       torch.where(pending, VOTE_PENDING, VOTE_LOST)).to(i32)


def joint_vote_result(voters_incoming, voters_outgoing, responded, granted):
    """Lost if either half lost, won if both won, else pending
    (quorum/joint.go:49-68)."""
    r1 = vote_result(voters_incoming, responded, granted)
    r2 = vote_result(voters_outgoing, responded, granted)
    lost = (r1 == VOTE_LOST) | (r2 == VOTE_LOST)
    won = (r1 == VOTE_WON) & (r2 == VOTE_WON)
    return torch.where(lost, VOTE_LOST,
                       torch.where(won, VOTE_WON, VOTE_PENDING)).to(torch.int32)
