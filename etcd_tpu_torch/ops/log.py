"""Log-ring ops (etcd_tpu/ops/log.py) over a batch of nodes.

Entry ``i`` lives at ring slot ``(i-1) % L``; the valid window is
(snap_index, last_index]. Node scalars are [N, C], the ring [N, L, C];
index arguments may carry extra per-node axes between N and C.
"""
from __future__ import annotations

import torch

from etcd_tpu_torch.models.state import NodeState
from etcd_tpu_torch.types import ENTRY_CONF_CHANGE, Spec
from etcd_tpu_torch.utils.tree import bcast_to


def slot(spec: Spec, idx: torch.Tensor) -> torch.Tensor:
    return (idx - 1) % spec.L


def ring_read(ring: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """ring[s] per node: ring [N, F, C], s [N, ..., C] -> s-shaped values.
    An index outside [0, F) reads 0, as the JAX one-hot contraction does."""
    N, F, C = ring.shape
    flat = s.reshape(N, -1, C)
    inside = (flat >= 0) & (flat < F)
    got = torch.gather(ring, 1, flat.clamp(0, F - 1).to(torch.int64))
    got = torch.where(inside, got, torch.zeros((), dtype=ring.dtype, device=ring.device))
    return got.view(s.shape)


def roll_left(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per node ``roll(a, -k)`` along the feature axis: a [N, F, ..., C],
    k [N, C]."""
    F = a.shape[1]
    lead = (1,) * (a.dim() - 3)
    offs = torch.arange(F, dtype=torch.int32, device=a.device).view((1, F) + lead + (1,))
    k = k.view(k.shape[:1] + (1,) + lead + k.shape[1:])
    return torch.gather(a, 1, ((offs + k) % F).to(torch.int64).expand(a.shape))


def first_index(n: NodeState) -> torch.Tensor:
    return n.snap_index + 1


def term_at(spec: Spec, n: NodeState, idx: torch.Tensor):
    """(term, ok) of entry ``idx`` (raftLog.term, log.go:265-285); ok is
    False outside [snap_index, last_index]."""
    snap_index = bcast_to(n.snap_index, idx)
    t = ring_read(n.log_term, slot(spec, idx))
    t = torch.where(idx == snap_index, bcast_to(n.snap_term, idx), t)
    ok = (idx >= snap_index) & (idx <= bcast_to(n.last_index, idx))
    return torch.where(ok, t, 0), ok


def match_term(spec: Spec, n: NodeState, idx, term):
    t, ok = term_at(spec, n, idx)
    return ok & (t == term)


def last_term(spec: Spec, n: NodeState) -> torch.Tensor:
    t, _ = term_at(spec, n, n.last_index)
    return t


def is_up_to_date(spec: Spec, n: NodeState, lasti, term) -> torch.Tensor:
    """raftLog.isUpToDate (log.go:313-315)."""
    lt = last_term(spec, n)
    return (term > lt) | ((term == lt) & (lasti >= n.last_index))


def clip(x, lo, hi):
    """jnp.clip: min(max(x, lo), hi), hi winning when lo > hi."""
    return torch.minimum(torch.maximum(x, lo), hi)


def commit_to(n: NodeState, tocommit) -> NodeState:
    """raftLog.commitTo (log.go:233-241): never decreases, clamped to
    last_index."""
    c = clip(tocommit, n.commit, n.last_index)
    return n.replace(commit=torch.maximum(n.commit, c))


def _ent_idx(spec: Spec, n: NodeState) -> torch.Tensor:
    """[N, L, C]: the entry index each ring slot holds in the current window."""
    idxs = torch.arange(spec.L, dtype=torch.int32, device=n.last_index.device)
    last = n.last_index.unsqueeze(1)
    return last - ((slot(spec, last) - idxs.view(1, -1, 1)) % spec.L)


def find_conflict_by_term(spec: Spec, n: NodeState, index, term) -> torch.Tensor:
    """Largest i <= index with term(i) <= term (log.go:147-168); an index
    past last_index is returned as-is."""
    ent_idx = _ent_idx(spec, n)
    hi = torch.minimum(index, n.last_index).unsqueeze(1)
    in_win = (ent_idx > n.snap_index.unsqueeze(1)) & (ent_idx <= hi)
    cand = torch.where(in_win & (n.log_term <= term.unsqueeze(1)), ent_idx, -1)
    best = cand.amax(1)
    best = torch.maximum(best, torch.where(
        (n.snap_term <= term) & (n.snap_index <= index), n.snap_index, -1))
    best = torch.maximum(best, torch.minimum(index, n.snap_index - 1))
    return torch.where(index > n.last_index, index, best)


def append_span(spec: Spec, n: NodeState, prev_index, ent_len, ent_term,
                ent_data, ent_type, enable) -> NodeState:
    """Truncate-and-append entries (prev_index, prev_index + ent_len] where
    ``enable`` (unstable.truncateAndAppend, log_unstable.go:121). Entries
    are [N, E, C]; consecutive indexes land on distinct ring slots, so the
    E writes commute."""
    dev = prev_index.device
    L = torch.arange(spec.L, dtype=torch.int32, device=dev).view(1, -1, 1)
    rings = {"log_term": n.log_term, "log_data": n.log_data,
             "log_type": n.log_type}
    vals = {"log_term": ent_term, "log_data": ent_data, "log_type": ent_type}
    for e in range(spec.E):
        s = slot(spec, prev_index + 1 + e)
        hit = (L == s.unsqueeze(1)) & (enable & (e < ent_len)).unsqueeze(1)
        for k in rings:
            rings[k] = torch.where(hit, vals[k][:, e].unsqueeze(1), rings[k])
    return n.replace(**rings, last_index=torch.where(
        enable, prev_index + ent_len, n.last_index))


def maybe_append(spec: Spec, n: NodeState, m_index, m_log_term, m_commit,
                 ent_len, ent_term, ent_data, ent_type, enable):
    """raftLog.maybeAppend (log.go:88-104): (state, last_new_i, ok)."""
    ok = match_term(spec, n, m_index, m_log_term)
    do = enable & ok
    last_new_i = m_index + ent_len

    E = spec.E
    offs = torch.arange(E, dtype=torch.int32, device=m_index.device).view(1, E, 1)
    idxs = m_index.unsqueeze(1) + 1 + offs
    valid = offs < ent_len.unsqueeze(1)
    t_here, ok_here = term_at(spec, n, idxs)
    matches = valid & ok_here & (t_here == ent_term)
    mismatch = valid & ~matches
    any_conflict = mismatch.any(1)
    first = torch.where(mismatch, offs, E).amin(1)
    ci_off = torch.where(any_conflict, first, 0)

    n = append_span(
        spec, n, m_index + ci_off, ent_len - ci_off,
        roll_left(ent_term, ci_off), roll_left(ent_data, ci_off),
        roll_left(ent_type, ci_off), do & any_conflict,
    )
    c = clip(torch.minimum(m_commit, last_new_i), n.commit, n.last_index)
    n = n.replace(commit=torch.where(do, torch.maximum(n.commit, c), n.commit))
    return n, torch.where(do, last_new_i, 0), ok


def entries_from(spec: Spec, n: NodeState, lo):
    """Up to E entries starting at index ``lo``: (len, term, data, type),
    the entry planes [N, E, C] (raftLog.entries as maybeSendAppend uses it)."""
    E = spec.E
    offs = torch.arange(E, dtype=torch.int32, device=lo.device).view(1, E, 1)
    idxs = lo.unsqueeze(1) + offs
    valid = (idxs >= first_index(n).unsqueeze(1)) & (idxs <= n.last_index.unsqueeze(1))
    s = slot(spec, idxs)
    ln = torch.clamp(n.last_index - lo + 1, 0, E)

    def rd(ring):
        return torch.where(valid, ring_read(ring, s), 0)
    return ln, rd(n.log_term), rd(n.log_data), rd(n.log_type)


def count_pending_conf(spec: Spec, n: NodeState, lo, hi) -> torch.Tensor:
    """Conf-change entries with index in (lo, hi] (raft.go:760-777)."""
    ent_idx = _ent_idx(spec, n)
    in_win = ((ent_idx > lo.unsqueeze(1)) & (ent_idx <= hi.unsqueeze(1))
              & (ent_idx > n.snap_index.unsqueeze(1))
              & (ent_idx <= n.last_index.unsqueeze(1)))
    return (in_win & (n.log_type == ENTRY_CONF_CHANGE)).sum(1, dtype=torch.int32)
