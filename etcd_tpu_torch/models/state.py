"""Per-node Raft state (counterpart of etcd_tpu/models/state.py).

The same fields, meanings and dtypes as the JAX ``NodeState``, held as one
tensor per field for a whole batch of nodes: a per-node scalar is [N, C],
a per-node vector is [N, F, C] (peer arrays F = M, the log ring F = L),
with N the node axis (a fleet's member axis) and C the clusters axis,
minor. The per-node PRNG key is int32 [N, 2, C] holding the bit patterns
of the JAX key's two uint32 words (utils/prng.py).
"""
from __future__ import annotations

import dataclasses

import torch

from etcd_tpu_torch.types import NONE_ID, PR_PROBE, ROLE_FOLLOWER, Spec, TensorStruct
from etcd_tpu_torch.utils import prng


@dataclasses.dataclass
class NodeState(TensorStruct):
    nid: torch.Tensor
    term: torch.Tensor
    vote: torch.Tensor
    commit: torch.Tensor
    lead: torch.Tensor
    role: torch.Tensor
    log_term: torch.Tensor          # [N, L, C]
    log_data: torch.Tensor          # [N, L, C]
    log_type: torch.Tensor          # [N, L, C]
    last_index: torch.Tensor
    applied: torch.Tensor
    applied_hash: torch.Tensor
    snap_index: torch.Tensor
    snap_term: torch.Tensor
    snap_hash: torch.Tensor
    snap_voters: torch.Tensor       # bool [N, M, C]
    snap_voters_out: torch.Tensor
    snap_learners: torch.Tensor
    snap_learners_next: torch.Tensor
    snap_auto_leave: torch.Tensor   # bool
    election_elapsed: torch.Tensor
    heartbeat_elapsed: torch.Tensor
    randomized_timeout: torch.Tensor
    rng_key: torch.Tensor           # int32 [N, 2, C], uint32 bit patterns
    match: torch.Tensor             # [N, M, C]
    next_idx: torch.Tensor
    pr_state: torch.Tensor
    probe_sent: torch.Tensor        # bool
    pending_snapshot: torch.Tensor
    recent_active: torch.Tensor     # bool
    infl_ends: torch.Tensor         # [N, M*W, C]
    infl_start: torch.Tensor        # [N, M, C]
    infl_count: torch.Tensor
    votes_responded: torch.Tensor   # bool [N, M, C]
    votes_granted: torch.Tensor
    voters: torch.Tensor            # bool [N, M, C]
    voters_out: torch.Tensor
    learners: torch.Tensor
    learners_next: torch.Tensor
    auto_leave: torch.Tensor        # bool
    pending_conf_index: torch.Tensor
    uncommitted_size: torch.Tensor
    lead_transferee: torch.Tensor
    ro_ctx: torch.Tensor            # [N, R, C]
    ro_index: torch.Tensor
    ro_from: torch.Tensor
    ro_acks: torch.Tensor           # bool [N, R*M, C]
    ro_count: torch.Tensor
    ro_pend_ctx: torch.Tensor       # [N, R, C]
    ro_pend_from: torch.Tensor
    ro_pend_count: torch.Tensor
    rs_ctx: torch.Tensor            # [N, R, C]
    rs_index: torch.Tensor
    rs_count: torch.Tensor


def init_node(
    spec: Spec,
    nid: torch.Tensor,
    voters: torch.Tensor,
    learners: torch.Tensor | None = None,
    seed: torch.Tensor | int = 0,
    election_tick: int = 10,
) -> NodeState:
    """Fresh followers at term 0 (etcd_tpu/models/state.py init_node) for a
    batch of nodes: ``nid`` and ``seed`` are integer [N, C] tensors, the
    config masks bool [N, M, C]. The randomized timeout and PRNG key come
    from the same threefry draws as the JAX function: key =
    fold_in(fold_in(PRNGKey(0), seed), nid), then split and randint."""
    N, C = nid.shape
    M, L, W, R = spec.M, spec.L, spec.W, spec.R
    dev = nid.device
    if learners is None:
        learners = torch.zeros((N, M, C), dtype=torch.bool, device=dev)
    seed = torch.as_tensor(seed, device=dev).expand(N, C)
    key = prng.fold_in(prng.prng_key(0, dev), seed)
    key = prng.fold_in(key, nid)
    key, sub = prng.split2(key)
    rand_to = election_tick + prng.randint(sub, 0, election_tick)

    def z(*f):
        return torch.zeros((N,) + f + (C,), dtype=torch.int32, device=dev)

    def full(v, *f):
        return torch.full((N,) + f + (C,), v, dtype=torch.int32, device=dev)

    def fb(*f):
        return torch.zeros((N,) + f + (C,), dtype=torch.bool, device=dev)

    return NodeState(
        nid=nid.to(torch.int32),
        term=z(), vote=full(NONE_ID), commit=z(),
        lead=full(NONE_ID), role=full(ROLE_FOLLOWER),
        log_term=z(L), log_data=z(L), log_type=z(L),
        last_index=z(), applied=z(), applied_hash=z(),
        snap_index=z(), snap_term=z(), snap_hash=z(),
        snap_voters=voters.clone(), snap_voters_out=fb(M),
        snap_learners=learners.clone(), snap_learners_next=fb(M),
        snap_auto_leave=fb(),
        election_elapsed=z(), heartbeat_elapsed=z(),
        randomized_timeout=rand_to,
        rng_key=prng.stored(key),
        match=z(M), next_idx=full(1, M), pr_state=full(PR_PROBE, M),
        probe_sent=fb(M), pending_snapshot=z(M), recent_active=fb(M),
        infl_ends=z(M * W), infl_start=z(M), infl_count=z(M),
        votes_responded=fb(M), votes_granted=fb(M),
        voters=voters.clone(), voters_out=fb(M),
        learners=learners.clone(), learners_next=fb(M),
        auto_leave=fb(),
        pending_conf_index=z(), uncommitted_size=z(),
        lead_transferee=full(NONE_ID),
        ro_ctx=z(R), ro_index=z(R), ro_from=full(NONE_ID, R),
        ro_acks=fb(R * M), ro_count=z(),
        ro_pend_ctx=z(R), ro_pend_from=full(NONE_ID, R), ro_pend_count=z(),
        rs_ctx=z(R), rs_index=z(R), rs_count=z(),
    )


def _self_hot(n: NodeState) -> torch.Tensor:
    """bool [N, M, C]: peer slot m is this node."""
    M = n.voters.shape[1]
    ids = torch.arange(M, dtype=torch.int32, device=n.nid.device).view(1, M, 1)
    return ids == n.nid.unsqueeze(1)


def is_joint(n: NodeState) -> torch.Tensor:
    return n.voters_out.any(1)


def is_learner_self(n: NodeState) -> torch.Tensor:
    return (_self_hot(n) & n.learners).any(1)


def in_config_self(n: NodeState) -> torch.Tensor:
    """Whether this node has a Progress entry (voter, outgoing or learner)."""
    return (_self_hot(n) & (n.voters | n.voters_out | n.learners)).any(1)


def state_bytes_per_group(spec: Spec) -> int:
    """Resident bytes per group (M nodes) of the dense fleet state, from the
    leaf dtypes and shapes."""
    n = init_node(spec, torch.zeros((1, 1), dtype=torch.int32),
                  torch.ones((1, spec.M, 1), dtype=torch.bool))
    return spec.M * sum(leaf.numel() * leaf.element_size()
                        for _, leaf in n.items())
