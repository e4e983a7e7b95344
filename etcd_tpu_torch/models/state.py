"""Per-node Raft state (counterpart of etcd_tpu/models/state.py).

The same fields, meanings and dtypes as the JAX ``NodeState``, held as one
tensor per field for a whole batch of nodes: a per-node scalar is [N, C],
a per-node vector is [N, F, C] (peer arrays F = M, the log ring F = L),
with N the node axis (a fleet's member axis) and C the clusters axis,
minor. The per-node PRNG key is int32 [N, 2, C] holding the bit patterns
of the JAX key's two uint32 words (utils/prng.py). ``PackedFleet`` is the
packed storage form of a fleet (RaftConfig.packed_state).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from etcd_tpu_torch.types import (
    NONE_ID,
    PR_PROBE,
    ROLE_FOLLOWER,
    Spec,
    TensorStruct,
    wrap_int32,
)
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


# What a crash keeps of each field (etcd_tpu/models/state.py; every field in
# exactly one class; models/engine.py crash_restart_fleet implements it):
# DURABLE survives as it is (HardState, snapshot, node id, the log ring's
# arrays); CAPPED survives up to the fsync floor; REPLAY rewinds to the
# snapshot and is re-derived by the apply loop; VOLATILE resets to a fresh
# follower's boot values.
DURABLE_FIELDS = (
    "nid", "term", "vote",
    "log_term", "log_data", "log_type",
    "snap_index", "snap_term", "snap_hash",
    "snap_voters", "snap_voters_out", "snap_learners", "snap_learners_next",
    "snap_auto_leave",
    "rng_key",
)
CAPPED_FIELDS = ("last_index", "commit")
REPLAY_FIELDS = (
    "applied", "applied_hash",
    "voters", "voters_out", "learners", "learners_next", "auto_leave",
)
VOLATILE_FIELDS = (
    "lead", "role",
    "election_elapsed", "heartbeat_elapsed", "randomized_timeout",
    "match", "next_idx", "pr_state", "probe_sent", "pending_snapshot",
    "recent_active",
    "infl_ends", "infl_start", "infl_count",
    "votes_responded", "votes_granted",
    "pending_conf_index", "uncommitted_size", "lead_transferee",
    "ro_ctx", "ro_index", "ro_from", "ro_acks", "ro_count",
    "ro_pend_ctx", "ro_pend_from", "ro_pend_count",
    "rs_ctx", "rs_index", "rs_count",
)


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


# ---------------------------------------------------------------------------
# Packed fleet storage (RaftConfig.packed_state; etcd_tpu/models/state.py)
#
# The same information as NodeState in three planes per node: ``bits``, the
# narrow fields (roles, ids, vote bitmaps, flags, timers, counters,
# pr_state, log_type) bit-packed into 32-bit lanes; ``narrow``, the index
# and term fields as int16; ``wide``, the hashes and log payload words as
# int32; plus the PRNG key passed through. The bit lanes are the JAX
# package's uint32 lanes held as int32 bit patterns: they are built in
# int64 and wrapped, and read with a mask after the (arithmetic) shift, so
# no sign bit leaks into a field.
# ---------------------------------------------------------------------------

# Packed timer lanes: the randomized timeout is drawn in [T, 2T), so
# 2 * election_tick must stay below 2**PACK_TIMER_BITS (build_round checks);
# the two elapsed counters saturate at the cap (see the JAX module).
PACK_TIMER_BITS = 10
_PACK_SATURATING = ("election_elapsed", "heartbeat_elapsed")

_PACK_BOOL_FIELDS = frozenset({
    "snap_auto_leave", "auto_leave",
    "probe_sent", "recent_active", "votes_responded", "votes_granted",
    "voters", "voters_out", "learners", "learners_next",
    "snap_voters", "snap_voters_out", "snap_learners", "snap_learners_next",
    "ro_acks",
})


@dataclasses.dataclass
class PackedFleet(TensorStruct):
    """A NodeState fleet in packed storage, leaves [M, lanes, C]."""
    bits: torch.Tensor      # int32 bit patterns of the u32 lanes [M, NB, C]
    narrow: torch.Tensor    # int16 [M, NI, C]
    wide: torch.Tensor      # int32 [M, NW, C]
    rng_key: torch.Tensor   # int32 [M, 2, C], passthrough


@functools.lru_cache(maxsize=16)
def pack_plan(spec: Spec):
    """The static layout for one Spec, as the JAX pack_plan gives it:
    (bit_rows, n_lanes, narrow_rows, n_narrow, wide_rows, n_wide). A bit
    row is (name, bits/element, bias, ((lane, offset) per element)); a
    plane row is (name, count, offset)."""
    M, L, R, W = spec.M, spec.L, spec.R, spec.W
    idb = max(M.bit_length(), 1)          # ids stored with +1 bias: 0..M
    cnt = max(R.bit_length(), 1)          # queue counters: 0..R
    tb = PACK_TIMER_BITS
    bit_fields = (
        # (name, bits/element, elements, bias)
        ("nid", idb, 1, 0),
        ("role", 2, 1, 0),
        ("lead", idb, 1, 1),
        ("vote", idb, 1, 1),
        ("lead_transferee", idb, 1, 1),
        ("snap_auto_leave", 1, 1, 0),
        ("auto_leave", 1, 1, 0),
        ("election_elapsed", tb, 1, 0),
        ("heartbeat_elapsed", tb, 1, 0),
        ("randomized_timeout", tb, 1, 0),
        ("ro_count", cnt, 1, 0),
        ("ro_pend_count", cnt, 1, 0),
        ("rs_count", cnt, 1, 0),
        ("pr_state", 2, M, 0),
        ("probe_sent", 1, M, 0),
        ("recent_active", 1, M, 0),
        ("votes_responded", 1, M, 0),
        ("votes_granted", 1, M, 0),
        ("voters", 1, M, 0),
        ("voters_out", 1, M, 0),
        ("learners", 1, M, 0),
        ("learners_next", 1, M, 0),
        ("snap_voters", 1, M, 0),
        ("snap_voters_out", 1, M, 0),
        ("snap_learners", 1, M, 0),
        ("snap_learners_next", 1, M, 0),
        ("infl_start", max((W - 1).bit_length(), 1), M, 0),
        ("infl_count", max(W.bit_length(), 1), M, 0),
        ("ro_acks", 1, R * M, 0),
        ("ro_from", idb, R, 1),
        ("ro_pend_from", idb, R, 1),
        ("log_type", 2, L, 0),
    )
    # greedy lane fill; an element never straddles two lanes
    bit_rows, lane, off = [], 0, 0
    for name, bits, count, bias in bit_fields:
        slots = []
        for _ in range(count):
            if off + bits > 32:
                lane, off = lane + 1, 0
            slots.append((lane, off))
            off += bits
        bit_rows.append((name, bits, bias, tuple(slots)))
    n_lanes = lane + 1

    def runs(fields):
        rows, o = [], 0
        for name, count in fields:
            rows.append((name, count, o))
            o += count
        return tuple(rows), o

    narrow_rows, n_narrow = runs((
        ("term", 1), ("commit", 1), ("last_index", 1), ("applied", 1),
        ("snap_index", 1), ("snap_term", 1), ("pending_conf_index", 1),
        ("uncommitted_size", 1),
        ("match", M), ("next_idx", M), ("pending_snapshot", M),
        ("infl_ends", M * W),
        ("log_term", L),
        ("ro_ctx", R), ("ro_index", R), ("ro_pend_ctx", R),
        ("rs_ctx", R), ("rs_index", R),
    ))
    wide_rows, n_wide = runs((
        ("applied_hash", 1), ("snap_hash", 1), ("log_data", L),
    ))
    covered = ({r[0] for r in bit_rows} | {r[0] for r in narrow_rows}
               | {r[0] for r in wide_rows} | {"rng_key"})
    if covered != set(NodeState.names()):
        raise ValueError("pack_plan out of sync with NodeState: missing="
                         f"{sorted(set(NodeState.names()) - covered)} extra="
                         f"{sorted(covered - set(NodeState.names()))}")
    return tuple(bit_rows), n_lanes, narrow_rows, n_narrow, wide_rows, n_wide


def _rows3(x: torch.Tensor) -> torch.Tensor:
    """Fleet leaf [M, C] or [M, count, C] -> [M, count, C]."""
    return x.unsqueeze(1) if x.dim() == 2 else x


def pack_fleet(spec: Spec, state: NodeState) -> PackedFleet:
    """NodeState fleet -> packed storage. Values are masked to their widths
    (the elapsed timers saturate instead), as the JAX function does."""
    bit_rows, n_lanes, narrow_rows, _, wide_rows, _ = pack_plan(spec)
    lanes = [None] * n_lanes
    for name, bits, bias, slots in bit_rows:
        v = _rows3(getattr(state, name)).to(torch.int64)
        if name not in _PACK_BOOL_FIELDS:
            v = v + bias
            if name in _PACK_SATURATING:
                v = torch.clamp(v, max=(1 << bits) - 1)
            v = v & ((1 << bits) - 1)
        for k, (lane, off) in enumerate(slots):
            word = v[:, k] << off
            lanes[lane] = word if lanes[lane] is None else lanes[lane] | word
    return PackedFleet(
        bits=wrap_int32(torch.stack(lanes, 1)),
        narrow=torch.cat([_rows3(getattr(state, name)).to(torch.int16)
                          for name, _, _ in narrow_rows], 1),
        wide=torch.cat([_rows3(getattr(state, name)).to(torch.int32)
                        for name, _, _ in wide_rows], 1),
        rng_key=state.rng_key)


def _unpack_bits_row(packed: PackedFleet, name, bits, bias, slots):
    mask = (1 << bits) - 1
    v = torch.stack([(packed.bits[:, lane] >> off) & mask for lane, off in slots], 1)
    x = (v != 0) if name in _PACK_BOOL_FIELDS else v - bias
    return x[:, 0] if len(slots) == 1 else x


def _unpack_plane_row(plane: torch.Tensor, count, off):
    x = plane[:, off:off + count].to(torch.int32)
    return x[:, 0] if count == 1 else x


def unpack_fleet(spec: Spec, packed: PackedFleet) -> NodeState:
    """Packed storage -> NodeState fleet, the exact inverse of pack_fleet on
    every in-contract value."""
    bit_rows, _, narrow_rows, _, wide_rows, _ = pack_plan(spec)
    out = {"rng_key": packed.rng_key}
    for name, bits, bias, slots in bit_rows:
        out[name] = _unpack_bits_row(packed, name, bits, bias, slots)
    for rows, plane in ((narrow_rows, packed.narrow), (wide_rows, packed.wide)):
        for name, count, off in rows:
            out[name] = _unpack_plane_row(plane, count, off)
    return NodeState(**out)


def unpack_field(spec: Spec, packed: PackedFleet, name: str) -> torch.Tensor:
    """One NodeState field off the packed storage, without unpacking the
    rest of the fleet."""
    if name == "rng_key":
        return packed.rng_key
    bit_rows, _, narrow_rows, _, wide_rows, _ = pack_plan(spec)
    for fname, bits, bias, slots in bit_rows:
        if fname == name:
            return _unpack_bits_row(packed, name, bits, bias, slots)
    for rows, plane in ((narrow_rows, packed.narrow), (wide_rows, packed.wide)):
        for fname, count, off in rows:
            if fname == name:
                return _unpack_plane_row(plane, count, off)
    raise KeyError(name)


def state_bytes_per_group(spec: Spec, packed: bool = False) -> int:
    """Resident bytes per group (M nodes) of the fleet state in the given
    storage form, from the leaf dtypes and shapes."""
    if packed:
        _, nb, _, ni, _, nw = pack_plan(spec)
        return spec.M * (nb * 4 + ni * 2 + nw * 4 + 2 * 4)
    n = init_node(spec, torch.zeros((1, 1), dtype=torch.int32),
                  torch.ones((1, spec.M, 1), dtype=torch.bool))
    return spec.M * sum(leaf.numel() * leaf.element_size()
                        for _, leaf in n.items())
