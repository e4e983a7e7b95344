"""Batched engine: node rounds + message exchange (etcd_tpu/models/engine.py).

Fleet layout is clusters-minor, as in the JAX package: every state leaf is
[M, feature..., C] and the stored wire is FLAT — dense [from, K*to(*E), C],
or compacted [B, to(*E), C] under ``RaftConfig.compact_wire`` — with int16
leaves under ``RaftConfig.wire_int16``. The node axis of the batched round
is the member axis, so the outbox a round writes is the [from, K, to, (E,)
C] delivery view; the keep-mask zeroes the type of dropped slots and the
compaction kernel packs the survivors into the next inbox. Under
``RaftConfig.packed_state`` the state between rounds is the PackedFleet
storage form, and ``fleet_chunks`` runs the round over C-slices in turn.
The chaos tier's crash machinery (``crash_restart_fleet``,
``wipe_crashed_traffic``) and its fault windows (``snapshot_window_mask``,
``member_window_mask``) work on the whole fleet. ``build_kv_round`` fuses
the device MVCC apply plane (etcd_tpu_torch/device_mvcc) into the round,
and ``KVRound`` runs it as one CUDA graph a round. ``wire_overflow_count``
audits an int32 wire for values the int16 wire would not carry.
"""
from __future__ import annotations

import torch

from etcd_tpu_torch.device_mvcc.apply import apply_word, extract_deltas
from etcd_tpu_torch.device_mvcc.state import KVSpec, KVState
from etcd_tpu_torch.kernels.compact_wire import compact_wire_carry
from etcd_tpu_torch.models.raft import node_round
from etcd_tpu_torch.models.state import (
    PACK_TIMER_BITS,
    NodeState,
    init_node,
    pack_fleet,
    unpack_fleet,
)
from etcd_tpu_torch.types import (
    ENT_FIELDS,
    ENTRY_CONF_CHANGE,
    ENTRY_NORMAL,
    MSG_SNAP,
    NONE_ID,
    PR_PROBE,
    PR_SNAPSHOT,
    ROLE_FOLLOWER,
    ROLE_LEADER,
    WIRE_SPLIT,
    Msg,
    Spec,
    empty_msg,
)
from etcd_tpu_torch.utils.config import RaftConfig
from etcd_tpu_torch.utils.device import resolve_device
from etcd_tpu_torch.utils.tree import bcast_to


def _unflatten_inbox(spec: Spec, msgs: Msg) -> Msg:
    """[from, K*to(*E), C] -> [from, K, to, (E,) C] (a view)."""
    M, K, E = spec.M, spec.K, spec.E

    def f(name, x):
        if name in ENT_FIELDS:
            return x.view(M, K, M, E, x.shape[-1])
        return x.view(M, K, M, x.shape[-1])
    return msgs.map(f)


def _flatten_inbox(spec: Spec, msgs: Msg) -> Msg:
    """Inverse of :func:`_unflatten_inbox`."""
    M, K, E = spec.M, spec.K, spec.E

    def f(name, x):
        n = K * M * (E if name in ENT_FIELDS else 1)
        return x.reshape(M, n, x.shape[-1])
    return msgs.map(f)


def _unflatten_compact(spec: Spec, msgs: Msg) -> Msg:
    """Compact storage [B, to(*E), C] -> receiver view [B, to, (E,) C]."""
    M, E = spec.M, spec.E

    def f(name, x):
        if name in ENT_FIELDS:
            return x.view(x.shape[0], M, E, x.shape[-1])
        return x
    return msgs.map(f)


def to_wire(m: Msg) -> Msg:
    """int32 -> int16 at the round boundary (RaftConfig.wire_int16)."""
    return m.map(lambda _, x: x.to(torch.int16) if x.dtype == torch.int32 else x)


def from_wire(m: Msg) -> Msg:
    return m.map(lambda _, x: x.to(torch.int32) if x.dtype == torch.int16 else x)


def wire_overflow_count(spec: Spec, inbox: Msg) -> torch.Tensor:
    """The int16-wire safety check: the number of values in a flat int32
    inbox ([from, K*to(*E), C] leaves) that would not survive the int16
    cast and are not covered by a registered split (types.WIRE_SPLIT), a
    0-dim int32 tensor on the inbox's device."""
    if inbox.term.dtype == torch.int16:
        raise ValueError(
            "wire_overflow_count audits the PRE-cast int32 wire; run the "
            "fleet with wire_int16=False and check each round's inbox")
    lo, hi = -(2 ** 15), 2 ** 15 - 1
    t = inbox.type.to(torch.int32)                 # [M, K*M, C]
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for name, x in inbox.items():
        if x.dtype != torch.int32:
            continue
        tt = t.repeat_interleave(spec.E, dim=1) if name in ENT_FIELDS else t
        bad = (x < lo) | (x > hi)
        for f, msg_type in WIRE_SPLIT:
            if f == name:
                bad = bad & (tt != msg_type)
        total = total + bad.sum()
    return total.to(torch.int32)


def empty_inbox(spec: Spec, C: int, wire_int16: bool = False,
                compact_bound: int = 0, device=None) -> Msg:
    """Zeroed flat inbox: [from, K*to(*E), C] leaves, or the compacted
    [B, to(*E), C] form when ``compact_bound`` > 0."""
    dev = resolve_device(device)
    B = min(compact_bound, spec.K * spec.M)

    def mk(name, x):
        e = spec.E if name in ENT_FIELDS else 1
        dt = torch.int16 if wire_int16 and x.dtype == torch.int32 else x.dtype
        shape = (B, spec.M * e, C) if B else (spec.M, spec.K * spec.M * e, C)
        return torch.zeros(shape, dtype=dt, device=dev)

    return empty_msg(spec, (1, 1), dev).map(mk)


def inbox_bytes_per_group(spec: Spec, wire_int16: bool = False,
                          compact_bound: int = 0) -> int:
    """Resident wire bytes per group in the given storage form."""
    ib = empty_inbox(spec, 1, wire_int16, compact_bound, device="cpu")
    return sum(x.numel() * x.element_size() for _, x in ib.items())


def init_fleet(spec: Spec, C: int, voters: torch.Tensor | None = None,
               learners: torch.Tensor | None = None, seed: int = 0,
               election_tick: int = 10, device=None) -> NodeState:
    """Fresh fleet, leaves [M, ..., C]. Node (m, c) draws from the seed
    ``c * 1_000_003 + seed`` wrapped to int32, as the JAX fleet does.
    ``voters``/``learners``: bool [M] shared by every group, or [C, M]."""
    dev = resolve_device(device)
    M = spec.M

    def mask(x, default):
        if x is None:
            x = torch.full((M,), default, dtype=torch.bool)
        x = torch.as_tensor(x, dtype=torch.bool, device=dev)
        x = x.T if x.dim() == 2 else x.unsqueeze(1).expand(M, C)
        return x.unsqueeze(0).expand(M, M, C)       # [node, member, C]

    c = torch.arange(C, dtype=torch.int64, device=dev)
    seeds = ((c * 1_000_003 + seed) & 0xFFFFFFFF).unsqueeze(0).expand(M, C)
    nid = torch.arange(M, dtype=torch.int32, device=dev).unsqueeze(1).expand(M, C)
    return init_node(spec, nid.contiguous(), mask(voters, True),
                     mask(learners, False), seeds, election_tick)


def crash_restart_fleet(spec: Spec, state: NodeState, crashed: torch.Tensor,
                        stable: torch.Tensor, rand_to: torch.Tensor,
                        keep_log=True) -> tuple[NodeState, torch.Tensor]:
    """Crash and at once restart the nodes of the mask ``crashed`` [M, C],
    keeping only their modeled durable state (models/state.py's classes:
    DURABLE, CAPPED, REPLAY, VOLATILE; etcd_tpu/models/engine.py
    crash_restart_fleet). ``stable`` [M, C] is each node's fsync'd log
    prefix, ``rand_to`` [M, C] the restarted node's fresh randomized
    election timeout, ``keep_log`` a bool or a 0-dim bool tensor (False is
    the broken persist-nothing model: nothing survives past the snapshot).

    The restarted values are written into the crashed lanes of ``state``'s
    own leaves (as the JAX program's donated carry is), so the wipe makes no
    fleet-sized copy; a leaf that shares its storage with another is first
    given storage of its own. Returns (state, entries_lost), entries_lost
    the int32 count of log entries this call dropped."""
    floor = state.snap_index                       # snapshots fsync eagerly
    kept = torch.maximum(torch.minimum(state.last_index, stable), floor)
    if isinstance(keep_log, torch.Tensor):
        durable_last = torch.where(keep_log, kept, floor)
    else:
        durable_last = kept if keep_log else floor
    # commit-only advances never force an fsync: the persisted commit is
    # capped by the durable log and may legally regress across the crash
    durable_commit = torch.maximum(torch.minimum(state.commit, durable_last), floor)
    lost = torch.where(crashed, state.last_index - durable_last, 0).sum().to(torch.int32)

    owners: dict = {}
    for name, x in state.items():
        owners.setdefault(x.untyped_storage().data_ptr(), []).append(name)
    shared = {n for names in owners.values() if len(names) > 1 for n in names}
    fresh = {n: getattr(state, n).clone() for n in shared}
    state = state.replace(**fresh)

    def put(name, value):
        cur = getattr(state, name)
        m = bcast_to(crashed, cur)
        if isinstance(value, torch.Tensor):
            torch.where(m, value.to(cur.dtype), cur, out=cur)
        else:
            cur.masked_fill_(m, value)

    # CAPPED
    put("last_index", durable_last)
    put("commit", durable_commit)
    # REPLAY: the state machine and the applied config rewind to the
    # snapshot; the apply loop re-derives the same hash chain
    for name, src in (("applied", "snap_index"), ("applied_hash", "snap_hash"),
                      ("voters", "snap_voters"), ("voters_out", "snap_voters_out"),
                      ("learners", "snap_learners"),
                      ("learners_next", "snap_learners_next"),
                      ("auto_leave", "snap_auto_leave")):
        put(name, getattr(state, src))
    # VOLATILE: a fresh follower's boot values
    put("randomized_timeout", rand_to)
    put("next_idx", durable_last.unsqueeze(1) + 1)
    for name in ("lead", "lead_transferee", "ro_from", "ro_pend_from"):
        put(name, NONE_ID)
    put("role", ROLE_FOLLOWER)
    put("pr_state", PR_PROBE)
    for name in ("election_elapsed", "heartbeat_elapsed", "match", "probe_sent",
                 "pending_snapshot", "recent_active", "infl_ends", "infl_start",
                 "infl_count", "votes_responded", "votes_granted",
                 "pending_conf_index", "uncommitted_size", "ro_ctx", "ro_index",
                 "ro_acks", "ro_count", "ro_pend_ctx", "ro_pend_count", "rs_ctx",
                 "rs_index", "rs_count"):
        put(name, 0)
    # DURABLE fields (term, vote, the log ring, snap_*, nid, rng_key) stay
    return state, lost


def wipe_crashed_traffic(spec: Spec, inbox: Msg, crashed: torch.Tensor) -> Msg:
    """Drop every in-flight message from or to a crashed node (mask [M, C])
    of the flat wire: only the type leaf is zeroed, since type 0 marks an
    empty slot whose other fields are never read. The from-wipe is what
    makes the loss of entries past ``stable`` safe: no acknowledgement of
    an unsynced entry is ever delivered."""
    M, K = spec.M, spec.K
    C = inbox.type.shape[-1]
    t5 = inbox.type.reshape(M, K, M, C)            # [from, K, to, C]
    kill = crashed.view(M, 1, 1, C) | crashed.view(1, 1, M, C)
    return inbox.replace(type=torch.where(kill, 0, t5).reshape(M, K * M, C))


def snapshot_window_mask(spec: Spec, state: NodeState, inbox: Msg) -> torch.Tensor:
    """bool [M, C]: nodes inside the snapshot-install window this round: a
    MsgSnap in flight to the node, or a leader with a peer in PR_SNAPSHOT
    (``inbox`` is the flat wire, int16 or int32)."""
    M, K = spec.M, spec.K
    C = inbox.type.shape[-1]
    t = inbox.type.reshape(M * K, M, C)            # [from*K, to, C]
    snap_to = (t == MSG_SNAP).any(0)
    snap_from = (state.role == ROLE_LEADER) & (state.pr_state == PR_SNAPSHOT).any(1)
    return snap_to | snap_from


def member_window_mask(spec: Spec, state: NodeState) -> torch.Tensor:
    """bool [M, C]: membership-sensitive nodes: the applied config is joint,
    or a committed but unapplied conf-change entry lies in (applied,
    commit]."""
    L = spec.L
    li = state.last_index.unsqueeze(1)                                 # [M, 1, C]
    idxs = torch.arange(L, dtype=torch.int32, device=li.device).view(1, L, 1)
    ent_idx = li - (((li - 1) % L) - idxs) % L     # the index living at each slot
    pend_cc = ((ent_idx > state.applied.unsqueeze(1))
               & (ent_idx <= state.commit.unsqueeze(1))
               & (ent_idx > state.snap_index.unsqueeze(1))
               & (state.log_type == ENTRY_CONF_CHANGE)).any(1)
    return state.voters_out.any(1) | pend_cc


def build_round(cfg: RaftConfig, spec: Spec, with_drop_count: bool = False):
    """Returns round_fn(state, inbox, prop_len, prop_data, prop_type, ri_ctx,
    do_hup, do_tick, keep_mask) -> (state, next_inbox), the signature and
    shapes of the JAX round: prop_len/ri_ctx/do_hup/do_tick [M, C],
    prop_data/prop_type [M, E, C], keep_mask bool [M(from), M(to), C]. An
    input whose local step ``cfg.local_steps`` leaves out is unused, as in
    the JAX program. The round runs on the device its tensors are on; on a
    CUDA device the compactions (``compact_wire``'s at the round boundary,
    or the in-round ``compact_inbox`` of ``inbox_bound``) are the
    hand-written kernel.

    ``with_drop_count``: also return the number of emitted messages the
    keep-mask (and, under compact_wire, the inbox bound) dropped, a 0-dim
    int64 tensor on the device. ``cfg.packed_state``: the state argument
    and result are PackedFleets, unpacked and repacked inside the round
    (inside each chunk under fleet_chunks > 1). Under fleet_chunks > 1 the
    round writes its results into the state and inbox it was given (their
    contiguous leaves; the JAX program donates them), so a caller that
    needs its input afterwards passes a copy."""
    if cfg.packed_state and 2 * cfg.election_tick >= (1 << PACK_TIMER_BITS):
        raise ValueError(
            f"packed_state timer lanes hold {PACK_TIMER_BITS} bits; "
            f"election_tick={cfg.election_tick} needs 2*T < {1 << PACK_TIMER_BITS}")
    M = spec.M

    def core(state, inbox: Msg, prop_len, prop_data, prop_type,
             ri_ctx, do_hup, do_tick, keep_mask):
        if cfg.packed_state:
            state = unpack_fleet(spec, state)
        if cfg.wire_int16:
            inbox = from_wire(inbox)
        if cfg.compact_wire:
            slots = _unflatten_compact(spec, inbox)        # [B, to, (E,) C]
        else:
            slots = _unflatten_inbox(spec, inbox).map(     # [from*K, to, (E,) C]
                lambda _, x: x.reshape((M * spec.K,) + x.shape[2:]))
        state, ob = node_round(cfg, spec, state, slots, prop_len, prop_data,
                               prop_type, ri_ctx, do_hup, do_tick)
        msgs = ob.msgs                                     # [from, K, to, (E,) C]
        emitted = (msgs.type != 0).sum() if with_drop_count else None
        # self-loops (MsgHup-to-self) are local, never subject to faults
        eye = torch.eye(M, dtype=torch.bool, device=keep_mask.device)
        keep = keep_mask | eye.unsqueeze(-1)
        msgs = msgs.replace(type=torch.where(keep.unsqueeze(1), msgs.type, 0))
        if cfg.compact_wire:
            nxt = compact_wire_carry(
                spec, msgs, cfg.inbox_bound,
                torch.int16 if cfg.wire_int16 else torch.int32)
        else:
            nxt = _flatten_inbox(spec, msgs)
            if cfg.wire_int16:
                nxt = to_wire(nxt)
        if cfg.packed_state:
            state = pack_fleet(spec, state)
        else:
            state = state.map(lambda _, x: x.contiguous())
        if with_drop_count:
            return state, nxt, emitted - (nxt.type != 0).sum()
        return state, nxt

    if cfg.fleet_chunks <= 1:
        return core

    def round_fn(state, inbox, *rest):
        # the clusters axis is independent and trailing: run the round on
        # contiguous copies of each C-slice in turn and write each chunk's
        # results back into the leaves it was cut from (the chunks are
        # disjoint, and a slice is copied out before it is overwritten), so
        # one fleet stays resident beside one chunk's temps
        C = state.rng_key.shape[-1]
        chunks = cfg.fleet_chunks
        if C % chunks:
            return core(state, inbox, *rest)
        csz = C // chunks
        # a strided leaf cannot take the writes: give it contiguous storage
        state, inbox = (t.map(lambda _, x: x.contiguous()) for t in (state, inbox))
        dropped = 0
        for i in range(chunks):
            sl = slice(i * csz, (i + 1) * csz)

            def cut(x):
                return x[..., sl].contiguous()

            part = core(state.map(lambda _, x: cut(x)), inbox.map(lambda _, x: cut(x)),
                        *[cut(r) for r in rest])
            for full, p in zip((state, inbox), part[:2]):
                for name, x in p.items():
                    getattr(full, name)[..., sl].copy_(x)
            if with_drop_count:
                dropped = dropped + part[2]
        if with_drop_count:
            return state, inbox, dropped
        return state, inbox

    return round_fn


def build_kv_round(cfg: RaftConfig, spec: Spec, kvspec: KVSpec, member: int = 0):
    """Round step with the device MVCC apply plane fused in
    (etcd_tpu/models/engine.py build_kv_round): the consensus round, then up
    to Spec.A committed entry words taken from ``member``'s apply frontier
    into a ``KVState`` fleet, then the watch-delta scan.

    Returns kv_round_fn(state, inbox, kv, do_apply, *round_args) ->
    (state, inbox, kv, delta). ``do_apply`` is a runtime operand ([C] bool,
    or one bool): False leaves the KV fleet as it was, so one program (one
    CUDA graph, see KVRound) serves both apply modes.

    The plane consumes the entries in (kv.applied_idx, state.applied[member]],
    the entries the node itself just applied to its hash chain, so it moves
    at the same <= A-per-round cadence. A word is lost only once a newer
    entry overwrites its ring slot (idx <= last_index - L); lost words are
    counted in kv.skipped and the cursor jumps. A member that installs a
    peer snapshot keeps its old ring bytes under new cursors; ring apply
    moves ``applied`` by at most A a round, so a larger jump is an install,
    and the lane freezes with the sticky kv.desynced set rather than replay
    stale words. Conf-change and empty entries decode as NOPs.

    The round writes into the state it is given under fleet_chunks > 1, so
    the bound member's pre-round ``applied`` is copied before it runs. The
    KV update is functional: the returned ``kv`` and ``delta`` are new
    tensors. KV words use bits 0-27, so the plane needs the int32 wire, and
    it reads the unpacked fleet and the dense wire."""
    if cfg.wire_int16:
        raise ValueError(
            "build_kv_round needs the int32 wire (KV op words use bits "
            "0-27); construct the engine with wire_int16=False")
    if cfg.packed_state or cfg.compact_wire:
        raise ValueError(
            "build_kv_round reads the unpacked fleet (log ring, applied "
            "cursor); construct it with packed_state=False and "
            "compact_wire=False")
    base = build_round(cfg, spec)
    L, A = spec.L, spec.A

    def kv_round_fn(state, inbox, kv: KVState, do_apply, *args):
        pre_applied = state.applied[member].clone()          # [C]
        rev_floor = kv.current_rev.clone()
        state, inbox = base(state, inbox, *args)
        do_apply = torch.as_tensor(do_apply, dtype=torch.bool,
                                   device=kv.current_rev.device).expand(rev_floor.shape)
        applied = state.applied[member]                      # [C]
        ld = state.log_data[member]                          # [L, C]
        lt = state.log_type[member]
        desynced = kv.desynced | (do_apply & (applied - pre_applied > A))
        live = do_apply & ~desynced
        # ring-overwrite overrun: a slot is gone only once a newer entry
        # lands on it; count the lost words and jump the cursor
        floor = torch.clamp(state.last_index[member] - L, min=0)
        lost = torch.where(live, torch.clamp(floor - kv.applied_idx, min=0), 0)
        kv = kv.replace(desynced=desynced, skipped=kv.skipped + lost,
                        applied_idx=torch.where(live, torch.maximum(kv.applied_idx, floor),
                                                kv.applied_idx))
        for _ in range(A):
            idx = kv.applied_idx + 1
            can = live & (idx <= applied)
            slot = ((idx - 1) % L).long().unsqueeze(0)       # [1, C]
            word = ld.gather(0, slot)[0]
            etype = lt.gather(0, slot)[0]
            word = torch.where(can & (etype == ENTRY_NORMAL), word, 0)
            kv = apply_word(kvspec, kv, word, can)
            kv = kv.replace(applied_idx=torch.where(can, idx, kv.applied_idx))
        return state, inbox, kv, extract_deltas(kvspec, rev_floor, kv)

    return kv_round_fn


class KVRound:
    """The KV round as a program served once a round (JAX's
    ``_jitted_kv_round``): ``rnd(state, inbox, kv, do_apply, *round_args)
    -> (state, inbox, kv, delta)``. On a CUDA device each call is one
    replay of a CUDA graph of ``build_kv_round``'s round (parallel/mesh.py
    CapturedStep: the first call runs one eager warm-up round and captures),
    whose static carry holds the state, inbox, KV fleet, delta, the
    ``do_apply`` lanes and the round inputs, so one graph serves both apply
    modes. The results are that carry: the next call overwrites them, so a
    caller reads them (or clones them) before it. On the CPU each call is
    the eager round."""

    def __init__(self, cfg: RaftConfig, spec: Spec, kvspec: KVSpec, member: int = 0):
        # parallel/mesh.py imports this module
        from etcd_tpu_torch.parallel.mesh import CapturedStep

        self.fn = build_kv_round(cfg, spec, kvspec, member)
        self.kvspec = kvspec
        self.graph = CapturedStep(self._step)

    def _step(self, carry):
        state, inbox, kv, _, do_apply, *args = carry
        return (*self.fn(state, inbox, kv, do_apply, *args), do_apply, *args)

    def __call__(self, state, inbox, kv: KVState, do_apply, *args):
        dev = kv.current_rev.device
        if dev.type == "cpu":
            return self.fn(state, inbox, kv, do_apply, *args)
        if dev.type != "cuda":
            raise ValueError(f"KVRound: no driver for device {dev}")
        C = kv.current_rev.shape[0]
        do_apply = torch.as_tensor(do_apply, dtype=torch.bool, device=dev).expand(C)
        carry = self.graph.carry
        # the delta slot of the carry is written, never read: the first call
        # fills it with a delta of the right shape
        delta = carry[3] if carry is not None else extract_deltas(
            self.kvspec, kv.current_rev, kv)
        out = self.graph((state, inbox, kv, delta, do_apply.contiguous(), *args))
        return out[:4]

    def release(self) -> None:
        self.graph.release()


class RaftEngine:
    """Lockstep driver for a fleet of C x M-member Raft groups
    (etcd_tpu/models/engine.py RaftEngine): the fleet, its inbox and the
    keep-mask, stepped by ``build_round``. Every round's inputs stay live
    (no donation), so a caller may keep ``engine.state`` across steps.

    On a CUDA device each step is one replay of a CUDA graph of the round
    (parallel/mesh.py CapturedStep; the first step runs one eager warm-up
    round and captures) over a static carry of the state, inbox, round
    inputs and keep-mask, which the host writes before each replay: a step
    of a small fleet is over a hundred thousand kernels, which the host
    cannot launch one by one at the card's pace. ``engine.state`` and
    ``engine.inbox`` are then that carry: the next step overwrites them, so
    a caller that keeps a state across steps clones it; one that replaces a
    leaf (``Cluster.set_node``) has it copied in before the next replay. On
    the CPU the step is the eager round."""

    def __init__(self, spec: Spec = Spec(), cfg: RaftConfig = RaftConfig(),
                 C: int = 1, voters=None, learners=None, seed: int = 0,
                 device=None):
        self.spec, self.cfg, self.C = spec, cfg, C
        self.device = resolve_device(device)
        self.graph = None
        if self.device.type == "cuda":
            # parallel/mesh.py imports this module
            from etcd_tpu_torch.parallel.mesh import CapturedStep

            self.graph = CapturedStep(self._graph_step)
        self.state = init_fleet(spec, C, voters, learners, seed,
                                election_tick=cfg.election_tick, device=self.device)
        if cfg.packed_state:
            self.state = pack_fleet(spec, self.state)
        self.inbox = empty_inbox(
            spec, C, wire_int16=cfg.wire_int16,
            compact_bound=cfg.inbox_bound if cfg.compact_wire else 0,
            device=self.device)
        self.keep_mask = torch.ones((spec.M, spec.M, C), dtype=torch.bool,
                                    device=self.device)
        self._round = build_round(cfg, spec)

    def step(self, prop_len=None, prop_data=None, prop_type=None, ri_ctx=None,
             do_hup=None, do_tick=False):
        """Inputs in the device layout (numpy arrays or tensors):
        prop_len/ri_ctx/do_hup/do_tick [M, C]; prop_data/prop_type [M, E, C].
        A missing input is zero; ``do_tick`` may be one bool for all."""
        C, M, E = self.C, self.spec.M, self.spec.E
        dev = self.device

        def arg(x, shape, dtype):
            if x is None:
                return torch.zeros(shape, dtype=dtype, device=dev)
            return torch.as_tensor(x).to(device=dev, dtype=dtype)

        if isinstance(do_tick, bool):
            do_tick = torch.full((M, C), do_tick, dtype=torch.bool, device=dev)
        i32, b = torch.int32, torch.bool
        args = (arg(prop_len, (M, C), i32), arg(prop_data, (M, E, C), i32),
                arg(prop_type, (M, E, C), i32), arg(ri_ctx, (M, C), i32),
                arg(do_hup, (M, C), b), arg(do_tick, (M, C), b), self.keep_mask)
        if self.graph is not None:
            self.state, self.inbox = self.graph((self.state, self.inbox, *args))[:2]
        else:
            self.state, self.inbox = self._round(self.state, self.inbox, *args)
        return self.state

    def _graph_step(self, carry):
        state, inbox, *args = carry
        return (*self._round(state, inbox, *args), *args)

    def pending_messages(self) -> int:
        return int((self.inbox.type != 0).sum())
