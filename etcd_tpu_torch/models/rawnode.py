"""RawNode: the synchronous per-group driver contract over the round's
functions (etcd_tpu/models/rawnode.py).

The reference's ``RawNode`` (raft/rawnode.go:34-241) is the thread-unsafe
API every etcd server drives: mutate the state machine via Campaign /
Propose / Step / Tick, then harvest pending work as an immutable ``Ready``
batch (raft/node.go:52-90), persist/send/apply it, and ``Advance``. Here a
RawNode owns one *lane*: a single node's ``NodeState`` as a batch of one
(N = 1, C = 1), stepped by the same ``process_message`` /
``tick_timers`` / ``apply_round`` functions that ``node_round`` runs for a
fleet (etcd_tpu_torch/models/raft.py).

How a lane runs. Between calls the lane lives on the host as one int32
vector (:class:`Lane`: every ``NodeState`` leaf flattened, bools as 0/1,
the PRNG key as its bit patterns), so every reader (``has_ready``,
``ready``, ``status``, ``DeviceLaneStorage``) reads host memory and the
host-side writes (``ready`` clearing ``rs_count``, ``compact_to`` moving
the snapshot cursor) are writes into that vector. A call of one of the
three lane functions copies the lane and the message's words into one
device buffer, runs the function there, and copies back one buffer holding
the new lane and the outbox: one copy each way, one device sync per call.
On a CUDA card each function is a ``CapturedStep`` (parallel/mesh.py)
over those two static buffers, shared by every RawNode with the same
(cfg, spec, device) as the JAX package's ``jax.jit`` kernels are, so a call
is one graph replay; inside ``eager_lanes()`` it runs eagerly instead. On
the CPU it runs eagerly under ``utils/device.py eager_mode``.

Ready/Advance accounting mirrors rawnode.go:125-179: prev Soft/HardState
are remembered at Ready() (acceptReady) and committed at Advance();
MustSync follows node.go:586-593 (term or vote changed, or new entries).

Differences from the reference (deliberate, as in the JAX package):
  * Snapshots restore eagerly inside the step (models/raft.py
    handle_snapshot); Ready still surfaces the snapshot so the application
    can persist it, but the in-memory log has already adopted it.
  * Conf changes are applied at apply time (inside ``apply_round``) rather
    than via an explicit ApplyConfChange call; Advance() therefore both
    advances the applied cursor and performs the config switch, and
    `last_conf_states` reports switches for drivers that want the
    reference's return value.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from etcd_tpu_torch.models import raft as raftmod
from etcd_tpu_torch.models.state import NodeState, init_node
from etcd_tpu_torch.ops.outbox import Outbox, empty_outbox, make_msg
from etcd_tpu_torch.parallel.mesh import CapturedStep
from etcd_tpu_torch.storage.raftstorage import (
    ConfState,
    Entry,
    ErrCompacted,
    ErrUnavailable,
    HardState,
    Snapshot,
    SnapshotMeta,
    Storage,
)
from etcd_tpu_torch.types import (
    CAMPAIGN_NONE,
    ENT_FIELDS,
    ENTRY_CONF_CHANGE,
    ENTRY_NORMAL,
    MSG_HUP,
    MSG_NONE,
    MSG_PROP,
    MSG_READ_INDEX,
    MSG_SNAP,
    PR_PROBE,
    PR_REPLICATE,
    PR_SNAPSHOT,
    ROLE_CANDIDATE,
    ROLE_FOLLOWER,
    ROLE_LEADER,
    ROLE_PRE_CANDIDATE,
    Msg,
    Spec,
)
from etcd_tpu_torch.utils.config import RaftConfig
from etcd_tpu_torch.utils.device import eager_mode, resolve_device

ROLE_NAMES = {
    ROLE_FOLLOWER: "StateFollower",
    ROLE_PRE_CANDIDATE: "StatePreCandidate",
    ROLE_CANDIDATE: "StateCandidate",
    ROLE_LEADER: "StateLeader",
}

# IsResponseMsg (raft/util.go:47-50)
_RESPONSE_TYPES = {
    2, 4, 7, 9, 15,  # AppResp, VoteResp, HeartbeatResp, PreVoteResp, Unreachable
}


class ErrStepLocalMsg(Exception):
    """raft: cannot step raft local message (rawnode.go:70-72)."""


class ErrStepPeerNotFound(Exception):
    """raft: cannot step as peer not found (rawnode.go:74-78)."""


PR_NAMES = {PR_PROBE: "StateProbe", PR_REPLICATE: "StateReplicate",
            PR_SNAPSHOT: "StateSnapshot"}


@dataclasses.dataclass
class HostMsg:
    """Host-side message record (raftpb.Message analog with explicit to)."""

    type: int
    to: int
    frm: int
    term: int = 0
    index: int = 0
    log_term: int = 0
    commit: int = 0
    reject: bool = False
    reject_hint: int = 0
    context: int = 0
    entries: tuple[Entry, ...] = ()
    snapshot: Snapshot | None = None  # MsgSnap only


@dataclasses.dataclass
class SoftState:
    lead: int
    role: int  # ROLE_*


@dataclasses.dataclass
class ReadState:
    index: int
    request_ctx: int


@dataclasses.dataclass
class Ready:
    """The pending-work batch (raft/node.go:52-90)."""

    soft_state: SoftState | None = None
    hard_state: HardState | None = None  # None == unchanged (empty)
    read_states: list[ReadState] = dataclasses.field(default_factory=list)
    entries: list[Entry] = dataclasses.field(default_factory=list)
    snapshot: Snapshot | None = None
    committed_entries: list[Entry] = dataclasses.field(default_factory=list)
    messages: list[HostMsg] = dataclasses.field(default_factory=list)
    must_sync: bool = False

    # Advance bookkeeping (acceptReady cursors)
    _commit_bound: int = 0


@dataclasses.dataclass
class Progress:
    """tracker.Progress snapshot (tracker/progress.go:30-80)."""

    match: int
    next: int
    state: int  # PR_*
    is_learner: bool
    paused: bool
    pending_snapshot: int
    recent_active: bool
    inflight: int
    inflight_full: bool

    def __str__(self) -> str:
        out = f"{PR_NAMES[self.state]} match={self.match} next={self.next}"
        if self.is_learner:
            out += " learner"
        if self.paused:
            out += " paused"
        if self.pending_snapshot > 0:
            out += f" pendingSnap={self.pending_snapshot}"
        if not self.recent_active:
            out += " inactive"
        if self.inflight > 0:
            out += f" inflight={self.inflight}"
            if self.inflight_full:
                out += "[full]"
        return out


@dataclasses.dataclass
class Status:
    """raft.Status/BasicStatus (raft/status.go:26-76)."""

    id: int
    hard_state: HardState
    soft_state: SoftState
    applied: int
    progress: dict[int, Progress]
    conf_state: ConfState


# ---------------------------------------------------------------------------
# the lane's flat layout
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def lane_layout(spec: Spec):
    """NodeState field -> (offset, per-node shape, kind) in the flat lane
    vector, kind "int", "bool" or "key" (the PRNG key's uint32 bit
    patterns); and the vector's length."""
    n = init_node(spec, torch.zeros((1, 1), dtype=torch.int32),
                  torch.ones((1, spec.M, 1), dtype=torch.bool))
    layout, off = {}, 0
    for name, leaf in n.items():
        shape = tuple(leaf.shape[1:-1])
        kind = "bool" if leaf.dtype == torch.bool else \
            "key" if name == "rng_key" else "int"
        layout[name] = (off, shape, kind)
        off += int(np.prod(shape, dtype=np.int64))
    return layout, off


def flatten_lane(n: NodeState) -> torch.Tensor:
    """A lane (leaves [1, ..., 1]) -> int32 [S], in NodeState field order."""
    return torch.cat([leaf.reshape(-1).to(torch.int32) for _, leaf in n.items()])


def unflatten_lane(spec: Spec, flat: torch.Tensor) -> NodeState:
    """The inverse of flatten_lane (views of ``flat``, bools compared)."""
    layout, _ = lane_layout(spec)
    out = {}
    for name, (off, shape, kind) in layout.items():
        size = int(np.prod(shape, dtype=np.int64))
        x = flat[off:off + size].view((1,) + shape + (1,))
        out[name] = x != 0 if kind == "bool" else x
    return NodeState(**out)


class Lane:
    """A node's lane on the host: the flat int32 vector and attribute reads
    of it in the JAX package's per-node shapes (a scalar field is a Python
    int or bool, a vector field a numpy array; the PRNG key uint32). Reads
    return copies; ``replace`` returns a new Lane."""

    __slots__ = ("spec", "w")

    def __init__(self, spec: Spec, w: np.ndarray):
        self.spec, self.w = spec, w

    def __getattr__(self, name):
        if name in Lane.__slots__:       # not set yet (a copy being made)
            raise AttributeError(name)
        try:
            off, shape, kind = lane_layout(self.spec)[0][name]
        except KeyError:
            raise AttributeError(name) from None
        if not shape:
            v = int(self.w[off])
            return bool(v) if kind == "bool" else v
        a = self.w[off:off + int(np.prod(shape))].reshape(shape)
        if kind == "bool":
            return a != 0
        return a.view(np.uint32).copy() if kind == "key" else a.copy()

    def replace(self, **kw) -> "Lane":
        layout = lane_layout(self.spec)[0]
        w = self.w.copy()
        for name, v in kw.items():
            off, shape, _ = layout[name]
            a = np.asarray(v).astype(np.int64).reshape(-1)
            w[off:off + a.size] = a.astype(np.int32)
        return Lane(self.spec, w)

    def to_numpy(self) -> dict:
        """Field -> array, as ``np.asarray`` of the JAX package's per-node
        NodeState leaf gives it (bool, int32, the key uint32)."""
        out = {}
        for name, (off, shape, kind) in lane_layout(self.spec)[0].items():
            a = self.w[off:off + int(np.prod(shape, dtype=np.int64))].reshape(shape)
            out[name] = a != 0 if kind == "bool" else \
                a.view(np.uint32).copy() if kind == "key" else a.copy()
        return out


# ---------------------------------------------------------------------------
# messages to and from the device
# ---------------------------------------------------------------------------

def _msg_width(spec: Spec) -> int:
    return len(Msg.names()) + (spec.E - 1) * len(ENT_FIELDS)


def msg_words(spec: Spec, hm: HostMsg) -> np.ndarray:
    """A HostMsg as the int32 words of a device Msg, in Msg field order
    (the ent fields E words each), as host_to_device_msg lays it out."""
    ents = hm.entries[: spec.E]
    f = dict(
        type=hm.type, term=hm.term, frm=hm.frm, index=hm.index,
        log_term=hm.log_term, commit=hm.commit, reject=int(hm.reject),
        reject_hint=hm.reject_hint, context=hm.context, ent_len=len(ents),
        c_voters=0, c_voters_out=0, c_learners=0, c_learners_next=0,
    )
    if hm.snapshot is not None:
        meta = hm.snapshot.meta
        cs = meta.conf_state
        v, vo, l, ln_ = cs.masks(spec.M)
        pack = lambda m: sum(1 << i for i in range(spec.M) if m[i])  # noqa: E731
        f.update(
            # app_hash split across commit/reject_hint, matching the
            # device MsgSnap emit (models/raft.py maybe_send_append)
            index=meta.index, log_term=meta.term, commit=meta.app_hash,
            reject_hint=(meta.app_hash >> 16) & 0xFFFF,
            reject=int(cs.auto_leave),
            c_voters=pack(v), c_voters_out=pack(vo), c_learners=pack(l),
            c_learners_next=pack(ln_),
        )
    ent = {k: np.zeros((spec.E,), np.int64) for k in ENT_FIELDS}
    for j, e in enumerate(ents):
        ent["ent_term"][j], ent["ent_data"][j], ent["ent_type"][j] = \
            e.term, e.data, e.type
    words = [np.asarray(ent[k]) if k in ENT_FIELDS else np.asarray([f[k]])
             for k in Msg.names()]
    return np.concatenate(words).astype(np.int32)


def unflatten_msg(spec: Spec, flat: torch.Tensor) -> Msg:
    """int32 words in Msg field order -> a Msg of [1, 1] ([1, E, 1]) views."""
    out, off = {}, 0
    for k in Msg.names():
        size = spec.E if k in ENT_FIELDS else 1
        x = flat[off:off + size].view((1, spec.E, 1) if k in ENT_FIELDS else (1, 1))
        out[k] = x != 0 if k == "reject" else x
        off += size
    return Msg(**out)


def host_to_device_msg(spec: Spec, hm: HostMsg, device=None) -> Msg:
    """HostMsg -> device Msg (the inbox slot format, etcd_tpu_torch/types.py)
    as a batch of one, on ``device`` (None: the card)."""
    words = torch.from_numpy(msg_words(spec, hm)).to(resolve_device(device))
    return unflatten_msg(spec, words)


def flatten_outbox(ob: Outbox) -> torch.Tensor:
    """A lane's outbox -> int32 words: the counts [M], then each Msg field
    [K, M] ([K, M, E]) in Msg field order."""
    parts = [ob.counts.reshape(-1)]
    parts += [leaf.reshape(-1).to(torch.int32) for _, leaf in ob.msgs.items()]
    return torch.cat(parts)


def _outbox_width(spec: Spec) -> int:
    K, M, E = spec.K, spec.M, spec.E
    return M + sum(K * M * (E if k in ENT_FIELDS else 1) for k in Msg.names())


def _unflatten_outbox_words(spec: Spec, w: np.ndarray):
    K, M, E = spec.K, spec.M, spec.E
    counts, off, f = w[:M], M, {}
    for k in Msg.names():
        shape = (K, M, E) if k in ENT_FIELDS else (K, M)
        size = int(np.prod(shape))
        f[k] = w[off:off + size].reshape(shape)
        off += size
    return counts, f


def _fields_to_host(spec: Spec, counts: np.ndarray, f: dict) -> list[HostMsg]:
    """Harvest [K, M(dest), (E)] outbox fields into HostMsgs,
    destination-major then slot order (the reference emits per-peer in
    sorted-id order via tracker.Visit, tracker/tracker.go:191-213, so this
    matches)."""
    if int(counts.sum()) == 0:
        return []
    out: list[HostMsg] = []
    for to in range(spec.M):
        for k in range(int(counts[to])):
            t = int(f["type"][k, to])
            if t == MSG_NONE:
                continue
            ents: tuple[Entry, ...] = ()
            if int(f["ent_len"][k, to]) > 0:
                base = int(f["index"][k, to])
                ents = tuple(
                    Entry(
                        index=base + 1 + j,
                        term=int(f["ent_term"][k, to, j]),
                        type=int(f["ent_type"][k, to, j]),
                        data=int(f["ent_data"][k, to, j]),
                    )
                    for j in range(int(f["ent_len"][k, to]))
                )
            snap = None
            if t == MSG_SNAP:
                ub = lambda w: [bool((int(w) >> i) & 1) for i in range(spec.M)]  # noqa: E731
                cs = ConfState.from_masks(
                    ub(f["c_voters"][k, to]),
                    ub(f["c_voters_out"][k, to]),
                    ub(f["c_learners"][k, to]),
                    ub(f["c_learners_next"][k, to]),
                    bool(f["reject"][k, to]),
                )
                # reassemble the split app hash (device MsgSnap wire
                # format, models/raft.py maybe_send_append)
                raw = (
                    (int(f["reject_hint"][k, to]) << 16)
                    | (int(f["commit"][k, to]) & 0xFFFF)
                ) & 0xFFFFFFFF
                snap = Snapshot(
                    meta=SnapshotMeta(
                        index=int(f["index"][k, to]),
                        term=int(f["log_term"][k, to]),
                        conf_state=cs,
                        app_hash=raw - (1 << 32) if raw >= 1 << 31 else raw,
                    )
                )
            out.append(
                HostMsg(
                    type=t, to=to, frm=int(f["frm"][k, to]),
                    term=int(f["term"][k, to]),
                    index=0 if t == MSG_SNAP else int(f["index"][k, to]),
                    log_term=0 if t == MSG_SNAP else int(f["log_term"][k, to]),
                    commit=0 if t == MSG_SNAP else int(f["commit"][k, to]),
                    reject=False if t == MSG_SNAP else bool(f["reject"][k, to]),
                    reject_hint=0 if t == MSG_SNAP
                    else int(f["reject_hint"][k, to]),
                    context=int(f["context"][k, to]),
                    entries=ents,
                    snapshot=snap,
                )
            )
    return out


def outbox_to_host(spec: Spec, ob: Outbox) -> list[HostMsg]:
    """Harvest a lane's device Outbox (leaves [1, K, M(dest), (E,) 1]) into
    HostMsgs, destination-major then slot order."""
    w = flatten_outbox(ob).cpu().numpy()
    return _fields_to_host(spec, *_unflatten_outbox_words(spec, w))


# ---------------------------------------------------------------------------
# the three lane functions
# ---------------------------------------------------------------------------

class LaneFunction:
    """One lane function, ``words -> words``: the input is the flat lane
    followed by a message's words, the output the new flat lane followed
    by the outbox's words. ``kind`` "step" is process_message, "tick"
    tick_timers with its synchronous MsgHup, "apply" apply_round, each over
    ``cfg`` as given, every message type and entry type handled (the JAX
    package's _kernels). On a CUDA card with ``graph`` it is a CapturedStep
    over a static input and output buffer; otherwise it runs eagerly.
    ``calls`` counts the calls."""

    def __init__(self, cfg: RaftConfig, spec: Spec, kind: str, device, graph: bool):
        self.cfg, self.spec, self.kind, self.device = cfg, spec, kind, device
        self.S = lane_layout(spec)[1]
        self.width_in = self.S + _msg_width(spec)
        self.graph = CapturedStep(self._carry) if graph else None
        self.inp = self.out = None
        self.calls = 0

    def fn(self, inp: torch.Tensor) -> torch.Tensor:
        """The function itself over one input buffer."""
        cfg, spec = self.cfg, self.spec
        n = unflatten_lane(spec, inp[:self.S])
        ob = empty_outbox(spec, (1, 1), inp.device)
        if self.kind == "step":
            n, ob = raftmod.process_message(cfg, spec, n, ob,
                                            unflatten_msg(spec, inp[self.S:]))
        elif self.kind == "tick":
            on = torch.ones((1, 1), dtype=torch.bool, device=inp.device)
            n, ob, fire = raftmod.tick_timers(cfg, spec, n, ob, on)
            # tickElection runs the campaign synchronously (raft.go:645-654)
            hup = make_msg(spec, n.nid, frm=n.nid,
                           type=torch.where(fire, MSG_HUP, MSG_NONE),
                           context=CAMPAIGN_NONE)
            n, ob = raftmod.process_message(cfg, spec, n, ob, hup)
        else:
            n, ob = raftmod.apply_round(cfg, spec, n, ob)
        return torch.cat([flatten_lane(n), flatten_outbox(ob)])

    def _carry(self, carry):
        inp, _ = carry
        return inp, self.fn(inp)

    def __call__(self, words: np.ndarray) -> np.ndarray:
        self.calls += 1
        host = torch.from_numpy(words)
        if self.device.type == "cpu":
            with eager_mode(self.device):
                return self.fn(host).numpy()
        if self.inp is None:
            self.inp = torch.zeros((self.width_in,), dtype=torch.int32,
                                   device=self.device)
        self.inp.copy_(host)
        if self.graph is None:
            return self.fn(self.inp).cpu().numpy()
        if self.out is None:     # the capture's carry: its output is written in place
            self.out = torch.zeros((self.S + _outbox_width(self.spec),),
                                   dtype=torch.int32, device=self.device)
        self.inp, self.out = self.graph((self.inp, self.out))
        return self.out.cpu().numpy()


_EAGER_LANES = False


@contextlib.contextmanager
def eager_lanes():
    """Lane calls made inside run eagerly on a card instead of replaying
    the lane functions' CUDA graphs (the graph-against-eager check)."""
    global _EAGER_LANES
    before, _EAGER_LANES = _EAGER_LANES, True
    try:
        yield
    finally:
        _EAGER_LANES = before


@functools.lru_cache(maxsize=256)
def lane_function(cfg: RaftConfig, spec: Spec, device: torch.device, graph: bool,
                  kind: str) -> LaneFunction:
    """The lane function every RawNode with this (cfg, spec) on ``device``
    shares, as the JAX package's jitted kernels are shared."""
    return LaneFunction(cfg, spec, kind, device, graph)


class RawNode:
    """Single-group driver with Ready/Advance accounting
    (raft/rawnode.go:34-241), state stepped by the fleet's functions.
    ``device`` None is the CUDA card (raises where there is none). On a
    card a call replays its lane function's CUDA graph (eagerly inside
    ``eager_lanes()``); elsewhere it runs eagerly."""

    def __init__(
        self,
        cfg: RaftConfig,
        spec: Spec,
        storage: Storage,
        nid: int,
        applied: int | None = None,
        seed: int = 0,
        device=None,
    ):
        self.cfg, self.spec, self.storage = cfg, spec, storage
        self.nid = nid
        self.device = resolve_device(device)
        self.n = self._boot(storage, nid, applied, seed)
        self._pending_msgs: list[HostMsg] = []
        self._pending_snap: Snapshot | None = None
        self._stable_to = int(self.n.last_index)
        # stable-entry cache: what the application has persisted so far.
        # The device ring is truncate-and-append (maybe_append) like the
        # reference's unstable log (log_unstable.go:121-156); when a new
        # leader overwrites a stable suffix, Ready must re-emit it, so we
        # diff the ring against this cache after every step.
        self._stable_ents: dict[int, tuple[int, int, int]] = {
            e.index: (e.term, e.type, e.data)
            for e in self.ring_entries(
                int(self.n.snap_index) + 1, self._stable_to + 1
            )
        }
        self.prev_hs = self._hard_state()
        self.prev_ss = self._soft_state()
        self.last_conf_states: list[ConfState] = []

    # -- boot (newRaft, raft.go:318-370) ------------------------------------
    def _boot(self, storage: Storage, nid, applied, seed) -> Lane:
        spec, cfg, dev = self.spec, self.cfg, self.device
        hs, cs = storage.initial_state()
        snap = storage.snapshot()
        v, vo, l, ln_ = cs.masks(spec.M)
        mask = lambda a: torch.from_numpy(a).view(1, spec.M, 1).to(dev)  # noqa: E731
        with eager_mode(dev):
            n = init_node(
                spec, torch.full((1, 1), nid, dtype=torch.int32, device=dev),
                mask(v), mask(l), seed=seed, election_tick=cfg.election_tick,
            )
            lane = Lane(spec, flatten_lane(n).cpu().numpy().copy())
        first, last = storage.first_index(), storage.last_index()
        # the ring base is the storage's truncation point, which can sit
        # past the retained snapshot (MemoryStorage.Compact moves only the
        # offset); the device collapses both to one snapshot cursor
        si = first - 1
        s_term = storage.term(si) if si > 0 else 0
        L = spec.L
        if last - si > L:
            raise ValueError(
                f"storage holds {last - si} entries > ring capacity {L}"
            )
        lt = np.zeros((L,), np.int32)
        ld = np.zeros((L,), np.int32)
        ly = np.zeros((L,), np.int32)
        for e in storage.entries(first, last + 1):
            s = (e.index - 1) % L
            lt[s], ld[s], ly[s] = e.term, e.data, e.type
        applied = max(applied if applied is not None else 0, si)
        return lane.replace(
            term=hs.term,
            vote=hs.vote,
            commit=max(hs.commit, si),
            applied=applied,
            last_index=last,
            snap_index=si,
            snap_term=s_term,
            snap_hash=snap.meta.app_hash,
            applied_hash=snap.meta.app_hash,
            log_term=lt,
            log_data=ld,
            log_type=ly,
            voters=v, voters_out=vo,
            learners=l, learners_next=ln_,
            auto_leave=cs.auto_leave,
            snap_voters=v, snap_voters_out=vo,
            snap_learners=l,
            snap_learners_next=ln_,
            snap_auto_leave=cs.auto_leave,
        )

    # -- running the lane functions -----------------------------------------
    def _call(self, kind: str, words: np.ndarray | None = None) -> None:
        """One lane function over the lane (and a message's words): the new
        lane replaces this one, the outbox joins the pending messages."""
        graph = self.device.type == "cuda" and not _EAGER_LANES
        fn = lane_function(self.cfg, self.spec, self.device, graph, kind)
        if words is None:
            words = np.zeros((_msg_width(self.spec),), np.int32)
        out = fn(np.concatenate([self.n.w, words]))
        S = self.n.w.size
        self.n = Lane(self.spec, out[:S].copy())
        self._pending_msgs.extend(_fields_to_host(
            self.spec, *_unflatten_outbox_words(self.spec, out[S:])))

    # -- state readers -------------------------------------------------------
    def _hard_state(self) -> HardState:
        n = self.n
        return HardState(int(n.term), int(n.vote), int(n.commit))

    def _soft_state(self) -> SoftState:
        n = self.n
        return SoftState(int(n.lead), int(n.role))

    def ring_entries(self, lo: int, hi: int) -> list[Entry]:
        """Entries [lo, hi) read from the lane's ring."""
        n, L = self.n, self.spec.L
        lt = n.log_term
        ld = n.log_data
        ly = n.log_type
        out = []
        for i in range(lo, hi):
            s = (i - 1) % L
            out.append(Entry(index=i, term=int(lt[s]), type=int(ly[s]),
                             data=int(ld[s])))
        return out

    # -- mutators ------------------------------------------------------------
    def _run_msg(self, hm: HostMsg) -> None:
        pre_snap = int(self.n.snap_index)
        self._call("step", msg_words(self.spec, hm))
        post_snap = int(self.n.snap_index)
        if hm.type == MSG_SNAP and post_snap > pre_snap and hm.snapshot:
            # eager restore happened: surface it in the next Ready and track
            # the stable cursor jump (the ring was reset to the snapshot)
            self._pending_snap = hm.snapshot
            self._stable_to = post_snap
            self._stable_ents = {}
        else:
            self._roll_back_overwritten()

    def _roll_back_overwritten(self) -> None:
        """If the step truncate-overwrote already-stable entries
        (handleAppendEntries conflict path, models/raft.py), move the
        stable cursor back so Ready re-emits the new suffix — the analog
        of unstable.truncateAndAppend moving its offset down."""
        n = self.n
        last = int(n.last_index)
        if last < self._stable_to:
            self._stable_to = last
            for j in [j for j in self._stable_ents if j > last]:
                del self._stable_ents[j]
        if not self._stable_ents:
            return
        lo = max(int(n.snap_index) + 1, min(self._stable_ents))
        for e in self.ring_entries(lo, min(self._stable_to, last) + 1):
            want = self._stable_ents.get(e.index)
            if want is not None and want != (e.term, e.type, e.data):
                self._stable_to = e.index - 1
                for j in [j for j in self._stable_ents if j >= e.index]:
                    del self._stable_ents[j]
                break

    def tick(self) -> None:
        self._call("tick")

    def campaign(self) -> None:
        self._run_msg(HostMsg(type=MSG_HUP, to=self.nid, frm=self.nid,
                              context=CAMPAIGN_NONE))

    def propose(self, data_word: int) -> bool:
        """Returns False if the proposal was dropped (ErrProposalDropped)."""
        before = (int(self.n.last_index), len(self._pending_msgs))
        self._run_msg(
            HostMsg(
                type=MSG_PROP, to=self.nid, frm=self.nid,
                entries=(Entry(index=0, term=0, type=ENTRY_NORMAL,
                               data=data_word),),
            )
        )
        return self._prop_accepted(before)

    def propose_conf_change(self, cc_word: int) -> bool:
        before = (int(self.n.last_index), len(self._pending_msgs))
        self._run_msg(
            HostMsg(
                type=MSG_PROP, to=self.nid, frm=self.nid,
                entries=(Entry(index=0, term=0, type=ENTRY_CONF_CHANGE,
                               data=cc_word),),
            )
        )
        return self._prop_accepted(before)

    def _prop_accepted(self, before) -> bool:
        last0, msgs0 = before
        appended = int(self.n.last_index) > last0
        forwarded = any(
            m.type == MSG_PROP for m in self._pending_msgs[msgs0:]
        )
        return appended or forwarded

    def step(self, hm: HostMsg) -> None:
        """Feed an external message (Step, rawnode.go:70-79): local message
        types are refused, and response messages from peers outside the
        tracked progress set raise ErrStepPeerNotFound."""
        if hm.type in (MSG_HUP, MSG_PROP):
            raise ErrStepLocalMsg("raft: cannot step raft local message")
        if hm.type in _RESPONSE_TYPES and 0 <= hm.frm < self.spec.M:
            n = self.n
            tracked = n.voters | n.voters_out | n.learners | n.learners_next
            if not tracked[hm.frm]:
                raise ErrStepPeerNotFound(
                    "raft: cannot step as peer not found"
                )
        self._run_msg(hm)

    def read_index(self, ctx: int) -> None:
        self._run_msg(HostMsg(type=MSG_READ_INDEX, to=self.nid, frm=self.nid,
                              context=ctx))

    # -- Ready/Advance (rawnode.go:125-179) ----------------------------------
    def has_ready(self) -> bool:
        n = self.n
        if self._pending_msgs or self._pending_snap:
            return True
        if int(n.last_index) > self._stable_to:
            return True
        if self._hard_state() != self.prev_hs:
            return True
        if self._soft_state() != self.prev_ss:
            return True
        if int(n.commit) > int(n.applied):
            return True
        if int(n.rs_count) > 0:
            return True
        return False

    def ready(self) -> Ready:
        """Harvest pending work and accept it (Ready + acceptReady)."""
        n = self.n
        rd = Ready()
        ss = self._soft_state()
        if ss != self.prev_ss:
            rd.soft_state = ss
        hs = self._hard_state()
        if hs != self.prev_hs:
            rd.hard_state = hs
        rs_count = int(n.rs_count)
        if rs_count > 0:
            ctxs = n.rs_ctx[:rs_count]
            idxs = n.rs_index[:rs_count]
            rd.read_states = [
                ReadState(index=int(i), request_ctx=int(c))
                for c, i in zip(ctxs, idxs)
            ]
            self.n = self.n.replace(rs_count=0)
        last = int(n.last_index)
        if last > self._stable_to:
            rd.entries = self.ring_entries(self._stable_to + 1, last + 1)
        rd.snapshot = self._pending_snap
        applied, commit = int(n.applied), int(n.commit)
        if commit > applied:
            rd.committed_entries = self.ring_entries(applied + 1, commit + 1)
        rd.messages = self._pending_msgs
        rd.must_sync = bool(
            hs.term != self.prev_hs.term
            or hs.vote != self.prev_hs.vote
            or rd.entries
        )
        rd._commit_bound = commit
        # acceptReady
        self._pending_msgs = []
        self._pending_snap = None
        self.prev_ss = ss
        self.prev_hs = hs
        self._stable_to = last
        for e in rd.entries:
            self._stable_ents[e.index] = (e.term, e.type, e.data)
        snap_i = int(n.snap_index)
        for j in [j for j in self._stable_ents if j <= snap_i]:
            del self._stable_ents[j]
        return rd

    def advance(self, rd: Ready) -> None:
        """Apply the accepted committed entries; conf changes take effect
        in the lane (apply_round) and are reported via last_conf_states."""
        self.last_conf_states = []
        while int(self.n.applied) < rd._commit_bound:
            pre = self._conf_tuple()
            self._call("apply")
            post = self._conf_tuple()
            if post != pre:
                self.last_conf_states.append(self.conf_state())

    def _conf_tuple(self):
        n = self.n
        return (
            tuple(n.voters.tolist()),
            tuple(n.voters_out.tolist()),
            tuple(n.learners.tolist()),
            tuple(n.learners_next.tolist()),
        )

    def compact_to(self, index: int) -> None:
        """Advance the lane's snapshot cursor to `index` — the lane analog
        of MemoryStorage.Compact (raft/storage.go:208-233): entries
        <= index become unreachable and further sends below it fall back
        to MsgSnap (maybeSendAppend, raft.go:446-469)."""
        n = self.n
        if index <= int(n.snap_index):
            return
        if index > int(n.applied):
            raise ValueError(
                f"cannot compact beyond applied index {int(n.applied)}"
            )
        term = self.ring_entries(index, index + 1)[0].term
        # the applied hash at `index` equals the current hash only when
        # applied == index; otherwise the snapshot hash stays at the last
        # known point (the chain cannot be rewound)
        snap_hash = (
            int(n.applied_hash) if int(n.applied) == index
            else int(n.snap_hash)
        )
        self.n = n.replace(
            snap_index=index,
            snap_term=term,
            snap_hash=snap_hash,
            snap_voters=n.voters, snap_voters_out=n.voters_out,
            snap_learners=n.learners, snap_learners_next=n.learners_next,
            snap_auto_leave=n.auto_leave,
        )

    def conf_state(self) -> ConfState:
        n = self.n
        return ConfState.from_masks(
            n.voters, n.voters_out, n.learners, n.learners_next,
            bool(n.auto_leave),
        )

    # -- status (raft/status.go:26-76) ---------------------------------------
    def status(self) -> Status:
        n, cfg, spec = self.n, self.cfg, self.spec
        progress: dict[int, Progress] = {}
        if int(n.role) == ROLE_LEADER:
            match = n.match
            nxt = n.next_idx
            prs = n.pr_state
            probe_sent = n.probe_sent
            psnap = n.pending_snapshot
            ract = n.recent_active
            icnt = n.infl_count
            learners = n.learners | n.learners_next
            tracked = n.voters | n.voters_out | n.learners | n.learners_next
            for i in range(spec.M):
                if not tracked[i]:
                    continue
                st = int(prs[i])
                full = int(icnt[i]) >= cfg.max_inflight
                paused = (
                    bool(probe_sent[i]) if st == PR_PROBE
                    else full if st == PR_REPLICATE
                    else True
                )
                progress[i] = Progress(
                    match=int(match[i]), next=int(nxt[i]), state=st,
                    is_learner=bool(learners[i]), paused=paused,
                    pending_snapshot=int(psnap[i]),
                    recent_active=bool(ract[i]),
                    inflight=int(icnt[i]), inflight_full=full,
                )
        return Status(
            id=self.nid,
            hard_state=self._hard_state(),
            soft_state=self._soft_state(),
            applied=int(self.n.applied),
            progress=progress,
            conf_state=self.conf_state(),
        )


class DeviceLaneStorage(Storage):
    """Storage view over a live RawNode's lane — what the lane's ring itself
    would answer (InitialState/Entries/Term/.../Snapshot), with the
    reference error taxonomy (raft/storage.go:24-72)."""

    def __init__(self, rn: RawNode):
        self.rn = rn

    def initial_state(self):
        return self.rn._hard_state(), self.rn.conf_state()

    def first_index(self) -> int:
        return int(self.rn.n.snap_index) + 1

    def last_index(self) -> int:
        return int(self.rn.n.last_index)

    def entries(self, lo, hi, max_entries=None):
        if lo < self.first_index():
            raise ErrCompacted(lo)
        if hi > self.last_index() + 1:
            raise ErrUnavailable(hi)
        out = self.rn.ring_entries(lo, hi)
        if max_entries is not None:
            out = out[:max_entries]
        return out

    def term(self, i) -> int:
        n = self.rn.n
        if i == int(n.snap_index):
            return int(n.snap_term)
        if i < int(n.snap_index):
            raise ErrCompacted(i)
        if i > int(n.last_index):
            raise ErrUnavailable(i)
        return self.rn.ring_entries(i, i + 1)[0].term

    def snapshot(self) -> Snapshot:
        n = self.rn.n
        return Snapshot(
            meta=SnapshotMeta(
                index=int(n.snap_index), term=int(n.snap_term),
                conf_state=ConfState.from_masks(
                    n.snap_voters, n.snap_voters_out,
                    n.snap_learners, n.snap_learners_next,
                    bool(n.snap_auto_leave),
                ),
                app_hash=int(n.snap_hash),
            )
        )
