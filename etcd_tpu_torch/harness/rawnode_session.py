"""The RawNode slice's scripts, run the same way on either package.

A script takes a namespace of one package's names (``port_package``: this
package's models/rawnode.py, storage/{raftstorage,wal,checkpoint}.py,
harness/{mock,interaction,datadriven}.py, utils/wait.py and
examples/raftexample.py on a device; tests/make_rawnode_pins.py builds the
JAX package's with ``namespace``) and returns a JSON-able record: every
Ready (soft and hard state, entries, snapshot, committed entries, messages,
MustSync, read states), the values the JAX package's tests assert on, the
errors raised, the lanes' leaves at the end, the interaction harness's
text, and the bytes of the WAL files. tests/make_rawnode_pins.py writes the
JAX package's records to ``RAWNODE_PIN.json`` at the root of the repo; the
port's tests and chip_smoke.py phase 11 hold the port's to them. The
interaction scripts are the files of ``tests/interaction_scripts/``; both
paths are relative to the repo's root, where these run.
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import os
import pathlib
import pickle
import types

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
SCRIPTS_DIR = ROOT / "tests" / "interaction_scripts"
PIN = ROOT / "RAWNODE_PIN.json"

# the specs and configs of the JAX package's tests each script transliterates
RAWNODE_SPEC = dict(M=8, L=64, E=16, K=8, W=8, R=4, A=8)          # test_rawnode.py
RAWNODE_CFG = dict(election_tick=3, heartbeat_tick=1, max_inflight=8)
FLOW_SPEC = dict(M=3, L=16, E=2, K=4, W=2, R=2, A=4)              # test_flow_control.py
FLOW_CFG = dict(election_tick=3, heartbeat_tick=1, max_inflight=2)
MOCK_SPEC = dict(M=1, L=16, E=2, K=2, W=4, R=2, A=4)              # test_wait_mock.py:63
WAL_SEGMENT_BYTES = 256        # the WAL scripts' segment size (forces cuts)


def namespace(name, mods: dict, kw: dict, lane) -> types.SimpleNamespace:
    """A package's names for the scripts: ``mods`` maps T (types), cc
    (confchange), rs (raftstorage), wal, walcodec, ck (checkpoint), rawnode,
    mock, wait, dd (datadriven), interaction, raftexample and config to the
    package's modules; ``kw`` goes to every RawNode, InteractionEnv and
    raftexample constructor; ``lane(rn)`` gives a RawNode's leaves as numpy
    arrays, the JAX package's per-node shapes and dtypes."""
    p = types.SimpleNamespace(name=name, kw=kw, lane=lane, **mods)
    p.Spec, p.RaftConfig = p.T.Spec, p.config.RaftConfig
    p.RawNode = functools.partial(p.rawnode.RawNode, **kw)
    p.InteractionEnv = functools.partial(p.interaction.InteractionEnv, **kw)
    p.Cluster = functools.partial(p.raftexample.Cluster, **kw)
    p.RaftExampleNode = functools.partial(p.raftexample.RaftExampleNode, **kw)
    return p


def port_package(device=None) -> types.SimpleNamespace:
    """This package's names, its lanes on ``device`` (None: the card)."""
    from etcd_tpu_torch import types as T
    from etcd_tpu_torch.examples import raftexample
    from etcd_tpu_torch.harness import datadriven, interaction, mock
    from etcd_tpu_torch.models import confchange, rawnode
    from etcd_tpu_torch.storage import checkpoint, raftstorage, wal, walcodec
    from etcd_tpu_torch.utils import config, wait

    mods = dict(T=T, cc=confchange, rs=raftstorage, wal=wal, walcodec=walcodec,
                ck=checkpoint, rawnode=rawnode, mock=mock, wait=wait, dd=datadriven,
                interaction=interaction, raftexample=raftexample, config=config)
    return namespace("port", mods, dict(device=device),
                     lambda rn: rn.n.to_numpy())


# ---------------------------------------------------------------------------
# JSON views
# ---------------------------------------------------------------------------

def v_entry(e):
    return [e.index, e.term, e.type, e.data]


def v_conf(cs):
    return [list(cs.voters), list(cs.voters_outgoing), list(cs.learners),
            list(cs.learners_next), bool(cs.auto_leave)]


def v_snap(s):
    if s is None:
        return None
    m = s.meta
    return [m.index, m.term, v_conf(m.conf_state), m.app_hash, list(s.data)]


def v_msg(m):
    return [m.type, m.to, m.frm, m.term, m.index, m.log_term, m.commit,
            bool(m.reject), m.reject_hint, m.context,
            [v_entry(e) for e in m.entries], v_snap(m.snapshot)]


def v_hs(hs):
    return None if hs is None else [hs.term, hs.vote, hs.commit]


def v_ready(rd):
    return {
        "soft_state": None if rd.soft_state is None
        else [rd.soft_state.lead, rd.soft_state.role],
        "hard_state": v_hs(rd.hard_state),
        "read_states": [[r.index, r.request_ctx] for r in rd.read_states],
        "entries": [v_entry(e) for e in rd.entries],
        "snapshot": v_snap(rd.snapshot),
        "committed_entries": [v_entry(e) for e in rd.committed_entries],
        "messages": [v_msg(m) for m in rd.messages],
        "must_sync": bool(rd.must_sync),
    }


def v_status(st):
    return {
        "id": st.id, "hard_state": v_hs(st.hard_state),
        "soft_state": [st.soft_state.lead, st.soft_state.role],
        "applied": st.applied,
        "progress": {str(i): [pr.match, pr.next, pr.state, pr.is_learner,
                              pr.paused, pr.pending_snapshot, pr.recent_active,
                              pr.inflight, pr.inflight_full, str(pr)]
                     for i, pr in sorted(st.progress.items())},
        "conf_state": v_conf(st.conf_state),
    }


def v_lane(p, rn) -> dict:
    return {k: np.asarray(v).tolist() for k, v in p.lane(rn).items()}


class Rec:
    """A script's record: a list of [tag, value] lines."""

    def __init__(self, p):
        self.p, self.log = p, []

    def add(self, tag, value=None):
        self.log.append([tag, value])

    def ready(self, rn):
        rd = rn.ready()
        self.add("ready", v_ready(rd))
        return rd

    def status(self, rn):
        st = rn.status()
        self.add("status", v_status(st))
        return st

    def raises(self, tag, fn, *a, **k):
        """Run ``fn``; record the exception's class name or None."""
        try:
            fn(*a, **k)
        except Exception as e:  # noqa: BLE001 - the name is the record
            self.add(tag, type(e).__name__)
            return e
        self.add(tag, None)
        return None


# ---------------------------------------------------------------------------
# rawnode: tests/test_rawnode.py, tests/test_flow_control.py and
# tests/test_wait_mock.py:63, transliterated
# ---------------------------------------------------------------------------

def _boot(p, spec, cfg, nid=0, voters=(0, 1, 2), index=2):
    s = p.rs.MemoryStorage()
    s.apply_snapshot(p.rs.Snapshot(meta=p.rs.SnapshotMeta(
        index=index, term=1, conf_state=p.rs.ConfState(voters=voters))))
    return p.RawNode(cfg, spec, s, nid, applied=index), s


def _rn(p):
    return p.Spec(**RAWNODE_SPEC), p.RaftConfig(**RAWNODE_CFG)


def _drive_to_leader(p, r, rn, s, peers=(1, 2)):
    rn.campaign()
    rd = r.ready(rn)
    s.set_hard_state(rd.hard_state)
    rn.advance(rd)
    term = int(rn.n.term)
    for q in peers:
        rn.step(p.rawnode.HostMsg(type=4, to=rn.nid, frm=q, term=term))
        if int(rn.n.role) == p.T.ROLE_LEADER:
            break
    r.add("role", int(rn.n.role))


def _persist(s, rd):
    if rd.hard_state:
        s.set_hard_state(rd.hard_state)
    s.append(rd.entries)


def rn_step_refuses_local_messages(p, r):
    rn, _ = _boot(p, *_rn(p))
    HM = p.rawnode.HostMsg
    r.raises("step MsgHup", rn.step, HM(type=p.T.MSG_HUP, to=0, frm=0))
    r.raises("step MsgProp", rn.step, HM(type=p.T.MSG_PROP, to=0, frm=0))
    return [rn]


def rn_step_refuses_response_from_unknown_peer(p, r):
    rn, _ = _boot(p, *_rn(p), voters=(0, 1))
    HM = p.rawnode.HostMsg
    r.raises("step AppResp from 5", rn.step,
             HM(type=p.T.MSG_APP_RESP, to=0, frm=5, term=1))
    r.raises("step Heartbeat from 5", rn.step,
             HM(type=p.T.MSG_HEARTBEAT, to=0, frm=5, term=1))
    r.ready(rn)
    return [rn]


def rn_propose_and_conf_change(p, r):
    rn, s = _boot(p, *_rn(p))
    HM = p.rawnode.HostMsg
    _drive_to_leader(p, r, rn, s)
    rd = r.ready(rn)
    _persist(s, rd)
    rn.advance(rd)
    r.add("propose 41", rn.propose(41))
    r.add("propose cc", rn.propose_conf_change(p.cc.encode([(p.T.CC_ADD_NODE, 3)])))
    last, term = int(rn.n.last_index), int(rn.n.term)
    for q in (1, 2):
        rn.step(HM(type=p.T.MSG_APP_RESP, to=0, frm=q, term=term, index=last))
    rd = r.ready(rn)
    _persist(s, rd)
    rn.advance(rd)
    r.add("last_conf_states", [v_conf(c) for c in rn.last_conf_states])
    r.add("conf_state", v_conf(rn.conf_state()))
    r.add("propose cc 2", rn.propose_conf_change(p.cc.encode([(p.T.CC_ADD_NODE, 4)])))
    r.ready(rn)
    return [rn]


def rn_ready_sequence_from_boot(p, r):
    rn, s = _boot(p, *_rn(p))
    r.add("has_ready", rn.has_ready())
    rn.campaign()
    r.add("has_ready", rn.has_ready())
    rd = r.ready(rn)
    s.set_hard_state(rd.hard_state)
    rn.advance(rd)
    r.add("has_ready", rn.has_ready())
    return [rn]


def rn_commit_only_ready_is_not_sync(p, r):
    rn, s = _boot(p, *_rn(p))
    HM = p.rawnode.HostMsg
    _drive_to_leader(p, r, rn, s)
    rd = r.ready(rn)
    _persist(s, rd)
    rn.advance(rd)
    last, term = int(rn.n.last_index), int(rn.n.term)
    for q in (1, 2):
        rn.step(HM(type=p.T.MSG_APP_RESP, to=0, frm=q, term=term, index=last))
    rd = r.ready(rn)
    rn.advance(rd)
    r.status(rn)
    return [rn]


def rn_restart_from_storage(p, r):
    s = p.rs.MemoryStorage()
    s.apply_snapshot(p.rs.Snapshot(meta=p.rs.SnapshotMeta(
        index=2, term=1, conf_state=p.rs.ConfState(voters=(0, 1, 2)))))
    s.append([p.rs.Entry(index=3, term=1, data=7)])
    s.set_hard_state(p.rs.HardState(term=1, vote=p.T.NONE_ID, commit=3))
    rn = p.RawNode(p.RaftConfig(**RAWNODE_CFG), p.Spec(**RAWNODE_SPEC), s, 0, applied=2)
    rd = r.ready(rn)
    rn.advance(rd)
    r.add("has_ready", rn.has_ready())
    r.add("applied", int(rn.n.applied))
    return [rn]


def rn_restart_from_snapshot(p, r):
    s = p.rs.MemoryStorage()
    s.apply_snapshot(p.rs.Snapshot(meta=p.rs.SnapshotMeta(
        index=5, term=2, conf_state=p.rs.ConfState(voters=(0, 1)), app_hash=99)))
    s.set_hard_state(p.rs.HardState(term=2, vote=p.T.NONE_ID, commit=5))
    rn = p.RawNode(p.RaftConfig(**RAWNODE_CFG), p.Spec(**RAWNODE_SPEC), s, 0, applied=5)
    r.add("has_ready", rn.has_ready())
    r.add("commit, applied_hash", [int(rn.n.commit), int(rn.n.applied_hash)])
    r.add("conf_state", v_conf(rn.conf_state()))
    return [rn]


def rn_read_index_leader(p, r):
    rn, s = _boot(p, *_rn(p))
    HM = p.rawnode.HostMsg
    _drive_to_leader(p, r, rn, s)
    rd = r.ready(rn)
    _persist(s, rd)
    rn.advance(rd)
    last, term = int(rn.n.last_index), int(rn.n.term)
    for q in (1, 2):
        rn.step(HM(type=p.T.MSG_APP_RESP, to=0, frm=q, term=term, index=last))
    rn.advance(r.ready(rn))
    rn.read_index(ctx=7)
    rn.advance(r.ready(rn))
    for q in (1, 2):
        rn.step(HM(type=7, to=0, frm=q, term=term, context=7))  # MsgHeartbeatResp
    rn.advance(r.ready(rn))
    return [rn]


def rn_read_index_parked_before_first_commit(p, r):
    """A read made before the leader commits in its term is parked
    (raft.go:1146-1152) and released by the MsgAppResp that commits: its
    heartbeats carry the read's context, their acks answer it. The boot's
    term is the snapshot's, so that the campaign opens a later one."""
    s = p.rs.MemoryStorage()
    s.apply_snapshot(p.rs.Snapshot(meta=p.rs.SnapshotMeta(
        index=2, term=1, conf_state=p.rs.ConfState(voters=(0, 1, 2)))))
    s.set_hard_state(p.rs.HardState(term=1, vote=p.T.NONE_ID, commit=2))
    rn = p.RawNode(p.RaftConfig(**RAWNODE_CFG), p.Spec(**RAWNODE_SPEC), s, 0, applied=2)
    HM = p.rawnode.HostMsg
    _drive_to_leader(p, r, rn, s)
    rd = r.ready(rn)
    _persist(s, rd)
    rn.advance(rd)
    rn.read_index(ctx=9)
    rn.advance(r.ready(rn))
    last, term = int(rn.n.last_index), int(rn.n.term)
    for q in (1, 2):
        rn.step(HM(type=p.T.MSG_APP_RESP, to=0, frm=q, term=term, index=last))
    rd = r.ready(rn)
    _persist(s, rd)
    rn.advance(rd)
    for q in (1, 2):
        rn.step(HM(type=p.T.MSG_HEARTBEAT_RESP, to=0, frm=q, term=term, context=9))
    rn.advance(r.ready(rn))
    r.add("has_ready", rn.has_ready())
    return [rn]


def rn_device_lane_storage_contract(p, r):
    rn, s = _boot(p, *_rn(p))
    _drive_to_leader(p, r, rn, s)
    rd = r.ready(rn)
    s.append(rd.entries)
    rn.advance(rd)
    lane = p.rawnode.DeviceLaneStorage(rn)
    r.add("first, last", [lane.first_index(), lane.last_index()])
    r.add("term(2)", lane.term(2))
    r.raises("entries(1, 3)", lane.entries, 1, 3)
    r.raises("entries past last", lane.entries, 3, lane.last_index() + 2)
    r.raises("term(1)", lane.term, 1)
    r.raises("term past last", lane.term, lane.last_index() + 1)
    r.add("entries", [v_entry(e) for e in lane.entries(3, lane.last_index() + 1)])
    r.add("entries max 0", [v_entry(e) for e in lane.entries(3, lane.last_index() + 1, 0)])
    hs, cs = lane.initial_state()
    r.add("initial_state", [v_hs(hs), v_conf(cs)])
    r.add("snapshot", v_snap(lane.snapshot()))
    return [rn]


def _flow(p):
    return p.Spec(**FLOW_SPEC), p.RaftConfig(**FLOW_CFG)


def _new_leader(p, r):
    spec, cfg = _flow(p)
    rn, s = _boot(p, spec, cfg)
    rn.campaign()
    term = int(rn.n.term)
    for q in (1, 2):
        rn.step(p.rawnode.HostMsg(type=4, to=0, frm=q, term=term))
    rd = r.ready(rn)
    _persist(s, rd)
    rn.advance(rd)
    _ack(p, rn, 1, int(rn.n.last_index))
    _drain(r, rn)
    return rn, s


def _ack(p, rn, frm, index, reject=False, hint=0, hint_term=0):
    rn.step(p.rawnode.HostMsg(type=p.T.MSG_APP_RESP, to=0, frm=frm,
                              term=int(rn.n.term), index=index, reject=reject,
                              reject_hint=hint, log_term=hint_term))


def _drain(r, rn):
    rd = r.ready(rn)
    rn.storage.append(rd.entries)
    if rd.hard_state:
        rn.storage.set_hard_state(rd.hard_state)
    rn.advance(rd)
    return rd.messages


def fc_flow_control_full(p, r):
    rn, _ = _new_leader(p, r)
    for k in range(FLOW_CFG["max_inflight"] + 3):
        r.add("propose", rn.propose(100 + k))
        _drain(r, rn)
    r.status(rn)
    return [rn]


def fc_flow_control_move_forward(p, r):
    rn, _ = _new_leader(p, r)
    first = int(rn.n.last_index) + 1
    for k in range(FLOW_CFG["max_inflight"] + 2):
        rn.propose(300 + k)
        _drain(r, rn)
    _ack(p, rn, 1, first)
    _drain(r, rn)
    r.status(rn)
    _ack(p, rn, 1, first)
    _drain(r, rn)
    return [rn]


def fc_heartbeat_resp_frees_one(p, r):
    rn, _ = _new_leader(p, r)
    for k in range(FLOW_CFG["max_inflight"] + 2):
        rn.propose(400 + k)
        _drain(r, rn)
    for _ in range(2):
        rn.step(p.rawnode.HostMsg(type=p.T.MSG_HEARTBEAT_RESP, to=0, frm=1,
                                  term=int(rn.n.term)))
        _drain(r, rn)
    return [rn]


def _snapshot_leader(p, r):
    rn, s = _new_leader(p, r)
    for k in range(4):
        rn.propose(500 + k)
        _drain(r, rn)
        _ack(p, rn, 1, int(rn.n.last_index))
        _drain(r, rn)
    rn.compact_to(int(rn.n.applied))
    probe_prev = rn.status().progress[2].next - 1
    _ack(p, rn, 2, probe_prev, reject=True, hint=0, hint_term=0)
    msgs = _drain(r, rn)
    snap = [m for m in msgs if m.type == p.T.MSG_SNAP and m.to == 2][0]
    r.status(rn)
    return rn, s, snap


def fc_snapshot_paths(p, r):
    """TestSendingSnapshotSetPendingSnapshot, TestPendingSnapshotPauseReplication,
    TestSnapshotFailure, TestSnapshotSucceed and TestSnapshotAbort, each on a
    fresh snapshot_leader."""
    HM = p.rawnode.HostMsg
    nodes = []
    rn, _, _ = _snapshot_leader(p, r)
    rn.propose(600)
    _drain(r, rn)
    nodes.append(rn)
    for reject in (True, False):
        rn, _, _ = _snapshot_leader(p, r)
        rn.step(HM(type=p.T.MSG_SNAP_STATUS, to=0, frm=2, term=int(rn.n.term),
                   reject=reject))
        r.status(rn)
        nodes.append(rn)
    rn, _, snap = _snapshot_leader(p, r)
    _ack(p, rn, 2, snap.snapshot.meta.index)
    r.status(rn)
    return nodes + [rn]


def fc_unreachable_drops_to_probe(p, r):
    rn, _ = _new_leader(p, r)
    rn.step(p.rawnode.HostMsg(type=p.T.MSG_UNREACHABLE, to=0, frm=1,
                              term=int(rn.n.term)))
    r.status(rn)
    return [rn]


def fc_ring_exhaustion_recovers_via_snapshot(p, r):
    spec, cfg = _flow(p)
    HM = p.rawnode.HostMsg
    rn, _ = _new_leader(p, r)
    f2, f2s = _boot(p, spec, cfg, nid=2)
    for k in range(spec.L + 8):
        rn.propose(700 + k)
        _drain(r, rn)
        _ack(p, rn, 1, int(rn.n.last_index))
        _drain(r, rn)
    r.add("leader snap_index", int(rn.n.snap_index))
    rn.step(HM(type=p.T.MSG_HEARTBEAT_RESP, to=0, frm=2, term=int(rn.n.term)))
    snaps = [m for m in _drain(r, rn) if m.type == p.T.MSG_SNAP and m.to == 2]
    f2.step(snaps[0])
    for _ in range(8):
        rd = r.ready(f2)
        if rd.hard_state:
            f2s.set_hard_state(rd.hard_state)
        f2s.append(rd.entries)
        if rd.snapshot:
            f2s.apply_snapshot(rd.snapshot)
        f2.advance(rd)
        for m in rd.messages:
            if m.to == 0:
                rn.step(m)
        back = [m for m in _drain(r, rn) if m.to == 2]
        if not back:
            break
        for m in back:
            f2.step(m)
    r.status(rn)
    return [rn, f2]


def mock_recording_storage_drives_rawnode(p, r):
    rs = p.mock.RecordingStorage(p.rs.MemoryStorage())
    rn = p.RawNode(p.RaftConfig(), p.Spec(**MOCK_SPEC), rs, nid=0)
    rn.campaign()
    rd = r.ready(rn)
    if rd.hard_state is not None:
        rs.set_hard_state(rd.hard_state)
    rs.append(rd.entries)
    rn.advance(rd)
    r.add("actions", [[a[0]] + [repr(x) for x in a[1:]] for a in rs.actions])
    return [rn]


RAWNODE_SCRIPTS = {f.__name__: f for f in (
    rn_step_refuses_local_messages, rn_step_refuses_response_from_unknown_peer,
    rn_propose_and_conf_change, rn_ready_sequence_from_boot,
    rn_commit_only_ready_is_not_sync, rn_restart_from_storage,
    rn_restart_from_snapshot, rn_read_index_leader,
    rn_read_index_parked_before_first_commit,
    rn_device_lane_storage_contract,
    fc_flow_control_full, fc_flow_control_move_forward,
    fc_heartbeat_resp_frees_one, fc_snapshot_paths,
    fc_unreachable_drops_to_probe, fc_ring_exhaustion_recovers_via_snapshot,
    mock_recording_storage_drives_rawnode,
)}


def run_rawnode(p, name: str) -> list:
    """One rawnode script's record, the lanes of its nodes at its end
    included."""
    r = Rec(p)
    nodes = RAWNODE_SCRIPTS[name](p, r)
    r.add("lanes", [v_lane(p, rn) for rn in nodes])
    return r.log


# ---------------------------------------------------------------------------
# raftexample: tests/test_raftexample.py in one process, then main()
# ---------------------------------------------------------------------------

def _example_view(c) -> dict:
    out = {}
    for nid, node in sorted(c.nodes.items()):
        rn = node.node
        out[str(nid)] = {
            "kv": dict(sorted(node.kv.data.items())),
            "applied_words": list(node.kv.applied_words),
            "hard_state": v_hs(rn._hard_state()),
            "applied": int(rn.n.applied),
            "applied_hash": int(rn.n.applied_hash),
            "status": v_status(rn.status()),
        }
    return out


def run_raftexample(p) -> dict:
    """The operations of tests/test_raftexample.py in order on one
    Cluster(3) (elect, put, overwrite, drop and heal, restart from storage,
    leader status), each followed by every node's view; then main()'s
    printed text."""
    ops = []
    c = p.Cluster(3)

    def view(op, **extra):
        ops.append({"op": op, "leader": c.leader(), "nodes": _example_view(c), **extra})

    view("elect", elected=c.elect(0))
    c.put("k1", "v1")
    view("put k1")
    c.put("k2", "a")
    c.put("k2", "b")
    view("overwrite k2")
    c.network.drop = {(m, 2) for m in c.nodes if m != 2}
    c.put("k3", "v3")
    view("put k3, node 2 cut off", k3_on_2=c.get("k3", 2))
    c.network.drop = set()
    c.put("k4", "v4")
    c.settle()
    view("heal, put k4")
    c.put("k5", "v5")
    victim = next(n for n in c.nodes if n != c.leader())
    old = c.nodes[victim]
    reborn = p.RaftExampleNode(c.cfg, c.spec, victim, c.proposals, storage=old.storage)
    c.nodes[victim] = reborn
    c.network.nodes = c.nodes
    c.settle()
    view("restart from storage", victim=victim, k5=reborn.kv.lookup("k5"),
         k1=reborn.kv.lookup("k1"))
    lead = c.leader()
    view("leader status", status=v_status(c.nodes[lead].node.status()))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if p.kw:
            dev = p.kw["device"]
            rc = p.raftexample.main([] if dev is None else ["--device", str(dev)])
        else:
            rc = p.raftexample.main()
    return {"ops": ops, "main": buf.getvalue(), "main_rc": rc}


# ---------------------------------------------------------------------------
# interaction: tests/interaction_scripts/*.txt through InteractionEnv
# ---------------------------------------------------------------------------

def interaction_names() -> list:
    return sorted(f.name for f in SCRIPTS_DIR.glob("*.txt"))


def run_interaction(p, fname: str) -> list:
    """Each command's output block, in order."""
    env = p.InteractionEnv()
    return [env.handle(case) for case in p.dd.parse_file(str(SCRIPTS_DIR / fname))]


# ---------------------------------------------------------------------------
# wal: byte-level scripts of tests/test_storage.py and
# tests/test_crash_durability.py, and a RawNode group through the WAL
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def segment_bytes(p, n: int):
    old = p.wal.SEGMENT_BYTES
    p.wal.SEGMENT_BYTES = n
    try:
        yield
    finally:
        p.wal.SEGMENT_BYTES = old


def dir_digest(d: str) -> dict:
    """File name -> sha256 of its bytes, for every file under ``d``."""
    out = {}
    for root, _, files in os.walk(d):
        for f in sorted(files):
            path = os.path.join(root, f)
            out[os.path.relpath(path, d)] = hashlib.sha256(
                pathlib.Path(path).read_bytes()).hexdigest()
    return dict(sorted(out.items()))


def read_view(p, d: str):
    """WAL(d).read_all() as a JSON-able list, or the error's class name."""
    try:
        w = p.wal.WAL(d)
        meta, hs, ents, snap = w.read_all()
        w.close()
    except Exception as e:  # noqa: BLE001
        return ["error", type(e).__name__]
    return [meta.decode("latin-1"), hs, ents, snap]


def _fill(w, n, term=1, commit_lag=1):
    for i in range(1, n + 1):
        w.save({"term": term, "vote": 0, "commit": max(i - commit_lag, 0)},
               [{"index": i, "term": term, "data": i * 11, "type": 0}])


def _segs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".wal"))


def wal_save_and_replay(p, d, r):
    w = p.wal.WAL(d, metadata=b"cluster-0")
    w.save({"term": 1, "vote": 0, "commit": 0},
           [{"index": 1, "term": 1, "data": 11, "type": 0}])
    w.save({"term": 1, "vote": 0, "commit": 1},
           [{"index": 2, "term": 1, "data": 22, "type": 0}])
    w.close()


def wal_truncate_and_append(p, d, r):
    w = p.wal.WAL(d)
    w.save(None, [{"index": i, "term": 1, "data": i, "type": 0} for i in (1, 2, 3)])
    w.save({"term": 2, "vote": 1, "commit": 1},
           [{"index": 2, "term": 2, "data": 20, "type": 0}])
    w.close()


def wal_torn_tail_repair(p, d, r):
    w = p.wal.WAL(d)
    w.save({"term": 1, "vote": 0, "commit": 0},
           [{"index": 1, "term": 1, "data": 5, "type": 0}])
    w.close()
    with open(os.path.join(d, _segs(d)[0]), "ab") as f:
        f.write(b"\x07\x00\x00\x00garbage-torn-tail")
    w2 = p.wal.WAL(d)
    r.add("read", read_view(p, d))
    w2.save(None, [{"index": 2, "term": 1, "data": 6, "type": 0}])
    w2.close()


def wal_snapshot_marker_and_release(p, d, r):
    w = p.wal.WAL(d, metadata=b"m")
    for i in range(1, 30):
        w.save(None, [{"index": i, "term": 1, "data": i, "type": 0}])
        if i == 12:
            w.save_snapshot(index=10, term=1)
    w.close()
    r.add("segments", _segs(d))
    r.add("read", read_view(p, d))
    w = p.wal.WAL(d)
    r.add("released", w.release_to(10))
    w.close()


def wal_corrupt_final_record_in_place(p, d, r):
    w = p.wal.WAL(d)
    _fill(w, 3)
    w.close()
    seg = os.path.join(d, _segs(d)[-1])
    data = bytearray(pathlib.Path(seg).read_bytes())
    for off in range(len(data) - 12, len(data) - 8):
        data[off] ^= 0xFF
    pathlib.Path(seg).write_bytes(bytes(data))
    w2 = p.wal.WAL(d)
    r.add("read", read_view(p, d))
    w2.save(None, [{"index": 4, "term": 1, "data": 44, "type": 0}])
    w2.close()


def wal_truncated_final_record(p, d, r):
    w = p.wal.WAL(d)
    _fill(w, 5)
    w.close()
    seg = os.path.join(d, _segs(d)[-1])
    with open(seg, "ab") as f:
        f.truncate(os.path.getsize(seg) - 7)


def wal_crash_during_cut_drops_debris(p, d, r):
    w = p.wal.WAL(d)
    for i in range(1, 20):
        w.save(None, [{"index": i, "term": 1, "data": i, "type": 0}])
    w.close()
    segs = _segs(d)
    pen = os.path.join(d, segs[-2])
    with open(pen, "ab") as f:
        f.truncate(os.path.getsize(pen) - 5)
    with open(os.path.join(d, segs[-1]), "r+b") as f:
        f.truncate(3)
    w2 = p.wal.WAL(d)
    _, _, ents, _ = w2.read_all()
    w2.save(None, [{"index": ents[-1]["index"] + 1, "term": 1, "data": 0, "type": 0}])
    w2.close()


def wal_bitrot_in_durable_segment_refuses(p, d, r):
    w = p.wal.WAL(d)
    for i in range(1, 20):
        w.save(None, [{"index": i, "term": 1, "data": i, "type": 0}])
    w.close()
    segs = _segs(d)
    pen = os.path.join(d, segs[-2])
    buf = pathlib.Path(pen).read_bytes()
    first_len = p.walcodec.get_codec().decode(buf, 0, 0)[0]
    data = bytearray(buf)
    data[first_len + 12] ^= 0xFF
    pathlib.Path(pen).write_bytes(bytes(data))
    with open(os.path.join(d, segs[-1]), "r+b") as f:
        f.truncate(3)


def wal_bitrot_mid_final_segment_refuses(p, d, r):
    w = p.wal.WAL(d)
    _fill(w, 2)
    w.close()
    seg = os.path.join(d, _segs(d)[-1])
    buf = pathlib.Path(seg).read_bytes()
    first_len = p.walcodec.get_codec().decode(buf, 0, 0)[0]
    data = bytearray(buf)
    data[first_len + 12] ^= 0xFF
    pathlib.Path(seg).write_bytes(bytes(data))


def wal_bitrot_in_debris_segment_refuses(p, d, r):
    w = p.wal.WAL(d)
    for i in range(1, 20):
        w.save(None, [{"index": i, "term": 1, "data": i, "type": 0}])
    w.close()
    segs = _segs(d)
    pen = os.path.join(d, segs[-2])
    with open(pen, "ab") as f:
        f.truncate(os.path.getsize(pen) - 5)
    last = os.path.join(d, segs[-1])
    data = bytearray(pathlib.Path(last).read_bytes())
    data[p.walcodec.HEADER_SIZE + 1] ^= 0xFF
    pathlib.Path(last).write_bytes(bytes(data))


def wal_mid_log_tear_refuses(p, d, r):
    w = p.wal.WAL(d)
    for i in range(1, 20):
        w.save(None, [{"index": i, "term": 1, "data": i, "type": 0}])
    w.close()
    pen = os.path.join(d, _segs(d)[-2])
    with open(pen, "ab") as f:
        f.truncate(os.path.getsize(pen) - 5)


def wal_bootstrap_initial_snapshot_marker(p, d, r):
    w = p.wal.WAL(d)
    w.save_snapshot(index=0, term=0)
    w.save({"term": 1, "vote": 0, "commit": 1},
           [{"index": 1, "term": 1, "data": 11, "type": 0}])
    w.close()
    ms, _ = p.rs.bootstrap_from_wal(p.wal.WAL(d))
    r.add("storage", [ms.first_index(), ms.last_index(), v_hs(ms.hard_state)])


def wal_crash_restart_roundtrip(p, d, r):
    import random

    w = p.wal.WAL(d, metadata=b"group-7")
    _fill(w, 6, term=1)
    w.save_snapshot(index=2, term=1)
    w.save({"term": 2, "vote": 1, "commit": 5},
           [{"index": 7, "term": 2, "data": 77, "type": 0}])
    w.close()
    rng = random.Random(5)
    for _ in range(4):
        seg = os.path.join(d, _segs(d)[-1])
        with open(seg, "ab") as f:
            f.truncate(max(os.path.getsize(seg) - rng.randrange(1, 30), 0))
        w = p.wal.WAL(d)
        ms, metadata = p.rs.bootstrap_from_wal(w)
        hs, _ = ms.initial_state()
        r.add("restart", [metadata.decode(), v_hs(hs), ms.first_index(),
                          ms.last_index(), ms.snapshot().meta.index,
                          [v_entry(e) for e in ms.entries(ms.first_index(),
                                                          ms.last_index() + 1)]])
        t, nxt = hs.term + 1, ms.last_index() + 1
        w.save({"term": t, "vote": 0, "commit": hs.commit},
               [{"index": nxt, "term": t, "data": nxt, "type": 0}])
        w.close()


# script -> the segment size it runs at (None: the WAL's own, 8 MiB)
WAL_SCRIPTS = {f.__name__: (f, seg) for f, seg in (
    (wal_save_and_replay, None), (wal_truncate_and_append, None),
    (wal_torn_tail_repair, None),
    (wal_snapshot_marker_and_release, WAL_SEGMENT_BYTES),
    (wal_corrupt_final_record_in_place, None), (wal_truncated_final_record, None),
    (wal_crash_during_cut_drops_debris, WAL_SEGMENT_BYTES),
    (wal_bitrot_in_durable_segment_refuses, WAL_SEGMENT_BYTES),
    (wal_bitrot_mid_final_segment_refuses, None),
    (wal_bitrot_in_debris_segment_refuses, WAL_SEGMENT_BYTES),
    (wal_mid_log_tear_refuses, WAL_SEGMENT_BYTES),
    (wal_bootstrap_initial_snapshot_marker, None),
    (wal_crash_restart_roundtrip, None),
)}


def run_wal(p, name: str, d: str) -> list:
    """A WAL script in directory ``d``: its record, then the final replay
    (or its error) and every file's digest."""
    fn, seg = WAL_SCRIPTS[name]
    r = Rec(p)
    with segment_bytes(p, seg or p.wal.SEGMENT_BYTES):
        fn(p, d, r)
        r.add("final read", read_view(p, d))
    r.add("files", dir_digest(d))
    return r.log


def run_wal_group(p, d: str) -> dict:
    """A three-node RawNode group on raftexample's Spec whose every Ready is
    persisted through a WAL per node (entries then hard state, WAL.save)
    at WAL_SEGMENT_BYTES: elected, 12 puts, a snapshot marker at the
    applied index and release_to after it; node 2's last segment then gets
    a torn half frame. The nodes are dropped, each WAL replayed into a
    fresh MemoryStorage (bootstrap_from_wal) and a RawNode rebooted from
    it, which applies its committed entries again. Returns the segment
    digests before the replay, each node's read-back and the rebooted
    nodes' applied words and Ready."""
    spec = p.Spec(M=3, L=32, E=1, K=2, W=4, R=2, A=4)
    cfg = p.RaftConfig()
    out = {"released": {}}
    with segment_bytes(p, WAL_SEGMENT_BYTES):
        storages, wals, nodes = {}, {}, {}
        for i in range(3):
            s = p.rs.MemoryStorage()
            s.apply_snapshot(p.rs.Snapshot(meta=p.rs.SnapshotMeta(
                index=1, term=1, conf_state=p.rs.ConfState(voters=(0, 1, 2)))))
            storages[i] = s
            wals[i] = p.wal.WAL(os.path.join(d, f"member-{i}"), metadata=b"group-0")
            wals[i].save_snapshot(index=1, term=1)
            nodes[i] = p.RawNode(cfg, spec, s, i, applied=1)
        queue = []

        def pump():
            for _ in range(64):
                moved = False
                for i, rn in nodes.items():
                    if not rn.has_ready():
                        continue
                    moved = True
                    rd = rn.ready()
                    hs = None if rd.hard_state is None else {
                        "term": rd.hard_state.term, "vote": rd.hard_state.vote,
                        "commit": rd.hard_state.commit}
                    wals[i].save(hs, [{"index": e.index, "term": e.term,
                                       "type": e.type, "data": e.data}
                                      for e in rd.entries])
                    if rd.hard_state is not None:
                        storages[i].set_hard_state(rd.hard_state)
                    storages[i].append(list(rd.entries))
                    queue.extend(rd.messages)
                    rn.advance(rd)
                msgs, queue[:] = list(queue), []
                for m in msgs:
                    moved = True
                    nodes[m.to].step(m)
                if not moved:
                    return

        nodes[0].campaign()
        pump()
        for k in range(12):
            nodes[0].propose(100 + k)
            pump()
        for i in range(3):
            applied = int(nodes[i].n.applied)
            wals[i].save_snapshot(index=applied - 4, term=storages[i].term(applied - 4))
            out["released"][str(i)] = wals[i].release_to(applied - 4)
            wals[i].close()
        out["lanes"] = {str(i): v_lane(p, rn) for i, rn in nodes.items()}
        del nodes
        # a torn half frame at the end of node 2's log
        seg = os.path.join(d, "member-2", _segs(os.path.join(d, "member-2"))[-1])
        frame, _ = p.walcodec.get_codec().encode(
            p.wal.REC_ENTRIES, pickle.dumps({"index": 99, "term": 9}), 0)
        with open(seg, "ab") as f:
            f.write(frame[: len(frame) // 2])
        out["files"] = dir_digest(d)
        out["reboot"] = {}
        for i in range(3):
            w = p.wal.WAL(os.path.join(d, f"member-{i}"))
            ms, meta = p.rs.bootstrap_from_wal(w)
            w.close()
            rn = p.RawNode(cfg, spec, ms, i, applied=ms.snapshot().meta.index)
            rd = rn.ready()
            rn.advance(rd)
            out["reboot"][str(i)] = {
                "metadata": meta.decode(),
                "storage": [ms.first_index(), ms.last_index(), v_hs(ms.hard_state),
                            ms.snapshot().meta.index],
                "entries": [v_entry(e) for e in ms.entries(ms.first_index(),
                                                           ms.last_index() + 1)],
                "ready": v_ready(rd),
                "applied": int(rn.n.applied),
                "applied_hash": int(rn.n.applied_hash),
            }
        out["files_after_replay"] = dir_digest(d)
    return out
