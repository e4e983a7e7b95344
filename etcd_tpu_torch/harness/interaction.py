"""InteractionEnv: the rafttest data-driven command language
(etcd_tpu/harness/interaction.py; the same output, text for text).

Implements the reference's interaction-testing harness
(raft/rafttest/interaction_env.go:33-49, interaction_env_handler.go:29-146)
over :class:`etcd_tpu_torch.models.rawnode.RawNode` lanes: ``add-nodes``,
``campaign``, ``propose``, ``propose-conf-change`` (v1/v2 + transitions),
``deliver-msgs`` (with drops), ``process-ready``, ``stabilize``,
``compact``, ``raft-log``, ``status``, ``tick-heartbeat`` and
``log-level`` — so the reference's golden scenarios
(raft/testdata/*.txt) replay against the engine. Its nodes' lanes run on
the CUDA card unless the caller passes ``device="cpu"``.

Output mirrors the reference's Describe* formats (raft/util.go:64-210)
and the load-bearing logger lines (role transitions, config switches,
snapshot restores) so goldens can be compared semantically: structural
lines byte-for-byte, logger lines through a curated-event normalizer
(see tests/test_datadriven_interaction.py).

Convention: device member ids are 0-based; all rendered output adds 1, so
NONE_ID (-1) prints as 0 — exactly the reference's "None = 0" convention.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from etcd_tpu_torch.models import confchange as ccmod
from etcd_tpu_torch.models.rawnode import (
    ErrStepLocalMsg,
    ErrStepPeerNotFound,
    HostMsg,
    RawNode,
    Ready,
    ROLE_NAMES,
)
from etcd_tpu_torch.storage.raftstorage import (
    ConfState,
    Entry,
    MemoryStorage,
    PayloadTable,
    Snapshot,
    SnapshotMeta,
)
from etcd_tpu_torch.types import (
    CC_ADD_LEARNER,
    CC_ADD_NODE,
    CC_REMOVE_NODE,
    CC_UPDATE_NODE,
    ENTRY_NORMAL,
    MSG_APP,
    MSG_APP_RESP,
    MSG_HEARTBEAT,
    MSG_HEARTBEAT_RESP,
    MSG_HUP,
    MSG_PRE_VOTE,
    MSG_PRE_VOTE_RESP,
    MSG_PROP,
    MSG_READ_INDEX,
    MSG_READ_INDEX_RESP,
    MSG_SNAP,
    MSG_SNAP_STATUS,
    MSG_TIMEOUT_NOW,
    MSG_TRANSFER_LEADER,
    MSG_UNREACHABLE,
    MSG_VOTE,
    MSG_VOTE_RESP,
    PR_REPLICATE,
    PR_SNAPSHOT,
    ROLE_CANDIDATE,
    ROLE_FOLLOWER,
    ROLE_LEADER,
    ROLE_PRE_CANDIDATE,
    Spec,
)
from etcd_tpu_torch.utils.config import RaftConfig
from etcd_tpu_torch.utils.device import resolve_device

MSG_NAMES = {
    MSG_APP: "MsgApp", MSG_APP_RESP: "MsgAppResp",
    MSG_VOTE: "MsgVote", MSG_VOTE_RESP: "MsgVoteResp",
    MSG_SNAP: "MsgSnap", MSG_HEARTBEAT: "MsgHeartbeat",
    MSG_HEARTBEAT_RESP: "MsgHeartbeatResp",
    MSG_PRE_VOTE: "MsgPreVote", MSG_PRE_VOTE_RESP: "MsgPreVoteResp",
    MSG_TRANSFER_LEADER: "MsgTransferLeader",
    MSG_TIMEOUT_NOW: "MsgTimeoutNow",
    MSG_READ_INDEX: "MsgReadIndex", MSG_READ_INDEX_RESP: "MsgReadIndexResp",
    MSG_PROP: "MsgProp", MSG_UNREACHABLE: "MsgUnreachable",
    MSG_SNAP_STATUS: "MsgSnapStatus", MSG_HUP: "MsgHup",
}

ROLE_LOG_NAMES = {
    ROLE_FOLLOWER: "follower",
    ROLE_PRE_CANDIDATE: "pre-candidate",
    ROLE_CANDIDATE: "candidate",
    ROLE_LEADER: "leader",
}

LVL_DEBUG, LVL_INFO, LVL_WARN, LVL_ERROR, LVL_FATAL, LVL_NONE = range(6)
LVL_NAMES = ["DEBUG", "INFO", "WARN", "ERROR", "FATAL", "NONE"]


def _ids_str(ids) -> str:
    return "(" + " ".join(str(i + 1) for i in sorted(ids)) + ")"


def conf_str(cs: ConfState) -> str:
    """tracker.Config.String() (tracker/tracker.go:80-93) +
    quorum Joint/MajorityConfig.String()."""
    out = "voters=" + _ids_str(cs.voters)
    if cs.voters_outgoing:
        out += "&&" + _ids_str(cs.voters_outgoing)
    if cs.learners:
        out += " learners=" + _ids_str(cs.learners)
    if cs.learners_next:
        out += " learners_next=" + _ids_str(cs.learners_next)
    if cs.auto_leave:
        out += " autoleave"
    return out


def conf_state_brackets(cs: ConfState) -> str:
    """DescribeConfState (raft/util.go:78-83)."""
    sq = lambda ids: "[" + " ".join(str(i + 1) for i in sorted(ids)) + "]"
    return (
        f"Voters:{sq(cs.voters)} VotersOutgoing:{sq(cs.voters_outgoing)} "
        f"Learners:{sq(cs.learners)} LearnersNext:{sq(cs.learners_next)} "
        f"AutoLeave:{'true' if cs.auto_leave else 'false'}"
    )


def cc_changes_str(word: int) -> str:
    """ConfChangesToString (raftpb/confchange.go:149-168) for our packed
    conf-change word (models/confchange.py layout)."""
    if ccmod.is_leave_joint(word):
        return ""
    names = {CC_ADD_NODE: "v", CC_REMOVE_NODE: "r", CC_UPDATE_NODE: "u",
             CC_ADD_LEARNER: "l"}
    parts = []
    if word & (1 << 16):
        parts.append(f"{names[word & 7]}{((word >> 3) & 31) + 1}")
    if word & (1 << 17):
        parts.append(f"{names[(word >> 8) & 7]}{((word >> 11) & 31) + 1}")
    return " ".join(parts)


@dataclasses.dataclass
class _StateSnap:
    term: int
    role: int
    lead: int
    vote: int
    snap_index: int
    conf: tuple
    commit: int
    applied: int
    last_index: int
    stored_last: int  # storage.LastIndex(): unstable.offset - 1


# Go value-rendering of ConfChangeV2 (raftpb confchange String forms), used
# by the leader's "ignoring conf change" refusal line (raft.go:1034-1071).
_CC_GO_NAMES = {
    CC_ADD_NODE: "ConfChangeAddNode",
    CC_REMOVE_NODE: "ConfChangeRemoveNode",
    CC_UPDATE_NODE: "ConfChangeUpdateNode",
    CC_ADD_LEARNER: "ConfChangeAddLearnerNode",
}
_TRANSITION_GO = {
    "auto": "ConfChangeTransitionAuto",
    "implicit": "ConfChangeTransitionJointImplicit",
    "explicit": "ConfChangeTransitionJointExplicit",
}


def cc_go_str(changes, transition: str) -> str:
    chs = " ".join(
        "{%s %d}" % (_CC_GO_NAMES[t], nid + 1) for t, nid in changes
    )
    return "{%s [%s] []}" % (_TRANSITION_GO[transition], chs)


class InteractionEnv:
    """Driver state: nodes + in-flight message pool + output buffer
    (raft/rafttest/interaction_env.go:33-49)."""

    def __init__(self, spec: Spec | None = None, cfg: RaftConfig | None = None,
                 device=None):
        # defaultRaftConfig (interaction_env.go:64-74): ElectionTick=3,
        # HeartbeatTick=1, no limits — E/W sized so single messages carry
        # whole logs like the reference's MaxUint64 MaxSizePerMsg, and L
        # large enough that the engine's ring-pressure auto-compaction
        # (apply_round's occ > L - 2E trigger) never fires mid-scenario:
        # the reference only compacts on the explicit `compact` command.
        self.spec = spec or Spec(M=8, L=64, E=16, K=8, W=8, R=4, A=8)
        self.cfg = cfg or RaftConfig(
            election_tick=3, heartbeat_tick=1, max_inflight=8
        )
        self.device = resolve_device(device)
        self.nodes: list[RawNode] = []
        self.storages: list[MemoryStorage] = []
        self.history: list[list[Snapshot]] = []
        self.messages: list[HostMsg] = []
        self.payloads = PayloadTable()
        self.v1_words: set[int] = set()
        # per-node vote tally for the current campaign: (granted, rejected)
        # voter-id sets (the poll() bookkeeping, raft.go:837-845)
        self._votes: dict[int, tuple[set, set]] = {}
        self.lvl = LVL_DEBUG
        self._lines: list[str] = []
        self._indent = 0

    # -- output --------------------------------------------------------------
    def p(self, line: str) -> None:
        for sub in line.split("\n"):
            self._lines.append("  " * self._indent + sub)

    def log(self, lvl: int, line: str) -> None:
        if lvl >= self.lvl:
            self.p(f"{LVL_NAMES[lvl]} {line}")

    # -- id rendering --------------------------------------------------------
    @staticmethod
    def r(i) -> int:
        return int(i) + 1

    # -- describe helpers (raft/util.go) -------------------------------------
    def entry_str(self, e: Entry) -> str:
        if e.type == ENTRY_NORMAL:
            name = "EntryNormal"
            formatted = '"' + self.payloads.lookup(e.data).decode() + '"'
        else:
            name = (
                "EntryConfChange" if e.data in self.v1_words
                else "EntryConfChangeV2"
            )
            formatted = cc_changes_str(e.data)
        sep = " " if formatted else ""
        return f"{e.term}/{e.index} {name}{sep}{formatted}"

    def msg_str(self, m: HostMsg) -> str:
        out = (
            f"{self.r(m.frm)}->{self.r(m.to)} {MSG_NAMES[m.type]} "
            f"Term:{m.term} Log:{m.log_term}/{m.index}"
        )
        if m.reject:
            out += f" Rejected (Hint: {m.reject_hint})"
        if m.commit != 0:
            out += f" Commit:{m.commit}"
        if m.entries:
            out += " Entries:[" + ", ".join(
                self.entry_str(e) for e in m.entries
            ) + "]"
        if m.snapshot is not None and not m.snapshot.is_empty():
            meta = m.snapshot.meta
            out += (
                f" Snapshot: Index:{meta.index} Term:{meta.term} "
                f"ConfState:{conf_state_brackets(meta.conf_state)}"
            )
        return out

    def hard_state_str(self, hs) -> str:
        out = f"Term:{hs.term}"
        if hs.vote != -1:
            out += f" Vote:{self.r(hs.vote)}"
        return out + f" Commit:{hs.commit}"

    def ready_str(self, rd: Ready) -> str:
        parts = []
        if rd.soft_state is not None:
            parts.append(
                f"Lead:{self.r(rd.soft_state.lead)} "
                f"State:{ROLE_NAMES[rd.soft_state.role]}"
            )
        if rd.hard_state is not None:
            parts.append("HardState " + self.hard_state_str(rd.hard_state))
        if rd.read_states:
            rs = " ".join(
                "{" + f"{s.index} {s.request_ctx}" + "}" for s in rd.read_states
            )
            parts.append(f"ReadStates [{rs}]")
        if rd.entries:
            parts.append("Entries:")
            parts.extend(self.entry_str(e) for e in rd.entries)
        if rd.snapshot is not None and not rd.snapshot.is_empty():
            meta = rd.snapshot.meta
            parts.append(
                f"Snapshot Index:{meta.index} Term:{meta.term} "
                f"ConfState:{conf_state_brackets(meta.conf_state)}"
            )
        if rd.committed_entries:
            parts.append("CommittedEntries:")
            parts.extend(self.entry_str(e) for e in rd.committed_entries)
        if rd.messages:
            parts.append("Messages:")
            parts.extend(self.msg_str(m) for m in rd.messages)
        if not parts:
            return "<empty Ready>"
        ms = "true" if rd.must_sync else "false"
        return f"Ready MustSync={ms}:\n" + "\n".join(parts)

    # -- state-diff logger lines --------------------------------------------
    def _snap_state(self, idx: int) -> _StateSnap:
        rn = self.nodes[idx]
        n = rn.n
        return _StateSnap(
            term=int(n.term), role=int(n.role), lead=int(n.lead),
            vote=int(n.vote), snap_index=int(n.snap_index),
            conf=rn._conf_tuple(),
            commit=int(n.commit), applied=int(n.applied),
            last_index=int(n.last_index),
            stored_last=self.storages[idx].last_index(),
        )

    def _last_log(self, idx: int) -> tuple[int, int]:
        """(lastTerm, lastIndex) of a node's log."""
        n = self.nodes[idx].n
        li = int(n.last_index)
        if li == int(n.snap_index):
            return int(n.snap_term), li
        return int(n.log_term[(li - 1) % self.spec.L]), li

    def _term_at(self, idx: int, i: int) -> int:
        """zeroTermOnOutOfBounds(term(i)) (raft log.go)."""
        n = self.nodes[idx].n
        if i == int(n.snap_index):
            return int(n.snap_term)
        if int(n.snap_index) < i <= int(n.last_index):
            return int(n.log_term[(i - 1) % self.spec.L])
        return 0

    def _progress_of(self, idx: int, pid: int):
        return self.nodes[idx].status().progress.get(pid)

    def _emit_transitions(self, idx: int, before: _StateSnap,
                          trigger: HostMsg | None = None) -> None:
        rn = self.nodes[idx]
        n = rn.n
        term, role = int(n.term), int(n.role)
        rid = self.r(idx)
        if (
            trigger is not None
            and trigger.term > before.term
            and term > before.term
        ):
            self.log(
                LVL_INFO,
                f"{rid} [term: {before.term}] received a "
                f"{MSG_NAMES[trigger.type]} message with higher term from "
                f"{self.r(trigger.frm)} [term: {trigger.term}]",
            )
        restored = int(n.snap_index) > before.snap_index and (
            trigger is not None and trigger.type == MSG_SNAP
        )
        if restored:
            # raftLog.restore preamble (raft/log.go:86-90): unstable.offset
            # is one past the last persisted entry; everything this harness
            # appends is persisted at the next Ready, so offset derives from
            # the storage's last index at delivery time.
            self.log(
                LVL_INFO,
                f"log [committed={before.commit}, applied={before.applied}, "
                f"unstable.offset={before.stored_last + 1}, "
                f"len(unstable.Entries)="
                f"{before.last_index - before.stored_last}] starts to "
                f"restore snapshot [index: {int(n.snap_index)}, "
                f"term: {int(n.snap_term)}]",
            )
        if restored and rn._conf_tuple() != before.conf:
            self.log(
                LVL_INFO,
                f"{rid} switched to configuration {conf_str(rn.conf_state())}",
            )
        if role != before.role or term != before.term:
            self.log(
                LVL_INFO,
                f"{rid} became {ROLE_LOG_NAMES[role]} at term {term}",
            )
        if restored:
            si, st = int(n.snap_index), int(n.snap_term)
            c = int(n.commit)
            self.log(
                LVL_INFO,
                f"{rid} [commit: {c}, lastindex: {int(n.last_index)}, "
                f"lastterm: {st}] restored snapshot "
                f"[index: {si}, term: {st}]",
            )
            self.log(
                LVL_INFO,
                f"{rid} [commit: {c}] restored snapshot "
                f"[index: {si}, term: {st}]",
            )

    # -- commands ------------------------------------------------------------
    def add_nodes(self, n: int, voters=(), learners=(), index=0, content=b""):
        """interaction_env_handler_add_nodes.go:54-131."""
        bootstrap = bool(voters or learners or index)
        for _ in range(n):
            idx = len(self.nodes)
            storage = MemoryStorage()
            cs = ConfState(
                voters=tuple(voters), learners=tuple(learners)
            )
            snap = Snapshot(
                meta=SnapshotMeta(
                    index=index, term=1 if bootstrap else 0, conf_state=cs
                ),
                data=(self.payloads.intern(content),) if content else (),
            )
            if bootstrap:
                if index <= 1:
                    raise ValueError(
                        "index must be specified as > 1 due to bootstrap"
                    )
                storage.apply_snapshot(snap)
            rn = RawNode(
                self.cfg, self.spec, storage, idx, applied=index, seed=idx,
                device=self.device,
            )
            self.nodes.append(rn)
            self.storages.append(storage)
            self.history.append([snap])
            rid = self.r(idx)
            self.log(
                LVL_INFO,
                f"{rid} switched to configuration {conf_str(cs)}",
            )
            self.log(LVL_INFO, f"{rid} became follower at term 0")
            peers = ",".join(
                str(self.r(i)) for i in sorted((*voters, *learners))
            )
            n_ = rn.n
            self.log(
                LVL_INFO,
                f"newRaft {rid} [peers: [{peers}], term: 0, commit: "
                f"{int(n_.commit)}, applied: {int(n_.applied)}, lastindex: "
                f"{int(n_.last_index)}, lastterm: "
                f"{int(n_.snap_term) if int(n_.last_index) == int(n_.snap_index) else int(n_.log_term[(int(n_.last_index) - 1) % self.spec.L])}]",
            )

    def campaign(self, idx: int) -> None:
        before = self._snap_state(idx)
        rn = self.nodes[idx]
        msgs0 = len(rn._pending_msgs)
        rid = self.r(idx)
        self.log(
            LVL_INFO,
            f"{rid} is starting a new election at term {before.term}",
        )
        self._votes[idx] = ({idx}, set())
        rn.campaign()
        n = rn.n
        role, term = int(n.role), int(n.term)
        if role == ROLE_LEADER and before.role != ROLE_LEADER:
            # singleton fast path: the whole candidate->leader cascade ran
            # inside one step; reconstruct the intermediate transitions the
            # reference logs one call at a time (campaign, raft.go:785-835)
            self.log(LVL_INFO, f"{rid} became candidate at term {term}")
            self.log(
                LVL_INFO,
                f"{rid} received MsgVoteResp from {rid} at term {term}",
            )
            self.log(LVL_INFO, f"{rid} became leader at term {term}")
        else:
            self._emit_transitions(idx, before)
            self._emit_campaign_lines(idx, before, msgs0)

    def _emit_campaign_lines(self, idx, before, msgs0) -> None:
        rn = self.nodes[idx]
        n = rn.n
        rid = self.r(idx)
        role = int(n.role)
        if role in (ROLE_CANDIDATE, ROLE_PRE_CANDIDATE, ROLE_LEADER):
            # self vote recorded (poll, raft.go:837-845)
            vt = "MsgPreVoteResp" if role == ROLE_PRE_CANDIDATE else "MsgVoteResp"
            self.log(
                LVL_INFO,
                f"{rid} received {vt} from {rid} at term {int(n.term)}",
            )
        for m in rn._pending_msgs[msgs0:]:
            if m.type in (MSG_VOTE, MSG_PRE_VOTE):
                self.log(
                    LVL_INFO,
                    f"{rid} [logterm: {m.log_term}, index: {m.index}] sent "
                    f"{MSG_NAMES[m.type]} request to {self.r(m.to)} at term "
                    f"{int(n.term)}",
                )

    def propose(self, idx: int, data: bytes | str) -> None:
        word = self.payloads.intern(data)
        if not self.nodes[idx].propose(word):
            self._err = "raft proposal dropped"
            self.p(self._err)

    def propose_conf_change(self, idx: int, changes, v1=False,
                            transition="auto") -> None:
        """interaction_env_handler_propose_conf_change.go; encoding per
        ConfChangeV2.EnterJoint/LeaveJoint semantics
        (raftpb/confchange.go:57-102)."""
        if v1 and (len(changes) > 1 or transition != "auto"):
            self.p(
                "v1 conf change can only have one operation and no transition"
            )
            return
        rn = self.nodes[idx]
        if int(rn.n.role) == ROLE_LEADER:
            # the appendEntry guard (raft.go:1034-1071): the leader demotes
            # a refused conf change to an empty entry and says why
            cs = rn.conf_state()
            joint = bool(cs.voters_outgoing)
            wants_leave = not changes
            pci, applied = int(rn.n.pending_conf_index), int(rn.n.applied)
            reason = None
            if pci > applied:
                reason = (
                    f"possible unapplied conf change at index {pci} "
                    f"(applied to {applied})"
                )
            elif joint and not wants_leave:
                reason = "must transition out of joint config first"
            elif not joint and wants_leave:
                reason = "not in joint state; refusing empty conf change"
            if reason:
                self.log(
                    LVL_INFO,
                    f"{self.r(idx)} ignoring conf change "
                    f"{cc_go_str(changes, transition)} at config "
                    f"{conf_str(cs)}: {reason}",
                )
        if not changes and transition == "auto":
            word = ccmod.encode_leave_joint()
        else:
            enter = transition != "auto" or len(changes) > 1
            auto_leave = transition in ("auto", "implicit")
            # the packed word carries at most 2 changes; longer batches only
            # appear in scenarios where the leader must refuse them anyway
            # (joint-config guard demotes the entry to an empty normal one,
            # raft.go:1034-1071), so the truncation is never applied
            word = ccmod.encode(
                changes[:2], enter_joint=enter, auto_leave=auto_leave
            )
        if v1:
            self.v1_words.add(word)
        if not self.nodes[idx].propose_conf_change(word):
            self._err = "raft proposal dropped"
            self.p(self._err)

    def deliver_msgs(self, recipients: list[tuple[int, bool]]) -> int:
        """recipients: [(idx, drop)] (interaction_env_handler_deliver_msgs.go)."""
        count = 0
        for idx, drop in recipients:
            mine = [m for m in self.messages if m.to == idx]
            self.messages = [m for m in self.messages if m.to != idx]
            count += len(mine)
            for m in mine:
                if drop:
                    self.p("dropped: " + self.msg_str(m))
                    continue
                self.p(self.msg_str(m))
                self._deliver_one(idx, m)
        return count

    def _deliver_one(self, idx: int, m: HostMsg) -> None:
        if m.type == MSG_SNAP and m.snapshot is not None:
            # the env overrides snapshot *data* from the sender's history
            # (snapOverrideStorage, interaction_env_handler_add_nodes.go:39-58)
            for snap in reversed(self.history[m.frm]):
                if snap.meta.index <= m.snapshot.meta.index:
                    m = dataclasses.replace(
                        m,
                        snapshot=dataclasses.replace(
                            m.snapshot, data=snap.data
                        ),
                    )
                    break
        rn = self.nodes[idx]
        before = self._snap_state(idx)
        msgs0 = len(rn._pending_msgs)
        # pre-step observations for the logger lines only derivable from
        # state the step overwrites
        lead_resp = (
            m.type in (MSG_APP_RESP, MSG_HEARTBEAT_RESP)
            and before.role == ROLE_LEADER
        )
        pre_prog = self._progress_of(idx, m.frm) if lead_resp else None
        pre_terms = (
            np.asarray(rn.n.log_term)
            if m.type == MSG_APP and m.entries else None
        )
        try:
            rn.step(m)
        except (ErrStepLocalMsg, ErrStepPeerNotFound) as e:
            self.p(str(e))
            return
        delta = rn._pending_msgs[msgs0:]
        self._emit_vote_tally(idx, before, m)
        # becomeCandidate/becomePreCandidate reset the poll bookkeeping;
        # a step-triggered candidacy (pre-vote won, MsgTimeoutNow) must
        # reset it here too, after the triggering response was tallied
        role_now = int(rn.n.role)
        stepped_into_candidacy = role_now in (
            ROLE_CANDIDATE, ROLE_PRE_CANDIDATE
        ) and role_now != before.role
        if stepped_into_candidacy:
            self._votes[idx] = ({idx}, set())
        self._emit_transitions(idx, before, trigger=m)
        if stepped_into_candidacy:
            # campaign() ran inside this step (pre-vote won, MsgTimeoutNow):
            # Go logs the self-vote poll and the vote-request sends too
            self._emit_campaign_lines(idx, before, msgs0)
        self._emit_post_step(idx, before, m, delta, pre_prog, pre_terms)

    def _emit_vote_tally(self, idx: int, before: _StateSnap,
                         m: HostMsg) -> None:
        """poll() receipt + tally (raft.go:837-845, stepCandidate) — logged
        before any role transition the response triggers."""
        if (
            m.type not in (MSG_VOTE_RESP, MSG_PRE_VOTE_RESP)
            or before.role not in (ROLE_CANDIDATE, ROLE_PRE_CANDIDATE)
            or m.term < before.term  # stale responses are ignored outright
        ):
            return
        # a response at a higher term dethrones the candidate instead of
        # being polled — EXCEPT a granted pre-vote response, which echoes
        # the candidate's future term (raft.go Step's MsgPreVoteResp carve-
        # out) and is the normal pre-vote grant
        if m.term > before.term and not (
            m.type == MSG_PRE_VOTE_RESP and not m.reject
        ):
            return
        gr, rj = self._votes.setdefault(idx, (set(), set()))
        (rj if m.reject else gr).add(m.frm)
        rid = self.r(idx)
        name = MSG_NAMES[m.type]
        if m.reject:
            self.log(
                LVL_INFO,
                f"{rid} received {name} rejection from {self.r(m.frm)} "
                f"at term {before.term}",
            )
        else:
            self.log(
                LVL_INFO,
                f"{rid} received {name} from {self.r(m.frm)} "
                f"at term {before.term}",
            )
        self.log(
            LVL_INFO,
            f"{rid} has received {len(gr)} {name} votes and "
            f"{len(rj)} vote rejections",
        )

    def _emit_post_step(self, idx: int, before: _StateSnap, m: HostMsg,
                        delta: list[HostMsg], pre_prog,
                        pre_terms) -> None:
        """Logger lines derived from what the step did: vote casting,
        append rejection/conflict, and the leader's probe/snapshot
        bookkeeping (raft.go stepLeader / handleAppendEntries)."""
        rn = self.nodes[idx]
        n = rn.n
        rid = self.r(idx)
        if m.type in (MSG_VOTE, MSG_PRE_VOTE):
            resp = next(
                (p for p in delta
                 if p.type in (MSG_VOTE_RESP, MSG_PRE_VOTE_RESP)), None
            )
            if resp is None:
                return
            lt, li = self._last_log(idx)
            # r.Vote at log time: reset by a real-vote term bump; a
            # pre-vote never changes term or vote, so the recorded vote
            # still shows
            shown = (
                0 if m.term > before.term and m.type == MSG_VOTE
                else self.r(before.vote)
            )
            verb = (
                f"rejected {MSG_NAMES[m.type]} from"
                if resp.reject else f"cast {MSG_NAMES[m.type]} for"
            )
            self.log(
                LVL_INFO,
                f"{rid} [logterm: {lt}, index: {li}, vote: {shown}] {verb} "
                f"{self.r(m.frm)} [logterm: {m.log_term}, "
                f"index: {m.index}] at term {int(n.term)}",
            )
        elif m.type == MSG_APP:
            reject = next(
                (p for p in delta if p.type == MSG_APP_RESP and p.reject),
                None,
            )
            if reject is not None:
                # handleAppendEntries rejection (raft.go:1633-1668); the
                # log is untouched, so the post-step term lookup is the
                # pre-step one
                self.log(
                    LVL_DEBUG,
                    f"{rid} [logterm: {self._term_at(idx, m.index)}, "
                    f"index: {m.index}] rejected MsgApp "
                    f"[logterm: {m.log_term}, index: {m.index}] "
                    f"from {self.r(m.frm)}",
                )
            elif pre_terms is not None:
                # findConflict + truncateAndAppend (raft/log.go:118-151):
                # first overlapping entry whose stored term differs
                for e in m.entries:
                    if e.index > before.last_index:
                        break
                    if e.index <= before.snap_index:
                        continue
                    ext = int(pre_terms[(e.index - 1) % self.spec.L])
                    if ext != e.term:
                        self.log(
                            LVL_INFO,
                            f"found conflict at index {e.index} [existing "
                            f"term: {ext}, conflicting term: {e.term}]",
                        )
                        self.log(
                            LVL_INFO,
                            f"replace the unstable entries from index "
                            f"{e.index}",
                        )
                        break
        elif pre_prog is not None:
            # one post-step Status serves the response lookup and every
            # snapshot the step emitted
            post_progs = rn.status().progress
            post = post_progs.get(m.frm)
            if m.type == MSG_APP_RESP and m.reject:
                self.log(
                    LVL_DEBUG,
                    f"{rid} received MsgAppResp(rejected, hint: (index "
                    f"{m.reject_hint}, term {m.log_term})) from "
                    f"{self.r(m.frm)} for index {m.index}",
                )
                if post is not None and (
                    (post.match, post.next) != (pre_prog.match, pre_prog.next)
                    or post.state != pre_prog.state
                ):
                    # MaybeDecrTo succeeded. The reference prints the
                    # progress between the decrease and the BecomeProbe/
                    # snapshot transition the same step performs: a
                    # replicating peer still shows StateReplicate with
                    # next=match+1 (tracker MaybeDecrTo's replicate arm);
                    # a probing one shows the new next, unchanged by the
                    # later transition.
                    if pre_prog.state == PR_REPLICATE:
                        shown = (
                            f"StateReplicate match={pre_prog.match} "
                            f"next={pre_prog.match + 1}"
                        )
                    else:
                        shown = (
                            f"StateProbe match={post.match} "
                            f"next={post.next}"
                        )
                    self.log(
                        LVL_DEBUG,
                        f"{rid} decreased progress of {self.r(m.frm)} to "
                        f"[{shown}]",
                    )
            elif (
                m.type == MSG_APP_RESP
                and pre_prog.state == PR_SNAPSHOT
                and post is not None
                and post.state != PR_SNAPSHOT
            ):
                nxt = max(pre_prog.next, m.index + 1)
                self.log(
                    LVL_DEBUG,
                    f"{rid} recovered from needing snapshot, resumed "
                    f"sending replication messages to {self.r(m.frm)} "
                    f"[StateSnapshot match={m.index} next={nxt} paused "
                    f"pendingSnap={pre_prog.pending_snapshot}]",
                )
            for pm in delta:
                if pm.type != MSG_SNAP or pm.snapshot is None:
                    continue
                p = post_progs.get(pm.to)
                meta = pm.snapshot.meta
                self.log(
                    LVL_DEBUG,
                    f"{rid} [firstindex: {int(n.snap_index) + 1}, "
                    f"commit: {int(n.commit)}] sent snapshot"
                    f"[index: {meta.index}, term: {meta.term}] to "
                    f"{self.r(pm.to)} [StateProbe match={p.match} "
                    f"next={p.next}]",
                )
                self.log(
                    LVL_DEBUG,
                    f"{rid} paused sending replication messages to "
                    f"{self.r(pm.to)} [{p}]",
                )

    def process_ready(self, idx: int) -> None:
        """interaction_env_handler_process_ready.go:40-102."""
        rn, storage = self.nodes[idx], self.storages[idx]
        rd = rn.ready()
        self.p(self.ready_str(rd))
        if rd.hard_state is not None:
            storage.set_hard_state(rd.hard_state)
        if rd.entries:
            storage.append(rd.entries)
        if rd.snapshot is not None and not rd.snapshot.is_empty():
            storage.apply_snapshot(rd.snapshot)
        self.messages.extend(rd.messages)
        rn.advance(rd)
        for cs in rn.last_conf_states:
            self.log(
                LVL_INFO,
                f"{self.r(idx)} switched to configuration {conf_str(cs)}",
            )
            if (
                cs.voters_outgoing and cs.auto_leave
                and int(rn.n.role) == ROLE_LEADER
            ):
                # the leader schedules the empty leave-joint entry the
                # moment it applies an auto-leave joint config
                # (raft.go:668-692)
                self.log(
                    LVL_INFO,
                    "initiating automatic transition out of joint "
                    f"configuration {conf_str(cs)}",
                )
        # the "appender state machine" history (process_ready.go:64-90)
        hist = self.history[idx]
        for e in rd.committed_entries:
            last = hist[-1]
            data = last.data
            if e.type == ENTRY_NORMAL and e.data:
                data = data + (e.data,)
            hist.append(
                Snapshot(
                    meta=SnapshotMeta(
                        index=e.index, term=e.term,
                        conf_state=rn.conf_state(),
                        app_hash=int(rn.n.applied_hash),
                    ),
                    data=data,
                )
            )

    def stabilize(self, idxs: list[int] | None = None) -> None:
        """Fixpoint loop (interaction_env_handler_stabilize.go:152-185)."""
        sel = idxs if idxs else list(range(len(self.nodes)))
        while True:
            done = True
            for idx in sel:
                if self.nodes[idx].has_ready():
                    done = False
                    self.p(f"> {self.r(idx)} handling Ready")
                    self._indent += 1
                    self.process_ready(idx)
                    self._indent -= 1
            for idx in sel:
                if any(m.to == idx for m in self.messages):
                    done = False
                    self.p(f"> {self.r(idx)} receiving messages")
                    self._indent += 1
                    self.deliver_msgs([(idx, False)])
                    self._indent -= 1
            if done:
                return

    def compact(self, idx: int, compact_index: int) -> None:
        self.storages[idx].compact(compact_index)
        self.nodes[idx].compact_to(compact_index)
        self.raft_log(idx)

    def raft_log(self, idx: int) -> None:
        storage = self.storages[idx]
        fi, li = storage.first_index(), storage.last_index()
        if li < fi:
            self.p(f"log is empty: first index={fi}, last index={li}")
            return
        for e in storage.entries(fi, li + 1):
            self.p(self.entry_str(e))

    def status(self, idx: int) -> None:
        st = self.nodes[idx].status()
        for pid in sorted(st.progress):
            self.p(f"{self.r(pid)}: {st.progress[pid]}")

    def tick_heartbeat(self, idx: int) -> None:
        self.nodes[idx].tick()

    # -- dispatcher ----------------------------------------------------------
    def handle(self, case) -> str:
        """Execute one datadriven Case; returns the output block
        (interaction_env_handler.go:29-146)."""
        self._lines = []
        self._err = None
        try:
            self._dispatch(case)
        except Exception as e:  # errors go to the output buffer
            self._err = f"{type(e).__name__}: {e}"
            self.p(self._err)
        if not self._lines:
            return "ok"
        if self.lvl == LVL_NONE:
            return self._err if self._err else "ok (quiet)"
        return "\n".join(self._lines)

    def _dispatch(self, case) -> None:
        cmd, args, inp = case.cmd, case.args, case.input
        pos = args.get("_pos", [])
        if cmd == "log-level":
            name = pos[0]
            self.lvl = LVL_NAMES.index(name.upper())
            return
        if cmd == "add-nodes":
            ids = lambda key: tuple(int(v) - 1 for v in args.get(key, []))
            self.add_nodes(
                int(pos[0]),
                voters=ids("voters"),
                learners=ids("learners"),
                index=int(args.get("index", [0])[0]),
                content=args.get("content", [""])[0],
            )
            return
        if cmd == "campaign":
            self.campaign(int(pos[0]) - 1)
            return
        if cmd == "propose":
            self.propose(int(pos[0]) - 1, pos[1])
            return
        if cmd == "propose-conf-change":
            ops = {"v": CC_ADD_NODE, "l": CC_ADD_LEARNER,
                   "r": CC_REMOVE_NODE, "u": CC_UPDATE_NODE}
            changes = []
            for tok in " ".join(inp).split():
                changes.append((ops[tok[0]], int(tok[1:]) - 1))
            self.propose_conf_change(
                int(pos[0]) - 1,
                changes,
                v1=args.get("v1", ["false"])[0] == "true",
                transition=args.get("transition", ["auto"])[0],
            )
            return
        if cmd == "deliver-msgs":
            rs = [(int(v) - 1, False) for v in pos]
            rs += [(int(v) - 1, True) for v in args.get("drop", [])]
            if self.deliver_msgs(rs) == 0:
                self.p("no messages")
            return
        if cmd == "process-ready":
            idxs = [int(v) - 1 for v in pos]
            for idx in idxs:
                if len(idxs) > 1:
                    self.p(f"> {self.r(idx)} handling Ready")
                    self._indent += 1
                    self.process_ready(idx)
                    self._indent -= 1
                else:
                    self.process_ready(idx)
            return
        if cmd == "stabilize":
            self.stabilize([int(v) - 1 for v in pos])
            return
        if cmd == "compact":
            self.compact(int(pos[0]) - 1, int(pos[1]))
            return
        if cmd == "raft-log":
            self.raft_log(int(pos[0]) - 1)
            return
        if cmd == "status":
            self.status(int(pos[0]) - 1)
            return
        if cmd == "tick-heartbeat":
            self.tick_heartbeat(int(pos[0]) - 1)
            return
        if cmd == "_breakpoint":
            return
        raise ValueError(f"unknown command {cmd}")
