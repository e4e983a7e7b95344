"""The black-box forensics plane (etcd_tpu/models/blackbox.py): per-group
event rings and their post-mortem decode.

  * :class:`EventRing`: ``ring[W, M, C]`` holds one bit-packed int32 event
    word per (window slot, member, group) for the last W rounds (slot =
    round % W): the member's role, its role and term transitions, its
    commit and applied deltas, the message classes it sent and received,
    the crash, restart and down flags, conf-change applies and snapshot
    installs.
  * :func:`blackbox_update`: one read-only pass over the (pre, post) round
    states and the consumed and emitted wire, shared by the metered round,
    the chaos epoch and the Cluster. The round's slot is written in place
    at a slot index that stays on the device, so the pass runs inside a
    CUDA graph and never copies the ring.
  * on a violation, :func:`first_k_offenders` and :func:`gather_forensics`
    reduce the per-group violation masks on the device to the first K
    offending groups and copy only their lanes ([W, M, K], never
    [W, M, C]); :func:`forensics_report` decodes them into per-round,
    per-member timelines.
  * :func:`to_chrome_trace`: the Chrome trace-event JSON (one track per
    member, one per host request) that Perfetto loads.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from etcd_tpu_torch.models.state import NodeState
from etcd_tpu_torch.types import (
    MSG_APP,
    MSG_APP_RESP,
    MSG_HEARTBEAT,
    MSG_HEARTBEAT_RESP,
    MSG_HUP,
    MSG_PRE_VOTE,
    MSG_PRE_VOTE_RESP,
    MSG_SNAP,
    MSG_SNAP_STATUS,
    MSG_TIMEOUT_NOW,
    MSG_TRANSFER_LEADER,
    MSG_VOTE,
    MSG_VOTE_RESP,
    ROLE_LEADER,
    Msg,
    Spec,
    TensorStruct,
)

# rounds of history per group
DEFAULT_WINDOW = 32

# ---------------------------------------------------------------------------
# event-word bit layout (int32, bit 31 clear, so a word is never negative)
#
#   bits  0-1   role after the round (ROLE_* 0..3)
#   bit   2     role transition (post.role != pre.role)
#   bits  3-5   term delta this round, clamped to [0, 7]
#   bits  6-8   commit delta, clamped to [0, 7]
#   bits  9-11  applied delta, clamped to [0, 7]
#   bit   12    snapshot install (applied jump > Spec.A)
#   bit   13    conf-change apply (an applied config mask changed)
#   bit   14    crashed this round (chaos tier)
#   bit   15    restart completed this round (chaos tier)
#   bit   16    down this round (chaos tier)
#   bits 17-20  message classes sent (append/election/heartbeat/other)
#   bits 21-24  message classes received (the same mask)
#   bits 25-27  messages sent, clamped to [0, 7]
#   bits 28-30  messages received, clamped to [0, 7]
# ---------------------------------------------------------------------------

ROLE_NAMES = ("follower", "pre-candidate", "candidate", "leader")
MSG_CLASSES = ("append", "election", "heartbeat", "other")

_CLASS_APPEND = (MSG_APP, MSG_APP_RESP, MSG_SNAP, MSG_SNAP_STATUS)
_CLASS_ELECT = (MSG_VOTE, MSG_VOTE_RESP, MSG_PRE_VOTE, MSG_PRE_VOTE_RESP,
                MSG_TIMEOUT_NOW, MSG_TRANSFER_LEADER, MSG_HUP)
_CLASS_HEARTBEAT = (MSG_HEARTBEAT, MSG_HEARTBEAT_RESP)
_N_MSG_TYPES = 18
_N_CLASSES = 5          # 0 (no class) and the four of MSG_CLASSES


def _class_table() -> np.ndarray:
    """Message type -> class id (1-based; 0 for the empty slot)."""
    t = np.zeros((_N_MSG_TYPES,), np.int32)
    t[list(_CLASS_APPEND)] = 1
    t[list(_CLASS_ELECT)] = 2
    t[list(_CLASS_HEARTBEAT)] = 3
    # every other nonzero type (prop, read-index, unreachable, ...)
    t[1:][t[1:] == 0] = 4
    return t


_CLASS_TABLE = _class_table()
# the table as 3-bit fields of two int32 words (type i at bits 3i..3i+2 of
# the low word, type 10 + i of the high one), read with a shift: no table
# tensor is copied to the device inside a round
_CLASS_LO = sum(int(c) << (3 * i) for i, c in enumerate(_CLASS_TABLE[:10]))
_CLASS_HI = sum(int(c) << (3 * i) for i, c in enumerate(_CLASS_TABLE[10:]))


@dataclasses.dataclass
class EventRing(TensorStruct):
    """The ring carry: ``ring[W, M, C]`` int32 event words of the last W
    rounds, and ``round``, the rounds observed (int32 0-dim)."""

    round: torch.Tensor
    ring: torch.Tensor


def init_blackbox(spec: Spec, state: NodeState,
                  window: int = DEFAULT_WINDOW) -> EventRing:
    """A ring attached to a live (unpacked) fleet, on its device; each leaf
    has storage of its own."""
    if not 2 <= window <= 256:
        raise ValueError(f"blackbox window={window} outside [2, 256]")
    C = state.term.shape[-1]
    dev = state.term.device
    return EventRing(round=torch.zeros((), dtype=torch.int32, device=dev),
                     ring=torch.zeros((window, spec.M, C), dtype=torch.int32, device=dev))


def msg_activity(spec: Spec, msg: Msg, side: str):
    """One side of a wire's message activity per member, in either storage
    form (flat [from, K*to(*E), C] or compacted [B, to(*E), C]): (count,
    classes), each int32 [M, C], ``classes`` a bitmask with bit g - 1 set
    when a message of class g took part. ``side`` "sent" attributes a
    message to its ``frm`` field, "recv" to the receiver its slot is laid
    out for (middle-axis slot k*M + to in both forms).

    One scatter_add_ of ones into [M + 1, 5, C] counts the messages per
    (member, class); the extra row takes the empty slots (and a sender id
    outside [0, M)), so no [A, S, M, C] temporary is made."""
    M = spec.M
    t = msg.type.to(torch.int32)        # the int16 wire compares as int32
    A, S, C = t.shape
    dev = t.device
    live = t != 0
    t = t.clamp(0, _N_MSG_TYPES - 1)
    cls = torch.where(t < 10, (_CLASS_LO >> (3 * t.clamp_max(9))) & 7,
                      (_CLASS_HI >> (3 * (t - 10).clamp_min(0))) & 7)
    del t
    if side == "sent":
        who = msg.frm.to(torch.int32)
        live = live & (who >= 0) & (who < M)
    elif side == "recv":
        who = (torch.arange(S, dtype=torch.int32, device=dev) % M).view(1, S, 1)
    else:
        raise ValueError(f"side must be 'sent' or 'recv', got {side!r}")
    code = torch.where(live, who * _N_CLASSES + cls, M * _N_CLASSES).view(A * S, C)
    del cls, who, live
    counts = torch.zeros(((M + 1) * _N_CLASSES, C), dtype=torch.int32, device=dev)
    counts.scatter_add_(0, code.long(),
                        torch.ones((), dtype=torch.int32, device=dev).expand(A * S, C))
    counts = counts[: M * _N_CLASSES].view(M, _N_CLASSES, C)
    total = counts.sum(1, dtype=torch.int32)
    bits = torch.zeros((M, C), dtype=torch.int32, device=dev)
    for g in range(1, _N_CLASSES):
        bits = bits | ((counts[:, g] > 0).to(torch.int32) << (g - 1))
    return total, bits


def _activity(spec: Spec, x, side: str):
    """``x`` is a wire, or its msg_activity already taken (before a round
    that overwrites its inbox consumed it)."""
    return msg_activity(spec, x, side) if isinstance(x, Msg) else x


def _event_word(spec: Spec, pre, post: NodeState, inbox, outbox, crashed,
                restarted, down) -> torch.Tensor:
    """One round's [M, C] event words (the layout above)."""
    i32 = torch.int32

    def clip3(x):
        return torch.clamp(x, 0, 7).to(i32)

    w = post.role.to(i32) & 0x3
    w = w | ((post.role != pre.role).to(i32) << 2)
    w = w | (clip3(post.term - pre.term) << 3)
    w = w | (clip3(post.commit - pre.commit) << 6)
    dap = post.applied - pre.applied
    w = w | (clip3(dap) << 9)
    w = w | ((dap > spec.A).to(i32) << 12)
    cc = ((pre.voters != post.voters) | (pre.voters_out != post.voters_out)
          | (pre.learners != post.learners)
          | (pre.learners_next != post.learners_next)).any(1)
    w = w | (cc.to(i32) << 13)
    for flag, bit in ((crashed, 14), (restarted, 15), (down, 16)):
        if flag is not None:
            w = w | (flag.to(i32) << bit)
    if outbox is not None:
        sent, bits = _activity(spec, outbox, "sent")
        w = w | (bits << 17) | (clip3(sent) << 25)
    if inbox is not None:
        recv, bits = _activity(spec, inbox, "recv")
        w = w | (bits << 21) | (clip3(recv) << 28)
    return w


# the NodeState leaves the planes read before the round
PRE_FIELDS = ("role", "term", "commit", "applied",
              "voters", "voters_out", "learners", "learners_next")


@dataclasses.dataclass
class PreRound(TensorStruct):
    """Copies of the leaves of the state before a round that the planes
    and the membership counters read (a round under fleet_chunks > 1, or a
    crash restart, writes into the state it is given)."""

    role: torch.Tensor
    term: torch.Tensor
    commit: torch.Tensor
    applied: torch.Tensor
    voters: torch.Tensor
    voters_out: torch.Tensor
    learners: torch.Tensor
    learners_next: torch.Tensor


def snapshot_pre(state: NodeState) -> PreRound:
    return PreRound(**{k: getattr(state, k).clone() for k in PRE_FIELDS})


def blackbox_update(spec: Spec, bb: EventRing, pre, post: NodeState, inbox=None,
                    outbox=None, crashed=None, restarted=None, down=None,
                    write_mask=None) -> EventRing:
    """One round's ring pass over the (unpacked) states before and after the
    round and the consumed (``inbox``) and emitted (``outbox``) wire, each
    a Msg or its msg_activity; reads only. ``crashed``, ``restarted`` and
    ``down`` ([M, C] bool or None) are the chaos tier's crash flags.
    ``write_mask`` ([C] bool or None) selects the groups that still record:
    the chaos tier freezes a group's ring at its first violation, so the
    window it keeps ends there.

    The word is written into slot ``round % W`` of ``bb.ring`` in place
    (index_copy_ at a device index); the result holds that same ring."""
    W = bb.ring.shape[0]
    word = _event_word(spec, pre, post, inbox, outbox, crashed, restarted, down)
    slot = (bb.round % W).long().view(1)
    if write_mask is not None:
        word = torch.where(write_mask, word, bb.ring.index_select(0, slot)[0])
    bb.ring.index_copy_(0, slot, word.unsqueeze(0))
    return EventRing(round=bb.round + 1, ring=bb.ring)


# ---------------------------------------------------------------------------
# the on-violation reduction on the device
# ---------------------------------------------------------------------------


def first_k_offenders(mask: torch.Tensor, k: int) -> torch.Tensor:
    """The first k set group ids of a [C] bool mask, on its device: int32
    ids in ascending order, padded with the sentinel C where fewer than k
    groups are set. The sort runs over one [C] int32 lane."""
    C = mask.shape[0]
    idx = torch.where(mask, torch.arange(C, dtype=torch.int32, device=mask.device), C)
    return torch.sort(idx).values[:k]


def gather_forensics(ring: EventRing, viol_groups: torch.Tensor,
                     viol_round: torch.Tensor, k: int) -> dict:
    """Reduce and gather on the device, then copy only the first k
    offending groups' lanes ([W, M, k]): numpy arrays keyed ids, rings,
    bits, viol_round, total and round."""
    C = viol_groups.shape[0]
    ids = first_k_offenders(viol_groups != 0, k)
    safe = torch.clamp_max(ids, C - 1).long()    # sentinel lanes gather a dummy
    got = {
        "ids": ids,
        "rings": ring.ring.index_select(2, safe),
        "bits": viol_groups[safe],
        "viol_round": viol_round[safe],
        "total": (viol_groups != 0).sum().to(torch.int32),
        "round": ring.round,
    }
    return {name: x.cpu().numpy() for name, x in got.items()}


# ---------------------------------------------------------------------------
# host-side decode
# ---------------------------------------------------------------------------


def decode_word(w: int) -> dict:
    """One event word -> its fields (the layout above)."""
    w = int(w)
    return {
        "role": ROLE_NAMES[w & 0x3],
        "role_change": bool((w >> 2) & 1),
        "term_delta": (w >> 3) & 0x7,
        "commit_delta": (w >> 6) & 0x7,
        "applied_delta": (w >> 9) & 0x7,
        "snapshot_install": bool((w >> 12) & 1),
        "conf_change": bool((w >> 13) & 1),
        "crashed": bool((w >> 14) & 1),
        "restarted": bool((w >> 15) & 1),
        "down": bool((w >> 16) & 1),
        "sent": [MSG_CLASSES[g] for g in range(4) if (w >> (17 + g)) & 1],
        "recv": [MSG_CLASSES[g] for g in range(4) if (w >> (21 + g)) & 1],
        "sent_count": (w >> 25) & 0x7,
        "recv_count": (w >> 28) & 0x7,
    }


def word_events(d: dict) -> list:
    """The events of one decoded word as short strings."""
    ev = [name for name, key in (("crash", "crashed"), ("restart", "restarted"),
                                 ("down", "down")) if d[key]]
    if d["role_change"]:
        ev.append("became-leader" if d["role"] == ROLE_NAMES[ROLE_LEADER]
                  else f"became-{d['role']}")
    if d["term_delta"]:
        ev.append(f"term+{d['term_delta']}")
    if d["snapshot_install"]:
        ev.append("snap-install")
    elif d["applied_delta"]:
        ev.append(f"applied+{d['applied_delta']}")
    if d["commit_delta"]:
        ev.append(f"commit+{d['commit_delta']}")
    if d["conf_change"]:
        ev.append("conf-change")
    if d["sent"]:
        ev.append("sent:" + "|".join(d["sent"]))
    if d["recv"]:
        ev.append("recv:" + "|".join(d["recv"]))
    return ev


def ring_timeline(ring_wm: np.ndarray, end_round: int) -> list:
    """One group's ring lanes ([W, M] int32) as per-round rows; the ring
    covers rounds [end_round - W + 1, end_round], clipped at 0, where
    ``end_round`` is the last round it recorded."""
    W, M = ring_wm.shape
    rows = []
    for r in range(max(0, end_round - W + 1), end_round + 1):
        members = []
        for m in range(M):
            d = decode_word(ring_wm[r % W, m])
            members.append({"member": m, "role": d["role"],
                            "word": int(ring_wm[r % W, m]), "events": word_events(d)})
        rows.append({"round": r, "members": members})
    return rows


# bit order of harness/chaos.py VIOLATION_KEYS (which asserts it)
VIOLATION_BIT_NAMES = (
    "multi_leader", "hash_mismatch", "commit_regress",
    "lost_commit", "log_divergence", "term_regress",
)


def violation_names(bits: int) -> list:
    return [n for i, n in enumerate(VIOLATION_BIT_NAMES) if (int(bits) >> i) & 1]


def forensics_report(ring: EventRing, viol_groups: torch.Tensor,
                     viol_round: torch.Tensor, k: int = 4) -> dict:
    """The chaos post-mortem: the first k offending groups, found on the
    device, each with its violations, its first violation round and its
    decoded timeline up to that round."""
    g = gather_forensics(ring, viol_groups, viol_round, k)
    W = ring.ring.shape[0]
    C = viol_groups.shape[0]
    rounds = int(g["round"])
    captured = []
    for i, gid in enumerate(g["ids"]):
        if int(gid) >= C:
            break      # the sentinel: fewer than k offenders
        vr = int(g["viol_round"][i])
        captured.append({
            "group": int(gid),
            "violations": violation_names(int(g["bits"][i])),
            "first_violation_round": vr,
            "timeline": ring_timeline(g["rings"][:, :, i], vr if vr >= 0 else rounds - 1),
        })
    return {"window": W, "rounds_observed": rounds,
            "groups_violating": int(g["total"]), "captured": captured}


def ring_capture(ring: EventRing, group_ids) -> list:
    """The live ring lanes of the given groups, decoded (copies only those
    lanes, [W, M, len(ids)])."""
    ids = torch.as_tensor(list(group_ids), dtype=torch.int64).to(ring.ring.device)
    rings = ring.ring.index_select(2, ids).cpu().numpy()
    end = int(ring.round) - 1
    return [{"group": int(gid), "timeline": ring_timeline(rings[:, :, i], end)}
            for i, gid in enumerate(group_ids)]


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------

# host request spans take a process id far from any group id
HOST_PID = 1 << 20


def to_chrome_trace(captures=None, spans=None, round_us: int = 1000) -> dict:
    """Chrome trace-event JSON ({"traceEvents": [...]}): one track per
    member for ring timelines (pid = group id, tid = member; each round a
    ``round_us``-microsecond event named by its events), one per request
    for host spans (pid = HOST_PID, tid = request; the span and a slice per
    step). ``captures`` is forensics_report()["captured"] or ring_capture()
    output; ``spans`` a list of span dicts (op, start, dur, fields, steps)."""
    events = []
    for cap in captures or []:
        g = int(cap["group"])
        events.append({"ph": "M", "name": "process_name", "pid": g, "tid": 0,
                       "args": {"name": f"raft group {g} (device rounds)"}})
        seen = set()
        for row in cap["timeline"]:
            ts = row["round"] * round_us
            for ent in row["members"]:
                m = int(ent["member"])
                if m not in seen:
                    seen.add(m)
                    events.append({"ph": "M", "name": "thread_name", "pid": g,
                                   "tid": m, "args": {"name": f"member {m}"}})
                events.append({
                    "ph": "X", "cat": "device",
                    "name": ", ".join(ent["events"]) or ent["role"],
                    "pid": g, "tid": m, "ts": ts, "dur": round_us,
                    "args": {"round": row["round"], "role": ent["role"],
                             "word": ent["word"]},
                })
    if spans:
        events.append({"ph": "M", "name": "process_name", "pid": HOST_PID, "tid": 0,
                       "args": {"name": "host requests"}})
        t0 = min(s["start"] for s in spans)
        for i, s in enumerate(spans):
            events.append({"ph": "M", "name": "thread_name", "pid": HOST_PID, "tid": i,
                           "args": {"name": f"req {i}: {s['op']}"}})
            base = (s["start"] - t0) * 1e6
            events.append({"ph": "X", "cat": "host", "name": s["op"], "pid": HOST_PID,
                           "tid": i, "ts": base, "dur": s["dur"] * 1e6,
                           "args": dict(s.get("fields", {}))})
            prev = 0.0
            for st in s.get("steps", []):
                events.append({"ph": "X", "cat": "host", "name": st["msg"],
                               "pid": HOST_PID, "tid": i, "ts": base + prev * 1e6,
                               "dur": max(st["ts"] - prev, 0.0) * 1e6,
                               "args": dict(st.get("fields", {}))})
                prev = st["ts"]
    return {"traceEvents": events, "displayTimeUnit": "ms"}
