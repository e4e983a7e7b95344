"""The batched Raft state machine (etcd_tpu/models/raft.py).

The JAX package writes each step for ONE node and batches it with
``jax.vmap``; here every function takes a batch of nodes directly (node
scalars [N, C], peer vectors [N, M, C], see models/state.py) and the
data-dependent control flow of the reference is the same straight-line
masked update. ``lax.scan`` loops become Python loops over their static
counts. ``RaftConfig.message_classes`` and ``entry_classes`` drop handler
blocks from a program as in the JAX package: None keeps every one.
"""
from __future__ import annotations

import torch

from etcd_tpu_torch.kernels.compact_wire import compact_inbox_slots
from etcd_tpu_torch.models import confchange as ccmod
from etcd_tpu_torch.models.state import (
    NodeState,
    _self_hot,
    in_config_self,
    is_joint,
    is_learner_self,
)
from etcd_tpu_torch.ops import inflights as infl
from etcd_tpu_torch.ops import log as logops
from etcd_tpu_torch.ops import quorum
from etcd_tpu_torch.ops.outbox import (
    Outbox,
    bcast,
    emit,
    emit_one,
    empty_outbox,
    make_msg,
    record_sent_commit,
)
from etcd_tpu_torch.types import (
    CAMPAIGN_FORCE,
    CAMPAIGN_NONE,
    CAMPAIGN_TRANSFER,
    ENTRY_CONF_CHANGE,
    ENTRY_NORMAL,
    MSG_APP,
    MSG_APP_RESP,
    MSG_HEARTBEAT,
    MSG_HEARTBEAT_RESP,
    MSG_HUP,
    MSG_NONE,
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
    NONE_ID,
    PR_PROBE,
    PR_REPLICATE,
    PR_SNAPSHOT,
    ROLE_CANDIDATE,
    ROLE_FOLLOWER,
    ROLE_LEADER,
    ROLE_PRE_CANDIDATE,
    VOTE_LOST,
    VOTE_WON,
    Msg,
    Spec,
    pack_mask,
    unpack_mask,
    wrap_int32,
)
from etcd_tpu_torch.utils import prng
from etcd_tpu_torch.utils.config import RaftConfig
from etcd_tpu_torch.utils.tree import tree_where

I32 = torch.int32


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------


def _v(x: torch.Tensor) -> torch.Tensor:
    """A node scalar [N, C] as [N, 1, C], to broadcast against [N, M, C]."""
    return x.unsqueeze(1)


def _ids(spec: Spec, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(spec.M, dtype=I32, device=like.device).view(1, -1, 1)


def _full(v, like: torch.Tensor, dtype=I32) -> torch.Tensor:
    """Constant ``v`` as a broadcast view of ``like``'s shape."""
    return torch.full((), v, dtype=dtype, device=like.device).expand(like.shape)


def onehot_sel(vec: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """vec[i] per node: vec [N, M, C], i [N, C]."""
    return logops.ring_read(vec, i)


def _progress_ids(n: NodeState) -> torch.Tensor:
    return n.voters | n.voters_out | n.learners


def _voter_union(n: NodeState) -> torch.Tensor:
    return n.voters | n.voters_out


def promotable(n: NodeState) -> torch.Tensor:
    """raft.promotable (raft.go:1618-1621)."""
    return in_config_self(n) & ~is_learner_self(n)


def _mix_hash(h, idx, term, data):
    """Rolling hash chain over applied entries, with the int32 wraparound of
    the JAX function computed in int64 and wrapped explicitly."""
    L = torch.int64
    h = h.to(L) * 1000003 + idx.to(L) * -1640531527
    h = h ^ (term.to(L) * 40503 + data.to(L) * 69069 + 1)
    return wrap_int32(h)


def _handles(cfg: RaftConfig, *types) -> bool:
    """Does this program handle any of these message types? None handles
    every class."""
    return cfg.message_classes is None or any(t in cfg.message_classes
                                              for t in types)


# ---------------------------------------------------------------------------
# state transitions (raft.go:590-758)
# ---------------------------------------------------------------------------


def reset_state(cfg: RaftConfig, spec: Spec, n: NodeState, term) -> NodeState:
    """raft.reset (raft.go:590-619); draws a new randomized timeout even
    when the term is unchanged, as the JAX function does."""
    sh = _self_hot(n)
    changed = n.term != term
    key, sub = prng.split2(n.rng_key)
    rand_to = cfg.election_tick + prng.randint(sub, 0, cfg.election_tick)
    zs = _full(0, n.term)
    fM = _full(False, n.match, torch.bool)
    n = n.replace(
        term=term.to(I32).expand(n.term.shape),
        vote=torch.where(changed, NONE_ID, n.vote),
        lead=_full(NONE_ID, n.lead),
        election_elapsed=zs,
        heartbeat_elapsed=zs,
        randomized_timeout=rand_to,
        rng_key=prng.stored(key),
        lead_transferee=_full(NONE_ID, n.lead),
        votes_responded=fM,
        votes_granted=fM,
        match=torch.where(sh, _v(n.last_index), 0),
        next_idx=(_v(n.last_index) + 1).expand(n.match.shape),
        pr_state=_full(PR_PROBE, n.match),
        probe_sent=fM,
        pending_snapshot=_full(0, n.match),
        recent_active=fM,
        pending_conf_index=zs,
        uncommitted_size=zs,
        ro_count=zs,
        ro_pend_count=zs,
    )
    return n.replace(infl_start=_full(0, n.match), infl_count=_full(0, n.match))


def become_follower_state(cfg, spec, n: NodeState, term, lead) -> NodeState:
    """raft.becomeFollower (raft.go:686-693)."""
    n = reset_state(cfg, spec, n, term)
    return n.replace(lead=lead.to(I32).expand(n.lead.shape),
                     role=_full(ROLE_FOLLOWER, n.role))


def become_candidate_state(cfg, spec, n: NodeState) -> NodeState:
    """raft.becomeCandidate (raft.go:695-706)."""
    n = reset_state(cfg, spec, n, n.term + 1)
    return n.replace(vote=n.nid, role=_full(ROLE_CANDIDATE, n.role))


def become_pre_candidate_state(cfg, spec, n: NodeState) -> NodeState:
    """raft.becomePreCandidate (raft.go:708-722)."""
    fM = _full(False, n.match, torch.bool)
    return n.replace(votes_responded=fM, votes_granted=fM,
                     lead=_full(NONE_ID, n.lead),
                     role=_full(ROLE_PRE_CANDIDATE, n.role))


def record_vote(spec, n: NodeState, vid, granted) -> NodeState:
    """ProgressTracker.RecordVote (tracker.go:259-264): first response wins."""
    hot = _ids(spec, vid) == _v(vid)
    fresh = hot & ~n.votes_responded
    return n.replace(votes_responded=n.votes_responded | hot,
                     votes_granted=torch.where(fresh, _v(granted), n.votes_granted))


def tally_votes(n: NodeState) -> torch.Tensor:
    return quorum.joint_vote_result(n.voters, n.voters_out,
                                    n.votes_responded, n.votes_granted)


def maybe_commit_state(cfg, spec, n: NodeState):
    """raft.maybeCommit (raft.go:585-588). Returns (n, advanced)."""
    mci = quorum.joint_committed_index(n.voters, n.voters_out, n.match)
    t, ok = logops.term_at(spec, n, mci)
    adv = (mci > n.commit) & ok & (t == n.term)
    return n.replace(commit=torch.where(adv, mci, n.commit)), adv


def append_entries_state(cfg, spec, n: NodeState, p_len, ent_data, ent_type,
                         enable, count_quota: bool = True):
    """raft.appendEntry (raft.go:621-642). Returns (n, accepted)."""
    add = p_len
    if count_quota:
        over = ((n.uncommitted_size > 0) & (add > 0)
                & (n.uncommitted_size + add > cfg.max_uncommitted_entries))
    else:
        over = torch.zeros_like(enable)
    cap_over = (n.last_index + add - n.snap_index) > spec.L
    accepted = enable & ~over & ~cap_over
    terms = _v(n.term).expand(n.term.shape[:1] + (spec.E,) + n.term.shape[1:])
    n2 = logops.append_span(spec, n, n.last_index, add, terms, ent_data,
                            ent_type, accepted)
    sh = _self_hot(n)
    uncommitted = n2.uncommitted_size + torch.where(accepted, add, 0) \
        if count_quota else n2.uncommitted_size
    n2 = n2.replace(
        uncommitted_size=uncommitted,
        match=torch.where(sh, torch.maximum(n2.match, _v(n2.last_index)), n2.match),
        next_idx=torch.where(sh, torch.maximum(n2.next_idx, _v(n2.last_index) + 1),
                             n2.next_idx),
    )
    n3, _ = maybe_commit_state(cfg, spec, n2)
    return tree_where(accepted, n3, n), accepted


def become_leader_state(cfg, spec, n: NodeState) -> NodeState:
    """raft.becomeLeader (raft.go:724-758), with the empty entry at the new
    term appended outside the quota."""
    n = reset_state(cfg, spec, n, n.term)
    sh = _self_hot(n)
    n = n.replace(
        lead=n.nid,
        role=_full(ROLE_LEADER, n.role),
        pr_state=torch.where(sh, PR_REPLICATE, n.pr_state),
        next_idx=torch.where(sh, n.match + 1, n.next_idx),
        pending_conf_index=n.last_index,
    )
    zE = _full(0, n.log_term[:, :spec.E])
    n, _ = append_entries_state(cfg, spec, n, _full(1, n.term), zE, zE,
                                _full(True, n.term, torch.bool),
                                count_quota=False)
    return n


# ---------------------------------------------------------------------------
# sending (raft.go:421-541)
# ---------------------------------------------------------------------------


def _is_paused(cfg, n: NodeState) -> torch.Tensor:
    """Progress.IsPaused (tracker/progress.go:201-212), [N, M, C]."""
    return torch.where(
        n.pr_state == PR_PROBE, n.probe_sent,
        torch.where(n.pr_state == PR_REPLICATE, infl.full(cfg.max_inflight, n),
                    True))


def maybe_send_append(cfg, spec, n: NodeState, ob: Outbox, dest_mask,
                      send_if_empty):
    """raft.maybeSendAppend over all destinations (raft.go:432-492), with
    the MsgSnap fallback when the needed entries are compacted.
    ``dest_mask`` [N, M, C]; ``send_if_empty`` bool, [N, C] or [N, M, C]."""
    if not isinstance(send_if_empty, torch.Tensor):
        send_if_empty = torch.full((), send_if_empty, dtype=torch.bool,
                                   device=dest_mask.device)
    if send_if_empty.dim() == 2:
        send_if_empty = _v(send_if_empty)
    E = spec.E
    mask = dest_mask & (_ids(spec, n.nid) != _v(n.nid)) & ~_is_paused(cfg, n)

    prev = n.next_idx - 1                                   # [N, M, C]
    needs_snap = prev < _v(n.snap_index)
    t_prev = torch.where(prev == _v(n.snap_index), _v(n.snap_term),
                         logops.ring_read(n.log_term, logops.slot(spec, prev)))
    offs = torch.arange(E, dtype=I32, device=prev.device).view(1, 1, E, 1)
    idxs = n.next_idx.unsqueeze(2) + offs                   # [N, M, E, C]
    last = n.last_index.view(n.last_index.shape[0], 1, 1, -1)
    snap = n.snap_index.view(last.shape)
    valid = (idxs <= last) & (idxs > snap)
    s = logops.slot(spec, idxs)

    def ents(ring):
        return torch.where(valid, logops.ring_read(ring, s), 0)

    ln = torch.clamp(_v(n.last_index) - n.next_idx + 1, 0, E)

    empty = ln == 0
    send_app = mask & ~needs_snap & ~(empty & ~send_if_empty)
    send_snap = mask & needs_snap & n.recent_active

    base = bcast(spec, make_msg(spec, n.term))
    app = base.replace(
        type=torch.where(send_app, MSG_APP, MSG_NONE).to(I32),
        term=_v(n.term).expand(prev.shape), frm=_v(n.nid).expand(prev.shape),
        index=prev, log_term=t_prev, commit=_v(n.commit).expand(prev.shape),
        ent_len=ln, ent_term=ents(n.log_term), ent_data=ents(n.log_data),
        ent_type=ents(n.log_type),
    )
    ob = emit(spec, ob, send_app, app,
              fields=("index", "log_term", "commit", "ent_len",
                      "ent_term", "ent_data", "ent_type"))
    ob = record_sent_commit(ob, send_app, n.commit)

    has_ents = send_app & (ln > 0)
    repl = n.pr_state == PR_REPLICATE
    probe = n.pr_state == PR_PROBE
    last_sent = prev + ln
    n = n.replace(
        next_idx=torch.where(has_ents & repl, last_sent + 1, n.next_idx),
        probe_sent=n.probe_sent | (has_ents & probe),
    )
    n = infl.add(spec, n, has_ents & repl, last_sent)

    # The snapshot sent is the freshest applied state; its 32-bit applied
    # hash rides split across commit (low 16 bits) and reject_hint (>> 16)
    # so that it survives the int16 wire (see the JAX function).
    t_app, _ = logops.term_at(spec, n, n.applied)

    def node(x):
        return _v(x).expand(prev.shape)

    snap_msg = base.replace(
        type=torch.where(send_snap, MSG_SNAP, MSG_NONE).to(I32),
        term=node(n.term), frm=node(n.nid), index=node(n.applied),
        log_term=node(t_app), commit=node(n.applied_hash),
        reject_hint=node(n.applied_hash >> 16), reject=node(n.auto_leave),
        c_voters=node(pack_mask(n.voters)),
        c_voters_out=node(pack_mask(n.voters_out)),
        c_learners=node(pack_mask(n.learners)),
        c_learners_next=node(pack_mask(n.learners_next)),
    )
    ob = emit(spec, ob, send_snap, snap_msg,
              fields=("index", "log_term", "commit", "reject_hint",
                      "c_voters", "c_voters_out", "c_learners",
                      "c_learners_next"))
    ob = record_sent_commit(ob, send_snap, n.commit)
    n = n.replace(
        pr_state=torch.where(send_snap, PR_SNAPSHOT, n.pr_state),
        pending_snapshot=torch.where(send_snap, _v(n.applied), n.pending_snapshot),
    )
    return n, ob


def bcast_append(cfg, spec, n, ob, enable):
    """raft.bcastAppend (raft.go:515-522)."""
    return maybe_send_append(cfg, spec, n, ob, _progress_ids(n) & _v(enable), True)


def _ro_last_ctx(n: NodeState) -> torch.Tensor:
    """readOnly.lastPendingRequestCtx (read_only.go:115-121); 0 if none."""
    last = onehot_sel(n.ro_ctx, torch.clamp(n.ro_count - 1, min=0))
    return torch.where(n.ro_count > 0, last, 0)


def bcast_heartbeat(cfg, spec, n, ob, ctx, enable):
    """raft.bcastHeartbeat (raft.go:525-541): the commit sent to each
    destination is min(match, committed) (raft.go:495-511)."""
    to = _progress_ids(n) & (_ids(spec, n.nid) != _v(n.nid)) & _v(enable)
    commit = torch.minimum(n.match, _v(n.commit))
    msg = bcast(spec, make_msg(spec, n.term)).replace(
        type=torch.where(to, MSG_HEARTBEAT, MSG_NONE).to(I32),
        term=_v(n.term).expand(to.shape), frm=_v(n.nid).expand(to.shape),
        commit=commit, context=_v(ctx).expand(to.shape).to(I32))
    ob = emit(spec, ob, to, msg, fields=("commit",))
    return n, record_sent_commit(ob, to, commit)


# ---------------------------------------------------------------------------
# campaigning (raft.go:760-845)
# ---------------------------------------------------------------------------


def _vote_request(spec, n: NodeState, to, mtype, term, context=None) -> Msg:
    """A (pre-)vote request to every destination in ``to``."""
    kw = {}
    if context is not None:
        kw["context"] = _v(context).expand(to.shape)
    return bcast(spec, make_msg(spec, n.term)).replace(
        type=torch.where(to, mtype, MSG_NONE).to(I32),
        term=_v(term).expand(to.shape), frm=_v(n.nid).expand(to.shape),
        index=_v(n.last_index).expand(to.shape),
        log_term=_v(logops.last_term(spec, n)).expand(to.shape), **kw)


def campaign(cfg, spec, n: NodeState, ob: Outbox, kind, enable):
    """raft.campaign (raft.go:785-835) with a per-node CAMPAIGN_* kind; a
    pre-vote won at once (single voter) falls through to the real election."""
    ids = _ids(spec, n.nid)
    true = _full(True, n.term, torch.bool)
    if cfg.pre_vote:
        pre = enable & (kind == CAMPAIGN_NONE)
        npre = become_pre_candidate_state(cfg, spec, n)
        npre = record_vote(spec, npre, npre.nid, true)
        won_pre = tally_votes(npre) == VOTE_WON
        to = _v(pre & ~won_pre) & _voter_union(npre) & (ids != _v(npre.nid))
        msg = _vote_request(spec, npre, to, MSG_PRE_VOTE, npre.term + 1)
        ob = emit(spec, ob, to, msg, fields=("index", "log_term"))
        n = tree_where(pre, npre, n)
        do_real = enable & torch.where(pre, won_pre, True)
    else:
        do_real = enable

    nr = become_candidate_state(cfg, spec, n)
    nr = record_vote(spec, nr, nr.nid, true)
    won = tally_votes(nr) == VOTE_WON
    to = _v(do_real & ~won) & _voter_union(nr) & (ids != _v(nr.nid))
    ctx = torch.where(kind == CAMPAIGN_TRANSFER, CAMPAIGN_TRANSFER, 0).to(I32)
    msg = _vote_request(spec, nr, to, MSG_VOTE, nr.term, ctx)
    ob = emit(spec, ob, to, msg, fields=("index", "log_term"))
    nr = tree_where(won, become_leader_state(cfg, spec, nr), nr)
    n = tree_where(do_real, nr, n)
    return n, ob


def hup(cfg, spec, n, ob, kind, enable):
    """raft.hup (raft.go:760-781): no campaign as leader, when unpromotable,
    or with an unapplied conf change in (applied, committed]."""
    pend = logops.count_pending_conf(spec, n, n.applied, n.commit)
    ok = (enable & (n.role != ROLE_LEADER) & promotable(n)
          & ~((pend > 0) & (n.commit > n.applied)))
    return campaign(cfg, spec, n, ob, kind, ok)


def _emit_hup_to_self(spec, n, ob, kind, enable):
    """Queue a MsgHup to self for the next round (MsgTimeoutNow, or a
    pre-candidate that won its pre-vote)."""
    return emit_one(spec, ob, n.nid,
                    make_msg(spec, n.term, type=MSG_HUP, frm=n.nid, context=kind),
                    enable, fields=())


# ---------------------------------------------------------------------------
# read-only queue (raft/read_only.go, keyed by integer ctx)
# ---------------------------------------------------------------------------


def _r_ids(spec, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(spec.R, dtype=I32, device=like.device).view(1, -1, 1)


def _rs_push(spec, n: NodeState, ctx, index, enable) -> NodeState:
    """Surface a ReadState to the local application (raft.go:249)."""
    pos = torch.clamp(n.rs_count, max=spec.R - 1)
    can = enable & (n.rs_count < spec.R)
    sel = (_r_ids(spec, pos) == _v(pos)) & _v(can)
    return n.replace(
        rs_ctx=torch.where(sel, _v(ctx), n.rs_ctx),
        rs_index=torch.where(sel, _v(index), n.rs_index),
        rs_count=n.rs_count + can.to(I32),
    )


def _acks(spec, n: NodeState) -> torch.Tensor:
    """ro_acks [N, R*M, C] as [N, R, M, C]."""
    N, _, C = n.ro_acks.shape
    return n.ro_acks.view(N, spec.R, spec.M, C)


def _ro_add_request(spec, n: NodeState, ctx, frm, enable) -> NodeState:
    """readOnly.addRequest (read_only.go:39-59); a duplicate ctx is a no-op."""
    r = _r_ids(spec, ctx)
    dup = ((n.ro_ctx == _v(ctx)) & (r < _v(n.ro_count))).any(1)
    can = enable & ~dup & (n.ro_count < spec.R)
    sel = (r == _v(torch.clamp(n.ro_count, max=spec.R - 1))) & _v(can)
    return n.replace(
        ro_ctx=torch.where(sel, _v(ctx), n.ro_ctx),
        ro_index=torch.where(sel, _v(n.commit), n.ro_index),
        ro_from=torch.where(sel, _v(frm), n.ro_from),
        ro_acks=torch.where(sel.unsqueeze(2), False, _acks(spec, n)).reshape(
            n.ro_acks.shape),
        ro_count=n.ro_count + can.to(I32),
    )


def _ro_recv_ack(spec, n: NodeState, frm, ctx, enable):
    """readOnly.recvAck (read_only.go:61-70). Returns (n, found, acks_row)."""
    in_q = _r_ids(spec, ctx) < _v(n.ro_count)
    slot_hot = (n.ro_ctx == _v(ctx)) & in_q                   # [N, R, C]
    found = enable & slot_hot.any(1)
    fhot = _ids(spec, frm) == _v(frm)                         # [N, M, C]
    acks = _acks(spec, n) | (slot_hot.unsqueeze(2) & fhot.unsqueeze(1)
                             & enable.view(enable.shape[0], 1, 1, -1))
    row = (slot_hot.unsqueeze(2) & acks).any(1)               # [N, M, C]
    return n.replace(ro_acks=acks.reshape(n.ro_acks.shape)), found, row


def _ro_advance_emit(cfg, spec, n: NodeState, ob: Outbox, ctx, enable):
    """readOnly.advance (read_only.go:72-101) and the response fan-out of
    stepLeader's MsgHeartbeatResp (raft.go:1304-1309)."""
    r = _r_ids(spec, ctx)
    in_q = r < _v(n.ro_count)
    slot_hot = (n.ro_ctx == _v(ctx)) & in_q
    found = enable & slot_hot.any(1)
    # the first hot slot (argmax), 0 when none
    pos = torch.where(slot_hot, r, spec.R).amin(1)
    pos = torch.where(pos == spec.R, 0, pos)
    released = (r <= _v(pos)) & in_q & _v(found)              # [N, R, C]
    for i in range(spec.R):
        req_from = n.ro_from[:, i]
        local = (req_from == NONE_ID) | (req_from == n.nid)
        n = _rs_push(spec, n, n.ro_ctx[:, i], n.ro_index[:, i],
                     released[:, i] & local)
        ob = emit_one(spec, ob, req_from,
                      make_msg(spec, n.term, type=MSG_READ_INDEX_RESP, term=n.term,
                               frm=n.nid, index=n.ro_index[:, i],
                               context=n.ro_ctx[:, i]),
                      released[:, i] & ~local, fields=("index",))
    shift = torch.where(found, pos + 1, 0)
    return n.replace(
        ro_ctx=logops.roll_left(n.ro_ctx, shift),
        ro_index=logops.roll_left(n.ro_index, shift),
        ro_from=logops.roll_left(n.ro_from, shift),
        ro_acks=logops.roll_left(_acks(spec, n), shift).reshape(n.ro_acks.shape),
        ro_count=n.ro_count - shift,
    ), ob


def _committed_in_term(spec, n: NodeState) -> torch.Tensor:
    """raft.committedEntryInCurrentTerm (raft.go:1731-1733)."""
    t, _ = logops.term_at(spec, n, n.commit)
    return t == n.term


def _is_singleton(spec, n: NodeState) -> torch.Tensor:
    """ProgressTracker.IsSingleton: exactly one joint voter, and it is self."""
    vu = _voter_union(n)
    return (vu.sum(1) == 1) & (vu & _self_hot(n)).any(1)


def _send_read_index_response(cfg, spec, n, ob, ctx, frm, enable):
    """sendMsgReadIndexResponse (raft.go:1827-1843)."""
    if cfg.read_only_lease_based:
        local = (frm == NONE_ID) | (frm == n.nid)
        n = _rs_push(spec, n, ctx, n.commit, enable & local)
        ob = emit_one(spec, ob, frm,
                      make_msg(spec, n.term, type=MSG_READ_INDEX_RESP, term=n.term,
                               frm=n.nid, index=n.commit, context=ctx),
                      enable & ~local, fields=("index",))
        return n, ob
    n = _ro_add_request(spec, n, ctx, frm, enable)
    n, _, _ = _ro_recv_ack(spec, n, n.nid, ctx, enable)
    return bcast_heartbeat(cfg, spec, n, ob, ctx, enable)


def _release_pending_read_index(cfg, spec, n, ob, enable):
    """releasePendingReadIndexMessages (raft.go:1813-1825)."""
    ok = enable & _committed_in_term(spec, n)
    for i in range(spec.R):
        n, ob = _send_read_index_response(cfg, spec, n, ob, n.ro_pend_ctx[:, i],
                                          n.ro_pend_from[:, i],
                                          ok & (i < n.ro_pend_count))
    return n.replace(ro_pend_count=torch.where(ok, 0, n.ro_pend_count)), ob


# ---------------------------------------------------------------------------
# message handlers (raft.go:1475-1511)
# ---------------------------------------------------------------------------


def _pend_reply(spec, ob: Outbox, to, enable, term, index, reject, hint,
                logterm) -> Outbox:
    """Record a MsgAppResp intent to destination ``to`` [N, C] where
    ``enable`` (deferred emission; last writer wins per destination). The
    values are [N, C] tensors or Python numbers."""
    def v(x):
        return _v(x) if isinstance(x, torch.Tensor) else x

    p = ob.pend
    hot = (_ids(spec, to) == _v(to)) & _v(enable)
    return ob.replace(pend=p.replace(
        rep_any=p.rep_any | hot,
        rep_term=torch.where(hot, v(term), p.rep_term),
        rep_index=torch.where(hot, v(index), p.rep_index),
        rep_reject=torch.where(hot, v(reject), p.rep_reject),
        rep_hint=torch.where(hot, v(hint), p.rep_hint),
        rep_logterm=torch.where(hot, v(logterm), p.rep_logterm),
    ))


def handle_append_entries(cfg, spec, n, ob, m: Msg, enable):
    """raft.handleAppendEntries (raft.go:1475-1511)."""
    below = m.index < n.commit
    commit0 = n.commit      # the below-commit reply carries the pre-append commit
    if not cfg.deferred_emit:
        ob = emit_one(spec, ob, m.frm,
                      make_msg(spec, n.term, type=MSG_APP_RESP, term=n.term,
                               frm=n.nid, index=n.commit),
                      enable & below, fields=("index",))
    en = enable & ~below
    # ring-capacity partial accept: only the storable prefix is taken
    eff_len = logops.clip(n.snap_index + spec.L - m.index, _full(0, m.ent_len),
                          m.ent_len)
    n, lastnewi, ok = logops.maybe_append(
        spec, n, m.index, m.log_term, m.commit, eff_len, m.ent_term,
        m.ent_data, m.ent_type, en)
    hint_index = torch.minimum(m.index, n.last_index)
    hint_index = logops.find_conflict_by_term(spec, n, hint_index, m.log_term)
    hint_term, _ = logops.term_at(spec, n, hint_index)
    if cfg.deferred_emit:
        # one recorded reply covers the three exclusive cases
        rej = en & ~ok
        idx = torch.where(below, commit0, torch.where(ok, lastnewi, m.index))
        ob = _pend_reply(spec, ob, m.frm, enable, n.term, idx, rej,
                         torch.where(rej, hint_index, 0),
                         torch.where(rej, hint_term, 0))
        return n, ob
    ob = emit_one(spec, ob, m.frm,
                  make_msg(spec, n.term, type=MSG_APP_RESP, term=n.term,
                           frm=n.nid, index=lastnewi),
                  en & ok, fields=("index",))
    ob = emit_one(spec, ob, m.frm,
                  make_msg(spec, n.term, type=MSG_APP_RESP, term=n.term,
                           frm=n.nid, index=m.index, reject=True,
                           reject_hint=hint_index, log_term=hint_term),
                  en & ~ok, fields=("index", "reject_hint", "log_term"))
    return n, ob


def handle_heartbeat(cfg, spec, n, ob, m: Msg, enable):
    """raft.handleHeartbeat (raft.go:1513-1516)."""
    n = n.replace(commit=torch.where(enable, logops.commit_to(n, m.commit).commit,
                                     n.commit))
    ob = emit_one(spec, ob, m.frm,
                  make_msg(spec, n.term, type=MSG_HEARTBEAT_RESP, term=n.term,
                           frm=n.nid, context=m.context),
                  enable, fields=())
    return n, ob


def handle_snapshot(cfg, spec, n, ob, m: Msg, enable):
    """raft.handleSnapshot + restore (raft.go:1518-1614), applied at once:
    the log resets to (sindex, sterm), and the state-machine hash and the
    config come from the message."""
    sindex, sterm = m.index, m.log_term
    stale = sindex <= n.commit
    mv = unpack_mask(m.c_voters, spec.M)
    mvo = unpack_mask(m.c_voters_out, spec.M)
    ml = unpack_mask(m.c_learners, spec.M)
    mln = unpack_mask(m.c_learners_next, spec.M)
    in_cs = ((mv | mvo | ml) & _self_hot(n)).any(1)
    fast_fwd = logops.match_term(spec, n, sindex, sterm)
    follower = n.role == ROLE_FOLLOWER
    go = enable & ~stale & follower & in_cs
    do_restore = go & ~fast_fwd
    do_fast = go & fast_fwd
    n = n.replace(commit=torch.where(do_fast, logops.commit_to(n, sindex).commit,
                                     n.commit))
    # the split applied hash (see the MsgSnap emit site): low 16 bits from
    # commit, high 16 from reject_hint
    shash = wrap_int32((m.reject_hint.to(torch.int64) << 16)
                       | (m.commit.to(torch.int64) & 0xFFFF))
    restored = n.replace(
        last_index=sindex, commit=sindex, applied=sindex, applied_hash=shash,
        snap_index=sindex, snap_term=sterm, snap_hash=shash,
        snap_voters=mv, snap_voters_out=mvo, snap_learners=ml,
        snap_learners_next=mln, snap_auto_leave=m.reject,
        voters=mv, voters_out=mvo, learners=ml, learners_next=mln,
        auto_leave=m.reject,
    )
    n = tree_where(do_restore, restored, n)
    ob = emit_one(spec, ob, m.frm,
                  make_msg(spec, n.term, type=MSG_APP_RESP, term=n.term, frm=n.nid,
                           index=torch.where(do_restore, n.last_index, n.commit)),
                  enable & follower, fields=("index",))
    return n, ob


# ---------------------------------------------------------------------------
# role step functions
# ---------------------------------------------------------------------------


def _step_leader(cfg, spec, n: NodeState, ob: Outbox, m: Msg, en):
    """stepLeader (raft.go:991-1372), less MsgBeat and MsgCheckQuorum, which
    tick_timers fires directly."""
    ids = _ids(spec, n.nid)
    frm_c = torch.clamp(m.frm, 0, spec.M - 1)
    fhot = ids == _v(m.frm)

    # ---- MsgProp (raft.go:1019-1077)
    if _handles(cfg, MSG_PROP):
        is_prop = en & (m.type == MSG_PROP)
        drop = (~in_config_self(n) | (n.lead_transferee != NONE_ID)
                | (m.ent_len == 0))
        doprop = is_prop & ~drop
        # conf-change entry guards; refused ones are blanked to empty normal
        already_joint = is_joint(n)
        pend = n.pending_conf_index > n.applied
        e_type = list(m.ent_type.unbind(1))
        e_data = list(m.ent_data.unbind(1))
        new_pci = n.pending_conf_index
        for e in range(spec.E):
            valid = doprop & (e < m.ent_len)
            is_cc = valid & (e_type[e] == ENTRY_CONF_CHANGE)
            wants_leave = ccmod.is_leave_joint(e_data[e])
            refused = pend | (already_joint & ~wants_leave) | (~already_joint & wants_leave)
            keep = is_cc & ~refused
            e_type[e] = torch.where(is_cc & refused, ENTRY_NORMAL, e_type[e])
            e_data[e] = torch.where(is_cc & refused, 0, e_data[e])
            new_pci = torch.where(keep, n.last_index + e + 1, new_pci)
            pend = pend | keep
        n = n.replace(pending_conf_index=torch.where(doprop, new_pci,
                                                     n.pending_conf_index))
        n, accepted = append_entries_state(
            cfg, spec, n, m.ent_len, torch.stack(e_data, 1),
            torch.stack(e_type, 1), doprop)
        if cfg.deferred_emit:
            dest = _progress_ids(n) & _v(doprop & accepted)
            ob = _pend_send(ob, dest, dest)
        else:
            n, ob = bcast_append(cfg, spec, n, ob, doprop & accepted)

    # ---- MsgReadIndex (raft.go:1078-1097)
    if _handles(cfg, MSG_READ_INDEX):
        is_ri = en & (m.type == MSG_READ_INDEX)
        singleton = _is_singleton(spec, n)
        local = (m.frm == NONE_ID) | (m.frm == n.nid)
        n = _rs_push(spec, n, m.context, n.commit, is_ri & singleton & local)
        ob = emit_one(spec, ob, m.frm,
                      make_msg(spec, n.term, type=MSG_READ_INDEX_RESP, term=n.term,
                               frm=n.nid, index=n.commit, context=m.context),
                      is_ri & singleton & ~local, fields=("index",))
        cit = _committed_in_term(spec, n)
        # defer until the first commit at this term (raft.go:1087-1092)
        can_defer = is_ri & ~singleton & ~cit & (n.ro_pend_count < spec.R)
        sel = (_r_ids(spec, m.frm)
               == _v(torch.clamp(n.ro_pend_count, max=spec.R - 1))) & _v(can_defer)
        n = n.replace(
            ro_pend_ctx=torch.where(sel, _v(m.context), n.ro_pend_ctx),
            ro_pend_from=torch.where(sel, _v(m.frm), n.ro_pend_from),
            ro_pend_count=n.ro_pend_count + can_defer.to(I32),
        )
        n, ob = _send_read_index_response(cfg, spec, n, ob, m.context, m.frm,
                                          is_ri & ~singleton & cit)

    # ---- messages that need a Progress entry for m.frm (raft.go:1099-1104)
    has_pr = onehot_sel(_progress_ids(n), frm_c) & (m.frm >= 0)

    if _handles(cfg, MSG_APP_RESP):
        # ---- MsgAppResp (raft.go:1106-1283)
        is_ar = en & (m.type == MSG_APP_RESP) & has_pr
        n = n.replace(recent_active=n.recent_active | (fhot & _v(is_ar)))
        match_f = onehot_sel(n.match, frm_c)
        next_f = onehot_sel(n.next_idx, frm_c)
        repl_f = onehot_sel(n.pr_state, frm_c) == PR_REPLICATE

        # reject path (raft.go:1109-1236)
        rej = is_ar & m.reject
        next_probe = torch.where(
            m.log_term > 0,
            logops.find_conflict_by_term(spec, n, m.reject_hint, m.log_term),
            m.reject_hint)
        dec_repl = rej & repl_f & (m.index > match_f)
        dec_probe = rej & ~repl_f & (next_f - 1 == m.index)
        new_next = torch.where(
            dec_repl, match_f + 1,
            torch.clamp(torch.minimum(m.index, next_probe + 1), min=1))
        decremented = dec_repl | dec_probe
        dr = fhot & _v(dec_repl)
        n = n.replace(
            next_idx=torch.where(fhot & _v(decremented), _v(new_next), n.next_idx),
            probe_sent=torch.where(fhot & _v(dec_probe), False, n.probe_sent),
            pr_state=torch.where(dr, PR_PROBE, n.pr_state),
            pending_snapshot=torch.where(dr, 0, n.pending_snapshot),
        )
        n = infl.reset(n, dr)

        # accept path (raft.go:1237-1282)
        acc = is_ar & ~m.reject
        old_paused_f = onehot_sel(_is_paused(cfg, n), frm_c)
        updated = acc & (m.index > match_f)
        up = fhot & _v(updated)
        n = n.replace(
            match=torch.where(up, _v(m.index), n.match),
            next_idx=torch.where(fhot & _v(acc),
                                 torch.maximum(n.next_idx, _v(m.index) + 1),
                                 n.next_idx),
            probe_sent=torch.where(up, False, n.probe_sent),
        )
        state_f = onehot_sel(n.pr_state, frm_c)
        new_match = onehot_sel(n.match, frm_c)
        to_repl = updated & (
            (state_f == PR_PROBE)
            | ((state_f == PR_SNAPSHOT)
               & (new_match >= onehot_sel(n.pending_snapshot, frm_c))))
        tr = fhot & _v(to_repl)
        n = n.replace(
            pr_state=torch.where(tr, PR_REPLICATE, n.pr_state),
            next_idx=torch.where(tr, _v(new_match) + 1, n.next_idx),
            pending_snapshot=torch.where(tr, 0, n.pending_snapshot),
        )
        n = infl.reset(n, tr)
        n = infl.free_le(spec, n, fhot & _v(updated & (state_f == PR_REPLICATE)),
                         m.index)
        n2, committed_adv = maybe_commit_state(cfg, spec, n)
        committed_adv = committed_adv & updated
        n = tree_where(committed_adv, n2, n)
        if _handles(cfg, MSG_READ_INDEX):
            # the pending-read queue fills only in the MsgReadIndex arm
            n, ob = _release_pending_read_index(cfg, spec, n, ob, committed_adv)

        # merged send: refresh/drain to the acking follower or the
        # reject-path re-probe, plus (without coalescing) the commit-advance
        # broadcast (raft.go:1230-1276)
        if cfg.coalesce_commit_refresh:
            send_dest = fhot & _v(updated | decremented)
            send_nonempty = decremented | old_paused_f
        else:
            send_dest = torch.where(_v(committed_adv), _progress_ids(n),
                                    fhot & _v(updated | decremented))
            send_nonempty = committed_adv | decremented | old_paused_f
        if cfg.deferred_emit:
            # accumulated; the round's flush runs one merged maybe_send_append
            ob = _pend_send(ob, send_dest, send_dest & _v(send_nonempty))
        else:
            n, ob = maybe_send_append(cfg, spec, n, ob, send_dest, send_nonempty)

        if not cfg.deferred_emit or _handles(cfg, MSG_TRANSFER_LEADER):
            # leadership transfer (raft.go:1278-1281)
            xfer = updated & (m.frm == n.lead_transferee) & \
                (onehot_sel(n.match, frm_c) == n.last_index)
            ob = emit_one(spec, ob, m.frm,
                          make_msg(spec, n.term, type=MSG_TIMEOUT_NOW, term=n.term,
                                   frm=n.nid),
                          xfer, fields=())

    if _handles(cfg, MSG_HEARTBEAT_RESP):
        # ---- MsgHeartbeatResp (raft.go:1284-1309)
        is_hr = en & (m.type == MSG_HEARTBEAT_RESP) & has_pr
        hr = fhot & _v(is_hr)
        n = n.replace(recent_active=n.recent_active | hr,
                      probe_sent=torch.where(hr, False, n.probe_sent))
        n = infl.free_first_one(
            spec, n, hr & _v(onehot_sel(n.pr_state, frm_c) == PR_REPLICATE)
            & _v(onehot_sel(infl.full(cfg.max_inflight, n), frm_c)))
        n, ob = maybe_send_append(
            cfg, spec, n, ob, hr & _v(onehot_sel(n.match, frm_c) < n.last_index),
            True)
        if not cfg.read_only_lease_based:
            n, found, row = _ro_recv_ack(spec, n, m.frm, m.context,
                                         is_hr & (m.context != 0))
            won = quorum.joint_vote_result(n.voters, n.voters_out, row, row) == VOTE_WON
            n, ob = _ro_advance_emit(cfg, spec, n, ob, m.context, found & won)

    if _handles(cfg, MSG_SNAP_STATUS):
        # ---- MsgSnapStatus (raft.go:1310-1331)
        is_ss = (en & (m.type == MSG_SNAP_STATUS) & has_pr
                 & (onehot_sel(n.pr_state, frm_c) == PR_SNAPSHOT))
        pend_f = torch.where(m.reject, 0, onehot_sel(n.pending_snapshot, frm_c))
        probe_next = torch.maximum(onehot_sel(n.match, frm_c) + 1, pend_f + 1)
        ss = fhot & _v(is_ss)
        n = n.replace(
            pr_state=torch.where(ss, PR_PROBE, n.pr_state),
            next_idx=torch.where(ss, _v(probe_next), n.next_idx),
            pending_snapshot=torch.where(ss, 0, n.pending_snapshot),
            probe_sent=torch.where(ss, True, n.probe_sent),
        )
        n = infl.reset(n, ss)

    if _handles(cfg, MSG_UNREACHABLE):
        # ---- MsgUnreachable (raft.go:1332-1338)
        is_un = (en & (m.type == MSG_UNREACHABLE) & has_pr
                 & (onehot_sel(n.pr_state, frm_c) == PR_REPLICATE))
        un = fhot & _v(is_un)
        n = n.replace(
            pr_state=torch.where(un, PR_PROBE, n.pr_state),
            next_idx=torch.where(un, _v(onehot_sel(n.match, frm_c) + 1), n.next_idx),
            pending_snapshot=torch.where(un, 0, n.pending_snapshot),
            probe_sent=torch.where(un, False, n.probe_sent),
        )
        n = infl.reset(n, un)

    if _handles(cfg, MSG_TRANSFER_LEADER):
        # ---- MsgTransferLeader (raft.go:1339-1369)
        is_tl = en & (m.type == MSG_TRANSFER_LEADER) & has_pr
        ignore = (onehot_sel(n.learners, frm_c) | (m.frm == n.nid)
                  | (n.lead_transferee == m.frm))
        do_tl = is_tl & ~ignore
        n = n.replace(
            election_elapsed=torch.where(do_tl, 0, n.election_elapsed),
            lead_transferee=torch.where(do_tl, m.frm, n.lead_transferee),
        )
        up_to_date = onehot_sel(n.match, frm_c) == n.last_index
        ob = emit_one(spec, ob, m.frm,
                      make_msg(spec, n.term, type=MSG_TIMEOUT_NOW, term=n.term,
                               frm=n.nid),
                      do_tl & up_to_date, fields=())
        n, ob = maybe_send_append(cfg, spec, n, ob, fhot & _v(do_tl & ~up_to_date),
                                  True)
    return n, ob


def _pend_send(ob: Outbox, dest, nonempty) -> Outbox:
    """Add maybe_send_append destinations (bool [N, M, C]) to the deferred
    union."""
    p = ob.pend
    return ob.replace(pend=p.replace(send_dest=p.send_dest | dest,
                                     send_nonempty=p.send_nonempty | nonempty))


def _step_candidate(cfg, spec, n, ob, m: Msg, en):
    """stepCandidate (raft.go:1376-1419): the vote responses."""
    if not _handles(cfg, MSG_VOTE_RESP, MSG_PRE_VOTE_RESP):
        return n, ob
    pre = n.role == ROLE_PRE_CANDIDATE
    my_resp = torch.where(pre, MSG_PRE_VOTE_RESP, MSG_VOTE_RESP)
    is_vr = en & (m.type == my_resp)
    res_before = tally_votes(n)
    n = tree_where(is_vr, record_vote(spec, n, m.frm, ~m.reject), n)
    res = tally_votes(n)
    # only the response that changes the tally acts (the pre-candidate stays
    # in role until its MsgHup to self lands next round)
    won = is_vr & (res == VOTE_WON) & (res_before != VOTE_WON)
    lost = is_vr & (res == VOTE_LOST) & (res_before != VOTE_LOST)
    ob = _emit_hup_to_self(spec, n, ob, CAMPAIGN_FORCE, won & pre)
    won_real = won & ~pre
    n = tree_where(won_real, become_leader_state(cfg, spec, n), n)
    n, ob = bcast_append(cfg, spec, n, ob, won_real)
    n = tree_where(lost, become_follower_state(cfg, spec, n, n.term,
                                               _full(NONE_ID, n.term)), n)
    return n, ob


def _step_follower(cfg, spec, n, ob, m: Msg, en):
    """stepFollower (raft.go:1421-1473)."""
    if _handles(cfg, MSG_PROP):
        is_prop = en & (m.type == MSG_PROP)
        fwd_ok = (n.lead != NONE_ID) & (not cfg.disable_proposal_forwarding)
        if cfg.deferred_emit:
            # the flush emits one MsgProp per destination; an earlier
            # forward to the same leader this round is superseded
            p = ob.pend
            hot = (_ids(spec, n.lead) == _v(n.lead)) & _v(is_prop & fwd_ok)
            hot_e = hot.unsqueeze(2)
            ob = ob.replace(pend=p.replace(
                fwd_any=p.fwd_any | hot,
                fwd_len=torch.where(hot, _v(m.ent_len), p.fwd_len),
                fwd_data=torch.where(hot_e, m.ent_data.unsqueeze(1), p.fwd_data),
                fwd_type=torch.where(hot_e, m.ent_type.unsqueeze(1), p.fwd_type),
            ))
        else:
            ob = emit_one(spec, ob, n.lead,
                          m.replace(frm=n.nid, term=_full(0, n.term)),
                          is_prop & fwd_ok)

    lead_msg = en & ((m.type == MSG_APP) | (m.type == MSG_HEARTBEAT)
                     | (m.type == MSG_SNAP))
    n = n.replace(
        election_elapsed=torch.where(lead_msg, 0, n.election_elapsed),
        lead=torch.where(lead_msg, m.frm, n.lead),
    )
    if _handles(cfg, MSG_APP):
        n, ob = handle_append_entries(cfg, spec, n, ob, m,
                                      lead_msg & (m.type == MSG_APP))
    if _handles(cfg, MSG_HEARTBEAT):
        n, ob = handle_heartbeat(cfg, spec, n, ob, m,
                                 lead_msg & (m.type == MSG_HEARTBEAT))
    if _handles(cfg, MSG_SNAP):
        n, ob = handle_snapshot(cfg, spec, n, ob, m, lead_msg & (m.type == MSG_SNAP))

    # MsgTransferLeader / MsgReadIndex forwarded to the leader (1445-1451,
    # 1458-1464)
    if _handles(cfg, MSG_TRANSFER_LEADER, MSG_READ_INDEX):
        fwd = (en & ((m.type == MSG_TRANSFER_LEADER) | (m.type == MSG_READ_INDEX))
               & (n.lead != NONE_ID))
        ob = emit_one(spec, ob, n.lead, m, fwd)

    # MsgTimeoutNow: campaign at once, without pre-vote (raft.go:1452-1457)
    if _handles(cfg, MSG_TIMEOUT_NOW):
        ob = _emit_hup_to_self(spec, n, ob, CAMPAIGN_TRANSFER,
                               en & (m.type == MSG_TIMEOUT_NOW))

    # MsgReadIndexResp -> a local ReadState (raft.go:1465-1471)
    if _handles(cfg, MSG_READ_INDEX_RESP):
        n = _rs_push(spec, n, m.context, m.index, en & (m.type == MSG_READ_INDEX_RESP))
    return n, ob


# ---------------------------------------------------------------------------
# Step: term gate + dispatch (raft.go:847-987)
# ---------------------------------------------------------------------------


def process_message(cfg: RaftConfig, spec: Spec, n: NodeState, ob: Outbox, m: Msg):
    active = m.type != MSG_NONE
    local = m.term == 0
    higher = active & ~local & (m.term > n.term)
    lower = active & ~local & (m.term < n.term)

    vote_like = (m.type == MSG_VOTE) | (m.type == MSG_PRE_VOTE)
    force = m.context == CAMPAIGN_TRANSFER
    in_lease = (cfg.check_quorum & (n.lead != NONE_ID)
                & (n.election_elapsed < cfg.election_tick))
    drop_lease = higher & vote_like & ~force & in_lease

    keep_term = (m.type == MSG_PRE_VOTE) | ((m.type == MSG_PRE_VOTE_RESP) & ~m.reject)
    do_bf = higher & ~drop_lease & ~keep_term
    from_is_lead = ((m.type == MSG_APP) | (m.type == MSG_HEARTBEAT)
                    | (m.type == MSG_SNAP))
    nbf = become_follower_state(cfg, spec, n, m.term,
                                torch.where(from_is_lead, m.frm, NONE_ID))
    n = tree_where(do_bf, nbf, n)

    # lower-term handling consumes the message (raft.go:883-919)
    if _handles(cfg, MSG_HEARTBEAT, MSG_APP):
        lt_push = (lower & (cfg.check_quorum or cfg.pre_vote)
                   & ((m.type == MSG_HEARTBEAT) | (m.type == MSG_APP)))
        if cfg.deferred_emit:
            ob = _pend_reply(spec, ob, m.frm, lt_push, n.term, 0, False, 0, 0)
        else:
            ob = emit_one(spec, ob, m.frm,
                          make_msg(spec, n.term, type=MSG_APP_RESP, term=n.term,
                                   frm=n.nid),
                          lt_push, fields=())
    if _handles(cfg, MSG_PRE_VOTE):
        lt_prevote = lower & (m.type == MSG_PRE_VOTE)
        ob = emit_one(spec, ob, m.frm,
                      make_msg(spec, n.term, type=MSG_PRE_VOTE_RESP, term=n.term,
                               frm=n.nid, reject=True),
                      lt_prevote, fields=())
    proceed = active & ~drop_lease & ~lower

    # ---- MsgHup (raft.go:923-928)
    if _handles(cfg, MSG_HUP):
        n, ob = hup(cfg, spec, n, ob, m.context, proceed & (m.type == MSG_HUP))

    # ---- Msg{Pre,}Vote for any role (raft.go:930-978)
    if _handles(cfg, MSG_VOTE, MSG_PRE_VOTE):
        is_vreq = proceed & vote_like
        can_vote = ((n.vote == m.frm)
                    | ((n.vote == NONE_ID) & (n.lead == NONE_ID))
                    | ((m.type == MSG_PRE_VOTE) & (m.term > n.term)))
        utd = logops.is_up_to_date(spec, n, m.index, m.log_term)
        grant = is_vreq & can_vote & utd
        resp_type = torch.where(m.type == MSG_VOTE, MSG_VOTE_RESP, MSG_PRE_VOTE_RESP)
        ob = emit_one(spec, ob, m.frm,
                      make_msg(spec, n.term, frm=n.nid, type=resp_type,
                               term=torch.where(grant, m.term, n.term),
                               reject=~grant),
                      is_vreq, fields=())
        real_grant = grant & (m.type == MSG_VOTE)
        n = n.replace(
            election_elapsed=torch.where(real_grant, 0, n.election_elapsed),
            vote=torch.where(real_grant, m.frm, n.vote),
        )

    # ---- candidates seeing a current leader demote first (raft.go:1390-1398)
    rest = proceed & ~vote_like & (m.type != MSG_HUP)
    cand = (n.role == ROLE_CANDIDATE) | (n.role == ROLE_PRE_CANDIDATE)
    demote = rest & cand & from_is_lead
    n = tree_where(demote, become_follower_state(cfg, spec, n, m.term, m.frm), n)

    # ---- role dispatch
    n, ob = _step_leader(cfg, spec, n, ob, m, rest & (n.role == ROLE_LEADER))
    n, ob = _step_candidate(
        cfg, spec, n, ob, m,
        rest & ((n.role == ROLE_CANDIDATE) | (n.role == ROLE_PRE_CANDIDATE)))
    n, ob = _step_follower(cfg, spec, n, ob, m, rest & (n.role == ROLE_FOLLOWER))
    return n, ob


# ---------------------------------------------------------------------------
# tick (raft.go:645-684): returns an election-fire flag instead of
# campaigning inline; the campaign runs through the round's MsgHup step
# ---------------------------------------------------------------------------


def tick_timers(cfg: RaftConfig, spec: Spec, n: NodeState, ob: Outbox, enable):
    """Returns (n, ob, fire)."""
    is_lead = n.role == ROLE_LEADER

    # tickElection for followers and candidates (raft.go:645-654)
    ee = n.election_elapsed + 1
    fire = enable & ~is_lead & promotable(n) & (ee >= n.randomized_timeout)
    n = n.replace(election_elapsed=torch.where(
        enable & ~is_lead, torch.where(fire, 0, ee), n.election_elapsed))

    # tickHeartbeat for leaders (raft.go:657-684)
    ee2 = n.election_elapsed + 1
    et_fire = enable & is_lead & (ee2 >= cfg.election_tick)
    n = n.replace(election_elapsed=torch.where(
        enable & is_lead, torch.where(et_fire, 0, ee2), n.election_elapsed))
    if cfg.check_quorum:
        # the MsgCheckQuorum step (raft.go:997-1018)
        sh = _self_hot(n)
        qa = quorum.joint_vote_result(n.voters, n.voters_out, _progress_ids(n) | sh,
                                      n.recent_active | sh) == VOTE_WON
        step_down = et_fire & ~qa
        n = tree_where(step_down, become_follower_state(
            cfg, spec, n, n.term, _full(NONE_ID, n.term)), n)
        still = et_fire & ~step_down
        n = n.replace(recent_active=torch.where(_v(still), sh & n.recent_active,
                                                n.recent_active))
    # abort an unfinished transfer after an election timeout (raft.go:668-671)
    n = n.replace(lead_transferee=torch.where(
        et_fire & (n.role == ROLE_LEADER), NONE_ID, n.lead_transferee))

    he = n.heartbeat_elapsed + 1
    lead_now = enable & (n.role == ROLE_LEADER)
    hb_fire = lead_now & (he >= cfg.heartbeat_tick)
    n = n.replace(heartbeat_elapsed=torch.where(
        lead_now, torch.where(hb_fire, 0, he), n.heartbeat_elapsed))
    n, ob = bcast_heartbeat(cfg, spec, n, ob, _ro_last_ctx(n), hb_fire)
    return n, ob, fire


# ---------------------------------------------------------------------------
# apply cycle and the round
# ---------------------------------------------------------------------------


def apply_round(cfg: RaftConfig, spec: Spec, n: NodeState, ob: Outbox):
    """Apply up to Spec.A committed entries: conf changes take effect
    (raft.go:1623-1700), the hash chain advances, auto-leave fires
    (raft.go:554-570), and the ring compacts at the applied cursor when it
    is nearly full. ``entry_classes`` without "conf_change" drops the
    conf-change block, as in the JAX program."""
    handle_cc = cfg.entry_classes is None or "conf_change" in cfg.entry_classes
    for _ in range(spec.A):
        idx = n.applied + 1
        can = idx <= n.commit
        s = logops.slot(spec, idx)
        e_term = logops.ring_read(n.log_term, s)
        e_data = logops.ring_read(n.log_data, s)
        if handle_cc:
            is_cc = can & (logops.ring_read(n.log_type, s) == ENTRY_CONF_CHANGE)
            n, ob = ccmod.apply_conf_change(cfg, spec, n, ob, e_data, is_cc)
        n = n.replace(
            applied=torch.where(can, idx, n.applied),
            applied_hash=torch.where(
                can, _mix_hash(n.applied_hash, idx, e_term, e_data), n.applied_hash),
            uncommitted_size=torch.where(
                can & (n.role == ROLE_LEADER),
                torch.clamp(n.uncommitted_size - 1, min=0), n.uncommitted_size),
        )

    if handle_cc:
        # auto-leave of a joint config (advance(), raft.go:554-570): the
        # leave entry is appended, not broadcast
        al = ((n.role == ROLE_LEADER) & n.auto_leave & is_joint(n)
              & (n.applied >= n.pending_conf_index))
        zE = torch.zeros_like(n.log_term[:, :spec.E])
        first = torch.arange(spec.E, device=zE.device).view(1, -1, 1) == 0
        leave_data = torch.where(first, ccmod.encode_leave_joint(), zE)
        leave_type = torch.where(first, ENTRY_CONF_CHANGE, zE)
        n, acc = append_entries_state(cfg, spec, n, _full(1, n.term), leave_data,
                                      leave_type, al, count_quota=False)
        n = n.replace(pending_conf_index=torch.where(al & acc, n.last_index,
                                                     n.pending_conf_index))

    occ = n.last_index - n.snap_index
    do_c = (occ > spec.L - 2 * spec.E) & (n.applied > n.snap_index)
    t_app, _ = logops.term_at(spec, n, n.applied)
    compacted = n.replace(
        snap_index=n.applied, snap_term=t_app, snap_hash=n.applied_hash,
        snap_voters=n.voters, snap_voters_out=n.voters_out,
        snap_learners=n.learners, snap_learners_next=n.learners_next,
        snap_auto_leave=n.auto_leave,
    )
    return tree_where(do_c, compacted, n), ob


def compact_inbox(spec: Spec, flat: Msg, bound: int) -> Msg:
    """A node's inbox slots [S, N, (E,) C] -> its first ``bound`` nonempty
    slots in order (later messages drop); unchanged when bound >= S. On a
    CUDA tensor this is the compaction kernel (int32 output), on a CPU
    tensor its plain form."""
    S = flat.type.shape[0]
    B = min(bound, S)
    if B >= S:
        return flat
    return compact_inbox_slots(flat.map(lambda _, x: x.contiguous()), B)


def _flush_deferred(cfg, spec, n: NodeState, ob: Outbox):
    """The PendingWire intents of the message loop as slots (raft.py
    _flush_deferred): one MsgAppResp emit, one proposal-forward emit and
    one merged maybe_send_append, once per round."""
    p = ob.pend
    base = bcast(spec, make_msg(spec, n.term))
    frm = _v(n.nid).expand(p.rep_term.shape)
    rep = base.replace(
        type=torch.where(p.rep_any, MSG_APP_RESP, MSG_NONE).to(I32),
        term=p.rep_term, frm=frm, index=p.rep_index, reject=p.rep_reject,
        reject_hint=p.rep_hint, log_term=p.rep_logterm)
    ob = emit(spec, ob, p.rep_any, rep, fields=("index", "reject_hint", "log_term"))
    fwd = base.replace(
        type=torch.where(p.fwd_any, MSG_PROP, MSG_NONE).to(I32), frm=frm,
        ent_len=p.fwd_len, ent_data=p.fwd_data, ent_type=p.fwd_type)
    ob = emit(spec, ob, p.fwd_any, fwd, fields=("ent_len", "ent_data", "ent_type"))
    return maybe_send_append(cfg, spec, n, ob, p.send_dest, p.send_nonempty)


def node_round(cfg: RaftConfig, spec: Spec, n: NodeState, slots: Msg,
               prop_len, prop_data, prop_type, ri_ctx, do_hup, do_tick):
    """One lockstep round for a batch of nodes: tick, then the [hup, inbox
    slots..., prop, read-index] messages, the deferred flush, the coalesced
    commit refresh, then apply. ``slots`` holds the inbox as delivered,
    leaves [S, N, (E,) C] (already compacted when cfg.compact_wire). Under
    cfg.sparse_outbox the slot loop's handlers only record PendingWire
    intents (the JAX scan carries just the state and the PendingWire); the
    round raises if one wrote the outbox slots, counts or sent commits.
    Returns (state, outbox)."""
    ob = empty_outbox(spec, n.term.shape, n.term.device, deferred=cfg.deferred_emit)
    if "tick" in cfg.local_steps:
        n, ob, fire = tick_timers(cfg, spec, n, ob, do_tick)
        do_hup = do_hup | fire
    commit0 = n.commit

    if "hup" in cfg.local_steps:
        hup_msg = make_msg(spec, n.term, frm=n.nid,
                           type=torch.where(do_hup, MSG_HUP, MSG_NONE),
                           context=CAMPAIGN_NONE)
        n, ob = process_message(cfg, spec, n, ob, hup_msg)

    if not cfg.compact_wire and cfg.inbox_bound:
        slots = compact_inbox(spec, slots, cfg.inbox_bound)
    # the identities only: a reference to the immediate form's empty
    # outbox would keep a whole outbox alive through the loop
    fixed = ("msgs", "counts", "sent_commit") if cfg.sparse_outbox else ()
    before = [getattr(ob, f) for f in fixed]
    for s in range(slots.type.shape[0]):
        n, ob = process_message(cfg, spec, n, ob, slots.map(lambda _, x: x[s]))
    if any(getattr(ob, f) is not x for f, x in zip(fixed, before)):
        raise RuntimeError("a handler emitted inside the sparse message loop")

    if "prop" in cfg.local_steps:
        prop_msg = make_msg(spec, n.term, frm=n.nid,
                            type=torch.where(prop_len > 0, MSG_PROP, MSG_NONE),
                            ent_len=prop_len, ent_data=prop_data,
                            ent_type=prop_type)
        n, ob = process_message(cfg, spec, n, ob, prop_msg)
    if "read_index" in cfg.local_steps:
        ri_msg = make_msg(spec, n.term, frm=n.nid,
                          type=torch.where(ri_ctx != 0, MSG_READ_INDEX, MSG_NONE),
                          context=ri_ctx)
        n, ob = process_message(cfg, spec, n, ob, ri_msg)

    if cfg.deferred_emit:
        n, ob = _flush_deferred(cfg, spec, n, ob)

    if cfg.coalesce_commit_refresh:
        # one (possibly empty) append to every follower whose messages this
        # round carried a commit older than the one the round reached
        stale = ob.sent_commit < torch.minimum(n.match, _v(n.commit))
        refresh = (_v((n.role == ROLE_LEADER) & (n.commit > commit0))
                   & _progress_ids(n) & ((ob.counts == 0) | stale))
        n, ob = maybe_send_append(cfg, spec, n, ob, refresh, True)

    return apply_round(cfg, spec, n, ob)
