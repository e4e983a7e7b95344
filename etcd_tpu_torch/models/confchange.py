"""Config-change arithmetic as mask algebra (etcd_tpu/models/confchange.py)
over a batch of nodes.

The reference's ``confchange.Changer`` (raft/confchange/confchange.go):
Simple one-delta changes, joint consensus EnterJoint/LeaveJoint and the
LearnersNext staging, on bool [N, M, C] config masks. A conf change is one
int32 entry-data word holding up to two changes:

  [0:3]   op1 (CC_*)        [3:8]   id1
  [8:11]  op2               [11:16] id2
  16: has1   17: has2   18: enter_joint   19: auto_leave   20: leave_joint

Validation happens at proposal time in the leader (models/raft.py
_step_leader), so application here is unconditional.
"""
from __future__ import annotations

import torch

from etcd_tpu_torch.types import (
    CC_ADD_LEARNER,
    CC_ADD_NODE,
    CC_REMOVE_NODE,
    NONE_ID,
    PR_PROBE,
    ROLE_LEADER,
)
from etcd_tpu_torch.utils.tree import tree_where

_HAS1 = 1 << 16
_HAS2 = 1 << 17
_ENTER = 1 << 18
_AUTO = 1 << 19
_LEAVE = 1 << 20


def encode(changes: list[tuple[int, int]], enter_joint: bool = False,
           auto_leave: bool = True, leave_joint: bool = False) -> int:
    """Host-side encoder: ``changes`` is [(op, id), ...], at most two."""
    if leave_joint:
        return _LEAVE
    if len(changes) > 2:
        raise ValueError("at most 2 changes per conf-change word")
    w = 0
    if len(changes) >= 1:
        op, nid = changes[0]
        w |= (op & 7) | ((nid & 31) << 3) | _HAS1
    if len(changes) >= 2:
        op, nid = changes[1]
        w |= ((op & 7) << 8) | ((nid & 31) << 11) | _HAS2
    if enter_joint or len(changes) > 1:
        w |= _ENTER
        if auto_leave:
            w |= _AUTO
    return w


def encode_leave_joint() -> int:
    return _LEAVE


def is_leave_joint(data: torch.Tensor) -> torch.Tensor:
    return (data & _LEAVE) != 0


def _apply_one(spec, v, vo, l, ln_, joint, op, nid, enable):
    """One change against the incoming config (confchange.go:152-230).
    Masks [N, M, C]; joint, op, nid, enable [N, C]."""
    ids = torch.arange(spec.M, dtype=torch.int32, device=v.device).view(1, -1, 1)
    hot = (ids == nid.unsqueeze(1)) & enable.unsqueeze(1)
    op = op.unsqueeze(1)
    add_v = hot & (op == CC_ADD_NODE)
    add_l = hot & (op == CC_ADD_LEARNER)
    rem = hot & (op == CC_REMOVE_NODE)
    v = (v | add_v) & ~add_l & ~rem                    # makeVoter
    # makeLearner: a demoted voter still in the outgoing config is staged
    # in LearnersNext until LeaveJoint
    stage = add_l & joint.unsqueeze(1) & vo
    l = (l | (add_l & ~stage)) & ~add_v & ~rem
    ln_ = (ln_ | stage) & ~add_v & ~rem
    return v, vo, l, ln_


def apply_conf_change(cfg, spec, n, ob, data, enable):
    """applyConfChange + switchToConfig (raft/raft.go:1623-1700) where
    ``enable`` [N, C], for the entry word ``data`` [N, C]."""
    from etcd_tpu_torch.models import raft as raftmod   # cycle-free at call time
    from etcd_tpu_torch.models.state import in_config_self, is_learner_self

    op1 = data & 7
    id1 = (data >> 3) & 31
    op2 = (data >> 8) & 7
    id2 = (data >> 11) & 31
    has1 = (data & _HAS1) != 0
    has2 = (data & _HAS2) != 0
    enter = ((data & _ENTER) != 0) | (has1 & has2)
    auto = (data & _AUTO) != 0
    leave = (data & _LEAVE) != 0

    v, vo, l, ln_ = n.voters, n.voters_out, n.learners, n.learners_next

    # LeaveJoint (confchange.go:97-123)
    do_leave = (enable & leave).unsqueeze(1)
    l_l = l | ln_

    # EnterJoint copies incoming -> outgoing first (confchange.go:49-95)
    change = enable & ~leave
    do_change = change.unsqueeze(1)
    vo_c = torch.where((change & enter).unsqueeze(1), v, vo)
    joint_now = vo_c.any(1)
    v_c, vo_c, l_c, ln_c = _apply_one(spec, v, vo_c, l, ln_, joint_now, op1, id1,
                                      change & has1)
    v_c, vo_c, l_c, ln_c = _apply_one(spec, v_c, vo_c, l_c, ln_c, joint_now, op2,
                                      id2, change & has2)

    was_tracked = v | vo | l | ln_

    def pick(left, changed, old):
        return torch.where(do_leave, left, torch.where(do_change, changed, old))

    n = n.replace(
        voters=pick(v, v_c, n.voters),
        voters_out=pick(False, vo_c, n.voters_out),
        learners=pick(l_l, l_c, n.learners),
        learners_next=pick(False, ln_c, n.learners_next),
        auto_leave=torch.where(enable & leave, False,
                               torch.where(change & enter, auto, n.auto_leave)),
    )

    # fresh Progress for members entering the tracked set
    # (confchange.go:249-272 initProgress)
    now_tracked = n.voters | n.voters_out | n.learners | n.learners_next
    fresh = enable.unsqueeze(1) & now_tracked & ~was_tracked
    N, _, C = n.infl_ends.shape
    ends = n.infl_ends.view(N, spec.M, spec.W, C)
    n = n.replace(
        match=torch.where(fresh, 0, n.match),
        next_idx=torch.where(fresh, torch.clamp(n.last_index, min=1).unsqueeze(1),
                             n.next_idx),
        pr_state=torch.where(fresh, PR_PROBE, n.pr_state),
        probe_sent=torch.where(fresh, False, n.probe_sent),
        pending_snapshot=torch.where(fresh, 0, n.pending_snapshot),
        recent_active=torch.where(fresh, True, n.recent_active),
        infl_count=torch.where(fresh, 0, n.infl_count),
        infl_start=torch.where(fresh, 0, n.infl_start),
        infl_ends=torch.where(fresh.unsqueeze(2), 0, ends).reshape(N, -1, C),
    )

    # switchToConfig side effects (raft.go:1651-1700)
    self_ok = in_config_self(n) & ~is_learner_self(n)
    active = enable & (n.role == ROLE_LEADER) & self_ok & n.voters.any(1)
    n2, adv = raftmod.maybe_commit_state(cfg, spec, n)
    n = tree_where(active & adv, n2, n)
    n, ob = raftmod.bcast_append(cfg, spec, n, ob, active & adv)
    n, ob = raftmod.maybe_send_append(
        cfg, spec, n, ob, raftmod._progress_ids(n) & (active & ~adv).unsqueeze(1),
        False)
    # abort a transfer to a peer no longer in the voter union (raft.go:1694-1697)
    tr = torch.clamp(n.lead_transferee, 0, spec.M - 1)
    gone = (n.lead_transferee != NONE_ID) & ~raftmod.onehot_sel(
        n.voters | n.voters_out, tr)
    return n.replace(lead_transferee=torch.where(enable & gone, NONE_ID,
                                                 n.lead_transferee)), ob
