"""The consensus drive of bench.py, on the port (bench.py:458-552).

Two phases over a fleet of C five-member groups:
  * ``settle_leaders``: member 0 of every group campaigns, and the round
    runs until every group has a leader and the wire is quiet;
  * ``steady_rounds``: one client proposal per group per round at member 0,
    the leader: MsgProp -> append -> MsgApp -> follower append and
    MsgAppResp -> quorum commit -> apply -> delivery into the next inbox.

The configuration is bench.py's accelerator one (``bench_spec``,
``settle_config``), with ``steady_config`` its steady program in the dense
storage form with immediate emission; etcd_tpu_torch.bench adds the packed
state, deferred emission and sparse outbox of bench.py's defaults. A plain
loop of rounds.
"""
from __future__ import annotations

import dataclasses

import torch

from etcd_tpu_torch.models.engine import build_round
from etcd_tpu_torch.models.state import NodeState
from etcd_tpu_torch.types import (
    MSG_APP,
    MSG_APP_RESP,
    MSG_HUP,
    MSG_PRE_VOTE,
    MSG_PRE_VOTE_RESP,
    MSG_PROP,
    MSG_VOTE,
    MSG_VOTE_RESP,
    PR_SNAPSHOT,
    ROLE_LEADER,
    Msg,
    Spec,
)
from etcd_tpu_torch.utils.config import RaftConfig
from etcd_tpu_torch.utils.device import resolve_device

SETTLE_MAX_ROUNDS = 24


def bench_spec() -> Spec:
    """bench.py:342 at its defaults (BENCH_L=16, BENCH_W=4)."""
    return Spec(M=5, L=16, E=1, K=2, W=4, R=2, A=2)


# the message classes of the settle traffic: the election cascade a MsgHup
# starts, plus steady replication (no tick, so no heartbeat, check-quorum
# step, snapshot, read or transfer)
SETTLE_CLASSES = (
    MSG_HUP, MSG_PRE_VOTE, MSG_PRE_VOTE_RESP, MSG_VOTE, MSG_VOTE_RESP,
    MSG_APP, MSG_APP_RESP, MSG_PROP,
)


def settle_config(spec: Spec) -> RaftConfig:
    """bench.py:385-389 (inbox bound M-1, int16 compact wire), specialised
    to what its rounds carry: they never tick and inject no read-index
    request, so the local steps are the MsgHup and MsgProp injections, the
    message classes SETTLE_CLASSES and the entries normal ones
    (tests/test_torch_round.py holds it equal to bench.py's full settle
    program)."""
    return RaftConfig(pre_vote=True, check_quorum=True, max_inflight=min(4, spec.W),
                      inbox_bound=spec.M - 1, coalesce_commit_refresh=True,
                      wire_int16=True, compact_wire=True,
                      local_steps=("hup", "prop"), message_classes=SETTLE_CLASSES,
                      entry_classes=("normal",))


def steady_config(settle: RaftConfig) -> RaftConfig:
    """bench.py:408-430 with immediate emission and dense state."""
    return dataclasses.replace(
        settle, local_steps=("prop",),
        message_classes=(MSG_APP, MSG_APP_RESP, MSG_PROP),
        entry_classes=("normal",))


def _inputs(spec: Spec, C: int, dev):
    M, E = spec.M, spec.E
    z2 = torch.zeros((M, C), dtype=torch.int32, device=dev)
    zp = torch.zeros((M, E, C), dtype=torch.int32, device=dev)
    no = torch.zeros((M, C), dtype=torch.bool, device=dev)
    keep = torch.ones((M, M, C), dtype=torch.bool, device=dev)
    return z2, zp, no, keep


def settle_leaders(cfg: RaftConfig, spec: Spec, state: NodeState, inbox: Msg,
                   device=None):
    """Campaign member 0 of every group, then run at most 24 more rounds
    until all C groups have a leader and no message is in flight (the
    steady state the timed rounds start from). Returns (state, inbox,
    rounds run after the campaign round); raises if the fleet did not
    settle."""
    dev = resolve_device(device)
    C = state.term.shape[-1]
    step = build_round(cfg, spec)
    z2, zp, no, keep = _inputs(spec, C, dev)
    hup0 = no.clone()
    hup0[0] = True
    state, inbox = step(state, inbox, z2, zp, zp, z2, hup0, no, keep)
    rounds = 0
    for rounds in range(1, SETTLE_MAX_ROUNDS + 1):
        state, inbox = step(state, inbox, z2, zp, zp, z2, no, no, keep)
        if _leaders(state) == C and _in_flight(inbox) == 0:
            break
    leaders, busy = _leaders(state), _in_flight(inbox)
    if leaders != C or busy:
        raise RuntimeError(f"fleet did not settle in {rounds} rounds: {leaders} "
                           f"of {C} leaders, {busy} messages in flight")
    return state, inbox, rounds


def steady_rounds(cfg: RaftConfig, spec: Spec, state: NodeState, inbox: Msg,
                  rounds: int, keep: torch.Tensor | None = None):
    """``rounds`` steady rounds with one proposal per group per round at
    member 0 (``steady_inputs``), on the device the fleet lies on, in the
    state's storage form (dense, or packed under cfg.packed_state).
    ``keep``: optional keep-mask [M, M, C]. Returns (state, inbox)."""
    step = build_round(cfg, spec)
    args = steady_inputs(spec, state.rng_key.shape[-1], state.rng_key.device, keep)
    for _ in range(rounds):
        state, inbox = step(state, inbox, *args)
    return state, inbox


def steady_inputs(spec: Spec, C: int, device, keep: torch.Tensor | None = None):
    """The per-round inputs of a steady round after the (state, inbox)
    carry: one proposal per group at member 0 (prop_len[0] = 1,
    prop_data[0, 0] = 7), no read index, hup or tick, and ``keep`` or a
    keep-everything mask."""
    z2, zp, no, full = _inputs(spec, C, device)
    prop_len = z2.clone()
    prop_len[0] = 1
    prop_data = zp.clone()
    prop_data[0, 0] = 7
    return (prop_len, prop_data, zp, z2, no, no, full if keep is None else keep)


def check_steady(state: NodeState, commit0: int, rounds: int) -> int:
    """bench.py:548-552: the slowest member advanced its commit by at least
    ``rounds - 4`` (commit trails the proposal by the append -> ack
    pipeline), and no leader fell back to a snapshot, which the round's
    handlers do not take. Returns the minimum commit advance."""
    adv = int(state.commit.min()) - commit0
    if adv < rounds - 4:
        raise RuntimeError(f"commit advanced {adv} in {rounds} rounds; the fleet "
                           "is not in one-commit-per-round steady state")
    if bool((state.pr_state == PR_SNAPSHOT).any()):
        raise RuntimeError("a leader sent MsgSnap, which this port does not handle yet")
    # the KV_HASH check: members that applied as far agree on the hash chain
    same = state.applied.unsqueeze(1) == state.applied.unsqueeze(0)     # [M, M, C]
    agree = state.applied_hash.unsqueeze(1) == state.applied_hash.unsqueeze(0)
    if bool((same & ~agree).any()):
        raise RuntimeError("members at equal applied index disagree on applied_hash")
    return adv


def _leaders(state: NodeState) -> int:
    return int((state.role == ROLE_LEADER).sum())


def _in_flight(inbox: Msg) -> int:
    return int((inbox.type != 0).sum())
