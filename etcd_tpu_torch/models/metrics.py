"""Fleet observability counters (etcd_tpu/models/metrics.py).

A small ``FleetMetrics`` of 0-dim int32 tensors stays on the fleet's device
and is updated by reductions inside the metered round; the host reads it
once per report (``metrics_report``). ``CrashMetrics`` are the chaos
tier's crash and membership counters (``crash_metrics_report``).
``fleet_summary`` is the whole-fleet status aggregate, ``basic_status``
one lane's raft.Status. The counters are
int32 like the JAX package's, so a window must be short enough not to wrap
(both reports raise if one has). ``build_metered_round`` also carries the
telemetry plane (models/telemetry.py) and the black-box event ring
(models/blackbox.py) when asked.
"""
from __future__ import annotations

import dataclasses

import torch

from etcd_tpu_torch.models.blackbox import blackbox_update, msg_activity, snapshot_pre
from etcd_tpu_torch.models.engine import build_round
from etcd_tpu_torch.models.state import NodeState, unpack_fleet
from etcd_tpu_torch.models.telemetry import telemetry_update
from etcd_tpu_torch.types import (
    PR_PROBE,
    PR_REPLICATE,
    PR_SNAPSHOT,
    ROLE_LEADER,
    Spec,
    TensorStruct,
)
from etcd_tpu_torch.utils.config import RaftConfig
from etcd_tpu_torch.utils.device import resolve_device

# commit-apply lag histogram bucket upper bounds (entries); last is +inf
LAG_BUCKETS = (0, 1, 2, 4, 8, 16, 32)

I32 = torch.int32


@dataclasses.dataclass
class FleetMetrics(TensorStruct):
    rounds: torch.Tensor          # lockstep rounds executed
    elections_won: torch.Tensor   # nodes that newly became leader
    leader_losses: torch.Tensor   # nodes that stopped being leader
    commits: torch.Tensor         # sum of per-node commit advances
    applies: torch.Tensor         # sum of per-node applied advances
    msgs_delivered: torch.Tensor  # slots surviving the fault mask
    msgs_dropped: torch.Tensor    # emitted slots killed by the keep-mask
    lag_hist: torch.Tensor        # [len(LAG_BUCKETS)+1] cumulative lag counts


def zero_metrics(device=None) -> FleetMetrics:
    dev = resolve_device(device)

    def z():
        return torch.zeros((), dtype=I32, device=dev)

    return FleetMetrics(
        rounds=z(), elections_won=z(), leader_losses=z(), commits=z(),
        applies=z(), msgs_delivered=z(), msgs_dropped=z(),
        lag_hist=torch.zeros((len(LAG_BUCKETS) + 1,), dtype=I32, device=dev))


def _count(x: torch.Tensor) -> torch.Tensor:
    """A sum as the int32 the JAX counters add (wrapping as int32 does)."""
    return x.sum().to(I32)


@dataclasses.dataclass
class CrashMetrics(TensorStruct):
    """The chaos tier's crash-restart and membership counters
    (etcd_tpu/models/metrics.py CrashMetrics), int32 0-dim tensors carried
    by the chaos epoch and read once per report."""
    crashes_injected: torch.Tensor       # nodes killed by the crash mask
    entries_lost_fsync: torch.Tensor     # log entries dropped past `stable`
    restarts_completed: torch.Tensor     # down-timers that reached 0
    member_changes_proposed: torch.Tensor  # conf-change proposals injected
    cc_guard_refusals: torch.Tensor      # guard outcome at injection: refuse
    cc_guard_admits: torch.Tensor        # guard outcome at injection: admit
    conf_changes_applied: torch.Tensor   # lanes whose applied config changed
    joint_entered: torch.Tensor          # lanes entering a joint config
    joint_left: torch.Tensor             # lanes leaving a joint config
    snap_window_lanes: torch.Tensor      # lanes in-window at sampling time
    snap_window_crashes: torch.Tensor    # crashes that landed in-window
    member_window_lanes: torch.Tensor
    member_window_crashes: torch.Tensor


def zero_crash_metrics(device=None) -> CrashMetrics:
    dev = resolve_device(device)
    return CrashMetrics(**{k: torch.zeros((), dtype=I32, device=dev)
                           for k in CrashMetrics.names()})


def crash_metrics_report(m: CrashMetrics) -> dict:
    """One host transfer -> the counters as a plain dict, with the two
    window hit rates; raises OverflowError if a counter has wrapped."""
    vals = torch.stack([v for _, v in m.items()]).tolist()
    out = dict(zip(CrashMetrics.names(), vals))
    if any(v < 0 for v in out.values()):
        raise OverflowError(
            "CrashMetrics counter wrapped (i32); shorten the run or shard "
            "the report window")
    crashes = max(out["crashes_injected"], 1)
    out["snap_window_hit_rate"] = round(out["snap_window_crashes"] / crashes, 6)
    out["member_window_hit_rate"] = round(
        out["member_window_crashes"] / crashes, 6)
    return out


def build_metered_round(cfg: RaftConfig, spec: Spec,
                        with_telemetry: bool = False,
                        with_blackbox: bool = False):
    """The round with the metric updates after it: fn(state, inbox,
    prop_len, prop_data, prop_type, ri_ctx, do_hup, do_tick, keep_mask,
    metrics) -> (state, inbox, metrics). ``with_telemetry`` adds a trailing
    FleetTelemetry argument and result, ``with_blackbox`` an EventRing
    after it (the JAX function's positional order; the ring is written in
    place). State and inbox are the bare round's: the planes only read.
    Under packed_state the counters and planes read unpacked views of the
    state before and after the round; the leaves they read of the state
    before it are copied first, and the ring's receive side is taken from
    the inbox before the round consumes it, since under fleet_chunks > 1
    the round writes into both."""
    round_fn = build_round(cfg, spec, with_drop_count=True)

    def unp(s):
        return unpack_fleet(spec, s) if cfg.packed_state else s

    edges = torch.tensor(LAG_BUCKETS, dtype=I32)

    def metered(state, inbox, prop_len, prop_data, prop_type, ri_ctx, do_hup,
                do_tick, keep_mask, metrics: FleetMetrics, telemetry=None,
                blackbox=None):
        pre = unp(state)
        was_leader = pre.role == ROLE_LEADER
        if with_telemetry or with_blackbox:
            pre = snapshot_pre(pre)
            commit0, applied0 = pre.commit, pre.applied
        else:
            commit0, applied0 = pre.commit.clone(), pre.applied.clone()
        recv = msg_activity(spec, inbox, "recv") if with_blackbox else None
        state, nxt, dropped = round_fn(state, inbox, prop_len, prop_data,
                                       prop_type, ri_ctx, do_hup, do_tick,
                                       keep_mask)
        post = unp(state)
        is_leader = post.role == ROLE_LEADER
        lag = post.commit - post.applied
        # Prometheus-style cumulative buckets: hist[b] counts lag <= edges[b];
        # the last slot counts every sample (+inf bucket)
        cum = (lag.unsqueeze(-1) <= edges.to(lag.device)).flatten(0, -2).sum(0)
        total = torch.full((1,), lag.numel(), dtype=cum.dtype, device=cum.device)
        metrics = FleetMetrics(
            rounds=metrics.rounds + 1,
            elections_won=metrics.elections_won + _count(is_leader & ~was_leader),
            leader_losses=metrics.leader_losses + _count(was_leader & ~is_leader),
            commits=metrics.commits + _count(post.commit - commit0),
            applies=metrics.applies + _count(post.applied - applied0),
            msgs_delivered=metrics.msgs_delivered + _count(nxt.type != 0),
            msgs_dropped=metrics.msgs_dropped + dropped.to(I32),
            lag_hist=metrics.lag_hist + torch.cat([cum, total]).to(I32),
        )
        out = (state, nxt, metrics)
        if with_telemetry:
            out += (telemetry_update(spec, telemetry, pre, post),)
        if with_blackbox:
            # the consumed wire is the round's receive side, the fresh wire
            # its send side
            out += (blackbox_update(spec, blackbox, pre, post, inbox=recv, outbox=nxt),)
        return out

    return metered


def metrics_report(metrics: FleetMetrics, elapsed_s: float | None = None,
                   n_groups: int | None = None,
                   n_members: int | None = None) -> dict:
    """One host transfer -> a plain dict (the JAX function's keys)."""
    m = {k: v.cpu() for k, v in metrics.items()}
    if int(m["msgs_delivered"]) < 0 or int(m["commits"]) < 0 or int(m["applies"]) < 0:
        raise OverflowError("FleetMetrics counter wrapped (i32); reset metrics "
                            "per window with zero_metrics()")
    hist = [int(v) for v in m["lag_hist"]]
    out = {
        "rounds": int(m["rounds"]),
        "elections_won": int(m["elections_won"]),
        "leader_losses": int(m["leader_losses"]),
        "commits_total": int(m["commits"]),
        "applies_total": int(m["applies"]),
        "msgs_delivered": int(m["msgs_delivered"]),
        "msgs_dropped": int(m["msgs_dropped"]),
        "commit_apply_lag_hist": {
            **{f"le_{b}": v for b, v in zip(LAG_BUCKETS, hist)},
            "inf": hist[-1],
        },
    }
    if elapsed_s and elapsed_s > 0:
        out["commits_per_sec"] = round(int(m["commits"]) / elapsed_s, 1)
        out["rounds_per_sec"] = round(int(m["rounds"]) / elapsed_s, 1)
    if n_groups:
        # `commits` sums per-replica commit advances; over the replica
        # count it is committed entries per group per round
        nodes = n_groups * (n_members or 1)
        key = ("commits_per_group_per_round" if n_members
               else "commit_advances_per_node_per_round")
        out[key] = round(int(m["commits"]) / max(int(m["rounds"]), 1) / nodes, 4)
    return out


_ROLE_NAMES = {0: "StateFollower", 1: "StatePreCandidate",
               2: "StateCandidate", 3: "StateLeader"}
_PR_NAMES = {PR_PROBE: "StateProbe", PR_REPLICATE: "StateReplicate",
             PR_SNAPSHOT: "StateSnapshot"}


def fleet_summary(state: NodeState) -> dict:
    """Whole-fleet aggregate status: the reductions run on the fleet's
    device, then one transfer."""
    s = state
    lag = s.commit - s.applied
    per_group_leaders = (s.role == ROLE_LEADER).sum(0)
    edges = torch.tensor(LAG_BUCKETS, dtype=I32, device=lag.device)
    r = torch.stack([
        *[(s.role == k).sum() for k in range(4)],
        s.term.max().long(), s.commit.min().long(), s.commit.max().long(),
        s.applied.max().long(), lag.max().long(), lag.long().sum(),
        (per_group_leaders > 0).sum(), (per_group_leaders > 1).sum(),
        *(lag.unsqueeze(-1) <= edges).sum((0, 1)),
    ]).tolist()
    M, C = s.role.shape[0], s.role.shape[-1]
    return {
        "nodes": M * C,
        "groups": C,
        "roles": {name: r[i] for i, name in _ROLE_NAMES.items()},
        "term_max": r[4],
        "commit_min": r[5],
        "commit_max": r[6],
        "applied_max": r[7],
        "commit_apply_lag_max": r[8],
        "commit_apply_lag_mean": float(r[9]) / (M * C),
        "lag_sum": r[9],
        "commit_apply_lag_hist": {
            **{f"le_{b}": v for b, v in zip(LAG_BUCKETS, r[12:])},
            "inf": M * C,
        },
        "groups_with_leader": r[10],
        "groups_multi_leader": r[11],
    }


def basic_status(state: NodeState, spec: Spec, m: int, c: int = 0) -> dict:
    """raft.Status for one lane (m, c) of the fleet: the BasicStatus fields
    plus the leader's progress map (status.go:26-76). One host read of the
    lane."""
    lane = {k: v[m, ..., c].tolist() for k, v in state.items()}
    role = lane["role"]
    out = {
        "id": m,
        "term": lane["term"],
        "vote": lane["vote"],
        "commit": lane["commit"],
        "applied": lane["applied"],
        "lead": lane["lead"],
        "raft_state": _ROLE_NAMES[role],
    }
    if role == ROLE_LEADER:
        out["progress"] = {
            i: {
                "match": lane["match"][i],
                "next": lane["next_idx"][i],
                "state": _PR_NAMES[lane["pr_state"][i]],
                "is_learner": lane["learners"][i] or lane["learners_next"][i],
                "recent_active": lane["recent_active"][i],
                "pending_snapshot": lane["pending_snapshot"][i],
                "inflight": lane["infl_count"][i],
            }
            for i in range(spec.M)
            if lane["voters"][i] or lane["voters_out"][i] or lane["learners"][i]
            or lane["learners_next"][i]
        }
    return out
