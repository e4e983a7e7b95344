"""The functional chaos tier (etcd_tpu/harness/chaos.py).

The reference's functional tester (tests/functional/tester/cluster.go:43-65)
loops inject -> stress -> recover -> check over a live cluster. Here the
loop runs on the device over a fleet of C groups:

  * drop faults: per-round Bernoulli keep-masks (the blackhole case);
  * partition faults: per-group bisections re-drawn every
    ``partition_period`` rounds, healed between epochs;
  * delay faults (rafttest/network.go:122-144): a message goes into a sparse
    held buffer with probability ``delay_p`` and arrives a round late,
    behind younger messages;
  * crash-restart faults (the SIGKILL cases): per-round crash masks wipe a
    hit node's volatile state and its in-flight traffic, keeping its
    modeled durable state (HardState, snapshot, the log up to the fsync
    floor one round behind last_index); it stays down ``down_rounds``
    rounds and restarts as a follower (utils/config.py CrashConfig);
  * membership faults (the member add/remove cases): node 0's proposal
    becomes a conf-change word from a palette with probability
    ``member_p`` per (round, group) (``member_palette``);
  * targeted crash scheduling: the same expected crash budget, moved onto
    the snapshot-install and membership windows (``targeted_crash_probs``);
  * checkers every round, as reductions into violation counters: at most
    one leader per (group, term), equal applied index => equal applied
    hash, no commit index moves backwards (crashed nodes exempt), and with
    crashes or membership faults the recovery checkers against each
    group's live, possibly joint, configuration: leader completeness, log
    matching across restarts, term monotonicity
    (``check_recovery_invariants``).

The draws are the JAX program's threefry draws, bit for bit, so the port's
epoch equals the JAX epoch on every leaf. The rounds of an epoch make no
host sync; the host reads the counters at epoch boundaries only. Two
read-only planes can ride the epoch beside the fleet: the telemetry plane
(models/telemetry.py; ``run_chaos`` turns it into a flight recorder with one
timeline row per epoch boundary) and the black-box event ring
(models/blackbox.py; each group's ring freezes at its first violation, and
the report's ``forensics`` decodes the first offenders' rings).
"""
from __future__ import annotations

import dataclasses

import torch

from etcd_tpu_torch.models.blackbox import (
    DEFAULT_WINDOW,
    VIOLATION_BIT_NAMES,
    EventRing,
    blackbox_update,
    forensics_report,
    init_blackbox,
    msg_activity,
    snapshot_pre,
)
from etcd_tpu_torch.models.confchange import encode
from etcd_tpu_torch.models.engine import (
    build_round,
    crash_restart_fleet,
    empty_inbox,
    init_fleet,
    member_window_mask,
    snapshot_window_mask,
    wipe_crashed_traffic,
)
from etcd_tpu_torch.models.metrics import (
    CrashMetrics,
    crash_metrics_report,
    zero_crash_metrics,
)
from etcd_tpu_torch.models.state import NodeState
from etcd_tpu_torch.models.telemetry import (
    DEFAULT_BUCKETS,
    FleetTelemetry,
    flight_record,
    init_telemetry,
    telemetry_report,
    telemetry_update,
)
from etcd_tpu_torch.parallel.mesh import CapturedStep
from etcd_tpu_torch.types import (
    CC_ADD_LEARNER,
    CC_ADD_NODE,
    CC_REMOVE_NODE,
    ENTRY_CONF_CHANGE,
    INT32_MAX,
    ROLE_LEADER,
    Msg,
    Spec,
    TensorStruct,
    wrap_int32,
)
from etcd_tpu_torch.utils import prng
from etcd_tpu_torch.utils.config import CrashConfig, MemberChaosConfig, RaftConfig
from etcd_tpu_torch.utils.device import in_eager_mode, resolve_device

VIOLATION_KEYS = (
    "multi_leader", "hash_mismatch", "commit_regress",
    "lost_commit", "log_divergence", "term_regress",
)
# the black box's per-group violation bitmask sets bit i for VIOLATION_KEYS[i]
assert VIOLATION_KEYS == VIOLATION_BIT_NAMES

# delayed messages held per sender row (see HeldSparse)
HELD_SLOTS = 3


@dataclasses.dataclass
class Violations(TensorStruct):
    """Safety-violation counters, int32 0-dim tensors. The last three are
    the recovery checkers' and stay 0 without crash or membership faults."""
    multi_leader: torch.Tensor
    hash_mismatch: torch.Tensor
    commit_regress: torch.Tensor
    lost_commit: torch.Tensor
    log_divergence: torch.Tensor
    term_regress: torch.Tensor


def zero_violations(device=None) -> Violations:
    dev = resolve_device(device)
    return Violations(**{k: torch.zeros((), dtype=torch.int32, device=dev)
                         for k in VIOLATION_KEYS})


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum().to(torch.int32)


@dataclasses.dataclass
class BlackBox(TensorStruct):
    """The forensics plane an epoch carries: the event ring, each group's
    violation kinds as an int32 [C] bitmask in VIOLATION_KEYS bit order,
    and the round of its first violation (int32 [C], -1 for none), where
    its ring freezes."""
    ring: EventRing
    viol_groups: torch.Tensor
    viol_round: torch.Tensor


def empty_blackbox(spec: Spec, state: NodeState,
                   window: int = DEFAULT_WINDOW) -> BlackBox:
    C = state.term.shape[-1]
    dev = state.term.device
    return BlackBox(ring=init_blackbox(spec, state, window=window),
                    viol_groups=torch.zeros((C,), dtype=torch.int32, device=dev),
                    viol_round=torch.full((C,), -1, dtype=torch.int32, device=dev))


def check_invariants(state: NodeState, prev_commit: torch.Tensor,
                     viol: Violations, exempt=None, with_masks: bool = False):
    """One round's checker pass over [M, C] leaves; ``exempt`` ([M, C]
    bool or None) leaves nodes out of the commit-monotonicity check.
    ``with_masks`` also returns the per-group [C] bool masks (multi_leader,
    hash_mismatch, commit_regress) the forensics plane keeps, from the same
    intermediates the counters sum."""
    M = state.role.shape[0]
    is_lead = state.role == ROLE_LEADER
    iu, ju = torch.triu_indices(M, M, 1, device=is_lead.device)
    term = state.term
    both_lead = is_lead[iu] & is_lead[ju] & (term[iu] == term[ju])
    hash_mm = ((state.applied[iu] == state.applied[ju])
               & (state.applied_hash[iu] != state.applied_hash[ju]))
    regress = state.commit < prev_commit
    if exempt is not None:
        regress = regress & ~exempt
    viol = viol.replace(
        multi_leader=viol.multi_leader + _count(both_lead),
        hash_mismatch=viol.hash_mismatch + _count(hash_mm),
        commit_regress=viol.commit_regress + _count(regress),
    )
    if not with_masks:
        return viol
    return viol, (both_lead.any(0), hash_mm.any(0), regress.any(0))


@dataclasses.dataclass
class HeldSparse(TensorStruct):
    """Per-sender-row packed delayed messages: ``idx[m, h, c]`` is the flat
    slot (0..K*M-1) the h-th held message came from (-1 = empty); ``msgs``
    leaves are [M, H(*E), C] in the wire dtype."""
    idx: torch.Tensor
    msgs: Msg


def empty_held(spec: Spec, C: int, wire_int16: bool, device=None) -> HeldSparse:
    dev = resolve_device(device)
    H = HELD_SLOTS
    like = empty_inbox(spec, 1, wire_int16=wire_int16, device=dev)
    S = spec.K * spec.M
    return HeldSparse(
        idx=torch.full((spec.M, H, C), -1, dtype=torch.int32, device=dev),
        msgs=like.map(lambda _, x: torch.zeros((spec.M, H * (x.shape[1] // S), C),
                                               dtype=x.dtype, device=dev)))


def _pack_held(spec: Spec, out: Msg, dm: torch.Tensor) -> HeldSparse:
    """This round's delayed slots (mask ``dm`` [M, S, C]) in the sparse
    form: per sender row, the h-th delayed slot lands in held slot h;
    extras past HELD_SLOTS drop."""
    M, S, H = spec.M, spec.K * spec.M, HELD_SLOTS
    C = dm.shape[-1]
    rank = torch.cumsum(dm.to(torch.int32), 1, dtype=torch.int32) - 1   # [M, S, C]
    hs = torch.arange(H, dtype=torch.int32, device=dm.device).view(1, H, 1, 1)
    sel = (rank.unsqueeze(1) == hs) & dm.unsqueeze(1)                   # [M, H, S, C]
    taken = sel.any(2)                                                  # [M, H, C]
    slots = torch.arange(S, dtype=torch.int32, device=dm.device).view(1, 1, S, 1)
    src = torch.where(sel, slots, 0).sum(2, dtype=torch.int32)          # [M, H, C]
    idx = torch.where(taken, src, -1)

    def pack(_, x):
        e = x.shape[1] // S
        at = src.unsqueeze(2).expand(M, H, e, C).to(torch.int64)
        got = torch.gather(x.view(M, S, e, C), 1, at)
        got = torch.where(taken.unsqueeze(2), got, torch.zeros((), dtype=x.dtype,
                                                               device=x.device))
        return got.reshape(M, H * e, C)

    return HeldSparse(idx=idx, msgs=out.map(pack))


def _held_wins(spec: Spec, held: HeldSparse, fresh: Msg) -> Msg:
    """The sparse held messages scattered back over fresh traffic: a held
    message wins a slot collision (the fresh one drops, as the transport
    contract allows, etcdserver/raft.go:107-110)."""
    M, S, H = spec.M, spec.K * spec.M, HELD_SLOTS
    C = held.idx.shape[-1]
    slots = torch.arange(S, dtype=torch.int32, device=held.idx.device).view(1, 1, S, 1)
    sel = (held.idx.unsqueeze(2) == slots) & (held.idx >= 0).unsqueeze(2)  # [M, H, S, C]
    live = sel.any(1)                                                      # [M, S, C]
    hs = torch.arange(H, dtype=torch.int32, device=sel.device).view(1, H, 1, 1)
    which = torch.where(sel, hs, 0).sum(1, dtype=torch.int32)             # [M, S, C]

    def un(name, f):
        xh = getattr(held.msgs, name)
        e = f.shape[1] // S
        at = which.unsqueeze(2).expand(M, S, e, C).to(torch.int64)
        dense = torch.gather(xh.view(M, H, e, C), 1, at).reshape(M, S * e, C)
        keep = live.unsqueeze(2).expand(M, S, e, C).reshape(M, S * e, C)
        return torch.where(keep, dense.to(f.dtype), f)

    return fresh.map(un)


def _merge_delayed(spec: Spec, out: Msg, held: HeldSparse, delay_mask):
    """Split this round's traffic (flat [from, K*to(*E), C]) by the delay
    mask [from, K*to, C] and merge in the messages held from the previous
    round. Returns (next inbox, new held buffer)."""
    new_held = _pack_held(spec, out, delay_mask)
    fresh = out.replace(type=torch.where(delay_mask, 0, out.type))
    return _held_wins(spec, held, fresh), new_held


@dataclasses.dataclass
class CrashState(TensorStruct):
    """The recovery bookkeeping an epoch carries (etcd_tpu/harness/chaos.py
    CrashState). ``stable`` is each node's durable log floor, its last_index
    at the top of the previous round (the modeled fsync lag); ``down`` the
    rounds of outage left; ``watermark`` each group's highest committed
    index so far; ``prev_term`` the term-monotonicity baseline; the ``ref_*``
    leaves each group's newest applied configuration (incoming voters,
    outgoing voters, tracked members, bool [M(id), C]) and the applied index
    it was taken at, kept across crash rewinds by refresh_ref_config."""
    stable: torch.Tensor          # int32 [M, C]
    down: torch.Tensor            # int32 [M, C], 0 = up
    watermark: torch.Tensor       # int32 [C]
    prev_term: torch.Tensor       # int32 [M, C]
    ref_voters: torch.Tensor      # bool [M, C]
    ref_voters_out: torch.Tensor  # bool [M, C]
    ref_tracked: torch.Tensor     # bool [M, C]
    ref_applied: torch.Tensor     # int32 [C]
    metrics: CrashMetrics


def refresh_ref_config(state: NodeState, crash: CrashState) -> CrashState:
    """Adopt each group's newest applied configuration as the recovery
    checkers' reference: the config of its member with the highest applied
    index (the lowest id on a tie), unless an earlier reference was taken at
    a higher applied index (a crash rewinds applied configs to the snapshot,
    and a mass outage must not regress the checker to a stale view)."""
    best = state.applied.amax(0)                                   # [C]
    is_best = state.applied == best
    first = is_best & (torch.cumsum(is_best, 0) == 1)             # one-hot

    def pick(mask):  # [M(node), M(id), C] -> the best node's [M(id), C]
        return (first.unsqueeze(1) & mask).any(0)

    tracked = state.voters | state.voters_out | state.learners | state.learners_next
    adopt = (best >= crash.ref_applied).unsqueeze(0)
    return crash.replace(
        ref_voters=torch.where(adopt, pick(state.voters), crash.ref_voters),
        ref_voters_out=torch.where(adopt, pick(state.voters_out), crash.ref_voters_out),
        ref_tracked=torch.where(adopt, pick(tracked), crash.ref_tracked),
        ref_applied=torch.maximum(crash.ref_applied, best),
    )


def check_recovery_invariants(spec: Spec, state: NodeState, crash: CrashState,
                              viol: Violations, config_aware, with_masks: bool = False):
    """The recovery checkers of one round, counted into ``viol``; returns
    (viol, crash) with the reference config, watermark and term baseline
    refreshed (etcd_tpu/harness/chaos.py check_recovery_invariants).

    * term_regress: a node's term moved backwards (term and vote are fsync'd
      before any message shows them, so nothing may regress them).
    * lost_commit: an index the group once committed could be erased by an
      election: in the reference config's incoming voters, and when joint
      in its outgoing voters too, the nodes whose log misses it form a
      quorum on their own.
    * log_divergence: two tracked members that can read the tracked
      members' lowest commit index disagree on its term.

    ``config_aware`` (a 0-dim bool tensor): False selects the
    deliberately config-blind variant, a static majority of all M member
    slots with every slot tracked, which fires on a remove-voter schedule
    the honest checker accepts. ``with_masks`` also returns the per-group
    [C] bool masks (lost_commit, log_divergence, term_regress) for the
    forensics plane: (viol, crash, masks)."""
    M = spec.M
    crash = refresh_ref_config(state, crash)
    t_reg_mask = state.term < crash.prev_term
    wm = torch.maximum(crash.watermark, state.commit.amax(0))      # [C]
    holders = state.last_index >= wm                               # [M, C]

    def electable_without(half):
        """Could a candidate missing wm win this half? Yes iff its
        non-holders reach the half's quorum by themselves."""
        nv = half.sum(0)
        non = (half & ~holders).sum(0)
        return (nv > 0) & (non >= nv // 2 + 1)

    out_empty = ~crash.ref_voters_out.any(0)
    erasable = electable_without(crash.ref_voters) & (
        out_empty | electable_without(crash.ref_voters_out))
    blind = holders.sum(0) < (M // 2 + 1)
    lost = torch.where(config_aware, erasable, blind) & (wm > 0)

    # log matching at the tracked members' committed frontier mc: members
    # compacted past it abstain, a snapshot boundary answers with snap_term
    tracked = torch.where(config_aware, crash.ref_tracked,
                          torch.ones_like(crash.ref_tracked))
    mc = torch.where(tracked, state.commit, INT32_MAX).amin(0)     # [C]
    L = state.log_term.shape[1]
    oh = torch.arange(L, dtype=torch.int32, device=mc.device).unsqueeze(1) == (mc - 1) % L
    t_ring = (state.log_term * oh).sum(1, dtype=torch.int32)       # [M, C]
    t_mc = torch.where(mc == state.snap_index, state.snap_term, t_ring)
    can_read = tracked & (mc >= state.snap_index) & (mc > 0) & (mc < INT32_MAX)
    iu, ju = torch.triu_indices(M, M, 1, device=mc.device)
    diverged = (t_mc[iu] != t_mc[ju]) & can_read[iu] & can_read[ju]
    viol = viol.replace(
        term_regress=viol.term_regress + _count(t_reg_mask),
        lost_commit=viol.lost_commit + _count(lost),
        log_divergence=viol.log_divergence + _count(diverged),
    )
    crash = crash.replace(watermark=wm, prev_term=state.term.clone())
    if not with_masks:
        return viol, crash
    return viol, crash, (lost, diverged.any(0), t_reg_mask.any(0))


def member_palette(spec: Spec, mix: str = "standard", device=None) -> torch.Tensor:
    """The conf-change words the membership tier injects, int32 [P] (the
    mixes of utils/config.py MEMBER_MIXES): "simple" adds a voter, removes
    one or adds a learner, per id >= 2; "standard" adds the two-delta
    auto-joint words; "shrink" only removes voters. No word removes or
    demotes ids 0 and 1, the voter floor the fsync-lag crash model needs."""
    ids = list(range(2, spec.M))
    if not ids:
        raise ValueError("member chaos needs spec.M >= 3 (ids 0/1 are the "
                         "never-removed voter floor)")
    if mix == "shrink":
        words = [encode([(CC_REMOVE_NODE, i)]) for i in ids]
    else:
        words = []
        for i in ids:
            words += [encode([(CC_ADD_NODE, i)]), encode([(CC_REMOVE_NODE, i)]),
                      encode([(CC_ADD_LEARNER, i)])]
        if mix == "standard" and len(ids) >= 2:
            a, b = ids[-2], ids[-1]
            words += [
                encode([(CC_ADD_NODE, a), (CC_ADD_NODE, b)]),
                encode([(CC_REMOVE_NODE, a), (CC_REMOVE_NODE, b)]),
                encode([(CC_ADD_NODE, a), (CC_REMOVE_NODE, b)]),
                encode([(CC_ADD_LEARNER, a), (CC_ADD_LEARNER, b)]),
            ]
    return torch.tensor(words, dtype=torch.int32).to(resolve_device(device))


def targeted_crash_probs(crash_p, snap_win, mem_win, snap_boost,
                         member_boost) -> torch.Tensor:
    """Per-lane crash probabilities, float32 [M, C], that move the same
    expected crash budget (crash_p x lanes) onto the fault windows: a
    snapshot-window lane gets crash_p x snap_boost, a membership-window lane
    crash_p x member_boost, the rest of the budget spreads evenly over the
    other lanes; if the windows alone would overspend it, both window rates
    scale down. The float32 operations are the JAX function's, one by one,
    in its order. ``crash_p`` and the boosts are float32 0-dim tensors."""
    f32, dev = torch.float32, snap_win.device
    one = torch.ones((), dtype=f32, device=dev)
    lanes = torch.full((), snap_win.numel(), dtype=f32, device=dev)
    budget = crash_p * lanes
    mem_only = mem_win & ~snap_win
    w_s = snap_win.sum().to(f32)
    w_m = mem_only.sum().to(f32)
    p_s = torch.minimum(crash_p * snap_boost, one)
    p_m = torch.minimum(crash_p * member_boost, one)
    spend = p_s * w_s + p_m * w_m
    eps = torch.full((), 1e-9, dtype=f32, device=dev)
    scale = torch.where(spend > budget, budget / torch.maximum(spend, eps), one)
    p_s = p_s * scale
    p_m = p_m * scale
    rest = torch.maximum(lanes - w_s - w_m, one)
    p_base = torch.clamp((budget - p_s * w_s - p_m * w_m) / rest, 0.0, 1.0)
    return torch.where(snap_win, p_s, torch.where(mem_only, p_m, p_base))


def empty_crash_state(state: NodeState) -> CrashState:
    """The recovery bookkeeping at boot: nothing down, the floor at
    last_index, and the boot config adopted as the reference."""
    f2 = torch.zeros_like(state.last_index, dtype=torch.bool)
    base = CrashState(
        stable=state.last_index.clone(),
        down=torch.zeros_like(state.last_index),
        watermark=state.commit.amax(0),
        prev_term=state.term.clone(),
        ref_voters=f2, ref_voters_out=f2, ref_tracked=f2,
        # epoch -1: the first refresh adopts the boot config
        ref_applied=torch.full(state.term.shape[-1:], -1, dtype=torch.int32,
                               device=state.term.device),
        metrics=zero_crash_metrics(state.term.device),
    )
    return refresh_ref_config(state, base)


@dataclasses.dataclass
class Carry(TensorStruct):
    """What one chaos round reads and writes: the fleet, its inbox and held
    buffer, the recovery bookkeeping, the fault key and the epoch's
    partition key, the partition period index, the counters and the
    previous round's commit indexes; and the round's fixed inputs
    (proposals, the network fault probabilities, and under crash or
    membership faults the knobs: crash_p, down_rounds, keep_log,
    config_aware, member_p, palette, snap_boost, member_boost), and the
    planes' carries, None where a plane is off."""
    state: NodeState
    inbox: Msg
    held: HeldSparse | None
    crash: CrashState | None
    key: torch.Tensor          # int64 [2]
    pkey: torch.Tensor         # int64 [2]
    period: torch.Tensor       # int64 []
    viol: Violations
    prev_commit: torch.Tensor  # int32 [M, C]
    prop_len: torch.Tensor
    prop_data: torch.Tensor
    probs: tuple               # float32 [] drop, delay, partition
    knobs: tuple
    tele: FleetTelemetry | None
    bb: BlackBox | None


KNOB_NAMES = ("crash_p", "down_rounds", "keep_log", "config_aware", "member_p",
              "palette", "snap_boost", "member_boost")


def pre_round(cfg: RaftConfig, spec: Spec, c: Carry, sample: bool, with_crash: bool,
              with_delay: bool):
    """A chaos round's top-of-round crash bookkeeping over the whole fleet:
    run the down-timers, with ``sample`` kill fresh nodes (targeted_crash_probs,
    then crash_restart_fleet into the fleet's own leaves), silence every down
    node's in-flight traffic and refresh the durable floor. Returns (state,
    inbox, held, crash, key, hit, alive, restarted); hit, alive and the
    restarts completed this round (bool [M, C]) are None without crashes
    (the JAX epoch's pre_round)."""
    state, inbox, held, crash, key = c.state, c.inbox, c.held, c.crash, c.key
    if not with_crash:
        return state, inbox, held, crash, key, None, None, None
    crash_p, down_rounds, keep_log, _, _, _, snap_boost, member_boost = c.knobs
    down = torch.clamp_min(crash.down - 1, 0)
    rst = (crash.down > 0) & (down == 0)
    m = crash.metrics
    hit = None
    if sample:
        key, ck, tk = prng.split(key, 3)
        # windows and crashes count at sampling instants only
        snap_win = snapshot_window_mask(spec, state, inbox)
        mem_win = member_window_mask(spec, state)
        p_lane = targeted_crash_probs(crash_p, snap_win, mem_win, snap_boost,
                                      member_boost)
        hit = prng.bernoulli(ck, p_lane) & (down == 0)
        # a restart draws a fresh randomized election timeout in [T, 2T)
        rand_to = cfg.election_tick + prng.randint(tk, 0, cfg.election_tick,
                                                   tuple(hit.shape))
        state, lost = crash_restart_fleet(spec, state, hit, crash.stable, rand_to,
                                          keep_log)
        down = torch.where(hit, down_rounds, down)
        m = m.replace(
            crashes_injected=m.crashes_injected + _count(hit),
            entries_lost_fsync=m.entries_lost_fsync + lost,
            snap_window_lanes=m.snap_window_lanes + _count(snap_win),
            snap_window_crashes=m.snap_window_crashes + _count(hit & snap_win),
            member_window_lanes=m.member_window_lanes + _count(mem_win),
            member_window_crashes=m.member_window_crashes + _count(hit & mem_win))
    # a down node's traffic is dead every round it is down: the from-wipe
    # makes the fsync-lag loss safe (the unsynced entries' acks die with it),
    # and re-wiping while down kills held messages that resurface
    inbox = wipe_crashed_traffic(spec, inbox, down > 0)
    if hit is not None and with_delay:
        # what a crashed sender emitted in its lost round may sit in the held
        # buffer too: the same unsynced sends, the same wipe
        held = held.replace(idx=torch.where(hit.unsqueeze(1), -1, held.idx))
    crash = crash.replace(
        stable=state.last_index.clone(), down=down,
        metrics=m.replace(restarts_completed=m.restarts_completed + _count(rst)))
    return state, inbox, held, crash, key, hit, down == 0, rst


def inject_member(c: Carry, state: NodeState, crash: CrashState, key, alive, zp):
    """Node 0's proposal becomes a palette word with probability member_p per
    group, on fresh proposal tensors (a draw that lands while node 0 is down
    is dropped before the counters); the leader-side guard outcome (a conf
    change pending in (applied, pci], or a joint config) is counted against
    the group's current leader. Returns (key, prop_data, prop_type, crash)
    (the JAX epoch's inject_member)."""
    member_p, palette = c.knobs[4], c.knobs[5]
    key, kc, kw = prng.split(key, 3)
    C = state.term.shape[-1]
    do_cc = prng.bernoulli(kc, member_p, (C,))
    if alive is not None:
        do_cc = do_cc & alive[0]
    pi = prng.randint(kw, 0, palette.shape[0], (C,))
    word = palette[pi.long()]
    pd = c.prop_data.clone()
    pd[0, 0] = torch.where(do_cc, word, c.prop_data[0, 0])
    pt = zp.clone()
    pt[0, 0] = do_cc.to(torch.int32) * ENTRY_CONF_CHANGE
    is_lead = state.role == ROLE_LEADER
    guard = (state.pending_conf_index > state.applied) | state.voters_out.any(1)
    has_lead = is_lead.any(0)
    refuse = (is_lead & guard).any(0)
    m = crash.metrics
    crash = crash.replace(metrics=m.replace(
        member_changes_proposed=m.member_changes_proposed + _count(do_cc),
        cc_guard_refusals=m.cc_guard_refusals + _count(do_cc & has_lead & refuse),
        cc_guard_admits=m.cc_guard_admits + _count(do_cc & has_lead & ~refuse)))
    return key, pd, pt, crash


def _mask_down(keep, pl, dt, alive):
    """Down nodes neither exchange traffic, tick, nor propose."""
    if alive is None:
        return keep, pl, dt
    return (keep & alive.unsqueeze(1) & alive.unsqueeze(0),
            torch.where(alive, pl, 0), dt & alive)


def _post_checks(spec: Spec, c: Carry, pre, state: NodeState, crash, hit,
                 with_recovery: bool, with_blackbox: bool):
    """The round's checkers and the count of applied config transitions
    (``pre`` is the snapshot after pre_round, so crash rewinds never count
    as transitions). Returns (crash, viol, gmask): with the black box on,
    gmask is the round's per-group int32 [C] violation bitmask
    (VIOLATION_KEYS bit order), else None."""
    masks = []
    viol = check_invariants(state, c.prev_commit, c.viol, exempt=hit,
                            with_masks=with_blackbox)
    if with_blackbox:
        viol, found = viol
        masks += found
    if with_recovery:
        ch = ((pre.voters != state.voters) | (pre.voters_out != state.voters_out)
              | (pre.learners != state.learners)
              | (pre.learners_next != state.learners_next)).any(1)
        was_j, now_j = pre.voters_out.any(1), state.voters_out.any(1)
        m = crash.metrics
        crash = crash.replace(metrics=m.replace(
            conf_changes_applied=m.conf_changes_applied + _count(ch),
            joint_entered=m.joint_entered + _count(~was_j & now_j),
            joint_left=m.joint_left + _count(was_j & ~now_j)))
        out = check_recovery_invariants(spec, state, crash, viol, c.knobs[3],
                                        with_masks=with_blackbox)
        viol, crash = out[:2]
        if with_blackbox:
            masks += out[2]
    gmask = None
    if with_blackbox:
        gmask = torch.zeros_like(c.bb.viol_groups)
        for bit, mask in enumerate(masks):
            gmask = gmask | (mask.to(torch.int32) << bit)
    return crash, viol, gmask


def _plane_steps(spec: Spec, c: Carry, pre, state: NodeState, recv, out, hit,
                 alive, rst, gmask):
    """The planes' passes of one round (read-only; a plane that is off
    stays None). ``pre`` is the snapshot after pre_round, so a crash rewind
    never reads as a role or applied transition; ``recv`` the receive side
    of the inbox the round consumed, ``out`` the wire it emitted. The ring
    records this round's words in groups that had not violated before it,
    then the round's violations fold into the first-violation bookkeeping,
    so a group's ring keeps the W rounds that end at its violation."""
    down = None if alive is None else ~alive
    tele, bb = c.tele, c.bb
    if tele is not None:
        tele = telemetry_update(spec, tele, pre, state, restarted=rst, down=down)
    if bb is not None:
        r = bb.ring.round
        ring = blackbox_update(spec, bb.ring, pre, state, inbox=recv, outbox=out,
                               crashed=hit, restarted=rst, down=down,
                               write_mask=bb.viol_round < 0)
        fresh = (bb.viol_round < 0) & (gmask != 0)
        bb = BlackBox(ring=ring, viol_groups=bb.viol_groups | gmask,
                      viol_round=torch.where(fresh, r, bb.viol_round))
    return tele, bb


def build_chaos_epoch(cfg: RaftConfig, spec: Spec, rounds: int,
                      faultless: bool = False, partition_period: int = 25,
                      tick: bool = True, with_delay: bool = True,
                      with_crash: bool = False, with_member: bool = False,
                      with_telemetry: bool = False, with_blackbox: bool = False,
                      graph: bool = True, graph_pool=None):
    """One chaos epoch: ``rounds`` lockstep rounds of faulted traffic with
    the checks after every round (etcd_tpu/harness/chaos.py
    build_chaos_epoch).

    Returns fn(state, inbox, held, crash, key, prop_len, prop_data, viol,
    tele, bb, drop_p, delay_p, partition_p, crash_p, down_rounds, keep_log,
    config_aware, member_p, palette, snap_boost, member_boost) -> (state,
    inbox, held, crash, key, viol, tele, bb, commits_delta). The
    probabilities and boosts are float32 0-dim tensors, down_rounds int32,
    keep_log and config_aware bool, palette int32 [P] (member_palette);
    ``held`` is None without ``with_delay``, ``tele`` (a FleetTelemetry) and
    ``bb`` (a BlackBox) are None without ``with_telemetry`` and
    ``with_blackbox``, and ``crash`` is None and the eight knobs after
    partition_p are left out without ``with_crash`` and ``with_member``.
    ``faultless`` is the heal program: it drains the held buffer into the
    entry inbox once (held wins a slot collision), then runs rounds without
    network faults or membership injection; with ``with_crash`` its
    down-timers still run and its checks stay on, but it samples no crash.
    Every epoch first splits the key into (key, partition key), as the JAX
    program does.

    A fault round under ``with_crash`` first runs the down-timers, samples
    the crash mask over the whole fleet (targeted_crash_probs over the
    snapshot-install and membership windows), restarts the hit nodes from
    their durable state (models/engine.py crash_restart_fleet, written into
    the fleet's own leaves), wipes the traffic from and to every down node
    and the held messages of the crashed senders; down nodes neither
    exchange traffic, tick, nor propose. Under ``with_member`` node 0's
    proposal becomes a palette word with probability member_p per group.
    After the round come check_invariants (crashed nodes exempt from the
    commit check), the count of applied config transitions,
    check_recovery_invariants, and the planes' passes, which read the
    round and never feed back (models/telemetry.py telemetry_update,
    models/blackbox.py blackbox_update; the ring is written in place).

    On a CUDA device with ``graph`` the round is one CUDA graph
    (``fn.graph``, a parallel/mesh.py CapturedStep; ``graph_pool`` lets
    several epochs share one memory pool), captured at the first call and
    replayed once a round; its operands, the knobs among them, are device
    tensors of the graph's carry, loaded before each replay. The results are
    then the graph's carry, which the next call overwrites, so a caller that
    keeps them across calls clones them. Otherwise the rounds run eagerly,
    write into the state they are given under ``fleet_chunks`` > 1 or
    ``with_crash``, into the inbox under ``fleet_chunks`` > 1, and into the
    ring, as the JAX program's donated carry does."""
    if cfg.packed_state or cfg.compact_wire:
        raise ValueError(
            "chaos epochs need the unpacked fleet and the dense wire; "
            "run with packed_state=False and compact_wire=False")
    round_fn = build_round(cfg, spec)
    M, K = spec.M, spec.K
    # the recovery bookkeeping serves both fault classes: crashes lose
    # state, membership changes move the quorum the checkers count against
    with_recovery = with_crash or with_member
    need_pre = with_recovery or with_telemetry or with_blackbox

    def fault_round(c: Carry) -> Carry:
        C = c.prev_commit.shape[-1]
        state, inbox, held, crash, key, hit, alive, rst = pre_round(
            cfg, spec, c, True, with_crash, with_delay)
        pre = snapshot_pre(state) if need_pre else None
        zp, z2, no, dt = _quiet_inputs(spec, C, c.key.device, tick)
        pd, pt = c.prop_data, zp
        if with_member:
            key, pd, pt, crash = inject_member(c, state, crash, key, alive, zp)
        drop_p, delay_p, partition_p = c.probs
        # the rolling partition: drawn from the epoch's partition key folded
        # with the period index, so a cut holds for a period
        key, kd, kl = prng.split(key, 3)
        kp = prng.fold_in(c.pkey, c.period)
        side = prng.bernoulli(kp, 0.5, (M, C))
        parted = prng.bernoulli(prng.fold_in(kp, 1), partition_p, (C,))
        keep = ((side.unsqueeze(1) == side.unsqueeze(0)) | ~parted)
        keep = keep & prng.bernoulli(kd, 1.0 - drop_p, (M, M, C))
        keep, pl, dt = _mask_down(keep, c.prop_len, dt, alive)
        # the receive side before the round consumes (and, in chunks,
        # overwrites) the inbox
        recv = msg_activity(spec, inbox, "recv") if with_blackbox else None
        state, out = round_fn(state, inbox, pl, pd, pt, z2, no, dt, keep)
        nxt = out
        if with_delay:
            delay = prng.bernoulli(kl, delay_p, (M, K * M, C)) & (out.type != 0)
            nxt, held = _merge_delayed(spec, out, held, delay)
        crash, viol, gmask = _post_checks(spec, c, pre, state, crash, hit,
                                          with_recovery, with_blackbox)
        # ``out``, before the delay split, is the round's send side
        tele, bb = _plane_steps(spec, c, pre, state, recv, out, hit, alive, rst, gmask)
        return c.replace(state=state, inbox=nxt, held=held, crash=crash, key=key,
                         viol=viol, prev_commit=state.commit.clone(), tele=tele, bb=bb)

    def heal_round(c: Carry) -> Carry:
        C = c.prev_commit.shape[-1]
        state, inbox, _, crash, _, _, alive, rst = pre_round(cfg, spec, c, False,
                                                             with_crash, with_delay)
        pre = snapshot_pre(state) if need_pre else None
        zp, z2, no, dt = _quiet_inputs(spec, C, c.key.device, tick)
        keep = torch.ones((M, M, C), dtype=torch.bool, device=c.key.device)
        keep, pl, dt = _mask_down(keep, c.prop_len, dt, alive)
        recv = msg_activity(spec, inbox, "recv") if with_blackbox else None
        state, out = round_fn(state, inbox, pl, c.prop_data, zp, z2, no, dt, keep)
        crash, viol, gmask = _post_checks(spec, c, pre, state, crash, None,
                                          with_recovery, with_blackbox)
        tele, bb = _plane_steps(spec, c, pre, state, recv, out, None, alive, rst, gmask)
        return c.replace(state=state, inbox=out, crash=crash, viol=viol,
                         prev_commit=state.commit.clone(), tele=tele, bb=bb)

    step = heal_round if faultless else fault_round

    def epoch(state, inbox, held, crash, key, prop_len, prop_data, viol, tele, bb,
              drop_p, delay_p, partition_p, *knobs):
        dev = state.term.device
        if with_recovery and (crash is None or len(knobs) != len(KNOB_NAMES)):
            raise ValueError(f"crash and membership epochs need the CrashState and "
                             f"the knobs {', '.join(KNOB_NAMES)}")
        for on, carry, name in ((with_telemetry, tele, "FleetTelemetry"),
                                (with_blackbox, bb, "BlackBox")):
            if on and carry is None:
                raise ValueError(f"this epoch carries a {name}; pass one")
        commit0 = state.commit.to(torch.int64).sum()
        key, pkey = prng.split(key, 2)
        if faultless and with_delay:
            inbox = _held_wins(spec, held, inbox)
            held = HeldSparse(idx=torch.full_like(held.idx, -1),
                              msgs=held.msgs.map(lambda _, x: torch.zeros_like(x)))
        c = Carry(state=state, inbox=inbox, held=held,
                  crash=crash if with_recovery else None, key=key, pkey=pkey,
                  period=torch.zeros((), dtype=torch.int64, device=dev), viol=viol,
                  prev_commit=state.commit.clone(), prop_len=prop_len,
                  prop_data=prop_data, probs=(drop_p, delay_p, partition_p),
                  knobs=knobs if with_recovery else (),
                  tele=tele if with_telemetry else None,
                  bb=bb if with_blackbox else None)
        run = step
        if dev.type == "cuda" and graph:
            if epoch.graph is None:
                epoch.graph = CapturedStep(step, pool=graph_pool)
            run = epoch.graph
        for r in range(rounds):
            if not faultless:
                c.period.fill_(r // partition_period)
            c = run(c)
        delta = wrap_int32(c.state.commit.to(torch.int64).sum() - commit0)
        return c.state, c.inbox, c.held, c.crash, c.key, c.viol, c.tele, c.bb, delta

    epoch.graph = None
    return epoch


def _quiet_inputs(spec: Spec, C: int, dev, tick: bool):
    """A chaos round's fixed round inputs: no proposed entry types, no
    read-index request, no hup, and every node ticking (``tick``)."""
    M = spec.M
    zp = torch.zeros((M, spec.E, C), dtype=torch.int32, device=dev)
    z2 = torch.zeros((M, C), dtype=torch.int32, device=dev)
    no = torch.zeros((M, C), dtype=torch.bool, device=dev)
    return zp, z2, no, torch.full((M, C), tick, dtype=torch.bool, device=dev)


def chaos_operands(spec: Spec, drop_p: float, delay_p: float, partition_p: float,
                   crash_p: float, crash: CrashConfig | None, member_p: float,
                   member: MemberChaosConfig, config_aware: bool, device):
    """The epochs' operands after ``viol`` as device tensors, as the JAX
    run_chaos passes them: (fault, heal), each the three network fault
    probabilities (0 for heal) and, with crash or membership faults, the
    knobs of ``KNOB_NAMES`` (crash_p and member_p 0 for heal)."""
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.tensor(x, dtype=dtype).to(dev)

    f32 = torch.float32
    z = t(0.0, f32)
    fault = (t(drop_p, f32), t(delay_p, f32), t(partition_p, f32))
    heal = (z, z, z)
    if crash_p <= 0 and member_p <= 0:
        return fault, heal
    palette = (member_palette(spec, member.mix, dev) if member_p > 0
               else torch.zeros((1,), dtype=torch.int32, device=dev))
    rest = (t(crash.down_rounds if crash_p > 0 else 1, torch.int32),
            t(crash.durability == "stable" if crash_p > 0 else True, torch.bool),
            t(config_aware, torch.bool))
    boosts = (t(member.snap_crash_boost, f32), t(member.member_crash_boost, f32))
    return ((*fault, t(crash_p, f32), *rest, t(member_p, f32), palette, *boosts),
            (*heal, z, *rest, z, palette, *boosts))


@in_eager_mode
def run_chaos(spec: Spec, cfg: RaftConfig, C: int, rounds: int = 200,
              epoch_len: int = 50, heal_len: int = 25, seed: int = 0,
              drop_p: float = 0.02, delay_p: float = 0.05,
              partition_p: float = 0.1, crash_p: float = 0.0,
              crash: CrashConfig | None = None, member_p: float = 0.0,
              member: MemberChaosConfig | None = None, config_aware: bool = True,
              propose: bool = True, sync_dispatch: bool = False,
              telemetry: bool = False, telemetry_buckets: int = DEFAULT_BUCKETS,
              telemetry_every: int = 1, blackbox: bool = False,
              blackbox_window: int = DEFAULT_WINDOW, blackbox_k: int = 4,
              device=None, end=None) -> dict:
    """The tester's round loop (tester/cluster_run.go): fault epochs and
    heal epochs in turn, then the WaitHealth loop, which heals in further
    epochs (at most 6) until every group has a leader. Returns the JAX
    run_chaos report (etcd_tpu/harness/chaos.py run_chaos).

    ``crash_p`` > 0 turns on crash-restart faults with the model ``crash``
    (default CrashConfig: 3-round outages, fsync-lag loss); ``member_p`` > 0
    turns on membership faults drawn from ``member.mix``'s palette, with
    ``member.initial_voters`` voters at boot; ``member``'s boosts target the
    crash budget at the snapshot-install and membership windows (boosts of
    1 are uniform); ``config_aware=False`` selects the config-blind
    recovery checkers.

    ``telemetry`` rides the telemetry plane (``telemetry_buckets`` pow2
    buckets) through every epoch: the report gains a ``timeline`` of
    flight-recorder rows (models/telemetry.py flight_record), one per epoch
    boundary, or per ``telemetry_every``-th boundary and the last, and a
    ``telemetry`` report (``{"wrapped": true, "rounds": N}`` if a counter
    wrapped). ``blackbox`` rides the event ring (``blackbox_window``
    rounds): the report gains a ``forensics`` section that decodes the
    rings of the first ``blackbox_k`` violating groups, found on the device.
    Neither changes a state or wire leaf.

    ``end``, a dict, receives the final state, inbox, held buffer,
    CrashState, key and plane carries (``tele``, ``bb``), and the epochs'
    CUDA graphs (``graphs``: on a CUDA device each round is one replay, see
    build_chaos_epoch). ``sync_dispatch`` waits for the card at every epoch
    boundary."""
    with_crash = crash_p > 0
    with_member = member_p > 0
    if (with_crash or with_member) and spec.M < 2:
        raise ValueError("crash faults require M >= 2 (fsync-lag model)")
    if with_member and not propose:
        raise ValueError("membership chaos requires propose=True")
    if with_member and cfg.wire_int16:
        raise ValueError(
            "membership chaos words exceed the int16 wire (conf-change "
            "bits 16-20); run with wire_int16=False")
    crash_cfg = (crash or CrashConfig()) if with_crash else None
    member_cfg = member or MemberChaosConfig()
    iv = member_cfg.initial_voters
    if iv > spec.M:
        raise ValueError(
            f"initial_voters={iv} exceeds the member count M={spec.M}")
    dev = resolve_device(device)
    M = spec.M
    voters = None if iv == 0 else torch.arange(M) < iv
    state = init_fleet(spec, C, voters=voters, election_tick=cfg.election_tick,
                       seed=seed, device=dev)
    inbox = empty_inbox(spec, C, wire_int16=cfg.wire_int16, device=dev)
    with_delay = delay_p > 0
    with_recovery = with_crash or with_member
    held = empty_held(spec, C, cfg.wire_int16, dev) if with_delay else None
    crash_state = empty_crash_state(state) if with_recovery else None
    key = prng.prng_key(seed, dev)
    prop_len = torch.zeros((M, C), dtype=torch.int32, device=dev)
    prop_data = torch.zeros((M, spec.E, C), dtype=torch.int32, device=dev)
    if propose:
        # one proposal per group per round at node 0, forwarded to the
        # leader wherever leadership lands
        prop_len[0] = 1
        prop_data[0, 0] = 7
    tele = init_telemetry(spec, state, buckets=telemetry_buckets) if telemetry else None
    if telemetry_every < 1:
        raise ValueError(f"telemetry_every must be >= 1, got {telemetry_every}")
    bb = empty_blackbox(spec, state, window=blackbox_window) if blackbox else None
    # the two epochs never run at once: their graphs share one memory pool
    pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
    kw = dict(with_delay=with_delay, with_crash=with_crash, with_member=with_member,
              with_telemetry=telemetry, with_blackbox=blackbox, graph_pool=pool)
    chaos = build_chaos_epoch(cfg, spec, epoch_len, False, **kw)
    heal = build_chaos_epoch(cfg, spec, heal_len, True, **kw)

    fault_ops, heal_ops = chaos_operands(spec, drop_p, delay_p, partition_p, crash_p,
                                         crash_cfg, member_p, member_cfg, config_aware,
                                         dev)

    def boundary():
        if sync_dispatch and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    viol = zero_violations(dev)
    commits = []
    timeline = []
    rec = {"i": 0, "pending": None}

    def record(kind):
        # the flight recorder's row at an epoch boundary (one small transfer,
        # read before the next epoch overwrites a graph's carry); a row that
        # telemetry_every skips leaves its kind, so the last is never lost
        if not telemetry:
            return
        i = rec["i"]
        rec["i"] = i + 1
        if i % telemetry_every:
            rec["pending"] = kind
            return
        rec["pending"] = None
        timeline.append(flight_record(
            tele, viol, crash_state.metrics if with_recovery else None, kind=kind))

    done = fault_rounds = 0
    while done < rounds:
        state, inbox, held, crash_state, key, viol, tele, bb, dc = chaos(
            state, inbox, held, crash_state, key, prop_len, prop_data, viol, tele, bb,
            *fault_ops)
        boundary()
        done += epoch_len
        fault_rounds += epoch_len
        record("fault")
        state, inbox, held, crash_state, key, viol, tele, bb, dh = heal(
            state, inbox, held, crash_state, key, prop_len, prop_data, viol, tele, bb,
            *heal_ops)
        boundary()
        done += heal_len
        record("heal")
        commits.append((int(dc), int(dh)))

    def leaders() -> int:
        return int(((state.role == ROLE_LEADER).sum(0) > 0).sum())

    for _ in range(6):
        if leaders() == C:
            break
        state, inbox, held, crash_state, key, viol, tele, bb, dh = heal(
            state, inbox, held, crash_state, key, prop_len, prop_data, viol, tele, bb,
            *heal_ops)
        done += heal_len
        record("heal")
        commits.append((0, int(dh)))
    if telemetry and rec["pending"]:
        # the run ended on a skipped boundary: its row comes last
        timeline.append(flight_record(
            tele, viol, crash_state.metrics if with_recovery else None,
            kind=rec["pending"]))
    if end is not None:
        end.update(state=state, inbox=inbox, held=held, crash=crash_state, key=key,
                   tele=tele, bb=bb,
                   graphs=[g for g in (chaos.graph, heal.graph) if g is not None])
    rep = {"groups": C, "rounds": done}
    rep.update({k: int(v) for k, v in viol.items()})
    rep.update({
        "groups_with_leader_after_heal": leaders(),
        "heal_commits_last_epoch": commits[-1][1],
        "epoch_commits": commits,
    })
    if with_crash:
        rep["crash_p"] = crash_p
        rep["crash_down_rounds"] = crash_cfg.down_rounds
        rep["crash_durability"] = crash_cfg.durability
        rep["snap_crash_boost"] = member_cfg.snap_crash_boost
        rep["member_crash_boost"] = member_cfg.member_crash_boost
    if with_member:
        rep["member_p"] = member_p
        rep["member_mix"] = member_cfg.mix
        rep["initial_voters"] = member_cfg.initial_voters
    if telemetry:
        try:
            rep["telemetry"] = telemetry_report(tele)
        except OverflowError:
            # a wrapped int32 counter (a very long soak at a very large C):
            # the run still reports; the timeline rows flag it as well
            rep["telemetry"] = {"wrapped": True, "rounds": int(tele.round)}
        rep["timeline"] = timeline
    if blackbox:
        rep["forensics"] = forensics_report(bb.ring, bb.viol_groups, bb.viol_round,
                                            k=blackbox_k)
    if with_recovery:
        rep["config_aware"] = config_aware
        rep.update(crash_metrics_report(crash_state.metrics))
        if with_crash:
            # the uniform-Bernoulli window baseline: the share of the
            # crash-sampled lanes that were in a window
            sampled = M * C * fault_rounds
            rep["snap_window_lane_frac"] = round(
                rep["snap_window_lanes"] / max(sampled, 1), 6)
            rep["member_window_lane_frac"] = round(
                rep["member_window_lanes"] / max(sampled, 1), 6)
    return rep


def summarize_chaos(rep: dict, *, rounds: int, epoch_len: int, heal_len: int,
                    liveness_frac: float = 0.2) -> dict:
    """The safety verdict, the tester's recovery bar and the fault-epoch
    liveness floor of a run_chaos report (etcd_tpu/harness/chaos.py
    summarize_chaos). WaitHealth epochs add (0, dh) rows that are not fault
    epochs, so the floor counts the fault rounds the budget asked for."""
    safe = all(rep.get(k, 0) == 0 for k in VIOLATION_KEYS)
    recovered = (rep["groups_with_leader_after_heal"] == rep["groups"]
                 and rep["heal_commits_last_epoch"] > 0)
    faulted = sum(dc for dc, _ in rep["epoch_commits"])
    faulted_rounds = -(-rounds // (epoch_len + heal_len)) * epoch_len
    floor = int(liveness_frac * rep["groups"] * faulted_rounds)
    return {
        "safe": safe,
        "recovered": recovered,
        "faulted_commits": faulted,
        "faulted_liveness_floor": floor,
        "lively": faulted >= floor,
    }
