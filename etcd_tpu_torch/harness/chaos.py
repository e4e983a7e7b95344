"""The functional chaos tier's network faults (etcd_tpu/harness/chaos.py).

The reference's functional tester (tests/functional/tester/cluster.go:43-65)
loops inject -> stress -> recover -> check over a live cluster. Here the
loop runs on the device over a fleet of C groups:

  * drop faults: per-round Bernoulli keep-masks (the blackhole case);
  * partition faults: per-group bisections re-drawn every
    ``partition_period`` rounds, healed between epochs;
  * delay faults (rafttest/network.go:122-144): a message goes into a sparse
    held buffer with probability ``delay_p`` and arrives a round late,
    behind younger messages;
  * checkers every round, as reductions into violation counters: at most
    one leader per (group, term), equal applied index => equal applied
    hash, no commit index moves backwards.

The draws are the JAX program's threefry draws, bit for bit, so the port's
epoch equals the JAX epoch on every leaf. The rounds of an epoch make no
host sync; the host reads the counters at epoch boundaries only. The crash,
membership, telemetry and black-box tiers are not ported: asking for them
raises.
"""
from __future__ import annotations

import dataclasses

import torch

from etcd_tpu_torch.models.engine import build_round, empty_inbox, init_fleet
from etcd_tpu_torch.models.state import NodeState
from etcd_tpu_torch.types import ROLE_LEADER, Msg, Spec, TensorStruct, wrap_int32
from etcd_tpu_torch.parallel.mesh import CapturedStep
from etcd_tpu_torch.utils import prng
from etcd_tpu_torch.utils.config import RaftConfig
from etcd_tpu_torch.utils.device import resolve_device

VIOLATION_KEYS = (
    "multi_leader", "hash_mismatch", "commit_regress",
    "lost_commit", "log_divergence", "term_regress",
)

# delayed messages held per sender row (see HeldSparse)
HELD_SLOTS = 3

_UNPORTED_TIERS = ("with_crash", "with_member", "with_telemetry", "with_blackbox")


@dataclasses.dataclass
class Violations(TensorStruct):
    """Safety-violation counters, int32 0-dim tensors. The last three are
    the crash tier's and stay 0 in the network tier."""
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


def check_invariants(state: NodeState, prev_commit: torch.Tensor,
                     viol: Violations, exempt=None) -> Violations:
    """One round's checker pass over [M, C] leaves; ``exempt`` ([M, C]
    bool or None) leaves nodes out of the commit-monotonicity check."""
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
    return viol.replace(
        multi_leader=viol.multi_leader + _count(both_lead),
        hash_mismatch=viol.hash_mismatch + _count(hash_mm),
        commit_regress=viol.commit_regress + _count(regress),
    )


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
class Carry(TensorStruct):
    """What one chaos round reads and writes: the fleet, its inbox and held
    buffer, the fault key and the epoch's partition key, the partition
    period index, the counters and the previous round's commit indexes;
    and the round's fixed inputs (proposals and probabilities)."""
    state: NodeState
    inbox: Msg
    held: HeldSparse | None
    key: torch.Tensor          # int64 [2]
    pkey: torch.Tensor         # int64 [2]
    period: torch.Tensor       # int64 []
    viol: Violations
    prev_commit: torch.Tensor  # int32 [M, C]
    prop_len: torch.Tensor
    prop_data: torch.Tensor
    probs: tuple               # float32 [] drop, delay, partition


def build_chaos_epoch(cfg: RaftConfig, spec: Spec, rounds: int,
                      faultless: bool = False, partition_period: int = 25,
                      tick: bool = True, with_delay: bool = True,
                      with_crash: bool = False, with_member: bool = False,
                      with_telemetry: bool = False, with_blackbox: bool = False,
                      graph: bool = True, graph_pool=None):
    """One chaos epoch: ``rounds`` lockstep rounds of faulted traffic with
    the checks after every round (etcd_tpu/harness/chaos.py
    build_chaos_epoch, network tier).

    Returns fn(state, inbox, held, key, prop_len, prop_data, viol, drop_p,
    delay_p, partition_p) -> (state, inbox, held, key, viol,
    commits_delta). The probabilities are float32 0-dim tensors; ``held``
    is None without ``with_delay``. ``faultless`` is the heal program: it
    drains the held buffer into the entry inbox once (held wins a slot
    collision), then runs rounds without faults. Every epoch first splits
    the key into (key, partition key), as the JAX program does.

    On a CUDA device with ``graph`` the round is one CUDA graph
    (``fn.graph``, a parallel/mesh.py CapturedStep; ``graph_pool`` lets
    several epochs share one memory pool), captured at the first call and
    replayed once a round;
    the results are then the graph's carry, which the next call overwrites,
    so a caller that keeps them across calls clones them. Otherwise the
    rounds run eagerly, and under ``fleet_chunks`` > 1 they write into the
    state and inbox they are given, as the JAX program's donated carry
    does."""
    for name, on in zip(_UNPORTED_TIERS, (with_crash, with_member, with_telemetry,
                                          with_blackbox)):
        if on:
            raise NotImplementedError(f"etcd_tpu_torch's chaos epoch has no {name} yet")
    if cfg.packed_state or cfg.compact_wire:
        raise ValueError(
            "chaos epochs need the unpacked fleet and the dense wire; "
            "run with packed_state=False and compact_wire=False")
    round_fn = build_round(cfg, spec)
    M, K = spec.M, spec.K

    def fault_round(c: Carry) -> Carry:
        dev = c.key.device
        C = c.prev_commit.shape[-1]
        drop_p, delay_p, partition_p = c.probs
        # the rolling partition: drawn from the epoch's partition key folded
        # with the period index, so a cut holds for a period
        key, kd, kl = prng.split(c.key, 3)
        kp = prng.fold_in(c.pkey, c.period)
        side = prng.bernoulli(kp, 0.5, (M, C))
        parted = prng.bernoulli(prng.fold_in(kp, 1), partition_p, (C,))
        keep = ((side.unsqueeze(1) == side.unsqueeze(0)) | ~parted)
        keep = keep & prng.bernoulli(kd, 1.0 - drop_p, (M, M, C))
        state, out = round_fn(c.state, c.inbox, c.prop_len, c.prop_data,
                              *_quiet_inputs(spec, C, dev, tick), keep)
        held = c.held
        if with_delay:
            delay = prng.bernoulli(kl, delay_p, (M, K * M, C)) & (out.type != 0)
            out, held = _merge_delayed(spec, out, held, delay)
        viol = check_invariants(state, c.prev_commit, c.viol)
        return c.replace(state=state, inbox=out, held=held, key=key, viol=viol,
                         prev_commit=state.commit.clone())

    def heal_round(c: Carry) -> Carry:
        dev = c.key.device
        C = c.prev_commit.shape[-1]
        keep_all = torch.ones((M, M, C), dtype=torch.bool, device=dev)
        state, out = round_fn(c.state, c.inbox, c.prop_len, c.prop_data,
                              *_quiet_inputs(spec, C, dev, tick), keep_all)
        viol = check_invariants(state, c.prev_commit, c.viol)
        return c.replace(state=state, inbox=out, viol=viol,
                         prev_commit=state.commit.clone())

    step = heal_round if faultless else fault_round

    def epoch(state, inbox, held, key, prop_len, prop_data, viol, drop_p, delay_p,
              partition_p):
        dev = state.term.device
        commit0 = state.commit.to(torch.int64).sum()
        key, pkey = prng.split(key, 2)
        if faultless and with_delay:
            inbox = _held_wins(spec, held, inbox)
            held = HeldSparse(idx=torch.full_like(held.idx, -1),
                              msgs=held.msgs.map(lambda _, x: torch.zeros_like(x)))
        c = Carry(state=state, inbox=inbox, held=held, key=key, pkey=pkey,
                  period=torch.zeros((), dtype=torch.int64, device=dev), viol=viol,
                  prev_commit=state.commit.clone(), prop_len=prop_len,
                  prop_data=prop_data, probs=(drop_p, delay_p, partition_p))
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
        return c.state, c.inbox, c.held, c.key, c.viol, delta

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


def run_chaos(spec: Spec, cfg: RaftConfig, C: int, rounds: int = 200,
              epoch_len: int = 50, heal_len: int = 25, seed: int = 0,
              drop_p: float = 0.02, delay_p: float = 0.05,
              partition_p: float = 0.1, crash_p: float = 0.0,
              member_p: float = 0.0, propose: bool = True,
              sync_dispatch: bool = False, telemetry: bool = False,
              blackbox: bool = False, device=None, end=None) -> dict:
    """The tester's round loop (tester/cluster_run.go): fault epochs and
    heal epochs in turn, then the WaitHealth loop, which heals in further
    epochs (at most 6) until every group has a leader. Returns the JAX
    run_chaos report (the network tier's keys). ``end``, a dict, receives
    the final state, inbox, held buffer and key, and the epochs' CUDA graphs
    (``graphs``: on a CUDA device each round is one replay, see
    build_chaos_epoch).
    ``sync_dispatch`` waits for the card at every epoch boundary."""
    if crash_p > 0 or member_p > 0 or telemetry or blackbox:
        raise NotImplementedError(
            "etcd_tpu_torch's run_chaos has the network tier only: no crash, "
            "membership, telemetry or black-box tier yet")
    dev = resolve_device(device)
    M = spec.M
    state = init_fleet(spec, C, election_tick=cfg.election_tick, seed=seed, device=dev)
    inbox = empty_inbox(spec, C, wire_int16=cfg.wire_int16, device=dev)
    with_delay = delay_p > 0
    held = empty_held(spec, C, cfg.wire_int16, dev) if with_delay else None
    key = prng.prng_key(seed, dev)
    prop_len = torch.zeros((M, C), dtype=torch.int32, device=dev)
    prop_data = torch.zeros((M, spec.E, C), dtype=torch.int32, device=dev)
    if propose:
        # one proposal per group per round at node 0, forwarded to the
        # leader wherever leadership lands
        prop_len[0] = 1
        prop_data[0, 0] = 7
    # the two epochs never run at once: their graphs share one memory pool
    pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
    chaos = build_chaos_epoch(cfg, spec, epoch_len, False, with_delay=with_delay,
                              graph_pool=pool)
    heal = build_chaos_epoch(cfg, spec, heal_len, True, with_delay=with_delay,
                             graph_pool=pool)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32).to(dev)

    probs = (f32(drop_p), f32(delay_p), f32(partition_p))
    none = (f32(0.0),) * 3

    def boundary():
        if sync_dispatch and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    viol = zero_violations(dev)
    commits = []
    done = 0
    while done < rounds:
        state, inbox, held, key, viol, dc = chaos(state, inbox, held, key, prop_len,
                                                  prop_data, viol, *probs)
        boundary()
        done += epoch_len
        state, inbox, held, key, viol, dh = heal(state, inbox, held, key, prop_len,
                                                 prop_data, viol, *none)
        boundary()
        done += heal_len
        commits.append((int(dc), int(dh)))

    def leaders() -> int:
        return int(((state.role == ROLE_LEADER).sum(0) > 0).sum())

    for _ in range(6):
        if leaders() == C:
            break
        state, inbox, held, key, viol, dh = heal(state, inbox, held, key, prop_len,
                                                 prop_data, viol, *none)
        done += heal_len
        commits.append((0, int(dh)))
    if end is not None:
        end.update(state=state, inbox=inbox, held=held, key=key,
                   graphs=[g for g in (chaos.graph, heal.graph) if g is not None])
    rep = {"groups": C, "rounds": done}
    rep.update({k: int(v) for k, v in viol.items()})
    rep.update({
        "groups_with_leader_after_heal": leaders(),
        "heal_commits_last_epoch": commits[-1][1],
        "epoch_commits": commits,
    })
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
