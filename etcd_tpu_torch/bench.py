"""The consensus benchmark on the port: ``python -m etcd_tpu_torch.bench``.

The counterpart of bench.py's ``main`` for the steady consensus round, on
the CUDA card (or the CPU, where a caller passes ``device="cpu"``):

  1. settle: a fleet of C five-member groups elects member 0 everywhere
     with the full dense program (etcd_tpu_torch.drive.settle_leaders);
  2. the fleet is packed (``BENCH_PACKED``), and ``inner`` rounds of the
     steady program, with deferred emission and the sparse outbox, run as
     one CUDA graph (parallel/mesh.py build_scan_rounds): once to capture
     and warm, then ``reps`` timed replays; the best gives the rate;
  3. the commit advance is checked (bench.py:545-551), the fleet unpacked;
  4. the observability pass (bench.py:555-690), each probe timed as the
     best of 3 passes of 8 rounds of the dense program: the metered round
     (models/metrics.py) with the telemetry plane (TELEM=1), whose counters
     and latency histograms fill the report; the bare round; and the
     metered round with the telemetry plane and the black-box event ring
     (BENCH_BLACKBOX=1). telemetry_overhead_pct is (t_obs - t_bare) /
     t_bare and ring_overhead_pct (t_bb - t_obs) / t_bare, bench.py's
     formulas;
  5. one JSON line with bench.py's keys: the metric, its value and unit,
     the counters, the commit-latency percentiles, the overheads, the
     telemetry report and the bytes-per-group footprint.

The knobs are bench.py's, with its accelerator defaults: BENCH_C,
BENCH_ROUNDS, BENCH_REPS, BENCH_PACKED, BENCH_SPARSE, BENCH_DEFERRED,
BENCH_CHUNKS, TELEM (1), TELEM_BUCKETS (8, in 2..16) and BENCH_BLACKBOX
(1). A knob the port does not implement (other ring, window, inbox or wire
forms, the profiler, --preflight) exits 2 unless it is set to the one value
the port runs, as bench.py exits 2 on a value it cannot honour.

APPLY_MODE (off, device, host or both) switches to bench.py's end-to-end
served-writes benchmark (bench.py:11-35, 124-278): every round proposes one
canonical KV put per group, and a write counts once it is committed,
applied to an MVCC revision store and surfaced as a watch delta. In device
mode the apply plane rides the round (models/engine.py build_kv_round, one
CUDA graph a round, KVRound) and the per-round delta count is the host
handoff; in host mode the same round runs with the apply operand off and
each round's committed words replay through one WatchableStore per group;
both runs the two on the same schedule and compares the digests of 64
lanes. Its knobs: APPLY_C (262,144 on the card, 8,192 on the CPU),
APPLY_ROUNDS (32), APPLY_KEYS (64, in 1..511) and BENCH_CHUNKS (C //
131,072 on the card), all checked before any device work.
"""
from __future__ import annotations

import dataclasses
import json
import os
import resource
import sys
import time

import numpy as np
import torch

from etcd_tpu_torch import drive
from etcd_tpu_torch.device_mvcc import KVSpec, init_kv, kv_digest, scheme
from etcd_tpu_torch.models.blackbox import init_blackbox
from etcd_tpu_torch.models.engine import (
    KVRound,
    build_round,
    empty_inbox,
    inbox_bytes_per_group,
    init_fleet,
)
from etcd_tpu_torch.models.metrics import (
    build_metered_round,
    metrics_report,
    zero_metrics,
)
from etcd_tpu_torch.models.state import (
    pack_fleet,
    state_bytes_per_group,
    unpack_field,
    unpack_fleet,
)
from etcd_tpu_torch.models.telemetry import init_telemetry, telemetry_report
from etcd_tpu_torch.parallel.mesh import ScanRounds, build_scan_rounds
from etcd_tpu_torch.server.mvcc import MVCCStore
from etcd_tpu_torch.server.watch import WatchableStore
from etcd_tpu_torch.types import ROLE_LEADER, Spec
from etcd_tpu_torch.utils.config import RaftConfig
from etcd_tpu_torch.utils.device import resolve_device
from etcd_tpu_torch.utils.knobs import env_bool, env_int, env_str, knob_error

PROG = "bench"
BASELINE_WRITES_PER_SEC = 10_000                      # bench.py:103
NORTH_STAR_GROUP_ROUNDS_PER_SEC = 1_000_000 * 10_000
METERED_ROUNDS = 8
PROBE_PASSES = 3

# knobs bench.py reads that the port runs at one value only: its
# accelerator default, or the feature off
FIXED_KNOBS = {
    "BENCH_L": "16", "BENCH_W": "4", "BENCH_INBOX": "4",
    "BENCH_WIRE16": "1", "BENCH_CWIRE": "1", "BENCH_CC": "0", "BENCH_PROFILE": "0",
}


@dataclasses.dataclass(frozen=True)
class Knobs:
    C: int
    inner: int
    reps: int
    packed: bool
    sparse: bool
    deferred: bool
    chunks: int
    telem: bool
    telem_buckets: int
    blackbox: bool


def read_knobs(environ=None) -> Knobs:
    """The BENCH_* knobs from ``environ`` (default os.environ), validated
    with bench.py's exit-2 contract."""
    env = os.environ if environ is None else environ
    for name, value in FIXED_KNOBS.items():
        if name in env and env[name] != value:
            knob_error(PROG, f"{name}={env[name]!r}: etcd_tpu_torch runs only "
                             f"{name}={value}")
    C = env_int(PROG, "BENCH_C", "1048576", lo=1, environ=env)
    inner = env_int(PROG, "BENCH_ROUNDS", "16", lo=1, environ=env)
    reps = env_int(PROG, "BENCH_REPS", "3", lo=1, environ=env)
    packed = env_bool(PROG, "BENCH_PACKED", "1", environ=env)
    sparse = env_bool(PROG, "BENCH_SPARSE", "1", environ=env)
    chunks = env_int(PROG, "BENCH_CHUNKS", "1" if packed else str(max(1, C // 131072)),
                     lo=1, environ=env)
    deferred = env_bool(PROG, "BENCH_DEFERRED", "1", environ=env)
    if sparse and not deferred and "BENCH_SPARSE" in env:
        knob_error(PROG, "BENCH_SPARSE=1 needs BENCH_DEFERRED=1 (the sparse "
                         "scan carry is a deferred-emission form)")
    telem = env_bool(PROG, "TELEM", "1", environ=env)
    telem_buckets = env_int(PROG, "TELEM_BUCKETS", "8", lo=2, hi=16, environ=env)
    blackbox = env_bool(PROG, "BENCH_BLACKBOX", "1", environ=env)
    return Knobs(C, inner, reps, packed, sparse and deferred, deferred, chunks,
                 telem, telem_buckets, blackbox)


def configs(knobs: Knobs, spec: Spec) -> tuple[RaftConfig, RaftConfig]:
    """(settle and metered config, steady config), bench.py:385-430."""
    cfg = dataclasses.replace(drive.settle_config(spec), fleet_chunks=knobs.chunks)
    steady = dataclasses.replace(
        drive.steady_config(cfg), deferred_emit=knobs.deferred,
        sparse_outbox=knobs.sparse, packed_state=knobs.packed)
    return cfg, steady


@dataclasses.dataclass
class BenchRun:
    report: dict            # bench.py's JSON line
    scan: ScanRounds        # the timed driver (its captured launches, replays)
    settle_rounds: int
    timed_s: list           # each timed run of ``inner`` rounds, seconds
    state: object           # the dense fleet after the metered pass
    inbox: object
    peaks: dict = dataclasses.field(default_factory=dict)
    # on a CUDA device, torch.cuda.max_memory_allocated of each part of the
    # run (steady, metered, bare, ring), the peak reset before each part


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(knobs: Knobs, device=None) -> BenchRun:
    dev = resolve_device(device)
    spec = drive.bench_spec()
    cfg, steady = configs(knobs, spec)
    C = knobs.C

    state = init_fleet(spec, C, seed=0, election_tick=cfg.election_tick, device=dev)
    inbox = empty_inbox(spec, C, cfg.wire_int16, cfg.inbox_bound, device=dev)
    state, inbox, settle_rounds = drive.settle_leaders(cfg, spec, state, inbox, device=dev)

    args = drive.steady_inputs(spec, C, dev)
    scan = build_scan_rounds(steady, spec, None, rounds=knobs.inner)
    if knobs.packed:
        state = pack_fleet(spec, state)

    def fleet_commit(st):
        return unpack_field(spec, st, "commit") if knobs.packed else st.commit

    state, inbox = scan(state, inbox, *args)      # capture + warm
    _sync(dev)
    commit0 = int(fleet_commit(state).min())
    timed = []
    for _ in range(knobs.reps):
        t0 = time.perf_counter()
        state, inbox = scan(state, inbox, *args)
        _sync(dev)
        timed.append(time.perf_counter() - t0)
    best = min(timed)
    if dev.type == "cuda":
        live_bytes = torch.cuda.memory_allocated(dev)
    else:   # the carry itself: what stays resident between timed runs
        live_bytes = sum(x.numel() * x.element_size()
                         for s in (state, inbox) for _, x in s.items())
    rounds_per_sec = knobs.inner / best
    group_rounds_per_sec = C * rounds_per_sec

    if knobs.packed:
        state = unpack_fleet(spec, state)
    scan.release()
    drive.check_steady(state, commit0, knobs.inner * knobs.reps)

    peaks, current = {}, ["steady"]

    def part(name):
        """Close the current part's peak reading and open ``name``'s."""
        if dev.type == "cuda":
            _sync(dev)
            peaks[current[0]] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        current[0] = name

    # the observability pass (bench.py:555-690): each probe is the best of
    # PROBE_PASSES passes of METERED_ROUNDS rounds
    def timed_passes(fn):
        ts = []
        for _ in range(PROBE_PASSES):
            t0 = time.perf_counter()
            for _ in range(METERED_ROUNDS):
                fn()
            _sync(dev)
            ts.append(time.perf_counter() - t0)
        return ts

    part("metered")
    met_step = build_metered_round(cfg, spec, with_telemetry=knobs.telem)
    metrics = zero_metrics(dev)
    tele = init_telemetry(spec, state, knobs.telem_buckets) if knobs.telem else None

    def met_round():
        nonlocal state, inbox, metrics, tele
        if knobs.telem:
            state, inbox, metrics, tele = met_step(state, inbox, *args, metrics, tele)
        else:
            state, inbox, metrics = met_step(state, inbox, *args, metrics)

    met_round()                                                    # warm
    _sync(dev)
    # the counters cover the timed passes; the telemetry stays cumulative
    metrics = zero_metrics(dev)
    obs = timed_passes(met_round)
    t_obs = min(obs)
    rep = metrics_report(metrics, sum(obs), C, spec.M)
    extra = {}
    if knobs.telem or knobs.blackbox:
        part("bare")
        bare = build_round(cfg, spec)

        def bare_round():
            nonlocal state, inbox
            state, inbox = bare(state, inbox, *args)

        bare_round()                                               # warm
        t_bare = min(timed_passes(bare_round))
    if knobs.telem:
        trep = telemetry_report(tele)
        # the delta over the bare round covers the whole metered pass (the
        # counters and the plane), an upper bound on the plane's own cost
        extra = {
            "commit_latency_p50_rounds": trep["commit_latency_rounds"]["p50"],
            "commit_latency_p99_rounds": trep["commit_latency_rounds"]["p99"],
            "telemetry_overhead_pct": round((t_obs - t_bare) / t_bare * 100, 1),
            "telemetry": trep,
        }
    if knobs.blackbox:
        # the ring on top of what the metered pass ran: (t_bb - t_obs) is its
        # marginal cost, over the bare round like the telemetry probe's
        part("ring")
        bb_step = build_metered_round(cfg, spec, with_telemetry=knobs.telem,
                                      with_blackbox=True)
        bb = init_blackbox(spec, state)
        bmetrics = zero_metrics(dev)

        def bb_round():
            nonlocal state, inbox, bmetrics, tele, bb
            if knobs.telem:
                state, inbox, bmetrics, tele, bb = bb_step(state, inbox, *args,
                                                           bmetrics, tele, bb)
            else:
                state, inbox, bmetrics, bb = bb_step(state, inbox, *args, bmetrics, None,
                                                     bb)

        bb_round()                                                 # warm
        t_bb = min(timed_passes(bb_round))
        extra["ring_overhead_pct"] = round((t_bb - t_obs) / t_bare * 100, 1)
        del bb
    part("end")

    bound = cfg.inbox_bound
    st_b = state_bytes_per_group(spec, packed=knobs.packed)
    wi_b = inbox_bytes_per_group(spec, wire_int16=cfg.wire_int16, compact_bound=bound)
    st_dense = state_bytes_per_group(spec)
    wi_dense = inbox_bytes_per_group(spec, wire_int16=cfg.wire_int16)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    report = {
        "metric": "consensus_group_rounds_per_sec",
        "value": round(group_rounds_per_sec, 1),
        "unit": (f"group-rounds/s (device consensus incl. in-ring apply; "
                 f"reference writes/s adds host MVCC+fsync — see README) "
                 f"(C={C}, {dev.type} x{n_dev}, {rounds_per_sec:.1f} rounds/s; "
                 f"baseline = reference's 10k writes/s headline)"),
        "vs_baseline": round(group_rounds_per_sec / BASELINE_WRITES_PER_SEC, 2),
        "vs_north_star_1e10": round(
            group_rounds_per_sec / NORTH_STAR_GROUP_ROUNDS_PER_SEC, 6),
        "elections_won": rep["elections_won"],
        "leader_losses": rep["leader_losses"],
        "commits_per_group_per_round": rep["commits_per_group_per_round"],
        "commit_apply_lag_hist": rep["commit_apply_lag_hist"],
        "msgs_dropped": rep["msgs_dropped"],
        **extra,
        "bytes_per_group_state": st_b,
        "bytes_per_group_wire": wi_b,
        "bytes_per_group_total": st_b + wi_b,
        "bytes_per_group_dense_total": st_dense + wi_dense,
        "bytes_ratio_vs_dense": round((st_dense + wi_dense) / (st_b + wi_b), 2),
        "fleet_bytes_resident": (st_b + wi_b) * C,
        "live_bytes_after_timed_reps": live_bytes,
        "rss_peak_mb": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1),
        "packed_state": knobs.packed,
        "compact_wire": bool(cfg.compact_wire),
        "sparse_outbox": bool(steady.sparse_outbox),
        "fleet_chunks": knobs.chunks,
        "wire_int16": bool(cfg.wire_int16),
    }
    return BenchRun(report, scan, settle_rounds, timed, state, inbox, peaks)


APPLY_MODES = ("off", "device", "host", "both")
DRAIN_ROUNDS = 4        # commit lags 2 rounds behind the proposal (bench.py:191)
DIGEST_LANES = 64       # lanes whose digests the host replays (bench.py:229, 270)


@dataclasses.dataclass(frozen=True)
class ApplyKnobs:
    mode: str
    C: int
    rounds: int
    keys: int
    chunks: int


def read_apply_knobs(environ=None, on_card: bool = True) -> ApplyKnobs:
    """bench.py's APPLY_* knobs (bench.py:106-121) and the apply benchmark's
    BENCH_CHUNKS (bench.py:144-146), validated with the exit-2 contract."""
    env = os.environ if environ is None else environ
    mode = env_str(PROG, "APPLY_MODE", "off", APPLY_MODES, environ=env)
    C = env_int(PROG, "APPLY_C", "262144" if on_card else "8192", lo=1, environ=env)
    rounds = env_int(PROG, "APPLY_ROUNDS", "32", lo=1, environ=env)
    keys = env_int(PROG, "APPLY_KEYS", "64", lo=1, hi=scheme.MAX_KEYS, environ=env)
    chunks = env_int(PROG, "BENCH_CHUNKS", str(max(1, C // 131072)) if on_card else "1",
                     lo=1, environ=env)
    return ApplyKnobs(mode, C, rounds, keys, chunks)


def apply_config(spec: Spec, chunks: int) -> RaftConfig:
    """bench.py:147-151: bench.py's geometry on the int32 wire (KV words use
    bits 0-27), the inbox bound M-1 and ``chunks`` fleet chunks, with every
    local step, message class and entry class, as the reference runs it."""
    return RaftConfig(pre_vote=True, check_quorum=True, max_inflight=4,
                      inbox_bound=spec.M - 1, coalesce_commit_refresh=True,
                      wire_int16=False, fleet_chunks=chunks)


def proposal_words(knobs: ApplyKnobs) -> list:
    """One canonical put a round, every group: rotating keys, varying
    payloads (bench.py:165-168)."""
    return [scheme.encode_put(r % knobs.keys, (100 + r) & scheme.MAX_VAL,
                              r % (scheme.MAX_LEASE + 1)) for r in range(knobs.rounds)]


@dataclasses.dataclass
class ApplyMode:
    elapsed_s: float        # the timed rounds, host clock
    served: int             # watch events delivered
    digests: np.ndarray     # int32 kv_digest lanes (all C on the device, 64 on the host)
    settle_rounds: int
    settle_s: float         # the settle, the graph's warm-up and capture included
    first_round_s: float    # the settle's first round: on the card, in the first
    # mode run, the graph's eager warm-up round and its capture


@dataclasses.dataclass
class ApplyRun:
    report: dict            # bench.py's served-writes JSON line
    rnd: KVRound            # the round program (its graph's captures and replays)
    modes: dict             # "device" / "host" -> ApplyMode
    words: list             # the proposal schedule
    peaks: dict = dataclasses.field(default_factory=dict)


def apply_run(knobs: ApplyKnobs, device=None) -> ApplyRun:
    """bench.py's served-writes benchmark (bench.py:124-278) at ``knobs``."""
    dev = resolve_device(device)
    C, keys = knobs.C, knobs.keys
    kvspec = KVSpec(keys=keys)
    spec = drive.bench_spec()
    cfg = apply_config(spec, knobs.chunks)
    M, E = spec.M, spec.E
    rnd = KVRound(cfg, spec, kvspec, 0)

    def zeros(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    z2, zp = zeros((M, C)), zeros((M, E, C))
    no_hup = no_tick = zeros((M, C), torch.bool)
    hup = no_hup.clone()
    hup[0] = True
    keep = torch.ones((M, M, C), dtype=torch.bool, device=dev)
    pl = z2.clone()
    pl[0] = 1
    words = proposal_words(knobs)

    def fresh_fleet():
        state = init_fleet(spec, C, seed=0, election_tick=cfg.election_tick, device=dev)
        inbox = empty_inbox(spec, C, wire_int16=False, device=dev)
        kv = init_kv(kvspec, C, dev)
        off = zeros((C,), torch.bool)
        t0 = time.perf_counter()
        state, inbox, kv, _ = rnd(state, inbox, kv, off, z2, zp, zp, z2, hup, no_tick, keep)
        leaders = int((state.role == ROLE_LEADER).sum())
        first_s = time.perf_counter() - t0
        n = 1
        while leaders != C and n < 25:
            state, inbox, kv, _ = rnd(state, inbox, kv, off, z2, zp, zp, z2, no_hup,
                                      no_tick, keep)
            leaders = int((state.role == ROLE_LEADER).sum())
            n += 1
        if leaders != C:
            raise RuntimeError("fleet failed to elect")
        return state, inbox, kv, n, first_s

    def run_mode(on_device: bool) -> ApplyMode:
        """One timed pass. A write is served once its watch delta is visible
        past the device boundary: the per-round delta count on the device,
        the per-group watcher buffers on the host."""
        t0 = time.perf_counter()
        state, inbox, kv, settle_rounds, first_s = fresh_fleet()
        settle_s = time.perf_counter() - t0
        do_apply = torch.full((C,), on_device, dtype=torch.bool, device=dev)
        if not on_device:
            hosts = []
            for _ in range(C):
                ws = WatchableStore(MVCCStore())
                hosts.append((ws, ws.watch(scheme.key_bytes(0), b"\x00").id))
            cursors = [0] * C
        served = 0
        L = spec.L
        t0 = time.perf_counter()
        for r in range(knobs.rounds + DRAIN_ROUNDS):
            if r < knobs.rounds:
                pd = zp.clone()
                pd[0, 0] = words[r]
                props = (pl, pd)
            else:
                props = (z2, zp)
            state, inbox, kv, delta = rnd(state, inbox, kv, do_apply, *props, zp, z2,
                                          no_hup, no_tick, keep)
            if on_device:
                served += int(delta.mask.sum())     # the per-round handoff
                continue
            applied = state.applied[0].tolist()
            ld = state.log_data[0].cpu().numpy()
            for g in range(C):
                ws, wid = hosts[g]
                for idx in range(cursors[g] + 1, applied[g] + 1):
                    word = int(ld[(idx - 1) % L, g])
                    if word:
                        op = scheme.decode(word)
                        txn = ws.kv.write_txn()
                        txn.put(scheme.key_bytes(op["key"]),
                                scheme.encode_value(op["val"]), op["lease"])
                        txn.end()
                        ws.notify(txn.events)
                cursors[g] = applied[g]
                # drain per round: served = delivered to the consumer
                served += len(ws.take_events(wid))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
        if on_device:
            digs = kv_digest(kvspec, kv).cpu().numpy()
        else:
            digs = np.asarray([scheme.store_latest_digest(ws.kv, keys)
                               for ws, _ in hosts[:DIGEST_LANES]], np.int32)
        return ApplyMode(elapsed, served, digs, settle_rounds, settle_s, first_s)

    platform = "gpu" if dev.type == "cuda" else dev.type
    rep = {
        "metric": "served_writes_per_sec",
        "unit": ("committed+applied+watch-delta writes/s "
                 f"(C={C}, rounds={knobs.rounds}, keys={keys}, {platform}; "
                 "baseline = reference's 10k writes/s headline)"),
        "C": C, "rounds": knobs.rounds, "keys": keys, "platform": platform,
    }
    modes, peaks = {}, {}
    want = knobs.rounds * C
    for name in ("device", "host"):
        if knobs.mode not in (name, "both"):
            continue
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        m = modes[name] = run_mode(name == "device")
        if dev.type == "cuda":
            peaks[name] = torch.cuda.max_memory_allocated(dev)
        rep[f"{name}_writes_per_sec"] = round(want / m.elapsed_s, 1)
        rep[f"{name}_elapsed_s"] = round(m.elapsed_s, 3)
        rep[f"{name}_served_events"] = m.served
        rep[f"{name}_served_ok"] = m.served == want
    if knobs.mode == "both":
        n = min(DIGEST_LANES, C)
        rep["digests_match"] = bool((modes["device"].digests[:n]
                                     == modes["host"].digests[:n]).all())
        rep["digest_lanes_checked"] = n
        rep["device_vs_host_speedup"] = round(
            rep["device_writes_per_sec"] / rep["host_writes_per_sec"], 2)
        rep["vs_baseline"] = round(rep["device_writes_per_sec"] / BASELINE_WRITES_PER_SEC, 2)
    return ApplyRun(rep, rnd, modes, words, peaks)


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv:
        knob_error(PROG, f"unknown argument(s): {' '.join(argv)} (etcd_tpu_torch's "
                         "bench takes none, --preflight included; configure via "
                         "BENCH_* knobs)")
    # the APPLY_* knobs first, as bench.py:297-314
    on_card = device is None or torch.device(device).type == "cuda"
    apply_knobs = read_apply_knobs(on_card=on_card)
    if apply_knobs.mode != "off":
        res = apply_run(apply_knobs, device)
    else:
        res = run(read_knobs(), device)
    print(json.dumps(res.report), flush=True)
    if res.peaks:
        print(f"{PROG}: peak device memory {max(res.peaks.values())} B over the whole "
              f"run; by part {res.peaks} (torch.cuda.max_memory_allocated, reset "
              "between parts)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
