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
(1). A knob the port does not implement (the apply benchmark, other ring,
window, inbox or wire forms, the profiler, --preflight) exits 2 unless it
is set to the one value the port runs, as bench.py exits 2 on a value it
cannot honour.
"""
from __future__ import annotations

import dataclasses
import json
import os
import resource
import sys
import time

import torch

from etcd_tpu_torch import drive
from etcd_tpu_torch.models.blackbox import init_blackbox
from etcd_tpu_torch.models.engine import (
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
from etcd_tpu_torch.types import Spec
from etcd_tpu_torch.utils.config import RaftConfig
from etcd_tpu_torch.utils.device import resolve_device
from etcd_tpu_torch.utils.knobs import env_bool, env_int, knob_error

PROG = "bench"
BASELINE_WRITES_PER_SEC = 10_000                      # bench.py:103
NORTH_STAR_GROUP_ROUNDS_PER_SEC = 1_000_000 * 10_000
METERED_ROUNDS = 8
PROBE_PASSES = 3

# knobs bench.py reads that the port runs at one value only: its
# accelerator default, or the feature off
FIXED_KNOBS = {
    "APPLY_MODE": "off", "BENCH_L": "16", "BENCH_W": "4", "BENCH_INBOX": "4",
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


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv:
        knob_error(PROG, f"unknown argument(s): {' '.join(argv)} (etcd_tpu_torch's "
                         "bench takes none, --preflight included; configure via "
                         "BENCH_* knobs)")
    res = run(read_knobs(), device)
    print(json.dumps(res.report), flush=True)
    if res.peaks:
        print(f"{PROG}: peak device memory {max(res.peaks.values())} B over the whole "
              f"run; by part {res.peaks} (torch.cuda.max_memory_allocated, reset "
              "between parts)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
