#!/usr/bin/env python3
"""Smoke run of the PyTorch port (etcd_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each printing its lines:
  0. the card (torch and nvidia-smi's name and power limit);
  1. the compaction kernel: built from etcd_tpu_torch/kernels/compact_wire.cu,
     launched on seeded random inputs (about 40% of slots nonempty) at the
     bench geometry (C = 1,048,576 groups, S = 10 sender slots, 5 receivers,
     bound 4, E = 1, plus an E = 2 case at C = 262,144) at its round-boundary
     site (compact_wire_carry, int16 wire), and at its in-round
     compact_inbox site (int32 output) on the same E = 1 input, each held
     bit for bit against its plain PyTorch version, with both times (mean of
     25 back-to-back launches, CUDA events) and the bound;
  2. the kernel inside the rounds at C = 64, card against CPU on every leaf:
     settle + 16 dense steady rounds; then bench.py's steady program
     (packed state, deferred emission, sparse outbox) for 16 rounds from
     the packed settled fleet; and on the card that program's CUDA graph
     (parallel/mesh.py build_scan_rounds), two replays of 16 rounds, against
     the same 32 rounds run eagerly; then chaos_run's program (harness/chaos.py
     run_chaos, 2 fleet chunks) for a fault epoch and a heal epoch of 10
     rounds, each round a replay of its CUDA graph on the card, against the
     CPU on the report and every leaf, with the compact_inbox launches
     counted (rounds x chunks);
  3. the dense eager path (immediate emission): init_fleet, settle_leaders and 16
     steady_rounds at C = 262,144 groups with the kernel launch count read
     around that run, the commit advance and hash-chain checks,
     group-rounds/s and peak memory (``--profile`` adds a device profile);
  4. the bench path at full width: etcd_tpu_torch.bench's run at its
     defaults (C = 1,048,576: settle, pack, 16 rounds x (1 + 3 timed) as one
     CUDA graph, the commit check, the metered pass), printing its JSON line,
     with the launches counted around it (the graph's recorded launches
     times its replays, plus the eager ones) and its peak memory;
  5. the same steady program run eagerly for comparison at full width, the
     compaction kernel timed on the outbox of its last round (the main
     path's own input) against its plain version and its bound, a device
     profile of two eager rounds (launches per round, device busy time,
     idle share, device time under named functions), and of one replay of
     a fresh graph of 16 rounds, with that graph's peak memory;
  6. the chaos path at full width: etcd_tpu_torch.chaos_run at
     CHAOS_C = 1,048,576, CHAOS_ROUNDS = 75 (a fault epoch of 50 rounds, a
     heal epoch of 25, and the WaitHealth heal epochs it needs) and its
     other defaults (drop 0.02, delay 0.05, partition 0.1, L = 16, bound 4,
     int16 wire, 8 fleet chunks), its JSON line and verdicts (safe,
     recovered, lively), wall time, launches and peak memory; then a device
     profile of 2 eager fault rounds on one chunk's 131,072 groups (device
     busy time, idle share, launches per round, device time under
     tick_timers, process_message, apply_round, the fault draws,
     _merge_delayed, check_invariants and the kernel); ``--profile`` adds
     one of the graph replay of 2 fault rounds at full width.
Then a line with the kernels' JSON record (the one kernel, once per site),
nvidia-smi's name and power limit,
and last {"ok": true, "device": {...}}. Any failure exits non-zero before the
last line. Needs a CUDA device; the port imports no JAX.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import subprocess
import sys
import time

FULL_GROUPS = 1_048_576
HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
# 32-bit integer issue rate: 64 integer lanes per SM x 132 SMs x 1.98 GHz
# (H100 SXM boost clock); the data sheet gives no integer rate outside the
# tensor cores
INT32_OPS_PER_S = 64 * 132 * 1.98e9
KERNEL_SOURCE = "etcd_tpu_torch/kernels/compact_wire.cu"
KERNEL_REPLACES = "experiments/pallas_compact.py:59"
# the JAX package's state_bytes_per_group(spec, packed=True) at bench.py's
# geometry (tests/test_torch_packed.py holds the port's equal to it)
JAX_PACKED_STATE_BYTES = 1230


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n=25, warmup=3):
    """Mean time of ``n`` back-to-back calls of ``fn`` on the current stream,
    ms, between two CUDA events: the host enqueues ahead of the card, so
    the wrapper's own host time stays out of the reading."""
    import torch

    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def random_outbox(spec, C, gen, dev):
    """Seeded random keep-masked outbox [from, K, to, (E,) C], ~40% of slots
    nonempty, values in int16 range."""
    import torch

    from etcd_tpu_torch.types import ENT_FIELDS, Msg

    M, K, E = spec.M, spec.K, spec.E
    leaves = {}
    for name in Msg.names():
        shape = (M, K, M) + ((E,) if name in ENT_FIELDS else ()) + (C,)
        if name == "reject":
            leaves[name] = torch.randint(0, 2, shape, generator=gen, device=dev).bool()
        elif name == "type":
            t = torch.randint(1, 18, shape, generator=gen, device=dev, dtype=torch.int32)
            live = torch.rand(shape, generator=gen, device=dev) < 0.4
            leaves[name] = torch.where(live, t, 0)
        else:
            leaves[name] = torch.randint(-32768, 32768, shape, generator=gen,
                                         device=dev, dtype=torch.int32)
    return Msg(**leaves)


def needed_bytes(spec, msgs, bound, out_itemsize):
    """Bytes the compaction must move for these inputs, at the card's 32 B
    sector: the whole type plane; of every other leaf, each sector (8 int32
    or 32 bool columns of one slot row) from which some column selects a
    slot; and the outputs."""
    import torch

    from etcd_tpu_torch.types import ENT_FIELDS

    M, K, E = spec.M, spec.K, spec.E
    S, C = M * K, msgs.type.shape[-1]
    B = min(bound, S)
    if C % 32:
        raise ValueError(f"needed_bytes counts 32-column sectors; C={C}")
    live = msgs.type.reshape(S, M, C) != 0
    sel = live & (torch.cumsum(live.to(torch.int32), 0) <= B)    # [S, to, C]
    sectors = {per: int(sel.view(S, M, C // per, per).any(-1).sum()) for per in (8, 32)}
    total = msgs.type.numel() * 4
    for name, x in msgs.items():
        e = E if name in ENT_FIELDS else 1
        out_item = 1 if name == "reject" else out_itemsize
        if name != "type":
            total += sectors[32 if name == "reject" else 8] * 32 * e
        total += B * M * C * e * out_item
    return total


# the kernel's two sites: LAUNCHES key, what it computes, output bytes
SITES = {
    "carry": ("compact_wire", "compact_wire_carry, int16 wire", 2),
    "inbox": ("compact_inbox", "compact_inbox, int32", 4),
}


def kernel_record(spec, msgs, bound, where, site="carry"):
    """Time the kernel at one of its sites and its plain version on
    ``msgs`` (the keep-masked outbox [from, K, to, (E,) C]; the inbox site
    reads it as the slots [S, to, (E,) C] a node batch is handed) with
    ``time_ms``, after holding them equal; the JSON record's fields with the
    bound computed from these inputs."""
    import torch

    from etcd_tpu_torch.kernels import compact_wire as cw

    name, what, out_bytes = SITES[site]
    if site == "carry":
        def run():
            return cw.compact_wire_carry(spec, msgs, bound, torch.int16)

        def plain():
            return cw.compact_wire_carry_plain(spec, msgs, bound, torch.int16)
    else:
        S = spec.M * spec.K
        flat = msgs.map(lambda _, x: x.view((S,) + x.shape[2:]))
        B = min(bound, S)

        def run():
            return cw.compact_inbox_slots(flat, B)

        def plain():
            return cw.compact_slots(flat, B)
    got, ref = run(), plain()
    torch.cuda.synchronize()
    bad = leaves_equal(got, ref)
    err = max_abs_err(got, ref)
    if bad or err:
        raise AssertionError(f"kernel != plain on {where} ({what}): {bad}, "
                             f"max abs err {err}")
    del got, ref
    ms = time_ms(run)
    plain_ms = time_ms(plain)
    C = msgs.type.shape[-1]
    nbytes = needed_bytes(spec, msgs, bound, out_bytes)
    S = spec.M * spec.K
    ops = spec.M * C * (2 * S + 17 * bound)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    record = {
        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "site": what, "launches": None,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }
    print(f"kernel ({what}) on {where} C={C}: == plain (max abs err {err}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {nbytes / 1e9:.4f} GB "
          f"needed at 32 B sectors -> {nbytes / ms / 1e6:.1f} GB/s, bound "
          f"{record['bound_ms']:.4f} ms ({record['bound_by']}), "
          f"{record['bound_ms'] / ms:.1%} of it", flush=True)
    return record


def leaves_equal(a, b):
    return [k for k, x in a.items()
            if x.dtype != getattr(b, k).dtype or not torch_equal(x, getattr(b, k))]


def max_abs_err(a, b) -> int:
    """Largest absolute difference over all leaves of two equal-shaped Msgs."""
    return max(int((x.long() - getattr(b, k).long()).abs().max()) for k, x in a.items())


def torch_equal(x, y):
    import torch

    return x.shape == y.shape and bool(torch.equal(x.cpu(), y.cpu()))


def phase_kernel():
    import torch

    from etcd_tpu_torch import drive
    from etcd_tpu_torch.kernels import compact_wire as cw
    from etcd_tpu_torch.types import Spec

    t0 = time.perf_counter()
    lib, log = cw.build()
    build_s = time.perf_counter() - t0
    regs = " ".join(l.strip() for l in log.splitlines() if "registers" in l or "spill" in l)
    print(f"phase 1 build: {lib.name} in {build_s:.1f}s; ptxas: {regs or 'cached'}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    spec = drive.bench_spec()
    bound = spec.M - 1
    err = 0
    inbox_record = None
    for E, C in ((1, FULL_GROUPS), (2, FULL_GROUPS // 4)):
        sp = Spec(M=spec.M, L=spec.L, E=E, K=spec.K, W=spec.W, R=spec.R, A=spec.A)
        msgs = random_outbox(sp, C, gen, dev)
        print("phase 1 ", end="")
        err = max(err, kernel_record(sp, msgs, bound, f"random outbox E={E}")["max_abs_err"])
        if E == 1:
            print("phase 1 ", end="")
            inbox_record = kernel_record(sp, msgs, bound, "random slots E=1", "inbox")
        del msgs
    return err, inbox_record


def run_slice(spec, C, device, steady_n=16):
    from etcd_tpu_torch import drive
    from etcd_tpu_torch.models.engine import empty_inbox, init_fleet

    cfg = drive.settle_config(spec)
    state = init_fleet(spec, C, device=device)
    inbox = empty_inbox(spec, C, cfg.wire_int16, cfg.inbox_bound, device=device)
    state, inbox, rounds = drive.settle_leaders(cfg, spec, state, inbox, device=device)
    commit0 = int(state.commit.min())
    state, inbox = drive.steady_rounds(drive.steady_config(cfg), spec, state, inbox,
                                       steady_n)
    adv = drive.check_steady(state, commit0, steady_n)
    return state, inbox, rounds, adv


def steady_program(spec):
    """etcd_tpu_torch.bench's (settle config, steady config) at its defaults."""
    from etcd_tpu_torch import bench

    return bench.configs(bench.read_knobs({}), spec)


def phase_round():
    import torch

    from etcd_tpu_torch import drive
    from etcd_tpu_torch.models.engine import empty_inbox, init_fleet
    from etcd_tpu_torch.models.state import pack_fleet
    from etcd_tpu_torch.parallel.mesh import build_scan_rounds

    spec = drive.bench_spec()
    gs, gi, r1, _ = run_slice(spec, 64, "cuda")
    cs, ci, r2, _ = run_slice(spec, 64, "cpu")
    bad = leaves_equal(gs, cs) + leaves_equal(gi, ci)
    if bad or r1 != r2:
        raise AssertionError(f"card run != CPU run at C=64: {bad}, rounds {r1} vs {r2}")
    torch.cuda.synchronize()
    print(f"phase 2 C=64: settle ({r1} rounds) + 16 steady rounds, card (kernel) == "
          "CPU (plain) on every state and wire leaf")

    cfg, steady = steady_program(spec)
    ends, settled = {}, {}
    for dev in ("cuda", "cpu"):
        st = init_fleet(spec, 64, device=dev)
        ib = empty_inbox(spec, 64, cfg.wire_int16, cfg.inbox_bound, device=dev)
        st, ib, _ = drive.settle_leaders(cfg, spec, st, ib, device=dev)
        settled[dev] = (pack_fleet(spec, st), ib)
        ends[dev] = drive.steady_rounds(steady, spec, *settled[dev], 16)
    bad = [k for a, b in zip(ends["cuda"], ends["cpu"]) for k in leaves_equal(a, b)]
    if bad:
        raise AssertionError(f"steady program: card != CPU at C=64: {bad}")
    print("phase 2 C=64: settle, pack + 16 packed/deferred/sparse steady rounds, "
          "card (kernel) == CPU (plain) on every packed state and wire leaf")

    args = drive.steady_inputs(spec, 64, "cuda")
    scan = build_scan_rounds(steady, spec, None, rounds=16)
    st, ib = scan(*settled["cuda"], *args)
    st, ib = scan(st, ib, *args)
    eager = drive.steady_rounds(steady, spec, *settled["cuda"], 32)
    torch.cuda.synchronize()
    bad = leaves_equal(st, eager[0]) + leaves_equal(ib, eager[1])
    if bad:
        raise AssertionError(f"CUDA graph replay != eager rounds at C=64: {bad}")
    print(f"phase 2 C=64: CUDA graph of 16 rounds ({sum(scan.captured.values())} "
          f"kernel launches recorded: {dict(scan.captured)}) replayed twice == "
          "32 eager rounds on every packed state and wire leaf")


def graph_launches(counted, graphs):
    """The launches a run really made: ``counted`` (kernels.LAUNCHES read
    around it) counts a launch recorded into a CUDA graph once, at capture,
    where it does not run; each replay runs it once."""
    real = collections.Counter(counted)
    for g in graphs:
        for k, v in g.captured.items():
            real[k] += v * (g.replays - 1)
    return dict(real)


def phase_chaos_small(C=64, chunks=2):
    """chaos_run's program at C = ``C`` in ``chunks`` fleet chunks: one fault
    epoch and one heal epoch of 10 rounds (plus the WaitHealth epochs it
    needs), card (each round a replay of its CUDA graph) against CPU on the
    report and every leaf of the state, the inbox, the held buffer and the
    key; on the card the kernel runs at the compact_inbox site once per
    round and chunk."""
    import torch

    from etcd_tpu_torch import chaos_run
    from etcd_tpu_torch.harness.chaos import run_chaos
    from etcd_tpu_torch.kernels import LAUNCHES, reset_launches

    k = chaos_run.read_knobs({"CHAOS_C": str(C), "CHAOS_CHUNKS": str(chunks)})
    spec, cfg = chaos_run.spec_and_config(k)
    reps, ends, launches = {}, {}, {}
    for dev in ("cuda", "cpu"):
        reset_launches()
        ends[dev] = {}
        reps[dev] = run_chaos(spec, cfg, C=C, rounds=20, epoch_len=10, heal_len=10,
                              seed=k["seed"], drop_p=k["drop_p"], delay_p=k["delay_p"],
                              partition_p=k["partition_p"], device=dev, end=ends[dev])
        launches[dev] = graph_launches(LAUNCHES, ends[dev]["graphs"])
    torch.cuda.synchronize()
    if reps["cuda"] != reps["cpu"]:
        raise AssertionError(f"chaos report: card {reps['cuda']} != CPU {reps['cpu']}")
    a, b = ends["cuda"], ends["cpu"]
    bad = (leaves_equal(a["state"], b["state"]) + leaves_equal(a["inbox"], b["inbox"])
           + leaves_equal(a["held"].msgs, b["held"].msgs)
           + ([] if torch_equal(a["held"].idx, b["held"].idx) else ["held.idx"])
           + ([] if torch_equal(a["key"], b["key"]) else ["key"]))
    if bad:
        raise AssertionError(f"chaos run at C={C}: card != CPU on {bad}")
    rounds = reps["cuda"]["rounds"]
    graphs = a["graphs"]
    replayed = sum(g.captured["compact_inbox"] * g.replays for g in graphs)
    warm = len(graphs) * chunks
    if replayed != rounds * chunks or launches["cuda"].get("compact_inbox") != \
            rounds * chunks + warm or launches["cpu"]:
        raise AssertionError(f"compact_inbox launches {launches} over {rounds} rounds "
                             f"x {chunks} chunks (+ {warm} in the graphs' warm-up "
                             f"rounds), {replayed} replayed")
    print(f"phase 2 chaos C={C} in {chunks} chunks: {rounds} rounds as replays of "
          f"{len(graphs)} CUDA graphs, card (kernel at compact_inbox: rounds x chunks "
          f"= {replayed} launches replayed, plus {warm} in the graphs' eager warm-up "
          f"rounds) == CPU (plain) on the report and every state, inbox and "
          f"held-buffer leaf: {json.dumps(reps['cuda'])}", flush=True)


def phase_full(card, profile=False, groups=FULL_GROUPS // 4):
    """The dense eager path (cut from C = 1,048,576 to 262,144 groups to
    keep the script's time for the chaos path)."""
    import torch

    from etcd_tpu_torch import drive
    from etcd_tpu_torch.kernels import LAUNCHES, reset_launches
    from etcd_tpu_torch.models.engine import empty_inbox, init_fleet

    spec = drive.bench_spec()
    cfg = drive.settle_config(spec)
    steady_n = 16
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_fleet(spec, groups)
    inbox = empty_inbox(spec, groups, cfg.wire_int16, cfg.inbox_bound)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0

    reset_launches()
    t0 = time.perf_counter()
    state, inbox, rounds = drive.settle_leaders(cfg, spec, state, inbox)
    torch.cuda.synchronize()
    t_settle = time.perf_counter() - t0
    commit0 = int(state.commit.min())
    t0 = time.perf_counter()
    state, inbox = drive.steady_rounds(drive.steady_config(cfg), spec, state, inbox,
                                       steady_n)
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    adv = drive.check_steady(state, commit0, steady_n)
    if launches.get("compact_wire", 0) != rounds + 1 + steady_n:
        raise AssertionError(f"compact_wire launched {launches} times in "
                             f"{rounds + 1 + steady_n} rounds")
    peak = torch.cuda.max_memory_allocated()
    rate = groups * steady_n / t_steady
    print(f"phase 3 C={groups} on {card}: init {t_init:.2f}s, settle {rounds}+1 rounds "
          f"{t_settle:.2f}s, {steady_n} steady rounds {t_steady:.3f}s = "
          f"{rate:.1f} group-rounds/s, commit advance {adv}, "
          f"peak memory {peak / 2**30:.2f} GiB, launches {launches}")
    if profile:
        steady = drive.steady_config(cfg)
        profile_rounds("phase 3 profile", lambda: drive.steady_rounds(
            steady, spec, state, inbox, 2), 2, card)
    return launches


def free_card():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_bench(card):
    """etcd_tpu_torch.bench's main path at its defaults, with the launches
    made on it: the eager ones, plus the graph's recorded launches once per
    replay (``kernels.LAUNCHES`` counts a recorded launch once, at capture,
    where it does not run)."""
    import torch

    from etcd_tpu_torch import bench
    from etcd_tpu_torch.kernels import LAUNCHES, reset_launches

    knobs = bench.read_knobs({})
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = bench.run(knobs, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scan = res.scan
    launches = graph_launches(LAUNCHES, [scan])
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps(res.report))
    rep = res.report
    per_round = {k: v / knobs.inner for k, v in scan.captured.items()}
    print(f"phase 4 bench C={knobs.C} on {card}: {wall:.1f}s in all, settle "
          f"{res.settle_rounds}+1 rounds, CUDA graph of {knobs.inner} rounds x "
          f"{scan.replays} replays (timed {', '.join(f'{t:.4f}' for t in res.timed_s)} s), "
          f"{rep['value']} group-rounds/s, peak memory {peak / 2**30:.2f} GiB, "
          f"launches {launches}, recorded per graph round {per_round}", flush=True)
    if per_round.get("compact_wire") != 1:
        raise AssertionError(f"the graph holds {dict(scan.captured)} launches for "
                             f"{knobs.inner} rounds; compact_wire must be once a round")
    slack = 1 - 4 / (knobs.inner * knobs.reps)
    if not rep["commits_per_group_per_round"] >= slack:
        raise AssertionError(f"metered commits_per_group_per_round "
                             f"{rep['commits_per_group_per_round']} < {slack}")
    if rep["bytes_per_group_state"] != JAX_PACKED_STATE_BYTES:
        raise AssertionError(f"bytes_per_group_state {rep['bytes_per_group_state']} "
                             f"!= the JAX package's {JAX_PACKED_STATE_BYTES}")
    return res, launches


def phase_compare(res, card, rounds=16):
    """The bench's steady program run eagerly on its fleet, the kernel timed
    on the outbox of its last round, and device profiles of two eager
    rounds and one replay of a fresh graph of ``rounds`` rounds."""
    import torch

    from etcd_tpu_torch import drive
    from etcd_tpu_torch.models import engine
    from etcd_tpu_torch.models.state import pack_fleet
    from etcd_tpu_torch.parallel.mesh import build_scan_rounds

    spec = drive.bench_spec()
    _, steady = steady_program(spec)
    C = res.inbox.type.shape[-1]
    state, inbox = pack_fleet(spec, res.state), res.inbox
    res.state = res.inbox = None
    free_card()
    state, inbox = drive.steady_rounds(steady, spec, state, inbox, 1)    # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, inbox = drive.steady_rounds(steady, spec, state, inbox, rounds - 1)
    seen = {}
    real = engine.compact_wire_carry

    def recording(sp, msgs, bound, out_dtype=torch.int32):
        seen.update(spec=sp, msgs=msgs, bound=bound)
        return real(sp, msgs, bound, out_dtype)

    engine.compact_wire_carry = recording
    try:
        state, inbox = drive.steady_rounds(steady, spec, state, inbox, 1)
    finally:
        engine.compact_wire_carry = real
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    print(f"phase 5 eager steady program C={C} on {card}: {rounds} rounds {t:.3f}s = "
          f"{C * rounds / t:.1f} group-rounds/s (graph: {res.report['value']})", flush=True)
    print("phase 5 ", end="")
    record = kernel_record(seen["spec"], seen["msgs"], seen["bound"],
                           "the steady program's outbox")
    del seen
    profile_rounds("phase 5 profile eager", lambda: drive.steady_rounds(
        steady, spec, state, inbox, 2), 2, card)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    args = drive.steady_inputs(spec, C, "cuda")
    scan = build_scan_rounds(steady, spec, None, rounds=rounds)
    out = scan(state, inbox, *args)                                      # capture
    torch.cuda.synchronize()
    print(f"phase 5 graph of {rounds} rounds: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({base / 2**30:.2f} GiB "
          f"held before it: the packed fleet and its wire)", flush=True)
    profile_rounds("phase 5 profile graph", lambda: scan(*out, *args), rounds, card)
    scan.release()
    return record


CHAOS_ROUNDS = 75      # one fault epoch of 50 and one heal epoch of 25
PROFILED_CHAOS = (("etcd_tpu_torch.models.raft", "tick_timers"),
                  ("etcd_tpu_torch.models.raft", "process_message"),
                  ("etcd_tpu_torch.models.raft", "apply_round"),
                  ("etcd_tpu_torch.utils.prng", "bernoulli"),
                  ("etcd_tpu_torch.harness.chaos", "_merge_delayed"),
                  ("etcd_tpu_torch.harness.chaos", "check_invariants"),
                  ("etcd_tpu_torch.models.raft", "compact_inbox_slots"),
                  ("etcd_tpu_torch.utils.prng", "threefry2x32"))


def phase_chaos_full(card, profile=False):
    """The chaos path at full width: etcd_tpu_torch.chaos_run at
    CHAOS_C = 1,048,576 and CHAOS_ROUNDS = 75 with its other defaults (each
    round a replay of its CUDA graph), the launches read around it, its JSON
    line and verdicts, wall time and peak memory; then a device profile of 2
    fault rounds eager on one chunk's 131,072 groups of its end state, for
    the device time under the named functions; with ``profile`` first one
    of the graph's replay of 2 fault rounds at full width (device busy time,
    idle share, launches: about a million kernels, minutes of the
    profiler's own processing)."""
    import torch

    from etcd_tpu_torch import chaos_run
    from etcd_tpu_torch.harness.chaos import build_chaos_epoch, zero_violations
    from etcd_tpu_torch.kernels import LAUNCHES, reset_launches

    k = chaos_run.read_knobs({"CHAOS_C": str(FULL_GROUPS),
                              "CHAOS_ROUNDS": str(CHAOS_ROUNDS)})
    spec, cfg = chaos_run.spec_and_config(k)
    torch.cuda.reset_peak_memory_stats()
    end = {}
    reset_launches()
    t0 = time.perf_counter()
    rep = chaos_run.run(k, "cuda", end=end)
    wall = time.perf_counter() - t0
    graphs = end.pop("graphs")
    launches = graph_launches(LAUNCHES, graphs)
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps(rep), flush=True)
    rounds = rep["rounds"]
    print(f"phase 6 chaos_run C={rep['groups']} on {card}: {rounds} rounds in "
          f"{wall:.1f}s = {wall * 1e3 / rounds:.1f} ms/round wall (the graphs' "
          f"capture included), {rep['groups'] * rounds / wall:.1f} group-rounds/s, "
          f"fleet_chunks {cfg.fleet_chunks}, peak memory {peak / 2**30:.2f} GiB, "
          f"launches {launches}, graph replays {[g.replays for g in graphs]} of "
          f"{[sum(g.captured.values()) for g in graphs]} recorded kernel-wrapper "
          f"launches", flush=True)
    bad = [key for key in ("multi_leader", "hash_mismatch", "commit_regress") if rep[key]]
    bad += [key for key in ("safe", "recovered", "lively") if not rep[key]]
    if bad or rep["groups"] != FULL_GROUPS:
        raise AssertionError(f"chaos_run at C={FULL_GROUPS}: {bad}")
    replayed = sum(g.captured["compact_inbox"] * g.replays for g in graphs)
    if replayed != rounds * cfg.fleet_chunks:
        raise AssertionError(f"compact_inbox launched {launches} times, {replayed} in "
                             f"replays; {rounds} rounds x {cfg.fleet_chunks} chunks")
    del graphs

    dev = torch.device("cuda")
    probs = [torch.tensor(k[p], dtype=torch.float32).to(dev)
             for p in ("drop_p", "delay_p", "partition_p")]
    carry = [end.pop(n) for n in ("state", "inbox", "held", "key")]

    def proposals(C):
        prop_len = torch.zeros((spec.M, C), dtype=torch.int32, device=dev)
        prop_data = torch.zeros((spec.M, spec.E, C), dtype=torch.int32, device=dev)
        prop_len[0] = 1
        prop_data[0, 0] = 7
        return prop_len, prop_data

    def epoch_runner(epoch, state, inbox, held, key):
        C = state.term.shape[-1]
        pl, pd = proposals(C)
        c = [state, inbox, held, key]

        def run():
            c[:] = epoch(*c, pl, pd, zero_violations(dev), *probs)[:4]
        return run

    free_card()
    if profile:
        full = epoch_runner(build_chaos_epoch(cfg, spec, 2), *carry)
        full()                                     # capture and warm
        profile_rounds("phase 6 profile of 2 fault rounds (graph replay, "
                       "C=1,048,576)", full, 2, card)
        del full
    # one chunk's worth of groups, eager, for the named functions' device time
    csz = FULL_GROUPS // cfg.fleet_chunks
    def cut(_, t):
        return t[..., :csz].contiguous()

    state, inbox, held, key = carry
    part = [state.map(cut), inbox.map(cut),
            type(held)(idx=cut(None, held.idx), msgs=held.msgs.map(cut)), key]
    del carry, state, inbox, held
    free_card()
    one = dataclasses.replace(cfg, fleet_chunks=1)
    eager = epoch_runner(build_chaos_epoch(one, spec, 2, graph=False), *part)
    eager()                                        # warm
    profile_rounds(f"phase 6 profile of 2 fault rounds (eager, one chunk, C={csz})",
                   eager, 2, card, PROFILED_CHAOS)
    free_card()
    return launches, rep


# functions whose device time the profile reports as named ranges
PROFILED = (("etcd_tpu_torch.models.raft", "process_message"),
            ("etcd_tpu_torch.utils.prng", "threefry2x32"),
            ("etcd_tpu_torch.models.raft", "apply_round"),
            ("etcd_tpu_torch.models.raft", "_flush_deferred"),
            ("etcd_tpu_torch.models.engine", "unpack_fleet"),
            ("etcd_tpu_torch.models.engine", "pack_fleet"),
            ("etcd_tpu_torch.models.engine", "compact_wire_carry"))


def profile_rounds(label, fn, rounds, card, profiled=PROFILED):
    """Where the time of ``fn`` (``rounds`` rounds) goes: device busy time
    against wall time, kernel launches per round, the device time under a
    few named functions (process_message includes the threefry draws; a
    graph replay calls none of them), and the kernels that take most."""
    import importlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name, f):
        def call(*a, **k):
            with record_function(name):
                return f(*a, **k)
        return call

    saved = []
    for mod_name, fn_name in profiled:
        mod = importlib.import_module(mod_name)
        saved.append((mod, fn_name, getattr(mod, fn_name)))
        setattr(mod, fn_name, ranged(fn_name, getattr(mod, fn_name)))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for mod, fn_name, f in saved:
            setattr(mod, fn_name, f)
    events = prof.key_averages()
    ranges = {n for _, n in profiled}
    # the named ranges show on the device timeline as spans from their
    # first to their last kernel; only kernels count as busy time
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.key not in ranges]
    busy_us = sum(e.self_device_time_total for e in kernels)
    count = sum(e.count for e in kernels)
    if not count:
        print(f"{label}: wall {wall * 1e3 / rounds:.2f} ms/round; the profiler saw no "
              "kernels: device busy time and idle share not measured")
        return
    print(f"{label} {rounds} rounds on {card}: wall {wall * 1e3 / rounds:.2f} ms/round, "
          f"device busy {busy_us / 1e3 / rounds:.2f} ms/round "
          f"(idle share {1 - busy_us / 1e6 / wall:.3f}), "
          f"{count / rounds:.0f} kernel launches/round", flush=True)
    spans = {e.key: e for e in events
             if e.key in ranges and e.device_type == DeviceType.CUDA}
    if spans:
        print(f"{label} device span ms/round of: " + ", ".join(
            f"{n} {spans[n].device_time_total / 1e3 / rounds:.2f} "
            f"({spans[n].count / rounds:g}x)" for _, n in profiled if n in spans))
    # the kernels launched under each range (its CPU-side event's device
    # time): device busy time, where a span also holds the gaps between
    calls = {e.key: e for e in events
             if e.key in ranges and e.device_type == DeviceType.CPU}
    if calls:
        print(f"{label} device busy ms/round under: " + ", ".join(
            f"{n} {calls[n].device_time_total / 1e3 / rounds:.2f}"
            for _, n in profiled if n in calls))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"{label}   {e.self_device_time_total / 1e3 / rounds:9.3f} ms/round "
              f"{e.count / rounds:8.1f}x  {e.key[:140]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile two steady rounds of phase 3 and the "
                    "full-width graph replay of two chaos fault rounds (phase 6)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import etcd_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"phase 0 device: {name} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()

    def done(n):
        print(f"phase {n} done at {time.perf_counter() - t0:.1f}s", flush=True)

    err, inbox_record = phase_kernel()
    done(1)
    phase_round()
    phase_chaos_small()
    done(2)
    phase_full(smi, args.profile)
    free_card()
    done(3)
    res, launches = phase_bench(smi)
    done(4)
    record = phase_compare(res, smi)
    del res
    free_card()
    done(5)
    record["launches"] = launches.get("compact_wire", 0)
    record["max_abs_err"] = max(err, record["max_abs_err"])
    if not record["launches"]:
        raise AssertionError("the bench path launched no compact_wire kernel")
    chaos_launches, _ = phase_chaos_full(smi, args.profile)
    inbox_record["launches"] = chaos_launches.get("compact_inbox", 0)
    if not inbox_record["launches"]:
        raise AssertionError(f"the chaos path launched {chaos_launches}")
    print(f"all phases in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": [record, inbox_record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
