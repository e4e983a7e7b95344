#!/usr/bin/env python3
"""Smoke run of the PyTorch port (etcd_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile] [--phases 1,2,...]

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
     the same 32 rounds run eagerly; the dense metered round (bench.py's
     observability pass) with the telemetry plane and the black-box ring, 8
     rounds, card against CPU on the counters and every plane leaf, its
     state and wire equal to the planes-off round's; then chaos_run's
     programs (harness/chaos.py run_chaos, 2 fleet chunks on the card, the
     telemetry plane on as chaos_run's default TELEM=1) for the network
     tier, the crash tier, the persist-nothing crash tier (which must trip
     lost_commit; with CHAOS_BLACKBOX=1, so its forensics section is not
     empty) and the membership and crash tiers (int32 wire), each round a
     replay of its CUDA graph on the card, against the CPU (worker
     processes, one chunk) on the report (telemetry, timeline, forensics)
     and every state, wire and plane leaf, with the compact_inbox launches
     counted (rounds x chunks);
  3. the dense eager path (immediate emission): init_fleet, settle_leaders and 16
     steady_rounds at C = 262,144 groups with the kernel launch count read
     around that run, the commit advance and hash-chain checks,
     group-rounds/s and peak memory (``--profile`` adds a device profile);
  4. the bench path at full width: etcd_tpu_torch.bench's run at its
     defaults (C = 1,048,576: settle, pack, 16 rounds x (1 + 3 timed) as one
     CUDA graph, the commit check, the observability pass with TELEM=1 and
     BENCH_BLACKBOX=1: the metered, bare and ring probes), printing its JSON
     line, with the launches counted around it (the graph's recorded
     launches times its replays, plus the eager ones: the planes add none),
     its peak memory by part, telemetry_overhead_pct (at most 10, bench.py's
     bar) and the ring probe's peak (at most 1.5 GiB above the metered
     pass's);
  5. the same steady program run eagerly for comparison on 131,072 groups of
     that fleet, the compaction kernel timed on the outbox of its last round
     (the main path's own input) against its plain version and its bound, a
     device profile of two eager rounds (launches per round, device busy
     time, idle share, device time under named functions), and of one replay
     of a fresh graph of 16 rounds, with that graph's peak memory;
  6. the chaos path: etcd_tpu_torch.chaos_run's network tier at
     CHAOS_C = 262,144, CHAOS_ROUNDS = 75 (a fault epoch of 50 rounds, a
     heal epoch of 25, and the WaitHealth heal epochs it needs) and its
     other defaults (drop 0.02, delay 0.05, partition 0.1, L = 16, bound 4,
     int16 wire, TELEM=1), its JSON line and verdicts (safe, recovered,
     lively), its flight-recorder timeline (monotone per counter, none
     wrapped), wall time, launches and peak memory; then a device profile of
     2 eager fault rounds with both planes (device busy time, idle share,
     launches per round, device time under tick_timers, process_message,
     apply_round, the fault draws, _merge_delayed, check_invariants, the
     kernel, telemetry_update, blackbox_update and msg_activity);
     ``--profile`` adds one of the graph replay of 2 fault rounds;
  7a. the crash tier at its documented size: CHAOS_C = 262,144,
     CHAOS_CRASH = 0.01, 75 rounds, with TELEM=1 and CHAOS_BLACKBOX=1 (a safe
     run: forensics finds no group), its JSON line, verdicts, timeline, crash
     counters, wall time, launches and peak memory, and the kernel timed on
     the compact_inbox input of an eager fault round;
  7b. the membership and crash tiers (CHAOS_MEMBER = 0.05, CHAOS_CRASH =
     0.005, CHAOS_SNAP_BOOST = 200, CHAOS_MEMBER_BOOST = 4, int32 wire) at
     C = 262,144 in 2 chunks, one fault and one heal epoch of 25 rounds, the
     same lines plus the membership counters, the kernel timed on an inbox
     carrying conf-change words, and a device profile of 2 eager fault
     rounds on one chunk (pre_round, crash_restart_fleet,
     check_recovery_invariants, inject_member); then the same knobs at
     C = 65,536 for 75 rounds with TELEM=0, the report held key for key to
     the reference's committed one (CHAOS_MEMBER_65K_PIN.json, which holds
     no plane keys).
Then a line with the kernels' JSON record (the one kernel: at its carry
site, and at compact_inbox on the network, crash and membership paths),
nvidia-smi's name and power limit, and last {"ok": true, "device": {...}}.
Any failure exits non-zero before the last line. A chaos path's verdicts
(safe, recovered, lively) are all required; one that is false is printed
at once and fails the run after the kernels' line, so that every phase
still prints its measurements. The one exception is phase 7b's
`recovered`, and only while the 65,536-group report equals the
reference's: the reference itself leaves groups without a leader under
this mix (ROADMAP.md section 3), so there the port is held to the
reference's report, not to recovery. ``--phases`` runs a subset
(phase 5 needs 4), without those last lines. Needs a CUDA device; the port
imports no JAX.
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
    phase_metered_planes(spec, cfg, settled)


def phase_metered_planes(spec, cfg, settled, rounds=8):
    """The dense metered round with both planes from the settled fleet, card
    against CPU on the state, wire, counters and every plane leaf, and
    against the planes-off metered round on the state and wire; the planes
    add no launch of the kernel."""
    import torch

    from etcd_tpu_torch import drive
    from etcd_tpu_torch.kernels import LAUNCHES
    from etcd_tpu_torch.models.blackbox import init_blackbox
    from etcd_tpu_torch.models.metrics import build_metered_round, zero_metrics
    from etcd_tpu_torch.models.state import unpack_fleet
    from etcd_tpu_torch.models.telemetry import init_telemetry

    both = build_metered_round(cfg, spec, with_telemetry=True, with_blackbox=True)
    bare = build_metered_round(cfg, spec)
    ends = {}
    for dev in ("cuda", "cpu"):
        packed, ib = settled[dev]
        st = unpack_fleet(spec, packed)
        args = drive.steady_inputs(spec, 64, dev)
        on = [st, ib, zero_metrics(dev), init_telemetry(spec, st), init_blackbox(spec, st)]
        off = [st.map(lambda _, x: x.clone()), ib.map(lambda _, x: x.clone()),
               zero_metrics(dev)]
        before = LAUNCHES["compact_wire"]
        for _ in range(rounds):
            on = list(both(on[0], on[1], *args, *on[2:]))
        planes = LAUNCHES["compact_wire"] - before
        for _ in range(rounds):
            off = list(bare(off[0], off[1], *args, off[2]))
        if dev == "cuda":
            torch.cuda.synchronize()
        bad = [d for n, a, b in zip(("state", "inbox", "metrics"), on, off)
               for d in tree_diff(a, b, n)]
        if bad or (dev == "cuda" and planes != rounds):
            raise AssertionError(f"metered round on {dev}: planes on != off on {bad}, "
                                 f"or {planes} kernel launches in {rounds} rounds")
        ends[dev] = on
    bad = [d for n, a, b in zip(("state", "inbox", "metrics", "tele", "ring"),
                                ends["cuda"], ends["cpu"]) for d in tree_diff(a, b, n)]
    if bad:
        raise AssertionError(f"metered round with both planes: card != CPU on {bad}")
    tele, ring = ends["cuda"][3], ends["cuda"][4]
    print(f"phase 2 C=64: {rounds} dense metered rounds with the telemetry plane and "
          f"the black-box ring, card == CPU on the counters and every plane leaf "
          f"({int(tele.commit_hist[-1])} commit-latency samples, "
          f"{int((ring.ring != 0).sum())} nonzero event words), state and wire == the "
          f"planes-off round's, {rounds} kernel launches (the planes add none)",
          flush=True)


def graph_launches(counted, graphs):
    """The launches a run really made: ``counted`` (kernels.LAUNCHES read
    around it) counts a launch recorded into a CUDA graph once, at capture,
    where it does not run; each replay runs it once."""
    real = collections.Counter(counted)
    for g in graphs:
        for k, v in g.captured.items():
            real[k] += v * (g.replays - 1)
    return dict(real)


def tree_diff(a, b, name: str) -> list:
    """The leaves (by path) where two equal-structured tensor dataclasses,
    nested or None, differ in dtype, shape or value."""
    import torch

    if a is None or b is None:
        return [] if a is b else [name]
    if isinstance(a, torch.Tensor):
        return [] if a.dtype == b.dtype and torch_equal(a, b) else [name]
    return [d for k, v in a.items() for d in tree_diff(v, getattr(b, k), f"{name}.{k}")]


# phase 2's chaos runs at C = 64 in 2 fleet chunks: name, chaos_run knobs,
# rounds, fault epoch, heal epoch
SMALL_CHAOS = (
    ("network", {}, 20, 10, 10),
    ("crash", {"CHAOS_CRASH": "0.02"}, 20, 10, 10),
    # the broken persist-nothing model on the JAX test's mix
    # (tests/test_recovery_crash.py:65); it must trip the checker
    ("persist-nothing", {"CHAOS_CRASH": "0.12", "CHAOS_DOWN": "2",
                         "CHAOS_DURABILITY": "none", "CHAOS_DROP": "0",
                         "CHAOS_PART": "0", "CHAOS_DELAY": "0.08",
                         "CHAOS_BLACKBOX": "1"}, 25, 25, 10),
    ("member+crash", {"CHAOS_MEMBER": "0.05", "CHAOS_CRASH": "0.005",
                      "CHAOS_SNAP_BOOST": "200", "CHAOS_MEMBER_BOOST": "4"}, 20, 10, 10),
)


def small_chaos_run(env, rounds, epoch_len, heal_len, C, chunks, dev):
    """One of SMALL_CHAOS on ``dev``: (report, end dict without the graphs,
    kernel launches, CUDA graphs). The CPU runs the fleet in one chunk: its
    eager rounds cost per operation, and chunks compute the same values."""
    import torch

    from etcd_tpu_torch import chaos_run
    from etcd_tpu_torch.harness.chaos import run_chaos
    from etcd_tpu_torch.kernels import LAUNCHES, reset_launches

    if dev == "cpu":
        torch.set_num_threads(2)
    k = chaos_run.read_knobs({"CHAOS_C": str(C), "CHAOS_CHUNKS": str(chunks), **env})
    spec, cfg = chaos_run.spec_and_config(k)
    if dev == "cpu":
        cfg = dataclasses.replace(cfg, fleet_chunks=1)
    reset_launches()
    end = {}
    rep = run_chaos(spec, cfg, C=C, rounds=rounds, epoch_len=epoch_len,
                    heal_len=heal_len, device=dev, end=end, **chaos_run.fault_kwargs(k))
    graphs = end.pop("graphs")
    launches = graph_launches(LAUNCHES, graphs)
    return rep, end, launches, graphs


def _cpu_small_chaos_run(*args):
    """small_chaos_run on the CPU in a worker process (its result pickled)."""
    rep, end, launches, _ = small_chaos_run(*args, "cpu")
    return rep, end, launches


def phase_chaos_small(C=64, chunks=2):
    """chaos_run's programs at C = ``C``, each of SMALL_CHAOS: the card in
    ``chunks`` fleet chunks (each round a replay of its CUDA graph) against
    the CPU in one chunk, on the report and every leaf of the state, the
    inbox, the held buffer, the CrashState and the key; on the card the
    kernel runs at the compact_inbox site once per round and chunk. The CPU
    runs go side by side in worker processes while the card runs."""
    import concurrent.futures
    import multiprocessing

    import torch

    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(SMALL_CHAOS), mp_context=ctx) as pool:
        cpu = [pool.submit(_cpu_small_chaos_run, env, rounds, epoch_len, heal_len, C,
                           chunks)
               for _, env, rounds, epoch_len, heal_len in SMALL_CHAOS]
        for (name, env, rounds, epoch_len, heal_len), fut in zip(SMALL_CHAOS, cpu):
            rep, a, launches, graphs = small_chaos_run(env, rounds, epoch_len, heal_len,
                                                       C, chunks, "cuda")
            torch.cuda.synchronize()
            cpu_rep, b, cpu_launches = fut.result()
            if rep != cpu_rep:
                raise AssertionError(f"chaos {name}: card {rep} != CPU {cpu_rep}")
            bad = [d for leaf in ("state", "inbox", "held", "crash", "key", "tele", "bb")
                   for d in tree_diff(a[leaf], b[leaf], leaf)]
            if bad:
                raise AssertionError(f"chaos {name} at C={C}: card != CPU on {bad}")
            done = rep["rounds"]
            replayed = sum(g.captured["compact_inbox"] * g.replays for g in graphs)
            warm = len(graphs) * chunks
            if replayed != done * chunks or launches.get("compact_inbox") != \
                    done * chunks + warm or cpu_launches:
                raise AssertionError(f"compact_inbox launches {launches} (CPU "
                                     f"{cpu_launches}) over {done} rounds x {chunks} "
                                     f"chunks (+ {warm} in the graphs' warm-up rounds), "
                                     f"{replayed} replayed")
            if name == "persist-nothing" and not (
                    rep["lost_commit"] > 0 and rep["forensics"]["captured"]):
                raise AssertionError(f"persist-nothing run did not trip lost_commit, or "
                                     f"its forensics are empty: {rep}")
            bad = timeline_faults(rep)
            if bad:
                raise AssertionError(f"chaos {name}: timeline {bad}")
            wire = "int32" if "CHAOS_MEMBER" in env else "int16"
            print(f"phase 2 chaos {name} C={C} in {chunks} chunks ({wire} wire, "
                  f"{time.perf_counter() - t0:.1f}s): {done} rounds as replays of "
                  f"{len(graphs)} CUDA graphs, card (kernel at compact_inbox: rounds x "
                  f"chunks = {replayed} launches replayed, plus {warm} in the graphs' "
                  f"eager warm-up rounds) == CPU (plain, one chunk) on the report and "
                  f"every state, inbox, held-buffer, CrashState, telemetry and ring "
                  f"leaf: {json.dumps(rep)}", flush=True)


TIMELINE_COUNTERS = ("round", "commit_sum", "elect_sum", "heal_sum", "leader_changes",
                     "snapshot_installs", "heal_rounds")


def timeline_faults(rep) -> list:
    """What is wrong with a report's flight-recorder timeline: a missing one
    or telemetry report, a wrapped row, or a counter (a histogram bucket, a
    violation or crash counter among them) that moves down between rows."""
    rows = rep.get("timeline")
    if not rows or "telemetry" not in rep:
        return ["no timeline or telemetry report"]
    bad = [f"row {i} wrapped" for i, r in enumerate(rows) if r["wrapped"]]

    def counters(r):
        out = {k: r[k] for k in TIMELINE_COUNTERS}
        for h in ("commit_hist", "elect_hist", "heal_hist"):
            out.update({f"{h}[{i}]": v for i, v in enumerate(r[h])})
        out.update({f"violations.{k}": v for k, v in r["violations"].items()})
        out.update({k: r[k] for k in ("crashes_injected", "restarts_completed") if k in r})
        return out

    for i, (a, b) in enumerate(zip(rows, rows[1:])):
        ca, cb = counters(a), counters(b)
        bad += [f"{k} falls from row {i} to {i + 1}" for k in ca if cb[k] < ca[k]]
    return bad


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
    reset_launches()
    t0 = time.perf_counter()
    res = bench.run(knobs, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scan = res.scan
    launches = graph_launches(LAUNCHES, [scan])
    print(json.dumps(res.report))
    rep = res.report
    per_round = {k: v / knobs.inner for k, v in scan.captured.items()}
    peaks = {k: round(v / 2**30, 3) for k, v in res.peaks.items()}
    print(f"phase 4 bench C={knobs.C} on {card}: {wall:.1f}s in all, settle "
          f"{res.settle_rounds}+1 rounds, CUDA graph of {knobs.inner} rounds x "
          f"{scan.replays} replays (timed {', '.join(f'{t:.4f}' for t in res.timed_s)} s), "
          f"{rep['value']} group-rounds/s, peak memory {max(peaks.values()):.2f} GiB "
          f"(GiB by part, the peak reset between parts: {peaks}), "
          f"launches {launches}, recorded per graph round {per_round}", flush=True)
    print(f"phase 4 planes (TELEM=1, BENCH_BLACKBOX=1): commit latency p50 "
          f"{rep['commit_latency_p50_rounds']} p99 {rep['commit_latency_p99_rounds']} "
          f"rounds, telemetry_overhead_pct {rep['telemetry_overhead_pct']}, "
          f"ring_overhead_pct {rep['ring_overhead_pct']}, ring probe peak "
          f"{peaks['ring']} GiB against the metered pass's {peaks['metered']} GiB",
          flush=True)
    if per_round.get("compact_wire") != 1:
        raise AssertionError(f"the graph holds {dict(scan.captured)} launches for "
                             f"{knobs.inner} rounds; compact_wire must be once a round")
    # settle (its rounds + 1), the graph's eager warm-up round and its
    # replays, and the three probes' 1 + 3 x 8 metered, bare and ring rounds:
    # the planes launch no compaction of their own
    probes = 3 * (1 + bench.PROBE_PASSES * bench.METERED_ROUNDS)
    want = res.settle_rounds + 1 + 1 + knobs.inner * scan.replays + probes
    if launches.get("compact_wire") != want:
        raise AssertionError(f"compact_wire launched {launches} times on the bench "
                             f"path; {want} rounds ran")
    if not rep["telemetry_overhead_pct"] <= 10:
        raise AssertionError(f"telemetry_overhead_pct {rep['telemetry_overhead_pct']} "
                             "> 10, bench.py's bar for the plane")
    if not res.peaks["ring"] - res.peaks["metered"] <= 1.5 * 2**30:
        raise AssertionError(f"the ring probe's peak is {res.peaks['ring']} B, more "
                             f"than 1.5 GiB above the metered pass's "
                             f"{res.peaks['metered']} B")
    slack = 1 - 4 / (knobs.inner * knobs.reps)
    if not rep["commits_per_group_per_round"] >= slack:
        raise AssertionError(f"metered commits_per_group_per_round "
                             f"{rep['commits_per_group_per_round']} < {slack}")
    if rep["bytes_per_group_state"] != JAX_PACKED_STATE_BYTES:
        raise AssertionError(f"bytes_per_group_state {rep['bytes_per_group_state']} "
                             f"!= the JAX package's {JAX_PACKED_STATE_BYTES}")
    return res, launches


def phase_compare(res, card, rounds=16, groups=FULL_GROUPS // 8):
    """The bench's steady program run eagerly on the first ``groups`` groups
    of its fleet (cut from C = 1,048,576 to 131,072 to keep the script's
    time for the chaos paths), the kernel timed on the outbox of its last
    round, and device profiles of two eager rounds and one replay of a
    fresh graph of ``rounds`` rounds."""
    import torch

    from etcd_tpu_torch import drive
    from etcd_tpu_torch.models import engine
    from etcd_tpu_torch.models.state import pack_fleet
    from etcd_tpu_torch.parallel.mesh import build_scan_rounds

    spec = drive.bench_spec()
    _, steady = steady_program(spec)
    C = groups
    state, inbox = pack_fleet(spec, cut_groups(res.state, C)), cut_groups(res.inbox, C)
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
                  ("etcd_tpu_torch.utils.prng", "threefry2x32"),
                  ("etcd_tpu_torch.harness.chaos", "telemetry_update"),
                  ("etcd_tpu_torch.harness.chaos", "blackbox_update"),
                  ("etcd_tpu_torch.harness.chaos", "msg_activity"),
                  ("etcd_tpu_torch.models.blackbox", "msg_activity"))
PROFILED_MEMBER = (("etcd_tpu_torch.harness.chaos", "pre_round"),
                   ("etcd_tpu_torch.harness.chaos", "crash_restart_fleet"),
                   ("etcd_tpu_torch.harness.chaos", "check_recovery_invariants"),
                   ("etcd_tpu_torch.harness.chaos", "inject_member"),
                   ("etcd_tpu_torch.models.raft", "process_message"),
                   ("etcd_tpu_torch.models.raft", "compact_inbox_slots"),
                   ("etcd_tpu_torch.utils.prng", "threefry2x32"))

# the chaos paths: phase -> (chaos_run knobs, report keys the phase's line
# prints)
CHAOS_PATHS = {
    # cut from C = 1,048,576 to keep the script's time for phase 7b
    "6": ({"CHAOS_C": str(FULL_GROUPS // 4)}, ()),
    # chaos_run.py's docstring and tests/test_recovery_crash.py:219
    "7a": ({"CHAOS_C": str(FULL_GROUPS // 4), "CHAOS_CRASH": "0.01",
            "CHAOS_BLACKBOX": "1"},
           ("crashes_injected", "entries_lost_fsync", "restarts_completed",
            "lost_commit", "snap_window_hit_rate")),
    # the membership tier's acceptance mix (tests/test_recovery_member.py:359),
    # cut from C = 1,048,576 to 262,144 groups (in 131,072-group chunks, the
    # chunk chaos_run.py takes at full width), and (in main) to one fault and
    # one heal epoch of 25 rounds, to fit the script's time limit
    "7b": ({"CHAOS_C": str(FULL_GROUPS // 4), "CHAOS_CHUNKS": "2", "CHAOS_MEMBER": "0.05",
            "CHAOS_CRASH": "0.005", "CHAOS_SNAP_BOOST": "200", "CHAOS_MEMBER_BOOST": "4"},
           ("crashes_injected", "entries_lost_fsync", "conf_changes_applied",
            "joint_entered", "joint_left", "cc_guard_refusals", "cc_guard_admits",
            "member_changes_proposed", "snap_window_hit_rate", "member_window_hit_rate",
            "snap_window_lane_frac", "member_window_lane_frac")),
}


# the membership tier at the largest size the reference has run (on the
# CPU), and where its report is kept; that report holds no plane keys, so
# the run keeps the telemetry plane off
MEMBER_PIN = ({"CHAOS_C": "65536", "CHAOS_ROUNDS": "75", "CHAOS_MEMBER": "0.05",
               "CHAOS_CRASH": "0.005", "CHAOS_SNAP_BOOST": "200", "CHAOS_MEMBER_BOOST": "4",
               "TELEM": "0"},
              "CHAOS_MEMBER_65K_PIN.json")
# report keys the pin does not compare: the host and its clock
UNPINNED = ("elapsed_s", "platform")


def phase_member_pin(card):
    """The membership tier at MEMBER_PIN's knobs through
    etcd_tpu_torch.chaos_run on the card, its report held equal to the
    reference's committed one on every key (less UNPINNED). Returns the
    failures."""
    import os

    from etcd_tpu_torch import chaos_run

    env, name = MEMBER_PIN
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), name)) as f:
        ref = json.load(f)["reference"]["report"]
    free_card()
    t0 = time.perf_counter()
    # through JSON, as the reference's was kept: its pairs become lists
    rep = json.loads(json.dumps(chaos_run.run(chaos_run.read_knobs(env), "cuda")))
    wall = time.perf_counter() - t0
    free_card()
    print(json.dumps(rep), flush=True)
    keys = sorted((set(rep) | set(ref)) - set(UNPINNED))
    differ = [x for x in keys if rep.get(x) != ref.get(x)]
    print(f"phase 7b pin: chaos_run C={rep['groups']} on {card}: {rep['rounds']} rounds in "
          f"{wall:.1f}s; against {name}: {len(keys)} keys, "
          f"{'equal' if not differ else f'differ on {differ}'}; safe {rep['safe']}, "
          f"recovered {rep['recovered']} ({rep['groups_with_leader_after_heal']} of "
          f"{rep['groups']} groups with a leader), lively {rep['lively']}", flush=True)
    return [f"phase 7b pin: differs from {name} on {differ}"] if differ else []


def cut_groups(x, csz):
    """The first ``csz`` groups of a fleet tree (tensor dataclasses, nested,
    or None), as contiguous copies; 0-dim counters are copied whole."""
    import torch

    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x[..., :csz].contiguous() if x.dim() else x.clone()
    return x.map(lambda _, v: cut_groups(v, csz))


def epoch_runner(epoch, spec, carry, ops):
    """fn() running ``epoch`` on ``carry`` = [state, inbox, held, crash, key,
    tele, bb] with node 0 proposing in every group, writing the results back
    into ``carry``."""
    import torch

    from etcd_tpu_torch.harness.chaos import zero_violations

    dev = carry[0].term.device
    C = carry[0].term.shape[-1]
    prop_len = torch.zeros((spec.M, C), dtype=torch.int32, device=dev)
    prop_data = torch.zeros((spec.M, spec.E, C), dtype=torch.int32, device=dev)
    prop_len[0] = 1
    prop_data[0, 0] = 7

    def run():
        out = epoch(*carry[:5], prop_len, prop_data, zero_violations(dev), *carry[5:], *ops)
        carry[:] = out[:5] + out[6:8]
    return run


def phase_chaos_path(card, phase, rounds=CHAOS_ROUNDS, lens=None, profiled=None,
                     full_profile=False, time_kernel=False):
    """One chaos path, CHAOS_PATHS[phase]:
    etcd_tpu_torch.chaos_run for ``rounds`` rounds (each a replay of its
    CUDA graph; fault and heal epochs of chaos_run's 50 and 25 rounds, or of
    ``lens``) with the launches read around it, its JSON line, its
    verdicts (safe, recovered, lively: all required), wall time and peak
    memory. Then, on one chunk of its end state, eagerly: with
    ``time_kernel`` one fault round whose compact_inbox input is kept, and
    the kernel timed on it against its plain version; with ``profiled`` a
    device profile of 2 fault rounds with those named functions; with
    ``full_profile`` first a profile of the graph replay of 2 fault rounds
    at full width (about a million kernels, minutes of the profiler's own
    processing). Returns (launches, report, kernel record or None, the
    failed verdicts)."""
    import torch

    from etcd_tpu_torch import chaos_run
    from etcd_tpu_torch.harness.chaos import (build_chaos_epoch, chaos_operands,
                                              empty_blackbox, run_chaos, summarize_chaos)
    from etcd_tpu_torch.kernels import LAUNCHES, reset_launches
    from etcd_tpu_torch.models import raft
    from etcd_tpu_torch.models.telemetry import init_telemetry
    from etcd_tpu_torch.types import ENTRY_CONF_CHANGE

    env, extra = CHAOS_PATHS[phase]
    k = chaos_run.read_knobs({**env, "CHAOS_ROUNDS": str(rounds)})
    spec, cfg = chaos_run.spec_and_config(k)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    end = {}
    reset_launches()
    t0 = time.perf_counter()
    if lens is None:
        rep = chaos_run.run(k, "cuda", end=end)
    else:
        # a cut of chaos_run's epochs: run_chaos with the driver's knobs, and
        # the driver's verdicts over the cut epochs
        rep = run_chaos(spec, cfg, C=k["C"], rounds=rounds, epoch_len=lens[0],
                        heal_len=lens[1], sync_dispatch=k["sync"], device="cuda",
                        end=end, **chaos_run.fault_kwargs(k))
        rep.update(summarize_chaos(rep, rounds=rounds, epoch_len=lens[0],
                                   heal_len=lens[1], liveness_frac=k["liveness_frac"]))
    wall = time.perf_counter() - t0
    graphs = end.pop("graphs")
    launches = graph_launches(LAUNCHES, graphs)
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps(rep), flush=True)
    done = rep["rounds"]
    wire = "int16" if cfg.wire_int16 else "int32"
    print(f"phase {phase} chaos_run C={rep['groups']} ({wire} wire) on {card}: {done} "
          f"rounds in {wall:.1f}s = {wall * 1e3 / done:.1f} ms/round wall (the graphs' "
          f"capture included), {rep['groups'] * done / wall:.1f} group-rounds/s, "
          f"fleet_chunks {cfg.fleet_chunks}, peak memory {peak / 2**30:.2f} GiB, "
          f"launches {launches}, graph replays {[g.replays for g in graphs]} of "
          f"{[sum(g.captured.values()) for g in graphs]} recorded kernel-wrapper "
          f"launches; verdicts safe {rep['safe']}, recovered {rep['recovered']}, lively "
          f"{rep['lively']} (faulted commits {rep['faulted_commits']} against the floor "
          f"{rep['faulted_liveness_floor']})" + "".join(
              f", {key} {rep[key]}" for key in extra), flush=True)
    replayed = sum(g.captured["compact_inbox"] * g.replays for g in graphs)
    if replayed != done * cfg.fleet_chunks:
        raise AssertionError(f"compact_inbox launched {launches} times, {replayed} in "
                             f"replays; {done} rounds x {cfg.fleet_chunks} chunks")
    del graphs
    # the verdicts are required; the measurements below print first
    bad = [key for key in ("safe", "recovered", "lively") if not rep[key]]
    if rep["groups"] != k["C"]:
        bad.append(f"groups {rep['groups']}")
    if k["telemetry"]:
        faults = timeline_faults(rep)
        t = rep["telemetry"]
        print(f"phase {phase} planes: {len(rep['timeline'])} timeline rows, "
              f"{'monotone and unwrapped' if not faults else faults}; commit latency "
              f"p50 {t['commit_latency_rounds']['p50']} p99 "
              f"{t['commit_latency_rounds']['p99']} rounds, election p50 "
              f"{t['election_duration_rounds']['p50']} p99 "
              f"{t['election_duration_rounds']['p99']}, heal p50 "
              f"{t['heal_latency_rounds']['p50']} p99 {t['heal_latency_rounds']['p99']}, "
              f"leader changes {t['leader_changes_total']}"
              + (f"; forensics: {rep['forensics']['groups_violating']} groups violating "
                 f"over {rep['forensics']['rounds_observed']} rounds"
                 if k["blackbox"] else ""), flush=True)
        bad += [f"timeline: {f}" for f in faults]
    if k["blackbox"] and rep["safe"] and rep["forensics"]["groups_violating"]:
        bad.append(f"forensics finds {rep['forensics']['groups_violating']} groups in a "
                   "safe run")
    record = None
    if not (time_kernel or profiled or full_profile):
        return launches, rep, record, _verdicts(phase, k, bad)

    dev = torch.device("cuda")
    ops = chaos_operands(spec, device=dev, **{
        n: v for n, v in chaos_run.fault_kwargs(k).items()
        if n not in ("seed",) + chaos_run.PLANE_KNOBS})[0]
    # the eager rounds below carry both planes, whatever the run did
    tiers = dict(with_crash=k["crash_p"] > 0, with_member=k["member_p"] > 0,
                 with_telemetry=True, with_blackbox=True)
    carry = [end.pop(n) for n in ("state", "inbox", "held", "crash", "key", "tele")]
    if carry[-1] is None:
        carry[-1] = init_telemetry(spec, carry[0])
    carry.append(end.pop("bb") or empty_blackbox(spec, carry[0]))
    free_card()
    if full_profile:
        full = epoch_runner(build_chaos_epoch(cfg, spec, 2, **tiers), spec, carry, ops)
        full()                                     # capture and warm
        profile_rounds(f"phase {phase} profile of 2 fault rounds (graph replay, "
                       f"C={k['C']})", full, 2, card)
        del full
    # one chunk's worth of groups, eager
    csz = k["C"] // cfg.fleet_chunks
    part = [cut_groups(x, csz) for x in carry]
    del carry
    free_card()
    one = dataclasses.replace(cfg, fleet_chunks=1)
    eager = epoch_runner(build_chaos_epoch(one, spec, 2, graph=False, **tiers), spec,
                         part, ops)
    seen = {}
    real = raft.compact_inbox_slots

    def recording(flat, B):
        seen.update(flat=flat.map(lambda _, x: x.clone()), B=B)
        return real(flat, B)

    raft.compact_inbox_slots = recording
    try:
        eager()                                    # warm, the input kept
    finally:
        raft.compact_inbox_slots = real
    if time_kernel:
        flat = seen.pop("flat")
        cc = int(((flat.type != 0) & (flat.ent_type == ENTRY_CONF_CHANGE).any(2)).sum())
        live = int((flat.type != 0).sum())
        print(f"phase {phase} compact_inbox input of an eager fault round on one chunk "
              f"(C={csz}): {live} live slots, {cc} of them carrying conf-change "
              f"entries", flush=True)
        if k["member_p"] > 0 and not cc:
            raise AssertionError(f"phase {phase}: no conf-change entry on the wire")
        msgs = flat.map(lambda _, x: x.view((spec.M, spec.K) + x.shape[1:]))
        del flat
        print(f"phase {phase} ", end="")
        record = kernel_record(spec, msgs, cfg.inbox_bound,
                               f"the phase {phase} chaos inbox", "inbox")
        record["path"] = f"phase {phase}: chaos_run " + " ".join(
            f"{n}={v}" for n, v in env.items())
        del msgs
    seen.clear()
    if profiled:
        profile_rounds(f"phase {phase} profile of 2 fault rounds (eager, one chunk, "
                       f"C={csz})", eager, 2, card, profiled)
    free_card()
    return launches, rep, record, _verdicts(phase, k, bad)


def _verdicts(phase, k, bad) -> list[str]:
    """The failed verdicts of a chaos path, printed; main fails the run on
    them after every phase has printed its measurements."""
    if bad:
        print(f"phase {phase} FAILED: chaos_run at C={k['C']}: not {bad}", flush=True)
    return [f"phase {phase}: not {bad}"] if bad else []


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
    names = list(dict.fromkeys(n for _, n in profiled))     # a name may be in two modules
    ranges = set(names)
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
            f"({spans[n].count / rounds:g}x)" for n in names if n in spans))
    # the kernels launched under each range (its CPU-side event's device
    # time): device busy time, where a span also holds the gaps between
    calls = {e.key: e for e in events
             if e.key in ranges and e.device_type == DeviceType.CPU}
    if calls:
        print(f"{label} device busy ms/round under: " + ", ".join(
            f"{n} {calls[n].device_time_total / 1e3 / rounds:.2f}"
            for n in names if n in calls))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"{label}   {e.self_device_time_total / 1e3 / rounds:9.3f} ms/round "
              f"{e.count / rounds:8.1f}x  {e.key[:140]}")


PHASES = ("1", "2", "3", "4", "5", "6", "7a", "7b")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile two steady rounds of phase 3 and the "
                    "full-width graph replay of two chaos fault rounds (phase 6)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="the phases to run, comma-separated (default: all; phase 5 "
                    "needs 4); the kernels and result lines print only when all run")
    args = ap.parse_args(argv)
    want = args.phases.split(",")
    if set(want) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(want) - set(PHASES))}; known {PHASES}")

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

    records = {}
    if "1" in want:
        err, records["inbox"] = phase_kernel()
        done(1)
    if "2" in want:
        phase_round()
        phase_chaos_small()
        done(2)
    if "3" in want:
        phase_full(smi, args.profile)
        free_card()
        done(3)
    if "4" in want or "5" in want:
        res, launches = phase_bench(smi)
        done(4)
        if "5" in want:
            records["carry"] = phase_compare(res, smi)
            done(5)
        del res
        free_card()
    paths = {}
    for phase, kw in (("6", dict(profiled=PROFILED_CHAOS, full_profile=args.profile)),
                      ("7a", dict(time_kernel=True)),
                      ("7b", dict(rounds=50, lens=(25, 25), time_kernel=True,
                                  profiled=PROFILED_MEMBER))):
        if phase in want:
            paths[phase] = phase_chaos_path(smi, phase, **kw)
            done(phase)
    failed = [f for p in paths.values() for f in p[3]]
    if "7b" in want:
        pin = phase_member_pin(smi)
        done("7b pin")
        if not pin and paths["7b"][3] == ["phase 7b: not ['recovered']"]:
            # the reference's own result under this mix, held by the pin
            print("phase 7b: recovered False, as the reference's at 65,536 groups "
                  "(CHAOS_MEMBER_65K_PIN.json, held equal above): not a failure of "
                  "the port; safe and lively hold", flush=True)
            failed.remove("phase 7b: not ['recovered']")
        failed += pin
    if want != list(PHASES):
        print(f"phases {args.phases} in {time.perf_counter() - t0:.1f}s (a subset: no "
              "kernels or result line)")
        return 1 if failed else 0

    carry = records["carry"]
    carry["launches"] = launches.get("compact_wire", 0)
    carry["max_abs_err"] = max(err, carry["max_abs_err"])
    kernels = [carry, records["inbox"]]
    records["inbox"]["path"] = "phase 6: chaos_run, network tier (timed on phase 1's input)"
    for phase, record in (("6", records["inbox"]), ("7a", paths["7a"][2]),
                          ("7b", paths["7b"][2])):
        record["launches"] = paths[phase][0].get("compact_inbox", 0)
        if record is not records["inbox"]:
            kernels.append(record)
    bad = [r["site"] + " " + r.get("path", "") for r in kernels if not r["launches"]]
    if bad:
        raise AssertionError(f"no launch of the kernel on: {bad}")
    print(f"all phases in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    if failed:
        print(f"chip_smoke: FAILED verdicts: {failed}", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
