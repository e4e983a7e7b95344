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
     counted (rounds x chunks); then bench.py's apply program
     (build_kv_round, KVRound's CUDA graph on the card, 2 chunks) for 6
     settle, 16 proposal (gen_schedules words: puts, delete-ranges, CONT
     txns, compactions) and 4 drain rounds, card against CPU on every state,
     wire, KV-fleet and delta leaf every round, with its launches; and the
     differential fuzz (keys 16, 128 groups, 60 ops), card against CPU on the
     report and the digests;
  3. the dense eager path (immediate emission): init_fleet, settle_leaders and 16
     steady_rounds at C = 262,144 groups with the kernel launch count read
     around that run, the commit advance and hash-chain checks,
     group-rounds/s and peak memory (``--profile`` adds a device profile);
  4. the bench path at full width: etcd_tpu_torch.bench's run at its
     defaults (C = 1,048,576: settle, pack, 16 rounds x (1 + 3 timed) as one
     CUDA graph, the commit check, the observability pass with TELEM=1 and
     BENCH_BLACKBOX=1: the metered, bare and ring probes, each one pass of
     8 rounds here, the best of 3 in bench.py), printing its JSON
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
     of a fresh graph of 8 rounds, with that graph's peak memory (8 eager
     rounds and a graph of 8, not 16: a cut);
  6. the chaos path: etcd_tpu_torch.chaos_run's network tier at
     CHAOS_C = 131,072 (a cut), CHAOS_ROUNDS = 75 (a fault epoch of 50 rounds, a
     heal epoch of 25, and the WaitHealth heal epochs it needs) and its
     other defaults (drop 0.02, delay 0.05, partition 0.1, L = 16, bound 4,
     int16 wire, TELEM=1), with CHAOS_LEASE=0 and the KV apply-plane tier of
     chaos_run.py's docstring (APPLY_KEYS=64, APPLY_GROUPS=256,
     APPLY_OPS=200), its JSON line and verdicts (safe, recovered, lively,
     lease_safe, apply_parity_ok), its flight-recorder timeline (monotone per counter, none
     wrapped), wall time, launches and peak memory; then a device profile of
     one eager fault round with both planes (device busy time, idle share,
     launches per round, device time under tick_timers, process_message,
     apply_round, the fault draws, _merge_delayed, check_invariants, the
     kernel, telemetry_update, blackbox_update and msg_activity);
     ``--profile`` adds one of the graph replay of 2 fault rounds;
  7a. the crash tier: CHAOS_C = 131,072 (a cut from its documented
     262,144), CHAOS_CRASH = 0.01, 75 rounds, with TELEM=1 and CHAOS_BLACKBOX=1 (a safe
     run: forensics finds no group), its JSON line, verdicts, timeline, crash
     counters, wall time, launches and peak memory, and the kernel timed on
     the compact_inbox input of an eager fault round;
  7b. the membership and crash tiers (CHAOS_MEMBER = 0.05, CHAOS_CRASH =
     0.005, CHAOS_SNAP_BOOST = 200, CHAOS_MEMBER_BOOST = 4, int32 wire) at
     C = 262,144 in 2 chunks, one fault and one heal epoch of 25 rounds, the
     same lines plus the membership counters, the kernel timed on an inbox
     carrying conf-change words, and a device profile of one eager fault
     round on one chunk (pre_round, crash_restart_fleet,
     check_recovery_invariants, inject_member); then the same knobs at
     C = 65,536 for 75 rounds with TELEM=0, the report held key for key to
     the reference's committed one (CHAOS_MEMBER_65K_PIN.json, which holds
     no plane keys);
  8. the served-writes path: etcd_tpu_torch.bench's APPLY_MODE=device at its
     defaults but 16 timed rounds, not 32 (a cut) (C = 262,144 in 2 chunks,
     64 keys; each round one
     replay of KVRound's CUDA graph and one read of the delta count), its
     JSON line, every write served (4,194,304), the compact_inbox launches
     (rounds x chunks + the warm-up round), peak memory, the graph capture's
     time apart, every lane's kv_digest against a host MVCCStore replay of
     the proposed words, the kernel timed on the compact_inbox input of an eager
     round of one chunk of its end state (``--profile`` adds device profiles
     of 2 graph replays at full width and of 2 eager rounds on one chunk,
     with the device time under apply_word and extract_deltas); then
     APPLY_MODE=both at APPLY_C = 4,096 (half APPLY_r08.json's size), both modes
     served and digests_match;
  9. the server layer: etcd_tpu_torch/server/kvserver.py EtcdCluster on the
     torch Cluster, each step one CUDA-graph replay of the round: (a) the
     scripted session of etcd_tpu_torch/harness/server_session.py at
     EtcdCluster's defaults (3 members, the Spec defaults; puts with and
     without a lease, ranges at the head and at an older revision, a txn on
     both branches, a watch and its events, delete_range, compact, lease
     grant, keepalive, time_to_live, expiry through advance_lease_clock,
     revoke, a Client Mutex lock and unlock), every answer and each
     member's hash_kv, revision, leases and raft term, commit and applied
     held key for key to the reference's (SERVER_SESSION_PIN.json), its
     steps and ms per step; then from its end state a ticking round with a
     proposal as the Cluster's graph replay and as build_round run
     eagerly, every state and inbox leaf equal, with the tensor ops a step
     counted; (b) the lease tier (etcd_tpu_torch/harness/chaos_lease.py)
     at the tiny size (132 steps in the reference), the report held key
     for key to CHAOS_LEASE_PIN.json's, with its steps and ms per step;
  10. the durable embedded server (etcd_tpu_torch/storage, EtcdCluster's
     data_dir paths, embed.start_etcd with the v3 JSON/HTTP gateway, the
     local tester), each part held to the reference's answers in
     DURABLE_SESSION_PIN.json: (a) the durable session of
     etcd_tpu_torch/harness/durable_session.py at EtcdCluster's defaults
     with a data dir (puts, a txn, a delete, a compaction, a lease,
     commit_backends, a follower crashed after sync_for_shutdown and
     restarted from its backend, a member crashed with an uncommitted batch,
     which is lost, and restarted, a clean close, boot_from_disk of the
     directory, a read back, an election and a put): every answer, each
     member's hash_kv, revision, compact revision, consistent index, leases
     and raft term, commit and applied at each stage, and the sha256 of each
     member db; then graph == eager from the booted cluster, with the steps,
     ms per step and the codec in use; (b) embed.start_etcd (3 members, a
     data dir, an ephemeral port, the ticker on) driven over RemoteClient on
     127.0.0.1 (put, range, txn, a lease grant and keep-alive, a watch, an
     election and a lock, /health, /version, /metrics), closed, started
     again on the same data dir and read back; (c) the local tester at 4
     cycles, seed 0, one put a phase and a data dir (a depth cut of its
     default run; the crash-restart cycle included), its report and steps,
     healthy.
  11. RawNode and its storage (etcd_tpu_torch/models/rawnode.py, storage/
     {raftstorage,wal,checkpoint}.py, harness/interaction.py, examples/
     raftexample.py), each part held to the JAX package's records in
     RAWNODE_PIN.json (harness/rawnode_session.py's scripts): (a)
     raftexample, tests/test_raftexample.py's operations on one Cluster(3)
     and main(); (b) the RawNode and flow-control Ready sequences, both once
     from the lane graphs and once eagerly, graph == eager; (c)
     InteractionEnv on every script of tests/interaction_scripts/, every
     command's text; (d) a RawNode group persisted through the WAL, torn,
     dropped, replayed and rebooted: the read-back and the segment sha256;
     (e) save_fleet and load_fleet of phase 5's fleet (C = 131,072),
     unpacked to a dense NodeState, every leaf equal after the round trip,
     the file's size and the save and load times; then ms per lane step,
     tick and apply call, graph and eager, and the tensor ops and ms a
     graph replay of one process_message, beside those of the step
     specialized to one message type (a comparison only).
Only with ``--phases 10d`` (a call of its own): 10d. the local tester at
its defaults with a data dir, its report and steps against the pin's
"localtester_default", healthy, and its wall time.
Only with ``--phases 9c`` (a call of its own, about 22 minutes): 9c. the
runner tier at the tiny size (330 steps, moved here from 9b for the
script's time), held to CHAOS_LEASE_PIN.json's "tiny"; then
etcd_tpu_torch.chaos_run at its defaults with CHAOS_LEASE unset, as
``python -m etcd_tpu_torch.chaos_run`` runs it (the network tier at C =
262,144, then the lease and runner tiers at their defaults in their
subprocess on the card), the tiers' time against the reference's 1,800 s
limit and their report held key for key to CHAOS_LEASE_PIN.json's.
Cuts that keep the script inside its 1,200 s limit (PERF.md section 4):
phases 5, 6, 7a and 7b run at C = 262,144 or 131,072, not 1,048,576, phase 7b
in epochs of 25 rounds, phases 6 and 7b profile one eager fault round,
phase 4's probes take one pass, phase 5 runs 8 rounds, phase
8 16 timed rounds, and phase 9b the lease tier alone.
Then a line with the kernels' JSON record (the one kernel: at its carry
site, and at compact_inbox on the network, crash, membership and
served-writes paths),
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
import pathlib
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


def phase_kv_small(C=64, chunks=2, settle=6, proposals=16, drain=4):
    """bench.py's apply program (build_kv_round) at C = ``C``: on the card in
    ``chunks`` fleet chunks, each round a replay of KVRound's CUDA graph,
    against the eager round on the CPU in one chunk, on every state, wire,
    KV-fleet and delta leaf after every round: ``settle`` rounds from a
    MsgHup, then ``proposals`` rounds of gen_schedules words (puts,
    delete-ranges, CONT txns, compactions; each group its own), then
    ``drain``; the compact_inbox launches are rounds x chunks plus the
    graph's warm-up round. Then the differential fuzz at keys 16, 128
    groups, 60 ops: card against CPU on the report and the digests."""
    import torch

    from etcd_tpu_torch import bench, drive
    from etcd_tpu_torch.device_mvcc import KVSpec, apply_words, init_kv, kv_digest
    from etcd_tpu_torch.device_mvcc.fuzz import differential_run, gen_schedules
    from etcd_tpu_torch.kernels import LAUNCHES, reset_launches
    from etcd_tpu_torch.models.engine import (KVRound, build_kv_round, empty_inbox,
                                              init_fleet)

    t0 = time.perf_counter()
    spec = drive.bench_spec()
    kvspec = KVSpec(keys=64)
    cfg = bench.apply_config(spec, chunks)
    words = gen_schedules(kvspec, C, proposals, seed=0)
    reset_launches()
    card = KVRound(cfg, spec, kvspec)
    cpu = build_kv_round(dataclasses.replace(cfg, fleet_chunks=1), spec, kvspec)
    runs = {}
    for dev in ("cuda", "cpu"):
        runs[dev] = [init_fleet(spec, C, device=dev), empty_inbox(spec, C, device=dev),
                     init_kv(kvspec, C, dev)]
    M, E = spec.M, spec.E
    n_rounds = settle + proposals + drain
    events = 0
    for r in range(n_rounds):
        p = r - settle
        ends = {}
        for dev, (st, ib, kv) in runs.items():
            pl = torch.zeros((M, C), dtype=torch.int32, device=dev)
            pd = torch.zeros((M, E, C), dtype=torch.int32, device=dev)
            if 0 <= p < proposals:
                pl[0] = 1
                pd[0, 0] = torch.from_numpy(words[p]).to(dev)
            hup = torch.zeros((M, C), dtype=torch.bool, device=dev)
            hup[0] = r == 0
            no = torch.zeros((M, C), dtype=torch.bool, device=dev)
            keep = torch.ones((M, M, C), dtype=torch.bool, device=dev)
            on = torch.ones((C,), dtype=torch.bool, device=dev)
            step = card if dev == "cuda" else cpu
            ends[dev] = step(st, ib, kv, on, pl, pd, pd * 0, pl * 0, hup, no, keep)
            runs[dev] = list(ends[dev][:3])
        torch.cuda.synchronize()
        bad = [d for n, a, b in zip(("state", "inbox", "kv", "delta"), ends["cuda"],
                                    ends["cpu"]) for d in tree_diff(a, b, n)]
        if bad:
            raise AssertionError(f"KV round {r} at C={C}: card != CPU on {bad}")
        events += int(ends["cpu"][3].mask.sum())
    launches = graph_launches(LAUNCHES, [card.graph])
    kv = runs["cpu"][2]
    if launches.get("compact_inbox") != (n_rounds + 1) * chunks or \
            card.graph.replays != n_rounds:
        raise AssertionError(f"compact_inbox launches {launches} over {n_rounds} "
                             f"rounds x {chunks} chunks (+ {chunks} in the warm-up), "
                             f"{card.graph.replays} replays")
    if not (events and int(kv.err_compacted.sum() + kv.err_future.sum())
            and bool(kv.tomb.any())):
        raise AssertionError(f"the KV rounds served {events} events; no error or "
                             "tombstone lane")
    card.release()
    print(f"phase 2 KV round C={C} in {chunks} chunks ({time.perf_counter() - t0:.1f}s): "
          f"{settle} settle + {proposals} proposal + {drain} drain rounds as replays of "
          f"one CUDA graph, card == CPU (one chunk) on every state, wire, KV-fleet and "
          f"delta leaf every round; {events} watch events, {int(kv.current_rev.min())} to "
          f"{int(kv.current_rev.max())} current_rev, {int(kv.err_compacted.sum())} "
          f"ErrCompacted and {int(kv.err_future.sum())} ErrFutureRev lanes; compact_inbox "
          f"{launches['compact_inbox']} launches = {n_rounds} rounds x {chunks} chunks + "
          f"{chunks} warm-up", flush=True)
    fuzz = KVSpec(keys=16)
    reps = {dev: differential_run(fuzz, 128, 60, seed=0, device=dev)
            for dev in ("cuda", "cpu")}
    words = gen_schedules(fuzz, 128, 60, seed=0)
    digs = {dev: kv_digest(fuzz, apply_words(fuzz, init_kv(fuzz, 128, dev), words)).cpu()
            for dev in ("cuda", "cpu")}
    if reps["cuda"] != reps["cpu"] or not reps["cuda"]["parity_ok"] or \
            not torch.equal(digs["cuda"], digs["cpu"]):
        raise AssertionError(f"differential fuzz: card {reps['cuda']} != CPU "
                             f"{reps['cpu']}, or the digests differ")
    print(f"phase 2 differential fuzz keys=16, 128 groups x 60 ops: card == CPU on the "
          f"report and all 128 digests: {json.dumps(reps['cuda'])}", flush=True)


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


# phase 4's observability probes: one pass of 8 rounds each, not the best of
# bench.py's 3 (cut to 2 passes to keep the script's time for phase 9, then
# to 1 for phase 11)
PHASE4_PROBE_PASSES = 1


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
    passes = bench.PROBE_PASSES
    bench.PROBE_PASSES = PHASE4_PROBE_PASSES
    try:
        res = bench.run(knobs, "cuda")
    finally:
        bench.PROBE_PASSES = passes
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
    # replays, and the three probes' 1 + 2 x 8 metered, bare and ring rounds:
    # the planes launch no compaction of their own
    probes = 3 * (1 + PHASE4_PROBE_PASSES * bench.METERED_ROUNDS)
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


def phase_compare(res, card, rounds=8, groups=FULL_GROUPS // 8):
    """The bench's steady program run eagerly on the first ``groups`` groups
    of its fleet (cut from C = 1,048,576 to 131,072 to keep the script's
    time for the chaos paths), the kernel timed on the outbox of its last
    round, and device profiles of two eager rounds and one replay of a
    fresh graph of ``rounds`` rounds. Returns the kernel's record and the
    packed fleet at the end, on the host."""
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
    # phase 11e saves and loads this fleet; it waits on the host meanwhile
    return record, state.map(lambda _, x: x.cpu())


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

# the eager fault rounds a chaos path's profile runs, and by default its
# kernel timing's warm run, whose last round's compact_inbox input is timed
# (cut from 2 to keep the script's time for phase 9; phase 7b warms 2, as
# only the second round's input carries the first round's conf changes)
EAGER_ROUNDS = 1

# the chaos paths: phase -> (chaos_run knobs, report keys the phase's line
# prints)
CHAOS_PATHS = {
    # cut from C = 1,048,576 to 262,144 to keep the script's time for phase
    # 7b, then to 131,072 for phase 10; with the KV apply-plane tier of
    # chaos_run.py's docstring
    "6": ({"CHAOS_LEASE": "0", "CHAOS_C": str(FULL_GROUPS // 8), "APPLY_KEYS": "64",
           "APPLY_GROUPS": "256", "APPLY_OPS": "200"}, ()),
    # chaos_run.py's docstring and tests/test_recovery_crash.py:219, cut from
    # 262,144 groups to 131,072 for phase 10
    "7a": ({"CHAOS_LEASE": "0", "CHAOS_C": str(FULL_GROUPS // 8), "CHAOS_CRASH": "0.01",
            "CHAOS_BLACKBOX": "1"},
           ("crashes_injected", "entries_lost_fsync", "restarts_completed",
            "lost_commit", "snap_window_hit_rate")),
    # the membership tier's acceptance mix (tests/test_recovery_member.py:359),
    # cut from C = 1,048,576 to 262,144 groups (in 131,072-group chunks, the
    # chunk chaos_run.py takes at full width), and (in main) to one fault and
    # one heal epoch of 25 rounds, to fit the script's time limit
    "7b": ({"CHAOS_LEASE": "0", "CHAOS_C": str(FULL_GROUPS // 4), "CHAOS_CHUNKS": "2",
            "CHAOS_MEMBER": "0.05",
            "CHAOS_CRASH": "0.005", "CHAOS_SNAP_BOOST": "200", "CHAOS_MEMBER_BOOST": "4"},
           ("crashes_injected", "entries_lost_fsync", "conf_changes_applied",
            "joint_entered", "joint_left", "cc_guard_refusals", "cc_guard_admits",
            "member_changes_proposed", "snap_window_hit_rate", "member_window_hit_rate",
            "snap_window_lane_frac", "member_window_lane_frac")),
}


# the membership tier at the largest size the reference has run (on the
# CPU), and where its report is kept; that report holds no plane keys, so
# the run keeps the telemetry plane off
MEMBER_PIN = ({"CHAOS_LEASE": "0", "CHAOS_C": "65536", "CHAOS_ROUNDS": "75",
               "CHAOS_MEMBER": "0.05",
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
                     full_profile=False, time_kernel=False, warm_rounds=EAGER_ROUNDS):
    """One chaos path, CHAOS_PATHS[phase]:
    etcd_tpu_torch.chaos_run for ``rounds`` rounds (each a replay of its
    CUDA graph; fault and heal epochs of chaos_run's 50 and 25 rounds, or of
    ``lens``) with the launches read around it, its JSON line, its
    verdicts (safe, recovered, lively: all required), wall time and peak
    memory. Then, on one chunk of its end state, eagerly: ``warm_rounds``
    fault rounds, the last one's compact_inbox input kept, and with
    ``time_kernel`` the kernel timed on it against its plain version; with
    ``profiled`` a device profile of EAGER_ROUNDS fault rounds with those
    named functions; with
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
    # (a cut of the epochs runs run_chaos alone: no lease or apply gate)
    gates = ("safe", "recovered", "lively") + (("lease_safe", "apply_parity_ok")
                                               if lens is None else ())
    bad = [key for key in gates if not rep[key]]
    if k["apply_keys"]:
        print(f"phase {phase} KV apply-plane tier (APPLY_KEYS={k['apply_keys']}, "
              f"{k['apply_groups']} groups x {k['apply_ops']} ops on the card against "
              f"host MVCCStore replays): apply_parity_ok {rep['apply_parity_ok']}, "
              f"kv_plane {json.dumps(rep.get('kv_plane', rep.get('kv_plane_error')))}",
              flush=True)
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

    def eager_epoch(n):
        return epoch_runner(build_chaos_epoch(one, spec, n, graph=False, **tiers), spec,
                            part, ops)
    eager = eager_epoch(warm_rounds)
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
        profile_rounds(f"phase {phase} profile of {EAGER_ROUNDS} fault round (eager, one "
                       f"chunk, C={csz})", eager_epoch(EAGER_ROUNDS), EAGER_ROUNDS, card,
                       profiled)
    free_card()
    return launches, rep, record, _verdicts(phase, k, bad)


def _verdicts(phase, k, bad) -> list[str]:
    """The failed verdicts of a chaos path, printed; main fails the run on
    them after every phase has printed its measurements."""
    if bad:
        print(f"phase {phase} FAILED: chaos_run at C={k['C']}: not {bad}", flush=True)
    return [f"phase {phase}: not {bad}"] if bad else []


# phase 8's timed rounds (cut from APPLY_ROUNDS' 32 to keep the script's time
# for phase 9)
SERVED_ROUNDS = 16
# phase 8's second run: APPLY_MODE=both at half APPLY_r08.json's 8,192 groups,
# so that the whole script keeps inside its time limit (PERF.md section 4)
SERVED_BOTH_C = 4096


# functions whose device time phase 8's profile reports
PROFILED_KV = (("etcd_tpu_torch.models.raft", "process_message"),
               ("etcd_tpu_torch.models.raft", "apply_round"),
               ("etcd_tpu_torch.models.raft", "compact_inbox_slots"),
               ("etcd_tpu_torch.models.engine", "apply_word"),
               ("etcd_tpu_torch.models.engine", "extract_deltas"))


def phase_served(card, profile=False):
    """bench.py's served-writes path through etcd_tpu_torch.bench's
    apply_run (what ``python -m etcd_tpu_torch.bench`` runs for APPLY_MODE):
    APPLY_MODE=device at its defaults but SERVED_ROUNDS timed rounds (C =
    262,144 in 2 chunks, 64 keys), its JSON line, every write served, the compact_inbox launches
    (settle + timed + drain rounds, times the chunks, plus the graph's
    warm-up round), every lane's kv_digest against a host MVCCStore replay
    of the proposed words, and the kernel timed on the compact_inbox input of
    one eager round of its end state (one chunk); with ``profile``, device
    profiles of 2 replays of the graph at full width and of 2 eager rounds
    on one chunk; then APPLY_MODE=both at C = SERVED_BOTH_C, both modes
    served and the digests matching. Returns the kernel record and the
    failures."""
    import torch

    from etcd_tpu_torch import bench, drive
    from etcd_tpu_torch.device_mvcc import KVSpec, scheme
    from etcd_tpu_torch.device_mvcc.fuzz import host_replay
    from etcd_tpu_torch.kernels import LAUNCHES, reset_launches
    from etcd_tpu_torch.models import raft
    from etcd_tpu_torch.models.engine import build_kv_round

    knobs = bench.read_apply_knobs({"APPLY_MODE": "device",
                                     "APPLY_ROUNDS": str(SERVED_ROUNDS)})
    free_card()
    reset_launches()
    t0 = time.perf_counter()
    res = bench.apply_run(knobs, "cuda")
    wall = time.perf_counter() - t0
    rep = res.report
    print(json.dumps(rep), flush=True)
    m = res.modes["device"]
    graph = res.rnd.graph
    launches = graph_launches(LAUNCHES, [graph])
    n_rounds = m.settle_rounds + knobs.rounds + bench.DRAIN_ROUNDS
    want_launches = (n_rounds + 1) * knobs.chunks
    kvspec = KVSpec(keys=knobs.keys)
    store, _, _ = host_replay(kvspec, res.words)
    host_digest = scheme.store_latest_digest(store, knobs.keys)
    # every group gets the same words, so every lane, in every chunk, must
    # hold the one host digest
    differ = int((m.digests != host_digest).sum())
    print(f"phase 8 served writes (APPLY_MODE=device) C={knobs.C} on {card}: "
          f"{rep['device_writes_per_sec']} writes/s ({rep['device_served_events']} served "
          f"in {rep['device_elapsed_s']} s: {knobs.rounds} timed + "
          f"{bench.DRAIN_ROUNDS} drain rounds, one graph replay and one delta-count read "
          f"each), settle {m.settle_rounds} rounds in {m.settle_s:.2f}s of which the "
          f"first round (eager warm-up and graph capture) {m.first_round_s:.2f}s; "
          f"{wall:.1f}s in all; fleet_chunks {knobs.chunks}, peak memory "
          f"{res.peaks['device'] / 2**30:.2f} GiB; compact_inbox {launches} launches "
          f"(want {n_rounds} rounds x {knobs.chunks} chunks + {knobs.chunks} warm-up = "
          f"{want_launches}), {graph.replays} replays of {dict(graph.captured)} recorded; "
          f"kv_digest of all {len(m.digests)} lanes against the host MVCCStore "
          f"replay's {host_digest}: {differ} differ", flush=True)
    failed = []
    if not (rep["device_served_ok"] and rep["device_served_events"] == knobs.rounds * knobs.C):
        failed.append(f"device served {rep['device_served_events']} of "
                      f"{knobs.rounds * knobs.C}")
    if launches.get("compact_inbox") != want_launches:
        failed.append(f"compact_inbox launched {launches}, want {want_launches}")
    if len(m.digests) != knobs.C or differ:
        failed.append(f"kv_digest != the host replay on {differ} of {len(m.digests)} lanes")

    if profile:
        profile_rounds(f"phase 8 profile of 2 rounds (graph replay, C={knobs.C})",
                       lambda: [res.rnd(*graph.carry[:3], *graph.carry[4:])
                                for _ in range(2)], 2, card, PROFILED_KV)
    # the kernel on this path's own input: one eager round of the end state's
    # first chunk, its compact_inbox input kept
    st, ib, kv = (cut_groups(x, knobs.C // knobs.chunks) for x in graph.carry[:3])
    args = [cut_groups(x, knobs.C // knobs.chunks) for x in graph.carry[4:]]
    res.rnd.release()
    del res
    free_card()
    spec = drive.bench_spec()
    one = build_kv_round(bench.apply_config(spec, 1), spec, kvspec)
    seen = {}
    real = raft.compact_inbox_slots

    def recording(flat, B):
        seen.update(flat=flat.map(lambda _, x: x.clone()), B=B)
        return real(flat, B)

    raft.compact_inbox_slots = recording
    try:
        one(st, ib, kv, *args)
    finally:
        raft.compact_inbox_slots = real
    flat = seen.pop("flat")
    msgs = flat.map(lambda _, x: x.view((spec.M, spec.K) + x.shape[1:]))
    print("phase 8 ", end="")
    record = kernel_record(spec, msgs, bench.apply_config(spec, 1).inbox_bound,
                           "the served-writes inbox", "inbox")
    record["path"] = "phase 8: bench APPLY_MODE=device"
    record["launches"] = launches.get("compact_inbox", 0)
    del flat, msgs
    if profile:
        carry = [st, ib, kv]

        def two():
            for _ in range(2):
                carry[:] = one(*carry, *args)[:3]
        profile_rounds(f"phase 8 profile of 2 eager rounds (one chunk, "
                       f"C={knobs.C // knobs.chunks})", two, 2, card, PROFILED_KV)
        del carry
    del st, ib, kv, args, one
    free_card()

    both = bench.read_apply_knobs({"APPLY_MODE": "both", "APPLY_C": str(SERVED_BOTH_C)})
    t0 = time.perf_counter()
    res = bench.apply_run(both, "cuda")
    wall = time.perf_counter() - t0
    rep = res.report
    print(json.dumps(rep), flush=True)
    print(f"phase 8 APPLY_MODE=both C={both.C} on {card}: device "
          f"{rep['device_writes_per_sec']} writes/s, host {rep['host_writes_per_sec']} "
          f"(device_vs_host_speedup {rep['device_vs_host_speedup']}), digests_match "
          f"{rep['digests_match']} on {rep['digest_lanes_checked']} lanes; {wall:.1f}s in "
          "all", flush=True)
    if not (rep["digests_match"] and rep["device_served_ok"] and rep["host_served_ok"]):
        failed.append(f"APPLY_MODE=both at C={both.C}: {rep}")
    res.rnd.release()
    del res
    free_card()
    for f in failed:
        print(f"phase 8 FAILED: {f}", flush=True)
    return record, [f"phase 8: {f}" for f in failed]


SESSION_PIN = "SERVER_SESSION_PIN.json"
LEASE_PIN = "CHAOS_LEASE_PIN.json"


def count_ops(fn):
    """``fn()`` with every tensor op that is not a view counted (on the card
    each launches one kernel: the profiler counted 134,953 kernels a step
    at M = 3 where the CPU count is 134,269). Returns (result, count)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not getattr(func, "is_view", False):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, Count.n


def counted_steps():
    """Count every Cluster.step until the returned restore() is called."""
    from etcd_tpu_torch.harness.cluster import Cluster

    real, box = Cluster.step, [0]

    def step(self, *a, **k):
        box[0] += 1
        return real(self, *a, **k)

    Cluster.step = step

    def restore():
        Cluster.step = real
        return box[0]
    return restore


def pin_differ(got: dict, want: dict) -> list:
    """The keys on which two reports differ (through JSON, as the pin was
    written)."""
    got = json.loads(json.dumps(got))
    return sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))


def tiny_tier(name):
    """One of chaos_lease's tiers ("lease" or "runner") at the tiny size
    (chaos_lease.SIZES["tiny"]) on the card: (report, steps, seconds)."""
    import torch

    from etcd_tpu_torch import concurrency
    from etcd_tpu_torch.harness import chaos_lease

    lease_kw, runner_kw = chaos_lease.SIZES["tiny"]
    restore = counted_steps()
    t0 = time.perf_counter()
    try:
        if name == "lease":
            rep = chaos_lease.run_lease_chaos(**lease_kw)
        else:
            concurrency.Session._next_id = 1000   # as in a fresh process
            rep = chaos_lease.run_runner_chaos(**runner_kw)
        torch.cuda.synchronize()
    finally:
        n = restore()
    return rep, n, time.perf_counter() - t0


def graph_vs_eager(g):
    """From a Cluster ``g``'s current state on the card: one ticking round
    with a proposal at its leader as the Cluster's step (a graph replay)
    and as build_round run eagerly on copies of the state, inbox and keep
    mask, same inputs. Returns (the leaves that differ, the eager round's
    tensor ops, graph ms, eager ms)."""
    import torch

    from etcd_tpu_torch.models.engine import build_round
    from etcd_tpu_torch.types import ENTRY_NORMAL

    M, E, lead = g.spec.M, g.spec.E, g.leader()
    st = g.eng.state.map(lambda _, x: x.clone())
    ib = g.eng.inbox.map(lambda _, x: x.clone())
    keep = g.eng.keep_mask.clone()
    eager_round = build_round(g.cfg, g.spec)
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    g.propose(lead, 4242)
    g.step(tick=True)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t1) * 1e3

    def eager_one():
        plen = torch.zeros((M, 1), dtype=torch.int32, device=dev)
        pdata = torch.zeros((M, E, 1), dtype=torch.int32, device=dev)
        plen[lead], pdata[lead, 0] = 1, 4242
        z = torch.zeros((M, 1), dtype=torch.int32, device=dev)
        return eager_round(st, ib, plen, pdata, torch.full_like(pdata, ENTRY_NORMAL), z,
                           torch.zeros((M, 1), dtype=torch.bool, device=dev),
                           torch.ones((M, 1), dtype=torch.bool, device=dev), keep)
    t1 = time.perf_counter()
    (st, ib), ops = count_ops(eager_one)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t1) * 1e3
    return leaves_equal(g.eng.state, st) + leaves_equal(g.eng.inbox, ib), ops, graph_ms, eager_ms


def phase_server(card):
    """Phase 9, the server layer (etcd_tpu_torch/server/kvserver.py
    EtcdCluster on the torch Cluster, each step one CUDA-graph replay):
    (a) the scripted session of harness/server_session.py at EtcdCluster's
    defaults (3 members, the Spec defaults), every answer and each member's
    hash_kv, revision, leases and raft term, commit and applied held key for
    key to the reference's in SERVER_SESSION_PIN.json; then graph == eager:
    from the session's end state a ticking round with a proposal as the
    Cluster's graph replay and as build_round run eagerly on copies, every
    state and inbox leaf equal, the eager round's ops counted; (b) the lease
    tier (harness/chaos_lease.py) at the tiny size, its report held key for
    key to CHAOS_LEASE_PIN.json's "tiny" (the runner tier's tiny run moved
    to phase 9c's call for the script's time). Prints each part's steps, ms
    per step and time. Returns the failures."""
    import torch

    from etcd_tpu_torch.harness import server_session
    from etcd_tpu_torch.server.kvserver import EtcdCluster

    failed = []
    with open(SESSION_PIN) as f:
        want = json.load(f)["session"]
    t0 = time.perf_counter()
    ec = EtcdCluster(n_members=3)
    got = json.loads(json.dumps(server_session.run_session(ec, server_session.port_api())))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    differ = [r[0] for r, w in zip(got["responses"], want["responses"]) if r != w]
    if len(got["responses"]) != len(want["responses"]):
        differ.append("the number of responses")
    differ += [f"state {k}" for k in pin_differ(got["state"], want["state"])]
    if got["steps"] != want["steps"]:
        differ.append(f"steps {got['steps']} != {want['steps']}")
    print(f"phase 9a EtcdCluster session (3 members, Spec defaults) on {card}: "
          f"{len(got['responses'])} requests in {got['steps']} steps, {wall:.1f}s "
          f"({wall * 1e3 / got['steps']:.1f} ms/step, the graph's capture included); "
          f"against {SESSION_PIN}: {'equal' if not differ else 'differs on ' + str(differ)} "
          f"(hash_kv {got['state']['hash_kv']}, raft term/commit/applied "
          f"{got['state']['raft_term']}/{got['state']['raft_commit']}/"
          f"{got['state']['raft_applied']})", flush=True)
    if differ:
        failed.append(f"phase 9a: the session differs from {SESSION_PIN} on {differ}")

    # graph == eager from the session's end state
    differ, ops, graph_ms, eager_ms = graph_vs_eager(ec.cl)
    print(f"phase 9a graph == eager: a ticking round with a proposal from the session's "
          f"end state, the Cluster's graph replay against build_round run eagerly, "
          f"every state and inbox leaf equal: {not differ} {differ or ''}; {ops} tensor "
          f"ops a step (each one kernel), graph {graph_ms:.1f} ms, eager {eager_ms:.1f} ms "
          f"(ops counted)", flush=True)
    if differ:
        failed.append(f"phase 9a: graph != eager on {differ}")
    del ec
    free_card()

    with open(LEASE_PIN) as f:
        want = json.load(f)["tiny"]
    rep, n, wall = tiny_tier("lease")
    differ = pin_differ(rep, {k: v for k, v in want.items() if not k.startswith("runner_")})
    print(json.dumps(rep), flush=True)
    print(f"phase 9b the lease tier at the tiny size on {card}: {n} steps in {wall:.1f}s "
          f"({wall * 1e3 / n:.1f} ms/step, the graph's capture included); against "
          f"{LEASE_PIN} \"tiny\": {len(rep)} keys, "
          f"{'equal' if not differ else 'differs on ' + str(differ)} (the runner tier's "
          f"tiny run is phase 9c's)", flush=True)
    if differ:
        failed.append(f"phase 9b: the lease tier's report differs from the pin on {differ}")
    free_card()
    for f in failed:
        print(f"phase 9 FAILED: {f}", flush=True)
    return failed


def phase_default_run(card):
    """Phase 9c (only with ``--phases 9c``, a call of its own: about 22
    minutes): the runner tier at the tiny size held to CHAOS_LEASE_PIN.json's
    "tiny"; then ``etcd_tpu_torch.chaos_run`` at its defaults, CHAOS_LEASE
    unset, as ``python -m etcd_tpu_torch.chaos_run`` runs it: the network
    tier at C = 262,144, then the lease and runner tiers at their defaults
    (seed 0) in their subprocess on the card, their wall time against the
    reference's 1,800 s limit, and their report held key for key to the
    reference's (CHAOS_LEASE_PIN.json's "default"). Returns the failures."""
    import torch

    from etcd_tpu_torch import chaos_run

    with open(LEASE_PIN) as f:
        pin = json.load(f)
    failed = []
    rep, n, wall = tiny_tier("runner")
    want = {k: v for k, v in pin["tiny"].items() if k.startswith("runner_")}
    differ = pin_differ(rep, want)
    print(json.dumps(rep), flush=True)
    print(f"phase 9c the runner tier at the tiny size on {card}: {n} steps in "
          f"{wall:.1f}s ({wall * 1e3 / n:.1f} ms/step, the graph's capture included); "
          f"against {LEASE_PIN} \"tiny\": {len(rep)} keys, "
          f"{'equal' if not differ else 'differs on ' + str(differ)}", flush=True)
    if differ:
        failed.append(f"phase 9c: the runner tier's report differs from the pin on {differ}")
    free_card()
    want = pin["default"]
    k = chaos_run.read_knobs({})
    real, took = chaos_run.lease_tier, {}

    def timed(seed, dev):
        t = time.perf_counter()
        try:
            return real(seed, dev)
        finally:
            took["s"] = time.perf_counter() - t
    chaos_run.lease_tier = timed
    t0 = time.perf_counter()
    try:
        rep = chaos_run.run(k, "cuda")
    finally:
        chaos_run.lease_tier = real
    torch.cuda.synchronize()
    print(json.dumps(rep), flush=True)
    differ = pin_differ({key: rep.get(key) for key in want}, want)
    print(f"phase 9c chaos_run at its defaults (C={k['C']}, CHAOS_LEASE unset) on {card}: "
          f"{time.perf_counter() - t0:.1f}s in all; the network tier {rep['elapsed_s']}s "
          f"(safe {rep['safe']}, recovered {rep['recovered']}, lively {rep['lively']}); "
          f"the lease and runner tiers {took.get('s', 0):.1f}s of the reference's "
          f"{chaos_run.LEASE_TIER_TIMEOUT_S}s limit, lease_safe {rep['lease_safe']}"
          + (f", lease_tier_error {rep['lease_tier_error']!r}" if "lease_tier_error" in rep
             else "")
          + f"; against {LEASE_PIN} \"default\": "
          f"{'equal' if not differ else 'differs on ' + str(differ)}", flush=True)
    failed += [f"phase 9c: {key}" for key in ("safe", "recovered", "lively", "lease_safe",
                                              "apply_parity_ok") if not rep[key]]
    if differ:
        failed.append(f"phase 9c: the lease tiers differ from the pin on {differ}")
    for f in failed:
        print(f"phase 9c FAILED: {f}", flush=True)
    return failed


DURABLE_PIN = "DURABLE_SESSION_PIN.json"


def phase_durable(card):
    """Phase 10, the durable embedded server on the card, each part held to
    the reference's answers in DURABLE_SESSION_PIN.json: (a) the durable
    session of harness/durable_session.py on EtcdCluster at its defaults (3
    members, the Spec defaults) with a data dir (puts, a txn, a delete, a
    compaction and a lease; commit_backends; a follower crashed after
    sync_for_shutdown, a write while it is down, its restart from its
    backend; a member crashed with an uncommitted batch, which is lost, and
    restarted; a clean close; boot_from_disk of the directory, a read back,
    an election and a put; each election by member 0's campaign): the
    answers, each member's state at each stage and the sha256 of each member
    db; then graph == eager from the booted cluster; (b) the gateway session
    on embed.start_etcd (3 members, the data dir, an ephemeral port, the
    ticker on) over RemoteClient, the v2 REST family and v2 auth over the
    wire, a close, a restart on the same data dir and every key read back;
    (c) the local
    tester at the pin's depth cut (4 cycles, seed 0, one put a phase, a
    data dir): the report and the steps, and healthy. Prints the steps, ms
    per step and the codec in use. Returns the failures."""
    import tempfile

    import torch

    from etcd_tpu_torch import client, localtester
    from etcd_tpu_torch.embed import Config, start_etcd
    from etcd_tpu_torch.harness import durable_session as ds
    from etcd_tpu_torch.harness.cluster import Cluster
    from etcd_tpu_torch.server.kvserver import EtcdCluster
    from etcd_tpu_torch.storage import walcodec

    with open(DURABLE_PIN) as f:
        pin = json.load(f)
    failed = []
    codec = "native (native/walcodec.cpp, built with g++)" if walcodec.is_native() \
        else "Python (the native build failed)"
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ec = EtcdCluster(n_members=3, data_dir=d)
        out = ds.run_durable_session(ec, ds.port_api(), d, lambda: Cluster(n_members=3))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, want = json.loads(json.dumps(ds.session_view(out))), pin["session"]
        differ = [r[0] for r, w in zip(got["responses"], want["responses"]) if r != w]
        if len(got["responses"]) != len(want["responses"]):
            differ.append("the number of responses")
        differ += [f"state {k}" for k in pin_differ(got["state"], want["state"])]
        differ += [f"file {k}" for k in pin_differ(got["files"], want["files"])]
        if got["steps"] != want["steps"]:
            differ.append(f"steps {got['steps']} != {want['steps']}")
        booted = got["state"]["booted_written"]
        print(f"phase 10a durable session (3 members, Spec defaults, a data dir) on {card}: "
              f"{len(got['responses'])} requests in {got['steps']} steps, {wall:.1f}s "
              f"({wall * 1e3 / got['steps']:.1f} ms/step, two graph captures included); "
              f"codec {codec}; member db sha256 "
              f"{[v['sha256'][:12] for v in got['files'].values()]}; against {DURABLE_PIN}: "
              f"{'equal' if not differ else 'differs on ' + str(differ)} (after the boot: "
              f"hash_kv {booted['hash_kv']}, applied {booted['applied_index']}, raft "
              f"term {booted['raft_term']})", flush=True)
        if differ:
            failed.append(f"phase 10a: the durable session differs from {DURABLE_PIN} "
                          f"on {differ}")
        differ, ops, graph_ms, eager_ms = graph_vs_eager(out["booted"].cl)
        print(f"phase 10a graph == eager from the booted cluster (its state written by "
              f"boot_from_disk through Cluster.set_node): every state and inbox leaf "
              f"equal: {not differ} {differ or ''}; {ops} tensor ops a step, graph "
              f"{graph_ms:.1f} ms, eager {eager_ms:.1f} ms (ops counted)", flush=True)
        if differ:
            failed.append(f"phase 10a: graph != eager on {differ}")
        del ec, out
    free_card()

    with tempfile.TemporaryDirectory() as d:
        restore = counted_steps()
        t0 = time.perf_counter()
        try:
            got = json.loads(json.dumps(ds.run_gateway_session(
                lambda: start_etcd(Config(cluster_size=3, data_dir=d, auto_tick=True)),
                client)))
        finally:
            n = restore()
        wall = time.perf_counter() - t0
    want = pin["gateway"]
    differ = [r[0] for r, w in zip(got["responses"], want["responses"]) if r != w]
    if len(got["responses"]) != len(want["responses"]):
        differ.append("the number of responses")
    r = dict(got["responses"])
    print(f"phase 10b the v3 gateway on embed.start_etcd (3 members, a data dir, the "
          f"ticker on) over RemoteClient on {card}: {len(got['responses'])} requests, "
          f"a close and a restart from disk in {n} steps (the ticker's included), "
          f"{wall:.1f}s; read back after the restart {r.get('restarted read back')} and "
          f"v2 {r.get('restarted v2 get /v2a')}; "
          f"against {DURABLE_PIN}: {'equal' if not differ else 'differs on ' + str(differ)}",
          flush=True)
    if differ:
        failed.append(f"phase 10b: the gateway session differs from {DURABLE_PIN} "
                      f"on {differ}")
    free_card()

    want = pin["localtester"]
    with tempfile.TemporaryDirectory() as d:
        restore = counted_steps()
        t0 = time.perf_counter()
        try:
            rep = localtester.run_local_tester(data_dir=d, **pin["tester_cut"])
            torch.cuda.synchronize()
        finally:
            n = restore()
        wall = time.perf_counter() - t0
    differ = pin_differ(rep, want["report"])
    if n != want["steps"]:
        differ.append(f"steps {n} != {want['steps']}")
    print(json.dumps(rep), flush=True)
    print(f"phase 10c the local tester (cycles 4, seed 0, one put a phase, a data dir) "
          f"on {card}: {n} steps in {wall:.1f}s ({wall * 1e3 / n:.1f} ms/step), healthy "
          f"{rep['healthy']}; against {DURABLE_PIN} \"localtester\": "
          f"{'equal' if not differ else 'differs on ' + str(differ)}", flush=True)
    if differ or not rep["healthy"]:
        failed.append(f"phase 10c: the local tester differs from the pin on {differ} "
                      f"or is not healthy")
    free_card()
    for f in failed:
        print(f"phase 10 FAILED: {f}", flush=True)
    return failed


def lane_timings(session, n: int = 20) -> dict:
    """ms a call of RawNode.step (a follower's MsgHeartbeatResp to a leader),
    tick (the leader's) and advance (one committed proposal) on a lane at
    test_rawnode.py's Spec on the card, each the mean of ``n`` calls after a
    first one (which, from the graphs, is the warm-up and capture): {name:
    (first ms, mean ms)}; inside ``eager_lanes()`` the calls run eagerly. A
    call returns host memory, so it includes the card's work."""
    from etcd_tpu_torch.models.rawnode import HostMsg
    from etcd_tpu_torch.types import MSG_APP_RESP, MSG_HEARTBEAT_RESP, MSG_VOTE_RESP

    p = session.port_package(None)
    spec, cfg = p.Spec(**session.RAWNODE_SPEC), p.RaftConfig(**session.RAWNODE_CFG)
    rn, s = session._boot(p, spec, cfg)
    rn.campaign()
    for q in (1, 2):
        rn.step(HostMsg(type=MSG_VOTE_RESP, to=0, frm=q, term=rn.n.term))
    rd = rn.ready()
    session._persist(s, rd)
    rn.advance(rd)

    def clock(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    def committed():
        rn.propose(7)
        for q in (1, 2):
            rn.step(HostMsg(type=MSG_APP_RESP, to=0, frm=q, term=rn.n.term,
                            index=rn.n.last_index))
        return rn.ready()

    out = {}
    for name, prep, call in (
            ("step", lambda: None, lambda _: rn.step(HostMsg(
                type=MSG_HEARTBEAT_RESP, to=0, frm=1, term=rn.n.term))),
            ("tick", lambda: None, lambda _: rn.tick()),
            ("advance", committed, lambda rd: rn.advance(rd))):
        times = []
        for _ in range(n + 1):
            arg = prep()
            times.append(clock(lambda: call(arg)))
            rn.ready()
        out[name] = (times[0], sum(times[1:]) / n)
    return out


def process_message_ops(session, n: int = 20):
    """The tensor ops (one kernel each on the card) of one process_message
    on a lane at test_rawnode.py's Spec, and ms a replay of its CUDA graph
    (the mean of ``n`` after the capture): the lane's function, which
    handles every message type, and, for comparison only, the function
    specialized by RaftConfig.message_classes to one message type alone
    (which no RawNode runs: a handler left out can leave lane state that a
    later message of another type reads). Returns {label: (ops, ms)}."""
    import dataclasses

    import numpy as np
    import torch

    from etcd_tpu_torch.models import rawnode
    from etcd_tpu_torch.types import MSG_APP, MSG_APP_RESP, MSG_HEARTBEAT, MSG_PROP, Spec
    from etcd_tpu_torch.utils.config import RaftConfig

    spec = Spec(**session.RAWNODE_SPEC)
    cfg = RaftConfig(**session.RAWNODE_CFG)
    p = session.port_package(None)
    with rawnode.eager_lanes():
        rn, _ = session._boot(p, spec, cfg)
        rn.campaign()
    dev = torch.device("cuda")
    out = {}
    for label, mtype in (("generic", None), ("MsgApp only", MSG_APP),
                         ("MsgAppResp only", MSG_APP_RESP),
                         ("MsgHeartbeat only", MSG_HEARTBEAT), ("MsgProp only", MSG_PROP)):
        c = cfg if mtype is None else dataclasses.replace(
            cfg, local_steps=(), message_classes=(mtype,))
        fn = rawnode.LaneFunction(c, spec, "step", dev, True)
        hm = rawnode.HostMsg(type=MSG_APP_RESP if mtype is None else mtype, to=0,
                             frm=1, term=1, index=2)
        host = np.concatenate([rn.n.w, rawnode.msg_words(spec, hm)])
        words = torch.from_numpy(host).to(dev)
        fn.fn(words)                                  # warm
        _, ops = count_ops(lambda: fn.fn(words))
        fn(host)                                      # the capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(host)
        out[label] = (ops, (time.perf_counter() - t0) * 1e3 / n)
    return out


def phase_rawnode(card, packed=None):
    """Phase 11, RawNode and its storage on the card, each part held to the
    JAX package's records in RAWNODE_PIN.json (etcd_tpu_torch/harness/
    rawnode_session.py's scripts): (a) raftexample (tests/test_raftexample.py's
    operations on one Cluster(3) and main()); (b) the RawNode and
    flow-control Ready sequences (tests/test_rawnode.py,
    tests/test_flow_control.py, the RecordingStorage drive), both once from
    the lane graphs and once eagerly, graph == eager; (c) InteractionEnv on
    every script of tests/interaction_scripts/, text equal; (d) a RawNode
    group persisted through the WAL in a temporary directory, torn, dropped,
    replayed into fresh MemoryStorages and rebooted: the read-back and the
    segment digests; (e) save_fleet and load_fleet of phase 5's fleet at its
    width (C = 131,072; ``packed``, or a fleet settled here when phase 5 did
    not run), unpacked to a dense NodeState, every leaf equal after
    the round trip, with the file's size and the save and load times. Prints
    ms per lane step, tick and apply call (graph and eager) and the tensor
    ops and graph ms of one process_message (process_message_ops). Returns
    the failures."""
    import contextlib
    import tempfile

    import torch

    from etcd_tpu_torch import drive
    from etcd_tpu_torch.harness import rawnode_session as session
    from etcd_tpu_torch.models.rawnode import eager_lanes
    from etcd_tpu_torch.models.engine import empty_inbox, init_fleet
    from etcd_tpu_torch.models.state import unpack_fleet
    from etcd_tpu_torch.storage.checkpoint import load_fleet, save_fleet

    pin = json.loads(session.PIN.read_text())
    failed = []

    def check(part, got, want):
        got = json.loads(json.dumps(got))
        if got != want:
            failed.append(f"phase {part}: differs from {session.PIN.name}")
        return got == want

    results = {}
    p = session.port_package(None)
    for mode, within in (("graph", contextlib.nullcontext), ("eager", eager_lanes)):
        t0 = time.perf_counter()
        with within():
            ex = session.run_raftexample(p)
            t1 = time.perf_counter()
            rn = {name: session.run_rawnode(p, name) for name in session.RAWNODE_SCRIPTS}
        t2 = time.perf_counter()
        results[mode] = (ex, rn)
        ok_a = check("11a", ex, pin["raftexample"])
        ok_b = check("11b", rn, pin["rawnode"])
        print(f"phase 11a raftexample ({mode}) on {card}: {len(ex['ops'])} operations "
              f"in {t1 - t0:.1f}s; against {session.PIN.name}: "
              f"{'equal' if ok_a else 'DIFFERS'}; main printed {ex['main']!r}", flush=True)
        print(f"phase 11b RawNode and flow-control Ready sequences ({mode}): "
              f"{len(rn)} scripts, {sum(len(v) for v in rn.values())} records in "
              f"{t2 - t1:.1f}s; against {session.PIN.name}: "
              f"{'equal' if ok_b else 'DIFFER on ' + str([k for k in rn if json.loads(json.dumps(rn[k])) != pin['rawnode'][k]])}",
              flush=True)
    same = json.loads(json.dumps(results["graph"])) == json.loads(json.dumps(results["eager"]))
    if not same:
        failed.append("phase 11a/11b: graph != eager")
    print(f"phase 11a/11b graph == eager: {same}", flush=True)

    t0 = time.perf_counter()
    differ = [name for name in session.interaction_names()
              if session.run_interaction(p, name) != pin["interaction"][name]]
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        group = session.run_wal_group(p, d)
    t2 = time.perf_counter()
    print(f"phase 11c InteractionEnv on {len(session.interaction_names())} scripts "
          f"(graph) in {t1 - t0:.1f}s; text against {session.PIN.name}: "
          f"{'equal' if not differ else 'differs on ' + str(differ)}", flush=True)
    if differ:
        failed.append(f"phase 11c: the interaction text differs on {differ}")
    ok_d = check("11d", group, pin["wal_group"])
    print(f"phase 11d a RawNode group through the WAL ({len(group['files'])} segments, "
          f"torn, replayed, rebooted) in {t2 - t1:.1f}s; read-back and segment sha256 "
          f"against {session.PIN.name}: {'equal' if ok_d else 'DIFFER'} (rebooted "
          f"applied {[v['applied'] for v in group['reboot'].values()]})", flush=True)
    for mode, within in (("graph", contextlib.nullcontext), ("eager", eager_lanes)):
        with within():
            ms = lane_timings(session)
        print(f"phase 11 lane calls ({mode}) on {card}, ms a call at test_rawnode.py's "
              f"Spec, the mean of 20 after the first: " + ", ".join(
                  f"{k} {v[1]:.3f} (first {v[0]:.1f})" for k, v in ms.items()), flush=True)
    ops = process_message_ops(session)
    print(f"phase 11 process_message at test_rawnode.py's Spec on {card}, tensor ops "
          f"(kernels on the card) and ms a graph replay (the mean of 20 after the "
          f"capture): the lane's function (every message type) and, for comparison "
          f"only, specialized to one type: " + ", ".join(
              f"{k} {v[0]} ops {v[1]:.3f} ms" for k, v in ops.items()), flush=True)
    free_card()

    spec = drive.bench_spec()
    if packed is None:      # phase 5 did not run: settle a fleet of its width
        C, cfg = FULL_GROUPS // 8, drive.settle_config(spec)
        dense, _, _ = drive.settle_leaders(
            cfg, spec, init_fleet(spec, C, device="cuda"),
            empty_inbox(spec, C, cfg.wire_int16, cfg.inbox_bound, device="cuda"),
            device="cuda")
        source = "a settled fleet (phase 5 did not run)"
    else:
        dense = unpack_fleet(spec, packed.map(lambda _, x: x.cuda()))
        source = "phase 5's fleet, unpacked"
    del packed
    C = dense.term.shape[-1]
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/fleet.npz"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_fleet(path, dense, round_no=11)
        t1 = time.perf_counter()
        back, meta = load_fleet(path)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        size = pathlib.Path(path).stat().st_size
    bad = leaves_equal(dense, back) + ([] if meta["round"] == 11 else ["meta"])
    dense_bytes = sum(x.numel() * x.element_size() for _, x in dense.items())
    print(f"phase 11e save_fleet/load_fleet of {source} (C = {C}, dense NodeState "
          f"{dense_bytes / 2**20:.1f} MiB) on {card}: file {size / 2**20:.1f} MiB, "
          f"save {t1 - t0:.2f}s, load to the card {t2 - t1:.2f}s; every leaf equal "
          f"after the round trip: {not bad} {bad or ''}", flush=True)
    if bad:
        failed.append(f"phase 11e: the fleet round trip differs on {bad}")
    del dense, back
    free_card()
    for f in failed:
        print(f"phase 11 FAILED: {f}", flush=True)
    return failed


def phase_tester_default(card):
    """Phase 10d (only with ``--phases 10d``, a call of its own): the local
    tester at its defaults with a data dir (``python -m
    etcd_tpu_torch.localtester --data-dir D``: 4 cycles, 3 members, 8 puts a
    phase, seed 0), its report and steps held to DURABLE_SESSION_PIN.json's
    "localtester_default", healthy, and its wall time. Returns the
    failures."""
    import tempfile

    import torch

    from etcd_tpu_torch import localtester

    with open(DURABLE_PIN) as f:
        want = json.load(f)["localtester_default"]
    with tempfile.TemporaryDirectory() as d:
        restore = counted_steps()
        t0 = time.perf_counter()
        try:
            rep = localtester.run_local_tester(data_dir=d)
            torch.cuda.synchronize()
        finally:
            n = restore()
        wall = time.perf_counter() - t0
    differ = pin_differ(rep, want["report"])
    if n != want["steps"]:
        differ.append(f"steps {n} != {want['steps']}")
    print(json.dumps(rep), flush=True)
    print(f"phase 10d the local tester at its defaults with a data dir on {card}: {n} "
          f"steps in {wall:.1f}s ({wall * 1e3 / n:.1f} ms/step), healthy {rep['healthy']}; "
          f"against {DURABLE_PIN} \"localtester_default\": "
          f"{'equal' if not differ else 'differs on ' + str(differ)}", flush=True)
    failed = []
    if differ or not rep["healthy"]:
        failed.append(f"phase 10d: the local tester differs from the pin on {differ} "
                      f"or is not healthy")
        print(f"phase 10d FAILED: {failed[0]}", flush=True)
    return failed


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


PHASES = ("1", "2", "3", "4", "5", "6", "7a", "7b", "8", "9", "10", "11")
# phases that run only when named in --phases
EXTRA_PHASES = ("9c", "10d")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile two steady rounds of phase 3, the "
                    "full-width graph replay of two chaos fault rounds (phase 6), "
                    "and two KV rounds of phase 8 (graph replay and eager)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="the phases to run, comma-separated (default: all but 9c and "
                    "10d, which run only when named; phase 5 needs 4); the kernels and "
                    "result lines print only when all run")
    args = ap.parse_args(argv)
    want = args.phases.split(",")
    known = PHASES + EXTRA_PHASES
    if set(want) - set(known):
        ap.error(f"unknown phases {sorted(set(want) - set(known))}; known {known}")

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
        phase_kv_small()
        done(2)
    if "3" in want:
        phase_full(smi, args.profile)
        free_card()
        done(3)
    if "4" in want or "5" in want:
        res, launches = phase_bench(smi)
        done(4)
        if "5" in want:
            records["carry"], records["fleet"] = phase_compare(res, smi)
            done(5)
        del res
        free_card()
    paths = {}
    for phase, kw in (("6", dict(profiled=PROFILED_CHAOS, full_profile=args.profile)),
                      ("7a", dict(time_kernel=True)),
                      ("7b", dict(rounds=50, lens=(25, 25), time_kernel=True, warm_rounds=2,
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
    if "8" in want:
        records["served"], served_failed = phase_served(smi, args.profile)
        failed += served_failed
        done(8)
    if "9" in want:
        failed += phase_server(smi)
        done(9)
    if "9c" in want:
        failed += phase_default_run(smi)
        done("9c")
    if "10" in want:
        failed += phase_durable(smi)
        done(10)
    if "10d" in want:
        failed += phase_tester_default(smi)
        done("10d")
    if "11" in want:
        failed += phase_rawnode(smi, records.pop("fleet", None))
        done(11)
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
    kernels.append(records["served"])
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
