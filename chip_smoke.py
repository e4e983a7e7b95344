#!/usr/bin/env python3
"""Smoke run of the PyTorch port (etcd_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each printing one line:
  0. the card (torch and nvidia-smi's name and power limit);
  1. the compaction kernel: built from etcd_tpu_torch/kernels/compact_wire.cu,
     launched on seeded random inputs (about 40% of slots nonempty) at the
     bench geometry (C = 1,048,576 groups, S = 10 sender slots, 5 receivers,
     bound 4, E = 1, plus an E = 2 case at C = 262,144), and held bit for
     bit against its plain PyTorch version, with both times (median of 25
     launches, CUDA events);
  2. the kernel inside the round: settle + 16 steady rounds at C = 64 on the
     card and on the CPU plain path, every state and wire leaf equal;
  3. the slice at full width: init_fleet, settle_leaders and 16
     steady_rounds at C = 1,048,576 groups (bench.py's north-star fleet)
     with the kernel launch count read around that run, the commit
     advance and hash-chain checks, group-rounds/s and peak memory.
Then a line with the kernels' JSON record, nvidia-smi's name and power limit,
and last {"ok": true, "device": {...}}. Any failure exits non-zero before the
last line. Needs a CUDA device; the port imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

FULL_GROUPS = 1_048_576
HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12       # float32 rate outside the tensor cores, used for 32-bit ops
KERNEL_SOURCE = "etcd_tpu_torch/kernels/compact_wire.cu"
KERNEL_REPLACES = "experiments/pallas_compact.py:59"


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n=25, warmup=3):
    """Median time of ``n`` calls of ``fn`` on the current stream, ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
    """Bytes the compaction must move for these inputs: the type plane, the
    surviving slots of every other leaf, and the outputs."""
    import torch

    from etcd_tpu_torch.types import ENT_FIELDS

    M, K, E = spec.M, spec.K, spec.E
    S, C = M * K, msgs.type.shape[-1]
    B = min(bound, S)
    kept = int(torch.clamp((msgs.type.reshape(S, M, C) != 0).sum(0), max=B).sum())
    total = msgs.type.numel() * 4
    for name, x in msgs.items():
        e = E if name in ENT_FIELDS else 1
        item = 1 if name == "reject" else 4
        out_item = 1 if name == "reject" else out_itemsize
        if name != "type":
            total += kept * e * item
        total += B * M * C * e * out_item
    return total


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
    out = torch.int16            # the main path's int16 wire
    record, err = None, 0
    for E, C in ((1, FULL_GROUPS), (2, FULL_GROUPS // 4)):
        sp = Spec(M=spec.M, L=spec.L, E=E, K=spec.K, W=spec.W, R=spec.R, A=spec.A)
        msgs = random_outbox(sp, C, gen, dev)
        got = cw.compact_wire_carry(sp, msgs, bound, out)
        ref = cw.compact_wire_carry_plain(sp, msgs, bound, out)
        torch.cuda.synchronize()
        bad = leaves_equal(got, ref)
        err = max(err, max_abs_err(got, ref))
        if bad or err:
            raise AssertionError(f"kernel != plain at E={E} C={C}: {bad}, "
                                 f"max abs err {err}")
        del got, ref
        print(f"phase 1 E={E} C={C}: kernel == plain bit for bit (int16 wire), "
              f"max abs err {err}")
        if E == 1:
            ms = time_ms(lambda: cw.compact_wire_carry(sp, msgs, bound, out))
            plain_ms = time_ms(lambda: cw.compact_wire_carry_plain(sp, msgs, bound, out))
            nbytes = needed_bytes(sp, msgs, bound, 2)
            S = sp.M * sp.K
            ops = sp.M * C * (2 * S + 17 * bound)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / INT32_OPS_PER_S * 1e3
            record = {
                "name": "compact_wire", "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": KERNEL_REPLACES, "launches": None, "max_abs_err": None,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": None,
            }
            print(f"phase 1 time C={C}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"{nbytes / 1e9:.3f} GB needed -> {nbytes / ms / 1e6:.1f} GB/s, "
                  f"bound {record['bound_ms']:.4f} ms ({record['bound_by']})")
        del msgs
    torch.cuda.empty_cache()
    record["max_abs_err"] = err
    return record


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


def phase_round():
    import torch

    from etcd_tpu_torch import drive

    spec = drive.bench_spec()
    gs, gi, r1, _ = run_slice(spec, 64, "cuda")
    cs, ci, r2, _ = run_slice(spec, 64, "cpu")
    bad = leaves_equal(gs, cs) + leaves_equal(gi, ci)
    if bad or r1 != r2:
        raise AssertionError(f"card run != CPU run at C=64: {bad}, rounds {r1} vs {r2}")
    torch.cuda.synchronize()
    print(f"phase 2 C=64: settle ({r1} rounds) + 16 steady rounds, card (kernel) == "
          "CPU (plain) on every state and wire leaf")


def phase_full(card, profile=False):
    import torch

    from etcd_tpu_torch import drive
    from etcd_tpu_torch.kernels import LAUNCHES, reset_launches
    from etcd_tpu_torch.models.engine import empty_inbox, init_fleet

    groups = FULL_GROUPS
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
        profile_steady(drive.steady_config(cfg), spec, state, inbox, card)
    return launches


# functions whose device time the profile reports as named ranges
PROFILED = (("etcd_tpu_torch.models.raft", "process_message"),
            ("etcd_tpu_torch.utils.prng", "threefry2x32"),
            ("etcd_tpu_torch.models.raft", "apply_round"),
            ("etcd_tpu_torch.models.engine", "compact_wire_carry"))


def profile_steady(cfg, spec, state, inbox, card, rounds=2):
    """Where a steady round's time goes: device busy time against wall time
    over ``rounds`` rounds, the device time under a few named functions
    (process_message includes the threefry draws), and the kernels that
    take most of it."""
    import importlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from etcd_tpu_torch import drive

    def ranged(name, fn):
        def call(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return call

    saved = []
    for mod_name, fn_name in PROFILED:
        mod = importlib.import_module(mod_name)
        saved.append((mod, fn_name, getattr(mod, fn_name)))
        setattr(mod, fn_name, ranged(fn_name, getattr(mod, fn_name)))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            drive.steady_rounds(cfg, spec, state, inbox, rounds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)
    events = prof.key_averages()
    ranges = {n for _, n in PROFILED}
    # the named ranges show on the device timeline as spans from their
    # first to their last kernel; only kernels count as busy time
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.key not in ranges]
    busy_us = sum(e.self_device_time_total for e in kernels)
    count = sum(e.count for e in kernels)
    print(f"profile {rounds} steady rounds on {card}: wall {wall * 1e3 / rounds:.2f} ms/round, "
          f"device busy {busy_us / 1e3 / rounds:.2f} ms/round "
          f"(idle share {1 - busy_us / 1e6 / wall:.3f}), "
          f"{count / rounds:.0f} kernel launches/round")
    spans = {e.key: e for e in events
             if e.key in ranges and e.device_type == DeviceType.CUDA}
    print("profile device span ms/round of: " + ", ".join(
        f"{n} {spans[n].device_time_total / 1e3 / rounds:.2f} ({spans[n].count // rounds}x)"
        for _, n in PROFILED if n in spans))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile   {e.self_device_time_total / 1e3 / rounds:9.3f} ms/round "
              f"{e.count // rounds:6d}x  {e.key[:150]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile two steady rounds of phase 3")
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
    record = phase_kernel()
    sys.stdout.flush()
    phase_round()
    sys.stdout.flush()
    launches = phase_full(smi, args.profile)
    record["launches"] = launches.get("compact_wire", 0)
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
