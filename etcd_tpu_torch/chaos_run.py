"""The chaos driver on the port: ``python -m etcd_tpu_torch.chaos_run``.

The counterpart of chaos_run.py (BASELINE config #5: the functional tester's
network, crash-restart and membership fault cases at fleet scale):
CHAOS_C groups x CHAOS_ROUNDS rounds of drop, delay and partition faults,
with CHAOS_CRASH > 0 crash-restart faults and with CHAOS_MEMBER > 0
membership faults, with the safety checks every round
(etcd_tpu_torch/harness/chaos.py), in fault epochs of 50 rounds and heal
epochs of 25, then one JSON line with the violation counts, the crash and
membership counters, the liveness figures, the flight recorder's timeline
and telemetry report, with the black box the forensics section, and the
verdicts of ``summarize_chaos``. It exits 0 when the run is safe, recovered
and lively.

    CHAOS_C=262144 CHAOS_CRASH=0.01 python -m etcd_tpu_torch.chaos_run
    CHAOS_C=1048576 CHAOS_MEMBER=0.05 CHAOS_CRASH=0.005 CHAOS_SNAP_BOOST=200 \
        CHAOS_MEMBER_BOOST=4 python -m etcd_tpu_torch.chaos_run

The knobs, their defaults and their checks are chaos_run.py's: CHAOS_C
(262,144 on the card, 1,000 on the CPU), CHAOS_ROUNDS, CHAOS_DROP,
CHAOS_DELAY, CHAOS_PART, CHAOS_SEED, CHAOS_L, CHAOS_BOUND, CHAOS_WIRE16,
CHAOS_CHUNKS (131,072-group chunks above 262,144 groups on the card),
CHAOS_SYNC and CHAOS_LIVENESS_FRAC (0.2, or 0.1 under the membership tier);
the crash tier's CHAOS_CRASH, CHAOS_DOWN (3) and CHAOS_DURABILITY (stable,
or none: the broken persist-nothing model, which must trip the
leader-completeness checker); the membership tier's CHAOS_MEMBER,
CHAOS_MEMBER_MIX (standard, simple, shrink), CHAOS_INIT_VOTERS (3 under the
tier, else 0), CHAOS_SNAP_BOOST and CHAOS_MEMBER_BOOST (1 = uniform crash
scheduling) and CHAOS_CONFIG_AWARE (0: the config-blind checkers); the
telemetry plane's TELEM (1), TELEM_BUCKETS (8, in 2..16) and TELEM_EVERY
(1: a timeline row at every epoch boundary); the black box's CHAOS_BLACKBOX
(0), CHAOS_BLACKBOX_K (4 groups decoded) and CHAOS_BLACKBOX_WINDOW (32
rounds, in 2..256). The membership tier runs on the int32 wire (its words
use bits 16-20): an explicit CHAOS_WIRE16=1 beside it exits 2. The tiers
the port does not run yet exit 2 unless left off: CHAOS_LEASE=0,
APPLY_KEYS=0, CHAOS_PRNG=threefry, and ``--preflight``.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

from etcd_tpu_torch.harness.chaos import run_chaos, summarize_chaos
from etcd_tpu_torch.types import Spec
from etcd_tpu_torch.utils.config import CrashConfig, MemberChaosConfig, RaftConfig
from etcd_tpu_torch.utils.device import resolve_device
from etcd_tpu_torch.utils.knobs import env_bool, env_float, env_int, knob_error

PROG = "chaos_run"
EPOCH_LEN, HEAL_LEN = 50, 25

# knobs of chaos_run.py whose tier the port does not run: only "off" is taken
OFF_KNOBS = {"CHAOS_LEASE": "0", "APPLY_KEYS": "0", "CHAOS_PRNG": "threefry"}
M = 5      # chaos_run.py's member count


def read_knobs(environ=None, on_card: bool = True) -> dict:
    """The CHAOS_* knobs, validated before any device work (exit 2)."""
    env = os.environ if environ is None else environ
    for name, off in OFF_KNOBS.items():
        if name in env and env[name] != off and not _is_zero(env[name]):
            knob_error(PROG, f"{name}={env[name]!r}: etcd_tpu_torch does not run "
                             f"this tier yet; set {name}={off}")
    k = {
        "drop_p": env_float(PROG, "CHAOS_DROP", "0.02", 0.0, 1.0, environ=env),
        "delay_p": env_float(PROG, "CHAOS_DELAY", "0.05", 0.0, 1.0, environ=env),
        "partition_p": env_float(PROG, "CHAOS_PART", "0.1", 0.0, 1.0, environ=env),
        "crash_p": env_float(PROG, "CHAOS_CRASH", "0", 0.0, 1.0, environ=env),
        "member_p": env_float(PROG, "CHAOS_MEMBER", "0", 0.0, 1.0, environ=env),
    }
    member_on = k["member_p"] > 0
    snap_boost = env_float(PROG, "CHAOS_SNAP_BOOST", "1", 1.0, environ=env)
    member_boost = env_float(PROG, "CHAOS_MEMBER_BOOST", "1", 1.0, environ=env)
    # the membership tier's conscious liveness floor: joint configs need
    # both halves to commit, and partial-voter boots leave smaller minorities
    k["liveness_frac"] = env_float(PROG, "CHAOS_LIVENESS_FRAC",
                                   "0.1" if member_on else "0.2", 0.0, 1.0, environ=env)
    init_voters = env_int(PROG, "CHAOS_INIT_VOTERS", "3" if member_on else "0",
                          environ=env)
    down_rounds = env_int(PROG, "CHAOS_DOWN", "3", environ=env)
    try:
        crash = CrashConfig(down_rounds=down_rounds,
                            durability=env.get("CHAOS_DURABILITY", "stable"))
        k["member"] = MemberChaosConfig(
            mix=env.get("CHAOS_MEMBER_MIX", "standard"), initial_voters=init_voters,
            snap_crash_boost=snap_boost, member_crash_boost=member_boost)
    except ValueError as e:
        knob_error(PROG, str(e))
    k["crash"] = crash if k["crash_p"] > 0 else None
    k["seed"] = env_int(PROG, "CHAOS_SEED", "0", environ=env)
    k["config_aware"] = env_bool(PROG, "CHAOS_CONFIG_AWARE", "1", environ=env)
    # the telemetry plane and flight recorder (on by default), the black box
    # (off: its ring is a [W, M, C] int32 buffer on the device)
    k["telemetry"] = env_bool(PROG, "TELEM", "1", environ=env)
    k["telemetry_buckets"] = env_int(PROG, "TELEM_BUCKETS", "8", 2, environ=env, hi=16)
    k["telemetry_every"] = env_int(PROG, "TELEM_EVERY", "1", 1, environ=env)
    k["blackbox"] = env_bool(PROG, "CHAOS_BLACKBOX", "0", environ=env)
    k["blackbox_k"] = env_int(PROG, "CHAOS_BLACKBOX_K", "4", 1, environ=env)
    k["blackbox_window"] = env_int(PROG, "CHAOS_BLACKBOX_WINDOW", "32", 2, environ=env,
                                   hi=256)
    k["sync"] = env_bool(PROG, "CHAOS_SYNC", "0", environ=env)
    wire16 = env_bool(PROG, "CHAOS_WIRE16", "1", environ=env)
    if member_on and "CHAOS_WIRE16" in env and wire16:
        knob_error(PROG, "CHAOS_MEMBER needs the int32 wire (conf-change words "
                         "use bits 16-20); unset CHAOS_WIRE16")
    if init_voters > M:
        knob_error(PROG, f"CHAOS_INIT_VOTERS={init_voters} exceeds the member "
                         f"count M={M}")
    k["wire16"] = wire16 and not member_on
    C = env_int(PROG, "CHAOS_C", "262144" if on_card else "1000", 1, environ=env)
    k["C"] = C
    k["rounds"] = env_int(PROG, "CHAOS_ROUNDS", "200", 1, environ=env)
    k["L"] = env_int(PROG, "CHAOS_L", "16", 1, environ=env)
    k["bound"] = env_int(PROG, "CHAOS_BOUND", "4", 0, environ=env)
    k["chunks"] = env_int(
        PROG, "CHAOS_CHUNKS",
        str(max(1, C // 131072)) if on_card and C > 262144 else "1", 1, environ=env)
    return k


def _is_zero(raw: str) -> bool:
    try:
        return float(raw) == 0
    except ValueError:
        return False


def spec_and_config(k: dict) -> tuple[Spec, RaftConfig]:
    """chaos_run.py's geometry: bench.py's Spec at CHAOS_L, and the full
    program with pre-vote, check-quorum, the inbox bound and the int16
    wire, int32 under the membership tier (chaos_run.py:200-230)."""
    spec = Spec(M=M, L=k["L"], E=1, K=2, W=4, R=2, A=2)
    cfg = RaftConfig(pre_vote=True, check_quorum=True, max_inflight=4,
                     inbox_bound=k["bound"], coalesce_commit_refresh=True,
                     wire_int16=k["wire16"], fleet_chunks=k["chunks"])
    return spec, cfg


PLANE_KNOBS = ("telemetry", "telemetry_buckets", "telemetry_every", "blackbox",
               "blackbox_window", "blackbox_k")


def fault_kwargs(k: dict) -> dict:
    """run_chaos's fault-mix and plane arguments at the knobs ``k``."""
    return dict(seed=k["seed"], drop_p=k["drop_p"], delay_p=k["delay_p"],
                partition_p=k["partition_p"], crash_p=k["crash_p"], crash=k["crash"],
                member_p=k["member_p"], member=k["member"],
                config_aware=k["config_aware"], **{n: k[n] for n in PLANE_KNOBS})


def run(k: dict, device=None, end=None) -> dict:
    """One chaos run at the knobs ``k``; the JSON line's dict."""
    dev = resolve_device(device)
    spec, cfg = spec_and_config(k)
    t0 = time.perf_counter()
    rep = run_chaos(spec, cfg, C=k["C"], rounds=k["rounds"], epoch_len=EPOCH_LEN,
                    heal_len=HEAL_LEN, sync_dispatch=k["sync"], device=dev, end=end,
                    **fault_kwargs(k))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rep["elapsed_s"] = round(time.perf_counter() - t0, 1)
    rep["platform"] = "gpu" if dev.type == "cuda" else dev.type
    rep.update(summarize_chaos(rep, rounds=k["rounds"], epoch_len=EPOCH_LEN,
                               heal_len=HEAL_LEN, liveness_frac=k["liveness_frac"]))
    # the lease and KV apply-plane tiers are off (OFF_KNOBS): their gates
    # hold vacuously, as in chaos_run.py with CHAOS_LEASE=0 and APPLY_KEYS=0
    rep["lease_safe"] = True
    rep["apply_parity_ok"] = True
    return rep


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv:
        knob_error(PROG, f"unknown argument(s): {' '.join(argv)} (etcd_tpu_torch's "
                         "chaos_run takes none, --preflight included; configure via "
                         "CHAOS_* knobs)")
    on_card = device is None or torch.device(device).type == "cuda"
    k = read_knobs(on_card=on_card)
    rep = run(k, device)
    print(json.dumps(rep), flush=True)
    if on_card:
        print(f"{PROG}: peak device memory {torch.cuda.max_memory_allocated()} B "
              "(torch.cuda.max_memory_allocated over the whole run)", file=sys.stderr)
    ok = rep["safe"] and rep["recovered"] and rep["lively"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
