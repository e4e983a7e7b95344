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
verdicts of ``summarize_chaos``. Then, with CHAOS_LEASE=1 (the default, as
chaos_run.py:189), the host-layer lease and runner tiers
(etcd_tpu_torch/harness/chaos_lease.py) run in a subprocess on the same
device, under chaos_run.py's 1,800 s limit, after the device tier's fleet is
freed; their report joins the line and folds into ``lease_safe`` as
chaos_run.py folds it (a failed or timed-out tier gives ``lease_safe`` false
and ``lease_tier_error``). It exits 0 when the run is safe, recovered and
lively, and the lease and apply gates hold.

    python -m etcd_tpu_torch.chaos_run
    CHAOS_LEASE=0 CHAOS_C=262144 CHAOS_CRASH=0.01 python -m etcd_tpu_torch.chaos_run
    CHAOS_LEASE=0 CHAOS_C=1048576 CHAOS_MEMBER=0.05 CHAOS_CRASH=0.005 \
        CHAOS_SNAP_BOOST=200 CHAOS_MEMBER_BOOST=4 python -m etcd_tpu_torch.chaos_run

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
rounds, in 2..256); the KV apply-plane tier's APPLY_KEYS (0: off, else the
key space, up to 511), APPLY_GROUPS (256) and APPLY_OPS (200), which runs
the device-vs-host differential parity pass (device_mvcc/fuzz.py) after
the chaos run and adds ``kv_plane`` and the ``apply_parity_ok`` gate to the
JSON line:

    CHAOS_LEASE=0 APPLY_KEYS=64 APPLY_GROUPS=256 APPLY_OPS=200 \
        python -m etcd_tpu_torch.chaos_run

The membership tier runs on the int32 wire (its words use bits 16-20): an
explicit CHAOS_WIRE16=1 beside it exits 2. The tiers the port does not run
yet exit 2 unless left off: CHAOS_PRNG=threefry and ``--preflight``.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import torch

from etcd_tpu_torch.device_mvcc import KVSpec
from etcd_tpu_torch.device_mvcc.fuzz import differential_run
from etcd_tpu_torch.harness.chaos import run_chaos, summarize_chaos
from etcd_tpu_torch.types import Spec
from etcd_tpu_torch.utils.config import CrashConfig, MemberChaosConfig, RaftConfig
from etcd_tpu_torch.utils.device import resolve_device
from etcd_tpu_torch.utils.knobs import env_bool, env_float, env_int, knob_error

PROG = "chaos_run"
EPOCH_LEN, HEAL_LEN = 50, 25

# knobs of chaos_run.py whose tier the port does not run: only "off" is taken
OFF_KNOBS = {"CHAOS_PRNG": "threefry"}
M = 5      # chaos_run.py's member count
# the lease tier's subprocess limit (chaos_run.py:309)
LEASE_TIER_TIMEOUT_S = 1800


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
    # the KV apply-plane tier (chaos_run.py:168-175); APPLY_KEYS caps at the
    # 9-bit op-word key field
    k["apply_keys"] = env_int(PROG, "APPLY_KEYS", "0", 0, environ=env, hi=511)
    k["apply_groups"] = env_int(PROG, "APPLY_GROUPS", "256", 1, environ=env)
    k["apply_ops"] = env_int(PROG, "APPLY_OPS", "200", 1, environ=env)
    k["sync"] = env_bool(PROG, "CHAOS_SYNC", "0", environ=env)
    k["lease_tier"] = env_bool(PROG, "CHAOS_LEASE", "1", environ=env)
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


def lease_tier_argv(seed: int, dev) -> list[str]:
    """The lease tier's command (chaos_run.py:300-309): the port's
    chaos_lease entry point at the run's seed, on the run's device."""
    argv = [sys.executable, "-m", "etcd_tpu_torch.harness.chaos_lease",
            "--seed", str(seed)]
    return argv if dev.type == "cuda" else argv + ["--device", str(dev)]


def lease_tier(seed: int, dev) -> dict:
    """The lease and runner tiers in a subprocess, folded as chaos_run.py
    folds them (chaos_run.py:296-335): their report and ``lease_safe``, or
    on any failure (an exit code, no JSON line, a timeout) ``lease_safe``
    false and ``lease_tier_error``."""
    try:
        out = subprocess.run(lease_tier_argv(seed, dev), capture_output=True,
                             text=True, timeout=LEASE_TIER_TIMEOUT_S)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if out.returncode != 0 or not lines:
            raise RuntimeError((out.stderr or out.stdout)[-500:])
        lrep = json.loads(lines[-1])
        lease_safe = (not lrep["lease_violations"]
                      and not lrep.get("lease_gate_failures")
                      and lrep["runner_exclusion_violations"] == 0
                      and lrep["runner_final_progress"])
        return {**lrep, "lease_safe": lease_safe}
    except Exception as e:  # noqa: BLE001 (the device tier's results stay)
        return {"lease_safe": False, "lease_tier_error": f"{type(e).__name__}: {e}"[-500:]}


def run(k: dict, device=None, end=None) -> dict:
    """One chaos run at the knobs ``k``, then (CHAOS_LEASE=1) the lease
    tier and (APPLY_KEYS > 0) the KV apply-plane tier; the JSON line's
    dict. With CHAOS_LEASE=0 the lease tier does not run and ``lease_safe``
    is true, as the reference sets it for that knob."""
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
    if k["lease_tier"]:
        # the device tier's fleet and graphs go before the tier's own
        # process takes the card
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rep.update(lease_tier(k["seed"], dev))
    else:
        # CHAOS_LEASE=0: the reference's gate for a skipped lease tier
        rep["lease_safe"] = True
    # the KV apply-plane tier (chaos_run.py:333-357): the device revision
    # store against per-schedule host MVCCStore replays on this device; a
    # failure of the tier keeps the chaos results and fails the gate
    if k["apply_keys"] > 0:
        try:
            rep["kv_plane"] = differential_run(
                KVSpec(keys=k["apply_keys"]), groups=k["apply_groups"],
                ops=k["apply_ops"], seed=k["seed"], device=dev)
            rep["apply_parity_ok"] = rep["kv_plane"]["parity_ok"]
        except Exception as e:  # noqa: BLE001 (reported, and fails the exit code)
            rep["apply_parity_ok"] = False
            rep["kv_plane_error"] = f"{type(e).__name__}: {e}"[-500:]
    else:
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
    ok = (rep["safe"] and rep["recovered"] and rep["lively"] and rep["lease_safe"]
          and rep["apply_parity_ok"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
