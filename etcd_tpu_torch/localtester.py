"""Local tester: a fault-injected live cluster under client load.

The reference's tools/local-tester runs an etcd cluster through
unreliable network bridges with a constant stream of Puts while a fault
script periodically kills members and disrupts connectivity
(tools/local-tester/{Procfile,faults.sh,bridge/}). The TPU-native analog
drives one embedded cluster (embed.start_etcd) with:

  * a constant client Put/Get stream (the benchmark-stresser role);
  * a periodic fault schedule cycling through the bridge/fault classes:
    link drops (bridge blackhole), member isolation (SIGSTOP/kill), and
    full partitions, injected through the engine keep-mask;
  * member crash + restart-from-disk (the kill/restart cycle) when a
    data dir is configured;
  * liveness/safety verification after each heal: stream errors are
    tolerated DURING faults, but the cluster must serve reads of every
    acknowledged write afterwards, and corruption_check() must pass.

The port's copy of etcd_tpu/localtester.py: the cluster lives on the CUDA
card unless ``device`` (``--device``) names another; a lossy-link fault
writes its keep mask into the ``Cluster``'s device mask, which the next
graph replay reads.

Usage:
    python -m etcd_tpu_torch.localtester [--cycles N] [--data-dir DIR]
        [--seed S] [--device cpu]
Prints one JSON line; exit 0 iff the run is healthy.
"""
from __future__ import annotations

import json
import random

from etcd_tpu_torch.server.kvserver import ErrTimeout, ServerError


FAULTS = ("drop_links", "isolate_member", "partition", "crash_restart")


def run_local_tester(cycles: int = 4, n_members: int = 3,
                     data_dir: str | None = None, seed: int = 0,
                     puts_per_phase: int = 8, device=None) -> dict:
    from etcd_tpu_torch.embed import Config, start_etcd

    rng = random.Random(seed)
    etcd = start_etcd(Config(cluster_size=n_members, auto_tick=False,
                             data_dir=data_dir, device=device))
    ec = etcd.server
    seq = [0]  # every stressed value is unique, so an identical earlier
    # write to the same key can never mask a lost later write
    acked: dict[bytes, bytes] = {}
    stats = {"puts_ok": 0, "put_errors": 0, "faults": [],
             "verify_failures": []}

    # keys whose LAST write timed out: the proposal may still commit
    # later and supersede the previously acked value — "timeout is not
    # failure", so the checker must treat them as indeterminate (the
    # reference tester's stresser does the same for context-deadline
    # errors)
    indeterminate: set[bytes] = set()

    def stress(tag: str) -> None:
        for _ in range(puts_per_phase):
            k = b"lt-%d" % rng.randrange(64)
            seq[0] += 1
            v = ("%s-%d" % (tag, seq[0])).encode()
            try:
                ec.put(k, v)
                acked[k] = v
                indeterminate.discard(k)
                stats["puts_ok"] += 1
            except ErrTimeout:
                # the proposal is in the log and may commit later,
                # superseding the acked value: indeterminate
                stats["put_errors"] += 1
                indeterminate.add(k)
            except ServerError:
                # definite rejection (no leader / quota / backpressure):
                # nothing was proposed, acked values stay verifiable
                stats["put_errors"] += 1
            etcd.tick()

    def heal_and_verify(fault: str) -> None:
        ec.cl.recover()
        for m in range(ec.M):
            if ec.members[m].crashed:
                ec.restart_member_from_disk(m)
        for _ in range(12):
            etcd.tick()
        # every acknowledged write must read back (linearizable)
        for k, v in acked.items():
            if k in indeterminate:
                continue  # a timed-out later write may have superseded it
            try:
                got = ec.range(k)["kvs"]
            except ServerError:
                stats["verify_failures"].append(f"{fault}: read {k!r} failed")
                continue
            if not got or got[0].value != v:
                stats["verify_failures"].append(
                    f"{fault}: {k!r} lost acknowledged value"
                )
        try:
            ec.corruption_check()
        except ServerError as e:
            stats["verify_failures"].append(f"{fault}: corruption: {e}")

    try:
        for cycle in range(cycles):
            fault = FAULTS[cycle % len(FAULTS)]
            if fault == "crash_restart" and data_dir is None:
                fault = "isolate_member"  # kill/restart needs a disk
            stats["faults"].append(fault)
            stress("pre")
            lead = ec.ensure_leader()
            victim = (lead + 1 + cycle) % ec.M
            if fault == "drop_links":
                # bridge-style lossy links (shared mask builder with the
                # lease chaos tier)
                from etcd_tpu_torch.harness.chaos_lease import _Rng

                ec.cl._set_keep(_Rng(seed + cycle).keep_mask(ec.M, 0.3))
            elif fault == "isolate_member":
                ec.cl.isolate(victim)
            elif fault == "partition":
                others = [m for m in range(ec.M) if m != victim]
                ec.cl.partition([[victim], others])
            elif fault == "crash_restart":
                ec.sync_for_shutdown()
                ec.crash_member(victim)
            stress(fault)
            heal_and_verify(fault)

        stats["acked_keys"] = len(acked)
        stats["healthy"] = (
            not stats["verify_failures"] and stats["puts_ok"] > 0
        )
        return stats
    finally:
        # an aborted run must not leak the V3Server listener thread or
        # open member backends into the calling process
        etcd.close()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="etcd-tpu-local-tester")
    p.add_argument("--cycles", type=int, default=4)
    p.add_argument("--members", type=int, default=3)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="the device the cluster lives on (default: the CUDA card)")
    args = p.parse_args(argv)
    rep = run_local_tester(cycles=args.cycles, n_members=args.members,
                           data_dir=args.data_dir, seed=args.seed,
                           device=args.device)
    print(json.dumps(rep))
    return 0 if rep["healthy"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
