"""Lease stress + expiry checking under faults — the host-layer chaos tier.

The reference's functional tester stresses leases while faults fire
(tests/functional/tester/stresser_lease.go: create leases with and without
keepalives, attach keys) and then checks expiry semantics
(tester/checker_lease_expire.go + checker_short_ttl_lease_expire.go):
after waiting out the TTL, every lease that was NOT kept alive must be
gone — with its attached keys deleted — and every kept-alive lease must
survive with its keys intact. The device chaos tier (harness/chaos.py)
covers raft safety at fleet scale; this tier drives the HOST layer
(Lessor, revoke-through-consensus, MVCC deletes) through the same fault
classes via the keep-mask, which nothing exercised before.

Faults make individual requests fail (no leader / timeout) — like the
reference tester, the stresser tolerates errors during fault epochs and
the checker runs after heal, within a bounded slack (the checker's own
retry loop, checker_lease_expire.go waitForLeaseExpire).

The port's copy of etcd_tpu/harness/chaos_lease.py: the same tiers, draws
and report on the port's ``EtcdCluster``, whose device (``device=None``:
CUDA) holds the cluster. Each round's keep mask is drawn from the same
``np.random.default_rng`` stream and written into the torch ``Cluster``'s
keep mask on its device (``Cluster._set_keep``), so the faults equal the
reference's mask for mask."""
from __future__ import annotations

import numpy as np

from etcd_tpu_torch.server.kvserver import EtcdCluster, ServerError
from etcd_tpu_torch.server.lease import ErrLeaseNotFound, LeaseError


# The tiers' sizes the smoke run and the tests drive, as (lease tier
# arguments, runner tier arguments): "default" is main's run at seed 0
# (4,713 steps in the reference), "tests" the reference's tests'
# (tests/test_chaos.py:79-81, :97; 964 steps), "tiny" 462 steps.
SIZES = {
    "default": ({"seed": 0}, {"seed": 0}),
    "tests": (dict(n_members=3, n_leases=4, ttl=8, short_ttl=1, fault_rounds=12,
                   drop_p=0.2, seed=5),
              dict(n_members=3, n_runners=2, fault_rounds=8, drop_p=0.15, seed=2)),
    "tiny": (dict(n_members=3, n_leases=2, ttl=4, short_ttl=1, fault_rounds=6,
                  drop_p=0.2, seed=5),
             dict(n_members=3, n_runners=2, fault_rounds=4, drop_p=0.15, seed=2)),
}


class _Rng:
    def __init__(self, seed: int):
        self.r = np.random.default_rng(seed)

    def keep_mask(self, M: int, drop_p: float) -> np.ndarray:
        km = self.r.random((M, M, 1)) >= drop_p
        return km | np.eye(M, dtype=bool)[:, :, None]


def run_lease_chaos(
    n_members: int = 5,
    n_leases: int = 8,
    # like the reference's stress leases, the kept TTL is LONG relative
    # to a fault window (stresser_lease.go TTL=120s vs second-scale
    # blips): a multi-round partition must not push every kept lease
    # into legal-expiry territory, or the checker verifies nothing
    ttl: int = 8,
    short_ttl: int = 1,
    fault_rounds: int = 30,
    drop_p: float = 0.25,
    seed: int = 0,
    retries: int = 3,
    device=None,
) -> dict:
    """One stress/fault/heal/check cycle. Returns counters; the caller
    asserts on ``violations`` AND ``lease_gate_failures`` (chaos_run.py
    folds both into its JSON).

    Leases [0, n//2) are kept alive through the fault epoch; leases
    [n//2, n), one short-TTL lease, and a short-TTL lease granted
    MID-EPOCH (the checker_short_ttl_lease_expire.go case — born under
    faults, must still expire) are abandoned and must expire with their
    keys revoked. TTLs are seconds = lease-clock ticks here.

    Gates (the reference checker's bar, r4 verdict Weak #3): the
    stresser retries each keepalive up to `retries` times, and the run
    FAILS if logical request failures exceed 20% of attempts or if more
    than ONE kept lease lands in the indeterminate bucket — a lease
    tier that mostly errors under faults and excuses itself through
    indeterminacy proves nothing."""
    ec = EtcdCluster(n_members=n_members, lease_min_ttl=1, device=device)
    ec.ensure_leader()
    rng = _Rng(seed)
    M = ec.M

    kept = list(range(1, n_leases // 2 + 1))
    abandoned = list(range(n_leases // 2 + 1, n_leases + 1))
    for lid in kept + abandoned:
        ec.lease_grant(lid, ttl)
        ec.put(b"lease-k-%d" % lid, b"v", lease=lid)
    short_id = n_leases + 1
    ec.lease_grant(short_id, short_ttl)  # checker_short_ttl analog
    ec.put(b"lease-k-%d" % short_id, b"v", lease=short_id)
    mid_short_id = n_leases + 2  # granted mid-epoch, under faults

    attempts = 0
    failures = 0
    tick_errors = 0
    keepalive_ok = 0
    mid_short_granted = False
    mid_short_tries = 0
    # a kept lease whose renewals gapped >= TTL during the fault epoch may
    # legally expire — the stresser failed, not the system. The reference
    # checker likewise only asserts on leases its stresser could service.
    last_renew = {lid: 0 for lid in kept}
    indeterminate: set[int] = set()
    # RETRY POLICY: the per-round keep mask freezes the fault pattern for
    # a whole round, so retrying within one round faces the identical
    # partition and proves nothing. Instead the stresser renews EVERY
    # round (the reference stresser retries continuously as real time
    # passes) and a LOGICAL failure is `retries` consecutive failed
    # rounds — sustained unavailability, not one unlucky mask.
    consec = {lid: 0 for lid in kept}

    def renew_all(r: int) -> None:
        nonlocal attempts, failures, keepalive_ok
        for lid in kept:
            try:
                ec.lease_keepalive(lid)
            except ErrLeaseNotFound:
                # the lease legally expired during a renewal gap and
                # the expiry loop already revoked it: exactly the
                # indeterminate case, not a crash
                indeterminate.add(lid)
                continue
            except (ServerError, LeaseError):
                consec[lid] += 1
                if consec[lid] >= retries:
                    attempts += 1
                    failures += 1
                    consec[lid] = 0
                # a lease is only unverifiable once its RENEWAL GAP
                # reached expiry range — a failed round with a fresh
                # renewal behind it proves nothing about expiry
                if r - last_renew[lid] >= ttl - 1:
                    indeterminate.add(lid)
            else:
                attempts += 1
                keepalive_ok += 1
                consec[lid] = 0
                last_renew[lid] = r

    # fault epoch: random link drops re-rolled every round while the lease
    # clock advances and keepalives fight through the faults
    for r in range(fault_rounds):
        ec.cl._set_keep(rng.keep_mask(M, drop_p))
        try:
            ec.tick(lease_clock=True)
        except ServerError:
            tick_errors += 1
        renew_all(r)
        if r >= fault_rounds // 2 and not mid_short_granted and \
                mid_short_tries < retries:
            # short-TTL lease born in the middle of the fault epoch:
            # it must expire like any other once abandoned
            mid_short_tries += 1
            try:
                try:
                    ec.lease_grant(mid_short_id, short_ttl)
                except LeaseError:
                    # ErrLeaseExists: the previous try's grant DID
                    # commit (its _propose merely timed out under
                    # faults) — that IS success, continue to the put
                    pass
                ec.put(b"lease-k-%d" % mid_short_id, b"v",
                       lease=mid_short_id)
                mid_short_granted = True
                attempts += 1
            except (ServerError, LeaseError):
                if mid_short_tries >= retries:
                    attempts += 1
                    failures += 1

    # heal, then give expiry the reference checker's slack: revokes that
    # queued behind faults drain through consensus here. The stresser
    # KEEPS renewing the kept set through the wait (the wait exists to
    # expire the ABANDONED set; without renewals the kept leases would
    # legitimately expire too and prove nothing).
    ec.cl.recover()
    for r in range(ttl + 6):
        try:
            ec.tick(lease_clock=True)
        except ServerError:
            tick_errors += 1
        renew_all(fault_rounds + r)

    violations: list[str] = []
    lead = ec.ensure_leader()
    live = set(ec.leases())
    for lid in kept:
        if lid in indeterminate:
            continue  # renewals gapped past TTL: expiry would be legal
        # kept alive through the epoch, so renewed within TTL: must live
        if lid not in live:
            violations.append(f"kept lease {lid} expired")
        elif ec.range(b"lease-k-%d" % lid)["count"] != 1:
            violations.append(f"kept lease {lid} lost its key")
    expired_set = abandoned + [short_id] + (
        [mid_short_id] if mid_short_granted else [])
    for lid in expired_set:
        if lid in live:
            violations.append(f"abandoned lease {lid} still alive")
        elif ec.range(b"lease-k-%d" % lid)["count"] != 0:
            violations.append(f"expired lease {lid} left its key behind")

    # ---- gates (fail the run, don't excuse it)
    gate_failures: list[str] = []
    if len(indeterminate) > 1:
        gate_failures.append(
            f"indeterminate bucket too large: {len(indeterminate)}/"
            f"{len(kept)} kept leases unverifiable (max 1)")
    if attempts and failures > 0.2 * attempts:
        gate_failures.append(
            f"request failure rate {failures}/{attempts} exceeds 20% "
            f"despite {retries} retries per request")

    return {
        "lease_kept": len(kept),
        "lease_kept_indeterminate": len(indeterminate),
        "lease_abandoned": len(expired_set),
        "lease_mid_epoch_short_granted": mid_short_granted,
        "lease_keepalives_ok": keepalive_ok,
        "lease_attempts": attempts,
        "lease_request_failures": failures,
        "lease_tick_errors": tick_errors,
        "lease_violations": violations,
        "lease_gate_failures": gate_failures,
        "leader_after_heal": lead,
    }


def run_runner_chaos(
    n_members: int = 3,
    n_runners: int = 3,
    fault_rounds: int = 20,
    drop_p: float = 0.2,
    seed: int = 1,
    device=None,
) -> dict:
    """Election-runner stress under faults (tester/stresser_runner.go,
    which shells out to functional/runner's election-command): N
    concurrency.Election candidates campaign/proclaim/resign against a
    faulted cluster; mutual exclusion (never two holders at once) must
    hold throughout, and after heal the election must make progress."""
    from etcd_tpu_torch.client import Client
    from etcd_tpu_torch.concurrency import ConcurrencyError, Election, Session

    ec = EtcdCluster(n_members=n_members, lease_min_ttl=1, device=device)
    ec.ensure_leader()
    c = Client(ec)
    rng = _Rng(seed)
    sessions = [Session(c, ttl=60) for _ in range(n_runners)]
    els = [Election(s, b"chaos-el") for s in sessions]

    errors = 0
    exclusion_violations = 0
    leaders_seen: set[bytes] = set()
    for r in range(fault_rounds):
        ec.cl._set_keep(rng.keep_mask(ec.M, drop_p))
        i = r % n_runners
        try:
            if els[i].is_leader():
                els[i].proclaim(b"v%d" % r)
                els[i].resign()
            else:
                els[i].campaign(b"runner-%d" % i, max_rounds=30)
        except (ServerError, ConcurrencyError):
            errors += 1
        # mutual exclusion: by construction at most one lowest
        # create-revision key exists; violation = two runners both
        # believing they hold it. The observation itself is a
        # linearizable read and may time out mid-fault — skip that
        # round's check, as the reference checker retries around
        # cluster unavailability.
        try:
            holders = [
                j for j, e in enumerate(els) if e.my_rev and e.is_leader()
            ]
            if len(holders) > 1:
                exclusion_violations += 1
            lv = els[i].leader()
            if lv is not None:
                leaders_seen.add(bytes(lv.value))
        except (ServerError, ConcurrencyError):
            errors += 1
    ec.cl.recover()
    # post-heal progress: someone can win an election cleanly
    for e in els:
        try:
            e.resign()
        except (ServerError, ConcurrencyError):
            pass
    els[0].campaign(b"final", max_rounds=200)
    final_ok = els[0].is_leader()
    return {
        "runner_count": n_runners,
        "runner_errors": errors,
        "runner_exclusion_violations": exclusion_violations,
        "runner_leaders_seen": len(leaders_seen),
        "runner_final_progress": bool(final_ok),
    }


def main(argv=None) -> int:
    """CLI: run both host tiers and print ONE JSON line
    (``python -m etcd_tpu_torch.harness.chaos_lease --seed S``; the port's
    chaos_run runs it in a subprocess on its own device). ``--device``
    defaults to the card; ``--device cpu`` is for a caller on the CPU."""
    import argparse
    import json

    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    rep = run_lease_chaos(seed=args.seed, device=args.device)
    rep.update(run_runner_chaos(seed=args.seed, device=args.device))
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
