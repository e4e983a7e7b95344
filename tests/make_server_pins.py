"""Make the server layer's pins from the JAX package (the reference) on the
CPU: ``SERVER_SESSION_PIN.json`` and ``CHAOS_LEASE_PIN.json`` at the root
of the repo.

    JAX_PLATFORMS=cpu python tests/make_server_pins.py [--skip-default]

``SERVER_SESSION_PIN.json`` holds the reference's answers to the scripted
sessions of ``etcd_tpu_torch/harness/server_session.py``: ``session`` at
``EtcdCluster``'s defaults (3 members, the ``Spec`` defaults; what
chip_smoke.py phase 9 holds the card to), and at bench.py's small ``Spec``
(``SMALL``, what the CPU tests hold the port to) ``session_small``,
``device_plane_small`` (``apply_plane="device"``, 16 keys) and
``lapped_member_small`` (a member isolated until the ring laps it).

``CHAOS_LEASE_PIN.json`` holds the reference's report of the lease and
runner tiers (harness/chaos_lease.py) at the sizes of the port's
``chaos_lease.SIZES`` (``default``: ``main --seed 0``, about 280 s here;
``tests``; ``tiny``) and at ``TIER1_SMALL`` on the small ``Spec`` (the one
lease-tier case of the tier-1 tests). ``--skip-default`` keeps the file's
``default`` entry. Both files name this script and the package versions.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SESSION_PIN = ROOT / "SERVER_SESSION_PIN.json"
LEASE_PIN = ROOT / "CHAOS_LEASE_PIN.json"
# bench.py's Spec at M members: the CPU tests' cheaper step
SMALL = dict(L=16, E=1, K=2, W=4, R=2, A=2)
# the tier-1 lease case: the lease tier alone, few fault rounds, on SMALL
TIER1_SMALL = dict(n_members=3, n_leases=1, ttl=1, short_ttl=1, fault_rounds=2,
                   drop_p=0.2, seed=5)


def small_cluster_factory(cluster_cls, spec_cls, **extra):
    """``Cluster(n_members=M, ...)`` on bench.py's Spec at M members; a
    stand-in for a package's ``kvserver.Cluster``."""
    def make(n_members=3, **kw):
        return cluster_cls(n_members=n_members, spec=spec_cls(M=n_members, **SMALL),
                           **extra, **kw)
    return make


def reference_api():
    from etcd_tpu import client, concurrency
    from etcd_tpu.device_mvcc import scheme
    from etcd_tpu.server.kvserver import Compare, Op
    from etcd_tpu.utils import failpoints

    return types.SimpleNamespace(Op=Op, Compare=Compare, Client=client.Client,
                                 Session=concurrency.Session, Mutex=concurrency.Mutex,
                                 failpoints=failpoints, scheme=scheme)


def reference_sessions() -> dict:
    from etcd_tpu.harness.cluster import Cluster
    from etcd_tpu.server.kvserver import EtcdCluster
    from etcd_tpu.types import Spec
    from etcd_tpu_torch.harness import server_session as ss

    api = reference_api()
    small = small_cluster_factory(Cluster, Spec)
    out = {"session": ss.run_session(EtcdCluster(n_members=3), api),
           "session_small": ss.run_session(EtcdCluster(cluster=small()), api),
           "device_plane_small": ss.run_device_plane_session(
               EtcdCluster(cluster=small(), apply_plane="device", kv_keys=16), api),
           "lapped_member_small": ss.run_lapped_member_session(
               EtcdCluster(cluster=small()), api)}
    return json.loads(json.dumps(out))


def reference_lease_report(lease_kw, runner_kw=None, small=False) -> dict:
    """The reference tiers' report (main's dict); ``small``: on SMALL."""
    from etcd_tpu import concurrency
    from etcd_tpu.harness import chaos_lease
    from etcd_tpu.harness.cluster import Cluster
    from etcd_tpu.server import kvserver
    from etcd_tpu.types import Spec

    real = kvserver.Cluster
    if small:
        kvserver.Cluster = small_cluster_factory(Cluster, Spec)
    try:
        rep = chaos_lease.run_lease_chaos(**lease_kw)
        if runner_kw is not None:
            concurrency.Session._next_id = 1000
            rep.update(chaos_lease.run_runner_chaos(**runner_kw))
    finally:
        kvserver.Cluster = real
    return json.loads(json.dumps(rep))


def provenance() -> dict:
    import jax
    import numpy

    return {"made_by": "tests/make_server_pins.py (the JAX package on the CPU)",
            "jax": jax.__version__, "numpy": numpy.__version__}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-default", action="store_true")
    args = ap.parse_args(argv)
    from etcd_tpu_torch.harness.chaos_lease import SIZES

    t0 = time.perf_counter()
    SESSION_PIN.write_text(json.dumps({**provenance(), "small_spec": SMALL,
                                       **reference_sessions()}, indent=1) + "\n")
    print(f"sessions in {time.perf_counter() - t0:.1f}s", flush=True)
    old = json.loads(LEASE_PIN.read_text()) if LEASE_PIN.exists() else {}
    pin = {**provenance(), "sizes": {k: list(v) for k, v in SIZES.items()},
           "tier1_small_args": TIER1_SMALL, "small_spec": SMALL}
    for name in ("tiny", "tests", "default"):
        if name == "default" and args.skip_default and "default" in old:
            pin["default"] = old["default"]
            continue
        t = time.perf_counter()
        pin[name] = reference_lease_report(*SIZES[name])
        print(f"{name} in {time.perf_counter() - t:.1f}s: {pin[name]}", flush=True)
    pin["tier1_small"] = reference_lease_report(TIER1_SMALL, small=True)
    LEASE_PIN.write_text(json.dumps(pin, indent=1) + "\n")
    print(f"all in {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
