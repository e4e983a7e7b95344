"""Make the durable embedded server's pin from the JAX package (the
reference) on the CPU: ``DURABLE_SESSION_PIN.json`` at the root of the repo.

    JAX_PLATFORMS=cpu python tests/make_durable_pins.py [--skip-default]

The pin holds the reference's answers to the scripts of
``etcd_tpu_torch/harness/durable_session.py`` and its local tester's
reports, each at ``EtcdCluster``'s defaults (3 members, the ``Spec``
defaults: what chip_smoke.py phase 10 holds the card to) and at bench.py's
small ``Spec`` (``SMALL``, what the CPU tests hold the port to):

- ``session`` / ``session_small``: ``run_durable_session`` (10a);
- ``gateway`` / ``gateway_small``: ``run_gateway_session`` on
  ``embed.start_etcd`` with 3 members, a data dir, an ephemeral port and
  the ticker on (10b), its v2 requests included;
- ``boot_small``: each of ``BOOT_SCRIPTS``, ``embed.start_etcd``'s
  bootstrap table, by ``run_boot_script`` on ``SMALL``;
- ``localtester`` / ``localtester_small``: ``run_local_tester(cycles=4,
  seed=0, puts_per_phase=1, data_dir=...)``, the crash-restart cycle
  included (10c);
- ``localtester_default``: the tester at its defaults with a data dir
  (``python -m etcd_tpu.localtester --data-dir D``; 10d). ``--skip-default``
  keeps the file's entry.

``--only KEY[,KEY]`` remakes those entries and keeps the others from the file.

Each tester entry holds the report and the ``Cluster`` steps it took. The
file names this script and the package versions.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from make_server_pins import SMALL, provenance  # noqa: E402

PIN = ROOT / "DURABLE_SESSION_PIN.json"
# chip_smoke.py phase 10c's depth cut of the tester's default run
TESTER_CUT = dict(cycles=4, seed=0, puts_per_phase=1)


class small_clusters:
    """Within the block, every ``Cluster`` a package's embed or boot path
    builds has bench.py's small ``Spec`` at its member count (the module
    attribute those paths import at call time); ``steps`` counts every
    ``Cluster.step`` meanwhile, small or not."""

    def __init__(self, cluster_module, spec_cls, small: bool):
        self.mod, self.spec_cls, self.small = cluster_module, spec_cls, small
        self.steps = 0

    def __enter__(self):
        real = self.real = self.mod.Cluster
        outer, spec_cls, small = self, self.spec_cls, self.small

        class Counted(real):
            def __init__(self, n_members=3, **kw):
                if small:
                    kw["spec"] = spec_cls(M=n_members, **SMALL)
                super().__init__(n_members=n_members, **kw)

            def step(self, *a, **k):
                outer.steps += 1
                return super().step(*a, **k)

        self.mod.Cluster = Counted
        return self

    def __exit__(self, *exc):
        self.mod.Cluster = self.real


def reference_api():
    import types

    from etcd_tpu.server import kvserver
    from etcd_tpu.storage import schema
    from etcd_tpu.storage.backend import Backend

    return types.SimpleNamespace(EtcdCluster=kvserver.EtcdCluster, Backend=Backend,
                                 schema=schema, Op=kvserver.Op, Compare=kvserver.Compare)


def reference_session(small: bool) -> dict:
    from etcd_tpu.harness import cluster
    from etcd_tpu.types import Spec
    from etcd_tpu_torch.harness import durable_session as ds

    with tempfile.TemporaryDirectory() as d, small_clusters(cluster, Spec, small):
        api = reference_api()
        ec = api.EtcdCluster(cluster=cluster.Cluster(n_members=3), data_dir=d)
        out = ds.run_durable_session(ec, api, d, lambda: cluster.Cluster(n_members=3))
    return json.loads(json.dumps(ds.session_view(out)))


def reference_gateway(small: bool) -> dict:
    from etcd_tpu import client
    from etcd_tpu.embed import Config, start_etcd
    from etcd_tpu.harness import cluster
    from etcd_tpu.types import Spec
    from etcd_tpu_torch.harness import durable_session as ds

    with tempfile.TemporaryDirectory() as d, small_clusters(cluster, Spec, small):
        out = ds.run_gateway_session(
            lambda: start_etcd(Config(cluster_size=3, data_dir=d, auto_tick=True)), client)
    return json.loads(json.dumps(out))


def reference_boot(small: bool = True) -> dict:
    from etcd_tpu.client import Client
    from etcd_tpu.embed import Config, start_etcd
    from etcd_tpu.harness import cluster
    from etcd_tpu.types import Spec
    from etcd_tpu_torch.harness import durable_session as ds

    out = {}
    for name in ds.BOOT_SCRIPTS:
        with tempfile.TemporaryDirectory() as d, small_clusters(cluster, Spec, small):
            data = f"{d}/data"
            out[name] = ds.run_boot_script(
                name, lambda **kw: start_etcd(Config(data_dir=data, auto_tick=False,
                                                     cluster_size=3, **kw)),
                Client, data)
    return json.loads(json.dumps(out))


def reference_tester(small: bool, **kw) -> dict:
    from etcd_tpu.harness import cluster
    from etcd_tpu.localtester import run_local_tester
    from etcd_tpu.types import Spec

    with tempfile.TemporaryDirectory() as d, small_clusters(cluster, Spec, small) as sc:
        rep = run_local_tester(data_dir=d, **kw)
    return {"report": json.loads(json.dumps(rep)), "steps": sc.steps, "args": kw}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-default", action="store_true")
    ap.add_argument("--only", default="")
    args = ap.parse_args(argv)
    old = json.loads(PIN.read_text()) if PIN.exists() else {}
    only = set(filter(None, args.only.split(",")))
    pin = {**old, **provenance(), "small_spec": SMALL, "tester_cut": TESTER_CUT}
    pin["made_by"] = "tests/make_durable_pins.py (the JAX package on the CPU)"
    t0 = time.perf_counter()
    makers = [(f"{name}_small" if small else name, make, small)
              for name, make in (("session", reference_session), ("gateway", reference_gateway),
                                 ("localtester",
                                  lambda small: reference_tester(small, **TESTER_CUT)))
              for small in (False, True)] + [("boot_small", reference_boot, True)]
    for key, make, small in makers:
        if only and key not in only:
            continue
        t = time.perf_counter()
        pin[key] = make(small)
        print(f"{key} in {time.perf_counter() - t:.1f}s", flush=True)
    if ("localtester_default" in only or "localtester_default" not in pin
            or not (only or args.skip_default)):
        t = time.perf_counter()
        pin["localtester_default"] = reference_tester(False)
        print(f"localtester_default in {time.perf_counter() - t:.1f}s: "
              f"{pin['localtester_default']}", flush=True)
    PIN.write_text(json.dumps(pin, indent=1) + "\n")
    print(f"all in {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
