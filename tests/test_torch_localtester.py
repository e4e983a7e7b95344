"""The port's local tester (etcd_tpu_torch/localtester.py, the reference's
tools/local-tester: a live embedded cluster under a constant put stream,
with lossy links, an isolated member, a partition and a crash-restart from
disk) on the CPU against the reference's (etcd_tpu/localtester.py).

Tier-1: the entry point's signature, its fault schedule and its command
line against the reference's, with the run patched out. ``slow``: the
tester at bench.py's small ``Spec`` with a data dir, 4 cycles and one put
a phase (the crash-restart cycle included; about 260 port steps), its
report and steps held to the reference's in ``DURABLE_SESSION_PIN.json``,
and the live JAX package beside it."""
from __future__ import annotations

import inspect
import json
import pathlib

import pytest
import torch

from etcd_tpu_torch import localtester
from etcd_tpu_torch.harness.cluster import Cluster
from etcd_tpu_torch.types import Spec

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PIN = json.loads((ROOT / "DURABLE_SESSION_PIN.json").read_text())
SMALL = PIN["small_spec"]

torch.set_num_threads(1)


def test_entry_point_and_fault_schedule_equal_the_reference():
    from etcd_tpu import localtester as ref

    assert localtester.FAULTS == ref.FAULTS
    want = dict(inspect.signature(ref.run_local_tester).parameters)
    got = dict(inspect.signature(localtester.run_local_tester).parameters)
    assert got.pop("device").default is None
    assert {k: p.default for k, p in got.items()} == {k: p.default for k, p in want.items()}


@pytest.mark.parametrize("healthy", [True, False])
def test_command_line_prints_one_json_line_and_folds_health(monkeypatch, capsys, healthy):
    seen = {}

    def run(**kw):
        seen.update(kw)
        return {"puts_ok": 3, "healthy": healthy}

    monkeypatch.setattr(localtester, "run_local_tester", run)
    rc = localtester.main(["--cycles", "2", "--data-dir", "/d", "--seed", "5",
                           "--device", "cpu"])
    assert rc == (0 if healthy else 1)
    assert seen == {"cycles": 2, "n_members": 3, "data_dir": "/d", "seed": 5,
                    "device": "cpu"}
    out = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in out] == [{"puts_ok": 3, "healthy": healthy}]
    localtester.main([])
    assert seen == {"cycles": 4, "n_members": 3, "data_dir": None, "seed": 0,
                    "device": None}


def test_lossy_links_write_the_clusters_device_mask():
    """The drop_links fault goes through Cluster._set_keep, which the next
    graph replay copies into the captured mask (the reference rebinds the
    engine's mask)."""
    import ast

    src = inspect.getsource(localtester.run_local_tester)
    calls = [n for n in ast.walk(ast.parse(src.strip()))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)]
    assert "_set_keep" in [c.func.attr for c in calls]
    assert "keep_mask =" not in src


def test_tester_pins_carry_the_reference_runs():
    for name in ("localtester", "localtester_small", "localtester_default"):
        entry = PIN[name]
        assert entry["report"]["healthy"] is True, name
        assert entry["steps"] > 0 and entry["report"]["puts_ok"] > 0
    assert PIN["localtester"]["args"] == PIN["tester_cut"]
    assert "crash_restart" in PIN["localtester"]["report"]["faults"]
    assert PIN["localtester_default"]["args"] == {}


def small_cluster(n_members=3, **kw):
    return Cluster(n_members=n_members, spec=Spec(M=n_members, **SMALL), **kw)


@pytest.mark.slow
def test_tester_at_the_small_spec_equals_the_reference(tmp_path, monkeypatch):
    from etcd_tpu_torch.harness import cluster

    steps = [0]

    def counted(*a, **k):
        cl = small_cluster(*a, **k)
        real = cl.step

        def step(*sa, **sk):
            steps[0] += 1
            return real(*sa, **sk)
        cl.step = step
        return cl

    monkeypatch.setattr(cluster, "Cluster", counted)
    rep = localtester.run_local_tester(data_dir=str(tmp_path), device="cpu",
                                       **PIN["tester_cut"])
    want = PIN["localtester_small"]
    assert json.loads(json.dumps(rep)) == want["report"]
    assert steps[0] == want["steps"]


@pytest.mark.slow
def test_tester_pin_equals_the_jax_package():
    import sys

    sys.path.insert(0, str(ROOT / "tests"))
    import make_durable_pins

    got = make_durable_pins.reference_tester(True, **make_durable_pins.TESTER_CUT)
    assert got == PIN["localtester_small"]
