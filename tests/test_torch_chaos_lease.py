"""The port's lease and runner chaos tiers (etcd_tpu_torch/harness/
chaos_lease.py) against the reference's (etcd_tpu/harness/chaos_lease.py),
and the way the port's chaos_run folds them into its JSON line.

The reference's reports come from ``CHAOS_LEASE_PIN.json``, which
``tests/make_server_pins.py`` makes from the JAX package on the CPU. The
tier-1 case runs the lease tier with one lease, two fault rounds and a
TTL of 1 on bench.py's small ``Spec`` (both packages' ``kvserver.Cluster``
built on it; no kept lease, so no keepalive: a kept one costs a proposal
a round and puts the case past 40 s here); the sizes the
reference's own tests and driver run take many minutes a run on the CPU (a
port step costs 0.5 to 1 s here) and are marked ``slow``."""
from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from etcd_tpu_torch import chaos_run, concurrency
from etcd_tpu_torch.harness import chaos_lease
from etcd_tpu_torch.harness.cluster import Cluster
from etcd_tpu_torch.server import kvserver
from etcd_tpu_torch.types import Spec

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PIN = json.loads((ROOT / "CHAOS_LEASE_PIN.json").read_text())
LEASE_KEYS = {"lease_kept", "lease_kept_indeterminate", "lease_abandoned",
              "lease_mid_epoch_short_granted", "lease_keepalives_ok", "lease_attempts",
              "lease_request_failures", "lease_tick_errors", "lease_violations",
              "lease_gate_failures", "leader_after_heal"}
RUNNER_KEYS = {"runner_count", "runner_errors", "runner_exclusion_violations",
               "runner_leaders_seen", "runner_final_progress"}
# the reference's report at its defaults, seed 0
# (`python -m etcd_tpu.harness.chaos_lease --seed 0`)
DEFAULT_SEED0 = {
    "lease_kept": 4, "lease_kept_indeterminate": 0, "lease_abandoned": 6,
    "lease_mid_epoch_short_granted": True, "lease_keepalives_ok": 136,
    "lease_attempts": 141, "lease_request_failures": 4, "lease_tick_errors": 0,
    "lease_violations": [], "lease_gate_failures": [], "leader_after_heal": 3,
    "runner_count": 3, "runner_errors": 12, "runner_exclusion_violations": 0,
    "runner_leaders_seen": 3, "runner_final_progress": True}

torch.set_num_threads(1)


def small_cluster(n_members=3, **kw):
    return Cluster(n_members=n_members, spec=Spec(M=n_members, **PIN["small_spec"]), **kw)


def port_report(lease_kw, runner_kw=None) -> dict:
    rep = chaos_lease.run_lease_chaos(**lease_kw, device="cpu")
    if runner_kw is not None:
        concurrency.Session._next_id = 1000     # as in a fresh process
        rep.update(chaos_lease.run_runner_chaos(**runner_kw, device="cpu"))
    return json.loads(json.dumps(rep))


def test_lease_tier_on_the_small_spec_equals_the_reference(monkeypatch):
    monkeypatch.setattr(kvserver, "Cluster", small_cluster)
    got = port_report(PIN["tier1_small_args"])
    assert got == PIN["tier1_small"]
    # the tier did its work: its leases, the one born under faults among
    # them, expired with their keys through revokes under the faults
    assert got["lease_abandoned"] == 3 and got["lease_mid_epoch_short_granted"]
    assert not got["lease_violations"] and not got["lease_gate_failures"]


@pytest.mark.parametrize("seed", range(6))
def test_keep_masks_equal_the_reference_mask_for_mask(seed):
    from etcd_tpu.harness.chaos_lease import _Rng as JRng

    a, b = JRng(seed), chaos_lease._Rng(seed)
    for M, p in ((3, 0.2), (5, 0.25), (3, 0.15)) * 4:
        assert np.array_equal(a.keep_mask(M, p), b.keep_mask(M, p))


def test_keep_mask_lands_in_the_clusters_device_mask():
    cl = Cluster(n_members=3, device="cpu")
    km = chaos_lease._Rng(0).keep_mask(3, 0.5)
    cl._set_keep(km)
    assert cl.eng.keep_mask.dtype == torch.bool
    assert np.array_equal(cl.eng.keep_mask.numpy(), km)


def test_entry_point_prints_one_json_line(monkeypatch, capsys):
    seen = {}

    def lease(seed, device):
        seen["lease"] = (seed, device)
        return {"lease_violations": []}

    def runner(seed, device):
        seen["runner"] = (seed, device)
        return {"runner_count": 3}

    monkeypatch.setattr(chaos_lease, "run_lease_chaos", lease)
    monkeypatch.setattr(chaos_lease, "run_runner_chaos", runner)
    assert chaos_lease.main(["--seed", "7", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == {"lease_violations": [], "runner_count": 3}
    assert seen == {"lease": (7, "cpu"), "runner": (7, "cpu")}
    assert chaos_lease.main(["--seed", "1"]) == 0
    assert seen["lease"] == (1, None)        # None: the card


def test_sizes_are_the_references():
    import inspect

    from etcd_tpu.harness import chaos_lease as ref

    for fn in ("run_lease_chaos", "run_runner_chaos"):
        a = inspect.signature(getattr(ref, fn)).parameters
        b = inspect.signature(getattr(chaos_lease, fn)).parameters
        assert list(b)[:-1] == list(a) and list(b)[-1] == "device"
        assert all(a[n].default == b[n].default for n in a)
    assert chaos_lease.SIZES["default"] == ({"seed": 0}, {"seed": 0})


def test_lease_pin_carries_the_reference_keys():
    assert {"tiny", "tests", "default", "tier1_small", "sizes", "made_by"} <= set(PIN)
    for name in ("tiny", "tests", "default"):
        assert set(PIN[name]) == LEASE_KEYS | RUNNER_KEYS, name
        assert PIN["sizes"][name] == [dict(d) for d in chaos_lease.SIZES[name]]
    assert set(PIN["tier1_small"]) == LEASE_KEYS
    assert PIN["default"] == DEFAULT_SEED0


@pytest.mark.slow
@pytest.mark.parametrize("size", ["tiny", "tests", "default"])
def test_tiers_equal_the_reference(size):
    """The port at the reference's Spec defaults on the CPU: tiny 462
    steps, tests 964, default 4,713 (the last about 1.5 hours here)."""
    assert port_report(*chaos_lease.SIZES[size]) == PIN[size]


@pytest.mark.slow
def test_pin_regenerates_from_the_jax_package(monkeypatch):
    """The pins' reference reports and sessions at the sizes that run in
    minutes, made again from the JAX package (``default`` takes about 350 s
    more; ``tests/make_server_pins.py`` makes it)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import make_server_pins as mk

    for name in ("tiny", "tests"):
        assert mk.reference_lease_report(*chaos_lease.SIZES[name]) == PIN[name]
    assert mk.reference_lease_report(mk.TIER1_SMALL, small=True) == PIN["tier1_small"]
    sessions = json.loads((ROOT / "SERVER_SESSION_PIN.json").read_text())
    fresh = mk.reference_sessions()
    assert {k: fresh[k] for k in fresh} == {k: sessions[k] for k in fresh}


# -- the driver's lease tier (chaos_run.py:296-335) ------------------------------

def _printing(report: dict | None, code: int = 0, sleep: float = 0) -> list[str]:
    """A stand-in tier command: prints ``report`` as its JSON line."""
    body = (f"import json, sys, time; time.sleep({sleep}); "
            f"print('noise'); print(json.dumps({report!r})); sys.exit({code})")
    return [sys.executable, "-c", body]


@pytest.mark.parametrize("case", ["tiny", "violation", "gate", "exclusion", "no-progress",
                                  "exit-1", "no-json", "timeout"])
def test_lease_tier_folds_as_the_reference(monkeypatch, case):
    rep = dict(PIN["tiny"])
    code, sleep, report = 0, 0, rep
    if case == "violation":
        rep["lease_violations"] = ["kept lease 1 expired"]
    elif case == "gate":
        rep["lease_gate_failures"] = ["request failure rate 5/10 exceeds 20%"]
    elif case == "exclusion":
        rep["runner_exclusion_violations"] = 1
    elif case == "no-progress":
        rep["runner_final_progress"] = False
    elif case == "exit-1":
        code = 1
    elif case == "no-json":
        report = None
    elif case == "timeout":
        sleep = 5
        monkeypatch.setattr(chaos_run, "LEASE_TIER_TIMEOUT_S", 0.5)
    argv = _printing(report, code, sleep)
    if case == "no-json":
        argv = [sys.executable, "-c", "print('no report')"]
    monkeypatch.setattr(chaos_run, "lease_tier_argv", lambda seed, dev: argv)
    out = chaos_run.lease_tier(0, torch.device("cpu"))
    if case in ("exit-1", "no-json", "timeout"):
        assert out["lease_safe"] is False and set(out) == {"lease_safe", "lease_tier_error"}
        # the reference keeps the error's last 500 characters
        want = {"exit-1": "RuntimeError", "no-json": "RuntimeError: no report",
                "timeout": "timed out after 0.5 seconds"}[case]
        assert want in out["lease_tier_error"] and len(out["lease_tier_error"]) <= 500
    else:
        assert out == {**rep, "lease_safe": case == "tiny"}


def test_lease_tier_command_is_the_references():
    argv = chaos_run.lease_tier_argv(3, torch.device("cuda"))
    assert argv == [sys.executable, "-m", "etcd_tpu_torch.harness.chaos_lease",
                    "--seed", "3"]
    assert chaos_run.lease_tier_argv(3, torch.device("cpu"))[-2:] == ["--device", "cpu"]
    assert chaos_run.LEASE_TIER_TIMEOUT_S == 1800
    assert chaos_run.read_knobs({})["lease_tier"] is True
    assert chaos_run.read_knobs({"CHAOS_LEASE": "0"})["lease_tier"] is False
    assert "CHAOS_LEASE" not in chaos_run.OFF_KNOBS
