"""The port stands alone: no jax, flax or etcd_tpu import anywhere in it or
in chip_smoke.py, every module importable with those blocked, a CUDA
default that raises where there is no card, the round configurations it
builds, and a refusal of what it does not implement yet."""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

from etcd_tpu_torch import bench, drive
from etcd_tpu_torch.models import engine as teng
from etcd_tpu_torch.models.metrics import build_metered_round, zero_metrics
from etcd_tpu_torch.parallel.mesh import build_scan_rounds
from etcd_tpu_torch.types import MSG_HEARTBEAT

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "etcd_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "etcd_tpu"}

torch.set_num_threads(1)


def test_no_forbidden_imports_in_the_package():
    found = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            found += [(path.name, m) for m in mods if m.split(".")[0] in FORBIDDEN]
    assert found == []
    for path in (ROOT / "chip_smoke.py",):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in names if m.split(".")[0] in FORBIDDEN]


def test_imports_and_runs_a_round_with_jax_blocked():
    """In a fresh interpreter where importing jax, flax or etcd_tpu fails,
    every module of the port (the bench and chaos entry points, the chaos
    harness and the Cluster included) imports, and on the CPU one round of
    the settle program, one of bench.py's packed, deferred and sparse
    steady program and one of the full program (chaos_run's config, every
    local step) run at C=2, a 3-member Cluster elects a leader, and a
    two-round chaos run with crash and membership faults injects both and
    carries the telemetry plane and the black box."""
    code = "\n".join([
        "import sys",
        "for m in ('jax', 'jaxlib', 'flax', 'etcd_tpu'):",
        "    sys.modules[m] = None",
        "import importlib, pkgutil, torch",
        "import etcd_tpu_torch.models.telemetry, etcd_tpu_torch.models.blackbox",
        "torch.set_num_threads(1)",
        "import etcd_tpu_torch",
        "for mod in pkgutil.walk_packages(etcd_tpu_torch.__path__, 'etcd_tpu_torch.'):",
        "    importlib.import_module(mod.name)",
        "import etcd_tpu_torch.bench",
        "from etcd_tpu_torch import drive",
        "from etcd_tpu_torch.models.engine import build_round, empty_inbox, init_fleet",
        "spec = drive.bench_spec(); cfg = drive.settle_config(spec)",
        "st = init_fleet(spec, 2, device='cpu')",
        "ib = empty_inbox(spec, 2, True, cfg.inbox_bound, device='cpu')",
        "z2 = torch.zeros((5, 2), dtype=torch.int32); zp = torch.zeros((5, 1, 2), dtype=torch.int32)",
        "no = torch.zeros((5, 2), dtype=torch.bool); hup = no.clone(); hup[0] = True",
        "st, ib = build_round(cfg, spec)(st, ib, z2, zp, zp, z2, hup, no,",
        "                                torch.ones((5, 5, 2), dtype=torch.bool))",
        "assert int((ib.type != 0).sum()) == 8, ib.type",
        "from etcd_tpu_torch import bench, drive",
        "from etcd_tpu_torch.models.state import pack_fleet",
        "_, steady = bench.configs(bench.read_knobs({'BENCH_C': '2'}), spec)",
        "st, ib = build_round(steady, spec)(pack_fleet(spec, st), ib,",
        "                                   *drive.steady_inputs(spec, 2, 'cpu'))",
        "import etcd_tpu_torch.chaos_run, etcd_tpu_torch.harness.chaos",
        "from etcd_tpu_torch.harness.cluster import Cluster",
        "from etcd_tpu_torch.utils.config import RaftConfig",
        "full = RaftConfig(pre_vote=True, check_quorum=True, inbox_bound=4,",
        "                  coalesce_commit_refresh=True, wire_int16=True)",
        "st = init_fleet(spec, 2, device='cpu'); ib = empty_inbox(spec, 2, True, device='cpu')",
        "st, ib = build_round(full, spec)(st, ib, z2, zp, zp, z2 + 1, hup, ~no,",
        "                                 torch.ones((5, 5, 2), dtype=torch.bool))",
        "assert int((ib.type != 0).sum()) > 0, ib.type",
        "cl = Cluster(3, device='cpu'); cl.campaign(0); cl.stabilize()",
        "assert cl.leader() == 0, cl.roles()",
        "from etcd_tpu_torch.harness.chaos import run_chaos",
        "from etcd_tpu_torch.utils.config import MemberChaosConfig",
        "rep = run_chaos(spec, RaftConfig(pre_vote=True, check_quorum=True, inbox_bound=4,",
        "                                 coalesce_commit_refresh=True), C=4, rounds=2,",
        "                epoch_len=1, heal_len=1, crash_p=0.3, member_p=0.9,",
        "                member=MemberChaosConfig(initial_voters=3), telemetry=True,",
        "                blackbox=True, device='cpu')",
        "assert rep['crashes_injected'] > 0 and rep['member_changes_proposed'] > 0, rep",
        "n = rep['rounds']    # one epoch a round, the WaitHealth epochs included",
        "assert rep['telemetry']['rounds'] == n and len(rep['timeline']) == n, rep",
        "assert rep['forensics']['rounds_observed'] == n, rep",
        "assert not any(m in sys.modules and sys.modules[m] is not None",
        "               for m in ('jax', 'flax', 'etcd_tpu'))",
        "print('ok')",
    ])
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default does not raise here")
    spec = drive.bench_spec()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.init_fleet(spec, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.empty_inbox(spec, 2)
    st = teng.init_fleet(spec, 2, device="cpu")
    ib = teng.empty_inbox(spec, 2, True, 4, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        drive.settle_leaders(drive.settle_config(spec), spec, st, ib)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zero_metrics()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run(bench.read_knobs({"BENCH_C": "2"}))


UNPORTED = {
    "conf_change": dict(entry_classes=("normal", "conf_change")),
    "tick": dict(local_steps=("tick", "hup", "prop")),
    "read_index": dict(local_steps=("hup", "prop", "read_index")),
    "message classes": dict(message_classes=(1, 2, 14, 17, MSG_HEARTBEAT)),
}


@pytest.mark.parametrize("what", sorted(UNPORTED))
def test_build_round_refuses_what_the_slice_does_not_implement(what):
    """These four parts of a round were refused until the general round was
    ported; build_round now builds each and runs it."""
    spec = drive.bench_spec()
    full = dict(message_classes=None, entry_classes=None)
    cfg = dataclasses.replace(drive.settle_config(spec), **{**full, **UNPORTED[what]})
    st = teng.init_fleet(spec, 2, device="cpu")
    ib = teng.empty_inbox(spec, 2, True, cfg.inbox_bound, device="cpu")
    z2 = torch.zeros((5, 2), dtype=torch.int32)
    zp = torch.zeros((5, 1, 2), dtype=torch.int32)
    on = torch.ones((5, 2), dtype=torch.bool)
    st, ib = teng.build_round(cfg, spec)(st, ib, z2 + 1, zp, zp, z2 + 3, on, on,
                                         torch.ones((5, 5, 2), dtype=torch.bool))
    assert int((st.role != 0).sum()) > 0         # campaigns started


@pytest.mark.parametrize("plane", ["telemetry", "blackbox"])
def test_build_metered_round_refuses_the_planes_not_ported(plane):
    """The planes were refused until they were ported; each now rides the
    metered round as a trailing argument and result."""
    from etcd_tpu_torch.models.blackbox import EventRing, init_blackbox
    from etcd_tpu_torch.models.telemetry import FleetTelemetry, init_telemetry

    spec = drive.bench_spec()
    cfg = drive.settle_config(spec)
    st = teng.init_fleet(spec, 2, device="cpu")
    ib = teng.empty_inbox(spec, 2, True, cfg.inbox_bound, device="cpu")
    carry = (init_telemetry(spec, st) if plane == "telemetry"
             else init_blackbox(spec, st))
    step = build_metered_round(cfg, spec, **{f"with_{plane}": True})
    args = drive.steady_inputs(spec, 2, "cpu")
    planes = (carry,) if plane == "telemetry" else (None, carry)
    out = step(st, ib, *args, zero_metrics("cpu"), *planes)
    assert len(out) == 4
    assert isinstance(out[3], FleetTelemetry if plane == "telemetry" else EventRing)
    assert int(out[3].round) == 1


def test_build_scan_rounds_refuses_a_mesh():
    spec = drive.bench_spec()
    with pytest.raises(NotImplementedError, match="mesh"):
        build_scan_rounds(drive.settle_config(spec), spec, mesh=object())


PORTED_IN_SLICE_2 = {
    "deferred_emit": dict(deferred_emit=True),
    "sparse_outbox": dict(deferred_emit=True, sparse_outbox=True),
    "packed_state": dict(packed_state=True),
    "fleet_chunks": dict(fleet_chunks=4),
}


@pytest.mark.parametrize("what", sorted(PORTED_IN_SLICE_2))
def test_build_round_takes_the_storage_and_emission_forms(what):
    spec = drive.bench_spec()
    steady = drive.steady_config(drive.settle_config(spec))
    teng.build_round(dataclasses.replace(steady, **PORTED_IN_SLICE_2[what]), spec)


def test_build_round_takes_the_slice_configs():
    spec = drive.bench_spec()
    cfg = drive.settle_config(spec)
    teng.build_round(cfg, spec)
    teng.build_round(drive.steady_config(cfg), spec)
    teng.build_round(dataclasses.replace(cfg, compact_wire=False, wire_int16=False), spec)
