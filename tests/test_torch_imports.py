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
    local step) run at C=2, a 3-member Cluster elects a leader, a
    two-round chaos run with crash and membership faults injects both and
    carries the telemetry plane and the black box, a DeviceBackedStore
    serves a put, the differential fuzz holds, and a KV round runs; with
    ``cryptography`` blocked too (the card's machine does not list it), an
    EtcdCluster on the small Spec elects a leader, serves a txn and a
    range, and the lease tier's keep mask lands in its Cluster; the v3
    gateway serves that range and /version over the wire, and a backend file
    written through the schema loads back to the member's store with the
    native codec; ``python -m etcd_tpu_torch.examples.raftexample --device
    cpu`` runs raftexample's demo, and a RawNode group's WAL written by the
    port replays into a MemoryStorage that a rebooted RawNode applies."""
    code = "\n".join([
        "import sys",
        "for m in ('jax', 'jaxlib', 'flax', 'etcd_tpu', 'cryptography'):",
        "    sys.modules[m] = None",
        "import dataclasses, importlib, pkgutil, torch",
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
        "from etcd_tpu_torch.device_mvcc import DevicePlane, KVSpec, init_kv, scheme",
        "from etcd_tpu_torch.device_mvcc.fuzz import differential_run",
        "from etcd_tpu_torch.server.mvcc import DeviceBackedStore",
        "from etcd_tpu_torch.server.watch import events_from_delta",
        "s = DeviceBackedStore(DevicePlane(KVSpec(keys=4), 2, device='cpu'), lane=1)",
        "t = s.write_txn(); t.put(scheme.key_bytes(1), scheme.encode_value(3)); t.end()",
        "assert s.current_rev == 2 and s.range(scheme.key_bytes(1))[1] == 1",
        "assert differential_run(KVSpec(keys=4), 4, 10, device='cpu')['parity_ok']",
        "from etcd_tpu_torch.models.engine import build_kv_round",
        "kvc = dataclasses.replace(full, wire_int16=False)",
        "st = init_fleet(spec, 2, device='cpu'); ib = empty_inbox(spec, 2, device='cpu')",
        "st, ib, kv, d = build_kv_round(kvc, spec, KVSpec(keys=4))(",
        "    st, ib, init_kv(KVSpec(keys=4), 2, 'cpu'), True, z2, zp, zp, z2, hup, no,",
        "    torch.ones((5, 5, 2), dtype=torch.bool))",
        "assert events_from_delta(d, 0) == [] and int(kv.current_rev.min()) == 1",
        "from etcd_tpu_torch.server.kvserver import Compare, EtcdCluster, Op",
        "from etcd_tpu_torch.harness.chaos_lease import _Rng",
        "from etcd_tpu_torch.types import Spec",
        "ec = EtcdCluster(cluster=Cluster(3, spec=Spec(M=3, L=16, E=1, K=2, W=4, R=2, A=2),",
        "                                 device='cpu'))",
        "ec.cl.campaign(0); ec.stabilize(); assert ec.ensure_leader() == 0",
        "assert ec.txn([Compare(b'a', 'version', '=', 0)], [Op('put', b'a', b'1')])['succeeded']",
        "assert ec.range(b'a', serializable=True)['kvs'][0].value == b'1'",
        "ec.cl._set_keep(_Rng(0).keep_mask(3, 0.2))",
        "assert ec.cl.eng.keep_mask.dtype == torch.bool",
        "ec.cl.recover()",
        "from etcd_tpu_torch.client import RemoteClient",
        "from etcd_tpu_torch.server.v3rpc import V3Server",
        "srv = V3Server(ec).start()",
        "rc = RemoteClient(f'http://127.0.0.1:{srv.port}', timeout=60)",
        "got = rc.call('/v3/kv/range', {'key': 'YQ==', 'serializable': True})",
        "assert got['kvs'][0]['value'] == 'MQ==' and b'etcdserver' in rc.get_raw('/version')",
        "srv.stop()",
        "import os, tempfile",
        "from etcd_tpu_torch.storage import schema, walcodec",
        "from etcd_tpu_torch.storage.backend import Backend",
        "d = tempfile.mkdtemp(); be = Backend(os.path.join(d, 'm.db'))",
        "schema.persist_mvcc_delta(be, ec.members[0].store.kv, 0); be.close()",
        "st = schema.load_mvcc(Backend(os.path.join(d, 'm.db')))",
        "assert st.hash_kv() == ec.hash_kv(0) and walcodec.is_native()",
        "import contextlib, io, runpy",
        "sys.argv = ['raftexample', '--device', 'cpu']; out = io.StringIO()",
        "with contextlib.redirect_stdout(out):",
        "    try:",
        "        runpy.run_module('etcd_tpu_torch.examples.raftexample', run_name='__main__')",
        "    except SystemExit as e:",
        "        assert e.code == 0, e.code",
        "assert \"node 2: {'foo': 'bar', 'hello': 'world', 'x': '42'}\" in out.getvalue(), out.getvalue()",
        "from etcd_tpu_torch.models.rawnode import RawNode",
        "from etcd_tpu_torch.storage import raftstorage, wal",
        "from etcd_tpu_torch.harness import rawnode_session",
        "assert 'etcd_tpu' not in sys.modules or sys.modules['etcd_tpu'] is None",
        "g = rawnode_session.run_wal_group(rawnode_session.port_package('cpu'), tempfile.mkdtemp())",
        "assert g['reboot']['2']['applied'] == g['reboot']['0']['applied'] > 1, g['reboot']",
        "w = wal.WAL(tempfile.mkdtemp(), metadata=b'm')",
        "w.save({'term': 1, 'vote': 0, 'commit': 1}, [{'index': 1, 'term': 1, 'type': 0, 'data': 5}])",
        "ms, _ = raftstorage.bootstrap_from_wal(wal.WAL(w.dir))",
        "ms.apply_snapshot(raftstorage.Snapshot(meta=raftstorage.SnapshotMeta(index=1, term=1,",
        "    conf_state=raftstorage.ConfState(voters=(0,)))))",
        "rn = RawNode(RaftConfig(), Spec(M=1, L=8, E=1, K=1, W=2, R=1, A=1), ms, 0, device='cpu')",
        "rn.campaign(); assert rn.status().soft_state.role == 3",
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
    from etcd_tpu_torch.device_mvcc import DevicePlane, KVSpec, init_kv
    from etcd_tpu_torch.device_mvcc.fuzz import differential_run

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kv(KVSpec(keys=4), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePlane(KVSpec(keys=4), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        differential_run(KVSpec(keys=4), 2, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.apply_run(bench.read_apply_knobs({"APPLY_MODE": "device", "APPLY_C": "2"}))
    from etcd_tpu_torch.harness.chaos_lease import run_lease_chaos
    from etcd_tpu_torch.server.kvserver import EtcdCluster

    with pytest.raises(RuntimeError, match="device='cpu'"):
        EtcdCluster(n_members=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_lease_chaos()
    from etcd_tpu_torch import localtester
    from etcd_tpu_torch.embed import Config, start_etcd

    with pytest.raises(RuntimeError, match="device='cpu'"):
        start_etcd(Config(auto_tick=False))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        localtester.run_local_tester()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        localtester.main([])
    from etcd_tpu_torch.examples import raftexample
    from etcd_tpu_torch.harness.interaction import InteractionEnv
    from etcd_tpu_torch.models.rawnode import RawNode
    from etcd_tpu_torch.storage.checkpoint import load_fleet
    from etcd_tpu_torch.storage.raftstorage import MemoryStorage
    from etcd_tpu_torch.utils.config import RaftConfig

    with pytest.raises(RuntimeError, match="device='cpu'"):
        RawNode(RaftConfig(), spec, MemoryStorage(), 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InteractionEnv()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        raftexample.Cluster(3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        raftexample.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_fleet("a file that is never opened.npz")


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
