"""The port's ``EtcdCluster`` (etcd_tpu_torch/server/kvserver.py) on the CPU
against the reference's (etcd_tpu/server/kvserver.py).

The scripted sessions of ``etcd_tpu_torch/harness/server_session.py`` run
on both packages' clusters, built from bench.py's small ``Spec`` (3 members,
L 16) to keep a port step cheap, and every answer, each member's
``hash_kv``, revision and leases and the raft term, commit and applied of
every member must be equal. The tier-1 cases hold the port to the
reference's answers as ``tests/make_server_pins.py`` recorded them from the
JAX package (``SERVER_SESSION_PIN.json``); the ``slow`` cases run the JAX
package beside the port (its round program takes about two minutes to
compile here) and hold the port's session at the ``Spec`` defaults to the
pin chip_smoke.py phase 9 uses."""
from __future__ import annotations

import ast
import json
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from etcd_tpu_torch.harness import server_session as ss
from etcd_tpu_torch.harness.cluster import Cluster
from etcd_tpu_torch.server import kvserver
from etcd_tpu_torch.types import Spec

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PIN = json.loads((ROOT / "SERVER_SESSION_PIN.json").read_text())
SMALL = PIN["small_spec"]

torch.set_num_threads(1)


def port_api():
    from etcd_tpu_torch.device_mvcc import scheme
    from etcd_tpu_torch.utils import failpoints

    api = ss.port_api()
    api.failpoints, api.scheme = failpoints, scheme
    return api


def port_cluster(**kw):
    return kvserver.EtcdCluster(
        cluster=Cluster(n_members=3, spec=Spec(M=3, **SMALL), device="cpu"), **kw)


class Watch:
    """Counts what the server must not do with the device state: any numpy
    conversion of a tensor (``np.asarray`` on a CUDA tensor fails), and the
    reads each ``_pump`` makes through the helper."""

    def __init__(self, monkeypatch, ec):
        self.array_calls = 0
        self.pump_reads: list[int] = []
        real_array = torch.Tensor.__array__

        def array(t, *a, **k):
            self.array_calls += 1
            return real_array(t, *a, **k)

        monkeypatch.setattr(torch.Tensor, "__array__", array)
        reads = [0]
        real_read, real_pump = ec._read, ec._pump

        def read(*a, **k):
            reads[0] += 1
            return real_read(*a, **k)

        def pump():
            reads[0] = 0
            real_pump()
            self.pump_reads.append(reads[0])

        monkeypatch.setattr(ec, "_read", read)
        monkeypatch.setattr(ec, "_pump", pump)


@pytest.fixture(scope="module")
def session():
    mp = pytest.MonkeyPatch()
    try:
        ec = port_cluster()
        watch = Watch(mp, ec)
        out = ss.run_session(ec, port_api())
    finally:
        mp.undo()
    return json.loads(json.dumps(out)), watch


def test_session_answers_equal_the_reference(session):
    out, _ = session
    want = PIN["session_small"]
    assert [r[0] for r in out["responses"]] == [r[0] for r in want["responses"]]
    for got, ref in zip(out["responses"], want["responses"]):
        assert got == ref, got[0]
    assert out["steps"] == want["steps"]


def test_session_state_equals_the_reference(session):
    out, _ = session
    assert out["state"] == PIN["session_small"]["state"]
    # the script reached the paths it names
    names = dict((n, v) for n, v in out["responses"])
    assert names["range a rev 2 after compaction"] == {"error": "ErrCompacted"}
    assert names["range ls after expiry"]["count"] == 0
    assert [e["type"] for e in names["watch_events"]] == ["put", "put", "delete"]
    assert names["txn success"]["succeeded"] and not names["txn failure"]["succeeded"]
    assert names["Mutex.is_owner"] is True


def test_server_reads_device_leaves_only_through_its_helper(session):
    _, watch = session
    # no tensor went through numpy's conversion (np.asarray on a CUDA
    # tensor raises) while the session ran
    assert watch.array_calls == 0
    # and the source takes no other route to the state
    src = (ROOT / "etcd_tpu_torch/server/kvserver.py").read_text()
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("asarray", "array") \
                and isinstance(node.func.value, ast.Name) and node.func.value.id == "np":
            pytest.fail(f"np.{node.func.attr} at kvserver.py:{node.lineno}")
    assert not re.search(r"\.cl\.s\b|\.cl\.(get|leaf)\(", src)
    reads = [i for i, line in enumerate(src.splitlines()) if "eng.state" in line]
    helper = src.splitlines().index("    def _read(self, *names: str, m: int | None = None)"
                                    " -> list[np.ndarray]:")
    assert len(reads) == 1 and 0 < reads[0] - helper < 8, reads


def test_pump_takes_its_leaves_off_the_device_in_one_transfer(session):
    _, watch = session
    assert watch.pump_reads and set(watch.pump_reads) == {1}


def test_a_data_dir_member_restarts_from_its_backend(tmp_path):
    """A member with a data_dir stages its applied state in its backend
    file; crashed, it comes back from that file (bootstrap.go:145), not
    empty."""
    ec = port_cluster(data_dir=str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"member{m}.db" for m in range(3)]
    ms = ec.members[1]
    txn = ms.store.kv.write_txn()
    txn.put(b"k", b"v", 0)
    txn.end()
    ms.lessor.grant(7, 30)
    ms.applied_index = 1
    ec._persist(ms, 1)
    ec.commit_backends()
    assert ec.members[1].durable_index == 1
    ec.crash_member(1)
    assert ec.members[1].crashed and ec.members[1].store.kv.current_rev == 1
    ec.restart_member_from_disk(1)
    ms = ec.members[1]
    assert not ms.crashed and ms.applied_index == ms.durable_index == 1
    assert ms.store.kv.range(b"k")[0][0].value == b"v"
    assert sorted(ms.lessor.leases) == [7]
    assert ms.backend.path == ec.member_db_path(str(tmp_path), 1)
    # the device plane has no backend path, as in the reference
    with pytest.raises(kvserver.ServerError, match="persistence"):
        port_cluster(data_dir=str(tmp_path), apply_plane="device")


def test_server_runs_on_the_card_unless_asked(monkeypatch):
    # device=None is the card: on a machine without one it raises rather
    # than fall back to the CPU
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(Exception):
        kvserver.EtcdCluster(n_members=3)


def _device_plane_answers():
    ec = port_cluster(apply_plane="device", kv_keys=16)
    assert ec.device_plane.device.type == "cpu"
    return json.loads(json.dumps(ss.run_device_plane_session(ec, port_api())))


@pytest.mark.slow
def test_device_apply_plane_session_equals_the_reference():
    """About 35 s here: slow, to keep the tier-1 tests inside their time."""
    got, want = _device_plane_answers(), PIN["device_plane_small"]
    for a, b in zip(got["responses"], want["responses"]):
        assert a == b, a[0]
    assert got == want
    # the crashed member caught up through a peer snapshot into its lane
    assert got["installs"] and got["state"]["hash_kv"] == [got["state"]["hash_kv"][0]] * 3


@pytest.mark.slow
def test_lapped_member_installs_a_peer_snapshot_as_the_reference():
    got = json.loads(json.dumps(ss.run_lapped_member_session(port_cluster(), port_api())))
    want = PIN["lapped_member_small"]
    for a, b in zip(got["responses"], want["responses"]):
        assert a == b, a[0]
    assert got == want
    # the failpoint fired on the first install and the retry installed
    assert len(got["installs"]) == 2
    assert {"error": "FailpointPanic"} in [v for _, v in got["responses"]]


# -- the JAX package beside the port (slow: its programs compile for minutes) ---

def reference_api():
    from etcd_tpu import client, concurrency
    from etcd_tpu.device_mvcc import scheme
    from etcd_tpu.server.kvserver import Compare, Op
    from etcd_tpu.utils import failpoints

    return types.SimpleNamespace(Op=Op, Compare=Compare, Client=client.Client,
                                 Session=concurrency.Session, Mutex=concurrency.Mutex,
                                 failpoints=failpoints, scheme=scheme)


def reference_cluster(**kw):
    from etcd_tpu.harness.cluster import Cluster as JCluster
    from etcd_tpu.server.kvserver import EtcdCluster as JEtcdCluster
    from etcd_tpu.types import Spec as JSpec

    return JEtcdCluster(cluster=JCluster(n_members=3, spec=JSpec(M=3, **SMALL)), **kw)


@pytest.mark.slow
@pytest.mark.parametrize("script", ["session", "device_plane", "lapped_member"])
def test_scripts_equal_the_jax_package(script):
    kw = {"apply_plane": "device", "kv_keys": 16} if script == "device_plane" else {}
    run = {"session": ss.run_session, "device_plane": ss.run_device_plane_session,
           "lapped_member": ss.run_lapped_member_session}[script]
    ref = json.loads(json.dumps(run(reference_cluster(**kw), reference_api())))
    got = json.loads(json.dumps(run(port_cluster(**kw), port_api())))
    assert got == ref
    assert ref == PIN[f"{script}_small"]


@pytest.mark.slow
def test_session_at_the_spec_defaults_equals_the_pin():
    """chip_smoke.py phase 9a's script at EtcdCluster's defaults (3
    members, the Spec defaults), on the CPU."""
    ec = kvserver.EtcdCluster(n_members=3, device="cpu")
    got = json.loads(json.dumps(ss.run_session(ec, port_api())))
    assert got == PIN["session"]


def test_session_pin_carries_the_reference_keys():
    assert {"session", "session_small", "device_plane_small", "lapped_member_small",
            "small_spec", "made_by"} <= set(PIN)
    for name in ("session", "session_small"):
        s = PIN[name]
        assert set(s) == {"responses", "steps", "state"}
        assert set(s["state"]) == {"hash_kv", "revision", "leases", "applied_index",
                                   "raft_term", "raft_commit", "raft_applied"}
        assert len(s["state"]["hash_kv"]) == 3 and s["steps"] > 0
        assert [r[0] for r in s["responses"]][:2] == ["ensure_leader", "put a"]
    assert np.all(np.asarray(PIN["lapped_member_small"]["state"]["revision"])
                  == PIN["lapped_member_small"]["state"]["revision"][0])
