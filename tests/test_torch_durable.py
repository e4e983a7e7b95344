"""The port's durable embedded server on the CPU against the reference:
``EtcdCluster``'s ``data_dir`` paths (etcd_tpu_torch/server/kvserver.py) and
``embed.start_etcd``'s bootstrap table (etcd_tpu_torch/embed.py).

The durable session of ``etcd_tpu_torch/harness/durable_session.py`` runs
on the port's cluster built from bench.py's small ``Spec`` (3 members, L
16), with a data dir: puts, a txn, a delete, a compaction and a lease; a
follower crashed and restarted from its backend; a member crashed with an
uncommitted batch (lost) and restarted; a clean close; ``boot_from_disk``
of the directory, a read back, an election and a put (each election by
member 0's campaign, as on the card). Every answer, each member's state at
each stage and the sha256 of each member's db file must equal the
reference's as ``tests/make_durable_pins.py`` recorded them from
the JAX package (``DURABLE_SESSION_PIN.json``); the port's files open in
the JAX package to equal stores. The bootstrap table mirrors
``tests/test_embed_bootstrap.py``'s six scripts: the two that build no
cluster here, and the four that boot and restart clusters
(``durable_session.BOOT_SCRIPTS``), whose answers, each member's state after
each boot and the db files after each close must equal the reference's pin
(``boot_small``); these four are ``slow`` (a port step costs about half a
second here), beside the live JAX session."""
from __future__ import annotations

import json
import os
import pathlib
import shutil

import pytest
import torch

from etcd_tpu_torch.harness import durable_session as ds
from etcd_tpu_torch.harness.cluster import Cluster
from etcd_tpu_torch.types import Spec

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PIN = json.loads((ROOT / "DURABLE_SESSION_PIN.json").read_text())
SMALL = PIN["small_spec"]

torch.set_num_threads(1)


def small_cluster(n_members=3, **kw):
    return Cluster(n_members=n_members, spec=Spec(M=n_members, **SMALL), **kw)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("durable"))
    api = ds.port_api()
    ec = api.EtcdCluster(cluster=small_cluster(device="cpu"), data_dir=d)
    out = ds.run_durable_session(ec, api, d, lambda: small_cluster(device="cpu"))
    return json.loads(json.dumps(ds.session_view(out))), d, out["booted"]


def test_durable_session_answers_equal_the_reference(session):
    got, _, _ = session
    want = PIN["session_small"]
    assert [r[0] for r in got["responses"]] == [r[0] for r in want["responses"]]
    for a, b in zip(got["responses"], want["responses"]):
        assert a == b, a[0]
    assert got["steps"] == want["steps"]


@pytest.mark.parametrize("stage", ["committed", "follower_down", "follower_restarted",
                                   "batch_lost_restarted", "closed", "booted",
                                   "booted_written"])
def test_durable_session_state_equals_the_reference(session, stage):
    got, _, _ = session
    assert got["state"][stage] == PIN["session_small"]["state"][stage]


def test_member_db_files_are_the_reference_bytes(session):
    got, _, _ = session
    assert got["files"] == PIN["session_small"]["files"]
    assert len(got["files"]) == 3


def test_an_uncommitted_batch_is_lost_and_the_ring_fills_the_gap(session):
    got, _, _ = session
    r = dict((n, v) for n, v in got["responses"])
    victim = [n for n in r if n.startswith("crash_member")][-1].split()[-1]
    on_disk = r[f"on disk {victim}"]["consistent_index"]
    assert r[f"pending ops {victim}"] > 0
    assert on_disk < r[f"applied at crash {victim}"]
    # the restarted member is back at its applied index through the ring,
    # its store equal to every peer's at that index
    st = got["state"]["batch_lost_restarted"]
    v = int(victim)
    assert st["applied_index"][v] == r[f"applied at crash {victim}"]
    assert {h for h, a in zip(st["hash_kv"], st["applied_index"])
            if a == st["applied_index"][v]} == {st["hash_kv"][v]}
    assert r["corruption_check"] is None
    # the booted cluster starts where the close left every member
    assert got["state"]["booted"]["applied_index"] == got["state"]["closed"]["applied_index"]
    assert got["state"]["booted"]["hash_kv"] == got["state"]["closed"]["hash_kv"]


def test_the_port_files_open_in_the_jax_package_to_equal_stores(session, tmp_path):
    from etcd_tpu.storage import schema as jschema
    from etcd_tpu.storage.backend import Backend as JBackend
    from etcd_tpu_torch.storage import schema as tschema
    from etcd_tpu_torch.storage.backend import Backend as TBackend

    _, d, _ = session
    for m in range(3):
        stores = []
        for schema, backend in ((jschema, JBackend), (tschema, TBackend)):
            path = str(tmp_path / f"{schema.__name__}{m}.db")
            shutil.copy(os.path.join(d, f"member{m}.db"), path)
            be = backend(path)
            meta = schema.load_applied_meta(be)
            st = schema.load_mvcc(be, max_rev=meta["current_rev"],
                                  compact_rev=meta["compact_rev"])
            stores.append((meta, st.current_rev, st.compact_rev, st.hash_kv(),
                           sorted((k, v[0].value, v[1]) for k, v in st.revs.items())))
            be.close()
        assert stores[0] == stores[1]


def test_no_record_of_the_session_pickles_a_class(session):
    import pickletools

    from etcd_tpu_torch.storage.backend import Backend

    _, d, _ = session
    for m in range(3):
        be = Backend(os.path.join(d, f"member{m}.db"))
        for bucket in be.buckets():
            for _, blob in be.range(bucket, b"", b"\x00"):
                if blob[:1] == b"\x80":
                    ops = {op.name for op, _, _ in pickletools.genops(blob)}
                    assert not ops & {"GLOBAL", "STACK_GLOBAL", "INST", "OBJ",
                                      "REDUCE", "NEWOBJ", "NEWOBJ_EX"}, bucket
        be.close()


def test_the_booted_cluster_serves_from_the_cpu(session):
    _, _, booted = session
    assert booted.cl.eng.device.type == "cpu"
    assert booted.cl.leader() >= 0
    assert booted.members[0].store.kv.range(b"h")[0][0].value == b"7"


# -- embed's bootstrap table (tests/test_embed_bootstrap.py's six scripts) ----

def _cfg(tmp_path, **kw):
    from etcd_tpu_torch.embed import Config

    return Config(data_dir=str(tmp_path / "data"), auto_tick=False, cluster_size=3,
                  device="cpu", **kw)


@pytest.fixture
def small_embed(monkeypatch):
    """embed builds its Cluster through the module attribute: give it the
    small Spec."""
    from etcd_tpu_torch.harness import cluster

    monkeypatch.setattr(cluster, "Cluster", small_cluster)


def test_existing_without_data_refuses(tmp_path, small_embed):
    from etcd_tpu_torch.embed import Config, start_etcd

    with pytest.raises(ValueError, match="nothing to join"):
        start_etcd(_cfg(tmp_path, initial_cluster_state="existing"))
    with pytest.raises(ValueError, match="nothing to join"):
        start_etcd(Config(auto_tick=False, initial_cluster_state="existing",
                          device="cpu"))


def test_validate_rejects_bad_flags():
    from etcd_tpu_torch.embed import Config

    with pytest.raises(ValueError, match="initial cluster state"):
        Config(initial_cluster_state="maybe").validate()
    with pytest.raises(ValueError, match="force_new_cluster"):
        Config(force_new_cluster=True).validate()


def boot_script(tmp_path, name):
    from etcd_tpu_torch.client import Client
    from etcd_tpu_torch.embed import start_etcd

    data = str(tmp_path / "data")
    got = ds.run_boot_script(name, lambda **kw: start_etcd(_cfg(tmp_path, **kw)), Client, data)
    got = json.loads(json.dumps(got))
    want = PIN["boot_small"][name]
    for a, b in zip(got["responses"], want["responses"]):
        assert a == b, a[0]
    assert got == want
    return dict(got["responses"]), got["boots"]


def value(kv):
    return kv and kv["value"]


@pytest.mark.slow
def test_new_then_restart_resumes_data(tmp_path, small_embed):
    r, boots = boot_script(tmp_path, "restart")
    assert value(r["restarted get k"]) == "v1", "restart wiped the data dir"
    assert int(r["restarted range k"]["header"]["revision"]) >= \
        int(r["range k"]["header"]["revision"])
    assert value(r["restarted get k again"]) == "v2"
    assert boots["restarted"]["applied_index"] >= boots["new"]["applied_index"]


@pytest.mark.slow
def test_absent_member_catches_up_from_peers(tmp_path, small_embed):
    r, boots = boot_script(tmp_path, "absent_member")
    assert r["corruption_check"] is None
    assert value(r["get k4"]) == "v4"
    assert len(set(boots["existing"]["hash_kv"])) == 1


@pytest.mark.slow
@pytest.mark.parametrize("lost", [None, "member0.db"])
def test_force_new_cluster_single_member(tmp_path, small_embed, lost):
    """Both force-new-cluster scripts: from member 0's data, and from a
    surviving member's when member 0's file is gone."""
    r, boots = boot_script(tmp_path, "force_new_cluster_member0_lost" if lost
                           else "force_new_cluster")
    assert boots["forced"]["members"] == 1
    assert value(r["get k"]) == "v1"
    assert value(r["get k2"]) == "v2"


# -- the JAX package beside the port (slow) -----------------------------------

@pytest.mark.slow
def test_durable_session_equals_the_jax_package(tmp_path):
    import sys

    sys.path.insert(0, str(ROOT / "tests"))
    import make_durable_pins

    ref = make_durable_pins.reference_session(small=True)
    assert ref == PIN["session_small"]
    d = str(tmp_path / "port")
    os.makedirs(d)
    api = ds.port_api()
    ec = api.EtcdCluster(cluster=small_cluster(device="cpu"), data_dir=d)
    got = ds.run_durable_session(ec, api, d, lambda: small_cluster(device="cpu"))
    assert json.loads(json.dumps(ds.session_view(got))) == ref


@pytest.mark.slow
def test_durable_session_at_the_spec_defaults_equals_the_pin(tmp_path):
    """chip_smoke.py phase 10a's script at EtcdCluster's defaults, on the CPU."""
    api = ds.port_api()
    d = str(tmp_path)
    ec = api.EtcdCluster(n_members=3, data_dir=d, device="cpu")
    got = ds.run_durable_session(ec, api, d, lambda: Cluster(n_members=3, device="cpu"))
    assert json.loads(json.dumps(ds.session_view(got))) == PIN["session"]


def test_durable_pin_carries_the_reference_keys():
    assert {"session", "session_small", "gateway", "gateway_small", "localtester",
            "localtester_small", "localtester_default", "boot_small", "small_spec",
            "made_by"} <= set(PIN)
    assert set(PIN["boot_small"]) == set(ds.BOOT_SCRIPTS)
    for name in ("session", "session_small"):
        s = PIN[name]
        assert set(s) == {"responses", "steps", "state", "files"}
        assert s["responses"][0][0] == "elect" and s["steps"] > 0
        assert len(s["files"]) == 3
