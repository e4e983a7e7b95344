"""The port's v3 JSON/HTTP gateway (etcd_tpu_torch/server/v3rpc.py, with
v2http.py, v2auth.py and client.py's ``RemoteClient``) on the CPU against
the reference's.

Tier-1: a ``V3Server`` over the port's ``EtcdCluster`` on bench.py's small
``Spec`` serves real HTTP on 127.0.0.1: ``/metrics`` in Prometheus
exposition format (every sample under its ``# TYPE``, histogram triplets
cumulative, a parse -> render -> parse round trip) with the reference's
families, ``/version``, the route table, the error answers, and after an
election a put, a linearizable range and a watch over the wire, and /v2
requests over the wire against the JAX package's ``V2Api``. ``slow``:
the gateway session of ``etcd_tpu_torch/harness/durable_session.py`` on
``embed.start_etcd`` (3 members, a data dir, the ticker on; the election and
lock paths, the lease service, the watch, the v2 REST family and v2 auth, a
close and a restart from disk)
held to the reference's answers in ``DURABLE_SESSION_PIN.json``."""
from __future__ import annotations

import base64
import json
import pathlib

import pytest
import torch

from etcd_tpu_torch.client import RemoteClient, RemoteError
from etcd_tpu_torch.harness import durable_session as ds
from etcd_tpu_torch.harness.cluster import Cluster
from etcd_tpu_torch.server import v3rpc
from etcd_tpu_torch.server.kvserver import EtcdCluster
from etcd_tpu_torch.types import Spec

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PIN = json.loads((ROOT / "DURABLE_SESSION_PIN.json").read_text())
SMALL = PIN["small_spec"]

torch.set_num_threads(1)


def small_cluster(n_members=3, **kw):
    return Cluster(n_members=n_members, spec=Spec(M=n_members, **SMALL), **kw)


@pytest.fixture(scope="module")
def served():
    """A V3Server over a 3-member port cluster on the CPU, no step run yet,
    with the ticker's contention detector embed arms, and a second over a
    cluster with the telemetry plane."""
    from etcd_tpu_torch.utils.contention import TimeoutDetector

    servers = []
    for kw in ({}, {"telemetry": True}):
        ec = EtcdCluster(cluster=small_cluster(device="cpu", **kw))
        ec.contention = TimeoutDetector(0.2)     # as embed's Etcd arms it
        servers.append(v3rpc.V3Server(ec).start())
    yield [(s, RemoteClient(f"http://127.0.0.1:{s.port}", timeout=60.0)) for s in servers]
    for s in servers:
        s.stop()


def scrape(rc) -> str:
    return rc.get_raw("/metrics").decode()


def test_metrics_families_equal_the_reference(served):
    _, rc = served[0]
    assert ds.metric_families(scrape(rc)) == dict(PIN["gateway_small"]["responses"])[
        "metrics families"]


def test_metrics_prometheus_conformance(served):
    """/metrics speaks exposition format: every sample under a # TYPE
    declaration, histogram triplets cumulative with +Inf == _count, and
    the text survives a parse -> re-render -> parse round trip."""
    import urllib.request

    from etcd_tpu_torch.models.telemetry import prometheus_parse, prometheus_render

    srv, rc = served[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics") as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    fams = prometheus_parse(text)
    assert fams["etcd_server_has_leader"]["type"] == "gauge"
    assert fams["etcd_server_leader_changes_seen_total"]["type"] == "counter"
    for name in ("etcd_tpu_commit_apply_lag_entries", "etcd_tpu_commit_latency_rounds",
                 "etcd_tpu_election_duration_rounds"):
        assert fams[name]["type"] == "histogram"
        assert (name + "_sum", ()) in fams[name]["samples"]
    fams2 = prometheus_parse(prometheus_render([
        (name, f["type"], f.get("help", name),
         [(k[0][len(name):], dict(k[1]), v) for k, v in f["samples"].items()])
        for name, f in fams.items()]))
    assert {n: f["samples"] for n, f in fams2.items()} == \
        {n: f["samples"] for n, f in fams.items()}
    for name in ("etcd_server_slow_apply_total", "etcd_server_slow_read_indexes_total"):
        assert fams[name]["type"] == "counter"


def test_prometheus_parse_rejects_counter_missing_type():
    from etcd_tpu_torch.models.telemetry import prometheus_parse

    with pytest.raises(ValueError, match="TYPE"):
        prometheus_parse("# HELP etcd_server_slow_apply_total The total.\n"
                         "etcd_server_slow_apply_total 3\n")


def test_version_and_routes_equal_the_reference(served):
    from etcd_tpu.server import v3rpc as jv3rpc

    _, rc = served[0]
    version = json.loads(rc.get_raw("/version"))
    assert version["etcdserver"] == dict(PIN["gateway_small"]["responses"])["version"]
    assert v3rpc.ROUTES == jv3rpc.ROUTES
    assert v3rpc.V3Api.AUTH_OPS == jv3rpc.V3Api.AUTH_OPS


def test_errors_answer_as_the_reference(served):
    import urllib.error
    import urllib.request

    srv, rc = served[0]
    with pytest.raises(RemoteError, match="unknown path /v3/nope"):
        rc.call("/v3/nope", {})
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v3/kv/put", data=b"{",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400 and json.loads(e.value.read()) == {"error": "bad json",
                                                                  "code": 3}
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope")
    assert e.value.code == 404


def test_a_write_a_read_and_a_watch_over_the_wire(served):
    srv, rc = served[0]
    ec = srv.api.ec
    with srv.api.lock:
        ec.cl.campaign(0)
        ec.stabilize()
    assert json.loads(rc.get_raw("/health")) == {"health": "true"}
    w = rc.watch(b"w/", prefix=True)
    out = rc.put(b"w/k", b"v")
    assert out["header"]["revision"] == "2" and out["header"]["member_id"] == "0"
    got = rc.call("/v3/kv/range", {"key": base64.b64encode(b"w/k").decode()})
    assert [base64.b64decode(kv["value"]) for kv in got["kvs"]] == [b"v"]
    assert w.events() == [("PUT", b"w/k", b"v")]
    assert w.cancel()
    assert ec.members[0].store.kv.current_rev == 2


V2_REQUESTS = [("PUT", "/v2/keys/t", {"value": "1"}), ("PUT", "/v2/keys/t", {"value": "2",
                                                                            "prevValue": "1"}),
               ("GET", "/v2/keys/t", None), ("GET", "/v2/keys/missing", None),
               ("PUT", "/v2/keys/u", {"value": "1", "ttl": "x"}), ("GET", "/v2/members", None),
               ("GET", "/v2/auth/users", None), ("GET", "/v2/stats/store", None)]


def test_v2_requests_over_the_wire_equal_the_reference(served):
    """The gateway routes /v2 requests to the port's V2Api over consensus;
    each answer equals the JAX package's V2Api on the same requests (over its
    EtcdCluster's v2 front, applied at once: tests/test_torch_v2http.py)."""
    from etcd_tpu.server.v2http import V2Api
    from test_torch_v2http import FakeClock, host_front

    srv, _ = served[0]
    ec = srv.api.ec
    with srv.api.lock:
        if ec.cl.leader() < 0:
            ec.cl.campaign(0)
            ec.stabilize()
    ref = V2Api(host_front("etcd_tpu", FakeClock()))
    url = f"http://127.0.0.1:{srv.port}"
    for method, path, form in V2_REQUESTS:
        got = ds.v2_call(url, method, path, form)
        if path.startswith("/v2/keys"):
            want = ref.keys(method, path[len("/v2/keys"):], form)
        elif path == "/v2/members":
            want = ref.members(method)
        elif path.startswith("/v2/auth"):
            want = ref.auth_admin(method, path[len("/v2/auth"):])
        else:
            want = ref.stats(path.rsplit("/", 1)[1])
        want = [want[0], json.loads(json.dumps(want[1])), str(want[2]["X-Etcd-Index"])]
        assert got == want, (method, path, form)


# -- the gateway session on embed.start_etcd (slow: about 60 port steps) -------

def gateway_answers(tmp_path, monkeypatch):
    from etcd_tpu_torch import client
    from etcd_tpu_torch.embed import Config, start_etcd
    from etcd_tpu_torch.harness import cluster

    monkeypatch.setattr(cluster, "Cluster", small_cluster)
    d = str(tmp_path / "data")
    out = ds.run_gateway_session(
        lambda: start_etcd(Config(cluster_size=3, data_dir=d, auto_tick=True,
                                  device="cpu")), client)
    return json.loads(json.dumps(out))


@pytest.mark.slow
def test_gateway_session_equals_the_reference(tmp_path, monkeypatch):
    got = gateway_answers(tmp_path, monkeypatch)
    want = PIN["gateway_small"]
    for a, b in zip(got["responses"], want["responses"]):
        assert a == b, a[0]
    assert got == want
    r = dict(got["responses"])
    # the election and lock paths answered, and the restart kept every
    # acknowledged write
    assert r["election leader"]["kv"]["value"] == base64.b64encode(b"me").decode()
    assert r["lock key held"] and r["lock key released"] == []
    assert r["restarted read back"] == r["read back"]


@pytest.mark.slow
def test_gateway_session_equals_the_jax_package(tmp_path, monkeypatch):
    import sys

    sys.path.insert(0, str(ROOT / "tests"))
    import make_durable_pins

    assert make_durable_pins.reference_gateway(small=True) == PIN["gateway_small"]
