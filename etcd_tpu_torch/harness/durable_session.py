"""Scripted sessions of the durable embedded server: an ``EtcdCluster`` with
a ``data_dir``, the v3 JSON/HTTP gateway of ``embed.start_etcd``, and the
answers of each in a JSON-ready form.

``run_durable_session(ec, api, data_dir, make_cluster)`` drives ``ec`` (an
``EtcdCluster`` of either package, built with ``data_dir``; ``api`` names
that package's ``EtcdCluster``, ``Backend``, ``schema``, ``Op`` and
``Compare``) through: the election, puts, a txn, a delete, a compaction and
a lease, ``commit_backends``; a follower crashed after
``sync_for_shutdown``, writes while it is down, and its restart from its
backend; a second member crashed with an uncommitted batch (the batch is
lost: its file holds the last committed applied-meta record) and
restarted; a clean close; then ``boot_from_disk`` of the whole directory
onto a fresh backing ``Cluster`` (``make_cluster()``), a read back from
every member, an election and a put on the booted cluster. Each election is
member 0's campaign (``campaign``), on the card as on the CPU, where a step
is dear and ticking to the election timeout would take ten or more. The
server's own ``ensure_leader`` runs in the gateway session and the local
tester. It returns the answers, the steps, each member's state at each
stage and the sha256 of each member's db file at the close.

``run_gateway_session(start, client_api)`` drives an ``embed.Etcd`` over
the wire with the package's ``RemoteClient``: put, range, txn, a lease grant
and keep-alive, a watch create and poll, an election campaign, leader and
resign, a lock and unlock, ``/health``, ``/version`` and ``/metrics``; the
v2 REST family (``/v2/keys`` writes, reads, compare-and-swap, a directory,
an in-order key, a watch and its poll, ``/v2/members``, ``/v2/stats``, and
v2 auth: users, a role, enable, and requests refused and allowed); then
closes it, starts it again on the same data dir and reads every v3 key and
a v2 key back. Fields that follow the wall clock (a lease's remaining TTL,
the cluster version the ticker's monitor sets) are left out of the answers.

``run_boot_script(name, start, client_cls, data_dir)`` runs one script of
``embed.start_etcd``'s bootstrap table (``BOOT_SCRIPTS``) and returns its
answers, each member's state after each boot and the db files after each
close.

The same functions make the reference's pins (tests/make_durable_pins.py)
and run the port's side (chip_smoke.py phase 10, tests/test_torch_durable.py
and tests/test_torch_v3rpc.py)."""
from __future__ import annotations

import base64
import hashlib
import json
import os
import types

from etcd_tpu_torch.harness.server_session import _record, jsonable


def port_api():
    """The port's classes for ``run_durable_session``."""
    from etcd_tpu_torch.server import kvserver
    from etcd_tpu_torch.storage import schema
    from etcd_tpu_torch.storage.backend import Backend

    return types.SimpleNamespace(EtcdCluster=kvserver.EtcdCluster, Backend=Backend,
                                 schema=schema, Op=kvserver.Op, Compare=kvserver.Compare)


def member_state(ec) -> dict:
    """Each member's hash_kv, revision, compact revision, consistent index
    (applied and durable), sorted lease ids, and the raft term, commit and
    applied of every member."""
    term, commit, applied = (ec.cl.leaf(n, ec.c) for n in ("term", "commit", "applied"))
    return {
        "hash_kv": [ec.hash_kv(m) for m in range(ec.M)],
        "revision": [ms.store.kv.current_rev for ms in ec.members],
        "compact_revision": [ms.store.kv.compact_rev for ms in ec.members],
        "applied_index": [ms.applied_index for ms in ec.members],
        "durable_index": [ms.durable_index for ms in ec.members],
        "leases": [sorted(ms.lessor.leases) for ms in ec.members],
        "raft_term": [int(v) for v in term],
        "raft_commit": [int(v) for v in commit],
        "raft_applied": [int(v) for v in applied],
    }


def db_files(data_dir: str) -> dict:
    """sha256 and size of each member's db file in the directory."""
    out = {}
    for name in sorted(os.listdir(data_dir)):
        if name.startswith("member") and name.endswith(".db"):
            with open(os.path.join(data_dir, name), "rb") as f:
                blob = f.read()
            out[name] = {"sha256": hashlib.sha256(blob).hexdigest(), "bytes": len(blob)}
    return out


def on_disk_meta(api, path: str) -> dict:
    """The committed applied-meta record of a member's db file, opened as a
    restart opens it (a torn tail is truncated)."""
    be = api.Backend(path)
    try:
        meta = api.schema.load_applied_meta(be) or {}
    finally:
        be.close()
    return {k: meta.get(k) for k in ("consistent_index", "term", "current_rev",
                                     "compact_rev")}


def campaign(ec) -> int:
    """Member 0 campaigns at once (rafttest's campaign verb): the election in
    a few steps, where ticking to the election timeout takes ten or more."""
    ec.cl.campaign(0, ec.c)
    ec.stabilize()
    return ec.ensure_leader()


def run_durable_session(ec, api, data_dir: str, make_cluster) -> dict:
    log: list = []
    stages: dict = {}
    steps = [0]
    counted: list = []

    def count(cl):
        real = cl.step

        def step(*a, **k):
            steps[0] += 1
            return real(*a, **k)
        cl.step = step
        counted.append(cl)

    def rec(name, fn, *a, **k):
        return _record(log, name, fn, *a, **k)

    Op, Compare = api.Op, api.Compare
    count(ec.cl)
    try:
        lead = rec("elect", campaign, ec)
        rec("put a", ec.put, b"a", b"1")
        rec("put b", ec.put, b"b", b"2")
        rec("txn", ec.txn, [Compare(b"a", "value", "=", b"1")],
            [Op("put", b"c", b"txn"), Op("range", b"a")], [Op("range", b"b")])
        rec("delete_range b", ec.delete_range, b"b", prev_kv=True)
        rec("compact 3", ec.compact, 3)
        rec("lease_grant 100", ec.lease_grant, 100, 30)
        rec("put la lease 100", ec.put, b"la", b"leased", lease=100)
        rec("commit_backends", ec.commit_backends)
        stages["committed"] = member_state(ec)

        # a follower crashed after a clean drain, writes while it is down,
        # then its restart from its backend (and the ring)
        f = (lead + 1) % ec.M
        rec("sync_for_shutdown", ec.sync_for_shutdown)
        rec(f"crash_member {f}", ec.crash_member, f)
        rec("put d while down", ec.put, b"d", b"4")
        stages["follower_down"] = member_state(ec)
        rec(f"on disk {f}", on_disk_meta, api, ec._backend_path(f))
        rec(f"restart_member_from_disk {f}", ec.restart_member_from_disk, f)
        stages["follower_restarted"] = member_state(ec)

        # a member crashed with an uncommitted batch: the batch is lost,
        # the file holds the last committed record, the ring fills the gap
        v = (lead + 2) % ec.M
        rec("put g", ec.put, b"g", b"6")
        rec(f"pending ops {v}", lambda: ec.members[v].backend._pending_ops)
        rec(f"applied at crash {v}", lambda: ec.members[v].applied_index)
        rec(f"crash_member {v}", ec.crash_member, v)
        rec(f"on disk {v}", on_disk_meta, api, ec._backend_path(v))
        rec(f"restart_member_from_disk {v}", ec.restart_member_from_disk, v)
        rec("corruption_check", ec.corruption_check)
        stages["batch_lost_restarted"] = member_state(ec)

        # a clean close (as embed's Etcd.close), then the whole directory
        rec("close", _close, ec)
        stages["closed"] = member_state(ec)
        files = db_files(data_dir)

        booted = api.EtcdCluster.boot_from_disk(data_dir, n_members=ec.M,
                                                cluster=make_cluster())
        count(booted.cl)
        stages["booted"] = member_state(booted)
        for m in range(booted.M):
            rec(f"range all at {m} serializable", booted.range, b"\x00", b"\x00",
                serializable=True, member=m)
        rec("booted elect", campaign, booted)
        rec("booted put h", booted.put, b"h", b"7")
        rec("booted range h", booted.range, b"h", serializable=True)
        rec("booted corruption_check", booted.corruption_check)
        stages["booted_written"] = member_state(booted)
    finally:
        for cl in counted:
            del cl.step
    return {"responses": log, "steps": steps[0], "files": files,
            "state": jsonable(stages), "booted": booted}


def _close(ec) -> None:
    ec.sync_for_shutdown()
    for ms in ec.members:
        if ms.backend is not None:
            ms.backend.close()


def session_view(out: dict) -> dict:
    """``run_durable_session``'s result without the live booted cluster."""
    return {k: v for k, v in out.items() if k != "booted"}


# ------------------------------------------------------------ the gateway

def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def run_gateway_session(start, client_api) -> dict:
    """The gateway script over the wire: ``start()`` returns a started
    ``embed.Etcd`` (its data dir the same on every call), driven with
    ``client_api.RemoteClient`` of the package that serves it. The session,
    a clean close, a second ``start()`` on the same data dir, and every key
    read back over the wire. Returns the answers in order."""
    log: list = []

    def rec(name, fn, *a, **k):
        return _record(log, name, fn, *a, **k)

    etcd = start()
    try:
        rc = client_api.RemoteClient(etcd.client_url, timeout=120.0)
        rec("health", lambda: rc.get_raw("/health").decode())
        rec("put a", rc.put, b"a", b"1")
        rec("put b", rc.put, b"b", b"2")
        rec("get a", rc.get, b"a")
        rec("range a", rc.call, "/v3/kv/range", {"key": _b64(b"a")})
        rec("txn", rc.call, "/v3/kv/txn", {
            "compare": [{"key": _b64(b"a"), "target": "VALUE", "result": "EQUAL",
                         "value": _b64(b"1")}],
            "success": [{"request_put": {"key": _b64(b"c"), "value": _b64(b"txn")}},
                        {"request_range": {"key": _b64(b"a")}}],
            "failure": [{"request_range": {"key": _b64(b"b")}}]})
        rec("lease_grant 7", rc.lease_grant, 7, 600)
        rec("put la lease 7", rc.put, b"la", b"leased", lease=7)
        rec("lease_keepalive 7", rc.lease_keepalive, 7)
        # the remaining TTL follows the wall clock under the ticker: only
        # the granted TTL and the keys are kept
        rec("lease_timetolive 7", lambda: {
            k: v for k, v in rc.call("/v3/lease/timetolive",
                                     {"ID": "7", "keys": True}).items() if k != "TTL"})
        w = rc.watch(b"w/", prefix=True)
        rec("watch w/", lambda: w.watch_id)
        rec("put w/1", rc.put, b"w/1", b"x")
        rec("delete w/1", rc.delete, b"w/1")
        rec("watch poll", w.events)
        rec("watch cancel", w.cancel)
        rec("lease_grant 8", rc.lease_grant, 8, 600)
        camp = rec("election campaign", rc.call, "/v3/election/campaign",
                   {"name": _b64(b"e1"), "value": _b64(b"me"), "lease": "8"})
        rec("election leader", rc.call, "/v3/election/leader", {"name": _b64(b"e1")})
        rec("election resign", rc.call, "/v3/election/resign", {"leader": camp["leader"]})
        lock = rec("lock", rc.call, "/v3/lock/lock", {"name": _b64(b"l1"), "lease": "8"})
        rec("lock key held", rc.get_prefix, b"l1")
        rec("unlock", rc.call, "/v3/lock/unlock", {"key": lock["key"]})
        rec("lock key released", rc.get_prefix, b"l1")
        rec("delete b", rc.delete, b"b")
        v2_requests(rec, etcd.client_url)
        # the cluster version follows the version monitor's ticks: only
        # the server's is kept
        rec("version", lambda: json.loads(rc.get_raw("/version"))["etcdserver"])
        rec("metrics families", lambda: metric_families(rc.get_raw("/metrics").decode()))
        rec("read back", rc.get_prefix, b"")
    finally:
        etcd.close()
    etcd = start()
    try:
        rc = client_api.RemoteClient(etcd.client_url, timeout=120.0)
        rec("restarted health", lambda: rc.get_raw("/health").decode())
        rec("restarted read back", rc.get_prefix, b"")
        rec("restarted put d", rc.put, b"d", b"4")
        rec("restarted get d", rc.get, b"d")
        rec("restarted v2 auth enabled", v2_call, etcd.client_url, "GET", "/v2/auth/enable",
            auth="root:rpw")
        rec("restarted v2 get /v2a", v2_call, etcd.client_url, "GET", "/v2/keys/v2a",
            auth="alice:apw")
        rec("restarted v2 guest write refused", v2_call, etcd.client_url, "PUT",
            "/v2/keys/v2a", {"value": "7"})
    finally:
        etcd.close()
    return {"responses": log}


def v2_call(url: str, method: str, path: str, form: dict | None = None,
            auth: str | None = None) -> list:
    """One v2 request over the wire: the form in the query of a GET, else as
    a JSON body; basic auth as ``user:password``. Returns the status, the
    JSON body and the X-Etcd-Index header."""
    import urllib.error
    import urllib.parse
    import urllib.request

    data, headers = None, {}
    if form and method == "GET":
        path += "?" + urllib.parse.urlencode(form)
    elif form:
        data = json.dumps(form).encode()
        headers["Content-Type"] = "application/json"
    if auth:
        headers["Authorization"] = "Basic " + base64.b64encode(auth.encode()).decode()
    req = urllib.request.Request(url + path, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=120.0) as r:
            status, blob, index = r.status, r.read(), r.headers.get("X-Etcd-Index")
    except urllib.error.HTTPError as e:
        status, blob, index = e.code, e.read(), e.headers.get("X-Etcd-Index")
    return [status, json.loads(blob or b"{}"), index]


def v2_requests(rec, url: str) -> None:
    """The gateway session's v2 part (no TTLs: their expirations follow the
    wall clock)."""
    def v2(name, method, path, form=None, auth=None):
        return rec(name, v2_call, url, method, path, form, auth)

    v2("v2 put /v2a", "PUT", "/v2/keys/v2a", {"value": "1"})
    v2("v2 get /v2a", "GET", "/v2/keys/v2a")
    v2("v2 put /dir/x", "PUT", "/v2/keys/dir/x", {"value": "2"})
    v2("v2 post /queue", "POST", "/v2/keys/queue", {"value": "j1"})
    v2("v2 get /dir sorted", "GET", "/v2/keys/dir", {"recursive": "true", "sorted": "true"})
    v2("v2 cas /v2a", "PUT", "/v2/keys/v2a", {"value": "3", "prevValue": "1"})
    v2("v2 cas /v2a refused", "PUT", "/v2/keys/v2a", {"value": "4", "prevValue": "1"})
    v2("v2 create /v2a refused", "PUT", "/v2/keys/v2a", {"value": "4", "prevExist": "false"})
    v2("v2 quorum get /v2a", "GET", "/v2/keys/v2a", {"quorum": "true"})
    v2("v2 bad ttl", "PUT", "/v2/keys/v2b", {"value": "1", "ttl": "x"})
    watch = v2("v2 watch /w2", "GET", "/v2/keys/w2", {"wait": "true"})
    v2("v2 put /w2", "PUT", "/v2/keys/w2", {"value": "x"})
    v2("v2 watch poll", "GET", f"/v2/watch_poll/{watch[1].get('watch_id')}")
    v2("v2 watch from history", "GET", "/v2/keys/v2a", {"wait": "true", "waitIndex": "1"})
    v2("v2 delete /dir", "DELETE", "/v2/keys/dir", {"recursive": "true"})
    v2("v2 get /dir gone", "GET", "/v2/keys/dir")
    v2("v2 members", "GET", "/v2/members")
    v2("v2 stats store", "GET", "/v2/stats/store")
    v2("v2 stats leader", "GET", "/v2/stats/leader")
    v2("v2 auth root", "PUT", "/v2/auth/users/root", {"password": "rpw"})
    v2("v2 auth role", "PUT", "/v2/auth/roles/reader",
       {"permissions": {"kv": {"read": ["/v2a"], "write": []}}})
    v2("v2 auth alice", "PUT", "/v2/auth/users/alice", {"password": "apw", "roles": ["reader"]})
    v2("v2 auth enable", "PUT", "/v2/auth/enable", auth="root:rpw")
    v2("v2 guest read only", "PUT", "/v2/auth/roles/guest",
       {"revoke": {"kv": {"read": [], "write": ["/*"]}}}, auth="root:rpw")
    v2("v2 guest write refused", "PUT", "/v2/keys/v2a", {"value": "5"})
    v2("v2 alice read", "GET", "/v2/keys/v2a", auth="alice:apw")
    v2("v2 alice write refused", "PUT", "/v2/keys/v2a", {"value": "6"}, auth="alice:apw")
    v2("v2 wrong password refused", "GET", "/v2/keys/v2a", auth="alice:nope")
    v2("v2 admin refused", "GET", "/v2/auth/users")
    v2("v2 users", "GET", "/v2/auth/users", auth="root:rpw")
    v2("v2 user alice", "GET", "/v2/auth/users/alice", auth="root:rpw")


# ------------------------------------------------------- the bootstrap table

# embed.start_etcd's bootstrap scripts (the reference's
# tests/test_embed_bootstrap.py): a restart on the data dir, an absent member
# caught up from its peers, and force-new-cluster from member 0's data and,
# with member 0's file gone, from a surviving member's
BOOT_SCRIPTS = ("restart", "absent_member", "force_new_cluster",
                "force_new_cluster_member0_lost")


def run_boot_script(name: str, start, client_cls, data_dir: str) -> dict:
    """``start(**kw)`` returns a started ``embed.Etcd`` of 3 members on
    ``data_dir`` with the ticker off (``kw`` are ``Config`` fields);
    ``client_cls`` is the package's in-process ``Client``."""
    log: list = []
    boots: dict = {}
    closes: dict = {}

    def rec(label, fn, *a, **k):
        return _record(log, label, fn, *a, **k)

    def boot(label, **kw):
        e = start(**kw)
        boots[label] = {"members": len(e.server.members), **member_state(e.server)}
        return e, client_cls(e.server)

    def close(label, e):
        e.close()
        closes[label] = db_files(data_dir)

    e, cl = boot("new")
    if name == "restart":
        rec("put k", cl.put, b"k", b"v1")
        rec("range k", cl.get_range, b"k")
        close("new", e)
        e, cl = boot("restarted")
        rec("restarted get k", cl.get, b"k")
        rec("restarted range k", cl.get_range, b"k")
        rec("restarted put k", cl.put, b"k", b"v2")
        rec("restarted get k again", cl.get, b"k")
        close("restarted", e)
    elif name == "absent_member":
        for i in range(5):
            rec(f"put k{i}", cl.put, b"k%d" % i, b"v%d" % i)
        close("new", e)
        os.remove(os.path.join(data_dir, "member2.db"))
        e, cl = boot("existing", initial_cluster_state="existing")
        rec("corruption_check", e.server.corruption_check)
        rec("get k4", cl.get, b"k4")
        close("existing", e)
    elif name in ("force_new_cluster", "force_new_cluster_member0_lost"):
        rec("put k", cl.put, b"k", b"v1")
        close("new", e)
        if name.endswith("member0_lost"):
            os.remove(os.path.join(data_dir, "member0.db"))
        e, cl = boot("forced", force_new_cluster=True)
        rec("get k", cl.get, b"k")
        rec("put k2", cl.put, b"k2", b"v2")
        rec("get k2", cl.get, b"k2")
        close("forced", e)
    else:
        raise ValueError(f"unknown boot script {name}")
    return {"responses": log, "boots": jsonable(boots), "files": closes}


def metric_families(text: str) -> list:
    """The sorted family names a /metrics page declares (its # TYPE lines)."""
    return sorted({line.split()[2] for line in text.splitlines()
                   if line.startswith("# TYPE ")})
