"""A scripted ``EtcdCluster`` session: the server layer's surface in about
a hundred steps, with every answer recorded in a JSON-ready form.

``run_session(ec, api)`` drives ``ec`` (an ``EtcdCluster`` of either
package: ``api`` names that package's ``Op``, ``Compare``, ``Client``,
``Session`` and ``Mutex``) through: the election, puts with and without a
lease, ranges at the head, at an older revision and over a prefix, a txn on
each branch, a watch and its events, ``delete_range``, ``compact`` and a
range below the compaction, a lease grant, keepalive and ``time_to_live``,
a short lease expired through ``advance_lease_clock`` (its key revoked), a
revoke, and a ``Client`` ``Mutex`` lock and unlock. It returns the answers,
then each member's ``hash_kv``, revision and lease list and the raft term,
commit and applied of every member (``server_state``). The same function
makes the reference's pin (tests/make_server_pins.py) and runs the port's
side (chip_smoke.py phase 9, tests/test_torch_kvserver.py)."""
from __future__ import annotations

import dataclasses
import types


def port_api():
    """The port's classes for ``run_session``."""
    from etcd_tpu_torch import client, concurrency
    from etcd_tpu_torch.server import kvserver

    return types.SimpleNamespace(Op=kvserver.Op, Compare=kvserver.Compare,
                                 Client=client.Client, Session=concurrency.Session,
                                 Mutex=concurrency.Mutex)


def jsonable(x):
    """A package-free, JSON-ready form: bytes as latin-1 text, dataclasses
    by class name and fields, exceptions by class name."""
    if isinstance(x, BaseException):
        return {"error": type(x).__name__}
    if isinstance(x, bytes):
        return x.decode("latin-1")
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return {"_": type(x).__name__,
                **{f.name: jsonable(getattr(x, f.name)) for f in dataclasses.fields(x)}}
    return {"_": type(x).__name__, "repr": repr(x)}


def _record(log, name, fn, *a, **k):
    try:
        out = fn(*a, **k)
    except Exception as e:  # noqa: BLE001 (an error is an answer too)
        out = e
    log.append([name, jsonable(out)])
    return out


def server_state(ec) -> dict:
    """Each member's hash_kv, revision and sorted lease ids, and the raft
    term, commit and applied of every member."""
    term, commit, applied = (ec.cl.leaf(n, ec.c) for n in ("term", "commit", "applied"))
    return {
        "hash_kv": [ec.hash_kv(m) for m in range(ec.M)],
        "revision": [ms.store.kv.current_rev for ms in ec.members],
        "leases": [sorted(ms.lessor.leases) for ms in ec.members],
        "applied_index": [ms.applied_index for ms in ec.members],
        "raft_term": [int(v) for v in term],
        "raft_commit": [int(v) for v in commit],
        "raft_applied": [int(v) for v in applied],
    }


def run_session(ec, api, steps: list | None = None) -> dict:
    """The scripted session on ``ec``; ``{"responses": [...], "state":
    server_state(ec)}``. ``steps``, if given, receives the cluster's step
    count after each request (the Cluster's rounds so far)."""
    # Session ids come from a class counter: start it where a fresh
    # process does, so the session's keys do not depend on earlier ones
    api.Session._next_id = 1000
    log: list = []
    rounds = [0]
    real_step = ec.cl.step

    def counted(*a, **k):
        rounds[0] += 1
        return real_step(*a, **k)

    ec.cl.step = counted
    try:
        _script(ec, api, log, steps, rounds)
    finally:
        del ec.cl.step
    return {"responses": log, "steps": rounds[0], "state": jsonable(server_state(ec))}


def _script(ec, api, log, steps, rounds):
    Op, Compare = api.Op, api.Compare

    def rec(name, fn, *a, **k):
        out = _record(log, name, fn, *a, **k)
        if steps is not None:
            steps.append((name, rounds[0]))
        return out

    lead = rec("ensure_leader", ec.ensure_leader)
    rec("put a", ec.put, b"a", b"1")
    rec("lease_grant 100", ec.lease_grant, 100, 30)
    rec("put la lease 100", ec.put, b"la", b"leased", lease=100)
    rec("put b", ec.put, b"b", b"2")
    rec("put a prev_kv", ec.put, b"a", b"3", prev_kv=True)
    rec("range a", ec.range, b"a")
    rec("range a rev 2", ec.range, b"a", rev=2)
    rec("range [a, z) serializable", ec.range, b"a", b"z", serializable=True,
        member=(lead + 1) % ec.M if isinstance(lead, int) else None)
    rec("txn success", ec.txn, [Compare(b"a", "value", "=", b"3")],
        [Op("put", b"c", b"from-txn"), Op("range", b"a")], [Op("range", b"b")])
    rec("txn failure", ec.txn, [Compare(b"a", "version", ">", 5)],
        [Op("put", b"never", b"x")], [Op("range", b"b"), Op("delete", b"c")])
    watcher = lead if isinstance(lead, int) and lead >= 0 else 0
    wid = rec("watch w/", lambda: ec.watch(watcher, b"w/", b"w0", 0, True).id)
    rec("put w/1", ec.put, b"w/1", b"x")
    rec("put w/2", ec.put, b"w/2", b"y")
    rec("delete_range w/1", ec.delete_range, b"w/1", prev_kv=True)
    rec("watch_events", ec.watch_events, watcher, wid)
    rec("delete_range b", ec.delete_range, b"b")
    rev = ec.members[watcher].store.kv.current_rev
    rec("compact", ec.compact, rev - 2)
    rec("range a rev 2 after compaction", ec.range, b"a", rev=2)
    rec("lease_keepalive 100", ec.lease_keepalive, 100)
    rec("lease_time_to_live 100", ec.lease_time_to_live, 100)
    rec("lease_grant 200 short", ec.lease_grant, 200, 1)
    rec("put ls lease 200", ec.put, b"ls", b"short", lease=200)
    for i in range(3):
        rec(f"advance_lease_clock {i}", ec.advance_lease_clock)
    rec("leases after expiry", ec.leases)
    rec("range ls after expiry", ec.range, b"ls")
    rec("lease_revoke 100", ec.lease_revoke, 100)
    rec("range la after revoke", ec.range, b"la")
    client = api.Client(ec)
    session = api.Session(client, ttl=30)
    rec("Session lease", lambda: session.lease_id)
    mutex = api.Mutex(session, b"lock/")
    rec("Mutex.lock", mutex.lock)
    rec("Mutex.is_owner", mutex.is_owner)
    rec("Mutex.unlock", mutex.unlock)
    rec("Session.close", session.close)
    rec("range lock/ prefix", client.get_prefix, b"lock/")
    rec("status", ec.status, watcher)
    rec("corruption_check", ec.corruption_check)


def _counting(ec, name, log):
    """Wrap ``ec.<name>`` so each call appends its arguments to ``log``."""
    real = getattr(ec, name)

    def wrapped(*a, **k):
        log.append([name, jsonable(list(a[:1]) + list(a[2:]))])
        return real(*a, **k)

    setattr(ec, name, wrapped)


def run_device_plane_session(ec, api) -> dict:
    """The device apply plane's script (``ec`` built with
    ``apply_plane="device"``; canonical keys, ``api.scheme`` the package's
    device_mvcc scheme): puts, a delete, a txn, a compaction and its
    boundary errors, a watch over the key space, then a crashed member
    restarted from memory, which catches up through a peer snapshot into
    its device lane. The answers, each member's digest and the state."""
    sc = api.scheme
    log: list = []
    installs: list = []
    _counting(ec, "_install_peer_snapshot", installs)
    Op, Compare = api.Op, api.Compare
    wid = _record(log, "watch", lambda: ec.watch(0, sc.key_bytes(0), b"\x00").id)
    _record(log, "put k1", ec.put, sc.key_bytes(1), sc.encode_value(42))
    _record(log, "put k0", ec.put, sc.key_bytes(0), sc.encode_value(7))
    _record(log, "put k1 again", ec.put, sc.key_bytes(1), sc.encode_value(43),
            prev_kv=True)
    _record(log, "delete k1", ec.delete_range, sc.key_bytes(1))
    _record(log, "txn", ec.txn, [Compare(sc.key_bytes(0), "version", "=", 1)],
            [Op("put", sc.key_bytes(2), sc.encode_value(5)), Op("range", sc.key_bytes(0))])
    _record(log, "compact 3", ec.compact, 3)
    _record(log, "compact 2", ec.compact, 2)
    _record(log, "compact 99", ec.compact, 99)
    _record(log, "range rev 99", ec.range, sc.key_bytes(0), rev=99)
    _record(log, "range all", ec.range, sc.key_bytes(0), b"\x00")
    _record(log, "watch_events", ec.watch_events, 0, wid)
    _record(log, "crash 2", ec.crash_member, 2)
    _record(log, "put k3", ec.put, sc.key_bytes(3), sc.encode_value(9))
    _record(log, "restart 2", ec.restart_member_from_disk, 2)
    _record(log, "stabilize", ec.stabilize)
    _record(log, "range k3 at 2", ec.range, sc.key_bytes(3), serializable=True, member=2)
    _record(log, "corruption_check", ec.corruption_check)
    del ec._install_peer_snapshot
    return {"responses": log, "installs": installs, "state": jsonable(server_state(ec))}


def run_lapped_member_session(ec, api, extra: int = 4) -> dict:
    """A member isolated until the device ring laps it: member ``m`` (not
    the leader) is cut off while L + ``extra`` puts commit, then healed;
    its host cursor is below the ring's compaction, so ``_pump`` installs a
    peer snapshot through ``snapstream.transfer``, with the
    ``raftBeforeApplySnap`` failpoint armed to fire once (the install is
    retried on the next pump). The answers, the installs and the state."""
    fp = api.failpoints
    log: list = []
    installs: list = []
    lead = _record(log, "ensure_leader", ec.ensure_leader)
    m = (lead + 1) % ec.M
    _record(log, "isolate", ec.cl.isolate, m, ec.c)
    for i in range(ec.cl.spec.L + extra):
        _record(log, f"put {i}", ec.put, b"lap/%02d" % i, b"v%d" % i)
    _counting(ec, "_install_peer_snapshot", installs)
    fp.enable("raftBeforeApplySnap", "panic")
    try:
        _record(log, "recover", ec.cl.recover, ec.c)
        # heartbeats find the lapped member; the leader snapshots it
        for i in range(16):
            _record(log, f"tick {i}", ec.tick)
            if ec.members[m].applied_index == ec.members[lead].applied_index:
                break
    finally:
        fp.disable("raftBeforeApplySnap")
        del ec._install_peer_snapshot
    _record(log, "range lap/ at the lapped member", ec.range, b"lap/", b"lap0",
            serializable=True, member=m, count_only=True)
    _record(log, "corruption_check", ec.corruption_check)
    return {"responses": log, "installs": installs, "lapped": m,
            "state": jsonable(server_state(ec))}
