"""The port's copies of the pure-host server modules against the JAX
package's: ``Lessor``, ``AuthStore`` (the simple token), ``V2Store``,
``version``, ``Changer``, ``adt`` and ``Trace``.

Each case draws a seeded numpy sequence of operations, runs it through the
reference module and through its port, and holds every return value, every
exception (its class name and text) and the final state equal. The objects
of the two packages are compared by class name and fields (``norm``)."""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import pytest

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

SEEDS = range(12)


def norm(x, _depth=0):
    """A package-free form of a value: objects by class name and fields,
    exceptions by class name and text, sets sorted."""
    if _depth > 12:
        return "<deep>"
    d = _depth + 1
    if isinstance(x, BaseException):
        return ("raise", type(x).__name__, str(x))
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return x
    if isinstance(x, (set, frozenset)):
        return ("set", sorted((norm(v, d) for v in x), key=repr))
    if isinstance(x, (list, tuple)):
        return [norm(v, d) for v in x]
    if isinstance(x, dict):
        return {repr(norm(k, d)): norm(v, d) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, {f.name: norm(getattr(x, f.name), d)
                                   for f in dataclasses.fields(x)})
    fields = getattr(x, "__slots__", None) or sorted(vars(x))
    return (type(x).__name__, {k: norm(getattr(x, k), d) for k in fields
                               if k not in ("parent", "store", "clock")})


def call(fn, *a, **k):
    try:
        return norm(fn(*a, **k))
    except Exception as e:  # noqa: BLE001 (the exception is the result)
        return norm(e)


def run_both(ops, ref, port):
    """Each op is (name, fn(obj, pkg) -> value); both logs must be equal."""
    for i, (name, op) in enumerate(ops):
        a, b = call(op, *ref), call(op, *port)
        assert a == b, f"op {i} {name}: reference {a} != port {b}"


# -- Lessor ----------------------------------------------------------------------

def lessor_ops(seed):
    r = np.random.default_rng(seed)
    ids = [int(i) for i in r.integers(1, 6, 120)]
    keys = [b"k%d" % int(i) for i in r.integers(0, 6, 120)]
    ops = []
    for n in range(120):
        lid, key, ttl = ids[n], keys[n], int(r.integers(0, 6))
        kind = int(r.integers(0, 13))
        if kind == 0:
            ops.append(("grant", lambda o, p, lid=lid, ttl=ttl: o.grant(lid, ttl)))
        elif kind == 1:
            ops.append(("revoke", lambda o, p, lid=lid: o.revoke(lid)))
        elif kind == 2:
            ops.append(("renew", lambda o, p, lid=lid: o.renew(lid)))
        elif kind == 3:
            ops.append(("ttl", lambda o, p, lid=lid: o.time_to_live(lid)))
        elif kind == 4:
            ops.append(("attach", lambda o, p, lid=lid, key=key: o.attach(lid, key)))
        elif kind == 5:
            ops.append(("detach", lambda o, p, key=key: o.detach(key)))
        elif kind == 6:
            ops.append(("lease_of", lambda o, p, key=key: o.lease_of(key)))
        elif kind == 7:
            ops.append(("promote", lambda o, p, ttl=ttl: o.promote(extend=ttl)))
        elif kind == 8:
            ops.append(("demote", lambda o, p: o.demote()))
        elif kind == 9:
            ops.append(("checkpoint", lambda o, p: o.checkpoint()))
        elif kind == 10:
            ops.append(("apply_checkpoint",
                        lambda o, p, lid=lid, ttl=ttl: o.apply_checkpoint(lid, ttl)))
        elif kind == 11:
            ops.append(("tick+expired", lambda o, p, ttl=ttl: (o.tick(ttl % 3),
                                                               o.expired(limit=2))))
        else:
            ops.append(("snapshot+restore", lambda o, p: (
                o.restore(o.to_snapshot()), o.to_snapshot())))
    ops.append(("defer", lambda o, p: o.defer_expiry(o.expired())))
    ops.append(("final", lambda o, p: (o.to_snapshot(), o.primary, o.expired(16))))
    return ops


@pytest.mark.parametrize("seed", SEEDS)
def test_lessor_equals_reference(seed):
    from etcd_tpu.server import lease as ref
    from etcd_tpu_torch.server import lease as port

    run_both(lessor_ops(seed), (ref.Lessor(min_ttl=2), ref), (port.Lessor(min_ttl=2), port))


# -- AuthStore (simple token) ----------------------------------------------------

USERS = ("root", "alice", "bob")
ROLES = ("root", "r1", "r2")


def auth_ops(seed):
    r = np.random.default_rng(seed)
    ops = [("root add", lambda o, p: o.user_add("root", salt=b"s",
                                                pw_hash=p._hash("pw-root", b"s"))),
           ("root role", lambda o, p: o.role_add("root")),
           ("root grant", lambda o, p: o.user_grant_role("root", "root"))]
    for _ in range(150):
        u, ro = USERS[int(r.integers(0, 3))], ROLES[int(r.integers(0, 3))]
        a, b = sorted(int(x) for x in r.integers(0, 8, 2))
        key = b"k%d" % a
        end = [None, b"k%d" % b, b"\x00"][int(r.integers(0, 3))]
        write, tick = bool(r.integers(0, 2)), int(r.integers(0, 120))
        perm = int(r.integers(0, 3))
        kind = int(r.integers(0, 16))
        if kind == 0:
            ops.append(("user_add", lambda o, p, u=u: o.user_add(
                u, salt=b"t", pw_hash=p._hash("pw-" + u, b"t"))))
        elif kind == 1:
            ops.append(("user_delete", lambda o, p, u=u: o.user_delete(u)))
        elif kind == 2:
            ops.append(("change_password", lambda o, p, u=u: o.user_change_password(
                u, salt=b"x", pw_hash=p._hash("pw-" + u, b"x"))))
        elif kind == 3:
            ops.append(("grant_role", lambda o, p, u=u, ro=ro: o.user_grant_role(u, ro)))
        elif kind == 4:
            ops.append(("revoke_role", lambda o, p, u=u, ro=ro: o.user_revoke_role(u, ro)))
        elif kind == 5:
            ops.append(("role_add", lambda o, p, ro=ro: o.role_add(ro)))
        elif kind == 6:
            ops.append(("role_delete", lambda o, p, ro=ro: o.role_delete(ro)))
        elif kind == 7:
            ops.append(("grant_perm", lambda o, p, ro=ro, perm=perm, key=key, end=end:
                        o.role_grant_permission(ro, p.Permission(perm, key, end))))
        elif kind == 8:
            ops.append(("revoke_perm", lambda o, p, ro=ro, key=key, end=end:
                        o.role_revoke_permission(ro, key, end)))
        elif kind == 9:
            ops.append(("enable", lambda o, p: o.auth_enable()))
        elif kind == 10:
            ops.append(("disable", lambda o, p: o.auth_disable()))
        elif kind == 11:
            # the token's text is random: the op returns what it names and
            # what it grants
            ops.append(("authenticate+check", lambda o, p, u=u, key=key, end=end,
                        write=write: _authenticate_check(o, u, key, end, write)))
        elif kind == 12:
            ops.append(("check_user", lambda o, p, u=u, key=key, end=end, write=write:
                        o.check_user(u, key, end, write)))
        elif kind == 13:
            ops.append(("tick", lambda o, p, tick=tick: (o.tick(tick), len(o.tokens))))
        elif kind == 14:
            # a second grant to the same role, abutting or overlapping
            ops.append(("grant_perm2", lambda o, p, ro=ro, perm=perm, a=a, b=b:
                        o.role_grant_permission(ro, p.Permission(
                            perm, b"k%d" % b, b"k%d" % min(8, b + 1 + a % 3)))))
        else:
            ops.append(("snapshot", lambda o, p: o.to_snapshot()))
    # every user and role back, alice on r1 and bob on r2 with whatever
    # grants the sequence left them, then every user against every range
    # over the key space, both ways
    ops.append(("users back", lambda o, p: (
        [call(o.user_add, u, salt=b"u", pw_hash=p._hash("pw-" + u, b"u")) for u in USERS],
        [call(o.role_add, ro) for ro in ROLES],
        [call(o.user_grant_role, u, ro) for u, ro in zip(USERS, ROLES)])))
    ops.append(("enable", lambda o, p: o.auth_enable()))
    ops.append(("sweep", lambda o, p: [
        call(o.check_user, u, b"k%d" % a, end, write)
        for u in USERS for a in range(8)
        for end in [None, b"\x00"] + [b"k%d" % b for b in range(a, 9)]
        for write in (False, True)]))
    ops.append(("final", lambda o, p: (o.to_snapshot(), o.enabled, o.revision,
                                       sorted(n for n, _, _ in o.tokens.values()))))
    return ops


def _authenticate_check(o, u, key, end, write):
    tok = o.authenticate(u, "pw-" + u)
    return o.auth_info(tok), call(o.check, tok, key, end, write), call(o.is_admin, tok)


@pytest.mark.parametrize("seed", SEEDS)
def test_auth_store_simple_token_equals_reference(seed):
    from etcd_tpu.server import auth as ref
    from etcd_tpu_torch.server import auth as port

    run_both(auth_ops(seed), (ref.AuthStore(), ref), (port.AuthStore(), port))


def test_auth_store_refuses_unknown_token_providers_alike():
    from etcd_tpu.server import auth as ref
    from etcd_tpu_torch.server import auth as port

    for spec in ("bogus", "jwt,ttl=x"):
        assert call(ref.AuthStore, spec) == call(port.AuthStore, spec)


# -- V2Store ----------------------------------------------------------------------

PATHS = ("/a", "/a/b", "/a/c", "/d", "/d/e/f", "/_hidden", "/a/b/x")


def v2_ops(seed):
    r = np.random.default_rng(seed)
    ops = []
    for n in range(150):
        path = PATHS[int(r.integers(0, len(PATHS)))]
        val = "v%d" % int(r.integers(0, 4))
        d, rec = bool(r.integers(0, 4) == 0), bool(r.integers(0, 2))
        exp = [None, 1000.0 + int(r.integers(0, 30))][int(r.integers(0, 2))]
        pi = int(r.integers(0, 6))
        kind = int(r.integers(0, 11))
        if kind == 0:
            ops.append(("create", lambda o, p, path=path, d=d, val=val, exp=exp:
                        o.create(path, d, val, unique=False, expire_time=exp)))
        elif kind == 1:
            ops.append(("create unique", lambda o, p, path=path, val=val:
                        o.create(path, False, val, unique=True)))
        elif kind == 2:
            ops.append(("set", lambda o, p, path=path, d=d, val=val, exp=exp:
                        o.set(path, d, val, expire_time=exp)))
        elif kind == 3:
            ops.append(("update", lambda o, p, path=path, val=val, exp=exp:
                        o.update(path, val, expire_time=exp)))
        elif kind == 4:
            ops.append(("cas", lambda o, p, path=path, val=val, pi=pi:
                        o.compare_and_swap(path, "v1", pi, val)))
        elif kind == 5:
            ops.append(("delete", lambda o, p, path=path, d=d, rec=rec:
                        o.delete(path, d, rec)))
        elif kind == 6:
            ops.append(("cad", lambda o, p, path=path, pi=pi:
                        o.compare_and_delete(path, "v2", pi)))
        elif kind == 7:
            ops.append(("get", lambda o, p, path=path, rec=rec: o.get(path, rec, True)))
        elif kind == 8:
            ops.append(("expire", lambda o, p, exp=exp: o.delete_expired_keys(
                exp or 1010.0)))
        elif kind == 9:
            ops.append(("watch", lambda o, p, path=path, rec=rec: (
                o.watch(path, rec, False, max(1, o.current_index - 2)).poll())))
        else:
            ops.append(("save+recovery", lambda o, p: o.recovery(o.save())))
    ops.append(("final", lambda o, p: (o.save(), o.json_stats(), o.index(),
                                       o.has_ttl_keys(), o.get("/", True, True))))
    return ops


@pytest.mark.parametrize("seed", SEEDS)
def test_v2store_equals_reference(seed):
    from etcd_tpu.server import v2store as ref
    from etcd_tpu_torch.server import v2store as port

    def clock():
        return 1000.0

    run_both(v2_ops(seed), (ref.V2Store(clock=clock), ref), (port.V2Store(clock=clock), port))


# -- version ------------------------------------------------------------------------

VERSIONS = ("3.4.0", "3.5.0", "3.5.7", "3.6.0", "3.6.0-tpu.4", "3.7.1", "4.0.0",
            "2.3.8", "bogus", "3.5", "")


class _Adapter:
    def __init__(self, pkg, cv, dg, versions):
        self.pkg, self.cv, self.dg, self.versions = pkg, cv, dg, versions
        self.proposed = []

    def get_cluster_version(self):
        return self.cv

    def get_downgrade_info(self):
        return self.dg

    def get_versions(self):
        return self.versions

    def update_cluster_version(self, ver):
        self.proposed.append(("version", ver))

    def downgrade_cancel(self):
        self.proposed.append(("cancel",))


@pytest.mark.parametrize("seed", SEEDS)
def test_version_equals_reference(seed):
    from etcd_tpu.server import version as ref
    from etcd_tpu_torch.server import version as port

    r = np.random.default_rng(seed)
    pick = lambda: VERSIONS[int(r.integers(0, len(VERSIONS)))]  # noqa: E731
    assert ref.SERVER_VERSION == port.SERVER_VERSION
    assert ref.MIN_CLUSTER_VERSION == port.MIN_CLUSTER_VERSION
    ops = []
    for _ in range(60):
        a, b, c = pick(), pick(), pick()
        enabled = bool(r.integers(0, 2))
        members = {m: (None if r.integers(0, 5) == 0 else
                       {"server": pick(), "cluster": pick()}) for m in range(3)}
        ops += [
            ("parse", lambda o, p, a=a: p.parse(a)),
            ("major_minor", lambda o, p, a=a: p.major_minor(a)),
            ("cluster_version_str", lambda o, p, a=a: p.cluster_version_str(a)),
            ("allowed_downgrade", lambda o, p, a=a: p.allowed_downgrade_version(a)),
            ("is_valid_downgrade", lambda o, p, a=a, b=b: p.is_valid_downgrade(a, b)),
            ("is_valid_version_change",
             lambda o, p, a=a, b=b: p.is_valid_version_change(a, b)),
            ("detect_downgrade", lambda o, p, a=a, b=b, c=c, e=enabled: p.detect_downgrade(
                a, b or None, p.DowngradeInfo(c if e else "", e))),
            ("downgrade info", lambda o, p, c=c, e=enabled: p.DowngradeInfo.from_dict(
                p.DowngradeInfo(c, e).to_dict()).to_dict()),
            ("monitor", lambda o, p, b=b, c=c, e=enabled, ms=members: (
                lambda ad: (p.VersionMonitor(ad).decide_cluster_version(),
                            p.VersionMonitor(ad).update_cluster_version_if_needed(),
                            p.VersionMonitor(ad).cancel_downgrade_if_needed(),
                            ad.proposed))(
                _Adapter(p, b or None, p.DowngradeInfo(c if e else "", e), ms))),
        ]
    run_both(ops, (None, ref), (None, port))


# -- Changer --------------------------------------------------------------------------

def _config(pkg, r, M):
    cfg = pkg.Config()
    roles = r.integers(0, 4, M)       # 0 out, 1 voter, 2 learner, 3 outgoing voter
    cfg.voters = {i for i in range(M) if roles[i] in (1, 3)} or {0}
    cfg.learners = {i for i in range(M) if roles[i] == 2} - cfg.voters
    cfg.progress = cfg.voters | cfg.learners
    cfg.progress_learner = set(cfg.learners)
    return cfg


@pytest.mark.parametrize("seed", SEEDS)
def test_changer_equals_reference(seed):
    from etcd_tpu.models import changer as ref
    from etcd_tpu_torch.models import changer as port
    from etcd_tpu_torch.types import CC_ADD_LEARNER, CC_ADD_NODE, CC_REMOVE_NODE, CC_UPDATE_NODE

    ops_kinds = (CC_ADD_NODE, CC_REMOVE_NODE, CC_UPDATE_NODE, CC_ADD_LEARNER)
    r = np.random.default_rng(seed)
    ops = []
    for _ in range(60):
        cseed = int(r.integers(0, 2**31))
        ccs = [(ops_kinds[int(r.integers(0, 4))], int(r.integers(0, 5)))
               for _ in range(int(r.integers(0, 4)))]
        mode, auto = int(r.integers(0, 4)), bool(r.integers(0, 2))

        def op(o, p, cseed=cseed, ccs=ccs, mode=mode, auto=auto):
            cfg = _config(p, np.random.default_rng(cseed), 5)
            ch = p.Changer(cfg)
            if mode == 0:
                out = ch.simple(ccs)
            elif mode == 1:
                out = ch.enter_joint(auto, ccs)
            elif mode == 2:
                joint = ch.enter_joint(auto, ccs)
                out = p.Changer(joint).leave_joint()
            else:
                out = ch.leave_joint()
            p.check_invariants(out)
            return out, out.joint()
        ops.append((f"changer mode {mode}", op))
    run_both(ops, (None, ref), (None, port))


# -- adt ------------------------------------------------------------------------------

def _ivl(p, a, b):
    if b is None:
        return p.point(b"%02d" % a)
    return p.Interval(b"%02d" % a, p.INF if b < 0 else b"%02d" % b)


@pytest.mark.parametrize("seed", SEEDS)
def test_adt_interval_tree_equals_reference(seed):
    from etcd_tpu.utils import adt as ref
    from etcd_tpu_torch.utils import adt as port

    r = np.random.default_rng(seed)
    ops = [("new", lambda o, p: o.__dict__.update(t=p.IntervalTree()))]
    for _ in range(150):
        a = int(r.integers(0, 20))
        b = [None, -1, int(r.integers(0, 22))][int(r.integers(0, 3))]
        kind = int(r.integers(0, 6))
        name = ("insert", "delete", "find", "intersects", "contains", "union")[kind]

        def op(o, p, a=a, b=b, kind=kind):
            t, iv = o.t, _ivl(p, a, b)
            if kind == 0:
                return t.insert(iv, a)
            if kind == 1:
                return t.delete(iv)
            if kind == 2:
                return t.find(iv)
            if kind == 3:
                return t.intersects(iv)
            if kind == 4:
                return t.contains(iv)
            seen = []
            t.visit(iv, lambda stored, val: seen.append((stored, val)) or True)
            return t.union(), seen
        ops.append((name, op))

    class Box:
        pass
    run_both(ops, (Box(), ref), (Box(), port))


# -- Trace ----------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_trace_equals_reference(seed, monkeypatch):
    from etcd_tpu.utils import trace as ref
    from etcd_tpu_torch.utils import trace as port

    # one shared fake clock, so the durations in the dumps agree
    clock = iter(np.arange(0.0, 1000.0, 0.125))
    now = {"t": 0.0}

    def perf_counter():
        now["t"] = float(next(clock))
        return now["t"]

    r = np.random.default_rng(seed)
    plan = [(int(r.integers(0, 4)), "s%d" % int(r.integers(0, 3)), int(r.integers(0, 9)))
            for _ in range(20)]
    logs = []
    for pkg in (ref, port):
        monkeypatch.setattr(pkg.time, "perf_counter", perf_counter)
        clock = iter(np.arange(0.0, 1000.0, 0.125))
        t = pkg.Trace("op%d" % seed, pkg.Field("member", seed))
        out = []
        for kind, key, v in plan:
            if kind == 0:
                t.step("step " + key, pkg.Field(key, v))
            elif kind == 1:
                t.add_field(pkg.Field(key, v))
            elif kind == 2:
                out.append(t.duration())
            else:
                out.append(pkg.Trace.todo().is_empty)
        out += [re.sub(r"trace\[\d+\]", "trace[id]", t.format()), t.to_span(),
                t.log_if_long(1e9)]
        logs.append(norm(out))
    assert logs[0] == logs[1]
