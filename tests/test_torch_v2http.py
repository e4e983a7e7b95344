"""The port's v2 REST façade, v2 auth, TLS helpers and contention detector
against the JAX package's: ``server/v2http.py`` (``V2Api``),
``server/v2auth.py`` (``V2AuthStore`` and its pattern rules),
``transport.py`` (``TLSInfo``, ``resolve_client_context``, the certificate
helpers and the connection identities) and ``utils/contention.py``
(``TimeoutDetector``).

``V2Api`` and ``V2AuthStore`` are driven over each package's own
``EtcdCluster`` v2 and membership fronts (``v2_request``, ``v2_get``,
``v2_sync``, ``v2_watch``, ``v2_stats``, ``member_add``,
``member_remove``), bound to a host-only front that applies each request
as a committed entry applies it (``EtcdCluster._apply_v2`` on one member's
``V2Store``) and each membership change through the package's ``Changer``.
Consensus itself is left out here: the gateway session
(``etcd_tpu_torch/harness/durable_session.py``) sends the same kinds of
/v2 requests through the port's cluster and is held to the reference's pin
by tests/test_torch_v3rpc.py and chip_smoke.py phase 10b.

Each case draws a seeded numpy sequence of requests (keys, dirs, TTLs on a
shared fake clock, compare-and-swap, watches and their polls, members,
stats, auth users, roles and basic-auth credentials), runs it through both
packages and holds every status, body and header, every exception (class
and text) and the final v2 tree equal."""
from __future__ import annotations

import datetime
import importlib
import ssl
import types

import numpy as np
import pytest

from test_torch_server_host import call, norm
from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

PKGS = ("etcd_tpu", "etcd_tpu_torch")
SEEDS = range(12)


class FakeClock:
    def __init__(self, t: float = 1_000_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def host_front(pkg: str, clock: FakeClock):
    """One package's ``EtcdCluster`` v2 and membership fronts over a single
    member's applied tree: a proposal is applied at once, as the committed
    entry would be; a membership change goes through the package's
    ``Changer`` (its checks raise as on the cluster)."""
    kv = importlib.import_module(f"{pkg}.server.kvserver")
    v2store = importlib.import_module(f"{pkg}.server.v2store")
    EC = kv.EtcdCluster

    class HostFront:
        v2_request, v2_get, v2_sync = EC.v2_request, EC.v2_get, EC.v2_sync
        v2_watch, v2_stats = EC.v2_watch, EC.v2_stats
        member_add, member_remove = EC.member_add, EC.member_remove

        def __init__(self):
            self.v2_now = clock
            self.members = [types.SimpleNamespace(v2store=v2store.V2Store(clock=clock))]
            self.voters, self.learners = {0, 1, 2}, set()

        def ensure_leader(self) -> int:
            return 0

        def _propose(self, req, member=None):
            return EC._apply_v2(self, self.members[0], req)

        def member_config(self):
            cfg = kv.HostConfig()
            cfg.voters, cfg.learners = set(self.voters), set(self.learners)
            cfg.progress = cfg.voters | cfg.learners
            cfg.progress_learner = set(cfg.learners)
            return cfg

        def _conf_change(self, ccs, validate):
            new = validate(kv.Changer(self.member_config()))
            self.voters, self.learners = set(new.voters), set(new.learners)

    return HostFront()


def both_apis():
    clock = FakeClock()
    apis = []
    for pkg in PKGS:
        v2http = importlib.import_module(f"{pkg}.server.v2http")
        apis.append(v2http.V2Api(host_front(pkg, clock)))
    return clock, apis


def run_ops(ops, clock, apis):
    """Each op is (name, fn(api) -> value) or ("advance", seconds)."""
    for i, (name, op) in enumerate(ops):
        if name == "advance":
            clock.t += op
            continue
        a, b = (call(op, api) for api in apis)
        assert a == b, f"op {i} {name}: reference {a} != port {b}"
    ends = []
    for api in apis:
        st = api.ec.members[0].v2store
        ends.append((st.save(), norm(st.json_stats()), sorted(api._watches), st.hub.count,
                     {k: len(v) for k, v in st.hub.watchers.items()}))
    assert ends[0] == ends[1]


# -- request sequences -------------------------------------------------------------

PATHS = ["/a", "/a/b", "/d", "/d/x", "/d/y/z", "/q", "//a/../d/x", "/",
         "/_security/users/root", "/app/x", "/app"]
CREDS = [None, None, None, "root:rpw", "alice:apw", "alice:wrong", "bob:bpw"]
ROLES = ["reader", "writer", "guest", "root", "nobody"]
PERMS = [{"kv": {"read": ["/a/*"], "write": []}},
         {"kv": {"read": ["/app/*", "/d*"], "write": ["/app/*"]}},
         {"kv": {"read": [], "write": ["/*"]}},
         {"kv": {"read": ["/q"], "write": ["/q"]}}]
FIELDS = {
    "value": ["", "v1", "v2"], "dir": ["true", "false"], "prevValue": ["v1", "v2", "nope"],
    "prevIndex": ["0", "2", "5", "9"], "prevExist": ["true", "false"],
    "ttl": ["", "3", "10"], "refresh": ["true", "false"], "recursive": ["true", "false"],
    "sorted": ["true", "false"], "quorum": ["true", "false"], "wait": ["true", "false"],
    "stream": ["true", "false"], "waitIndex": ["0", "1", "4", "12"],
    "noValueOnSuccess": ["true", "false"],
}
# the values parse_key_request refuses, one of them in a tenth of the forms
INVALID = {"dir": "maybe", "prevIndex": "-1", "ttl": "x", "recursive": "bad",
           "waitIndex": "x", "prevValue": "", "wait": "true", "refresh": "true"}
# the fields each method draws more often, beside a few of any kind
LIKELY = {"GET": ("recursive", "sorted", "quorum", "wait", "waitIndex", "stream"),
          "PUT": ("value", "prevValue", "prevIndex", "prevExist", "ttl", "dir",
                  "noValueOnSuccess"),
          "POST": ("value", "ttl", "dir"),
          "DELETE": ("recursive", "dir", "prevValue", "prevIndex")}


def pick(r, seq):
    return seq[int(r.integers(0, len(seq)))]


def key_form(r, method: str) -> dict:
    likely = LIKELY.get(method, ())
    form = {k: pick(r, v) for k, v in FIELDS.items()
            if r.random() < (0.3 if k in likely else 0.04)}
    if method in ("PUT", "POST") and r.random() < 0.7:
        form["value"] = pick(r, ["v1", "v2", "v3"])
    if r.random() < 0.1:
        k = pick(r, sorted(INVALID))
        form[k] = INVALID[k]
    who = pick(r, CREDS)
    if who:
        form["_basic_auth"] = who
    return form


def admin_op(r):
    who = pick(r, CREDS)
    form = {"_basic_auth": who} if who else {}
    kind = int(r.integers(0, 9))
    if kind == 0:
        m = pick(r, ["GET", "PUT", "DELETE"])
        return f"auth {m} /enable", lambda a, m=m, f=form: a.auth_admin(m, "/enable", f)
    if kind in (1, 2, 3):
        name = pick(r, ["root", "alice", "bob"])
        m = pick(r, ["GET", "PUT", "PUT", "DELETE"])
        f = dict(form, password={"root": "rpw", "alice": "apw", "bob": "bpw"}[name])
        if r.random() < 0.5:
            f["roles"] = pick(r, [["reader"], "reader,writer", ["writer"], ""])
        if r.random() < 0.25:
            f[pick(r, ["grant", "revoke"])] = pick(r, [["reader"], "writer", ["root"]])
        path = pick(r, [f"/users/{name}", "/users"])
        return f"auth {m} {path}", lambda a, m=m, p=path, f=f: a.auth_admin(m, p, f)
    if kind in (4, 5, 6):
        name = pick(r, ROLES)
        m = pick(r, ["GET", "PUT", "PUT", "DELETE"])
        f = dict(form)
        if r.random() < 0.6:
            f["permissions"] = pick(r, PERMS)
        if r.random() < 0.35:
            f[pick(r, ["grant", "revoke"])] = pick(r, PERMS)
        path = pick(r, [f"/roles/{name}", "/roles"])
        return f"auth {m} {path}", lambda a, m=m, p=path, f=f: a.auth_admin(m, p, f)
    if kind == 7:
        creds = pick(r, CREDS)
        creds = tuple(creds.split(":")) if creds else None
        key, write, rec = pick(r, PATHS), bool(r.random() < 0.5), bool(r.random() < 0.3)
        return ("auth check", lambda a, c=creds, k=key, w=write, rc=rec:
                a.auth.check_key_access(c, k, w, rc))
    return f"auth {kind} bogus", lambda a, f=form: a.auth_admin("GET", "/nope/x", f)


def prologue(seed: int) -> list:
    """Seeds 1 mod 3 start with users and roles, seeds 2 mod 3 with auth
    enabled and the guest role kept from writing."""
    if seed % 3 == 0:
        return []
    root = {"_basic_auth": "root:rpw"}
    ops = [
        ("mk root", lambda a: a.auth_admin("PUT", "/users/root", {"password": "rpw"})),
        ("mk writer", lambda a: a.auth_admin("PUT", "/roles/writer", {"permissions": PERMS[1]})),
        ("mk reader", lambda a: a.auth_admin("PUT", "/roles/reader", {"permissions": PERMS[0]})),
        ("mk alice", lambda a: a.auth_admin("PUT", "/users/alice",
                                            {"password": "apw", "roles": ["reader"]})),
        ("mk bob", lambda a: a.auth_admin("PUT", "/users/bob",
                                          {"password": "bpw", "roles": "writer"})),
    ]
    if seed % 3 == 2:
        ops += [
            ("enable", lambda a: a.auth_admin("PUT", "/enable", root)),
            ("guest ro", lambda a: a.auth_admin("PUT", "/roles/guest", dict(
                root, revoke={"kv": {"read": [], "write": ["/*"]}}))),
        ]
    return ops


def v2_ops(seed: int, n: int = 160) -> list:
    r = np.random.default_rng(seed)
    ops = prologue(seed)
    for _ in range(n):
        kind = int(r.integers(0, 20))
        if kind < 9:
            m = pick(r, ["GET", "PUT", "PUT", "POST", "DELETE", "GET", "HEAD"])
            path, form = pick(r, PATHS), key_form(r, m)
            ops.append((f"keys {m} {path} {form}",
                        lambda a, m=m, p=path, f=form: a.keys(m, p, f)))
        elif kind == 9:
            ops.append(("advance", float(pick(r, [0.5, 1.0, 2.5, 4.0, 11.0]))))
        elif kind == 10:
            ops.append(("sync", lambda a: a.ec.v2_sync()))
        elif kind in (11, 12):
            wid = int(r.integers(1, 7))
            if r.random() < 0.8:
                ops.append((f"watch_poll {wid}", lambda a, w=wid: a.watch_poll(w)))
            else:
                ops.append((f"watch_cancel {wid}", lambda a, w=wid: a.watch_cancel(w)))
        elif kind == 13:
            which = pick(r, ["store", "self", "leader", "bogus"])
            ops.append((f"stats {which}", lambda a, w=which: a.stats(w)))
        elif kind == 14:
            m = pick(r, ["GET", "POST", "DELETE", "PATCH"])
            mid = int(r.integers(0, 6))
            form = {"id": str(mid)} if r.random() < 0.9 else {}
            if r.random() < 0.4:
                form["isLearner"] = "true"
            ops.append((f"members {m} {mid}",
                        lambda a, m=m, i=mid, f=form: a.members(m, f"/{i}", f)))
        else:
            ops.append(admin_op(r))
    return ops


@pytest.mark.parametrize("seed", SEEDS)
def test_v2api_requests_equal_the_reference(seed):
    clock, apis = both_apis()
    run_ops(v2_ops(seed), clock, apis)


@pytest.mark.parametrize("seed", SEEDS)
def test_v2_auth_store_equals_the_reference(seed):
    """V2AuthStore's own methods, seeded, after the seed's prologue."""
    r = np.random.default_rng(1000 + seed)
    ops = prologue(seed)
    for _ in range(80):
        name, role = pick(r, ["root", "alice", "bob", "carol"]), pick(r, ROLES)
        kind = int(r.integers(0, 13))
        if kind == 0:
            ops.append(("create_user", lambda a, n=name, rl=role:
                        a.auth.create_user(n, n[:1] + "pw", [rl])))
        elif kind == 1:
            ops.append(("get_user", lambda a, n=name: a.auth.get_user(n)))
        elif kind == 2:
            ops.append(("delete_user", lambda a, n=name: a.auth.delete_user(n)))
        elif kind == 3:
            g = [role] if r.random() < 0.5 else None
            v = [pick(r, ROLES)] if r.random() < 0.5 else None
            pw = pick(r, [None, "new"])
            ops.append(("update_user", lambda a, n=name, pw=pw, g=g, v=v:
                        a.auth.update_user(n, password=pw, grant=g, revoke=v)))
        elif kind == 4:
            ops.append(("create_role", lambda a, rl=role, p=pick(r, PERMS + [None]):
                        a.auth.create_role(rl, p)))
        elif kind == 5:
            ops.append(("get_role", lambda a, rl=role: a.auth.get_role(rl)))
        elif kind == 6:
            ops.append(("delete_role", lambda a, rl=role: a.auth.delete_role(rl)))
        elif kind == 7:
            g = pick(r, PERMS) if r.random() < 0.5 else None
            v = pick(r, PERMS) if r.random() < 0.5 else None
            ops.append(("update_role", lambda a, rl=role, g=g, v=v:
                        a.auth.update_role(rl, grant=g, revoke=v)))
        elif kind == 8:
            m = pick(r, ["enable_auth", "disable_auth", "auth_enabled", "all_users",
                         "all_roles"])
            ops.append((m, lambda a, m=m: getattr(a.auth, m)()))
        elif kind == 9:
            pw = pick(r, ["rpw", "apw", "bpw", "new", "x"])
            ops.append(("check_password", lambda a, n=name, pw=pw:
                        a.auth.check_password(n, pw)))
            ops.append(("is_root", lambda a, n=name, pw=pw: a.auth.is_root((n, pw))))
        else:
            ops.append(admin_op(r))
    clock, apis = both_apis()
    run_ops(ops, clock, apis)


def test_key_request_parsing_equals_the_reference():
    """parse_key_request's validation ladder on seeded forms."""
    jv2 = importlib.import_module("etcd_tpu.server.v2http")
    tv2 = importlib.import_module("etcd_tpu_torch.server.v2http")
    r = np.random.default_rng(7)
    for _ in range(400):
        m = pick(r, ["GET", "PUT", "POST", "DELETE"])
        form = key_form(r, m)
        for k in FIELDS:
            if r.random() < 0.1:
                form[k] = INVALID.get(k, pick(r, FIELDS[k]))
        assert call(jv2.parse_key_request, m, form) == call(tv2.parse_key_request, m, form)


def test_pattern_rules_equal_the_reference():
    ja = importlib.import_module("etcd_tpu.server.v2auth")
    ta = importlib.import_module("etcd_tpu_torch.server.v2auth")
    r = np.random.default_rng(3)
    pats = ["/foo", "/foo/*", "/foo*", "/*", "*", "/a/b", "/a/*", ""]
    keys = ["/foo", "/foo/bar", "/foobar", "/a", "/a/b", "/a/b/c", "/", ""]
    for p in pats:
        for k in keys:
            for fn in ("simple_match", "prefix_match"):
                assert getattr(ja, fn)(p, k) == getattr(ta, fn)(p, k), (fn, p, k)
    for _ in range(200):
        perms = {"kv": {"read": list(r.choice(pats, 2)), "write": list(r.choice(pats, 1))}}
        k, w, rec = pick(r, keys), bool(r.random() < 0.5), bool(r.random() < 0.5)
        assert ja.has_access(perms, k, w, rec) == ta.has_access(perms, k, w, rec)
    for pw in ("", "rpw", "pässword", "x" * 300):
        assert ja.hash_password(pw) == ta.hash_password(pw)


# -- the contention detector -------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_timeout_detector_equals_the_reference(seed):
    jc = importlib.import_module("etcd_tpu.utils.contention")
    tc = importlib.import_module("etcd_tpu_torch.utils.contention")
    r = np.random.default_rng(seed)
    t = [0.0]
    limit = float(pick(r, [0.5, 1.0, 2.0]))
    dets = [m.TimeoutDetector(max_duration=limit, clock=lambda: t[0]) for m in (jc, tc)]
    for i in range(300):
        t[0] += float(r.exponential(0.8))
        which = pick(r, ["tick", "other", 0, 3])
        if r.random() < 0.03:
            for d in dets:
                d.reset()
        a, b = (d.observe(which) for d in dets)
        assert a == b, i
        assert (dets[0].late_total, dets[0].max_exceeded) == \
            (dets[1].late_total, dets[1].max_exceeded)


# -- TLS ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """A CA, a server and two client certificates, made by the JAX package."""
    from etcd_tpu import transport as jt

    d = tmp_path_factory.mktemp("pki")
    ca = jt.generate_ca(str(d / "ca"))
    server = jt.issue_cert(str(d / "leaf"), ca, "server", hosts=["localhost", "127.0.0.1"])
    alice = jt.issue_cert(str(d / "leaf"), ca, "alice",
                          hosts=["alice.example.com", "10.0.0.1"], server_auth=False)
    other_ca = jt.generate_ca(str(d / "other"), common_name="other-ca")
    mallory = jt.issue_cert(str(d / "mallory"), other_ca, "alice", server_auth=False)
    return types.SimpleNamespace(dir=d, ca=ca, server=server, alice=alice, mallory=mallory)


def ctx_view(ctx):
    if ctx is None:
        return None
    return {"verify_mode": int(ctx.verify_mode), "check_hostname": ctx.check_hostname,
            "minimum_version": int(ctx.minimum_version), "protocol": int(ctx.protocol),
            "ca_certs": len(ctx.get_ca_certs())}


def tls_infos(pki, r):
    """A seeded TLSInfo's fields: real, missing and empty files, every knob."""
    files = {"": "", "server": pki.server.cert_file, "key": pki.server.key_file,
             "ca": pki.ca.trusted_ca_file, "alice": pki.alice.cert_file,
             "alice_key": pki.alice.key_file, "missing": str(pki.dir / "missing.pem")}
    return dict(
        cert_file=files[pick(r, ["", "server", "server", "missing"])],
        key_file=files[pick(r, ["", "key", "key"])],
        client_cert_file=files[pick(r, ["", "", "alice"])],
        client_key_file=files[pick(r, ["", "", "alice_key"])],
        trusted_ca_file=files[pick(r, ["", "ca", "ca", "missing"])],
        client_cert_auth=bool(r.random() < 0.4),
        insecure_skip_verify=bool(r.random() < 0.3),
        allowed_cn=pick(r, ["", "", "alice"]),
        allowed_hostname=pick(r, ["", "", "alice.example.com"]))


@pytest.mark.parametrize("seed", range(6))
def test_tls_info_contexts_equal_the_reference(pki, seed):
    from etcd_tpu import transport as jt
    from etcd_tpu_torch import transport as tt

    r = np.random.default_rng(seed)
    for _ in range(12):
        fields = tls_infos(pki, r)
        views = []
        for t in (jt, tt):
            info = t.TLSInfo(**fields)
            views.append((info.empty(), str(info),
                          call(lambda: ctx_view(info.server_context())),
                          call(lambda: ctx_view(info.client_context())),
                          call(lambda: ctx_view(t.resolve_client_context(info)))))
        assert views[0] == views[1], fields
    ctx = ssl.create_default_context()
    assert tt.resolve_client_context(ctx) is ctx
    assert tt.resolve_client_context(None) is None is jt.resolve_client_context(None)


def cert_view(path: str, base) -> dict:
    from cryptography import x509

    with open(path, "rb") as f:
        c = x509.load_pem_x509_certificate(f.read())
    exts = []
    for e in c.extensions:
        v = e.value
        if isinstance(v, x509.SubjectAlternativeName):
            v = sorted(str(n.value) for n in v)
        elif isinstance(v, x509.ExtendedKeyUsage):
            v = [u.dotted_string for u in v]
        else:
            v = repr(v)
        exts.append((e.oid.dotted_string, e.critical, v))
    return {"subject": c.subject.rfc4514_string(), "issuer": c.issuer.rfc4514_string(),
            "days": (c.not_valid_after_utc - c.not_valid_before_utc)
            // datetime.timedelta(days=1),
            "curve": c.public_key().curve.name, "hash": c.signature_hash_algorithm.name,
            "extensions": exts}


def info_view(info, base) -> dict:
    return {k: (v.replace(str(base), "<dir>") if isinstance(v, str) else v)
            for k, v in vars(info).items()}


def test_certificates_equal_the_reference(tmp_path):
    from etcd_tpu import transport as jt
    from etcd_tpu_torch import transport as tt

    views = []
    for name, t in (("jax", jt), ("port", tt)):
        base = tmp_path / name
        made = {
            "self": t.self_cert(str(base / "self"), ["localhost", "127.0.0.1:2379", "::1"],
                                validity_days=30),
            "ca": t.generate_ca(str(base / "ca"), validity_days=90),
        }
        made["leaf"] = t.issue_cert(str(base / "leaf"), made["ca"], "a/b", hosts=["h.example"],
                                    client_auth=False)
        again = t.self_cert(str(base / "self"), ["other"])
        views.append({"infos": {k: info_view(v, base) for k, v in made.items()},
                      "certs": {k: cert_view(v.cert_file, base) for k, v in made.items()},
                      "reused": open(again.cert_file).read() ==
                      open(made["self"].cert_file).read()})
    assert views[0] == views[1]
    assert views[1]["reused"]


def handshake(server_ctx, client_ctx, hostname="localhost"):
    """A TLS handshake over memory buffers; returns the server's end."""
    s_in, s_out, c_in, c_out = (ssl.MemoryBIO() for _ in range(4))
    srv = server_ctx.wrap_bio(s_in, s_out, server_side=True)
    cli = client_ctx.wrap_bio(c_in, c_out, server_hostname=hostname)
    done = set()
    for _ in range(8):
        for name, obj, out, peer in (("c", cli, c_out, s_in), ("s", srv, s_out, c_in)):
            if name not in done:
                try:
                    obj.do_handshake()
                    done.add(name)
                except ssl.SSLWantReadError:
                    pass
            data = out.read()
            if data:
                peer.write(data)
        if done == {"c", "s"}:
            break
    return srv


@pytest.mark.parametrize("server_pkg,client_pkg", [("etcd_tpu", "etcd_tpu_torch"),
                                                   ("etcd_tpu_torch", "etcd_tpu")])
def test_connection_identities_equal_the_reference(pki, server_pkg, client_pkg):
    """A server context of one package verifies the other's client context
    over a handshake; both packages read the same identity off it and hold
    the same constraints; a client of another CA is refused."""
    srv_t = importlib.import_module(f"{server_pkg}.transport")
    cli_t = importlib.import_module(f"{client_pkg}.transport")
    pkgs = [importlib.import_module(f"{p}.transport") for p in PKGS]
    server = srv_t.TLSInfo(cert_file=pki.server.cert_file, key_file=pki.server.key_file,
                           trusted_ca_file=pki.ca.trusted_ca_file, client_cert_auth=True)
    client = cli_t.TLSInfo(client_cert_file=pki.alice.cert_file,
                           client_key_file=pki.alice.key_file,
                           trusted_ca_file=pki.ca.trusted_ca_file)
    conn = handshake(server.server_context(), cli_t.resolve_client_context(client))
    assert [t.peer_common_name(conn) for t in pkgs] == ["alice", "alice"]
    for cn, host in (("", ""), ("alice", ""), ("bob", ""), ("", "alice.example.com"),
                     ("", "10.0.0.1"), ("", "bob.example.com"), ("", "10.0.0.2")):
        got = [t.check_cert_constraints(conn, cn, host) for t in pkgs]
        assert got[0] == got[1], (cn, host)
        assert got[1] == (cn in ("", "alice") and host in ("", "alice.example.com",
                                                           "10.0.0.1")), (cn, host)
    assert [t.peer_common_name(object()) for t in pkgs] == [None, None]
    bad = cli_t.TLSInfo(client_cert_file=pki.mallory.cert_file,
                        client_key_file=pki.mallory.key_file,
                        trusted_ca_file=pki.ca.trusted_ca_file)
    with pytest.raises(ssl.SSLError):
        handshake(server.server_context(), bad.client_context())
