"""Network façade: the v3 API served over JSON/HTTP
(etcd_tpu/server/v3rpc.py).

The reference serves clients gRPC (server/etcdserver/api/v3rpc/grpc.go:39)
plus a JSON/HTTP mapping of the exact same services via the gRPC gateway
(api/etcdserverpb/rpc.proto's google.api.http annotations: /v3/kv/range,
/v3/kv/put, /v3/lease/grant, ...), and a plain-HTTP sidecar for
/health, /version and /metrics (api/etcdhttp). The TPU build serves the
gateway mapping directly — same paths, same JSON field conventions
(bytes base64-encoded, int64s as strings accepted) — over a threaded
stdlib HTTP server; one process-wide lock serializes access to the
EtcdCluster, mirroring the reference's single apply loop.

Streams: gRPC's bidi Watch/LeaseKeepAlive become create/poll/cancel
POSTs (a long-poll gateway, the same shape the reference's gateway
emulates with chunked JSON frames).

Election/Lock: the v3election/v3lock services
(server/etcdserver/api/v3election, v3lock) are served on their gateway
paths, implemented over the same concurrency recipes the client library
uses, bound to the caller's lease.
"""
from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from etcd_tpu_torch.client import Client
from etcd_tpu_torch.concurrency import Election, Mutex, Session
from etcd_tpu_torch.server.kvserver import Compare, EtcdCluster, Op, ServerError

from etcd_tpu_torch.server.version import MIN_CLUSTER_VERSION, SERVER_VERSION
from etcd_tpu_torch.utils.trace import Field, Trace

__version__ = SERVER_VERSION


def _b64(b: bytes | None) -> str | None:
    return base64.b64encode(b).decode() if b is not None else None


def _unb64(s: str | None) -> bytes | None:
    return base64.b64decode(s) if s is not None else None


def _int(v, default=0) -> int:
    if v is None:
        return default
    return int(v)  # the gateway accepts int64 as JSON string


def _kv_json(kv) -> dict:
    return {
        "key": _b64(kv.key),
        "value": _b64(kv.value),
        "create_revision": str(kv.create_revision),
        "mod_revision": str(kv.mod_revision),
        "version": str(kv.version),
        "lease": str(kv.lease),
    }


def _header_json(h) -> dict:
    return {
        "cluster_id": "1", "member_id": str(h.member_id),
        "revision": str(h.revision), "raft_term": str(h.raft_term),
    }


class _BoundSession(Session):
    """A Session over a caller-provided lease (v3election campaign takes
    the lease id on the wire, v3election/v3electionpb)."""

    def __init__(self, client: Client, lease_id: int):
        self.client = client
        self.lease_id = lease_id


class V3Api:
    """Request-level service implementation, transport-free (the analog
    of the v3rpc service structs); V3Server wires it to HTTP."""

    def __init__(self, ec: EtcdCluster):
        self.ec = ec
        self.lock = threading.RLock()
        self._watch_member = 0

    # -- kv ------------------------------------------------------------------
    # every KV handler opens the request's Trace HERE — the earliest
    # host-side point, so the recorded span covers json-decode-to-respond
    # (the reference starts its traceutil.Trace at the grpc handler,
    # v3_server.go:95-133); kvserver threads it through propose ->
    # wait-applied -> respond and retires it into ec.req_spans for
    # blackbox.to_chrome_trace
    def kv_range(self, q: dict) -> dict:
        trace = Trace("range", Field("rpc", "kv_range"))
        kvs = self.ec.range(
            _unb64(q["key"]),
            _unb64(q.get("range_end")),
            rev=_int(q.get("revision")),
            limit=_int(q.get("limit")),
            serializable=bool(q.get("serializable")),
            count_only=bool(q.get("count_only")),
            token=q.get("_token"),
            trace=trace,
        )
        return {
            "header": _header_json(kvs["header"]),
            "kvs": [_kv_json(kv) for kv in kvs["kvs"]],
            "count": str(kvs["count"]),
        }

    def _header(self) -> dict:
        return _header_json(self.ec._header(self.ec.ensure_leader()))

    def kv_put(self, q: dict) -> dict:
        trace = Trace("put", Field("rpc", "kv_put"))
        res = self.ec.put(
            _unb64(q["key"]), _unb64(q.get("value")) or b"",
            lease=_int(q.get("lease")),
            prev_kv=bool(q.get("prev_kv")),
            token=q.get("_token"),
            trace=trace,
        )
        out = {"header": self._header()}
        if res.get("prev_kv"):
            out["prev_kv"] = _kv_json(res["prev_kv"])
        return out

    def kv_deleterange(self, q: dict) -> dict:
        trace = Trace("delete_range", Field("rpc", "kv_deleterange"))
        res = self.ec.delete_range(
            _unb64(q["key"]), _unb64(q.get("range_end")),
            prev_kv=bool(q.get("prev_kv")),
            token=q.get("_token"),
            trace=trace,
        )
        out = {
            "header": self._header(),
            "deleted": str(res["deleted"]),
        }
        if res.get("prev_kvs"):
            out["prev_kvs"] = [_kv_json(kv) for kv in res["prev_kvs"]]
        return out

    def _parse_op(self, j: dict) -> Op:
        if "request_put" in j:
            p = j["request_put"]
            return Op("put", _unb64(p["key"]), _unb64(p.get("value")) or b"",
                      lease=_int(p.get("lease")))
        if "request_delete_range" in j:
            p = j["request_delete_range"]
            return Op("delete", _unb64(p["key"]), range_end=_unb64(p.get("range_end")))
        if "request_range" in j:
            p = j["request_range"]
            return Op("range", _unb64(p["key"]),
                      range_end=_unb64(p.get("range_end")),
                      rev=_int(p.get("revision")), limit=_int(p.get("limit")))
        raise ServerError("unsupported txn op")

    def _parse_cmp(self, j: dict) -> Compare:
        target = j.get("target", "VALUE").lower()
        result = {"EQUAL": "=", "GREATER": ">", "LESS": "<",
                  "NOT_EQUAL": "!="}[j.get("result", "EQUAL")]
        key = _unb64(j["key"])
        if target == "value":
            return Compare(key, "value", result, _unb64(j.get("value")) or b"")
        field = {"version": "version", "create": "create", "mod": "mod",
                 "lease": "lease"}[target]
        val = _int(j.get(field if field != "create" else "create_revision",
                         j.get(field + "_revision", j.get(field))))
        return Compare(key, field, result, val)

    def kv_txn(self, q: dict) -> dict:
        trace = Trace("txn", Field("rpc", "kv_txn"))
        res = self.ec.txn(
            [self._parse_cmp(c) for c in q.get("compare", [])],
            [self._parse_op(o) for o in q.get("success", [])],
            [self._parse_op(o) for o in q.get("failure", [])],
            token=q.get("_token"),
            trace=trace,
        )
        responses = []
        for entry in res["responses"]:
            kind = entry[0]
            if kind == "put":
                responses.append({"response_put": {"header": {}}})
            elif kind == "delete":
                responses.append(
                    {"response_delete_range": {"deleted": str(entry[1])}}
                )
            else:  # ("range", kvs, count) — a 3-tuple, unlike the others
                responses.append({
                    "response_range": {
                        "kvs": [_kv_json(kv) for kv in entry[1]],
                        "count": str(entry[2]),
                    }
                })
        return {
            "header": self._header(),
            "succeeded": res["succeeded"],
            "responses": responses,
        }

    def kv_compaction(self, q: dict) -> dict:
        self.ec.compact(_int(q.get("revision")))
        return {"header": {}}

    # -- watch (create/poll/cancel/progress long-poll mapping) ---------------
    # fragment budget: the reference splits WatchResponses at the stream's
    # maxRequestBytes (1.5 MiB default, sendFragments at
    # api/v3rpc/watch.go:508-545); here the budget bounds the JSON body
    MAX_WATCH_RESPONSE_BYTES = 3 << 20

    def watch(self, q: dict) -> dict:
        if "create_request" in q:
            c = q["create_request"]
            known = {"NOPUT": "put", "NODELETE": "delete"}
            bad = [f for f in c.get("filters", []) if f not in known]
            if bad:
                raise ServerError(f"unknown watch filters {bad}")
            filters = tuple(known[f] for f in c.get("filters", []))
            trace = Trace("watch_create", Field("rpc", "watch"))
            w = self.ec.watch(
                self._watch_member,
                _unb64(c["key"]), _unb64(c.get("range_end")),
                start_rev=_int(c.get("start_revision")),
                prev_kv=bool(c.get("prev_kv")),
                fragment=bool(c.get("fragment")),
                progress_notify=bool(c.get("progress_notify")),
                filters=filters,
            )
            trace.step("watcher registered", Field("watch_id", w.id))
            trace.log_if_long(self.ec.TRACE_THRESHOLD_S)
            self.ec._record_span(trace)
            return {"created": True, "watch_id": str(w.id)}
        if "poll_request" in q:
            return self._watch_poll(q["poll_request"])
        if "progress_request" in q:
            # WatchProgressRequest (watch.go:339-345): a bare revision
            # header, watch_id -1, "broadcast" to the stream
            rev = self.ec.watch_progress(self._watch_member)
            return {"watch_id": "-1",
                    "header": {"revision": str(rev)}}
        if "cancel_request" in q:
            wid = _int(q["cancel_request"]["watch_id"])
            return {"canceled": self.ec.cancel_watch(self._watch_member, wid),
                    "watch_id": str(wid)}
        raise ServerError("watch: need create/poll/cancel/progress request")

    def _watch_poll(self, p: dict) -> dict:
        m = self._watch_member
        wid = _int(p["watch_id"])
        budget = _int(p.get("max_response_bytes")) or \
            self.MAX_WATCH_RESPONSE_BYTES
        store = self.ec.members[m].store
        watcher = store.get_watcher(wid)
        frag_on = watcher is not None and watcher.fragment
        store.sync_watchers()  # one catch-up pass for this poll
        events, size = [], 0
        while True:
            batch = store.take_events(wid, limit=1 if frag_on else None)
            if not batch:
                break
            for e in batch:
                ej = {
                    "type": "PUT" if e.type == "put" else "DELETE",
                    "kv": _kv_json(e.kv),
                    **({"prev_kv": _kv_json(e.prev_kv)} if e.prev_kv else {}),
                }
                events.append(ej)
                size += len(json.dumps(ej))
            if not frag_on or size >= budget:
                break
        more = self.ec.watch_pending(m, wid) > 0
        resp = {
            "watch_id": str(wid),
            "header": {
                "revision": str(self.ec.members[m].store.kv.current_rev)
            },
            "events": events,
        }
        if frag_on and more:
            # sendFragments: every response but the last is marked
            resp["fragment"] = True
        if (not events and not more and watcher is not None
                and watcher.progress_notify):
            # idle progress notification (WatchResponse with no events and
            # a current revision header, watch.go progress path)
            rev = self.ec.watch_progress(m, wid)
            if rev is not None:
                resp["progress_notify"] = True
        return resp

    # -- lease ---------------------------------------------------------------
    def lease_grant(self, q: dict) -> dict:
        res = self.ec.lease_grant(_int(q.get("ID")), _int(q.get("TTL")))
        return {"ID": str(res["id"]), "TTL": str(res["ttl"]), "header": {}}

    def lease_revoke(self, q: dict) -> dict:
        self.ec.lease_revoke(_int(q.get("ID")))
        return {"header": {}}

    def lease_keepalive(self, q: dict) -> dict:
        res = self.ec.lease_keepalive(_int(q.get("ID")))
        return {"ID": str(res["id"]), "TTL": str(res["ttl"]), "header": {}}

    def lease_timetolive(self, q: dict) -> dict:
        res = self.ec.lease_time_to_live(_int(q.get("ID")))
        out = {"ID": str(res["id"]), "TTL": str(res["ttl"]),
               "grantedTTL": str(res.get("granted_ttl", res["ttl"])),
               "header": {}}
        if q.get("keys"):
            out["keys"] = [_b64(k) for k in res.get("keys", [])]
        return out

    def lease_leases(self, q: dict) -> dict:
        return {"leases": [{"ID": str(i)} for i in self.ec.leases()],
                "header": {}}

    # -- cluster -------------------------------------------------------------
    def member_add(self, q: dict) -> dict:
        mid = _int(q.get("ID"))
        self.ec.member_add(mid, learner=bool(q.get("is_learner")))
        return {"header": {}, "member": {"ID": str(mid),
                                         "is_learner": bool(q.get("is_learner"))}}

    def member_remove(self, q: dict) -> dict:
        self.ec.member_remove(_int(q.get("ID")))
        return {"header": {}}

    def member_promote(self, q: dict) -> dict:
        self.ec.member_promote(_int(q.get("ID")))
        return {"header": {}}

    def member_list(self, q: dict) -> dict:
        cfg = self.ec.member_config()
        return {
            "header": {},
            "members": [
                {"ID": str(i), "is_learner": i in cfg.learners}
                for i in sorted(cfg.progress)
            ],
        }

    # -- maintenance ---------------------------------------------------------
    def maintenance_status(self, q: dict) -> dict:
        st = self.ec.status(q.get("_member", self.ec.ensure_leader()))
        return {**{k: (str(v) if isinstance(v, int) else v)
                   for k, v in st.items()}, "version": __version__}

    def maintenance_hash_kv(self, q: dict) -> dict:
        m = q.get("_member", self.ec.ensure_leader())
        return {"hash": str(self.ec.hash_kv(m, _int(q.get("revision")))),
                "header": {}}

    def maintenance_alarm(self, q: dict) -> dict:
        action = q.get("action", "GET")
        if action == "GET":  # reads don't go through consensus
            lead = self.ec.ensure_leader()
            alarms = sorted(self.ec.members[lead].alarms)
        else:
            alarms = self.ec.alarm(
                {"ACTIVATE": "activate", "DEACTIVATE": "deactivate"}[action],
                q.get("alarm", "NOSPACE"),
            )
        return {"header": {}, "alarms": [{"alarm": a} for a in alarms]}

    def maintenance_snapshot(self, q: dict) -> dict:
        m = q.get("_member", self.ec.ensure_leader())
        snap = self.ec.member_snapshot(m)
        # the reference streams the raw backend file (maintenance.go
        # Snapshot); our binary-exact equivalent is the pickled member
        # snapshot — lossless, so `etcdutl snapshot restore` can rebuild
        # a data dir from the saved file
        import pickle

        return {"blob": _b64(pickle.dumps(snap, protocol=4))}

    def maintenance_defragment(self, q: dict) -> dict:
        for ms in self.ec.members:
            if ms.backend is not None:
                ms.backend.defrag()
        return {"header": {}}

    def maintenance_downgrade(self, q: dict) -> dict:
        """DowngradeRequest VALIDATE/ENABLE/CANCEL
        (rpc.proto Maintenance.Downgrade; v3_server.go:901)."""
        a = q.get("action", 0)
        if isinstance(a, str):
            a = {"VALIDATE": 0, "ENABLE": 1, "CANCEL": 2}.get(a.upper(), a)
        action = {0: "validate", 1: "enable", 2: "cancel"}[int(a)]
        res = self.ec.downgrade(action, q.get("version"))
        return {"header": {}, "version": res["version"]}

    # -- auth ----------------------------------------------------------------
    # gateway path suffix -> replicated auth request kind
    AUTH_OPS = {
        "enable": "auth_enable",
        "disable": "auth_disable",
        "user_add": "auth_user_add",
        "user_delete": "auth_user_delete",
        "user_changepw": "auth_user_change_password",
        "user_grant": "auth_user_grant_role",
        "user_revoke": "auth_user_revoke_role",
        "role_add": "auth_role_add",
        "role_delete": "auth_role_delete",
        "role_grant": "auth_role_grant_permission",
        "role_revoke": "auth_role_revoke_permission",
    }

    def auth(self, suffix: str, q: dict) -> dict:
        tok = q.pop("_token", None)
        if suffix == "authenticate":
            out = self.ec.authenticate(q["name"], q["password"])
            return {"token": out, "header": {}}
        kind = self.AUTH_OPS.get(suffix)
        if kind is None:
            raise ServerError(f"unknown auth op {suffix}")
        # AdminPermission (server/etcdserver/v3_server.go AuthInfoFromCtx
        # + auth store's root-role requirement): once auth is on, every
        # admin op needs the root role — via password token or cert-CN
        # identity. Without this the whole auth layer is one
        # /v3/auth/disable away from moot.
        lead = self.ec.ensure_leader()
        a = self.ec.members[lead].auth
        if a.enabled:
            if tok is None:
                raise ServerError(
                    "auth admin: token or cert identity required")
            a.is_admin(tok)
        kw = {k: v for k, v in q.items()}
        if kind == "auth_role_grant_permission":
            from etcd_tpu_torch.server.auth import Permission

            p = kw.pop("perm")
            ptype = {"READ": 0, "WRITE": 1, "READWRITE": 2}[
                p.get("permType", "READWRITE")
            ]
            kw["role"] = kw.pop("name", kw.get("role"))
            kw["perm"] = Permission(
                ptype, _unb64(p["key"]), _unb64(p.get("range_end"))
            )
        if "key" in kw and isinstance(kw["key"], str):
            kw["key"] = _unb64(kw["key"])
        if "range_end" in kw and isinstance(kw["range_end"], str):
            kw["range_end"] = _unb64(kw["range_end"])
        res = self.ec.auth_request(kind, **kw)
        return {"header": {}, "result": _jsonable(res)}

    # -- election / lock (api/v3election, api/v3lock) ------------------------
    def _session(self, lease: int, required: bool = True) -> Session:
        # a shared lease-0 session would collide every caller onto one
        # ownership key and break mutual exclusion
        if required and lease <= 0:
            raise ServerError("a positive lease is required")
        return _BoundSession(Client(self.ec), lease)

    def election_campaign(self, q: dict) -> dict:
        name = _unb64(q["name"])
        e = Election(self._session(_int(q.get("lease"))), name)
        e.campaign(_unb64(q.get("value")) or b"")
        return {
            "header": {},
            "leader": {"name": _b64(name), "key": _b64(e.my_key),
                       "rev": str(e.my_rev), "lease": q.get("lease")},
        }

    def election_proclaim(self, q: dict) -> dict:
        l = q["leader"]
        e = Election(self._session(_int(l.get("lease"))),
                     _unb64(l["name"]))
        e.my_key, e.my_rev = _unb64(l["key"]), _int(l.get("rev"))
        e.proclaim(_unb64(q.get("value")) or b"")
        return {"header": {}}

    def election_leader(self, q: dict) -> dict:
        e = Election(self._session(0, required=False), _unb64(q["name"]))
        kv = e.leader()
        if kv is None:
            raise ServerError("election: no leader")
        return {"header": {}, "kv": _kv_json(kv)}

    def election_resign(self, q: dict) -> dict:
        l = q["leader"]
        e = Election(self._session(_int(l.get("lease"))), _unb64(l["name"]))
        e.my_key, e.my_rev = _unb64(l["key"]), _int(l.get("rev"))
        e.resign()
        return {"header": {}}

    def lock_lock(self, q: dict) -> dict:
        m = Mutex(self._session(_int(q.get("lease"))), _unb64(q["name"]))
        m.lock()
        return {"header": {}, "key": _b64(m.my_key)}

    def lock_unlock(self, q: dict) -> dict:
        self.ec.delete_range(_unb64(q["key"]))
        return {"header": {}}


def _jsonable(x):
    if isinstance(x, bytes):
        return _b64(x)
    if isinstance(x, dict):
        return {str(_jsonable(k)): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set)):
        return [_jsonable(v) for v in sorted(x) if not isinstance(x, (list, tuple))] \
            if isinstance(x, set) else [_jsonable(v) for v in x]
    if hasattr(x, "__dict__"):
        return _jsonable(vars(x))
    return x


ROUTES = {
    "/v3/kv/range": "kv_range",
    "/v3/kv/put": "kv_put",
    "/v3/kv/deleterange": "kv_deleterange",
    "/v3/kv/txn": "kv_txn",
    "/v3/kv/compaction": "kv_compaction",
    "/v3/watch": "watch",
    "/v3/lease/grant": "lease_grant",
    "/v3/lease/revoke": "lease_revoke",
    "/v3/lease/keepalive": "lease_keepalive",
    "/v3/lease/timetolive": "lease_timetolive",
    "/v3/lease/leases": "lease_leases",
    "/v3/cluster/member/add": "member_add",
    "/v3/cluster/member/remove": "member_remove",
    "/v3/cluster/member/promote": "member_promote",
    "/v3/cluster/member/list": "member_list",
    "/v3/maintenance/status": "maintenance_status",
    "/v3/maintenance/hash": "maintenance_hash_kv",
    "/v3/maintenance/alarm": "maintenance_alarm",
    "/v3/maintenance/snapshot": "maintenance_snapshot",
    "/v3/maintenance/defragment": "maintenance_defragment",
    "/v3/maintenance/downgrade": "maintenance_downgrade",
    "/v3/election/campaign": "election_campaign",
    "/v3/election/proclaim": "election_proclaim",
    "/v3/election/leader": "election_leader",
    "/v3/election/resign": "election_resign",
    "/v3/lock/lock": "lock_lock",
    "/v3/lock/unlock": "lock_unlock",
}


class _QuietServer(ThreadingHTTPServer):
    """Failed TLS handshakes and client disconnects are the client's
    story, not server stderr noise; anything else (fd exhaustion, disk
    full, bugs) still gets the default traceback."""

    def handle_error(self, request, client_address):
        import errno
        import ssl
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (ssl.SSLError, ConnectionError,
                            TimeoutError)):
            return
        if isinstance(exc, OSError) and exc.errno in (
                errno.ECONNRESET, errno.EPIPE, errno.ETIMEDOUT,
                errno.ECONNABORTED):
            return
        super().handle_error(request, client_address)


class V3Server:
    """HTTP transport wrapper around V3Api + the etcdhttp endpoints.

    With `tls_info` the listener speaks HTTPS (the NewTLSListener path,
    client/pkg/transport/listener_tls.go): optional required-client-cert
    verification against the trusted CA, the post-handshake
    allowed-CN/hostname gate, and — when client certs are verified —
    the peer CN as a request identity (AuthInfoFromTLS,
    server/auth/store.go:985: the CN is the username, no password)."""

    def __init__(self, ec: EtcdCluster, host: str = "127.0.0.1",
                 port: int = 0, tls_info=None):
        from etcd_tpu_torch.server.v2http import KEYS_PREFIX, V2Api

        self.api = V3Api(ec)
        api = self.api
        self.v2api = V2Api(ec)
        v2api = self.v2api
        if tls_info is not None and tls_info.empty():
            # a half-configured TLSInfo must fail startup, never
            # silently downgrade to plaintext (listener.go:345)
            raise ValueError(
                "KeyFile and CertFile must both be present in tls_info")
        tls = tls_info
        self.tls_info = tls
        self.scheme = "https" if tls else "http"

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            # TLS handshakes run HERE, per-connection in the handler
            # thread (wrap_socket defers them) — a client that connects
            # and sends nothing must never stall the accept loop
            HANDSHAKE_TIMEOUT = 30.0

            def setup(self):
                if tls is not None and hasattr(self.request,
                                               "do_handshake"):
                    self.request.settimeout(self.HANDSHAKE_TIMEOUT)
                    self.request.do_handshake()  # raises -> conn dropped
                    self.request.settimeout(None)
                super().setup()

            def log_message(self, *a):  # quiet
                pass

            def _tls_gate(self) -> bool:
                """allowed-CN / allowed-hostname constraint
                (listener_tls.go:43): False ⇒ request rejected."""
                if tls is None or (not tls.allowed_cn and
                                   not tls.allowed_hostname):
                    return True
                from etcd_tpu_torch.transport import check_cert_constraints

                if check_cert_constraints(self.connection,
                                          tls.allowed_cn,
                                          tls.allowed_hostname):
                    return True
                # drain the body so a keep-alive connection stays in
                # sync after the rejection (empty read = client gone)
                n = int(self.headers.get("Content-Length", "0") or 0)
                while n > 0:
                    chunk = self.rfile.read(min(n, 1 << 16))
                    if not chunk:
                        break
                    n -= len(chunk)
                self._send(403, {"error": "client certificate "
                                 "constraint not satisfied"})
                return False

            def _cert_cn(self) -> str | None:
                """Verified client-cert CN, only when the listener
                actually verifies client certs."""
                if tls is None or not tls.client_cert_auth:
                    return None
                from etcd_tpu_torch.transport import peer_common_name

                return peer_common_name(self.connection)

            def _send(self, code: int, obj: dict,
                      headers: dict | None = None) -> None:
                blob = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(blob)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(blob)

            # ---- v2 REST family (api/v2http client.go handler mux)
            def _v2_form(self) -> dict:
                from urllib.parse import parse_qsl, urlsplit

                form = dict(parse_qsl(urlsplit(self.path).query,
                                      keep_blank_values=True))
                n = int(self.headers.get("Content-Length", "0") or 0)
                if n:
                    body = self.rfile.read(n).decode()
                    ctype = self.headers.get("Content-Type", "")
                    if "json" in ctype:
                        try:
                            form.update(json.loads(body or "{}"))
                        except json.JSONDecodeError:
                            pass
                    else:
                        form.update(parse_qsl(body,
                                              keep_blank_values=True))
                auth = self.headers.get("Authorization", "")
                if auth.startswith("Basic "):
                    import base64 as _b64

                    try:
                        form["_basic_auth"] = _b64.b64decode(
                            auth[6:]).decode()
                    except Exception:
                        pass
                return form

            def _maybe_v2(self) -> bool:
                from urllib.parse import urlsplit

                path = urlsplit(self.path).path
                if path.startswith(KEYS_PREFIX):
                    key = path[len(KEYS_PREFIX):] or "/"
                    with api.lock:
                        st, body, hdr = v2api.keys(
                            self.command, key, self._v2_form())
                    self._send(st, body, hdr)
                    return True
                if path.startswith("/v2/watch_poll/"):
                    wid = int(path.rsplit("/", 1)[1])
                    with api.lock:
                        if self.command == "DELETE":
                            v2api.watch_cancel(wid)
                            st, body, hdr = 204, {}, {}
                        else:
                            st, body, hdr = v2api.watch_poll(wid)
                    self._send(st, body, hdr)
                    return True
                if path.startswith("/v2/members"):
                    suffix = path[len("/v2/members"):]
                    with api.lock:
                        st, body, hdr = v2api.members(
                            self.command, suffix, self._v2_form())
                    self._send(st, body, hdr)
                    return True
                if path.startswith("/v2/stats/"):
                    with api.lock:
                        st, body, hdr = v2api.stats(path.rsplit("/", 1)[1])
                    self._send(st, body, hdr)
                    return True
                if path.startswith("/v2/auth/"):
                    with api.lock:
                        st, body, hdr = v2api.auth_admin(
                            self.command, path[len("/v2/auth"):],
                            self._v2_form())
                    self._send(st, body, hdr)
                    return True
                return False

            def do_PUT(self):
                if not self._tls_gate():
                    return
                if not self._maybe_v2():
                    self._send(404, {"error": "not found"})

            def do_DELETE(self):
                if not self._tls_gate():
                    return
                if not self._maybe_v2():
                    self._send(404, {"error": "not found"})

            def do_GET(self):
                if not self._tls_gate():
                    return
                if self._maybe_v2():
                    return
                # etcdhttp: /health, /version, /metrics (api/etcdhttp)
                if self.path == "/health":
                    with api.lock:
                        try:
                            api.ec.ensure_leader()
                            self._send(200, {"health": "true"})
                        except Exception as e:
                            self._send(503, {"health": "false",
                                             "reason": str(e)})
                elif self.path == "/version":
                    with api.lock:
                        cv = api.ec.cluster_version()
                    self._send(200, {
                        "etcdserver": __version__,
                        "etcdcluster": cv or MIN_CLUSTER_VERSION,
                    })
                elif self.path == "/metrics":
                    # Prometheus exposition format (api/etcdhttp metrics):
                    # etcd-reference metric names with # HELP/# TYPE
                    # declarations and histogram _bucket/_sum/_count
                    # triplets — parseable by any exposition-format
                    # scraper (round-trip test in tests/test_v3rpc.py)
                    from etcd_tpu_torch.models.metrics import fleet_summary
                    from etcd_tpu_torch.models.telemetry import (
                        PROMETHEUS_CONTENT_TYPE,
                        prometheus_render,
                        server_metric_families,
                        telemetry_report,
                    )

                    with api.lock:
                        s = fleet_summary(api.ec.cl.s)
                        tele = getattr(api.ec.cl, "tele", None)
                        trep = None
                        if tele is not None:
                            try:
                                trep = telemetry_report(
                                    tele, groups=api.ec.cl.C)
                            except OverflowError:
                                # a wrapped i32 window on a long-lived
                                # server must not poison every future
                                # scrape: open a fresh window and serve
                                # this scrape without the latency
                                # families
                                api.ec.cl.reset_telemetry()
                        td = getattr(api.ec, "contention", None)
                        slow = {
                            "slow_apply_total": getattr(
                                api.ec, "slow_apply_total", 0),
                            "slow_read_indexes_total": getattr(
                                api.ec, "slow_read_index_total", 0),
                        }
                    blob = prometheus_render(server_metric_families(
                        s, trep, contention=td, slow=slow)).encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     PROMETHEUS_CONTENT_TYPE)
                    self.send_header("Content-Length", str(len(blob)))
                    self.end_headers()
                    self.wfile.write(blob)
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if not self._tls_gate():
                    return
                if self._maybe_v2():
                    return
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    q = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self._send(400, {"error": "bad json", "code": 3})
                    return
                if not isinstance(q, dict):
                    self._send(400, {"error": "request body must be a "
                                     "JSON object", "code": 3})
                    return
                # _token is a transport-layer field: a JSON body that
                # smuggles one (e.g. "cert:root") must never reach the
                # handlers as an identity
                q.pop("_token", None)
                tok = self.headers.get("Authorization")
                # "cert:" is the transport-injected identity namespace —
                # never accepted from the wire (a client must not spoof
                # a cert identity through the Authorization header)
                if tok and not tok.startswith("cert:"):
                    q["_token"] = tok
                else:
                    cn = self._cert_cn()
                    if cn is not None:
                        # AuthInfoFromTLS (store.go:985): the verified
                        # client cert CN authenticates as that user,
                        # no password/token required
                        q["_token"] = "cert:" + cn
                path = self.path
                if path.startswith("/v3/auth/"):
                    suffix = path[len("/v3/auth/"):].replace("/", "_")
                    with api.lock:
                        try:
                            self._send(200, api.auth(suffix, q))
                        except Exception as e:
                            # AuthError subclasses often carry no
                            # message — the class name IS the error
                            self._send(400, {
                                "error": str(e) or type(e).__name__,
                                "code": 3})
                    return
                name = ROUTES.get(path)
                if name is None:
                    self._send(404, {"error": f"unknown path {path}"})
                    return
                with api.lock:
                    try:
                        self._send(200, getattr(api, name)(q))
                    except ServerError as e:
                        self._send(400, {"error": str(e), "code": 3})
                    except Exception as e:  # pragma: no cover
                        self._send(500, {"error": f"{type(e).__name__}: {e}"})

        # build the SSL context BEFORE binding so a bad cert path or
        # invalid constraint combination fails without leaking a bound
        # listener socket
        ssl_ctx = tls.server_context() if tls is not None else None
        self.httpd = _QuietServer((host, port), Handler)
        if tls is not None:
            # wrap the listening socket with DEFERRED handshakes:
            # accept() stays instant in the serve_forever thread, and
            # Handler.setup() handshakes in the per-connection thread
            # (a stalled or garbage client costs one worker thread for
            # HANDSHAKE_TIMEOUT, not the accept loop). Failed
            # handshakes raise there; _QuietServer drops them silently
            # — the client sees the TLS alert, the server keeps serving.
            self.httpd.socket = ssl_ctx.wrap_socket(
                self.httpd.socket, server_side=True,
                do_handshake_on_connect=False)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> "V3Server":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
