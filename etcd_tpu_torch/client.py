"""Client façade — the clientv3 analog.

Mirrors ``client/v3``'s surface (client.go / kv.go / watch.go / lease.go /
txn.go op-builders) over an in-process :class:`EtcdCluster`, the way the
reference embeds a client via `api/v3client`. Namespacing (client/v3/
namespace) is a constructor option; retry/balancer machinery collapses away
because transport faults surface as engine-level mask faults, not RPC
errors.

The port's copy of etcd_tpu/client.py, which it imports nothing of; the
wire transport (``RemoteClient``, ``RemoteWatch``) speaks the port's v3
JSON/HTTP gateway (server/v3rpc.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from etcd_tpu_torch.server.kvserver import Compare, EtcdCluster, Op


def prefix_range_end(prefix: bytes) -> bytes:
    """clientv3.GetPrefixRangeEnd (client/v3/op.go): increment the last
    byte that can be incremented; all-0xff prefixes scan to end."""
    end = bytearray(prefix)
    for i in range(len(end) - 1, -1, -1):
        if end[i] < 0xFF:
            end[i] += 1
            return bytes(end[: i + 1])
    return b"\x00"


@dataclasses.dataclass
class TxnBuilder:
    """clientv3.Txn: If(...).Then(...).Else(...).Commit()."""

    client: "Client"
    _compare: list[Compare] = dataclasses.field(default_factory=list)
    _success: list[Op] = dataclasses.field(default_factory=list)
    _failure: list[Op] = dataclasses.field(default_factory=list)

    def if_(self, *cmps: Compare) -> "TxnBuilder":
        self._compare.extend(cmps)
        return self

    def then(self, *ops: Op) -> "TxnBuilder":
        self._success.extend(ops)
        return self

    def else_(self, *ops: Op) -> "TxnBuilder":
        self._failure.extend(ops)
        return self

    def commit(self) -> dict:
        return self.client.ec.txn(
            self._compare,
            [self.client._ns_op(o) for o in self._success],
            [self.client._ns_op(o) for o in self._failure],
            token=self.client.token,
        )


class Client:
    def __init__(self, ec: EtcdCluster, namespace: bytes = b"",
                 token: str | None = None):
        self.ec = ec
        self.ns = namespace
        self.token = token

    # -- namespacing (client/v3/namespace) -----------------------------------
    def _key(self, key: bytes) -> bytes:
        return self.ns + key

    def _range_end(self, key: bytes, range_end: bytes | None):
        if range_end is None:
            return None
        if range_end == b"\x00":
            return prefix_range_end(self.ns) if self.ns else b"\x00"
        return self.ns + range_end

    def _ns_op(self, op: Op) -> Op:
        return dataclasses.replace(
            op, key=self._key(op.key),
            range_end=self._range_end(op.key, op.range_end),
        )

    def _strip(self, kvs):
        """Return prefix-stripped COPIES — range hands back the store's own
        KeyValue objects, which must stay immutable."""
        if not self.ns:
            return kvs
        return [
            dataclasses.replace(kv, key=kv.key[len(self.ns):]) for kv in kvs
        ]

    # -- KV ------------------------------------------------------------------
    def put(self, key: bytes, value: bytes, lease: int = 0,
            prev_kv: bool = False) -> dict:
        return self.ec.put(self._key(key), value, lease, prev_kv, self.token)

    def get(self, key: bytes, rev: int = 0, serializable: bool = False,
            member: int | None = None):
        res = self.ec.range(
            self._key(key), rev=rev, serializable=serializable, member=member,
            token=self.token,
        )
        kvs = self._strip(res["kvs"])
        return kvs[0] if kvs else None

    def get_range(self, key: bytes, range_end: bytes | None = None, **kw):
        res = self.ec.range(
            self._key(key), self._range_end(key, range_end),
            token=self.token, **kw,
        )
        res["kvs"] = self._strip(res["kvs"])
        return res

    def get_prefix(self, prefix: bytes, **kw):
        return self.get_range(prefix, prefix_range_end(prefix), **kw)

    def delete(self, key: bytes, range_end: bytes | None = None,
               prev_kv: bool = False):
        return self.ec.delete_range(
            self._key(key), self._range_end(key, range_end), prev_kv, self.token
        )

    def delete_prefix(self, prefix: bytes):
        return self.delete(prefix, prefix_range_end(prefix))

    def compact(self, rev: int):
        return self.ec.compact(rev)

    def txn(self) -> TxnBuilder:
        return TxnBuilder(self)

    # compare builders (client/v3/compare.go)
    def compare_value(self, key, result, value) -> Compare:
        return Compare(self._key(key), "value", result, value)

    def compare_version(self, key, result, version) -> Compare:
        return Compare(self._key(key), "version", result, version)

    def compare_create(self, key, result, rev) -> Compare:
        return Compare(self._key(key), "create", result, rev)

    def compare_mod(self, key, result, rev) -> Compare:
        return Compare(self._key(key), "mod", result, rev)

    # -- watch ---------------------------------------------------------------
    def watch(self, key: bytes, range_end: bytes | None = None,
              start_rev: int = 0, prev_kv: bool = False,
              member: int | None = None, filters: tuple = (),
              progress_notify: bool = False, fragment: bool = False):
        """clientv3 WatchCreateRequest options: `filters` drops event types
        ("put"/"delete" — WithFilterPut/WithFilterDelete), `progress_notify`
        = WithProgressNotify, `fragment` = WithFragment."""
        m = member if member is not None else self.ec.ensure_leader()
        w = self.ec.watch(
            m, self._key(key), self._range_end(key, range_end), start_rev,
            prev_kv, fragment=fragment, progress_notify=progress_notify,
            filters=filters,
        )
        return _WatchHandle(self, m, w.id)

    def watch_prefix(self, prefix: bytes, **kw):
        return self.watch(prefix, prefix_range_end(prefix), **kw)

    # -- lease ---------------------------------------------------------------
    def lease_grant(self, lease_id: int, ttl: int):
        return self.ec.lease_grant(lease_id, ttl)

    def lease_revoke(self, lease_id: int):
        return self.ec.lease_revoke(lease_id)

    def lease_keepalive(self, lease_id: int):
        return self.ec.lease_keepalive(lease_id)

    # -- auth ----------------------------------------------------------------
    def login(self, name: str, password: str) -> "Client":
        return Client(self.ec, self.ns, self.ec.authenticate(name, password))


@dataclasses.dataclass
class _WatchHandle:
    client: Client
    member: int
    watch_id: int

    def request_progress(self) -> int | None:
        """clientv3 Watcher.RequestProgress: current revision once this
        watcher is fully synced, else None."""
        return self.client.ec.watch_progress(self.member, self.watch_id)

    def events(self):
        evs = self.client.ec.watch_events(self.member, self.watch_id)
        if self.client.ns:
            evs = [
                dataclasses.replace(
                    e, kv=dataclasses.replace(
                        e.kv, key=e.kv.key[len(self.client.ns):]
                    )
                )
                if e.kv.key.startswith(self.client.ns) else e
                for e in evs
            ]
        return evs

    def cancel(self) -> bool:
        return self.client.ec.cancel_watch(self.member, self.watch_id)


# --------------------------------------------------------- wire transport

class RemoteError(Exception):
    """A gateway error response (the clientv3 rpctypes error analog)."""


class RemoteClient:
    """clientv3 over the wire: the JSON/HTTP gateway transport analog of
    the reference's gRPC client path (client/v3/client.go dial +
    credentials). The in-process :class:`Client` drives EtcdCluster
    directly; this one reaches a server in another process — over HTTPS
    with CA verification, mutual TLS, or cert-CN identity — using the
    same endpoints etcdctl speaks.

    `tls` is a :class:`etcd_tpu_torch.transport.TLSInfo` (or a prebuilt
    ``ssl.SSLContext``): trusted_ca_file verifies the server cert,
    client_cert/key enable mutual TLS (and cert-CN auth when the server
    requires client certs)."""

    def __init__(self, endpoint: str, token: str | None = None,
                 tls=None, timeout: float | None = 10.0):
        from etcd_tpu_torch.transport import resolve_client_context

        self.endpoint = endpoint.rstrip("/")
        self.token = token
        self.timeout = timeout  # None = block (CLI snapshot saves etc.)
        self._ctx = resolve_client_context(tls)

    # ---- transport
    def call(self, path: str, body: dict) -> dict:
        import json
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            self.endpoint + path, data=json.dumps(body).encode(),
            method="POST",
            headers={
                "Content-Type": "application/json",
                **({"Authorization": self.token} if self.token else {}),
            })
        try:
            with urllib.request.urlopen(
                    req, timeout=self.timeout, context=self._ctx) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            out = e.read()
            try:
                parsed = json.loads(out or b"{}")
                msg = parsed.get("error", "") if isinstance(
                    parsed, dict) else str(parsed)
            except json.JSONDecodeError:
                msg = out.decode(errors="replace")
            raise RemoteError(msg or f"HTTP {e.code}") from None

    def get_raw(self, path: str) -> bytes:
        """GET an etcdhttp endpoint (/health, /metrics, snapshots)
        through the same TLS context as the JSON calls."""
        import urllib.request

        with urllib.request.urlopen(self.endpoint + path,
                                    timeout=self.timeout,
                                    context=self._ctx) as r:
            return r.read()

    @staticmethod
    def _b64(v: bytes) -> str:
        import base64

        return base64.b64encode(v).decode()

    @staticmethod
    def _unb64(v: str | None) -> bytes:
        import base64

        return base64.b64decode(v) if v else b""

    # ---- auth
    def login(self, name: str, password: str) -> "RemoteClient":
        out = self.call("/v3/auth/authenticate",
                        {"name": name, "password": password})
        self.token = out["token"]
        return self

    # ---- kv
    def put(self, key: bytes, value: bytes, lease: int = 0) -> dict:
        body: dict = {"key": self._b64(key), "value": self._b64(value)}
        if lease:
            body["lease"] = str(lease)
        return self.call("/v3/kv/put", body)

    def get(self, key: bytes) -> bytes | None:
        res = self.call("/v3/kv/range", {"key": self._b64(key)})
        kvs = res.get("kvs", [])
        return self._unb64(kvs[0].get("value")) if kvs else None

    def get_prefix(self, prefix: bytes) -> list[tuple[bytes, bytes]]:
        res = self.call("/v3/kv/range", {
            "key": self._b64(prefix),
            "range_end": self._b64(prefix_range_end(prefix)),
        })
        return [(self._unb64(kv.get("key")), self._unb64(kv.get("value")))
                for kv in res.get("kvs", [])]

    def delete(self, key: bytes, range_end: bytes | None = None) -> int:
        body = {"key": self._b64(key)}
        if range_end:
            body["range_end"] = self._b64(range_end)
        return int(self.call("/v3/kv/deleterange", body).get("deleted", 0))

    # ---- lease
    def lease_grant(self, lease_id: int, ttl: int) -> dict:
        return self.call("/v3/lease/grant",
                         {"ID": str(lease_id), "TTL": str(ttl)})

    def lease_keepalive(self, lease_id: int) -> dict:
        return self.call("/v3/lease/keepalive", {"ID": str(lease_id)})

    def lease_revoke(self, lease_id: int) -> dict:
        return self.call("/v3/lease/revoke", {"ID": str(lease_id)})

    # ---- watch (create + poll, the gateway's long-poll stream stand-in)
    def watch(self, key: bytes, prefix: bool = False,
              start_rev: int = 0) -> "RemoteWatch":
        c: dict = {"key": self._b64(key)}
        if prefix:
            c["range_end"] = self._b64(prefix_range_end(key))
        if start_rev:
            c["start_revision"] = str(start_rev)
        out = self.call("/v3/watch", {"create_request": c})
        return RemoteWatch(self, int(out["watch_id"]))

    # ---- maintenance
    def status(self) -> dict:
        return self.call("/v3/maintenance/status", {})

    def member_list(self) -> dict:
        return self.call("/v3/cluster/member/list", {})


@dataclasses.dataclass
class RemoteWatch:
    client: RemoteClient
    watch_id: int

    def events(self) -> list[tuple[str, bytes, bytes]]:
        """Drain pending events as (type, key, value) triples."""
        out = self.client.call("/v3/watch", {
            "poll_request": {"watch_id": str(self.watch_id)}})
        return [(e["type"],
                 RemoteClient._unb64(e["kv"].get("key")),
                 RemoteClient._unb64(e["kv"].get("value")))
                for e in out.get("events", [])]

    def cancel(self) -> bool:
        out = self.client.call("/v3/watch", {
            "cancel_request": {"watch_id": str(self.watch_id)}})
        return bool(out.get("canceled"))
