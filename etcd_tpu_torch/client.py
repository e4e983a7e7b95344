"""Client façade — the clientv3 analog.

Mirrors ``client/v3``'s surface (client.go / kv.go / watch.go / lease.go /
txn.go op-builders) over an in-process :class:`EtcdCluster`, the way the
reference embeds a client via `api/v3client`. Namespacing (client/v3/
namespace) is a constructor option; retry/balancer machinery collapses away
because transport faults surface as engine-level mask faults, not RPC
errors.

The port's copy of etcd_tpu/client.py, which it imports nothing of; the
wire transport (``RemoteClient``, ``RemoteWatch``) waits for the port's
transport.
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
