"""Distributed coordination recipes — clientv3/concurrency analogs.

Mirrors ``client/v3/concurrency``: Session (lease-scoped liveness), Mutex
(lock by lowest create-revision under a prefix, mutex.go), Election
(campaign/proclaim/resign/observe, election.go) and STM (software
transactional memory retry loop, stm.go). These are *client-side recipes*
over KV+lease+watch — identical strategy to the reference, and the
substrate the server-side v3lock/v3election services expose.

The port's copy of etcd_tpu/concurrency.py, which it imports nothing of.
"""
from __future__ import annotations

import dataclasses

from etcd_tpu_torch.client import Client, prefix_range_end
from etcd_tpu_torch.server.kvserver import Compare, Op


class ConcurrencyError(Exception):
    pass


class Session:
    """concurrency.Session: a lease kept alive on tick; dropping it releases
    every lock/candidacy owned by the session."""

    _next_id = 1000

    def __init__(self, client: Client, ttl: int = 60):
        self.client = client
        Session._next_id += 1
        self.lease_id = Session._next_id
        client.lease_grant(self.lease_id, ttl)

    def keepalive(self) -> None:
        self.client.lease_keepalive(self.lease_id)

    def close(self) -> None:
        self.client.lease_revoke(self.lease_id)


class Mutex:
    """concurrency.Mutex (mutex.go): my key = <prefix>/<lease-id>; acquire
    by putting it iff absent (create-rev 0 compare) and owning the lock when
    no earlier create-revision exists under the prefix."""

    def __init__(self, session: Session, prefix: bytes):
        self.s = session
        self.prefix = prefix.rstrip(b"/") + b"/"
        self.my_key = self.prefix + str(session.lease_id).encode()
        self.my_rev = 0

    def try_lock(self) -> bool:
        c = self.s.client
        res = (
            c.txn()
            .if_(c.compare_create(self.my_key, "=", 0))
            .then(Op("put", self.my_key, b"", lease=self.s.lease_id))
            .else_(Op("range", self.my_key))
            .commit()
        )
        if res["succeeded"]:
            self.my_rev = res["rev"]
        else:
            self.my_rev = res["responses"][0][1][0].create_revision
        owner = self._owner()
        if owner == self.my_rev:
            return True
        return False

    def lock(self, max_rounds: int = 200) -> None:
        """Block (stepping the cluster) until owned — waitDeletes on earlier
        keys in the reference becomes step-and-recheck here."""
        for _ in range(max_rounds):
            if self.try_lock():
                return
            # step, don't tick: the wait loop only needs raft rounds to
            # flush; advancing the raft timers here would fast-forward
            # lease TTLs (wall-clock seconds) by hundreds of seconds in
            # milliseconds and expire other sessions' locks
            self.s.client.ec.step()
        raise ConcurrencyError("lock: timed out")

    def unlock(self) -> None:
        self.s.client.delete(self.my_key)
        self.my_rev = 0

    def _owner(self) -> int:
        """Lowest create-revision under the prefix (the lock holder)."""
        res = self.s.client.get_prefix(self.prefix)
        revs = [kv.create_revision for kv in res["kvs"]]
        return min(revs) if revs else 0

    def is_owner(self) -> bool:
        return self.my_rev != 0 and self._owner() == self.my_rev


class Election:
    """concurrency.Election (election.go): leadership = owning the lowest
    create-revision key under the election prefix; proclaim rewrites the
    value guarded by that ownership."""

    def __init__(self, session: Session, prefix: bytes):
        self.s = session
        self.prefix = prefix.rstrip(b"/") + b"/"
        self.my_key = self.prefix + str(session.lease_id).encode()
        self.my_rev = 0

    def campaign(self, value: bytes, max_rounds: int = 200) -> None:
        c = self.s.client
        res = (
            c.txn()
            .if_(c.compare_create(self.my_key, "=", 0))
            .then(Op("put", self.my_key, value, lease=self.s.lease_id))
            .else_(Op("range", self.my_key))
            .commit()
        )
        if res["succeeded"]:
            self.my_rev = res["rev"]
        else:
            self.my_rev = res["responses"][0][1][0].create_revision
            c.put(self.my_key, value, lease=self.s.lease_id)
        for _ in range(max_rounds):
            if self.is_leader():
                return
            c.ec.step()  # see Mutex.lock: no lease-clock fast-forward
        raise ConcurrencyError("campaign: timed out")

    def proclaim(self, value: bytes) -> None:
        c = self.s.client
        res = (
            c.txn()
            .if_(c.compare_create(self.my_key, "=", self.my_rev))
            .then(Op("put", self.my_key, value, lease=self.s.lease_id))
            .commit()
        )
        if not res["succeeded"]:
            raise ConcurrencyError("proclaim: not leader (session expired)")

    def resign(self) -> None:
        self.s.client.delete(self.my_key)
        self.my_rev = 0

    def leader(self):
        """(key, value) of the current leader — earliest create-revision."""
        res = self.s.client.get_prefix(self.prefix)
        if not res["kvs"]:
            return None
        kv = min(res["kvs"], key=lambda kv: kv.create_revision)
        return kv

    def is_leader(self) -> bool:
        kv = self.leader()
        return kv is not None and kv.create_revision == self.my_rev


class STM:
    """concurrency.NewSTM (stm.go, SerializableSnapshot flavor): buffer
    reads/writes, commit with mod-revision compares over the read set,
    retry on conflict."""

    def __init__(self, client: Client, max_retries: int = 16):
        self.client = client
        self.max_retries = max_retries

    def run(self, apply_fn) -> dict:
        for _ in range(self.max_retries):
            txn = _STMTxn(self.client)
            apply_fn(txn)
            res = txn.commit()
            if res is not None:
                return res
        raise ConcurrencyError("STM: too many retries")


class _STMTxn:
    def __init__(self, client: Client):
        self.c = client
        self.rset: dict[bytes, int] = {}   # key -> mod_revision seen (0=absent)
        self.wset: dict[bytes, bytes] = {}

    def get(self, key: bytes) -> bytes | None:
        if key in self.wset:
            return self.wset[key]
        kv = self.c.get(key, serializable=True)
        self.rset[key] = kv.mod_revision if kv else 0
        return kv.value if kv else None

    def put(self, key: bytes, value: bytes) -> None:
        self.wset[key] = value

    def commit(self) -> dict | None:
        cmps = [
            self.c.compare_mod(k, "=", rev) for k, rev in self.rset.items()
        ]
        puts = [Op("put", k, v) for k, v in self.wset.items()]
        res = self.c.txn().if_(*cmps).then(*puts).commit()
        return res if res["succeeded"] else None
