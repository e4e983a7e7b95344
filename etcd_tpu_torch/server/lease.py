"""Lease subsystem — TTL'd handles that expire keys.

Mirrors ``server/lease/lessor.go``: `Lessor` owns a min-heap expiry queue
(LeaseExpiredNotifier), leases attach key sets, only the *primary* lessor
(on the raft leader; Promote/Demote at leadership change, lessor.go:81-89)
expires; remaining-TTL checkpoints flow through consensus so a new leader
doesn't reset clocks (leasepb checkpoint, lessor.go Checkpoint). Time is a
logical tick counter fed by the server's round clock — deterministic, like
everything in the batched engine.

The port's copy of etcd_tpu/server/lease.py, which it imports nothing of.
"""
from __future__ import annotations

import dataclasses
import heapq


class LeaseError(Exception):
    pass


class ErrLeaseNotFound(LeaseError):
    pass


class ErrLeaseExists(LeaseError):
    pass


@dataclasses.dataclass
class Lease:
    id: int
    ttl: int                 # granted TTL in ticks
    expiry: int              # absolute tick of expiry (primary only)
    keys: set[bytes] = dataclasses.field(default_factory=set)
    remaining_checkpoint: int | None = None  # persisted remaining TTL


class Lessor:
    MIN_TTL = 1

    def __init__(self, min_ttl: int = 1):
        self.leases: dict[int, Lease] = {}
        self.item_map: dict[bytes, int] = {}  # key -> lease id
        self.min_ttl = min_ttl
        self.primary = False
        self.now = 0
        self._heap: list[tuple[int, int]] = []  # (expiry, id)

    # -- clock --------------------------------------------------------------
    def tick(self, n: int = 1) -> None:
        self.now += n

    # -- grant/revoke (lessor.go Grant/Revoke) -------------------------------
    def grant(self, lease_id: int, ttl: int) -> Lease:
        if lease_id <= 0:
            raise LeaseError("invalid lease id")
        if lease_id in self.leases:
            raise ErrLeaseExists(lease_id)
        ttl = max(ttl, self.min_ttl)
        l = Lease(lease_id, ttl, self.now + ttl)
        self.leases[lease_id] = l
        if self.primary:
            heapq.heappush(self._heap, (l.expiry, lease_id))
        return l

    def revoke(self, lease_id: int) -> list[bytes]:
        """Returns the attached keys (the server deletes them through an
        applied RaftRequest, lessor.go revokes via RevokeLease txn)."""
        l = self.leases.pop(lease_id, None)
        if l is None:
            raise ErrLeaseNotFound(lease_id)
        keys = sorted(l.keys)
        for k in keys:
            self.item_map.pop(k, None)
        return keys

    def renew(self, lease_id: int) -> int:
        """KeepAlive: reset expiry to now+TTL; primary-only (lessor.go)."""
        l = self.leases.get(lease_id)
        if l is None:
            raise ErrLeaseNotFound(lease_id)
        l.remaining_checkpoint = None
        l.expiry = self.now + l.ttl
        if self.primary:
            heapq.heappush(self._heap, (l.expiry, lease_id))
        return l.ttl

    def time_to_live(self, lease_id: int) -> tuple[int, list[bytes]]:
        l = self.leases.get(lease_id)
        if l is None:
            raise ErrLeaseNotFound(lease_id)
        remaining = max(l.expiry - self.now, 0) if self.primary else l.ttl
        return remaining, sorted(l.keys)

    # -- key attachment (lessor.go Attach/Detach via mvcc put) ---------------
    def attach(self, lease_id: int, key: bytes) -> None:
        l = self.leases.get(lease_id)
        if l is None:
            raise ErrLeaseNotFound(lease_id)
        old = self.item_map.get(key)
        if old is not None and old != lease_id and old in self.leases:
            self.leases[old].keys.discard(key)
        l.keys.add(key)
        self.item_map[key] = lease_id

    def detach(self, key: bytes) -> None:
        lid = self.item_map.pop(key, None)
        if lid is not None and lid in self.leases:
            self.leases[lid].keys.discard(key)

    def lease_of(self, key: bytes) -> int:
        return self.item_map.get(key, 0)

    # -- leadership (lessor.go Promote/Demote) -------------------------------
    def promote(self, extend: int = 0) -> None:
        """New leader: refresh every expiry from its TTL (the reference
        extends by the election timeout so in-flight keepalives survive)."""
        self.primary = True
        self._heap = []
        for l in self.leases.values():
            if l.remaining_checkpoint is not None:
                l.expiry = self.now + l.remaining_checkpoint
            else:
                l.expiry = self.now + l.ttl + extend
            heapq.heappush(self._heap, (l.expiry, l.id))

    def demote(self) -> None:
        self.primary = False
        self._heap = []

    # -- checkpointing (lessor.go Checkpoint; flows through raft) ------------
    def checkpoint(self) -> list[tuple[int, int]]:
        """[(lease_id, remaining_ttl)] for the leader to replicate."""
        if not self.primary:
            return []
        return [
            (l.id, max(l.expiry - self.now, 0)) for l in self.leases.values()
        ]

    def apply_checkpoint(self, lease_id: int, remaining: int) -> None:
        l = self.leases.get(lease_id)
        if l is not None:
            l.remaining_checkpoint = remaining

    # -- snapshot/restore (leaseBucket persistence, schema/lease.go) ---------
    def to_snapshot(self) -> dict:
        """(ttl, remaining, keys) per lease; remaining is measured from the
        snapshot moment so the restored member's local clock origin doesn't
        matter (the reference persists ID+TTL and checkpoints remaining)."""
        return {
            l.id: {
                "ttl": l.ttl,
                "remaining": (
                    max(l.expiry - self.now, 0)
                    if self.primary
                    else l.remaining_checkpoint
                ),
                "keys": sorted(l.keys),
            }
            for l in self.leases.values()
        }

    def restore(self, snap: dict) -> None:
        self.leases = {}
        self.item_map = {}
        self.primary = False
        self._heap = []
        for lid, d in snap.items():
            l = Lease(lid, d["ttl"], self.now + (d["remaining"] or d["ttl"]),
                      set(d["keys"]), d["remaining"])
            self.leases[lid] = l
            for k in l.keys:
                self.item_map[k] = lid

    # -- expiry (lessor.go expireExists / runLoop) ---------------------------
    def expired(self, limit: int = 16) -> list[int]:
        """Lease ids due at the current tick (primary only). The server
        turns each into a LeaseRevoke proposal through consensus."""
        if not self.primary:
            return []
        out = []
        while self._heap and len(out) < limit:
            exp, lid = self._heap[0]
            l = self.leases.get(lid)
            if l is None:
                heapq.heappop(self._heap)
                continue
            if l.expiry != exp:  # stale heap entry after renew
                heapq.heappop(self._heap)
                continue
            if exp > self.now:
                break
            heapq.heappop(self._heap)
            out.append(lid)
        return out

    def defer_expiry(self, lease_ids) -> None:
        """Re-queue ids whose revoke proposal failed so they retry next tick
        (expired() already popped their heap entries; without this they
        would never expire again)."""
        if not self.primary:
            return
        for lid in lease_ids:
            l = self.leases.get(lid)
            if l is not None:
                heapq.heappush(self._heap, (l.expiry, lid))
