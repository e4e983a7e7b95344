"""Multi-version KV store — the host-side applied state machine
(a copy of etcd_tpu/server/mvcc.py, with ``DeviceBackedStore`` on the
port's ``DevicePlane``).

Mirrors the reference's ``server/storage/mvcc`` semantics with an idiomatic
Python layout (the device engine replicates *entry references*; each member
applies them to one of these stores, like each etcd node applies to its own
bbolt):

  * every write gets a ``revision{main, sub}`` (mvcc/revision.go): main
    increments once per applied txn, sub per op within it.
  * ``treeIndex`` (mvcc/index.go:25-52) maps key -> keyIndex; here a dict of
    key -> KeyIndex plus a lazily-sorted key list for range scans (bisect
    stands in for the google/btree of degree 32).
  * ``KeyIndex`` (mvcc/key_index.go:70-74) keeps *generations* separated by
    tombstones so historical reads at any revision resolve correctly.
  * reads at a revision walk the index, then fetch values from the revision-
    keyed store (the bbolt "key" bucket analog, schema/bucket.go:97).
  * compaction (mvcc/kvstore_compaction.go) drops versions <= compact_rev
    except each key's latest, and whole keys whose latest is a tombstone.

Sizes are tracked so the quota/alarm path (NOSPACE) has something to check.
"""
from __future__ import annotations

import bisect
import dataclasses

from etcd_tpu_torch.device_mvcc import scheme


class MVCCError(Exception):
    pass


class ErrCompacted(MVCCError):
    """mvcc.ErrCompacted: requested rev <= compacted revision."""


class ErrFutureRev(MVCCError):
    """mvcc.ErrFutureRev: requested rev > current revision."""


@dataclasses.dataclass(frozen=True, order=True)
class Revision:
    main: int
    sub: int = 0


@dataclasses.dataclass
class KeyValue:
    """mvccpb.KeyValue (api/mvccpb/kv.proto)."""

    key: bytes
    value: bytes
    create_revision: int
    mod_revision: int
    version: int
    lease: int = 0


class KeyIndex:
    """key_index.go: per-key revision history in generations."""

    __slots__ = ("key", "generations")

    def __init__(self, key: bytes):
        self.key = key
        self.generations: list[list[Revision]] = []

    def put(self, rev: Revision) -> None:
        if not self.generations:
            self.generations.append([])
        self.generations[-1].append(rev)

    def tombstone(self, rev: Revision) -> None:
        self.put(rev)
        self.generations.append([])  # open a fresh (empty) generation

    def _walk(self, at_rev: int):
        """(gi, revs_visible) for the generation live at at_rev, where
        revs_visible are its revisions with main <= at_rev (key_index.go
        findGeneration + walk)."""
        for gi in range(len(self.generations) - 1, -1, -1):
            gen = self.generations[gi]
            if not gen or gen[0].main > at_rev:
                continue
            vis = [r for r in gen if r.main <= at_rev]
            if not vis:
                return None
            # closed generation whose visible tail is its tombstone => dead
            closed = gi < len(self.generations) - 1
            if closed and vis[-1] == gen[-1]:
                return None
            return gi, vis
        return None

    def get(self, at_rev: int) -> Revision | None:
        """Latest live revision <= at_rev, or None if absent/tombstoned."""
        hit = self._walk(at_rev)
        return hit[1][-1] if hit else None

    def compact(self, at_rev: int) -> bool:
        """Drop revisions <= at_rev except the live one; returns True when
        the whole keyIndex is empty and should be removed."""
        new_gens: list[list[Revision]] = []
        for gi, gen in enumerate(self.generations):
            if not gen:
                new_gens.append(gen)
                continue
            closed = gi < len(self.generations) - 1
            if closed and gen[-1].main <= at_rev:
                continue  # whole generation (incl. tombstone) compacted away
            keep = [r for r in gen if r.main > at_rev]
            live = [r for r in gen if r.main <= at_rev]
            if live and not (closed and live[-1] == gen[-1]):
                keep = [live[-1]] + keep
            new_gens.append(keep)
        # drop leading empties
        while len(new_gens) > 1 and not new_gens[0]:
            new_gens.pop(0)
        self.generations = new_gens
        return all(not g for g in self.generations)


class MVCCStore:
    """mvcc.store (kvstore.go:59-87) + treeIndex, single-writer."""

    def __init__(self):
        self.index: dict[bytes, KeyIndex] = {}
        self._sorted_keys: list[bytes] = []
        self._sorted_dirty = False
        # revision-keyed value store: (main, sub) -> KeyValue (+ tombstone flag)
        self.revs: dict[tuple[int, int], tuple[KeyValue, bool]] = {}
        self.current_rev = 1  # reference boots at rev 1 (kvstore.go:91-113)
        self.compact_rev = 0
        self.size = 0

    # -- internals ----------------------------------------------------------
    def _keys(self) -> list[bytes]:
        if self._sorted_dirty:
            self._sorted_keys = sorted(self.index.keys())
            self._sorted_dirty = False
        return self._sorted_keys

    def _range_keys(self, key: bytes, range_end: bytes | None) -> list[bytes]:
        """etcd range semantics: range_end None => single key; b'\\0' =>
        from key to end; else half-open [key, range_end)."""
        if range_end is None:
            return [key] if key in self.index else []
        ks = self._keys()
        lo = bisect.bisect_left(ks, key)
        if range_end == b"\x00":
            return ks[lo:]
        hi = bisect.bisect_left(ks, range_end)
        return ks[lo:hi]

    def _check_rev(self, rev: int) -> int:
        if rev <= 0 or rev > self.current_rev:
            if rev > self.current_rev:
                raise ErrFutureRev(rev)
            return self.current_rev
        if rev < self.compact_rev:
            raise ErrCompacted(rev)
        return rev

    # -- txn API (kvstore_txn.go) -------------------------------------------
    def write_txn(self) -> "WriteTxn":
        return WriteTxn(self)

    def range(
        self,
        key: bytes,
        range_end: bytes | None = None,
        rev: int = 0,
        limit: int = 0,
        count_only: bool = False,
    ) -> tuple[list[KeyValue], int, int]:
        """(kvs, count, rev_used). rev=0 means current."""
        at = self._check_rev(rev if rev > 0 else self.current_rev)
        return self._range_at(at, key, range_end, limit, count_only)

    def _range_at(
        self,
        at: int,
        key: bytes,
        range_end: bytes | None = None,
        limit: int = 0,
        count_only: bool = False,
    ) -> tuple[list[KeyValue], int, int]:
        kvs: list[KeyValue] = []
        count = 0
        for k in self._range_keys(key, range_end):
            ki = self.index.get(k)
            if ki is None:
                continue
            r = ki.get(at)
            if r is None:
                continue
            count += 1
            if count_only:
                continue
            if limit and len(kvs) >= limit:
                continue
            kv, tomb = self.revs[(r.main, r.sub)]
            if not tomb:
                kvs.append(kv)
        return kvs, count, at

    def compact(self, rev: int) -> None:
        if rev <= self.compact_rev:
            raise ErrCompacted(rev)
        if rev > self.current_rev:
            raise ErrFutureRev(rev)
        self.compact_rev = rev
        dead_keys = []
        for k, ki in self.index.items():
            if ki.compact(rev):
                dead_keys.append(k)
        for k in dead_keys:
            del self.index[k]
        self._sorted_dirty = True
        keep = set()
        for ki in self.index.values():
            for gen in ki.generations:
                for r in gen:
                    keep.add((r.main, r.sub))
        for rk in [rk for rk in self.revs if rk[0] <= rev and rk not in keep]:
            kv, _ = self.revs.pop(rk)
            self.size -= len(kv.key) + len(kv.value)

    def hash_kv(self, rev: int = 0) -> int:
        """Maintenance/HashKV analog (mvcc/hash.go): order-independent
        digest of revision data up to rev, folded with the canonical
        mixing kernel shared with the device apply plane
        (device_mvcc/scheme.py) — the corruption checker, the chaos
        report and the device plane's equivalence checks all compare
        digests built from the same fold."""
        at = rev if rev > 0 else self.current_rev
        s = 0
        for (main, sub), (kv, tomb) in self.revs.items():
            if main > at:
                continue
            s = scheme.u32(s + scheme.u32(scheme.history_record_mix(
                main, sub, scheme.u32(scheme.bytes32(kv.key)),
                scheme.u32(scheme.bytes32(kv.value)), tomb,
            )))
        return scheme.u32(s * scheme.MIX_C + at * scheme.MIX_D + scheme.MIX_A)

    def hash_kv_latest(self, nkeys: int) -> int:
        """The canonical latest-record digest over the device key space —
        bit-equal to the device plane's ``kv_digest`` lane for a store
        that applied the same committed words (scheme.store_latest_digest;
        the differential-fuzz parity gate)."""
        return scheme.store_latest_digest(self, nkeys)

    # -- snapshot (Maintenance.Snapshot / etcdutl analog) --------------------
    def to_snapshot(self) -> dict:
        return {
            "current_rev": self.current_rev,
            "compact_rev": self.compact_rev,
            "revs": [
                (m, s, kv.key, kv.value, kv.create_revision, kv.mod_revision,
                 kv.version, kv.lease, tomb)
                for (m, s), (kv, tomb) in sorted(self.revs.items())
            ],
            "index": [
                (k, [[(r.main, r.sub) for r in gen] for gen in ki.generations])
                for k, ki in sorted(self.index.items())
            ],
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "MVCCStore":
        st = cls()
        st.current_rev = snap["current_rev"]
        st.compact_rev = snap["compact_rev"]
        for m, s, k, v, cr, mr, ver, lease, tomb in snap["revs"]:
            st.revs[(m, s)] = (KeyValue(k, v, cr, mr, ver, lease), tomb)
            st.size += len(k) + len(v)
        for k, gens in snap["index"]:
            ki = KeyIndex(k)
            ki.generations = [[Revision(m, s) for m, s in gen] for gen in gens]
            st.index[k] = ki
        st._sorted_dirty = True
        return st


class DeviceBackedStore:
    """MVCCStore-shaped facade over one lane of the device-resident apply
    plane (etcd_tpu_torch/device_mvcc): the authoritative revision
    store lives on the device as ``[keys, C]`` tensors; this class only
    encodes ops into int32 words, runs one masked apply on the device, and
    materializes KeyValue/Event objects from lane readbacks.

    Contract differences from the host store (all inherent to the
    latest-record layout, and documented rather than papered over):

      * keys/values must be canonical (scheme.key_bytes/encode_value);
        anything else raises ValueError before touching the device.
      * lease ids ride a 4-bit word field (0..15).
      * historical reads: a matching key whose mod_revision is above the
        requested rev raises ErrCompacted — the plane's effective per-key
        compaction floor is its latest record (see device_mvcc.apply
        .read_at). Reads at the current revision are always exact.
      * ``revs`` exposes the latest record per key (revision-coalesced
        history): watcher catch-up replays coalesced deltas, the same
        delivery contract as the device watch scan.
      * ``size`` counts live latest records (quota/status accounting),
        not retained history bytes.
    """

    def __init__(self, plane, lane: int = 0):
        self.plane = plane
        self.lane = lane
        self._scheme = scheme

    # -- cursors -------------------------------------------------------------
    @property
    def current_rev(self) -> int:
        return self.plane.current_rev(self.lane)

    @property
    def compact_rev(self) -> int:
        return self.plane.compact_rev(self.lane)

    @property
    def size(self) -> int:
        sc = self._scheme
        n = 0
        for kid, r in self.plane.records(self.lane).items():
            n += len(sc.key_bytes(kid))
            if not r["tomb"]:
                n += len(sc.encode_value(r["vword"]))
        return n

    # -- record materialization ---------------------------------------------
    def _kv(self, kid: int, r: dict) -> KeyValue:
        sc = self._scheme
        if r["tomb"]:
            return KeyValue(sc.key_bytes(kid), b"", 0, r["mod"], 0)
        return KeyValue(sc.key_bytes(kid), sc.encode_value(r["vword"]),
                        r["create"], r["mod"], r["version"], r["lease"])

    def _rev_keyed(self) -> dict:
        """Latest record per key, keyed (mod, sub) — records sharing one
        main (a multi-op txn, or one delete-range over several keys) get
        distinct subs in key-id order, so none collide. The device never
        materializes subs; key-id order is the one deterministic
        assignment both readers of this view (watcher catch-up,
        snapshot materialization) can agree on."""
        records = self.plane.records(self.lane)
        by_main: dict[int, int] = {}
        out = {}
        for kid in sorted(records):
            r = records[kid]
            sub = by_main.get(r["mod"], 0)
            by_main[r["mod"]] = sub + 1
            out[(r["mod"], sub)] = (self._kv(kid, r), r["tomb"])
        return out

    @property
    def revs(self) -> dict:
        """The coalesced history view WatchableStore's catch-up path
        reads (latest record per key; see _rev_keyed)."""
        return self._rev_keyed()

    def _key_range(self, key: bytes, range_end: bytes | None) -> tuple[int, int]:
        sc = self._scheme
        lo = sc.key_id(key)
        if range_end is None:
            return lo, lo + 1
        if range_end == b"\x00":
            return lo, self.plane.kvspec.keys
        return lo, sc.key_id(range_end)

    # -- txn / read API (MVCCStore surface) ----------------------------------
    def write_txn(self) -> "DeviceWriteTxn":
        return DeviceWriteTxn(self)

    def range(self, key: bytes, range_end: bytes | None = None, rev: int = 0,
              limit: int = 0, count_only: bool = False):
        cur = self.current_rev
        at = rev if rev > 0 else cur
        if at > cur:
            raise ErrFutureRev(at)
        if at < self.compact_rev:
            raise ErrCompacted(at)
        lo, hi = self._key_range(key, range_end)
        kvs: list[KeyValue] = []
        count = 0
        records = self.plane.records(self.lane)
        for kid in sorted(records):
            if not lo <= kid < hi:
                continue
            r = records[kid]
            if r["mod"] > at:
                # latest-record store: this key's state at `at` was
                # compacted-to-latest by construction — refuse rather
                # than serve the newer record as history
                raise ErrCompacted(at)
            if r["tomb"]:
                continue
            count += 1
            if count_only or (limit and len(kvs) >= limit):
                continue
            kvs.append(self._kv(kid, r))
        return kvs, count, at

    def compact(self, rev: int) -> None:
        if rev <= self.compact_rev:
            raise ErrCompacted(rev)
        if rev > self.current_rev:
            raise ErrFutureRev(rev)
        self.plane.apply_word_lane(self.lane, self._scheme.encode_compact(rev))

    # -- digests -------------------------------------------------------------
    def hash_kv(self, rev: int = 0) -> int:
        """The canonical device digest (scheme.latest_digest) — the same
        int32 the differential-fuzz gate compares; rev is accepted for
        interface parity but only the current revision is served."""
        if rev > self.current_rev:
            raise ErrFutureRev(rev)
        return self.plane.digest(self.lane)

    # -- snapshots (materialized through the host store) ---------------------
    def _materialize(self) -> MVCCStore:
        """Latest records as a single-generation host MVCCStore (the
        snapshot donor form; history below the latest record does not
        exist on device, so none is invented)."""
        st = MVCCStore()
        st.current_rev = self.current_rev
        st.compact_rev = self.compact_rev
        for (mod, sub), (kv, tomb) in self._rev_keyed().items():
            ki = KeyIndex(kv.key)
            if tomb:
                ki.tombstone(Revision(mod, sub))
            else:
                ki.put(Revision(mod, sub))
            st.index[kv.key] = ki
            st.revs[(mod, sub)] = (kv, tomb)
            st.size += len(kv.key) + len(kv.value)
        st._sorted_dirty = True
        return st

    def to_snapshot(self) -> dict:
        return self._materialize().to_snapshot()

    def load_snapshot(self, snap: dict) -> None:
        """Install a snapshot into the device lane (the applySnapshot
        path for the device plane)."""
        sc = self._scheme
        host = MVCCStore.from_snapshot(snap)
        records = {}
        for (kid, mod, create, version, vword, lease, tomb) in (
                sc.store_latest_records(host, self.plane.kvspec.keys)):
            records[kid] = {"mod": mod, "create": create, "version": version,
                           "vword": vword, "lease": lease, "tomb": tomb}
        self.plane.load_lane(self.lane, records, host.current_rev,
                             host.compact_rev)


class DeviceWriteTxn:
    """WriteTxn facade over the device lane: ops dispatch eagerly,
    word-by-word, with the CONT bit joining them into one device txn
    (same revision main) — so intra-txn read-your-writes falls out of
    reading the live device state, exactly like the host txn's buffer
    visibility. Events are built from pre/post lane readbacks."""

    def __init__(self, store: DeviceBackedStore):
        self.s = store
        self.events: list[tuple[str, KeyValue, KeyValue | None]] = []
        self._started = False
        self.main = store.current_rev + 1

    def _prev(self, kid: int) -> KeyValue | None:
        r = self.s.plane.records(self.s.lane).get(kid)
        if r is None or r["tomb"]:
            return None
        return self.s._kv(kid, r)

    def range(self, key: bytes, range_end: bytes | None = None,
              limit: int = 0, count_only: bool = False):
        # eager application means the live lane IS the txn's view
        return self.s.range(key, range_end, 0, limit, count_only)

    def put(self, key: bytes, value: bytes, lease: int = 0) -> int:
        sc = self.s._scheme
        kid = sc.key_id(key)
        if kid >= self.s.plane.kvspec.keys:
            # validate BEFORE dispatch: the device op would stamp a
            # phantom revision with no key slot to land on
            raise ValueError(
                f"key {key!r} outside the device key space "
                f"(keys={self.s.plane.kvspec.keys})"
            )
        word = sc.encode_put(kid, sc.decode_value(value), lease,
                             cont=self._started)
        prev = self._prev(kid)
        self.s.plane.apply_word_lane(self.s.lane, word)
        self._started = True
        r = self.s.plane.records(self.s.lane)[kid]
        kv = self.s._kv(kid, r)
        self.events.append(("put", kv, prev))
        return kv.mod_revision

    def delete_range(self, key: bytes, range_end: bytes | None = None) -> int:
        sc = self.s._scheme
        lo, hi = self.s._key_range(key, range_end)
        pre = {
            kid: r for kid, r in self.s.plane.records(self.s.lane).items()
            if lo <= kid < hi and not r["tomb"]
        }
        if not pre:
            return 0
        word = sc.encode_delete_range(lo, min(hi, (1 << sc.HI_BITS) - 1),
                                      cont=self._started)
        self.s.plane.apply_word_lane(self.s.lane, word)
        self._started = True
        post = self.s.plane.records(self.s.lane)
        for kid in sorted(pre):
            kv = self.s._kv(kid, post[kid])
            self.events.append(("delete", kv, self.s._kv(kid, pre[kid])))
        return len(pre)

    def end(self) -> int:
        # the device bumped current_rev per writing word already
        return self.s.current_rev


class WriteTxn:
    """One applied entry's write transaction: all ops share revision main =
    current_rev + 1, distinct subs (kvstore_txn.go:127-240); End() bumps
    current_rev and reports events for the watch layer
    (watchable_store_txn.go:22)."""

    def __init__(self, store: MVCCStore):
        self.s = store
        self.main = store.current_rev + 1
        self.sub = 0
        self.events: list[tuple[str, KeyValue, KeyValue | None]] = []
        self._wrote = False

    def range(self, key: bytes, range_end: bytes | None = None,
              limit: int = 0, count_only: bool = False):
        """Read *inside* the txn: sees this txn's own earlier writes
        (kvstore_txn.go's read buffer over the uncommitted batch)."""
        return self.s._range_at(self.main, key, range_end, limit, count_only)

    def put(self, key: bytes, value: bytes, lease: int = 0) -> int:
        s = self.s
        rev = Revision(self.main, self.sub)
        ki = s.index.get(key)
        if ki is None:
            ki = KeyIndex(key)
            s.index[key] = ki
            s._sorted_dirty = True
        # visibility at self.main: ops in this txn see earlier ops of the
        # same txn (intra-txn read-your-writes, kvstore_txn.go tx buffer).
        # create/version come from the previous RECORD, not an index walk:
        # the reference stores them in the KeyValue and restores the
        # keyIndex generation's (created, ver) from it (kvstore.go
        # restore + key_index.go generation{created, ver}), so they
        # survive compaction — an index-walk derivation regressed both
        # once compaction dropped the generation's older revisions (and
        # diverged from the device apply plane, whose latest-record store
        # is exactly the reference's record-carried semantics).
        prev_kv = None
        pr = ki.get(self.main)
        if pr is not None:
            prev_kv = s.revs[(pr.main, pr.sub)][0]
        if prev_kv is None:
            create, version = rev.main, 1
        else:
            create, version = prev_kv.create_revision, prev_kv.version + 1
        ki.put(rev)
        kv = KeyValue(key, value, create, rev.main, version, lease)
        s.revs[(rev.main, rev.sub)] = (kv, False)
        s.size += len(key) + len(value)
        self.events.append(("put", kv, prev_kv))
        self.sub += 1
        self._wrote = True
        return rev.main

    def delete_range(self, key: bytes, range_end: bytes | None = None) -> int:
        s = self.s
        deleted = 0
        for k in list(s._range_keys(key, range_end)):
            ki = s.index.get(k)
            if ki is None:
                continue
            live = ki.get(self.main)  # sees this txn's own writes
            if live is None:
                continue
            rev = Revision(self.main, self.sub)
            prev_kv = s.revs[(live.main, live.sub)][0]
            ki.tombstone(rev)
            kv = KeyValue(k, b"", 0, rev.main, 0)
            s.revs[(rev.main, rev.sub)] = (kv, True)
            self.events.append(("delete", kv, prev_kv))
            self.sub += 1
            deleted += 1
            self._wrote = True
        return deleted

    def end(self) -> int:
        if self._wrote:
            self.s.current_rev = self.main
        return self.s.current_rev
