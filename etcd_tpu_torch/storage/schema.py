"""Backend bucket layout + consistent-index persistence
(etcd_tpu/storage/schema.py).

The reference's ``server/storage/schema`` defines the bbolt bucket names
(key/meta/lease/auth/alarm/members, schema/bucket.go:97) and the
consistent-index accessors (schema/cindex.go:85); ``cindex.Store``
(server/etcdserver/cindex/cindex.go:30-38) persists the applied
index+term inside the same backend transaction as the kv writes, so a
restarted member knows exactly which raft entries its backend reflects
and dedups replay.

Atomicity mapping: bbolt gives the reference multi-bucket transactional
commits. Our append-only backend's atomic unit is one CRC-framed record,
so the whole non-KV applied state rides in a single ``applied_meta``
record — (consistent_index, term, current_rev, compact_rev, lease, auth,
alarms) — written after each apply batch's revision records. Recovery
loads the last committed applied_meta and trims any revision records
beyond its ``current_rev``: a batch-commit boundary that splits a group
simply rolls the member back to the previous consistent point, exactly
the WAL+backend recovery contract (replay resumes at cindex).
"""
from __future__ import annotations

import pickle
import struct

from etcd_tpu_torch.server.mvcc import KeyIndex, KeyValue, MVCCStore, Revision
from etcd_tpu_torch.storage.backend import Backend

KEY_BUCKET = "key"
META_BUCKET = "meta"
MEMBERS_BUCKET = "members"

_REV = struct.Struct(">qi")  # main, sub — sorts correctly as bytes
_APPLIED_META_KEY = b"applied_meta"


def rev_to_bytes(main: int, sub: int) -> bytes:
    return _REV.pack(main, sub)


def bytes_to_rev(b: bytes) -> tuple[int, int]:
    return _REV.unpack(b)


def _enc_kv(kv: KeyValue, tomb: bool) -> bytes:
    return pickle.dumps(
        (kv.key, kv.value, kv.create_revision, kv.mod_revision, kv.version,
         kv.lease, tomb),
        protocol=4,
    )


def _dec_kv(blob: bytes) -> tuple[KeyValue, bool]:
    k, v, cr, mr, ver, lease, tomb = pickle.loads(blob)
    return KeyValue(k, v, cr, mr, ver, lease), tomb


# -- MVCC revision records ---------------------------------------------------
def persist_mvcc_delta(be: Backend, store: MVCCStore, last_rev: int) -> int:
    """Write every revision with main > last_rev to the key bucket;
    returns the new high-water main revision (storeTxnWrite.End ->
    batch_tx path, mvcc/kvstore_txn.go:182).

    ``store.revs`` is insertion-ordered (writes append chronologically;
    compaction only deletes), so the new tail is found by scanning from
    the end — O(delta), not O(history)."""
    new = []
    for key in reversed(store.revs):
        if key[0] <= last_rev:
            break
        new.append(key)
    for (main, sub) in reversed(new):
        kv, tomb = store.revs[(main, sub)]
        be.put(KEY_BUCKET, rev_to_bytes(main, sub), _enc_kv(kv, tomb))
    return store.current_rev


def persist_compaction(be: Backend, store: MVCCStore) -> None:
    """Drop revisions MVCC compaction removed (the scheduled-compaction
    delete pass, mvcc/kvstore_compaction.go)."""
    live = {rev_to_bytes(m, s) for (m, s) in store.revs}
    for k, _ in be.range(KEY_BUCKET, b"", b"\x00"):
        if k not in live:
            be.delete(KEY_BUCKET, k)


# -- the atomic applied-state record ----------------------------------------
def save_applied_meta(
    be: Backend, *, index: int, term: int, store: MVCCStore,
    lease_snap, auth_snap, alarms,
    cluster_version: str | None = None, downgrade: dict | None = None,
    v2: str | None = None,
) -> None:
    """One record = consistent index + MVCC cursors + the small applied
    sub-states (lease/auth/alarm buckets of the reference schema, plus
    the cluster-version / downgrade records of membership's backend
    buckets — cluster.go:263-269 recovers both on boot)."""
    be.put(
        META_BUCKET,
        _APPLIED_META_KEY,
        pickle.dumps(
            {
                "consistent_index": index,
                "term": term,
                "current_rev": store.current_rev,
                "compact_rev": store.compact_rev,
                "lease": lease_snap,
                "auth": auth_snap,
                "alarms": sorted(alarms),
                "cluster_version": cluster_version,
                "downgrade": downgrade,
                "v2": v2,
            },
            protocol=4,
        ),
    )


def load_applied_meta(be: Backend) -> dict | None:
    raw = be.get(META_BUCKET, _APPLIED_META_KEY)
    return pickle.loads(raw) if raw else None


def load_mvcc(be: Backend, max_rev: int | None = None,
              compact_rev: int = 0) -> MVCCStore:
    """Rebuild the MVCC store from the key bucket: replay revisions in
    (main, sub) order to reconstruct the keyIndex generations (the
    treeIndex rebuild on boot, mvcc/kvstore.go:59-113). Revisions past
    ``max_rev`` (a partially-committed batch) are dropped."""
    st = MVCCStore()
    for rk, blob in be.range(KEY_BUCKET, b"", b"\x00"):
        main, sub = bytes_to_rev(rk)
        if max_rev is not None and main > max_rev:
            continue
        kv, tomb = _dec_kv(blob)
        st.revs[(main, sub)] = (kv, tomb)
        st.size += len(kv.key) + len(kv.value)
        ki = st.index.get(kv.key)
        if ki is None:
            ki = KeyIndex(kv.key)
            st.index[kv.key] = ki
            st._sorted_dirty = True
        if tomb:
            ki.tombstone(Revision(main, sub))
        else:
            ki.put(Revision(main, sub))
    if max_rev is not None:
        st.current_rev = max(max_rev, 1)
    elif st.revs:
        st.current_rev = max(m for m, _ in st.revs)
    st.compact_rev = compact_rev
    return st


# ---- storage version (storage/schema/schema.go + version.go): the field
# was introduced "in 3.6" — its ABSENCE means the 3.5 layout. Migrate up
# writes it; migrate down removes it.
_STORAGE_VERSION_KEY = b"storage_version"
CURRENT_STORAGE_VERSION = "3.6"
MIN_STORAGE_VERSION = "3.5"


def set_storage_version(be: Backend, version: str | None) -> None:
    if version is None or version == MIN_STORAGE_VERSION:
        be.delete(META_BUCKET, _STORAGE_VERSION_KEY)
    else:
        be.put(META_BUCKET, _STORAGE_VERSION_KEY, version.encode())


def get_storage_version(be: Backend) -> str | None:
    """None = the pre-field (3.5-equivalent) layout."""
    raw = be.get(META_BUCKET, _STORAGE_VERSION_KEY)
    return raw.decode() if raw else None
