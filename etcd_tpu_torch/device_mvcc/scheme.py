"""Canonical KV scheme shared by the host and device apply planes
(a copy of etcd_tpu/device_mvcc/scheme.py, which the port may not import).

The device-resident MVCC plane (this package) and the host ``MVCCStore``
(etcd_tpu_torch/server/mvcc.py) agree on three things:

  1. the **key space**: device keys are slot ids ``0..keys-1``; the host
     sees them as canonical byte keys (:func:`key_bytes`), in the same
     order, so etcd range semantics over canonical keys coincide with
     interval masks over slot ids.
  2. the **value space**: device values are fixed-width *value words* (the
     replicated word is the value reference); the host stores the
     canonical byte encoding (:func:`encode_value`). Both directions are
     exact.
  3. the **digest**: one record fold (:func:`record_mix` /
     :func:`latest_digest`) computed identically by the host (Python ints,
     here) and the device (the tensor twin ``apply.kv_digest``). The fold
     is a wrap-sum of per-record mixes, so it is order-independent, and
     every equivalence check (the fuzz harness, chaos_run's APPLY tier,
     bench's APPLY_MODE=both) compares literally the same int32.

``MVCCStore.hash_kv`` routes its full-history digest through
:func:`history_record_mix`, so both planes share one mixing discipline.

This module imports nothing: it sits below both planes.
"""
from __future__ import annotations

import zlib

# ---------------------------------------------------------------------------
# int32 arithmetic (two's complement, congruent with torch.int32 wrap)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF

# mixing constants, shared with the tensor twin in apply.py (which passes
# each as its i32 bit pattern: a Python int above 2**31 - 1 times an int32
# tensor raises in torch)
MIX_A = 0x9E3779B1  # 2654435761, Knuth multiplicative
MIX_B = 0x85EBCA77  # murmur3 c2
MIX_C = 1000003     # the repo's rolling-hash base (models/raft.py _mix_hash)
MIX_D = 69069       # VAX MTH$RANDOM multiplier
MIX_E = 40503       # 16-bit Fibonacci hashing constant


def u32(x: int) -> int:
    return x & _M32


def i32(x: int) -> int:
    """Two's-complement int32 view of x (an int32 tensor's bit pattern)."""
    x &= _M32
    return x - 0x1_0000_0000 if x >= 0x8000_0000 else x


# ---------------------------------------------------------------------------
# op-word codec (bit layout shared with the device decoder)
# ---------------------------------------------------------------------------
#
# A device-MVCC operation is ONE int32 entry word — the unit the consensus
# tier replicates.  Layout (low bit first):
#
#   [0:2]   kind        0=nop  1=put  2=delete-range  3=compact
#   [2]     cont        1 = this op continues the previous word's txn
#                       (same revision main, next sub) — the multi-op-txn
#                       encoding; the engine's apply frontier never sets it
#   [3:12]  key         slot id (put: the key; delete: range lo)
#   [12:24] val         put: value word
#   [24:28] lease       put: lease id (0 = none)
#   [12:22] hi          delete: exclusive range end (lo+1 = point delete,
#                       kvspec.keys = from-lo-to-end)
#   [3:28]  rev         compact: compaction revision
#
# Words stay < 2**28: always positive int32, and safely outside the
# conf-change bit window (bits 16-20) only in the sense that they are
# ENTRY_NORMAL — the apply plane masks on entry type, not bit patterns.
# KV words do NOT fit the int16 wire; device-apply runs require
# wire_int16=False exactly like the membership chaos tier.

KIND_NOP = 0
KIND_PUT = 1
KIND_DELETE = 2
KIND_COMPACT = 3

KEY_SHIFT, KEY_BITS = 3, 9
VAL_SHIFT, VAL_BITS = 12, 12
LEASE_SHIFT, LEASE_BITS = 24, 4
HI_SHIFT, HI_BITS = 12, 10
REV_SHIFT, REV_BITS = 3, 25

MAX_KEYS = (1 << KEY_BITS) - 1          # 511 key slots
MAX_VAL = (1 << VAL_BITS) - 1
MAX_LEASE = (1 << LEASE_BITS) - 1
MAX_COMPACT_REV = (1 << REV_BITS) - 1

CONT_BIT = 1 << 2


def encode_put(key: int, val: int, lease: int = 0, cont: bool = False) -> int:
    if not 0 <= key <= MAX_KEYS:
        raise ValueError(f"key {key} outside [0, {MAX_KEYS}]")
    if not 0 <= val <= MAX_VAL:
        raise ValueError(f"value word {val} outside [0, {MAX_VAL}]")
    if not 0 <= lease <= MAX_LEASE:
        raise ValueError(f"lease {lease} outside [0, {MAX_LEASE}]")
    return (
        KIND_PUT | (CONT_BIT if cont else 0)
        | (key << KEY_SHIFT) | (val << VAL_SHIFT) | (lease << LEASE_SHIFT)
    )


def encode_delete_range(lo: int, hi: int, cont: bool = False) -> int:
    """Tombstone live keys in [lo, hi). hi = lo+1 is a point delete."""
    if not 0 <= lo <= MAX_KEYS:
        raise ValueError(f"lo {lo} outside [0, {MAX_KEYS}]")
    if not 0 <= hi <= (1 << HI_BITS) - 1:
        raise ValueError(f"hi {hi} outside [0, {(1 << HI_BITS) - 1}]")
    return (
        KIND_DELETE | (CONT_BIT if cont else 0)
        | (lo << KEY_SHIFT) | (hi << HI_SHIFT)
    )


def encode_compact(rev: int) -> int:
    if not 0 <= rev <= MAX_COMPACT_REV:
        raise ValueError(f"rev {rev} outside [0, {MAX_COMPACT_REV}]")
    return KIND_COMPACT | (rev << REV_SHIFT)


def decode(word: int) -> dict:
    """Host-side decode (tests / debugging / host replay)."""
    kind = word & 3
    out = {"kind": kind, "cont": bool(word & CONT_BIT)}
    if kind == KIND_PUT:
        out["key"] = (word >> KEY_SHIFT) & MAX_KEYS
        out["val"] = (word >> VAL_SHIFT) & MAX_VAL
        out["lease"] = (word >> LEASE_SHIFT) & MAX_LEASE
    elif kind == KIND_DELETE:
        out["lo"] = (word >> KEY_SHIFT) & MAX_KEYS
        out["hi"] = (word >> HI_SHIFT) & ((1 << HI_BITS) - 1)
    elif kind == KIND_COMPACT:
        out["rev"] = (word >> REV_SHIFT) & MAX_COMPACT_REV
    return out


# ---------------------------------------------------------------------------
# canonical key/value byte encodings (the host plane's view)
# ---------------------------------------------------------------------------


def key_bytes(key_id: int) -> bytes:
    """Canonical byte key for a device key slot (sorted order == id order,
    so etcd range semantics coincide with slot-interval masks)."""
    return b"k%03d" % key_id


def key_id(key: bytes) -> int:
    """Inverse of :func:`key_bytes`; raises ValueError off the canonical
    key space (the device plane serves ONLY canonical keys)."""
    if len(key) == 4 and key[:1] == b"k" and key[1:].isdigit():
        kid = int(key[1:])
        if key_bytes(kid) == key:
            return kid
    raise ValueError(f"key {key!r} is not in the canonical device key space")


def encode_value(val: int) -> bytes:
    return b"v%d" % val


def decode_value(value: bytes) -> int:
    if value[:1] == b"v" and value[1:].isdigit():
        return int(value[1:])
    raise ValueError(f"value {value!r} is not a canonical device value word")


def value_hash32(val: int) -> int:
    """int32 mix of a value word — cheap enough for the device to compute
    inline (no byte hashing: the word IS the value reference)."""
    return i32(u32(val * MIX_A) ^ u32(val + MIX_B))


# ---------------------------------------------------------------------------
# the shared record fold
# ---------------------------------------------------------------------------


def record_mix(key: int, mod: int, create: int, version: int, vword: int,
               lease: int, tomb: bool) -> int:
    """Mix of one latest-record per-key tuple. The tensor twin
    (device_mvcc/apply.py _record_mix) stays line-for-line congruent;
    tests/test_torch_device_mvcc.py cross-checks them on random records."""
    h = u32(key * MIX_A + mod * MIX_B)
    h = u32(h ^ u32(create * MIX_C + version * MIX_D + 7))
    h = u32(h * MIX_C + (u32(value_hash32(vword)) ^ u32(lease * MIX_E)))
    if tomb:
        h = u32(h + MIX_D)
    return i32(h)


def latest_digest(records, current_rev: int, compact_rev: int) -> int:
    """Order-independent digest over latest-record tuples
    ``(key, mod, create, version, vword, lease, tomb)`` plus the store's
    revision cursors. The device twin is ``apply.kv_digest``."""
    s = 0
    for (key, mod, create, version, vword, lease, tomb) in records:
        s = u32(s + u32(record_mix(key, mod, create, version, vword, lease,
                                   tomb)))
    h = u32(s * MIX_C + current_rev * MIX_A)
    h = u32(h ^ u32(compact_rev * MIX_E + MIX_B))
    return i32(h)


def history_record_mix(main: int, sub: int, key32: int, val32: int,
                       tomb: bool) -> int:
    """Mix of one full-history revision record — the kernel behind
    ``MVCCStore.hash_kv``. Shares the constants (and so the bit-level
    mixing discipline) with :func:`record_mix`; key/value bytes arrive
    pre-hashed (:func:`bytes32`) because the device never folds raw
    bytes."""
    h = u32(main * MIX_A + sub * MIX_B)
    h = u32(h ^ u32(key32 * MIX_C + val32 * MIX_D + 7))
    if tomb:
        h = u32(h + MIX_E)
    return i32(h)


def bytes32(b: bytes) -> int:
    """Canonical bytes -> int32 (crc32; host-only — device values are
    words, never raw bytes)."""
    return i32(zlib.crc32(b))


# ---------------------------------------------------------------------------
# host-store helpers (duck-typed over MVCCStore; no import to keep
# layering acyclic: scheme <- {server.mvcc, device_mvcc.apply, tests})
# ---------------------------------------------------------------------------


def store_latest_records(store, nkeys: int):
    """Latest-record tuples for the canonical key slots of a host
    ``MVCCStore`` — the host-side view of the device revision store.
    A key's latest record is the newest revision in its keyIndex
    (tombstones included until compaction removes the whole key, exactly
    like the device's tombstone mask)."""
    out = []
    for kid in range(nkeys):
        ki = store.index.get(key_bytes(kid))
        if ki is None:
            continue
        last = None
        for gen in ki.generations:
            if gen:
                last = gen[-1]
        if last is None:
            continue
        kv, tomb = store.revs[(last.main, last.sub)]
        if tomb:
            out.append((kid, last.main, 0, 0, 0, 0, True))
        else:
            out.append((kid, kv.mod_revision, kv.create_revision, kv.version,
                        decode_value(kv.value), kv.lease, False))
    return out


def store_latest_digest(store, nkeys: int) -> int:
    """The canonical latest-record digest of a host store — MUST equal the
    device plane's ``kv_digest`` lane after applying the same words."""
    return latest_digest(
        store_latest_records(store, nkeys), store.current_rev,
        store.compact_rev,
    )
