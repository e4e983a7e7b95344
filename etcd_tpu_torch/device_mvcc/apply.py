"""Batched txn apply, compaction, digest and watch-delta scan
(etcd_tpu/device_mvcc/apply.py).

One committed int32 entry word (scheme.py codec) is one MVCC operation;
``apply_word`` applies one word across the whole ``[keys, C]`` fleet as
straight-line masked tensor updates, the device twin of
``MVCCStore.WriteTxn`` (etcd_tpu_torch/server/mvcc.py):

  * a word with the CONT bit continues the open txn (same revision main);
    any other opens a new txn at ``current_rev + 1``, and ``current_rev``
    advances only when the txn wrote;
  * put: read-your-writes against the live store, version bump iff the
    key is live, a fresh generation (create=main, version=1) after a
    tombstone;
  * delete-range: one masked interval tombstone write; only live keys
    count toward the txn's write;
  * compact: ``ErrCompacted``/``ErrFutureRev`` become per-group status
    counters, then keys whose latest record is a tombstone at or below the
    compaction floor drop out of the index.

``kv_digest`` is the device half of the shared digest
(scheme.latest_digest); ``extract_deltas`` is the per-round watch delta
scan. All of it is plain PyTorch over int32 and bool tensors: the JAX
package ran these as XLA fusions, with no Pallas kernel. The hashes wrap
in int32 as the JAX ones do; every mixing constant enters as its
``scheme.i32`` bit pattern. Nothing here reads the host, so the functions
run inside a CUDA graph.
"""
from __future__ import annotations

import dataclasses

import torch

from etcd_tpu_torch.device_mvcc import scheme
from etcd_tpu_torch.device_mvcc.state import KVSpec, KVState
from etcd_tpu_torch.types import TensorStruct

I32 = torch.int32
MIX_A = scheme.i32(scheme.MIX_A)
MIX_B = scheme.i32(scheme.MIX_B)
MIX_C = scheme.i32(scheme.MIX_C)
MIX_D = scheme.i32(scheme.MIX_D)
MIX_E = scheme.i32(scheme.MIX_E)


def _value_hash32(val: torch.Tensor) -> torch.Tensor:
    """Tensor twin of scheme.value_hash32 (int32 wrap == u32 congruence)."""
    val = val.to(I32)
    return (val * MIX_A) ^ (val + MIX_B)


def _record_mix(key, mod, create, version, vword, lease, tomb):
    """Tensor twin of scheme.record_mix; keep line-for-line congruent."""
    h = key * MIX_A + mod * MIX_B
    h = h ^ (create * MIX_C + version * MIX_D + 7)
    h = h * MIX_C + (_value_hash32(vword) ^ (lease * MIX_E))
    return h + tomb.to(I32) * MIX_D


def _lanes(x, dtype, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=ref.device)


def apply_word(kvspec: KVSpec, st: KVState, word, active) -> KVState:
    """Apply one op word per group. ``word``/``active`` are [C] (a scalar
    broadcasts); inactive lanes and NOP kinds are the identity. Elementwise
    over [keys, C] with one-hot masks, no gathers."""
    K = kvspec.keys
    word, active = torch.broadcast_tensors(
        _lanes(word, I32, st.current_rev), _lanes(active, torch.bool, st.current_rev))

    kind = word & 3
    cont = (word & scheme.CONT_BIT) != 0
    key = (word >> scheme.KEY_SHIFT) & scheme.MAX_KEYS
    val = (word >> scheme.VAL_SHIFT) & scheme.MAX_VAL
    lease = (word >> scheme.LEASE_SHIFT) & scheme.MAX_LEASE
    hi = (word >> scheme.HI_SHIFT) & ((1 << scheme.HI_BITS) - 1)
    crev = (word >> scheme.REV_SHIFT) & scheme.MAX_COMPACT_REV

    is_put = active & (kind == scheme.KIND_PUT)
    is_del = active & (kind == scheme.KIND_DELETE)
    is_cmp = active & (kind == scheme.KIND_COMPACT)

    # a CONT word shares the open txn's main; anything else (a CONT with no
    # txn open included) opens a fresh txn at current_rev + 1, as the host
    # replay reopens after end(). txn_main == 0: no open txn.
    has_txn = cont & (st.txn_main > 0)
    main = torch.where(has_txn, st.txn_main, st.current_rev + 1)   # [C]
    main_k = main.unsqueeze(0)

    ids = torch.arange(K, dtype=I32, device=word.device).unsqueeze(1)   # [K, 1]
    live = st.present & ~st.tomb                                     # [K, C]

    # put
    pmask = is_put.unsqueeze(0) & (ids == key.unsqueeze(0))          # [K, C]
    new_present = st.present | pmask
    new_tomb = st.tomb & ~pmask
    new_mod = torch.where(pmask, main_k, st.mod)
    # fresh generation after absence or a tombstone: create=main, version=1;
    # a live key keeps create, version + 1 (key_index.go)
    new_create = torch.where(pmask, torch.where(live, st.create, main_k), st.create)
    new_version = torch.where(pmask, torch.where(live, st.version + 1, 1), st.version)
    new_vword = torch.where(pmask, val.unsqueeze(0), st.vword)
    new_lease = torch.where(pmask, lease.unsqueeze(0), st.lease)

    # delete-range
    dmask = (is_del.unsqueeze(0) & live & (ids >= key.unsqueeze(0))
             & (ids < hi.unsqueeze(0)))                               # [K, C]
    deleted_any = dmask.any(0)                                       # [C]
    # tombstoned keys stay present (in the index) until compaction; the
    # host tombstone KeyValue is (key, b"", create=0, mod=rev, version=0,
    # lease=0), so the same fields are zeroed
    new_tomb = new_tomb | dmask
    new_mod = torch.where(dmask, main_k, new_mod)
    new_create = new_create.masked_fill(dmask, 0)
    new_version = new_version.masked_fill(dmask, 0)
    new_vword = new_vword.masked_fill(dmask, 0)
    new_lease = new_lease.masked_fill(dmask, 0)

    wrote = is_put | (is_del & deleted_any)
    new_current = torch.where(wrote, main, st.current_rev)
    # a compact closes the open txn, so a later CONT word cannot bind to a
    # stale main
    new_txn_main = torch.where(is_put | is_del, main, st.txn_main.masked_fill(is_cmp, 0))

    # compact
    bad_c = is_cmp & (crev <= st.compact_rev)   # mvcc.ErrCompacted
    bad_f = is_cmp & (crev > st.current_rev)    # mvcc.ErrFutureRev
    ok_cmp = is_cmp & ~bad_c & ~bad_f
    new_compact = torch.where(ok_cmp, crev, st.compact_rev)
    # whole keys whose latest is a tombstone at or below the floor drop out
    # of the index (kvstore_compaction.go); live keys keep their latest
    gone = ok_cmp.unsqueeze(0) & st.tomb & (st.mod <= crev.unsqueeze(0))
    new_present = new_present & ~gone
    new_tomb = new_tomb & ~gone
    new_mod = new_mod.masked_fill(gone, 0)

    return st.replace(
        present=new_present, tomb=new_tomb, mod=new_mod, create=new_create,
        version=new_version, vword=new_vword, lease=new_lease,
        current_rev=new_current, compact_rev=new_compact, txn_main=new_txn_main,
        err_compacted=st.err_compacted + bad_c.to(I32),
        err_future=st.err_future + bad_f.to(I32),
    )


def apply_words(kvspec: KVSpec, st: KVState, words, active=None) -> KVState:
    """Apply a word stream [N, C] (each group its own schedule down axis 0,
    the differential fuzz layout). ``active`` [N, C] masks single ops;
    None = all on. Numpy arrays are moved to the store's device."""
    words = _lanes(words, I32, st.current_rev)
    active = (torch.ones(words.shape, dtype=torch.bool, device=words.device)
              if active is None else _lanes(active, torch.bool, st.current_rev))
    for w, a in zip(words, active):
        st = apply_word(kvspec, st, w, a)
    return st


# reads


def check_rev(st: KVState, rev):
    """The host's _check_rev window test as status lanes: (err_future,
    err_compacted, at) for a requested read revision (rev <= 0 means
    current); ``at`` is the served revision."""
    rev = _lanes(rev, I32, st.current_rev).expand(st.current_rev.shape)
    cur = torch.where(rev <= 0, st.current_rev, rev)
    err_f = cur > st.current_rev
    at = torch.where(err_f, st.current_rev, cur)
    err_c = at < st.compact_rev
    return err_f, err_c, at


def read_at(kvspec: KVSpec, st: KVState, rev=0):
    """Visibility at a revision: (visible [keys, C], unservable [keys, C],
    err_future [C], err_compacted [C]). A key is served at ``rev`` when its
    latest record is at or below it; a matching key whose mod_revision is
    above ``rev`` is ``unservable`` (its state at ``rev`` was compacted to
    the latest by construction: the honest answer is ErrCompacted)."""
    err_f, err_c, at = check_rev(st, rev)
    at_k = at.unsqueeze(0)
    reach = st.present & (st.mod <= at_k)
    visible = reach & ~st.tomb
    unservable = st.present & (st.mod > at_k)
    return visible, unservable, err_f, err_c


# digest (the device half of the shared fold)


def kv_digest(kvspec: KVSpec, st: KVState) -> torch.Tensor:
    """[C] int32, bit-equal to scheme.store_latest_digest of a host store
    that applied the same words. The key-axis sum wraps mod 2**32."""
    ids = torch.arange(kvspec.keys, dtype=I32, device=st.mod.device).unsqueeze(1)
    mix = _record_mix(ids, st.mod, st.create, st.version, st.vword, st.lease, st.tomb)
    s = (mix * st.present.to(I32)).sum(0, dtype=I32)
    h = s * MIX_C + st.current_rev * MIX_A
    return h ^ (st.compact_rev * MIX_E + MIX_B)


# watch deltas (the device-side delta scan)


@dataclasses.dataclass
class WatchDelta(TensorStruct):
    """Per-round [keys, C] delta tensors the host watch facade fans out.
    ``mask`` selects keys whose latest record moved past ``rev_floor`` this
    round; ``tomb`` tells delete events apart. Coalesced by revision: one
    event per key per round, carrying the newest record. The record leaves
    are copies of the store's, not views, so a delta stays valid after
    later rounds write the store."""

    mask: torch.Tensor       # bool [K, C]
    tomb: torch.Tensor       # bool [K, C]
    mod: torch.Tensor        # i32 [K, C]
    create: torch.Tensor     # i32 [K, C]
    version: torch.Tensor    # i32 [K, C]
    vword: torch.Tensor      # i32 [K, C]
    lease: torch.Tensor      # i32 [K, C]
    rev_floor: torch.Tensor  # i32 [C]: deltas cover (rev_floor, current_rev]


def extract_deltas(kvspec: KVSpec, rev_floor, st: KVState) -> WatchDelta:
    """Keys whose latest record landed after ``rev_floor`` (usually the
    previous round's current_rev). Compaction never fires a delta (it
    clears mod to 0, below any floor)."""
    rev_floor = _lanes(rev_floor, I32, st.current_rev).expand(
        st.current_rev.shape).clone()
    mask = st.present & (st.mod > rev_floor.unsqueeze(0))
    return WatchDelta(
        mask=mask, tomb=st.tomb & mask, mod=st.mod.clone(), create=st.create.clone(),
        version=st.version.clone(), vword=st.vword.clone(), lease=st.lease.clone(),
        rev_floor=rev_floor,
    )
