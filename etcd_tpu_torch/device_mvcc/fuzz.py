"""Differential fuzz harness: device plane vs host MVCCStore
(etcd_tpu/device_mvcc/fuzz.py).

Generates randomized txn schedules (puts, multi-op CONT txns, point /
interval / to-end delete-ranges, valid and deliberately-invalid
compactions), applies every schedule to BOTH planes — the device via one
batched ``apply_words`` over ``[ops, groups]`` (each group is its own
schedule: the groups axis carries schedule diversity), the host by
replaying each column through ``MVCCStore``/``WriteTxn`` — and compares:

  * the shared canonical digest (scheme.store_latest_digest vs
    apply.kv_digest) — the headline hash_kv parity gate,
  * revision bookkeeping (current_rev / compact_rev),
  * compaction-boundary errors (host ErrCompacted/ErrFutureRev exception
    counts vs the device status lanes),
  * per-key latest records, field by field.

``gen_schedules`` makes the same numpy draws as the JAX package's, so the
same seed gives the same words. Shared by tests/test_torch_device_mvcc.py
and etcd_tpu_torch.chaos_run's APPLY_* self-check tier.
"""
from __future__ import annotations

import numpy as np

from etcd_tpu_torch.device_mvcc import scheme
from etcd_tpu_torch.device_mvcc.apply import apply_words, kv_digest
from etcd_tpu_torch.device_mvcc.state import KVSpec, init_kv
from etcd_tpu_torch.server.mvcc import ErrCompacted, ErrFutureRev, MVCCStore


def gen_schedules(kvspec: KVSpec, groups: int, ops: int,
                  seed: int = 0) -> np.ndarray:
    """[ops, groups] int32 word matrix; each column an independent
    schedule. Mix: ~55% puts (some opening multi-op CONT txns), ~25%
    delete-ranges, ~20% compactions (split valid / below-floor /
    future)."""
    rng = np.random.default_rng(seed)
    K = kvspec.keys
    words = np.zeros((ops, groups), np.int32)
    for g in range(groups):
        cur = 1  # tracked optimistically (puts always bump); only used to
        # steer compaction revs toward interesting boundaries — exactness
        # is not required, invalid picks just exercise the error lanes
        cont_open = False
        for i in range(ops):
            r = rng.random()
            if r < 0.55:
                cont = cont_open and rng.random() < 0.5
                words[i, g] = scheme.encode_put(
                    int(rng.integers(K)), int(rng.integers(scheme.MAX_VAL + 1)),
                    int(rng.integers(scheme.MAX_LEASE + 1)), cont=cont,
                )
                if not cont:
                    cur += 1
                # ~30% of puts open a txn the next op may continue
                cont_open = rng.random() < 0.3
            elif r < 0.8:
                lo = int(rng.integers(K))
                kind = rng.random()
                if kind < 0.5:
                    hi = lo + 1                      # point delete
                elif kind < 0.8:
                    hi = int(rng.integers(lo, K)) + 1  # interval
                else:
                    hi = K                           # from lo to end
                cont = cont_open and rng.random() < 0.3
                words[i, g] = scheme.encode_delete_range(lo, hi, cont=cont)
                if not cont:
                    cur += 1
                cont_open = False
            else:
                kind = rng.random()
                if kind < 0.6:
                    rev = max(1, cur - int(rng.integers(1, 6)))  # plausible
                elif kind < 0.8:
                    rev = int(rng.integers(0, max(2, cur // 2)))  # often old
                else:
                    rev = cur + int(rng.integers(1, 50))  # future -> error
                words[i, g] = scheme.encode_compact(min(
                    rev, scheme.MAX_COMPACT_REV))
                # a compact closes the txn; sometimes leave cont_open set
                # anyway so schedules exercise the CONT-with-no-open-txn
                # guard (apply_word opens a fresh txn, like host replay)
                cont_open = rng.random() < 0.2
    return words


def host_replay(kvspec: KVSpec, column: np.ndarray):
    """Replay one schedule column through the host plane. Returns
    (store, err_compacted, err_future) — exceptions become counts, the
    host twin of the device status lanes."""
    store = MVCCStore()
    err_c = err_f = 0
    txn = None
    for word in column:
        op = scheme.decode(int(word))
        kind = op["kind"]
        if kind == scheme.KIND_NOP:
            continue
        if kind == scheme.KIND_COMPACT:
            if txn is not None:
                txn.end()
                txn = None
            try:
                store.compact(op["rev"])
            except ErrCompacted:
                err_c += 1
            except ErrFutureRev:
                err_f += 1
            continue
        if txn is None or not op["cont"]:
            if txn is not None:
                txn.end()
            txn = store.write_txn()
        if kind == scheme.KIND_PUT:
            txn.put(scheme.key_bytes(op["key"]), scheme.encode_value(op["val"]),
                    op["lease"])
        else:
            lo, hi = op["lo"], op["hi"]
            if hi >= kvspec.keys:
                range_end = b"\x00" if lo < kvspec.keys else None
                if lo >= kvspec.keys:
                    continue
            else:
                range_end = scheme.key_bytes(hi)
            if hi == lo + 1:
                range_end = None  # point delete, host single-key path
            txn.delete_range(scheme.key_bytes(lo), range_end)
    if txn is not None:
        txn.end()
    return store, err_c, err_f


def differential_run(kvspec: KVSpec, groups: int, ops: int, seed: int = 0,
                     check_groups: int | None = None, device=None) -> dict:
    """One batched device run (on ``device``, None: CUDA) vs per-column host
    replays.

    ``check_groups``: how many columns to replay host-side (None = all).
    Returns a report dict with mismatch counts (all-zero = parity)."""
    words = gen_schedules(kvspec, groups, ops, seed)
    st = apply_words(kvspec, init_kv(kvspec, groups, device), words)
    dig = kv_digest(kvspec, st).cpu().numpy()
    sub = type(st)(**{k: v.cpu().numpy() for k, v in st.items()})
    cur, cmp_ = sub.current_rev, sub.compact_rev
    ec, ef = sub.err_compacted, sub.err_future

    n = groups if check_groups is None else min(check_groups, groups)
    rep = {
        "groups": groups, "ops": ops, "seed": seed, "checked": n,
        "digest_mismatches": 0, "rev_mismatches": 0, "err_mismatches": 0,
        "record_mismatches": 0,
    }
    for g in range(n):
        store, herr_c, herr_f = host_replay(kvspec, words[:, g])
        if scheme.store_latest_digest(store, kvspec.keys) != int(dig[g]):
            rep["digest_mismatches"] += 1
        if (store.current_rev, store.compact_rev) != (int(cur[g]),
                                                      int(cmp_[g])):
            rep["rev_mismatches"] += 1
        if (herr_c, herr_f) != (int(ec[g]), int(ef[g])):
            rep["err_mismatches"] += 1
        host = {k: (m, c, v, w, le, t) for
                (k, m, c, v, w, le, t) in scheme.store_latest_records(
                    store, kvspec.keys)}
        dev = {}
        for kid in np.nonzero(sub.present[:, g])[0]:
            kid = int(kid)
            if sub.tomb[kid, g]:
                dev[kid] = (int(sub.mod[kid, g]), 0, 0, 0, 0, True)
            else:
                dev[kid] = (int(sub.mod[kid, g]), int(sub.create[kid, g]),
                            int(sub.version[kid, g]), int(sub.vword[kid, g]),
                            int(sub.lease[kid, g]), False)
        if host != dev:
            rep["record_mismatches"] += 1
    rep["parity_ok"] = not any(
        rep[k] for k in ("digest_mismatches", "rev_mismatches",
                         "err_mismatches", "record_mismatches")
    )
    return rep
