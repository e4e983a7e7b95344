"""The port's device MVCC apply plane against the JAX package's.

* ``device_mvcc/scheme.py`` (a copy) equals etcd_tpu's: constants, codec
  round trips, and the record mix of random records, with the port's tensor
  twin ``apply._record_mix`` congruent to both.
* ``apply_word``, ``apply_words``, ``check_rev``, ``read_at``, ``kv_digest``
  and ``extract_deltas`` equal JAX's, leaf for leaf, on ``gen_schedules``
  words at the JAX tests' fast sizes (keys 16, 128 groups, 60 ops, seed 2;
  keys 64, 32 groups, 80 ops, seed 3), among them lanes whose digest sum
  wraps int32; ``events_from_delta`` gives JAX's events.
* ``differential_run``'s report, and chaos_run's APPLY_KEYS tier's
  ``kv_plane``, equal JAX's ``differential_run`` report.
* ``DevicePlane`` and ``DeviceBackedStore`` equal JAX's on one scripted op
  sequence: records, digest, cursors, error counts, reads and errors.
* The host ``MVCCStore`` copy replays a schedule to JAX's snapshot.
Every leaf is an integer or a bool: exact equality, no tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu.device_mvcc import apply as japply
from etcd_tpu.device_mvcc import facade as jfacade
from etcd_tpu.device_mvcc import fuzz as jfuzz
from etcd_tpu.device_mvcc import scheme as jscheme
from etcd_tpu.device_mvcc import state as jstate
from etcd_tpu.server import mvcc as jmvcc
from etcd_tpu.server import watch as jwatch
from etcd_tpu_torch import chaos_run
from etcd_tpu_torch.convert import kv_state_from_numpy, to_numpy
from etcd_tpu_torch.device_mvcc import apply as tapply
from etcd_tpu_torch.device_mvcc import facade as tfacade
from etcd_tpu_torch.device_mvcc import fuzz as tfuzz
from etcd_tpu_torch.device_mvcc import scheme as tscheme
from etcd_tpu_torch.device_mvcc import state as tstate
from etcd_tpu_torch.server import mvcc as tmvcc
from etcd_tpu_torch.server import watch as twatch

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

torch.set_num_threads(1)

# the JAX tests' fast fuzz shapes (tests/test_device_mvcc.py): keys, groups,
# ops, seed
FAST = [(16, 128, 60, 2), (64, 32, 80, 3)]


def jax_np(tree) -> dict:
    return {k: np.asarray(getattr(tree, k)) for k in tree.__dataclass_fields__}


def diff(a: dict, b: dict) -> list:
    return [k for k in a if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
            or not np.array_equal(a[k], b[k])]


# the scheme copy


def test_scheme_constants_equal_jax():
    names = [n for n in dir(jscheme) if n.isupper()]
    assert len(names) > 15
    assert {n: getattr(tscheme, n) for n in names} == {n: getattr(jscheme, n)
                                                       for n in names}


def test_scheme_codecs_round_trip_as_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        kid = int(rng.integers(tscheme.MAX_KEYS + 1))
        val = int(rng.integers(tscheme.MAX_VAL + 1))
        lease = int(rng.integers(tscheme.MAX_LEASE + 1))
        cont = bool(rng.integers(2))
        lo = int(rng.integers(tscheme.MAX_KEYS + 1))
        hi = int(rng.integers(lo, 1 << tscheme.HI_BITS))
        rev = int(rng.integers(tscheme.MAX_COMPACT_REV + 1))
        for enc, args in (("encode_put", (kid, val, lease, cont)),
                          ("encode_delete_range", (lo, hi, cont)),
                          ("encode_compact", (rev,))):
            w = getattr(tscheme, enc)(*args)
            assert w == getattr(jscheme, enc)(*args)
            assert tscheme.decode(w) == jscheme.decode(w)
        assert tscheme.decode(tscheme.encode_put(kid, val, lease))["key"] == kid
        assert tscheme.key_id(tscheme.key_bytes(kid)) == kid
        assert tscheme.decode_value(tscheme.encode_value(val)) == val
        assert tscheme.value_hash32(val) == jscheme.value_hash32(val)
    for bad in (b"k12", b"x001", b"k0001"):
        with pytest.raises(ValueError):
            tscheme.key_id(bad)
    with pytest.raises(ValueError):
        tscheme.encode_put(tscheme.MAX_KEYS + 1, 0)


def test_record_mix_equals_jax_on_random_records():
    rng = np.random.default_rng(1)
    n = 256
    rec = dict(key=rng.integers(0, 512, n), mod=rng.integers(0, 1 << 24, n),
               create=rng.integers(0, 1 << 24, n), version=rng.integers(0, 1 << 16, n),
               vword=rng.integers(0, 4096, n), lease=rng.integers(0, 16, n))
    rec = {k: v.astype(np.int32) for k, v in rec.items()}
    tomb = rng.integers(0, 2, n).astype(bool)
    dev = tapply._record_mix(*[torch.from_numpy(rec[k]) for k in rec],
                             torch.from_numpy(tomb))
    jdev = np.asarray(japply._record_mix(*[jnp.asarray(rec[k]) for k in rec],
                                         jnp.asarray(tomb)))
    assert dev.dtype == torch.int32 and np.array_equal(dev.numpy(), jdev)
    host = [tscheme.record_mix(*[int(rec[k][i]) for k in rec], bool(tomb[i]))
            for i in range(n)]
    assert host == [jscheme.record_mix(*[int(rec[k][i]) for k in rec], bool(tomb[i]))
                    for i in range(n)]
    assert host == dev.tolist()
    vals = torch.arange(4096, dtype=torch.int32)
    assert tapply._value_hash32(vals).tolist() == [tscheme.value_hash32(v)
                                                   for v in range(4096)]


# the apply functions against JAX


@pytest.fixture(scope="module", params=FAST, ids=lambda p: f"keys{p[0]}")
def schedule(request):
    """One fast shape's schedule applied word by word in both packages, with
    a seeded ``active`` mask over the ops: per step (JAX state, port state)
    as numpy dicts."""
    keys, groups, ops, seed = request.param
    words = jfuzz.gen_schedules(jstate.KVSpec(keys=keys), groups, ops, seed)
    active = np.random.default_rng(seed).random(words.shape) < 0.9
    jkv = jstate.KVSpec(keys=keys)
    tkv = tstate.KVSpec(keys=keys)
    jstep = jax.jit(lambda s, w, a: japply.apply_word(jkv, s, w, a))
    js, ts = jstate.init_kv(jkv, groups), tstate.init_kv(tkv, groups, "cpu")
    steps = []
    for w, a in zip(words, active):
        js = jstep(js, w, a)
        ts = tapply.apply_word(tkv, ts, torch.from_numpy(w), torch.from_numpy(a))
        steps.append((jax_np(js), to_numpy(ts)))
    return dict(keys=keys, groups=groups, ops=ops, seed=seed, words=words,
                active=active, jkv=jkv, tkv=tkv, js=js, ts=ts, steps=steps)


def test_gen_schedules_equals_jax(schedule):
    s = schedule
    words = tfuzz.gen_schedules(s["tkv"], s["groups"], s["ops"], s["seed"])
    assert words.dtype == np.int32 and np.array_equal(words, s["words"])
    kinds = {int(w) & 3 for w in words.ravel()}
    assert kinds == {1, 2, 3}
    assert (words & tscheme.CONT_BIT).any()


def test_apply_word_equals_jax_every_step(schedule):
    for i, (j, t) in enumerate(schedule["steps"]):
        assert diff(j, t) == [], f"step {i}"
    last = schedule["steps"][-1][1]
    assert last["err_compacted"].sum() > 0 and last["err_future"].sum() > 0
    assert last["tomb"].any() and last["present"].any()


def test_apply_words_equals_jax(schedule):
    s = schedule
    jst = jax.jit(lambda st, w, a: japply.apply_words(s["jkv"], st, w, a))(
        jstate.init_kv(s["jkv"], s["groups"]), s["words"], s["active"])
    tst = tapply.apply_words(s["tkv"], tstate.init_kv(s["tkv"], s["groups"], "cpu"),
                             s["words"], s["active"])
    assert diff(jax_np(jst), to_numpy(tst)) == []
    assert diff(jax_np(jst), s["steps"][-1][1]) == []


def test_kv_digest_equals_jax_with_wrapping_lanes(schedule):
    s = schedule
    want = np.asarray(japply.kv_digest(s["jkv"], s["js"]))
    got = tapply.kv_digest(s["tkv"], s["ts"])
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # lanes whose key-axis sum leaves int32 before it wraps
    ids = torch.arange(s["keys"], dtype=torch.int32).unsqueeze(1)
    st = s["ts"]
    mix = tapply._record_mix(ids, st.mod, st.create, st.version, st.vword, st.lease,
                             st.tomb)
    wide = (mix.long() * st.present.long()).sum(0)
    assert ((wide < -2**31) | (wide > 2**31 - 1)).any()


def test_check_rev_and_read_at_equal_jax(schedule):
    s = schedule
    C = s["groups"]
    cur = s["ts"].current_rev
    rng = np.random.default_rng(7)
    cur = cur.numpy()
    revs = [0, -3, 5, cur + 1, (cur - rng.integers(0, 8, C)).astype(np.int32),
            s["ts"].compact_rev.numpy() - 1]
    for rev in revs:
        jout = japply.read_at(s["jkv"], s["js"], jnp.asarray(rev, jnp.int32))
        tout = tapply.read_at(s["tkv"], s["ts"], torch.as_tensor(rev, dtype=torch.int32))
        for j, t in zip(jout, tout):
            assert np.array_equal(np.asarray(j), t.numpy())
        jc = japply.check_rev(s["js"], jnp.asarray(rev, jnp.int32))
        tc = tapply.check_rev(s["ts"], torch.as_tensor(rev, dtype=torch.int32))
        for j, t in zip(jc, tc):
            assert np.array_equal(np.asarray(j), t.numpy())


def test_extract_deltas_and_events_equal_jax(schedule):
    s = schedule
    mid = s["steps"][len(s["steps"]) // 2]
    floor = mid[1]["current_rev"]
    jd = japply.extract_deltas(s["jkv"], jnp.asarray(floor), s["js"])
    td = tapply.extract_deltas(s["tkv"], torch.from_numpy(floor), s["ts"])
    assert diff(jax_np(jd), to_numpy(td)) == []
    assert to_numpy(td)["mask"].any() and to_numpy(td)["tomb"].any()
    # the delta's records are copies: they do not move with the store
    assert all(getattr(td, k).data_ptr() != getattr(s["ts"], k).data_ptr()
               for k in ("mod", "create", "version", "vword", "lease"))
    nxt = tapply.apply_word(s["tkv"], s["ts"], s["words"][0], True)
    assert diff(jax_np(jd), to_numpy(td)) == [] and nxt.mod is not td.mod
    for c in range(s["groups"]):
        assert [(t, dataclasses.astuple(kv), p) for t, kv, p in
                twatch.events_from_delta(td, c)] == \
            [(t, dataclasses.astuple(kv), p) for t, kv, p in
             jwatch.events_from_delta(jd, c)]


@pytest.mark.parametrize("keys, groups, ops, seed", FAST)
def test_differential_run_report_equals_jax(keys, groups, ops, seed):
    rep = tfuzz.differential_run(tstate.KVSpec(keys=keys), groups, ops, seed,
                                 device="cpu")
    assert rep == jfuzz.differential_run(jstate.KVSpec(keys=keys), groups, ops, seed)
    assert rep["parity_ok"] and rep["checked"] == groups


@pytest.mark.slow
def test_differential_run_acceptance_4096():
    """The JAX tests' acceptance shape: 4,096 schedules, every one replayed
    on the host."""
    rep = tfuzz.differential_run(tstate.KVSpec(keys=64), 4096, 120, 8, device="cpu")
    assert rep["checked"] == 4096 and rep["parity_ok"], rep


def test_chaos_run_apply_tier_kv_plane_equals_jax(monkeypatch, capsys):
    monkeypatch.setattr(chaos_run, "EPOCH_LEN", 2)
    monkeypatch.setattr(chaos_run, "HEAL_LEN", 2)
    env = {"CHAOS_LEASE": "0", "CHAOS_C": "4", "CHAOS_ROUNDS": "2", "TELEM": "0",
           "CHAOS_SEED": "3", "APPLY_KEYS": "16", "APPLY_GROUPS": "24",
           "APPLY_OPS": "40"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    chaos_run.main([], device="cpu")
    import json

    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jfuzz.differential_run(jstate.KVSpec(keys=16), groups=24, ops=40, seed=3)
    assert rep["kv_plane"] == want and rep["apply_parity_ok"] is True
    k = chaos_run.read_knobs({})
    assert (k["apply_keys"], k["apply_groups"], k["apply_ops"]) == (0, 256, 200)


# the host store copy and the facades


def test_host_replay_equals_jax_store():
    jkv, tkv = jstate.KVSpec(keys=16), tstate.KVSpec(keys=16)
    words = jfuzz.gen_schedules(jkv, 8, 60, 5)
    for g in range(8):
        js, jc, jf = jfuzz.host_replay(jkv, words[:, g])
        ts, tc, tf = tfuzz.host_replay(tkv, words[:, g])
        assert (tc, tf) == (jc, jf)
        assert ts.to_snapshot() == js.to_snapshot()
        assert ts.hash_kv() == js.hash_kv()
        assert ts.hash_kv_latest(16) == js.hash_kv_latest(16)


def _script(store, mvcc, ws=None):
    """One scripted op sequence on a DeviceBackedStore; the observable
    results in order (reads, revisions, errors, events, digests)."""
    sc = tscheme
    out = []

    def note(*x):
        out.append(x)

    def txn(ops):
        t = store.write_txn()
        for op, *a in ops:
            res = getattr(t, op)(*a)
            if op == "range":
                res = ([dataclasses.astuple(kv) for kv in res[0]],) + res[1:]
            note(op, res)
        note("end", t.end(), [(e, dataclasses.astuple(kv),
                               prev and dataclasses.astuple(prev)) for e, kv, prev in t.events])
        if ws is not None:
            ws.notify(t.events)

    txn([("put", sc.key_bytes(1), sc.encode_value(42), 3)])
    txn([("put", sc.key_bytes(0), sc.encode_value(7))])
    txn([("put", sc.key_bytes(1), sc.encode_value(43)),
         ("put", sc.key_bytes(2), sc.encode_value(5), 1),
         ("range", sc.key_bytes(0), b"\x00")])
    txn([("delete_range", sc.key_bytes(1), None)])
    txn([("delete_range", sc.key_bytes(5), sc.key_bytes(7))])          # nothing live
    txn([("put", sc.key_bytes(4), sc.encode_value(9)),
         ("delete_range", sc.key_bytes(0), sc.key_bytes(3))])
    for rev in (3, 2, 99, 5):
        try:
            store.compact(rev)
            note("compact", rev)
        except mvcc.MVCCError as e:
            note("compact", rev, type(e).__name__)
    for key, end, rev in ((0, b"\x00", 0), (4, None, 0), (0, b"\x00", 5), (0, b"\x00", 2),
                          (0, b"\x00", 99)):
        try:
            kvs, n, at = store.range(sc.key_bytes(key), end, rev)
            note("range", key, rev, [dataclasses.astuple(kv) for kv in kvs], n, at)
        except mvcc.MVCCError as e:
            note("range", key, rev, type(e).__name__)
    with pytest.raises(ValueError):
        store.write_txn().put(sc.key_bytes(store.plane.kvspec.keys), sc.encode_value(1))
    plane = store.plane
    note("cursors", store.current_rev, store.compact_rev, store.size,
         plane.err_counts(store.lane), plane.records(store.lane), store.hash_kv())
    snap = store.to_snapshot()
    note("snapshot", snap)
    store.load_snapshot(snap)
    note("reloaded", plane.records(store.lane), store.hash_kv(),
         sorted((k, dataclasses.astuple(v[0]), v[1]) for k, v in store.revs.items()))
    return out


def test_device_plane_and_store_equal_jax():
    jplane = jfacade.DevicePlane(jstate.KVSpec(keys=8), C=3)
    tplane = tfacade.DevicePlane(tstate.KVSpec(keys=8), C=3, device="cpu")
    jws = jwatch.WatchableStore()
    tws = twatch.WatchableStore()
    jw = jws.watch(jscheme.key_bytes(0), b"\x00")
    tw = tws.watch(tscheme.key_bytes(0), b"\x00")
    got = _script(tmvcc.DeviceBackedStore(tplane, lane=1), tmvcc, tws)
    want = _script(jmvcc.DeviceBackedStore(jplane, lane=1), jmvcc, jws)
    assert got == want
    assert [(e.type, dataclasses.astuple(e.kv)) for e in tws.take_events(tw.id)] == \
        [(e.type, dataclasses.astuple(e.kv)) for e in jws.take_events(jw.id)]
    # the other lanes never moved
    assert diff(jax_np(jplane.st), to_numpy(tplane.st)) == []
    assert tplane.records(0) == {} and tplane.current_rev(2) == 1
    assert tplane.digest(1) == jplane.digest(1)
    # a lane loaded from numpy state answers the same
    tplane.st = kv_state_from_numpy(jax_np(jplane.st), "cpu")
    assert tplane.records(1) == jplane.records(1)
