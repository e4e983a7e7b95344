"""The port's KV round, served-writes bench and wire and status probes
against the JAX package's.

* ``build_kv_round`` (bench.py's apply program cut to the classes this
  traffic carries, ``narrow_config``) at C = 16, in 1 and 2 fleet chunks,
  equals JAX's
  ``_jitted_kv_round`` after every round on every state, wire, KV-fleet and
  delta leaf: the settle, then proposals of ``gen_schedules`` words (puts,
  delete-ranges, CONT txns, compactions), with lanes whose apply operand is
  off long enough for the ring to overrun them, and keep-mask drops; with
  ``do_apply`` off the KV fleet stays as it was.
* etcd_tpu_torch.bench's apply program is bench.py's full RaftConfig,
  field for field, and equals the narrow program on the bench's traffic
  (port against port: the full round is held against JAX by
  tests/test_torch_general.py).
* A bound member that installs a peer snapshot freezes its lane under 2
  chunks (the pre-round ``applied`` is copied before the round writes it).
* The int16, packed and compact-wire refusals.
* ``wire_overflow_count`` and ``basic_status`` equal JAX's.
* ``python -m etcd_tpu_torch.bench`` with APPLY_MODE=both on the CPU prints
  bench.py's served-writes keys, serves every write in both modes and
  matches the digests.
One JAX program is compiled (the KV round at C = 16). Exact equality.
"""
import ast
import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu.device_mvcc import fuzz as jfuzz
from etcd_tpu.device_mvcc import state as jkvstate
from etcd_tpu.models import engine as jeng
from etcd_tpu.models import metrics as jmetrics
from etcd_tpu.types import Msg as JMsg
from etcd_tpu.types import Spec as JSpec
from etcd_tpu.utils.config import RaftConfig as JRaftConfig
from etcd_tpu_torch import bench, drive
from etcd_tpu_torch.convert import msg_from_numpy, node_state_from_numpy, to_numpy
from etcd_tpu_torch.device_mvcc import KVSpec, init_kv, scheme
from etcd_tpu_torch.models import engine as teng
from etcd_tpu_torch.models import metrics as tmetrics
from etcd_tpu_torch.types import MSG_SNAP, ROLE_LEADER, Spec
from etcd_tpu_torch.utils.config import RaftConfig

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
C = 16
KEYS = 16
SEED = 4
SETTLE = 6           # rounds after the MsgHup round: every group elects in 3
PROPOSE = 26         # rounds of proposals, then DRAIN without
DRAIN = 4
LAGGING = 4          # lanes 0..3 apply nothing for the first LAG_ROUNDS rounds
LAG_ROUNDS = 22

torch.set_num_threads(1)


def narrow_config(spec: Spec) -> RaftConfig:
    """bench.py's apply program (bench.apply_config) with the settle
    program's local steps, message classes and entry classes: the same KV
    round on the traffic here, and a JAX compile a quarter as long as the
    full program's at C = 16."""
    return dataclasses.replace(bench.apply_config(spec, 1), local_steps=("hup", "prop"),
                               message_classes=drive.SETTLE_CLASSES,
                               entry_classes=("normal",))


def jcfg(cfg):
    return JRaftConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def jnp_tree(cls, leaves: dict):
    return cls(**{k: jnp.asarray(v) for k, v in leaves.items()})


def jax_np(tree) -> dict:
    return {k: np.asarray(getattr(tree, k)) for k in tree.__dataclass_fields__}


def diff(a: dict, b: dict) -> list:
    return [k for k in a if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
            or not np.array_equal(a[k], b[k])]


def schedule(spec: Spec):
    """Per round (prop_len, prop_data, do_hup, keep, do_apply) as numpy."""
    M = spec.M
    words = jfuzz.gen_schedules(jkvstate.KVSpec(keys=KEYS), C, PROPOSE, SEED)
    rng = np.random.default_rng(SEED)
    rounds = []
    for r in range(1 + SETTLE + PROPOSE + DRAIN):
        p = r - 1 - SETTLE
        pl = np.zeros((M, C), np.int32)
        pd = np.zeros((M, spec.E, C), np.int32)
        if 0 <= p < PROPOSE:
            pl[0] = rng.random(C) < 0.85
            pd[0, 0] = words[p]
        hup = np.zeros((M, C), bool)
        hup[0] = r == 0
        keep = np.ones((M, M, C), bool)
        if 0 <= p < PROPOSE and p % 5 == 3:     # cut member 3 off in some groups
            cut = rng.random(C) < 0.5
            keep[3, :, cut] = False
            keep[:, 3, cut] = False
        on = np.ones(C, bool)
        if p < LAG_ROUNDS:
            on[:LAGGING] = False
        rounds.append((pl, pd, hup, keep, on))
    return rounds


@pytest.fixture(scope="module")
def trajectory():
    """The schedule through JAX's jitted KV round and the port's in 1 and 2
    chunks: per round the JAX leaves and each port run's leaves, as numpy
    dicts of (state, inbox, kv, delta)."""
    spec = drive.bench_spec()
    kvspec = KVSpec(keys=KEYS)
    cfg = narrow_config(spec)
    jspec = JSpec(**dataclasses.asdict(spec))
    jeng.empty_inbox(jspec, 1)          # the JAX empty message cache, made eagerly
    jrnd = jeng._jitted_kv_round(jcfg(cfg), jspec, jkvstate.KVSpec(keys=KEYS), 0)
    js = jeng.init_fleet(jspec, C, seed=0, election_tick=cfg.election_tick)
    ji = jeng.empty_inbox(jspec, C)
    jkv = jkvstate.init_kv(jkvstate.KVSpec(keys=KEYS), C)
    ports = {}
    for chunks in (1, 2):
        rnd = teng.build_kv_round(dataclasses.replace(cfg, fleet_chunks=chunks), spec,
                                  kvspec)
        ports[chunks] = [rnd, node_state_from_numpy(jax_np(js), "cpu"),
                         msg_from_numpy(jax_np(ji), "cpu"), init_kv(kvspec, C, "cpu")]
    z2 = np.zeros((spec.M, C), np.int32)
    zp = np.zeros((spec.M, spec.E, C), np.int32)
    no = np.zeros((spec.M, C), bool)
    rows = []
    for pl, pd, hup, keep, on in schedule(spec):
        js, ji, jkv, jd = jrnd(js, ji, jkv, on, pl, pd, zp, z2, hup, no, keep)
        jrow = tuple(jax_np(x) for x in (js, ji, jkv, jd))
        trow = {}
        for chunks, p in ports.items():
            args = [torch.from_numpy(x) for x in (on, pl, pd, zp, z2, hup, no, keep)]
            p[1], p[2], p[3], d = p[0](p[1], p[2], p[3], *args)
            # copies: on the CPU to_numpy shares the tensors' memory, and
            # the chunked round writes its next results into them
            trow[chunks] = tuple({k: v.copy() for k, v in to_numpy(x).items()}
                                 for x in (p[1], p[2], p[3], d))
        rows.append((jrow, trow))
    return dict(spec=spec, cfg=cfg, kvspec=kvspec, jrnd=jrnd, rows=rows,
                jax=(js, ji, jkv), port=ports[1][1:])


def test_kv_round_equals_jax_every_round(trajectory):
    for r, (j, t) in enumerate(trajectory["rows"]):
        for chunks, row in t.items():
            for what, a, b in zip(("state", "inbox", "kv", "delta"), j, row):
                assert diff(a, b) == [], f"round {r}, {chunks} chunks: {what}"


def test_kv_round_trajectory_exercises_the_plane(trajectory):
    (js, ji, jkv) = trajectory["jax"]
    kv = jax_np(jkv)
    rows = trajectory["rows"]
    assert (np.asarray(js.role[0]) == ROLE_LEADER).all()
    assert sum(int(j[3]["mask"].sum()) for j, _ in rows) > C * 10
    assert any(j[3]["tomb"].any() for j, _ in rows)          # delete events
    assert kv["skipped"][:LAGGING].sum() > 0 and (kv["skipped"][LAGGING:] == 0).all()
    assert kv["err_compacted"].sum() + kv["err_future"].sum() > 0
    # the lanes that applied all along keep up with the leader's frontier
    assert (kv["applied_idx"] == np.asarray(js.applied[0]))[LAGGING:].all()
    assert not kv["desynced"].any()


def test_kv_round_with_apply_off_leaves_the_fleet(trajectory):
    s = trajectory
    spec = s["spec"]
    pl = np.zeros((spec.M, C), np.int32)
    pl[0] = 1
    pd = np.zeros((spec.M, spec.E, C), np.int32)
    pd[0, 0] = scheme.encode_put(0, 9)
    z2 = np.zeros((spec.M, C), np.int32)
    no = np.zeros((spec.M, C), bool)
    keep = np.ones((spec.M, spec.M, C), bool)
    off = np.zeros(C, bool)
    js, ji, jkv = s["jax"]
    jout = s["jrnd"](js, ji, jkv, off, pl, pd, pd * 0, z2, no, no, keep)
    ts, ti, tkv = (x.map(lambda _, v: v.clone()) for x in s["port"])
    rnd = teng.build_kv_round(s["cfg"], spec, s["kvspec"])
    args = [torch.from_numpy(x) for x in (pl, pd, pd * 0, z2, no, no, keep)]
    tout = rnd(ts, ti, tkv, False, *args)
    for what, a, b in zip(("state", "inbox", "kv", "delta"), jout, tout):
        assert diff(jax_np(a), to_numpy(b)) == [], what
    assert diff(to_numpy(tout[2]), to_numpy(tkv)) == []
    assert not tout[3].mask.any()


def test_apply_config_equals_bench_py_full_program():
    """The apply bench runs bench.py:147-151's RaftConfig field for field,
    and on the bench's own traffic (a MsgHup round, puts, drain rounds) it
    equals the narrow program that the trajectory holds against JAX, port
    against port on every leaf."""
    spec = drive.bench_spec()
    for chunks in (1, 2):
        ref = JRaftConfig(pre_vote=True, check_quorum=True, max_inflight=4,
                          inbox_bound=spec.M - 1, coalesce_commit_refresh=True,
                          wire_int16=False, fleet_chunks=chunks)
        assert dataclasses.asdict(bench.apply_config(spec, chunks)) == \
            dataclasses.asdict(ref)
    kvspec = KVSpec(keys=KEYS)
    out = {}
    for name, cfg in (("full", bench.apply_config(spec, 1)), ("narrow", narrow_config(spec))):
        rnd = teng.build_kv_round(cfg, spec, kvspec)
        st = teng.init_fleet(spec, 8, device="cpu")
        ib = teng.empty_inbox(spec, 8, device="cpu")
        kv = init_kv(kvspec, 8, "cpu")
        z2 = torch.zeros((5, 8), dtype=torch.int32)
        zp = torch.zeros((5, 1, 8), dtype=torch.int32)
        no = torch.zeros((5, 8), dtype=torch.bool)
        hup = no.clone()
        hup[0] = True
        keep = torch.ones((5, 5, 8), dtype=torch.bool)
        rows = []
        for r in range(14):
            pl, pd = z2.clone(), zp.clone()
            if 4 <= r < 10:
                pl[0] = 1
                pd[0, 0] = scheme.encode_put(r % KEYS, r)
            st, ib, kv, d = rnd(st, ib, kv, True, pl, pd, zp, z2, hup if r == 0 else no,
                                no, keep)
            rows.append([to_numpy(x) for x in (st, ib, kv, d)])
        out[name] = rows
    assert int(out["full"][-1][2]["current_rev"].min()) > 1     # writes applied
    for r, (a, b) in enumerate(zip(out["full"], out["narrow"])):
        for what, x, y in zip(("state", "inbox", "kv", "delta"), a, b):
            assert diff(x, y) == [], f"round {r}: {what}"


def test_kv_round_freezes_on_snapshot_install_under_chunks():
    """tests/test_device_mvcc.py::test_engine_kv_round_freezes_on_snapshot_install
    on the port, in 2 fleet chunks: the round writes the fleet in place, so
    the bound member's pre-round ``applied`` must be a copy for the install
    to be seen."""
    spec = Spec(M=3, L=16, E=1, K=2, W=4, R=2, A=2)
    cfg = RaftConfig(pre_vote=True, check_quorum=True, max_inflight=4, inbox_bound=2,
                     coalesce_commit_refresh=True, wire_int16=False, fleet_chunks=2)
    kvspec = KVSpec(keys=16)
    n, M = 2, spec.M
    rnd = teng.build_kv_round(cfg, spec, kvspec, member=2)   # the slow follower
    z2 = torch.zeros((M, n), dtype=torch.int32)
    zp = torch.zeros((M, 1, n), dtype=torch.int32)
    no = torch.zeros((M, n), dtype=torch.bool)
    hup = no.clone()
    hup[0] = True
    full = torch.ones((M, M, n), dtype=torch.bool)
    cut2 = full.clone()
    cut2[:, 2] = False
    cut2[2, :] = False
    st = teng.init_fleet(spec, n, device="cpu")
    ib = teng.empty_inbox(spec, n, device="cpu")
    kv = init_kv(kvspec, n, "cpu")
    st, ib, kv, _ = rnd(st, ib, kv, True, z2, zp, zp, z2, hup, no, cut2)
    for _ in range(12):
        st, ib, kv, _ = rnd(st, ib, kv, True, z2, zp, zp, z2, no, no, cut2)
        if (st.role[0] == ROLE_LEADER).all():
            break
    # the leader runs far ahead while member 2 is cut: its ring compacts,
    # and member 2 can catch up only through MsgSnap
    for r in range(20):
        pl, pd = z2.clone(), zp.clone()
        pl[0] = 1
        pd[0, 0] = scheme.encode_put(r % 16, r)
        st, ib, kv, _ = rnd(st, ib, kv, True, pl, pd, zp, z2, no, no, cut2)
    assert (st.snap_index[0] > 0).all() and (st.applied[2] == 0).all()
    for _ in range(40):          # heal under ticks until the install
        st, ib, kv, delta = rnd(st, ib, kv, True, z2, zp, zp, z2, no, ~no, full)
        if kv.desynced.all():
            break
    assert (st.applied[2] > spec.A).all()
    assert kv.desynced.all()
    # frozen, not corrupted: nothing was replayed into the lanes
    assert (kv.current_rev == 1).all() and not kv.present.any()
    assert not delta.mask.any()


@pytest.mark.parametrize("form, match", [
    (dict(wire_int16=True), "int32 wire"),
    (dict(packed_state=True), "packed_state=False"),
    (dict(compact_wire=True), "compact_wire=False"),
])
def test_build_kv_round_refuses_what_it_cannot_read(form, match):
    spec = drive.bench_spec()
    cfg = dataclasses.replace(bench.apply_config(spec, 1), **form)
    with pytest.raises(ValueError, match=match):
        teng.build_kv_round(cfg, spec, KVSpec(keys=8))


def test_wire_overflow_count_equals_jax(trajectory):
    """On the KV round's int32 inbox, whose MsgApp entries carry KV words
    above int16; on the settle rounds' general-round inbox; and on a random
    int32 wire with MsgSnap slots (their commit is a registered split)."""
    spec = trajectory["spec"]
    jspec = JSpec(**dataclasses.asdict(spec))
    counts = []
    for r in (1, 1 + SETTLE + 5, 1 + SETTLE + 12):
        leaves = trajectory["rows"][r][0][1]
        got = teng.wire_overflow_count(spec, msg_from_numpy(leaves, "cpu"))
        want = jeng.wire_overflow_count(jspec, jnp_tree(JMsg, leaves))
        assert got.dtype == torch.int32 and int(got) == int(want)
        counts.append(int(got))
    assert counts[0] == 0 and counts[1] > 0
    rng = np.random.default_rng(SEED)
    leaves = {}
    for name, x in to_numpy(teng.empty_inbox(spec, C, device="cpu")).items():
        if x.dtype == bool:
            leaves[name] = rng.random(x.shape) < 0.5
        elif name == "type":
            leaves[name] = rng.choice(np.array([0, 1, 2, MSG_SNAP], np.int32), x.shape)
        else:
            leaves[name] = rng.integers(-2**20, 2**20, x.shape).astype(np.int32)
    got = teng.wire_overflow_count(spec, msg_from_numpy(leaves, "cpu"))
    assert int(got) == int(jeng.wire_overflow_count(jspec, jnp_tree(JMsg, leaves))) > 0
    with pytest.raises(ValueError, match="PRE-cast"):
        teng.wire_overflow_count(spec, teng.to_wire(msg_from_numpy(leaves, "cpu")))


def test_basic_status_equals_jax(trajectory):
    spec = trajectory["spec"]
    jspec = JSpec(**dataclasses.asdict(spec))
    js = trajectory["jax"][0]
    ts = node_state_from_numpy(jax_np(js), "cpu")
    for c in (0, 5, C - 1):
        for m in range(spec.M):
            got = tmetrics.basic_status(ts, spec, m, c)
            assert got == jmetrics.basic_status(js, jspec, m, c)
            assert ("progress" in got) == (m == 0)
    assert set(got) == {"id", "term", "vote", "commit", "applied", "lead", "raft_state"}


def _apply_bench_keys() -> set:
    """The keys bench.py's _apply_bench writes into its report, read from
    its source: the literal dict that holds "metric", and every
    ``rep["..."] = `` assignment."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_apply_bench")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            ks = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "metric" in ks:
                keys |= ks
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript):
            t = node.targets[0]
            if isinstance(t.value, ast.Name) and t.value.id == "rep":
                keys.add(t.slice.value)
    return keys


def test_bench_apply_mode_both_on_the_cpu(monkeypatch, capsys):
    for k, v in (("APPLY_MODE", "both"), ("APPLY_C", "64"), ("APPLY_ROUNDS", "8")):
        monkeypatch.setenv(k, v)
    assert bench.main([], device="cpu") == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _apply_bench_keys()
    assert {"device_served_ok", "digests_match", "vs_baseline"} <= want
    assert set(rep) == want
    assert rep["device_served_events"] == rep["host_served_events"] == 8 * 64
    assert rep["device_served_ok"] and rep["host_served_ok"] and rep["digests_match"]
    assert (rep["C"], rep["rounds"], rep["keys"], rep["platform"]) == (64, 8, 64, "cpu")


def test_bench_apply_knob_defaults_are_bench_py_s():
    k = bench.read_apply_knobs({})
    assert (k.mode, k.C, k.rounds, k.keys, k.chunks) == ("off", 262144, 32, 64, 2)
    assert bench.read_apply_knobs({}, on_card=False).C == 8192
    assert bench.read_apply_knobs({"APPLY_C": "1048576"}).chunks == 8
    cfg = bench.apply_config(drive.bench_spec(), 2)
    assert (cfg.wire_int16, cfg.compact_wire, cfg.packed_state, cfg.inbox_bound,
            cfg.fleet_chunks) == (False, False, False, 4, 2)
