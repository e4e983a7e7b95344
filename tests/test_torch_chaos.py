"""The port's chaos tier (network faults) against the JAX package.

* the held buffer's pack, scatter and merge, and the per-round checkers, on
  seeded random inputs;
* ``run_chaos`` at C = 16 under chaos_run.py's geometry (one fault epoch and
  one heal epoch of 10 rounds, plus the WaitHealth heal epochs it needs):
  the report, and the final state, inbox, held buffer and key, equal to the
  JAX run's on every leaf; the epoch makes no host sync in its rounds, nor
  do the crash and membership tiers' epochs (tests/test_torch_crash.py and
  tests/test_torch_member.py compare those with JAX);
* ``python -m etcd_tpu_torch.chaos_run``: its JSON keys (read from the JAX
  driver's source), its defaults, and its exit 2 on the knobs of the tiers
  the port does not run and on bad values (the crash and membership tiers'
  and the planes' knobs are read; tests/test_torch_blackbox.py holds the
  planes against JAX);
* slow: the same comparison at C = 64 for 75 rounds under tests/test_chaos.py's
  SPEC/CFG (K = 4, E = 2, int32 wire, no inbox bound).
"""
import ast
import collections
import dataclasses
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from etcd_tpu.harness import chaos as jch
from etcd_tpu.types import Msg as JMsg
from etcd_tpu.types import Spec as JSpec
from etcd_tpu.utils.config import RaftConfig as JRaftConfig
from etcd_tpu_torch import chaos_run
from etcd_tpu_torch.convert import from_numpy, to_numpy
from etcd_tpu_torch.harness import chaos as tch
from etcd_tpu_torch.types import Msg, Spec
from etcd_tpu_torch.utils.config import RaftConfig

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def jspec(spec):
    return JSpec(**dataclasses.asdict(spec))


def jcfg(cfg):
    return JRaftConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def jax_np(tree) -> dict:
    return {k: np.asarray(getattr(tree, k)) for k in tree.__dataclass_fields__}


def diff(a: dict, b: dict) -> list:
    return [k for k in a if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
            or not np.array_equal(a[k], b[k])]


def chaos_geometry(C=16):
    k = chaos_run.read_knobs({"CHAOS_C": str(C)}, on_card=False)
    return chaos_run.spec_and_config(k)


# ---------------------------------------------------------------------------
# the held buffer and the checkers
# ---------------------------------------------------------------------------


def random_wire(spec, C, wire16, rng) -> dict:
    """A flat wire [from, K*to(*E), C] with about a third of the slots live."""
    M, S, E = spec.M, spec.K * spec.M, spec.E
    out = {}
    for name in Msg.names():
        e = E if name in ("ent_term", "ent_data", "ent_type") else 1
        shape = (M, S * e, C)
        if name == "reject":
            out[name] = rng.random(shape) < 0.5
        else:
            lo, hi = (-2**15, 2**15) if wire16 else (-2**31, 2**31)
            out[name] = rng.integers(lo, hi, shape).astype(np.int16 if wire16 else np.int32)
    out["type"] = np.where(rng.random(out["type"].shape) < 0.35,
                           rng.integers(1, 18, out["type"].shape), 0).astype(out["type"].dtype)
    return out


CASES = [(wire16, seed) for wire16 in (True, False) for seed in (0, 1)]


@pytest.mark.parametrize("wire16,seed", CASES)
def test_held_buffer_equals_jax(wire16, seed):
    """_pack_held, _held_wins and _merge_delayed on random traffic, random
    delay masks (some rows over HELD_SLOTS) and a random held buffer."""
    spec, _ = chaos_geometry()
    C = 64
    rng = np.random.default_rng(seed)
    out = random_wire(spec, C, wire16, rng)
    S = spec.K * spec.M
    delay = (rng.random((spec.M, S, C)) < 0.25) & (out["type"] != 0)
    prev = tch._pack_held(spec, from_numpy(Msg, random_wire(spec, C, wire16, rng), "cpu"),
                          torch.from_numpy(rng.random((spec.M, S, C)) < 0.2))
    held_np = {"idx": prev.idx.numpy(), **to_numpy(prev.msgs)}
    jheld = jch.HeldSparse(idx=jnp.asarray(held_np["idx"]),
                           msgs=JMsg(**{k: jnp.asarray(held_np[k]) for k in Msg.names()}))
    jout = JMsg(**{k: jnp.asarray(v) for k, v in out.items()})
    tout = from_numpy(Msg, out, "cpu")
    js = jspec(spec)

    jp = jch._pack_held(js, jout, jnp.asarray(delay))
    tp = tch._pack_held(spec, tout, torch.from_numpy(delay))
    assert np.array_equal(np.asarray(jp.idx), tp.idx.numpy())
    assert diff(jax_np(jp.msgs), to_numpy(tp.msgs)) == []
    assert (np.asarray(jp.idx) >= 0).any()

    jw = jch._held_wins(js, jheld, jout)
    tw = tch._held_wins(spec, prev, tout)
    assert diff(jax_np(jw), to_numpy(tw)) == []

    jn, jh = jch._merge_delayed(js, jout, jheld, jnp.asarray(delay))
    tn, th = tch._merge_delayed(spec, tout, prev, torch.from_numpy(delay))
    assert diff(jax_np(jn), to_numpy(tn)) == []
    assert np.array_equal(np.asarray(jh.idx), th.idx.numpy())
    assert diff(jax_np(jh.msgs), to_numpy(th.msgs)) == []

    # the JAX package caches its message template per spec on first use,
    # and empty_held makes it under eval_shape: make it eagerly first, or
    # the cache would hold a tracer for every later JAX call
    from etcd_tpu.types import empty_msg

    empty_msg(js)
    je = jch.empty_held(js, C, wire16)
    te = tch.empty_held(spec, C, wire16, "cpu")
    assert np.array_equal(np.asarray(je.idx), te.idx.numpy())
    assert diff(jax_np(je.msgs), to_numpy(te.msgs)) == []


@pytest.mark.parametrize("seed", range(4))
def test_check_invariants_equals_jax(seed):
    rng = np.random.default_rng(seed)
    M, C = 5, 128
    leaves = {
        "role": rng.choice([0, 3], (M, C), p=[0.7, 0.3]),
        "term": rng.integers(1, 4, (M, C)),
        "applied": rng.integers(0, 3, (M, C)),
        "applied_hash": rng.integers(0, 2, (M, C)),
        "commit": rng.integers(0, 5, (M, C)),
    }
    leaves = {k: v.astype(np.int32) for k, v in leaves.items()}
    prev = rng.integers(0, 5, (M, C)).astype(np.int32)
    exempt = rng.random((M, C)) < 0.3
    jst = types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in leaves.items()})
    tst = types.SimpleNamespace(**{k: torch.from_numpy(v) for k, v in leaves.items()})
    for ex in (None, exempt):
        jv = jch.check_invariants(jst, jnp.asarray(prev), jch.zero_violations(),
                                  None if ex is None else jnp.asarray(ex))
        tv = tch.check_invariants(tst, torch.from_numpy(prev), tch.zero_violations("cpu"),
                                  None if ex is None else torch.from_numpy(ex))
        got = {k: int(v) for k, v in tv.items()}
        assert got == {k: int(getattr(jv, k)) for k in tch.VIOLATION_KEYS}
        assert got["multi_leader"] and got["hash_mismatch"] and got["commit_regress"]


# ---------------------------------------------------------------------------
# run_chaos against the JAX run
# ---------------------------------------------------------------------------


def run_both(spec, cfg, C, jax_kw=None, **kw):
    """run_chaos in both packages; the JAX run's last epoch outputs are
    caught by wrapping its epoch programs. ``jax_kw`` replaces arguments on
    the JAX side (its own config dataclasses)."""
    last = {}
    orig = jch._epoch_program

    def catching(*a, **k):
        f = orig(*a, **k)

        def g(*args):
            res = f(*args)
            last["out"] = res
            return res
        return g

    jch._epoch_program = catching
    try:
        jrep = jch.run_chaos(jspec(spec), jcfg(cfg), C=C, **{**kw, **(jax_kw or {})})
    finally:
        jch._epoch_program = orig
    end = {}
    trep = tch.run_chaos(spec, cfg, C=C, device="cpu", end=end, **kw)
    return jrep, trep, last["out"], end


def assert_same_run(jrep, trep, jout, end):
    assert trep == jrep
    jstate, jinbox, jheld, _, jkey = jout[:5]
    assert diff(jax_np(jstate), to_numpy(end["state"])) == []
    assert diff(jax_np(jinbox), to_numpy(end["inbox"])) == []
    if jheld is None:
        assert end["held"] is None
    else:
        assert np.array_equal(np.asarray(jheld.idx), end["held"].idx.numpy())
        assert diff(jax_np(jheld.msgs), to_numpy(end["held"].msgs)) == []
    assert np.array_equal(np.asarray(jkey), end["key"].numpy().astype(np.uint32))


@pytest.fixture(scope="module")
def small_run():
    spec, cfg = chaos_geometry()
    return run_both(spec, cfg, 16, rounds=20, epoch_len=10, heal_len=10, seed=0)


def test_run_chaos_equals_jax(small_run):
    assert_same_run(*small_run)


def test_run_chaos_report_is_chaos_runs(small_run):
    """The report's keys and the verdicts of summarize_chaos, both packages."""
    jrep, trep = small_run[:2]
    assert list(trep) == list(jrep)
    kw = dict(rounds=20, epoch_len=10, heal_len=10)
    assert tch.summarize_chaos(trep, **kw) == jch.summarize_chaos(jrep, **kw)
    assert tch.VIOLATION_KEYS == jch.VIOLATION_KEYS
    assert trep["groups_with_leader_after_heal"] == 16


class _HostTraffic(TorchDispatchMode):
    """Counts reads of a tensor's value on the host and copies of host data
    to a tensor."""

    BAD = ("aten._local_scalar_dense", "aten.lift_fresh")

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.BAD):
            self.seen[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("faultless", [False, True])
def test_epoch_rounds_make_no_host_sync(faultless):
    spec, cfg = chaos_geometry(C=8)
    cfg = dataclasses.replace(cfg, fleet_chunks=2)
    end = {}
    tch.run_chaos(spec, cfg, C=8, rounds=2, epoch_len=1, heal_len=1, device="cpu",
                  end=end)
    epoch = tch.build_chaos_epoch(cfg, spec, 3, faultless)
    prop_len = torch.zeros((5, 8), dtype=torch.int32)
    prop_data = torch.zeros((5, 1, 8), dtype=torch.int32)
    probs = [torch.tensor(p, dtype=torch.float32) for p in (0.1, 0.2, 0.3)]
    watch = _HostTraffic()
    with watch:
        out = epoch(end["state"], end["inbox"], end["held"], None, end["key"], prop_len,
                    prop_data, tch.zero_violations("cpu"), None, None, *probs)
    assert not watch.seen, dict(watch.seen)
    assert out[0].term.shape == (5, 8)


@pytest.mark.parametrize("faultless", [False, True])
@pytest.mark.parametrize("tier", ["crash", "member"])
def test_crash_and_member_epochs_make_no_host_sync(tier, faultless):
    """The crash tier's programs (int16 wire) and the membership and crash
    tiers' programs (int32 wire), fault and heal, in 2 fleet chunks: their
    rounds read no value on the host and copy no host data to a tensor."""
    spec, cfg = chaos_geometry(C=8)
    cfg = dataclasses.replace(cfg, fleet_chunks=2, wire_int16=tier == "crash")
    member_p = 0.3 if tier == "member" else 0.0
    end = {}
    tch.run_chaos(spec, cfg, C=8, rounds=2, epoch_len=1, heal_len=1, crash_p=0.2,
                  member_p=member_p, device="cpu", end=end)
    epoch = tch.build_chaos_epoch(cfg, spec, 3, faultless, with_crash=True,
                                  with_member=tier == "member")
    prop_len = torch.zeros((5, 8), dtype=torch.int32)
    prop_len[0] = 1
    prop_data = torch.full((5, 1, 8), 7, dtype=torch.int32)

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype)

    probs = (t(0.1), t(0.2), t(0.3))
    knobs = (t(0.3), t(2, torch.int32), t(True, torch.bool), t(True, torch.bool),
             t(member_p), tch.member_palette(spec, device="cpu"), t(200.0), t(4.0))
    watch = _HostTraffic()
    with watch:
        out = epoch(end["state"], end["inbox"], end["held"], end["crash"], end["key"],
                    prop_len, prop_data, tch.zero_violations("cpu"), None, None, *probs,
                    *knobs)
    assert not watch.seen, dict(watch.seen)
    assert out[3].down.shape == (5, 8)
    assert (prop_data == 7).all() and prop_len[0].eq(1).all()


@pytest.mark.parametrize("tier", ["with_crash", "with_member", "with_telemetry",
                                  "with_blackbox"])
def test_chaos_epoch_refuses_the_tiers_not_ported(tier):
    """Every tier was refused until it was ported: the crash and membership
    tiers and the telemetry and black-box planes now build; an epoch with a
    plane refuses to run without the plane's carry."""
    spec, cfg = chaos_geometry()
    epoch = tch.build_chaos_epoch(cfg, spec, 2, **{tier: True})
    assert callable(epoch)
    if tier in ("with_telemetry", "with_blackbox"):
        st = tch.init_fleet(spec, 2, device="cpu")
        ib = tch.empty_inbox(spec, 2, cfg.wire_int16, device="cpu")
        z = torch.zeros((), dtype=torch.float32)
        with pytest.raises(ValueError, match="pass one"):
            epoch(st, ib, tch.empty_held(spec, 2, cfg.wire_int16, "cpu"), None,
                  tch.prng.prng_key(0, "cpu"), torch.zeros((5, 2), dtype=torch.int32),
                  torch.zeros((5, 1, 2), dtype=torch.int32), tch.zero_violations("cpu"),
                  None, None, z, z, z)


def test_run_chaos_refuses_the_tiers_not_ported_and_the_diet_forms():
    """The diet forms are refused; the planes (each with the JAX checks of
    its size knobs) and the crash tier run, and the membership tier is
    refused only on the int16 wire, as in JAX."""
    spec, cfg = chaos_geometry()
    for kw, key in ((dict(telemetry=True), "timeline"), (dict(blackbox=True), "forensics")):
        rep = tch.run_chaos(spec, cfg, C=2, rounds=1, epoch_len=1, heal_len=1,
                            device="cpu", **kw)
        assert key in rep
    for kw, match in ((dict(telemetry=True, telemetry_buckets=17), "buckets"),
                      (dict(telemetry=True, telemetry_every=0), "telemetry_every"),
                      (dict(blackbox=True, blackbox_window=1), "window")):
        with pytest.raises(ValueError, match=match):
            tch.run_chaos(spec, cfg, C=2, rounds=1, device="cpu", **kw)
    rep = tch.run_chaos(spec, cfg, C=2, rounds=1, epoch_len=1, heal_len=1, crash_p=0.1,
                        device="cpu")
    assert "crashes_injected" in rep
    with pytest.raises(ValueError, match="int16 wire"):
        tch.run_chaos(spec, cfg, C=2, rounds=1, member_p=0.1, device="cpu")
    with pytest.raises(ValueError, match="dense wire"):
        tch.build_chaos_epoch(dataclasses.replace(cfg, compact_wire=True), spec, 2)


# ---------------------------------------------------------------------------
# python -m etcd_tpu_torch.chaos_run
# ---------------------------------------------------------------------------


def _jax_driver_keys() -> set:
    """The JSON keys of chaos_run.py's network tier at its defaults with the
    lease and KV tiers off: run_chaos's report literal, summarize_chaos's
    result literal (etcd_tpu/harness/chaos.py), the keys chaos_run.py sets
    itself, less the error keys of a failed tier, and the keys of the
    telemetry plane, which TELEM=1 (chaos_run.py's default) adds."""
    keys = set()
    src = ast.parse((ROOT / "etcd_tpu/harness/chaos.py").read_text())
    for fn in src.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in ("run_chaos", "summarize_chaos"):
            for node in ast.walk(fn):
                if isinstance(node, ast.Dict) and any(
                        isinstance(k, ast.Constant) and k.value == "groups"
                        or isinstance(k, ast.Constant) and k.value == "safe"
                        for k in node.keys):
                    keys |= {k.value for k in node.keys}
    drv = ast.parse((ROOT / "chaos_run.py").read_text())
    for node in ast.walk(drv):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript):
            t = node.targets[0]
            if isinstance(t.value, ast.Name) and t.value.id == "rep" \
                    and isinstance(t.slice, ast.Constant):
                keys.add(t.slice.value)
    return (keys - {"lease_tier_error", "kv_plane", "kv_plane_error"}) | {"telemetry",
                                                                         "timeline"}


def test_driver_json_keys_are_chaos_runs(monkeypatch, capsys):
    monkeypatch.setattr(chaos_run, "EPOCH_LEN", 2)
    monkeypatch.setattr(chaos_run, "HEAL_LEN", 2)
    for k in list(chaos_run.OFF_KNOBS) + ["CHAOS_C", "CHAOS_ROUNDS"]:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("CHAOS_C", "4")
    monkeypatch.setenv("CHAOS_ROUNDS", "4")
    rc = chaos_run.main([], device="cpu")
    import json

    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _jax_driver_keys()
    assert {"groups", "elapsed_s", "platform", "safe", "lively", "lease_safe"} <= want
    assert set(rep) == want, set(rep) ^ want
    assert rep["platform"] == "cpu" and rep["groups"] == 4
    assert rc == (0 if rep["safe"] and rep["recovered"] and rep["lively"] else 1)


def test_driver_defaults_are_chaos_runs():
    k = chaos_run.read_knobs({}, on_card=True)
    assert (k["C"], k["rounds"], k["drop_p"], k["delay_p"], k["partition_p"]) == \
        (262144, 200, 0.02, 0.05, 0.1)
    assert (k["L"], k["bound"], k["wire16"], k["chunks"], k["seed"]) == (16, 4, True, 1, 0)
    assert chaos_run.read_knobs({"CHAOS_C": "1048576"})["chunks"] == 8
    assert chaos_run.read_knobs({}, on_card=False)["C"] == 1000
    spec, cfg = chaos_run.spec_and_config(chaos_run.read_knobs({}))
    assert cfg == RaftConfig(pre_vote=True, check_quorum=True, max_inflight=4,
                             inbox_bound=4, coalesce_commit_refresh=True,
                             wire_int16=True, fleet_chunks=1)
    assert spec == Spec(M=5, L=16, E=1, K=2, W=4, R=2, A=2)


EXIT_2 = {
    "TELEM=yes": {"TELEM": "yes"},
    "TELEM_BUCKETS=17": {"TELEM_BUCKETS": "17"},
    "TELEM_BUCKETS=1": {"TELEM_BUCKETS": "1"},
    "TELEM_EVERY=0": {"TELEM_EVERY": "0"},
    "CHAOS_LEASE=1": {"CHAOS_LEASE": "1"},
    "CHAOS_BLACKBOX=2": {"CHAOS_BLACKBOX": "2"},
    "CHAOS_BLACKBOX_K=0": {"CHAOS_BLACKBOX_K": "0"},
    "CHAOS_BLACKBOX_WINDOW=1": {"CHAOS_BLACKBOX_WINDOW": "1"},
    "CHAOS_BLACKBOX_WINDOW=257": {"CHAOS_BLACKBOX_WINDOW": "257"},
    "APPLY_KEYS=64": {"APPLY_KEYS": "64"},
    "CHAOS_PRNG=rbg": {"CHAOS_PRNG": "rbg"},
    "CHAOS_DROP=1.5": {"CHAOS_DROP": "1.5"},
    "CHAOS_DELAY=nan": {"CHAOS_DELAY": "nan"},
    "CHAOS_C=0": {"CHAOS_C": "0"},
    "CHAOS_WIRE16=yes": {"CHAOS_WIRE16": "yes"},
}


@pytest.mark.parametrize("case", sorted(EXIT_2))
def test_driver_exits_2_on_knobs_it_cannot_honour(case):
    with pytest.raises(SystemExit) as e:
        chaos_run.read_knobs(EXIT_2[case])
    assert e.value.code == 2


def test_driver_exits_2_on_preflight():
    with pytest.raises(SystemExit) as e:
        chaos_run.main(["--preflight"], device="cpu")
    assert e.value.code == 2


@pytest.mark.slow
def test_run_chaos_equals_jax_test_chaos_geometry():
    """tests/test_chaos.py's SPEC/CFG and its small-fleet fault mix at C = 64
    for 75 rounds (K = 4, E = 2, int32 wire, no inbox bound). Slow: two JAX
    epoch programs of that geometry to compile (shared with that test)."""
    spec = Spec(M=5, L=32, E=2, K=4, W=2, R=2, A=4)
    cfg = RaftConfig(pre_vote=True, check_quorum=True)
    assert_same_run(*run_both(spec, cfg, 64, rounds=75, epoch_len=25, heal_len=25,
                              seed=1, drop_p=0.03, delay_p=0.08, partition_p=0.2))
