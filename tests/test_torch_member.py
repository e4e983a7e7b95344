"""The port's membership tier and targeted crash scheduling against the JAX
package.

* MemberChaosConfig's checks, the palettes of the three mixes, the palette
  index draw (spans 13, 9 and 3) and the Bernoulli draw with a per-lane
  probability tensor, over 200 keys;
* targeted_crash_probs, bit for bit in float32, with boosts of 200 and 4,
  of 1, and overspent windows;
* the snapshot-install and membership window masks on random fleets where
  they are non-empty;
* refresh_ref_config and check_recovery_invariants, config-aware and
  config-blind, on the fleets of tests/test_recovery_member.py (removed
  voters abstain, a joint config needs both halves, the even-half bar) and
  on random fleets;
* run_chaos's refusals, and ``run_chaos`` at C = 16 under chaos_run.py's
  geometry on the int32 wire with membership and crash faults (standard
  mix, 3 initial voters, boosts 200 and 4): the report and the final state,
  inbox, held buffer, CrashState and key equal to the JAX run's, with conf
  changes applied and joint configs entered;
* ``python -m etcd_tpu_torch.chaos_run`` on the crash and membership knobs:
  its JSON keys and defaults;
* a leader whose log ring is full of uncommitted entries appends no entry
  of its term, in both packages (the reference's liveness limit behind the
  groups the membership tier leaves without a leader);
* slow: the config-blind shrink run, and a C = 64 membership run.

Every comparison is exact.
"""
import ast
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu.harness import chaos as jch
from etcd_tpu.models import engine as jeng
from etcd_tpu.models import raft as jraft
from etcd_tpu.models.state import NodeState as JNodeState
from etcd_tpu.types import Msg as JMsg
from etcd_tpu.types import Spec as JSpec
from etcd_tpu.utils import config as jconfig
from etcd_tpu_torch import chaos_run
from etcd_tpu_torch.convert import from_numpy, to_numpy
from etcd_tpu_torch.harness import chaos as tch
from etcd_tpu_torch.models import engine as teng
from etcd_tpu_torch.models import raft as traft
from etcd_tpu_torch.models.metrics import CrashMetrics
from etcd_tpu_torch.models.state import NodeState
from etcd_tpu_torch.types import Msg, Spec
from etcd_tpu_torch.utils import config as tconfig
from etcd_tpu_torch.utils import prng
from etcd_tpu_torch.utils.config import CrashConfig, MemberChaosConfig

from test_torch_chaos import (
    ROOT,
    _jax_driver_keys,
    assert_same_run,
    chaos_geometry,
    diff,
    jax_np,
    jspec,
    run_both,
)
from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

torch.set_num_threads(1)

# tests/test_recovery_member.py's SPEC, for the checker fleets
SPEC = Spec(M=5, L=32, E=2, K=4, W=2, R=2, A=4)


def jtree(cls, leaves: dict):
    return cls(**{k: jnp.asarray(v) for k, v in leaves.items()})


def member_geometry(C=16):
    k = chaos_run.read_knobs({"CHAOS_C": str(C), "CHAOS_MEMBER": "0.05"}, on_card=False)
    return chaos_run.spec_and_config(k)


# ---------------------------------------------------------------------------
# config, palettes, draws
# ---------------------------------------------------------------------------

BAD_MEMBER = {
    "mix=nope": dict(mix="nope"),
    "initial_voters=1": dict(initial_voters=1),
    "initial_voters=-1": dict(initial_voters=-1),
    "snap_crash_boost=0.5": dict(snap_crash_boost=0.5),
    "member_crash_boost=0.9": dict(member_crash_boost=0.9),
}


@pytest.mark.parametrize("case", sorted(BAD_MEMBER))
def test_member_config_checks_are_jaxs(case):
    with pytest.raises(ValueError) as j:
        jconfig.MemberChaosConfig(**BAD_MEMBER[case])
    with pytest.raises(ValueError) as t:
        MemberChaosConfig(**BAD_MEMBER[case])
    assert str(t.value) == str(j.value)


def test_member_config_defaults_are_jaxs():
    assert tconfig.MEMBER_MIXES == jconfig.MEMBER_MIXES
    assert dataclasses.asdict(MemberChaosConfig()) == \
        dataclasses.asdict(jconfig.MemberChaosConfig())


@pytest.mark.parametrize("mix", ["standard", "simple", "shrink"])
def test_member_palette_equals_jax(mix):
    spec, _ = member_geometry()
    want = np.asarray(jch.member_palette(jspec(spec), mix))
    got = tch.member_palette(spec, mix, "cpu")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert len(want) == {"standard": 13, "simple": 9, "shrink": 3}[mix]


def test_member_palette_refuses_two_members():
    spec = Spec(M=2, L=8, E=1, K=1, W=2, R=2, A=2)
    with pytest.raises(ValueError) as j:
        jch.member_palette(JSpec(**dataclasses.asdict(spec)))
    with pytest.raises(ValueError) as t:
        tch.member_palette(spec, device="cpu")
    assert str(t.value) == str(j.value)


def keys200(seed):
    return np.asarray(jax.random.split(jax.random.PRNGKey(seed), 200))


@pytest.mark.parametrize("span", [13, 9, 3])
def test_palette_index_draw_equals_jax(span):
    """inject_member's draw: jax.random.randint(key, (C,), 0, P) for the
    palette sizes of the three mixes, over 200 keys."""
    keys = keys200(span)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (64,), 0, span, dtype=jnp.int32))(keys))
    for i in range(200):
        got = prng.randint(torch.from_numpy(keys[i].astype(np.int64)), 0, span, (64,))
        assert np.array_equal(got.numpy(), want[i]), i


def test_bernoulli_with_a_probability_per_lane_equals_jax():
    """The crash draw: jax.random.bernoulli(key, p_lane) with a float32 [M, C]
    probability tensor (its shape is the draw's), over 200 keys."""
    rng = np.random.default_rng(0)
    p = rng.random((5, 64)).astype(np.float32) * 0.2
    p[0, :8] = 1.0
    p[1, :8] = 0.0
    keys = keys200(3)
    want = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, jnp.asarray(p)))(keys))
    tp = torch.from_numpy(p)
    for i in range(200):
        got = prng.bernoulli(torch.from_numpy(keys[i].astype(np.int64)), tp)
        assert np.array_equal(got.numpy(), want[i]), i
    assert want.any() and not want.all()


# ---------------------------------------------------------------------------
# targeted scheduling and the windows
# ---------------------------------------------------------------------------

PROBS = {
    "boosts 200 and 4": (0.005, 200.0, 4.0, 0.004, 0.05),
    "boosts 200 and 4, crash 0.01": (0.01, 200.0, 4.0, 0.002, 0.1),
    "uniform": (0.01, 1.0, 1.0, 0.01, 0.1),
    "overspent": (0.01, 1e4, 1e4, 0.02, 0.1),
    "overspent at boosts 200 and 4": (0.05, 200.0, 4.0, 0.05, 0.3),
}


def _fma_f32(a, b, c):
    """float32(a * b + c) rounded once: a fused multiply-add."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _probs_with_fma(cp, snap, mem, sb, mb):
    """targeted_crash_probs in numpy float32 with its three multiply-adds
    fused, as XLA's CPU backend contracts them inside a fused computation."""
    f = np.float32
    lanes = f(snap.size)
    budget = f(cp * lanes)
    mo = mem & ~snap
    ws, wm = f(snap.sum()), f(mo.sum())
    ps, pm = min(f(cp * sb), f(1)), min(f(cp * mb), f(1))
    spend = _fma_f32(ps, ws, f(pm * wm))
    scale = f(budget / max(spend, f(1e-9))) if spend > budget else f(1)
    ps, pm = f(ps * scale), f(pm * scale)
    rest = max(f(f(lanes - ws) - wm), f(1))
    left = _fma_f32(-pm, wm, _fma_f32(-ps, ws, budget))
    base = min(max(f(left / rest), f(0)), f(1))
    return np.where(snap, ps, np.where(mo, pm, base)).astype(np.float32)


_JIT_PROBS = jax.jit(jch.targeted_crash_probs)


@pytest.mark.parametrize("case", sorted(PROBS))
def test_targeted_crash_probs_equals_jax_bit_for_bit(case):
    """The port's float32 p_lane equals JAX's op by op (each jnp operation
    rounded on its own) on every bit, over 50 random window layouts (one of
    them with both windows empty). Compiled under jax.jit on the CPU, XLA
    may fuse the three multiply-adds into FMAs, which moves the last bit;
    the test pins that every such difference is exactly that."""
    cp, sb, mb, snap_rate, mem_rate = PROBS[case]
    f32 = np.float32
    overspent = 0
    for seed in range(50):
        rng = np.random.default_rng(seed)
        C = (16, 200, 2000)[seed % 3]
        snap = rng.random((5, C)) < snap_rate * (seed > 0)
        mem = rng.random((5, C)) < mem_rate * (seed > 0)
        jargs = (jnp.float32(cp), jnp.asarray(snap), jnp.asarray(mem), jnp.float32(sb),
                 jnp.float32(mb))
        want = np.asarray(jch.targeted_crash_probs(*jargs))
        got = tch.targeted_crash_probs(torch.tensor(f32(cp)), torch.from_numpy(snap),
                                       torch.from_numpy(mem), torch.tensor(f32(sb)),
                                       torch.tensor(f32(mb)))
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32)), seed
        jit = np.asarray(_JIT_PROBS(*jargs)).view(np.int32)
        assert np.array_equal(jit, want.view(np.int32)) or np.array_equal(
            jit, _probs_with_fma(f32(cp), snap, mem, f32(sb), f32(mb)).view(np.int32)), seed
        w = snap.sum() * min(cp * sb, 1) + (mem & ~snap).sum() * min(cp * mb, 1)
        overspent += w > cp * snap.size
    if case.startswith("overspent"):
        assert overspent > 25


def random_fleet(spec, C, rng) -> dict:
    """A fleet whose window-relevant leaves are random: roles, peer
    progress states, joint configs, logs with conf-change entries and
    commit/applied cursors around them."""
    st = to_numpy(teng.init_fleet(spec, C, device="cpu"))
    M, L = spec.M, spec.L
    st["role"] = rng.choice([0, 3], (M, C), p=[0.7, 0.3]).astype(np.int32)
    st["pr_state"] = rng.choice([0, 1, 2], (M, M, C), p=[0.45, 0.5, 0.05]).astype(np.int32)
    st["voters_out"] = rng.random((M, M, C)) < 0.03
    last = rng.integers(0, 3 * L, (M, C)).astype(np.int32)
    snap = np.maximum(last - rng.integers(0, L, (M, C)), 0).astype(np.int32)
    commit = np.minimum(last, snap + rng.integers(0, L, (M, C))).astype(np.int32)
    st["last_index"], st["snap_index"], st["commit"] = last, snap, commit
    st["applied"] = np.maximum(commit - rng.integers(0, 4, (M, C)), snap).astype(np.int32)
    st["log_type"] = (rng.random((M, L, C)) < 0.15).astype(np.int32)
    return st


@pytest.mark.parametrize("wire16", [True, False])
def test_window_masks_equal_jax(wire16):
    spec, _ = member_geometry()
    rng = np.random.default_rng(7 + wire16)
    C = 256
    st = random_fleet(spec, C, rng)
    ib = to_numpy(teng.empty_inbox(spec, C, wire16, device="cpu"))
    ib["type"] = rng.choice([0, 1, 5, 14], ib["type"].shape,
                            p=[0.8, 0.1, 0.02, 0.08]).astype(ib["type"].dtype)
    js, tsn = jtree(JNodeState, st), from_numpy(NodeState, st, "cpu")
    snap_j = np.asarray(jeng.snapshot_window_mask(jspec(spec), js, jtree(JMsg, ib)))
    snap_t = teng.snapshot_window_mask(spec, tsn, from_numpy(Msg, ib, "cpu")).numpy()
    mem_j = np.asarray(jeng.member_window_mask(jspec(spec), js))
    mem_t = teng.member_window_mask(spec, tsn).numpy()
    assert np.array_equal(snap_t, snap_j) and np.array_equal(mem_t, mem_j)
    assert 0 < snap_j.sum() < snap_j.size and 0 < mem_j.sum() < mem_j.size
    # both sides of the snapshot window, and both kinds of membership lane
    assert (ib["type"] == 5).any() and ((st["role"] == 3) & (st["pr_state"] == 2).any(1)).any()
    assert (mem_j & ~st["voters_out"].any(1)).any()


# ---------------------------------------------------------------------------
# the recovery checkers
# ---------------------------------------------------------------------------


def _li(per_member, C=2):
    return np.broadcast_to(np.asarray(per_member, np.int32)[:, None], (5, C)).copy()


def _vo_joint(C=2):
    vo = np.zeros((5, 5, C), bool)
    vo[:, :3] = True
    return vo


# the fleets of tests/test_recovery_member.py:264-340: (voters, overrides)
CHECKER_FLEETS = {
    "removed voters abstain": ([1, 1, 0, 0, 0], dict(
        last_index=_li([5, 5, 0, 0, 0]), commit=_li([5, 5, 0, 0, 0]))),
    "joint needs both halves": ([1, 1, 1, 1, 1], dict(
        voters_out=_vo_joint(), last_index=_li([11, 11, 9, 0, 0]),
        commit=_li([11, 11, 9, 0, 0]))),
    "joint, outgoing half erasable": ([1, 1, 1, 1, 1], dict(
        voters_out=_vo_joint(), last_index=_li([11, 9, 9, 0, 0]),
        commit=_li([11, 11, 9, 0, 0]))),
    "even half, two holders": ([1, 1, 1, 1, 0], dict(
        last_index=_li([7, 7, 0, 0, 0]), commit=_li([7, 7, 0, 0, 0]))),
    "even half, one holder": ([1, 1, 1, 1, 0], dict(
        last_index=_li([7, 0, 0, 0, 0]), commit=_li([7, 7, 0, 0, 0]))),
}
# (lost_commit config-aware, config-blind) in tests/test_recovery_member.py
CHECKER_LOST = {"removed voters abstain": (0, 2), "joint needs both halves": (0, None),
                "joint, outgoing half erasable": (2, None),
                "even half, two holders": (0, None), "even half, one holder": (2, None)}


def jax_and_port_crash(spec, st, crash_np=None):
    """The JAX CrashState (empty_crash_state of the fleet, or the given
    leaves) and the port's, from the same numpy leaves."""
    js = jtree(JNodeState, st)
    if crash_np is None:
        jc = jch.empty_crash_state(js)
        crash_np = {k: np.asarray(getattr(jc, k)) for k in tch.CrashState.names()
                    if k != "metrics"}
    jc = jch.CrashState(**{k: jnp.asarray(v) for k, v in crash_np.items()},
                        metrics=jch.zero_crash_metrics())
    tc = tch.CrashState(**{k: torch.from_numpy(np.array(v)) for k, v in crash_np.items()},
                        metrics=tch.zero_crash_metrics("cpu"))
    return js, jc, from_numpy(NodeState, st, "cpu"), tc


def compare_checkers(spec, st, crash_np, aware):
    js, jc, ts, tc = jax_and_port_crash(spec, st, crash_np)
    jv, jc2 = jch.check_recovery_invariants(jspec(spec), js, jc, jch.zero_violations(),
                                            jnp.bool_(aware))
    tv, tc2 = tch.check_recovery_invariants(spec, ts, tc, tch.zero_violations("cpu"),
                                            torch.tensor(aware))
    got = {k: int(v) for k, v in tv.items()}
    assert got == {k: int(getattr(jv, k)) for k in tch.VIOLATION_KEYS}
    names = [k for k in tch.CrashState.names() if k != "metrics"]
    assert diff({k: np.asarray(getattr(jc2, k)) for k in names},
                {k: getattr(tc2, k).numpy() for k in names}) == []
    return got


@pytest.mark.parametrize("aware", [True, False])
@pytest.mark.parametrize("fleet", sorted(CHECKER_FLEETS))
def test_check_recovery_invariants_equals_jax(fleet, aware):
    voters, over = CHECKER_FLEETS[fleet]
    jst = jeng.init_fleet(jspec(SPEC), 2, voters=jnp.asarray(voters, jnp.bool_), seed=0)
    st = {k: np.asarray(getattr(jst, k)) for k in NodeState.names()}
    st.update(over)
    got = compare_checkers(SPEC, st, None, aware)
    want = CHECKER_LOST[fleet][0 if aware else 1]
    if want is not None:
        assert got["lost_commit"] == want


@pytest.mark.parametrize("aware", [True, False])
def test_recovery_bookkeeping_equals_jax_on_random_fleets(aware):
    """refresh_ref_config and check_recovery_invariants on random fleets and
    random carried bookkeeping (reference configs taken at applied indexes
    above and below the fleet's), over 20 seeds: the counters fire."""
    spec, _ = member_geometry()
    fired = {k: 0 for k in ("lost_commit", "log_divergence", "term_regress")}
    for seed in range(20):
        rng = np.random.default_rng(100 * aware + seed)
        M, C, L = spec.M, 64, spec.L
        st = random_fleet(spec, C, rng)
        st["term"] = rng.integers(1, 4, (M, C)).astype(np.int32)
        st["log_term"] = rng.integers(1, 3, (M, L, C)).astype(np.int32)
        st["snap_term"] = rng.integers(1, 3, (M, C)).astype(np.int32)
        st["voters"] = rng.random((M, M, C)) < 0.7
        st["learners"] = rng.random((M, M, C)) < 0.1
        crash = {
            "stable": st["last_index"].copy(),
            "down": np.zeros((M, C), np.int32),
            "watermark": rng.integers(0, 3 * L, (C,)).astype(np.int32),
            "prev_term": rng.integers(1, 4, (M, C)).astype(np.int32),
            "ref_voters": rng.random((M, C)) < 0.7,
            "ref_voters_out": rng.random((M, C)) < 0.1,
            "ref_tracked": rng.random((M, C)) < 0.8,
            "ref_applied": rng.integers(-1, 3 * L, (C,)).astype(np.int32),
        }
        js, jc, ts, tc = jax_and_port_crash(spec, st, crash)
        jr = jch.refresh_ref_config(js, jc)
        tr = tch.refresh_ref_config(ts, tc)
        for k in ("ref_voters", "ref_voters_out", "ref_tracked", "ref_applied"):
            assert np.array_equal(getattr(tr, k).numpy(), np.asarray(getattr(jr, k))), k
        got = compare_checkers(spec, st, crash, aware)
        for k in fired:
            fired[k] += got[k] > 0
    assert all(fired.values()), fired


# ---------------------------------------------------------------------------
# run_chaos
# ---------------------------------------------------------------------------


def test_run_chaos_refusals_are_jaxs():
    """run_chaos's four ValueErrors, raised before any device work."""
    spec, cfg = chaos_geometry()
    m1 = Spec(M=1, L=16, E=1, K=2, W=4, R=2, A=2)
    cases = [
        (m1, cfg, dict(crash_p=0.1)),
        (spec, dataclasses.replace(cfg, wire_int16=False), dict(member_p=0.1, propose=False)),
        (spec, cfg, dict(member_p=0.1)),
        (spec, cfg, dict(member=MemberChaosConfig(initial_voters=6))),
    ]
    for sp, cf, kw in cases:
        jkw = dict(kw)
        if "member" in kw:
            jkw["member"] = jconfig.MemberChaosConfig(initial_voters=6)
        with pytest.raises(ValueError) as j:
            jch.run_chaos(jspec(sp), jconfig.RaftConfig(**dataclasses.asdict(cf)), C=4,
                          **jkw)
        with pytest.raises(ValueError) as t:
            tch.run_chaos(sp, cf, C=4, device="cpu", **kw)
        assert str(t.value) == str(j.value)


MEMBER = dict(rounds=25, epoch_len=25, heal_len=25, seed=2, crash_p=0.03,
              crash=CrashConfig(down_rounds=2), member_p=0.15,
              member=MemberChaosConfig(initial_voters=3, snap_crash_boost=200.0,
                                       member_crash_boost=4.0))


def jax_kw(kw):
    out = {}
    if kw.get("crash") is not None:
        out["crash"] = jconfig.CrashConfig(**dataclasses.asdict(kw["crash"]))
    if kw.get("member") is not None:
        out["member"] = jconfig.MemberChaosConfig(**dataclasses.asdict(kw["member"]))
    return out


def assert_same_crash_state(jcrash, tcrash):
    names = [k for k in tch.CrashState.names() if k != "metrics"]
    assert diff({k: np.asarray(getattr(jcrash, k)) for k in names},
                {k: getattr(tcrash, k).numpy() for k in names}) == []
    assert diff(jax_np(jcrash.metrics), to_numpy(tcrash.metrics)) == []


@pytest.fixture(scope="module")
def member_run():
    spec, cfg = member_geometry()
    assert not cfg.wire_int16
    return run_both(spec, cfg, 16, jax_kw=jax_kw(MEMBER), **MEMBER)


def test_member_run_equals_jax(member_run):
    jrep, trep, jout, end = member_run
    assert_same_run(jrep, trep, jout, end)
    assert_same_crash_state(jout[3], end["crash"])
    assert list(trep) == list(jrep)
    assert trep["conf_changes_applied"] > 0 and trep["joint_entered"] > 0
    assert trep["member_changes_proposed"] > 0 and trep["crashes_injected"] > 0
    assert trep["cc_guard_refusals"] + trep["cc_guard_admits"] > 0
    s = tch.summarize_chaos(trep, rounds=25, epoch_len=25, heal_len=25, liveness_frac=0.1)
    assert s["safe"] and s["recovered"], (trep, s)


# ---------------------------------------------------------------------------
# python -m etcd_tpu_torch.chaos_run, crash and membership knobs
# ---------------------------------------------------------------------------


def _jax_tier_keys() -> set:
    """The keys chaos_run.py's JSON gains with the crash and membership
    tiers: run_chaos's ``rep[...]`` assignments outside the telemetry and
    black-box planes (etcd_tpu/harness/chaos.py), the CrashMetrics fields
    and crash_metrics_report's derived keys."""
    keys = set()
    src = ast.parse((ROOT / "etcd_tpu/harness/chaos.py").read_text())
    fn = next(n for n in src.body if isinstance(n, ast.FunctionDef) and n.name == "run_chaos")
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript):
            t = node.targets[0]
            if isinstance(t.value, ast.Name) and t.value.id == "rep":
                keys.add(t.slice.value)
    met = ast.parse((ROOT / "etcd_tpu/models/metrics.py").read_text())
    fn = next(n for n in met.body if isinstance(n, ast.FunctionDef)
              and n.name == "crash_metrics_report")
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript):
            keys.add(node.targets[0].slice.value)
    keys |= set(CrashMetrics.names())
    return keys - {"telemetry", "timeline", "forensics"}


@pytest.mark.parametrize("tier", ["crash", "member"])
def test_driver_json_keys_are_chaos_runs_on_the_new_tiers(monkeypatch, capsys, tier):
    monkeypatch.setattr(chaos_run, "EPOCH_LEN", 2)
    monkeypatch.setattr(chaos_run, "HEAL_LEN", 2)
    for k in ("CHAOS_CRASH", "CHAOS_MEMBER", "CHAOS_WIRE16", "CHAOS_INIT_VOTERS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("CHAOS_C", "4")
    monkeypatch.setenv("CHAOS_ROUNDS", "4")
    monkeypatch.setenv("CHAOS_CRASH", "0.2")
    if tier == "member":
        monkeypatch.setenv("CHAOS_MEMBER", "0.3")
    rc = chaos_run.main([], device="cpu")
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _jax_driver_keys() | _jax_tier_keys()
    if tier == "crash":
        want -= {"member_p", "member_mix", "initial_voters"}
    assert set(rep) == want, set(rep) ^ want
    assert rep["crash_p"] == 0.2 and rep["crash_durability"] == "stable"
    if tier == "member":
        assert rep["initial_voters"] == 3 and rep["member_mix"] == "standard"
    assert rc == (0 if rep["safe"] and rep["recovered"] and rep["lively"] else 1)


# the tier knobs, each read with chaos_run.py's defaults for the others
# (CHAOS_CRASH, CHAOS_MEMBER and CHAOS_INIT_VOTERS alone among them: the
# driver exited 2 on those before the tiers were ported)
TIER_KNOBS = {
    "CHAOS_CRASH=0.01": (
        {"CHAOS_CRASH": "0.01"},
        dict(crash_p=0.01, member_p=0.0, crash=CrashConfig(), wire16=True,
             liveness_frac=0.2, member=MemberChaosConfig(), config_aware=True)),
    "CHAOS_MEMBER=0.05": (
        {"CHAOS_MEMBER": "0.05"},
        dict(crash_p=0.0, member_p=0.05, crash=None, wire16=False, liveness_frac=0.1,
             member=MemberChaosConfig(initial_voters=3), config_aware=True)),
    "CHAOS_INIT_VOTERS=3": (
        {"CHAOS_INIT_VOTERS": "3"},
        dict(crash_p=0.0, member_p=0.0, crash=None, wire16=True, liveness_frac=0.2,
             member=MemberChaosConfig(initial_voters=3))),
    "member, boosts, config-blind": (
        {"CHAOS_MEMBER": "0.05", "CHAOS_SNAP_BOOST": "200", "CHAOS_MEMBER_BOOST": "4",
         "CHAOS_CONFIG_AWARE": "0"},
        dict(crash=None, wire16=False, liveness_frac=0.1, config_aware=False,
             member=MemberChaosConfig(initial_voters=3, snap_crash_boost=200.0,
                                      member_crash_boost=4.0))),
    "crash knobs, mix, voters": (
        {"CHAOS_CRASH": "0.1", "CHAOS_DOWN": "5", "CHAOS_DURABILITY": "none",
         "CHAOS_INIT_VOTERS": "4", "CHAOS_MEMBER_MIX": "shrink"},
        dict(crash=CrashConfig(down_rounds=5, durability="none"),
             member=MemberChaosConfig(mix="shrink", initial_voters=4))),
}


@pytest.mark.parametrize("case", sorted(TIER_KNOBS))
def test_driver_tier_defaults_are_chaos_runs(case):
    env, want = TIER_KNOBS[case]
    k = chaos_run.read_knobs(env)
    assert {n: k[n] for n in want} == want
    assert chaos_run.spec_and_config(k)[1].wire_int16 == k["wire16"]


TIER_EXIT_2 = {
    "CHAOS_MEMBER with CHAOS_WIRE16=1": {"CHAOS_MEMBER": "0.05", "CHAOS_WIRE16": "1"},
    "CHAOS_MEMBER_MIX=nope": {"CHAOS_MEMBER": "0.05", "CHAOS_MEMBER_MIX": "nope"},
    "CHAOS_DURABILITY=stabel": {"CHAOS_CRASH": "0.01", "CHAOS_DURABILITY": "stabel"},
    "CHAOS_DOWN=0": {"CHAOS_CRASH": "0.01", "CHAOS_DOWN": "0"},
    "CHAOS_INIT_VOTERS=6": {"CHAOS_INIT_VOTERS": "6"},
    "CHAOS_INIT_VOTERS=1": {"CHAOS_MEMBER": "0.05", "CHAOS_INIT_VOTERS": "1"},
    "CHAOS_SNAP_BOOST=0.5": {"CHAOS_SNAP_BOOST": "0.5"},
    "CHAOS_CRASH=1.5": {"CHAOS_CRASH": "1.5"},
    "CHAOS_CONFIG_AWARE=yes": {"CHAOS_CONFIG_AWARE": "yes"},
}


@pytest.mark.parametrize("case", sorted(TIER_EXIT_2))
def test_driver_exits_2_on_bad_tier_knobs(case, capsys):
    with pytest.raises(SystemExit) as e:
        chaos_run.read_knobs(TIER_EXIT_2[case])
    assert e.value.code == 2
    assert capsys.readouterr().err.startswith("chaos_run: ")


# ---------------------------------------------------------------------------
# slow
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_config_blind_shrink_run_equals_jax():
    """tests/test_recovery_member.py's config-blind schedule (shrink mix) at
    C = 16: both checkers in both packages; the blind one fires. Slow: the
    shrink palette is a new palette shape, so a new pair of JAX programs."""
    spec, cfg = member_geometry()
    kw = dict(rounds=25, epoch_len=25, heal_len=25, seed=5, drop_p=0.0, delay_p=0.05,
              partition_p=0.0, crash_p=0.02, crash=CrashConfig(down_rounds=2),
              member_p=0.25, member=MemberChaosConfig(mix="shrink", initial_voters=3))
    reps = {}
    for aware in (True, False):
        jrep, trep, jout, end = run_both(spec, cfg, 16, jax_kw=jax_kw(kw),
                                         config_aware=aware, **kw)
        assert_same_run(jrep, trep, jout, end)
        reps[aware] = trep
    assert reps[True]["conf_changes_applied"] > 0
    assert reps[False]["lost_commit"] > 0


@pytest.mark.slow
def test_member_run_equals_jax_at_64_groups():
    """The membership and crash tiers at C = 64 for a fault epoch of 50 and a
    heal epoch of 25 rounds (a new pair of JAX programs)."""
    spec, cfg = member_geometry(64)
    kw = dict(MEMBER, epoch_len=50, rounds=75, seed=0)
    jrep, trep, jout, end = run_both(spec, cfg, 64, jax_kw=jax_kw(kw), **kw)
    assert_same_run(jrep, trep, jout, end)
    assert_same_crash_state(jout[3], end["crash"])
    assert trep["joint_entered"] > 0


# ---------------------------------------------------------------------------
# the full-ring leader (a liveness limit of the reference, reproduced)
# ---------------------------------------------------------------------------


def test_leader_with_a_full_ring_appends_no_entry_of_its_term():
    """The reference's log is a ring of L slots, and append_entries_state
    refuses what would pass snap_index + L (etcd_tpu/models/raft.py:256
    cap_over), its new leader's empty entry included. A node whose ring is
    full of uncommitted entries of older terms that becomes leader therefore
    holds no entry of its own term and can never commit (Raft commits only
    entries of the leader's term): the groups of the membership tier that
    stay leaderless or commit nothing after WaitHealth are in this state.
    Both packages agree on every leaf; a ring one slot short appends."""
    spec, cfg = member_geometry(C=2)
    L = spec.L
    st = to_numpy(teng.init_fleet(spec, 2, device="cpu"))
    st["term"][:] = 5
    st["snap_index"][:] = 19
    st["commit"][:] = 19
    st["applied"][:] = 19
    st["last_index"][:] = np.array([19 + L, 19 + L - 1], np.int32)   # full, one short
    st["log_term"][:] = 3
    jfn = jax.vmap(jax.vmap(lambda n: jraft.become_leader_state(
        jconfig.RaftConfig(**dataclasses.asdict(cfg)), jspec(spec), n),
        in_axes=-1, out_axes=-1))
    want = jax_np(jfn(jtree(JNodeState, st)))
    got = to_numpy(traft.become_leader_state(cfg, spec, from_numpy(NodeState, st, "cpu")))
    assert diff(want, got) == []
    assert (got["role"] == 3).all()
    assert (got["last_index"][:, 0] == 19 + L).all()            # refused
    assert (got["last_index"][:, 1] == 19 + L).all()            # appended
    slot = (19 + L - 1) % L
    assert (got["log_term"][:, slot, 0] == 3).all() and (got["log_term"][:, slot, 1] == 5).all()
