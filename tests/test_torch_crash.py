"""The port's crash-restart tier against the JAX package.

* CrashConfig's checks, the shaped randint the restart timeouts draw, and
  the crash metrics report;
* crash_restart_fleet (both durability models, keep_log as a bool and as a
  tensor) and wipe_crashed_traffic on a fleet settled by chaos rounds, with
  random crash masks, on every leaf; the durability classes of the state;
* ``run_chaos`` at C = 16 under chaos_run.py's geometry (int16 wire), one
  fault epoch and one heal epoch of 25 rounds, with the honest fsync-lag
  model and with the persist-nothing model, which share the JAX epoch
  programs: the report and the final state, inbox, held buffer, CrashState
  and key equal to the JAX run's; crashes and fsync losses happened, and
  the persist-nothing run trips the leader-completeness checker.

Every comparison is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu.harness import chaos as jch
from etcd_tpu.models import engine as jeng
from etcd_tpu.models import metrics as jmet
from etcd_tpu.models import state as jstate
from etcd_tpu.models.state import NodeState as JNodeState
from etcd_tpu.types import Msg as JMsg
from etcd_tpu.utils.config import CrashConfig as JCrashConfig
from etcd_tpu_torch.convert import from_numpy, to_numpy
from etcd_tpu_torch.harness import chaos as tch
from etcd_tpu_torch.models import engine as teng
from etcd_tpu_torch.models import metrics as tmet
from etcd_tpu_torch.models import state as tstate
from etcd_tpu_torch.models.state import NodeState
from etcd_tpu_torch.types import Msg
from etcd_tpu_torch.utils import prng
from etcd_tpu_torch.utils.config import CrashConfig

from test_torch_chaos import assert_same_run, chaos_geometry, diff, jax_np, jspec, run_both
from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

torch.set_num_threads(1)


def jtree(cls, leaves: dict):
    return cls(**{k: jnp.asarray(v) for k, v in leaves.items()})


# ---------------------------------------------------------------------------
# config, draws, counters
# ---------------------------------------------------------------------------

BAD_CRASH = {
    "down_rounds=0": dict(down_rounds=0),
    "down_rounds=-2": dict(down_rounds=-2),
    "durability=stabel": dict(durability="stabel"),
    "durability=''": dict(durability=""),
}


@pytest.mark.parametrize("case", sorted(BAD_CRASH))
def test_crash_config_checks_are_jaxs(case):
    with pytest.raises(ValueError) as j:
        JCrashConfig(**BAD_CRASH[case])
    with pytest.raises(ValueError) as t:
        CrashConfig(**BAD_CRASH[case])
    assert str(t.value) == str(j.value)


def test_crash_config_defaults_are_jaxs():
    assert dataclasses.asdict(CrashConfig()) == dataclasses.asdict(JCrashConfig())
    assert CrashConfig(down_rounds=1, durability="none").durability == "none"


@pytest.mark.parametrize("span", [10, 7])
def test_shaped_randint_equals_jax(span):
    """The restart timeouts' draw: jax.random.randint(key, (M, C), 0, span)
    over 200 keys, span = election_tick (and one more span that is not a
    power of two)."""
    shape = (5, 64)
    keys = jax.random.split(jax.random.PRNGKey(11), 200)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, shape, 0, span, dtype=jnp.int32))(keys))
    words = np.asarray(keys)                      # uint32 [200, 2]
    for i in range(200):
        key = torch.from_numpy(words[i].astype(np.int64))
        got = prng.randint(key, 0, span, shape)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want[i]), i


def random_metrics(rng, wrap=False) -> dict:
    vals = {k: np.int32(rng.integers(0, 2**20)) for k in tmet.CrashMetrics.names()}
    vals["crashes_injected"] = np.int32(rng.integers(1, 2**20))
    if wrap:
        vals["entries_lost_fsync"] = np.int32(-5)
    return vals


@pytest.mark.parametrize("wrap", [False, True])
def test_crash_metrics_report_equals_jax(wrap):
    vals = random_metrics(np.random.default_rng(int(wrap)), wrap)
    jm = jtree(jmet.CrashMetrics, vals)
    tm = from_numpy(tmet.CrashMetrics, {k: np.asarray(v) for k, v in vals.items()}, "cpu")
    if wrap:
        with pytest.raises(OverflowError) as j:
            jmet.crash_metrics_report(jm)
        with pytest.raises(OverflowError) as t:
            tmet.crash_metrics_report(tm)
        assert str(t.value) == str(j.value)
        return
    want = jmet.crash_metrics_report(jm)
    got = tmet.crash_metrics_report(tm)
    assert got == want and list(got) == list(want)
    zero = tmet.zero_crash_metrics("cpu")
    assert {k: (v.dtype, int(v)) for k, v in zero.items()} == \
        {k: (torch.int32, int(getattr(jmet.zero_crash_metrics(), k)))
         for k in tmet.CrashMetrics.names()}


# ---------------------------------------------------------------------------
# the crash machinery on a settled fleet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def settled():
    """A fleet after 30 chaos rounds of the port's crash tier at C = 16
    (leaders elected, entries committed, nodes down): its state, inbox and
    CrashState as numpy leaves. The port's rounds are held equal to the JAX
    package's by the end-to-end tests; here the fleet is only an input."""
    spec, cfg = chaos_geometry()
    end = {}
    tch.run_chaos(spec, cfg, C=16, rounds=30, epoch_len=20, heal_len=10, seed=4,
                  crash_p=0.05, device="cpu", end=end)
    st = to_numpy(end["state"])
    assert (st["role"] == 3).any() and (st["commit"] > 0).any()
    return spec, st, to_numpy(end["inbox"]), end["crash"].stable.numpy()


@pytest.mark.parametrize("keep_log,form", [(True, "bool"), (False, "bool"),
                                           (True, "tensor"), (False, "tensor")])
def test_crash_restart_fleet_equals_jax(settled, keep_log, form):
    spec, st, _, stable = settled
    rng = np.random.default_rng(int(keep_log) + 2 * (form == "tensor"))
    M, C = st["term"].shape
    crashed = rng.random((M, C)) < 0.4
    # floors at and below last_index, so some entries are past them
    stable = np.minimum(stable, st["last_index"] - rng.integers(0, 2, (M, C))).astype(np.int32)
    rand_to = rng.integers(10, 20, (M, C)).astype(np.int32)
    jk = keep_log if form == "bool" else jnp.bool_(keep_log)
    tk = keep_log if form == "bool" else torch.tensor(keep_log)
    js, jlost = jeng.crash_restart_fleet(jspec(spec), jtree(JNodeState, st),
                                         jnp.asarray(crashed), jnp.asarray(stable),
                                         jnp.asarray(rand_to), keep_log=jk)
    given = from_numpy(NodeState, st, "cpu")
    ts, tlost = teng.crash_restart_fleet(spec, given, torch.from_numpy(crashed),
                                         torch.from_numpy(stable),
                                         torch.from_numpy(rand_to), tk)
    assert diff(jax_np(js), to_numpy(ts)) == []
    assert tlost.dtype == torch.int32 and int(tlost) == int(jlost) > 0
    # the writes land in the leaves it was given
    assert ts.last_index is given.last_index
    changed = [k for k in st if not np.array_equal(st[k], np.asarray(getattr(js, k)))]
    assert {"last_index", "role", "applied"} <= set(changed)


def test_crash_restart_fleet_gives_shared_leaves_their_own_storage(settled):
    """A leaf sharing its storage with another (the same tensor under two
    fields) is copied before the write, so the other keeps its values."""
    spec, st, _, stable = settled
    M, C = st["term"].shape
    state = from_numpy(NodeState, st, "cpu")
    state = state.replace(snap_voters=state.voters)
    before = state.voters.clone()
    crashed = torch.zeros((M, C), dtype=torch.bool)
    crashed[:, ::2] = True
    out, _ = teng.crash_restart_fleet(spec, state, crashed, torch.from_numpy(stable),
                                      torch.full((M, C), 12, dtype=torch.int32))
    assert torch.equal(out.snap_voters, before)
    assert out.voters is not out.snap_voters


def test_durability_classes_are_jaxs():
    """Every field in exactly one class, and the classes the JAX package's."""
    for name in ("DURABLE_FIELDS", "CAPPED_FIELDS", "REPLAY_FIELDS", "VOLATILE_FIELDS"):
        assert getattr(tstate, name) == getattr(jstate, name), name
    classes = (tstate.DURABLE_FIELDS + tstate.CAPPED_FIELDS + tstate.REPLAY_FIELDS
               + tstate.VOLATILE_FIELDS)
    assert sorted(classes) == sorted(NodeState.names())


@pytest.mark.parametrize("wire16", [True, False])
def test_wipe_crashed_traffic_equals_jax(settled, wire16):
    spec, _, inbox, _ = settled
    rng = np.random.default_rng(int(wire16))
    M, _, C = inbox["type"].shape
    ib = {k: v if wire16 or v.dtype != np.int16 else v.astype(np.int32)
          for k, v in inbox.items()}
    live = rng.random(ib["type"].shape) < 0.5
    ib["type"] = np.where(live, rng.integers(1, 18, live.shape), 0).astype(ib["type"].dtype)
    crashed = rng.random((M, C)) < 0.3
    jw = jeng.wipe_crashed_traffic(jspec(spec), jtree(JMsg, ib), jnp.asarray(crashed))
    tw = teng.wipe_crashed_traffic(spec, from_numpy(Msg, ib, "cpu"),
                                   torch.from_numpy(crashed))
    assert diff(jax_np(jw), to_numpy(tw)) == []
    assert (ib["type"] != 0).sum() > (to_numpy(tw)["type"] != 0).sum() > 0


# ---------------------------------------------------------------------------
# run_chaos against the JAX run
# ---------------------------------------------------------------------------

RUN = dict(rounds=25, epoch_len=25, heal_len=25)
HONEST = dict(RUN, seed=0, crash_p=0.04, crash=CrashConfig(down_rounds=2))
# no drops or partitions, many crashes; the same epoch programs as HONEST
NOTHING = dict(RUN, seed=1, drop_p=0.0, partition_p=0.0, delay_p=0.08, crash_p=0.12,
               crash=CrashConfig(down_rounds=2, durability="none"))


@pytest.fixture(scope="module")
def crash_runs():
    """Both runs in both packages (one pair of JAX epoch programs: the
    durability model is an operand)."""
    spec, cfg = chaos_geometry()
    out = {}
    for name, kw in (("honest", HONEST), ("nothing", NOTHING)):
        out[name] = run_both(spec, cfg, 16, jax_kw={"crash": JCrashConfig(
            **dataclasses.asdict(kw["crash"]))}, **kw)
    return out


def assert_same_crash_state(jcrash, tcrash):
    leaves = {k: np.asarray(getattr(jcrash, k)) for k in tch.CrashState.names()
              if k != "metrics"}
    assert diff(leaves, {k: v.numpy() for k, v in tcrash.items() if k != "metrics"}) == []
    assert diff(jax_np(jcrash.metrics), to_numpy(tcrash.metrics)) == []


def test_crash_run_equals_jax(crash_runs):
    jrep, trep, jout, end = crash_runs["honest"]
    assert_same_run(jrep, trep, jout, end)
    assert_same_crash_state(jout[3], end["crash"])
    assert trep["crashes_injected"] > 0 and trep["entries_lost_fsync"] > 0
    assert trep["restarts_completed"] == trep["crashes_injected"]
    s = tch.summarize_chaos(trep, rounds=25, epoch_len=25, heal_len=25)
    assert s["safe"] and s["recovered"], (trep, s)


def test_persist_nothing_run_equals_jax_and_trips_the_checker(crash_runs):
    jrep, trep, jout, end = crash_runs["nothing"]
    assert_same_run(jrep, trep, jout, end)
    assert_same_crash_state(jout[3], end["crash"])
    assert trep["crashes_injected"] > 0 and trep["entries_lost_fsync"] > 0
    assert trep["lost_commit"] > 0
    assert trep["crash_durability"] == "none"


def test_crash_report_keys_are_jaxs(crash_runs):
    for jrep, trep, _, _ in crash_runs.values():
        assert list(trep) == list(jrep)
        assert {"crash_p", "crash_down_rounds", "snap_window_lane_frac",
                "crashes_injected", "snap_window_hit_rate"} <= set(trep)
