"""The port's general round against the JAX round, leaf for leaf.

Three views of the round that every program beyond the bench's steady loop
runs (ticks, elections with pre-vote, check-quorum, heartbeats, the
read-index queue, snapshots, leadership transfer, conf changes):

* the whole round, ``build_round`` with every local step, message class and
  entry class, stepped 32 times at C = 16 on the int32 wire from seeded
  random ticks, hups, read-index requests, proposals (conf changes among
  them) and keep-masks, equal to the JAX program after every round on every
  state and wire leaf;
* ``process_message`` alone, for each of the 17 message types with empty
  slots among them, on 256 node states taken from that trajectory, with
  seeded random messages, under ``RaftConfig()`` and under chaos_run's
  program;
* ``apply_conf_change`` for every word of the membership tier's standard
  palette and the leave-joint word, on random voter and learner sets.

All comparisons are exact. One JAX round program, two message steps and one
conf-change step are compiled; the round program is the one
tests/test_torch_cluster.py's scenarios run (same config, spec and C).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu.harness.chaos import member_palette
from etcd_tpu.models import confchange as jcc
from etcd_tpu.models import engine as jeng
from etcd_tpu.models import raft as jraft
from etcd_tpu.models.state import NodeState as JNodeState
from etcd_tpu.ops.outbox import empty_outbox as jempty_outbox
from etcd_tpu.types import Msg as JMsg
from etcd_tpu.types import Spec as JSpec
from etcd_tpu.utils.config import RaftConfig as JRaftConfig
from etcd_tpu_torch.convert import from_numpy, node_state_from_numpy, to_numpy
from etcd_tpu_torch.models import confchange as tcc
from etcd_tpu_torch.models import engine as teng
from etcd_tpu_torch.models import raft as traft
from etcd_tpu_torch.ops.outbox import empty_outbox
from etcd_tpu_torch.types import (
    ENTRY_CONF_CHANGE,
    MSG_APP,
    MSG_HEARTBEAT,
    MSG_HUP,
    MSG_PROP,
    MSG_READ_INDEX,
    MSG_SNAP,
    MSG_TIMEOUT_NOW,
    Msg,
    Spec,
)
from etcd_tpu_torch.utils.config import RaftConfig

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

SPEC = Spec(M=5, L=16, E=2, K=2, W=4, R=2, A=2)
CFG = RaftConfig()
C = 16
ROUNDS = 32
FUZZ_C = 256
SEED = 3

torch.set_num_threads(1)


def jspec(spec):
    return JSpec(**dataclasses.asdict(spec))


def jcfg(cfg):
    return JRaftConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def jnp_tree(cls, leaves: dict):
    return cls(**{k: jnp.asarray(v) for k, v in leaves.items()})


def jax_np(tree) -> dict:
    return {k: np.asarray(getattr(tree, k)) for k in tree.__dataclass_fields__}


def diff(a: dict, b: dict) -> list:
    return [k for k in a if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
            or not np.array_equal(a[k], b[k])]


def cc_words(spec) -> list:
    return [int(w) for w in np.asarray(member_palette(jspec(spec), "standard"))] + [
        jcc.encode_leave_joint()]


def round_inputs(rng, spec, C, r):
    """Seeded inputs of round ``r``: ticks, hups, read-index contexts,
    proposals (one entry in ten a conf change), and a keep-mask that drops
    10% of the links, with one member cut off in a quarter of the groups
    during rounds 12-17."""
    M, E = spec.M, spec.E
    words = cc_words(spec)
    tick = rng.random((M, C)) < 0.7
    hup = rng.random((M, C)) < 0.03
    ri = np.where(rng.random((M, C)) < 0.15, rng.integers(1, 40, (M, C)), 0)
    plen = np.where(rng.random((M, C)) < 0.5, rng.integers(1, E + 1, (M, C)), 0)
    pdata = rng.integers(0, 1 << 15, (M, E, C))
    cc = rng.random((M, E, C)) < 0.1
    pdata = np.where(cc, rng.choice(words, (M, E, C)), pdata)
    ptype = np.where(cc, ENTRY_CONF_CHANGE, 0)
    keep = rng.random((M, M, C)) < 0.9
    if 12 <= r < 18:
        cut = np.arange(C) % 4 == 0
        keep[2, :, cut] = False
        keep[:, 2, cut] = False
    i32 = np.int32
    return [plen.astype(i32), pdata.astype(i32), ptype.astype(i32), ri.astype(i32),
            hup, tick, keep]


def boot_config(spec, C, rng):
    """Per-group boot configs: all voters, or four voters and a learner."""
    voters = np.ones((C, spec.M), bool)
    learners = np.zeros((C, spec.M), bool)
    some = rng.random(C) < 0.5
    voters[some, 4] = False
    learners[some, 4] = True
    return voters, learners


@pytest.fixture(scope="module")
def traj():
    """Per round: (jax state, jax wire, port state, port wire) as numpy."""
    rng = np.random.default_rng(SEED)
    voters, learners = boot_config(SPEC, C, rng)
    js_, jc = jspec(SPEC), jcfg(CFG)
    jround = jeng._jitted_round(jc, js_, False)
    tround = teng.build_round(CFG, SPEC)
    jst = jeng.init_fleet(js_, C, jnp.asarray(voters), jnp.asarray(learners), SEED,
                          election_tick=CFG.election_tick)
    jib = jeng.empty_inbox(js_, C)
    tst = teng.init_fleet(SPEC, C, torch.from_numpy(voters), torch.from_numpy(learners),
                          SEED, CFG.election_tick, device="cpu")
    tib = teng.empty_inbox(SPEC, C, device="cpu")
    out = []
    for r in range(ROUNDS):
        args = round_inputs(rng, SPEC, C, r)
        jst, jib = jround(jst, jib, *[jnp.asarray(a) for a in args])
        tst, tib = tround(tst, tib, *[torch.from_numpy(a) for a in args])
        out.append((jax_np(jst), jax_np(jib), to_numpy(tst), to_numpy(tib)))
    return out


@pytest.mark.parametrize("window", range(4))
def test_round_equals_jax_every_round(traj, window):
    n = ROUNDS // 4
    for r in range(window * n, (window + 1) * n):
        js, ji, ts, ti = traj[r]
        assert diff(js, ts) == [], f"round {r}: state leaves differ"
        assert diff(ji, ti) == [], f"round {r}: wire leaves differ"


def test_trajectory_reaches_the_general_round(traj):
    """The seeded run drives what the general round adds: heartbeats,
    read-index traffic, snapshots, transfers' MsgTimeoutNow aside, applied
    conf changes and read states."""
    seen = set()
    for _, ji, _, _ in traj:
        seen |= set(np.unique(ji["type"]).tolist())
    assert {MSG_APP, MSG_HEARTBEAT, MSG_READ_INDEX, MSG_SNAP} <= seen, seen
    last = traj[-1][0]
    assert (last["rs_count"] > 0).any()
    boot_voters = traj[0][0]["voters"]
    assert (last["voters"] != boot_voters).any() or last["voters_out"].any()
    assert (last["role"] == 3).any()


# ---------------------------------------------------------------------------
# process_message for each message type
# ---------------------------------------------------------------------------

def chaos_program():
    from etcd_tpu_torch import chaos_run

    return chaos_run.spec_and_config(chaos_run.read_knobs({}, on_card=False))


# (config, spec): RaftConfig() on the round's spec, and chaos_run's program,
# whose spec differs from SPEC only in E, which shapes messages, not states
FUZZ_CFGS = {"default": (RaftConfig(), SPEC),
             "chaos_run": chaos_program()[::-1]}


def fuzz_states(traj) -> dict:
    """256 node states: the JAX fleet after rounds 16..31, side by side."""
    snaps = [traj[r][0] for r in range(ROUNDS - FUZZ_C // C, ROUNDS)]
    return {k: np.concatenate([s[k] for s in snaps], -1) for k in snaps[0]}


def random_msgs(spec, st: dict, mtype: int, seed: int) -> dict:
    """Per node and column one message of type ``mtype`` (a fifth of the
    slots left empty), its fields drawn near the node's own state so that
    the handlers' branches are reached."""
    rng = np.random.default_rng(seed)
    M, E = spec.M, spec.E
    shape = st["term"].shape
    Cn = shape[-1]

    def near(x, lo, hi):
        return np.maximum(x + rng.integers(lo, hi, shape), 0)

    term = np.where(rng.random(shape) < 0.15, 0, near(st["term"], -1, 2))
    if mtype in (MSG_PROP, MSG_HUP):
        term = np.zeros(shape, int)
    frm = np.where(rng.random(shape) < 0.05, -1, rng.integers(0, M, shape))
    ctx_pool = np.concatenate([st["ro_ctx"], rng.integers(0, 3, (M, 2, Cn))], 1)
    ctx = np.take_along_axis(ctx_pool, rng.integers(0, ctx_pool.shape[1], (M, 1, Cn)),
                             1)[:, 0]
    words = cc_words(spec)
    ent_cc = rng.random((M, E, Cn)) < 0.2
    masks = rng.integers(0, 1 << M, (4,) + shape)
    m = {
        "type": np.where(rng.random(shape) < 0.8, mtype, 0),
        "term": term, "frm": frm,
        "index": near(st["last_index"], -4, 3),
        "log_term": near(st["term"], -2, 1),
        "commit": near(st["commit"], -1, 4),
        "reject": rng.random(shape) < 0.3,
        "reject_hint": near(st["last_index"], -5, 2),
        "context": ctx,
        "ent_len": rng.integers(0, E + 1, shape),
        "ent_term": np.maximum(st["term"][:, None] + rng.integers(-1, 2, (M, E, Cn)), 0),
        "ent_data": np.where(ent_cc, rng.choice(words, (M, E, Cn)),
                             rng.integers(0, 1000, (M, E, Cn))),
        "ent_type": np.where(ent_cc, ENTRY_CONF_CHANGE, 0),
        "c_voters": masks[0], "c_voters_out": masks[1] * (rng.random(shape) < 0.3),
        "c_learners": masks[2] & ~masks[0], "c_learners_next": masks[3] * 0,
    }
    return {k: (v if v.dtype == bool else v.astype(np.int32)) for k, v in m.items()}


def eager_empty_msg(spec):
    """The JAX package caches its message template per spec on first use;
    made inside a trace it would hold a tracer, so make it eagerly."""
    from etcd_tpu.types import empty_msg

    empty_msg(spec)


@pytest.fixture(scope="module")
def fuzz_programs():
    """One jitted JAX process_message per fuzz config, vmapped over nodes
    and columns, with an empty outbox per node."""
    out = {}
    for name, (cfg, spec) in FUZZ_CFGS.items():
        jc, js_ = jcfg(cfg), jspec(spec)
        eager_empty_msg(js_)

        def one(n, m, jc=jc, js_=js_):
            return jraft.process_message(jc, js_, n, jempty_outbox(js_), m)

        out[name] = jax.jit(jax.vmap(jax.vmap(one, in_axes=-1, out_axes=-1)))
    return out


def flat_outbox(spec, ob) -> dict:
    """The port's outbox [N, K, M, (E,) C] in the JAX per-node flat layout
    [N, K*M(*E), C]."""
    out = {f"msgs.{k}": v.reshape(v.shape[0], -1, v.shape[-1])
           for k, v in to_numpy(ob.msgs).items()}
    out["counts"] = ob.counts.numpy()
    out["sent_commit"] = ob.sent_commit.numpy()
    return out


@pytest.mark.parametrize("mtype", range(1, 18))
@pytest.mark.parametrize("cfg_name", sorted(FUZZ_CFGS))
def test_process_message_equals_jax(traj, fuzz_programs, cfg_name, mtype):
    cfg, spec = FUZZ_CFGS[cfg_name]
    st = fuzz_states(traj)
    msgs = random_msgs(spec, st, mtype, seed=1000 * mtype + 7)
    jn, job = fuzz_programs[cfg_name](jnp_tree(JNodeState, st), jnp_tree(JMsg, msgs))
    tn, tob = traft.process_message(
        cfg, spec, node_state_from_numpy(st, "cpu"),
        empty_outbox(spec, st["term"].shape, "cpu"), from_numpy(Msg, msgs, "cpu"))
    jo = {f"msgs.{k}": v for k, v in jax_np(job.msgs).items()}
    jo.update(counts=np.asarray(job.counts), sent_commit=np.asarray(job.sent_commit))
    assert diff(jax_np(jn), to_numpy(tn)) == []
    assert diff(jo, flat_outbox(spec, tob)) == []
    assert (msgs["type"] == mtype).any() and (msgs["type"] == 0).any()


# ---------------------------------------------------------------------------
# apply_conf_change
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cc_program():
    jc, js_ = jcfg(CFG), jspec(SPEC)
    eager_empty_msg(js_)

    def one(n, d, en):
        return jcc.apply_conf_change(jc, js_, n, jempty_outbox(js_), d, en)

    return jax.jit(jax.vmap(jax.vmap(one, in_axes=-1, out_axes=-1)))


def random_configs(st: dict, seed: int) -> dict:
    """The fuzz states with random voter, outgoing-voter, learner and
    staged-learner sets (joint in about half of the columns)."""
    rng = np.random.default_rng(seed)
    M, _, Cn = st["voters"].shape
    kind = rng.integers(0, 5, (M, M, Cn))
    joint = (rng.random(Cn) < 0.5)[None, None]
    st = dict(st)
    st["voters"] = (kind == 1) | (kind == 3)
    st["voters_out"] = ((kind == 3) | (kind == 4)) & joint
    st["learners"] = kind == 2
    st["learners_next"] = (kind == 4) & joint
    st["auto_leave"] = rng.random((M, Cn)) < 0.5
    st["lead_transferee"] = rng.integers(-1, M, (M, Cn)).astype(np.int32)
    return st


def test_encode_equals_jax():
    from etcd_tpu.types import CC_ADD_LEARNER, CC_ADD_NODE, CC_REMOVE_NODE

    for changes in ([], [(CC_ADD_NODE, 3)], [(CC_REMOVE_NODE, 4), (CC_ADD_LEARNER, 2)]):
        for enter in (False, True):
            for auto in (False, True):
                assert tcc.encode(changes, enter, auto) == jcc.encode(changes, enter, auto)
    assert tcc.encode([], leave_joint=True) == jcc.encode_leave_joint()
    assert tcc.encode_leave_joint() == jcc.encode_leave_joint()


@pytest.mark.parametrize("w", range(len(cc_words(SPEC))))
def test_apply_conf_change_equals_jax(traj, cc_program, w):
    word = cc_words(SPEC)[w]
    st = random_configs(fuzz_states(traj), seed=w)
    rng = np.random.default_rng(100 + w)
    data = np.full(st["term"].shape, word, np.int32)
    enable = rng.random(st["term"].shape) < 0.7
    jn, job = cc_program(jnp_tree(JNodeState, st), jnp.asarray(data), jnp.asarray(enable))
    tn, tob = tcc.apply_conf_change(
        CFG, SPEC, node_state_from_numpy(st, "cpu"),
        empty_outbox(SPEC, st["term"].shape, "cpu"), torch.from_numpy(data),
        torch.from_numpy(enable))
    jo = {f"msgs.{k}": v for k, v in jax_np(job.msgs).items()}
    jo.update(counts=np.asarray(job.counts), sent_commit=np.asarray(job.sent_commit))
    assert diff(jax_np(jn), to_numpy(tn)) == []
    assert diff(jo, flat_outbox(SPEC, tob)) == []
    changed = (np.asarray(jn.voters) != st["voters"]).any()
    assert changed or word == jcc.encode_leave_joint()
