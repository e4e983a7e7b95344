"""The port's deferred emission, sparse outbox and packed state against the
JAX program, leaf for leaf.

bench.py's steady program (``deferred_emit`` + ``sparse_outbox`` +
``packed_state`` over the int16 compact wire) runs in both packages from
one fleet that the port settled (tests/test_torch_round.py holds settling
against JAX), through 10 steady rounds and a drop case that cuts one
follower in a seeded half of the groups for two rounds, driving the
reject -> probe -> catch-up arms. Every packed state leaf and wire leaf must
be equal after every round; all leaves are integers or bools, so there is
no tolerance. The port's deferred forms also equal its immediate form on
steady traffic, as tests/test_deferred_emit.py and
tests/test_sparse_outbox.py hold for the JAX package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu.models import engine as jeng
from etcd_tpu.models.state import NodeState as JNodeState
from etcd_tpu.models.state import pack_fleet as jpack
from etcd_tpu.ops import outbox as joutbox
from etcd_tpu.types import Msg as JMsg
from etcd_tpu.types import Spec as JSpec
from etcd_tpu.utils.config import RaftConfig as JRaftConfig
from etcd_tpu_torch import drive
from etcd_tpu_torch.convert import from_numpy, to_numpy
from etcd_tpu_torch.models import engine as teng
from etcd_tpu_torch.models.state import PackedFleet, pack_fleet, unpack_fleet
from etcd_tpu_torch.ops import outbox as toutbox
from etcd_tpu_torch.types import PR_PROBE, PR_SNAPSHOT

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

C = 8
STEADY, DROP_ROUNDS, AFTER_DROP = 16, 2, 6
SEED = 0

torch.set_num_threads(1)


def diet_config(cfg):
    """bench.py's steady program at its accelerator defaults."""
    return dataclasses.replace(drive.steady_config(cfg), deferred_emit=True,
                               sparse_outbox=True, packed_state=True)


def jax_config(cfg):
    return JRaftConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})


def jax_tree(cls, leaves: dict):
    return cls(**{k: jnp.asarray(v) for k, v in leaves.items()})


def jax_np(tree) -> dict:
    return {k: np.asarray(getattr(tree, k)) for k in tree.__dataclass_fields__}


def diff(a: dict, b: dict) -> list:
    return [k for k in a if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
            or not np.array_equal(a[k], b[k])]


@pytest.fixture(scope="module")
def settled():
    spec = drive.bench_spec()
    cfg = drive.settle_config(spec)
    st = teng.init_fleet(spec, C, seed=SEED, device="cpu")
    ib = teng.empty_inbox(spec, C, True, cfg.inbox_bound, device="cpu")
    st, ib, _ = drive.settle_leaders(cfg, spec, st, ib, device="cpu")
    return spec, cfg, st, ib


def drop_mask(spec):
    rng = np.random.default_rng(SEED)
    keep = np.ones((spec.M, spec.M, C), bool)
    for c in np.flatnonzero(rng.random(C) < 0.5):
        f = rng.integers(1, spec.M)
        keep[f, :, c] = False
        keep[:, f, c] = False
    return keep


def schedule(spec):
    """(phase, keep-mask) per round: steady, then the drop case."""
    keep = np.ones((spec.M, spec.M, C), bool)
    cut = drop_mask(spec)
    return [("steady", keep)] * STEADY + \
        [("drop", cut if r < DROP_ROUNDS else keep)
         for r in range(DROP_ROUNDS + AFTER_DROP)]


@pytest.fixture(scope="module")
def traj(settled):
    """Per round: (phase, jax packed state, jax wire, port packed state,
    port wire) as numpy dicts."""
    spec, cfg, st, ib = settled
    diet = diet_config(cfg)
    jspec = JSpec(**dataclasses.asdict(spec))
    # the JAX package caches its empty message at first use: make that use
    # eager, or a jit trace would leave its tracers in the cache
    jeng.empty_inbox(jspec, 1)
    jround = jax.jit(jeng.build_round(jax_config(diet), jspec))
    tround = teng.build_round(diet, spec)
    js = jpack(jspec, jax_tree(JNodeState, to_numpy(st)))
    ji = jax_tree(JMsg, to_numpy(ib))
    ts, ti = pack_fleet(spec, st), ib
    args = [torch.from_numpy(x) for x in drive_inputs(spec)]
    out = []
    for phase, keep in schedule(spec):
        a = args[:-1] + [torch.from_numpy(keep)]
        js, ji = jround(js, ji, *[x.numpy() for x in a])
        ts, ti = tround(ts, ti, *a)
        out.append((phase, jax_np(js), jax_np(ji), to_numpy(ts), to_numpy(ti)))
    return out


def drive_inputs(spec):
    return [x.numpy() for x in drive.steady_inputs(spec, C, "cpu")]


@pytest.mark.parametrize("phase", ["steady", "drop"])
def test_packed_deferred_sparse_round_equals_jax_every_round(traj, phase):
    rows = [r for r in traj if r[0] == phase]
    assert rows
    for i, (_, js, ji, ts, ti) in enumerate(rows):
        assert diff(js, ts) == [], f"{phase} round {i}: packed state leaves differ"
        assert diff(ji, ti) == [], f"{phase} round {i}: wire leaves differ"


def test_trajectory_replicates_and_reprobes(traj, settled):
    """The run reaches what it claims to: one commit per round in the steady
    phase, and a leader re-probing a cut follower in the drop case."""
    spec = settled[0]

    def dense(row):
        return unpack_fleet(spec, from_numpy(PackedFleet, row[3], "cpu"))

    steady = [dense(r) for r in traj if r[0] == "steady"]
    c0 = int(settled[2].commit.min())
    assert int(steady[-1].commit.min()) - c0 >= STEADY - 4
    drop = [dense(r) for r in traj if r[0] == "drop"]
    assert any(bool((s.pr_state[0] == PR_PROBE).any()) for s in drop)
    # the catch-up stays within the ring: no leader falls back to MsgSnap
    assert not any(bool((s.pr_state == PR_SNAPSHOT).any()) for s in steady + drop)
    assert int(drop[-1].commit.min()) > int(steady[-1].commit.min())


def test_deferred_and_sparse_forms_equal_immediate_on_steady_traffic(settled):
    spec, cfg, st, ib = settled
    imm = drive.steady_config(cfg)
    forms = {
        "immediate": imm,
        "deferred": dataclasses.replace(imm, deferred_emit=True),
        "sparse": dataclasses.replace(imm, deferred_emit=True, sparse_outbox=True),
    }
    rounds = {k: teng.build_round(c, spec) for k, c in forms.items()}
    carry = {k: (st, ib) for k in forms}
    args = drive.steady_inputs(spec, C, "cpu")
    for r in range(STEADY):
        for k in forms:
            carry[k] = rounds[k](*carry[k], *args)
        ref = [to_numpy(x) for x in carry["immediate"]]
        for k in ("deferred", "sparse"):
            got = [to_numpy(x) for x in carry[k]]
            assert diff(ref[0], got[0]) == [], f"{k} round {r}: state differs"
            assert diff(ref[1], got[1]) == [], f"{k} round {r}: wire differs"
    assert int(carry["sparse"][0].commit.min()) - int(st.commit.min()) >= STEADY - 4


def test_pending_wire_is_the_jax_accumulator_batched():
    """PendingWire has the JAX fields, each batched to [N, M, (E,) C], and an
    empty deferred outbox holds no intents."""
    spec = drive.bench_spec()
    jp = joutbox.empty_pending(JSpec(**dataclasses.asdict(spec)))
    ob = toutbox.empty_outbox(spec, (3, C), "cpu", deferred=True)
    assert toutbox.PendingWire.names() == tuple(jp.__dataclass_fields__)
    for name, x in ob.pend.items():
        j = np.asarray(getattr(jp, name))
        assert x.shape == (3,) + j.shape + (C,), name
        assert str(x.dtype) == f"torch.{j.dtype}", name
        assert not bool(x.any()), name
    assert toutbox.empty_outbox(spec, (3, C), "cpu").pend is None
