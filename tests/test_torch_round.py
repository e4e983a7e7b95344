"""The port's slice as a whole against the JAX round, leaf for leaf.

The JAX side runs the FULL settle program (bench.py's accelerator config,
every message class and local step) and then the steady program; the port
runs its restricted settle and steady configurations (etcd_tpu_torch.drive)
on the CPU. After every round the whole fleet state and the int16 compact
wire must be equal, and the JAX wire must carry only the message classes the
port handles, which is what makes the restricted port a sound stand-in for
the full program. The drop case cuts one follower per group in a seeded half
of the groups for two rounds, driving the reject -> probe -> catch-up arms.
Tier-1 reads the JAX rounds from CHAOS_RUN_PIN.npz (tests/
make_chaos_run_pins.py); the slow twin traces the JAX programs live.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from etcd_tpu.models import engine as jeng
from etcd_tpu.models.state import NodeState as JNodeState
from etcd_tpu.types import MSG_APP, MSG_APP_RESP, MSG_PROP
from etcd_tpu.types import Spec as JSpec
from etcd_tpu.utils.config import RaftConfig as JRaftConfig
from etcd_tpu_torch import drive
from etcd_tpu_torch.convert import to_numpy
from etcd_tpu_torch.models import engine as teng

from test_torch_chaos import _pin_arrays
from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

C = 8
STEADY = 16
DROP_ROUNDS, AFTER_DROP = 2, 6
SEED = 0

torch.set_num_threads(1)


def _jax_np(tree, names):
    return {k: np.asarray(getattr(tree, k)) for k in names}


def _diff(a: dict, b: dict) -> list:
    return [k for k in a if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
            or not np.array_equal(a[k], b[k])]


def jax_trajectory() -> list:
    """The JAX side, per round: (phase, the round's inputs, JAX state, JAX
    wire) as numpy; the first row is the fresh fleet, with no inputs."""
    spec_t = drive.bench_spec()
    spec = JSpec(**dataclasses.asdict(spec_t))
    cfg = JRaftConfig(pre_vote=True, check_quorum=True, max_inflight=4,
                      inbox_bound=4, coalesce_commit_refresh=True,
                      wire_int16=True, compact_wire=True)
    steady = dataclasses.replace(
        cfg, local_steps=("prop",),
        message_classes=(MSG_APP, MSG_APP_RESP, MSG_PROP),
        entry_classes=("normal",))
    M, E = spec.M, spec.E
    js = jeng.init_fleet(spec, C, seed=SEED)
    ji = jeng.empty_inbox(spec, C, True, cfg.inbox_bound)
    snames = JNodeState.__dataclass_fields__
    mnames = ji.__dataclass_fields__
    out = [("init", (), _jax_np(js, snames), _jax_np(ji, mnames))]

    def args(keep, hup=None, prop=False):
        z2 = np.zeros((M, C), np.int32)
        zp = np.zeros((M, E, C), np.int32)
        no = np.zeros((M, C), bool)
        plen, pdata = z2.copy(), zp.copy()
        if prop:
            plen[0] = 1
            pdata[0, 0] = 7
        h = no if hup is None else hup
        return (plen, pdata, zp, z2, h, no, keep)

    def run(phase, jstep, a):
        nonlocal js, ji
        js, ji = jstep(js, ji, *a)
        out.append((phase, a, _jax_np(js, snames), _jax_np(ji, mnames)))

    keep = np.ones((M, M, C), bool)
    jfull = jax.jit(jeng.build_round(cfg, spec))
    hup0 = np.zeros((M, C), bool)
    hup0[0] = True
    run("settle", jfull, args(keep, hup=hup0))
    for _ in range(drive.SETTLE_MAX_ROUNDS):
        run("settle", jfull, args(keep))
        if (out[-1][2]["role"] == 3).sum() == C and (out[-1][3]["type"] != 0).sum() == 0:
            break

    jst = jax.jit(jeng.build_round(steady, spec))
    for _ in range(STEADY):
        run("steady", jst, args(keep, prop=True))

    rng = np.random.default_rng(SEED)
    cut = keep.copy()
    for c in np.flatnonzero(rng.random(C) < 0.5):
        f = rng.integers(1, M)
        cut[f, :, c] = False
        cut[:, f, c] = False
    for r in range(DROP_ROUNDS + AFTER_DROP):
        run("drop", jst, args(cut if r < DROP_ROUNDS else keep, prop=True))
    return out


def pin_trajectory(rows) -> dict:
    """The npz arrays that pin jax_trajectory's rows (``round/`` keys)."""
    arrays = {"round/phases": np.array([r[0] for r in rows])}
    for i, (_, a, js, ji) in enumerate(rows):
        arrays.update({f"round/{i}/arg/{j}": x for j, x in enumerate(a)})
        arrays.update({f"round/{i}/state/{k}": v for k, v in js.items()})
        arrays.update({f"round/{i}/wire/{k}": v for k, v in ji.items()})
    return arrays


def pinned_trajectory() -> list:
    """jax_trajectory's rows as tests/make_chaos_run_pins.py pinned them."""
    z = _pin_arrays()
    rows = []
    for i, phase in enumerate(z["round/phases"].tolist()):
        part = lambda what: {k.rsplit("/", 1)[1]: v for k, v in z.items()  # noqa: E731
                             if k.startswith(f"round/{i}/{what}/")}
        a = part("arg")
        rows.append((phase, tuple(a[str(j)] for j in range(len(a))), part("state"),
                     part("wire")))
    return rows


def trajectory(jrows) -> list:
    """Per round: (phase, jax state, jax wire, port state, port wire) as
    numpy dicts, the port's restricted settle and steady programs run on
    the JAX rounds' inputs."""
    spec_t = drive.bench_spec()
    cfg_t = drive.settle_config(spec_t)
    steady_t = drive.steady_config(cfg_t)
    ts = teng.init_fleet(spec_t, C, seed=SEED, device="cpu")
    ti = teng.empty_inbox(spec_t, C, True, cfg_t.inbox_bound, device="cpu")
    steps = {"settle": teng.build_round(cfg_t, spec_t),
             "steady": teng.build_round(steady_t, spec_t)}
    steps["drop"] = steps["steady"]
    out = []
    for phase, a, js, ji in jrows:
        if a:
            ts, ti = steps[phase](ts, ti, *[torch.from_numpy(np.array(x)) for x in a])
        out.append((phase, js, ji, to_numpy(ts), to_numpy(ti)))
    return out


@pytest.fixture(scope="module")
def traj():
    """The trajectory, the JAX side from the pin (CHAOS_RUN_PIN.npz)."""
    return trajectory(pinned_trajectory())


@pytest.mark.slow
def test_state_and_wire_equal_every_round_live():
    for i, (phase, js, ji, ts, ti) in enumerate(trajectory(jax_trajectory())):
        assert _diff(js, ts) == [], f"{phase} round {i}: state leaves differ"
        assert _diff(ji, ti) == [], f"{phase} round {i}: wire leaves differ"


@pytest.mark.parametrize("phase", ["init", "settle", "steady", "drop"])
def test_state_and_wire_equal_every_round(traj, phase):
    rows = [r for r in traj if r[0] == phase]
    assert rows
    for i, (_, js, ji, ts, ti) in enumerate(rows):
        assert _diff(js, ts) == [], f"{phase} round {i}: state leaves differ"
        assert _diff(ji, ti) == [], f"{phase} round {i}: wire leaves differ"


def test_jax_wire_carries_only_ported_classes(traj):
    for phase, _, ji, _, _ in traj:
        types = set(np.unique(ji["type"]).tolist()) - {0}
        assert types <= set(drive.SETTLE_CLASSES), (phase, types)


def test_trajectory_covers_the_slice(traj):
    """The run reaches what it claims to: every group elected, steady
    commits, and the drop case's probe and catch-up."""
    settled = [r for r in traj if r[0] == "settle"][-1][1]
    assert (settled["role"][0] == 3).all()
    seen = set()
    for _, _, ji, _, _ in traj:
        seen |= set(np.unique(ji["type"]).tolist())
    # proposals start at the leader, so MsgProp is never forwarded on the wire
    assert set(drive.SETTLE_CLASSES) - {MSG_PROP} <= seen
    drop = [r[1] for r in traj if r[0] == "drop"]
    assert any((s["pr_state"][0] == 0).any() for s in drop)      # re-probe
    steady_end = [r for r in traj if r[0] == "steady"][-1][1]
    assert steady_end["commit"].min() >= STEADY - 4
    final = drop[-1]
    assert final["commit"].min() > steady_end["commit"].min()


def test_drive_settles_like_the_jax_program(traj):
    """drive.settle_leaders gives the same fleet, in the same number of
    rounds, as the JAX settle loop."""
    spec = drive.bench_spec()
    cfg = drive.settle_config(spec)
    st = teng.init_fleet(spec, C, seed=SEED, device="cpu")
    ib = teng.empty_inbox(spec, C, True, cfg.inbox_bound, device="cpu")
    st, ib, rounds = drive.settle_leaders(cfg, spec, st, ib, device="cpu")
    settle = [r for r in traj if r[0] == "settle"]
    assert rounds == len(settle) - 1
    assert _diff(settle[-1][1], to_numpy(st)) == []


def test_dense_wire_path_matches_compact_path():
    """The dense int32 wire with in-round compaction (compact_wire and
    wire_int16 off, as the JAX package's tests/test_sparse_outbox.py holds
    it against the compact carry) gives the same fleet as the compact
    int16 wire, round for round, and the same messages once compacted."""
    from etcd_tpu_torch.kernels.compact_wire import compact_wire_carry_plain

    spec = drive.bench_spec()
    cfg = drive.settle_config(spec)
    dense = dataclasses.replace(cfg, compact_wire=False, wire_int16=False)
    M, E = spec.M, spec.E
    a = teng.init_fleet(spec, C, seed=SEED, device="cpu")
    b = teng.init_fleet(spec, C, seed=SEED, device="cpu")
    ia = teng.empty_inbox(spec, C, True, cfg.inbox_bound, device="cpu")
    ib = teng.empty_inbox(spec, C, False, 0, device="cpu")
    z2 = torch.zeros((M, C), dtype=torch.int32)
    zp = torch.zeros((M, E, C), dtype=torch.int32)
    no = torch.zeros((M, C), dtype=torch.bool)
    keep = torch.ones((M, M, C), dtype=torch.bool)
    hup = no.clone()
    hup[0] = True
    plen, pdata = z2.clone(), zp.clone()
    plen[0], pdata[0, 0] = 1, 7
    runs = [(cfg, dense, hup, z2, zp)] + [(cfg, dense, no, z2, zp)] * 10 + \
        [(drive.steady_config(cfg), drive.steady_config(dense), no, plen, pdata)] * 6
    for ca, cb, h, pl, pd in runs:
        a, ia = teng.build_round(ca, spec)(a, ia, pl, pd, zp, z2, h, no, keep)
        b, ib = teng.build_round(cb, spec)(b, ib, pl, pd, zp, z2, h, no, keep)
        assert _diff(to_numpy(a), to_numpy(b)) == []
        packed = compact_wire_carry_plain(
            spec, teng._unflatten_inbox(spec, ib), cfg.inbox_bound, torch.int16)
        assert _diff(to_numpy(ia), to_numpy(packed)) == []
    assert (to_numpy(a)["role"][0] == 3).all()
