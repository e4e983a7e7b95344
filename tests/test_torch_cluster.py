"""The port's Cluster against the JAX Cluster, scenario by scenario.

Each scenario script (the rafttest-style scripts of tests/test_raft_scenarios.py,
tests/test_confchange.py and tests/test_replication.py, with a ticking
stabilize cut from 64 rounds to 6, plus a snapshot catch-up) runs on the
port's Cluster; every round it steps is recorded, and the record must equal
the JAX Cluster's on every state and inbox leaf after every step, besides
the script's own assertions holding. The tier-1 cases hold the port to the
JAX Cluster's record in CLUSTER_SCENARIO_PIN.json (a digest of each leaf a
round, the last round's leaves in full; tests/make_cluster_pins.py makes it),
so that they trace no JAX program; their slow twins run both packages live.
The clusters run two groups, which both packages pad to 16 lanes, on the
spec and config of tests/test_torch_general.py, so the JAX program is the
one that test compiles.
"""
import dataclasses
import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from etcd_tpu.harness.cluster import Cluster as JCluster
from etcd_tpu.models import confchange as jcc
from etcd_tpu.types import Spec as JSpec
from etcd_tpu.utils.config import RaftConfig as JRaftConfig
from etcd_tpu_torch.convert import to_numpy
from etcd_tpu_torch.harness.cluster import Cluster as TCluster
from etcd_tpu_torch.models import confchange as tcc
from etcd_tpu_torch.types import (
    CC_ADD_NODE,
    MSG_SNAP,
    MSG_TRANSFER_LEADER,
    NONE_ID,
    PR_SNAPSHOT,
    ROLE_FOLLOWER,
    Spec,
)
from etcd_tpu_torch.utils.config import RaftConfig

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

SPEC = Spec(M=5, L=16, E=2, K=2, W=4, R=2, A=2)
CFG = RaftConfig()
PIN_PATH = pathlib.Path(__file__).resolve().parents[1] / "CLUSTER_SCENARIO_PIN.json"

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


def recorded(cl, log, to_np):
    """Record the state and inbox after every round ``cl`` steps."""
    step = cl.step

    def rec(tick=False):
        step(tick=tick)
        log.append((to_np(cl.eng.state), to_np(cl.eng.inbox)))

    cl.step = rec
    return cl


def both(script, spec=SPEC, cfg=CFG, **kw):
    """Run ``script(cl, cc)`` on a JAX and a port Cluster (``cc`` is the
    package's confchange module) and hold the records equal step by step.
    Returns the port cluster's record."""
    jlog, tlog = [], []
    jcl = recorded(JCluster(spec=jspec(spec), cfg=jcfg(cfg), **kw), jlog, jax_np)
    script(jcl, jcc)
    tcl = recorded(TCluster(spec=spec, cfg=cfg, device="cpu", **kw), tlog, to_numpy)
    script(tcl, tcc)
    assert len(jlog) == len(tlog), (len(jlog), len(tlog))
    for i, ((js, ji), (ts, ti)) in enumerate(zip(jlog, tlog)):
        assert diff(js, ts) == [], f"step {i}: state leaves differ"
        assert diff(ji, ti) == [], f"step {i}: inbox leaves differ"
    return tlog


def leaf_digest(a: np.ndarray) -> str:
    """A leaf's dtype, shape and bytes, hashed (16 hex digits)."""
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def pin_record(log) -> dict:
    """A scenario's record for the pin: each round's leaf digests, the last
    round's leaves in full."""
    st, ib = log[-1]
    full = {k: {"dtype": v.dtype.str, "value": v.tolist()} for k, v in st.items()}
    return {"rounds": [[{k: leaf_digest(v) for k, v in part.items()} for part in rnd]
                       for rnd in log],
            "final": {"state": full,
                      "inbox": {k: {"dtype": v.dtype.str, "value": v.tolist()}
                                for k, v in ib.items()}}}


def held_to_pin(name, log) -> None:
    """The port's record ``log`` against the pin's, naming the first round
    and leaf that differ."""
    want = json.loads(PIN_PATH.read_text())["scenarios"][name]
    for i, (rnd, w) in enumerate(zip(log, want["rounds"])):
        for part, wpart, what in zip(rnd, w, ("state", "inbox")):
            bad = [k for k in wpart if leaf_digest(part[k]) != wpart[k]]
            assert not bad and set(part) == set(wpart), \
                f"round {i}: {what} leaves differ from the JAX Cluster's: {bad}"
    assert len(log) == len(want["rounds"]), (len(log), len(want["rounds"]))
    for part, what in zip(log[-1], ("state", "inbox")):
        for k, v in want["final"][what].items():
            assert np.array_equal(part[k], np.array(v["value"], dtype=v["dtype"])), (what, k)


# a ticking stabilize never drains (heartbeats every round): the JAX scripts
# run 64 rounds of it; these run enough for the heartbeats to carry the news
TICKED = 6


def elect(cl, m=0):
    cl.campaign(m)
    cl.stabilize()
    assert cl.leader() == m


def transfer_to_lagging_follower(cl, cc):
    elect(cl, 0)
    cl.isolate(2)
    for d in (5, 6, 7):
        cl.propose(0, d)
        cl.stabilize()
    assert cl.get("match", 0)[2] < cl.get("last_index", 0)
    cl.recover()
    # the leader first catches 2 up, then sends MsgTimeoutNow
    cl.inject(to=0, frm=2, type=MSG_TRANSFER_LEADER, term=cl.get("term", 0))
    cl.stabilize()
    assert cl.leader() == 2
    assert cl.get("last_index", 2) >= 4


def stale_leader_steps_down_after_heal(cl, cc):
    elect(cl, 0)
    cl.partition([[0, 1], [2, 3, 4]])
    cl.campaign(2)
    cl.stabilize()
    assert 2 in cl.leaders()
    cl.recover()
    cl.propose(2, 9)
    cl.stabilize(max_rounds=TICKED, tick=True)
    cl.stabilize(max_rounds=TICKED, tick=True)
    cl.stabilize()
    assert cl.leaders() == [2]
    assert cl.get("role", 0) == ROLE_FOLLOWER
    assert min(cl.commits()) == max(cl.commits())


def joint_two_changes_auto_leave(cl, cc):
    cl.campaign(0)
    cl.stabilize()
    cl.propose_conf_change(0, cc.encode([(CC_ADD_NODE, 3), (CC_ADD_NODE, 4)],
                                        auto_leave=True))
    cl.stabilize()
    cl.stabilize(max_rounds=TICKED, tick=True)
    cl.stabilize(max_rounds=TICKED, tick=True)
    for m in range(5):
        assert list(cl.get("voters", m)) == [True] * 5, m
        assert list(cl.get("voters_out", m)) == [False] * 5, m
    cl.propose(0, 9)
    cl.stabilize()
    assert min(cl.commits()) == max(cl.commits())


def tick_based_election_fires(cl, cc):
    for _ in range(60):
        cl.step(tick=True)
        if cl.leader() != NONE_ID:
            break
    assert cl.leader() != NONE_ID
    assert len(cl.leaders()) == 1


def snapshot_catch_up(cl, cc):
    """Isolate follower 4 while the leader appends past its ring (L = 16),
    so the leader compacts beyond 4's log; after the heal the leader sends
    MsgSnap and 4 restores from it."""
    elect(cl, 0)
    cl.isolate(4)
    for i in range(12):
        cl.propose(0, 100 + i)
        cl.propose(0, 200 + i)
        cl.stabilize()
    assert cl.get("snap_index", 0) > cl.get("last_index", 4)
    cl.recover()
    for _ in range(3):
        cl.step(tick=True)
    cl.stabilize()
    assert cl.get("snap_index", 4) > 0
    assert cl.get("commit", 4) == cl.get("commit", 0)
    assert cl.get("applied_hash", 4) == cl.get("applied_hash", 0)


SCRIPTS = {
    "transfer_to_lagging_follower_waits_for_catchup": transfer_to_lagging_follower,
    "stale_leader_steps_down_after_heal": stale_leader_steps_down_after_heal,
    "joint_two_changes_auto_leave": joint_two_changes_auto_leave,
    "tick_based_election_fires": tick_based_election_fires,
    "snapshot_catch_up": snapshot_catch_up,
}
VOTERS = {"joint_two_changes_auto_leave": [True, True, True, False, False]}


def check_snapshot_path(name, log) -> None:
    if name == "snapshot_catch_up":
        assert any((ib["type"] == MSG_SNAP).any() for _, ib in log)
        assert any((st["pr_state"][0, 4] == PR_SNAPSHOT).any() for st, _ in log)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scenario_equals_jax(name):
    log = []
    tcl = recorded(TCluster(spec=SPEC, cfg=CFG, device="cpu", n_members=5, C=2,
                            voters=VOTERS.get(name)), log, to_numpy)
    SCRIPTS[name](tcl, tcc)
    held_to_pin(name, log)
    check_snapshot_path(name, log)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scenario_equals_jax_live(name):
    log = both(SCRIPTS[name], n_members=5, C=2, voters=VOTERS.get(name))
    check_snapshot_path(name, log)


@pytest.mark.slow
def test_read_index_lease_based_equals_jax():
    """tests/test_raft_scenarios.py's lease-based read, on its own 3-member
    single-group config (a JAX program of its own: slow)."""
    cfg = RaftConfig(check_quorum=True, read_only_lease_based=True)

    def script(cl, cc):
        elect(cl, 0)
        cl.propose(0, 5)
        cl.stabilize()
        commit = cl.get("commit", 0)
        ctx = cl.read_index(0)
        cl.step()               # answered locally, no heartbeat round
        assert cl.get("rs_count", 0) >= 1
        assert cl.get("rs_ctx", 0)[0] == ctx and cl.get("rs_index", 0)[0] == commit

    both(script, spec=Spec(M=3), cfg=cfg, n_members=3)


def test_cluster_refuses_the_planes_not_ported():
    """The planes are ported; what a Cluster refuses now is a plane over the
    packed storage form, as the JAX Cluster does."""
    packed = dataclasses.replace(RaftConfig(), packed_state=True)
    for plane in ("telemetry", "blackbox"):
        with pytest.raises(ValueError, match=f"Cluster {plane} reads the unpacked"):
            TCluster(3, cfg=packed, device="cpu", **{plane: True})
        assert getattr(TCluster(3, device="cpu", **{plane: True}),
                       "tele" if plane == "telemetry" else "bb") is not None


def test_cluster_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default does not raise here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TCluster(3)
