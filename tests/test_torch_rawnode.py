"""The port's RawNode (etcd_tpu_torch/models/rawnode.py) against the JAX
package's.

Tier-1 holds the Ready sequences of tests/test_rawnode.py,
tests/test_flow_control.py and tests/test_wait_mock.py:63
(etcd_tpu_torch/harness/rawnode_session.py, each at its JAX test's spec) to the JAX
package's records in RAWNODE_PIN.json: every Ready, every asserted value and
error, and each lane's leaves at the end, exactly. It also holds
host_to_device_msg and outbox_to_host to the JAX functions on seeded
messages (eager jnp, no jit), the lane layout to the pin's leaves, and
the lane functions' sharing. The slow twin runs the JAX package live.
"""
import dataclasses
import json
import random

import numpy as np
import pytest
import torch

from etcd_tpu_torch.harness import rawnode_session as S
from etcd_tpu_torch.models import rawnode as trn
from etcd_tpu_torch.ops.outbox import Outbox as TOutbox
from etcd_tpu_torch.storage import raftstorage as trs
from etcd_tpu_torch.types import ENT_FIELDS, Msg as TMsg, Spec

from make_rawnode_pins import jax_package
from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

torch.set_num_threads(1)

PIN = json.loads(S.PIN.read_text())


def jsonable(x):
    return json.loads(json.dumps(x))


@pytest.mark.parametrize("name", sorted(S.RAWNODE_SCRIPTS))
def test_ready_sequence_equals_pin(name):
    got = jsonable(S.run_rawnode(S.port_package("cpu"), name))
    want = PIN["rawnode"][name]
    first = next((i for i, (g, w) in enumerate(zip(got, want)) if g != w), None)
    assert first is None and len(got) == len(want), \
        f"line {first}: got {got[first] if first is not None else len(got)}, " \
        f"want {want[first] if first is not None else len(want)}"


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(S.RAWNODE_SCRIPTS))
def test_ready_sequence_equals_jax_live(name):
    want = jsonable(S.run_rawnode(jax_package(), name))
    assert jsonable(S.run_rawnode(S.port_package("cpu"), name)) == want


def seeded_host_msgs(seed, spec, rs, rn):
    """Messages of every field, some with entries up to E (and past it) or a
    snapshot with a hash that needs all 32 bits, from ``seed``."""
    rng = random.Random(seed)
    out = []
    for _ in range(12):
        ents = tuple(rs.Entry(index=0, term=rng.randrange(5), type=rng.randrange(3),
                              data=rng.randrange(-2**31, 2**31))
                     for _ in range(rng.randrange(spec.E + 2)))
        snap = None
        if rng.random() < 0.3:
            ids = lambda: tuple(sorted(rng.sample(range(spec.M), rng.randrange(spec.M + 1))))  # noqa: E731
            snap = rs.Snapshot(meta=rs.SnapshotMeta(
                index=rng.randrange(100), term=rng.randrange(9),
                conf_state=rs.ConfState(ids(), ids(), ids(), ids(), rng.random() < 0.5),
                app_hash=rng.randrange(-2**31, 2**31)))
        out.append(rn.HostMsg(
            type=rng.randrange(18), to=rng.randrange(spec.M), frm=rng.randrange(-1, spec.M),
            term=rng.randrange(9), index=rng.randrange(60), log_term=rng.randrange(9),
            commit=rng.randrange(60), reject=rng.random() < 0.5,
            reject_hint=rng.randrange(60), context=rng.randrange(2**20),
            entries=ents, snapshot=snap))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_host_to_device_msg_equals_jax(seed):
    from etcd_tpu.models import rawnode as jrn
    from etcd_tpu.storage import raftstorage as jrs
    from etcd_tpu.types import Spec as JSpec

    spec = Spec(M=5, L=16, E=3, K=2, W=4, R=2, A=2)
    jspec = JSpec(**dataclasses.asdict(spec))
    for jm, tm in zip(seeded_host_msgs(seed, jspec, jrs, jrn),
                      seeded_host_msgs(seed, spec, trs, trn)):
        j = jrn.host_to_device_msg(jspec, jm)
        t = trn.host_to_device_msg(spec, tm, device="cpu")
        for k in TMsg.names():
            a = np.asarray(getattr(j, k))
            b = getattr(t, k).numpy()
            b = b[0, :, 0] if k in ENT_FIELDS else b[0, 0]
            assert a.dtype == b.dtype and np.array_equal(a, b), (k, a, b)


@pytest.mark.parametrize("seed", range(3))
def test_outbox_to_host_equals_jax(seed):
    import jax.numpy as jnp

    from etcd_tpu.models import rawnode as jrn
    from etcd_tpu.ops.outbox import Outbox as JOutbox
    from etcd_tpu.types import Msg as JMsg, Spec as JSpec

    spec = Spec(M=4, L=16, E=3, K=3, W=4, R=2, A=2)
    K, M, E = spec.K, spec.M, spec.E
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, K + 1, M).astype(np.int32)
    f = {}
    for k in TMsg.names():
        shape = (K, M, E) if k in ENT_FIELDS else (K, M)
        f[k] = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    f["type"] = rng.integers(0, 18, (K, M)).astype(np.int32)
    f["type"][0, 0] = 5                                        # a MsgSnap
    f["ent_len"] = rng.integers(0, E + 1, (K, M)).astype(np.int32)
    f["frm"] = rng.integers(-1, M, (K, M)).astype(np.int32)
    f["reject"] = rng.random((K, M)) < 0.5
    f["index"] = rng.integers(0, 50, (K, M)).astype(np.int32)
    jmsgs = JMsg(**{k: jnp.asarray(v.reshape(-1)) for k, v in f.items()})
    jz = jnp.zeros((M,), jnp.int32)
    jout = jrn.outbox_to_host(JSpec(**dataclasses.asdict(spec)),
                              JOutbox(msgs=jmsgs, counts=jnp.asarray(counts),
                                      sent_commit=jz, pend=None))
    tmsgs = TMsg(**{k: torch.from_numpy(v[None, ..., None].copy()) for k, v in f.items()})
    tout = trn.outbox_to_host(spec, TOutbox(
        msgs=tmsgs, counts=torch.from_numpy(counts[None, :, None].copy()),
        sent_commit=torch.zeros((1, M, 1), dtype=torch.int32)))
    assert [S.v_msg(m) for m in jout] == [S.v_msg(m) for m in tout] and tout


def test_lane_layout_and_convert_hold_the_pins_lanes():
    """Every lane the pin recorded (the JAX package's NodeState leaves at the
    end of each rawnode script) goes into a host Lane, through the device
    NodeState (unflatten_lane, flatten_lane) and back out of Lane.to_numpy
    unchanged, leaf for leaf and dtype for dtype, at each script's spec."""
    specs = {"rn": S.RAWNODE_SPEC, "fc": S.FLOW_SPEC, "mock": S.MOCK_SPEC}
    n = 0
    for name, log in PIN["rawnode"].items():
        spec = Spec(**specs[name.split("_")[0]])
        width = trn.lane_layout(spec)[1]
        for leaves in log[-1][1]:
            want = {k: np.asarray(v) for k, v in leaves.items()}
            want = {k: v if v.dtype == bool else v.astype(np.int32) for k, v in want.items()}
            want["rng_key"] = want["rng_key"].astype(np.uint32)
            lane = trn.Lane(spec, np.zeros((width,), np.int32)).replace(**want)
            state = trn.unflatten_lane(spec, torch.from_numpy(lane.w))
            host = trn.Lane(spec, trn.flatten_lane(state).numpy()).to_numpy()
            assert sorted(host) == sorted(want) == sorted(state.names()), name
            for k, v in want.items():
                assert np.array_equal(host[k], v) and host[k].dtype == v.dtype, (name, k)
                assert tuple(getattr(state, k).shape) == (1, *v.shape, 1), (name, k)
            n += 1
    assert n >= len(PIN["rawnode"])


def test_lane_functions_are_shared_per_config():
    """One lane function per (cfg, spec, device, graph, kind), over the cfg
    as given (every message type handled, as the JAX package's kernels),
    run by every RawNode of that config; eager_lanes() sets and restores
    the switch that turns a card's graph replays off."""
    spec, cfg = Spec(**S.FLOW_SPEC), S.port_package("cpu").RaftConfig(**S.FLOW_CFG)
    dev = torch.device("cpu")
    a = trn.lane_function(cfg, spec, dev, False, "step")
    assert a is trn.lane_function(cfg, spec, dev, False, "step")
    assert a is not trn.lane_function(cfg, spec, dev, False, "tick")
    assert a.cfg == cfg and a.graph is None
    calls = a.calls
    for _ in range(2):
        trn.RawNode(cfg, spec, trs.MemoryStorage(), 0, device="cpu").campaign()
    assert a.calls == calls + 2
    assert not trn._EAGER_LANES
    with trn.eager_lanes():
        assert trn._EAGER_LANES
    assert not trn._EAGER_LANES
