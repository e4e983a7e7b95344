"""The port's initial fleets and byte accounting against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu.models import engine as jeng
from etcd_tpu.models.state import NodeState as JNodeState
from etcd_tpu.models.state import init_node as jinit_node
from etcd_tpu.models.state import state_bytes_per_group as jstate_bytes
from etcd_tpu.types import Spec as JSpec
from etcd_tpu_torch import drive
from etcd_tpu_torch.convert import msg_from_numpy, node_state_from_numpy, to_numpy
from etcd_tpu_torch.models import engine as teng
from etcd_tpu_torch.models.state import init_node, state_bytes_per_group

torch.set_num_threads(1)

SPEC = drive.bench_spec()
JSPEC = JSpec(M=5, L=16, E=1, K=2, W=4, R=2, A=2)


def assert_leaves_equal(jtree, tleaves, names):
    for k in names:
        a, b = np.asarray(getattr(jtree, k)), tleaves[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("C", [1, 7, 64])
@pytest.mark.parametrize("seed", [0, 3])
def test_init_fleet_equal(C, seed):
    j = jeng.init_fleet(JSPEC, C, seed=seed)
    t = teng.init_fleet(SPEC, C, seed=seed, device="cpu")
    assert_leaves_equal(j, to_numpy(t), JNodeState.__dataclass_fields__)


def test_init_fleet_config_masks():
    """Per-group voter and learner masks ([C, M]) land on every member."""
    rng = np.random.default_rng(0)
    C = 6
    voters = rng.random((C, SPEC.M)) < 0.7
    learners = ~voters & (rng.random((C, SPEC.M)) < 0.5)
    j = jeng.init_fleet(JSPEC, C, voters=jnp.asarray(voters),
                        learners=jnp.asarray(learners), seed=5)
    t = teng.init_fleet(SPEC, C, voters=torch.from_numpy(voters),
                        learners=torch.from_numpy(learners), seed=5, device="cpu")
    assert_leaves_equal(j, to_numpy(t), JNodeState.__dataclass_fields__)


@pytest.mark.parametrize("c", [2147, 2148, 1_048_575])
def test_init_node_at_wrapped_fleet_seeds(c):
    """The fleet seed c * 1_000_003 wraps in int32 from c = 2148 on; the
    port must draw the same timeouts and keys as the JAX node there."""
    seed = np.int64(c) * 1_000_003
    seed32 = np.int32((seed + 2**31) % 2**32 - 2**31)
    voters = np.ones((SPEC.M,), bool)
    for m in range(SPEC.M):
        j = jinit_node(JSPEC, m, jnp.asarray(voters), seed=jnp.int32(seed32))
        t = init_node(SPEC, torch.full((1, 1), m, dtype=torch.int32),
                      torch.ones((1, SPEC.M, 1), dtype=torch.bool),
                      seed=torch.full((1, 1), int(seed32)))
        tl = {k: v[0, ..., 0] for k, v in to_numpy(t).items()}
        assert_leaves_equal(j, tl, ("randomized_timeout", "rng_key", "nid"))
    # the port's fleet seeds the last group the same way
    if c < 4096:
        fleet = to_numpy(teng.init_fleet(SPEC, c + 1, device="cpu"))
        assert fleet["randomized_timeout"][:, c].tolist() == [
            int(jinit_node(JSPEC, m, jnp.asarray(voters), seed=jnp.int32(seed32)).randomized_timeout)
            for m in range(SPEC.M)]


def test_bytes_per_group_match_the_jax_accounting():
    assert state_bytes_per_group(SPEC) == jstate_bytes(JSPEC)
    for args in ((True, 4), (False, 4), (True, 0), (False, 0)):
        assert teng.inbox_bytes_per_group(SPEC, *args) == \
            jeng.inbox_bytes_per_group(JSPEC, *args), args
    # the resident form the slice runs: dense state + int16 compact wire
    fleet = teng.init_fleet(SPEC, 3, device="cpu")
    held = sum(x.numel() * x.element_size() for _, x in fleet.items())
    assert held == 3 * jstate_bytes(JSPEC)


def test_convert_round_trips_jax_leaves():
    j = jeng.init_fleet(JSPEC, 4, seed=1)
    leaves = {k: np.asarray(getattr(j, k)) for k in JNodeState.__dataclass_fields__}
    t = node_state_from_numpy(leaves, "cpu")
    assert t.rng_key.dtype == torch.int32
    back = to_numpy(t)
    for k, v in leaves.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k
    ji = jeng.empty_inbox(JSPEC, 4, True, 4)
    wl = {k: np.asarray(getattr(ji, k)) for k in ji.__dataclass_fields__}
    ti = to_numpy(msg_from_numpy(wl, "cpu"))
    for k, v in wl.items():
        assert ti[k].dtype == v.dtype and ti[k].shape == v.shape, k
