"""The port's packed fleet storage and fleet chunking against the JAX
package.

pack_fleet, unpack_fleet and unpack_field run in both packages on the same
fleets: a fresh fleet, a fleet the port settled, one after steady and drop
rounds, and a fleet of seeded random values over each field's whole range
(timers past their cap included, which saturate). The packed leaves must be
equal (the JAX uint32 bit lanes against the port's int32 bit patterns), and
unpack(pack(x)) must give back every in-range value. Then the footprint,
the packed program under fleet_chunks = 2, and the timer-lane check.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu.models import state as jstate
from etcd_tpu.types import Spec as JSpec
from etcd_tpu_torch import drive
from etcd_tpu_torch.convert import (
    UINT32_LEAVES,
    from_numpy,
    node_state_from_numpy,
    to_numpy,
)
from etcd_tpu_torch.models import engine as teng
from etcd_tpu_torch.models import state as tstate
from etcd_tpu_torch.models.state import (
    NodeState,
    PackedFleet,
    pack_fleet,
    pack_plan,
    unpack_fleet,
)

C = 16
SEED = 0

torch.set_num_threads(1)


def jax_nodes(leaves: dict):
    return jstate.NodeState(**{k: jnp.asarray(v) for k, v in leaves.items()})


def jax_np(tree) -> dict:
    return {k: np.asarray(getattr(tree, k)) for k in tree.__dataclass_fields__}


def diff(a: dict, b: dict) -> list:
    return [k for k in a if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
            or not np.array_equal(a[k], b[k])]


def random_fleet(spec, seed):
    """Seeded values over each packed field's range: bit fields over their
    lane width (less the id bias), elapsed timers up to twice their cap,
    index fields over int16, hashes and payloads over int32, any key."""
    rng = np.random.default_rng(seed)
    base = to_numpy(teng.init_fleet(spec, C, seed=seed, device="cpu"))
    bit_rows, _, narrow_rows, _, wide_rows, _ = pack_plan(spec)
    out = {}
    for name, bits, bias, _ in bit_rows:
        shape, dtype = base[name].shape, base[name].dtype
        if dtype == bool:
            out[name] = rng.random(shape) < 0.5
        else:
            hi = (1 << bits) * (2 if name in tstate._PACK_SATURATING else 1)
            out[name] = (rng.integers(0, hi, shape) - bias).astype(np.int32)
    for name, _, _ in narrow_rows:
        out[name] = rng.integers(-2**15, 2**15, base[name].shape).astype(np.int32)
    for name, _, _ in wide_rows:
        out[name] = rng.integers(-2**31, 2**31, base[name].shape).astype(np.int32)
    out["rng_key"] = rng.integers(0, 2**32, base["rng_key"].shape).astype(np.uint32)
    return out


@pytest.fixture(scope="module")
def fleets():
    """name -> dense fleet leaves (numpy)."""
    spec = drive.bench_spec()
    cfg = drive.settle_config(spec)
    st = teng.init_fleet(spec, C, seed=SEED, device="cpu")
    out = {"fresh": to_numpy(st)}
    ib = teng.empty_inbox(spec, C, True, cfg.inbox_bound, device="cpu")
    st, ib, _ = drive.settle_leaders(cfg, spec, st, ib, device="cpu")
    out["settled"] = to_numpy(st)
    keep = torch.ones((spec.M, spec.M, C), dtype=torch.bool)
    keep[2, :, ::2] = False
    keep[:, 2, ::2] = False
    st, ib = drive.steady_rounds(drive.steady_config(cfg), spec, st, ib, 6, keep)
    st, ib = drive.steady_rounds(drive.steady_config(cfg), spec, st, ib, 3)
    out["dropped"] = to_numpy(st)
    out["random"] = random_fleet(spec, SEED)
    return spec, out


KINDS = ("fresh", "settled", "dropped", "random")


@pytest.mark.parametrize("kind", KINDS)
def test_pack_fleet_equals_jax(fleets, kind):
    spec, f = fleets
    jp = jstate.pack_fleet(JSpec(**dataclasses.asdict(spec)), jax_nodes(f[kind]))
    tp = pack_fleet(spec, node_state_from_numpy(f[kind], "cpu"))
    assert diff(jax_np(jp), to_numpy(tp)) == []


@pytest.mark.parametrize("kind", KINDS)
def test_unpack_fleet_equals_jax_and_inverts_pack(fleets, kind):
    spec, f = fleets
    jspec = JSpec(**dataclasses.asdict(spec))
    jp = jstate.pack_fleet(jspec, jax_nodes(f[kind]))
    want = jax_np(jstate.unpack_fleet(jspec, jp))
    got = to_numpy(unpack_fleet(spec, from_numpy(PackedFleet, jax_np(jp), "cpu")))
    assert diff(want, got) == []
    # the identity on in-range values: every leaf but the saturated timers
    # of the random fleet comes back as it went in
    back = to_numpy(unpack_fleet(spec, pack_fleet(spec, node_state_from_numpy(f[kind], "cpu"))))
    bad = diff(f[kind], back)
    if kind == "random":
        assert set(bad) <= set(tstate._PACK_SATURATING)
        for name in bad:
            cap = (1 << tstate.PACK_TIMER_BITS) - 1
            assert np.array_equal(back[name], np.minimum(f[kind][name], cap))
    else:
        assert bad == []


@pytest.mark.parametrize("name", NodeState.names())
def test_unpack_field_equals_jax(fleets, name):
    spec, f = fleets
    jspec = JSpec(**dataclasses.asdict(spec))
    jp = jstate.pack_fleet(jspec, jax_nodes(f["random"]))
    want = np.asarray(jstate.unpack_field(jspec, jp, name))
    got = tstate.unpack_field(spec, from_numpy(PackedFleet, jax_np(jp), "cpu"), name).numpy()
    if name in UINT32_LEAVES:
        got = got.view(np.uint32)
    assert want.dtype == got.dtype and np.array_equal(want, got)


def test_pack_plan_and_bytes_per_group_equal_jax():
    spec = drive.bench_spec()
    jspec = JSpec(**dataclasses.asdict(spec))
    jplan = jstate.pack_plan(jspec)
    assert pack_plan(spec) == (tuple(jplan[0]),) + tuple(jplan[1:])
    for packed in (False, True):
        assert tstate.state_bytes_per_group(spec, packed=packed) == \
            jstate.state_bytes_per_group(jspec, packed=packed)
    # bench.py's geometry: 1,230 B of packed state + 660 B of compact int16
    # wire = 1,890 B/group, against 4,710 B/group dense
    assert tstate.state_bytes_per_group(spec, packed=True) == 1230
    assert tstate.state_bytes_per_group(spec, packed=True) + \
        teng.inbox_bytes_per_group(spec, True, spec.M - 1) == 1890
    assert tstate.state_bytes_per_group(spec) + \
        teng.inbox_bytes_per_group(spec, True) == 4710


def test_fleet_chunks_two_equals_one(fleets):
    """The packed steady program and the dense settle program, each with
    fleet_chunks = 2, give the fleets and wires of fleet_chunks = 1, and
    the same drop count; the chunked round writes into the leaves it was
    given, so no second fleet is allocated."""
    spec, f = fleets
    cfg = drive.settle_config(spec)
    diet = dataclasses.replace(drive.steady_config(cfg), deferred_emit=True,
                               sparse_outbox=True, packed_state=True)
    keep = torch.ones((spec.M, spec.M, C), dtype=torch.bool)
    keep[3, :, 1::3] = False
    args = drive.steady_inputs(spec, C, "cpu")[:-1]
    st = node_state_from_numpy(f["settled"], "cpu")
    ib = teng.empty_inbox(spec, C, True, cfg.inbox_bound, device="cpu")
    for c, state in ((diet, pack_fleet(spec, st)), (cfg, teng.init_fleet(spec, C, device="cpu"))):
        one = teng.build_round(c, spec, with_drop_count=True)
        two = teng.build_round(dataclasses.replace(c, fleet_chunks=2), spec,
                               with_drop_count=True)
        # fleet_chunks > 1 writes its results into the fleet it is given
        a, b = (state, ib), tuple(t.map(lambda _, x: x.clone()) for t in (state, ib))
        for r in range(6):
            k = keep if r in (1, 2) else torch.ones_like(keep)
            hup = torch.zeros_like(args[4])
            if c is cfg and r == 0:
                hup[0] = True
            rnd = (args[0], args[1], args[2], args[3], hup, args[5], k) \
                if c is cfg else args + (k,)
            *a, da = one(*a, *rnd)
            ptrs = [x.data_ptr() for t in b for _, x in t.items()]
            *b, db = two(*b, *rnd)
            assert [x.data_ptr() for t in b for _, x in t.items()] == ptrs
            for x, y in zip(a, b):
                assert diff(to_numpy(x), to_numpy(y)) == [], (c.packed_state, r)
            assert int(da) == int(db)


def test_packed_timer_lane_check():
    spec = drive.bench_spec()
    cfg = dataclasses.replace(drive.steady_config(drive.settle_config(spec)),
                              packed_state=True, election_tick=512)
    with pytest.raises(ValueError, match="timer lanes"):
        teng.build_round(cfg, spec)
