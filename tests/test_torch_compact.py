"""The plain inbox compaction against its three JAX forms.

``compact_wire_carry_plain`` (what the CUDA kernel is held against on the
card) must equal the JAX engine's ``compact_wire_carry``, the per-node
``raft.compact_inbox`` vmapped over receivers and clusters, and the Pallas
kernel ``experiments/pallas_compact.py`` run in interpret mode. Cases cover
all-empty columns, more nonempty slots than the bound (drops), a bound at or
past the slot count, set ``reject`` flags and two entry lanes. Dropped slots
keep their other fields, as the keep-mask leaves them, so a leak would show.
"""
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from etcd_tpu.models import engine as jeng
from etcd_tpu.models import raft as jraft
from etcd_tpu.types import Msg as JMsg
from etcd_tpu.types import Spec as JSpec
from etcd_tpu_torch.convert import msg_from_numpy, to_numpy
from etcd_tpu_torch.kernels.compact_wire import compact_wire_carry, compact_wire_carry_plain
from etcd_tpu_torch.models import raft as traft
from etcd_tpu_torch.types import ENT_FIELDS, Msg, Spec

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def specs(E):
    kw = dict(M=5, L=16, E=E, K=2, W=4, R=2, A=2)
    return Spec(**kw), JSpec(**kw)


def outbox(spec, C, seed, live=0.4, empty_cols=True):
    """Random keep-masked outbox leaves [from, K, to, (E,) C] as numpy; the
    first columns are all empty, the next all full."""
    rng = np.random.default_rng(seed)
    M, K, E = spec.M, spec.K, spec.E
    leaves = {}
    for name in Msg.names():
        shape = (M, K, M) + ((E,) if name in ENT_FIELDS else ()) + (C,)
        if name == "reject":
            leaves[name] = rng.random(shape) < 0.5
        else:
            leaves[name] = rng.integers(-3000, 3000, shape).astype(np.int32)
    t = rng.integers(1, 18, leaves["type"].shape).astype(np.int32)
    t = np.where(rng.random(t.shape) < live, t, 0)
    if empty_cols:
        t[..., 0] = 0
        t[..., 1] = np.maximum(t[..., 1], 1)
    leaves["type"] = t
    return leaves


def jmsg(leaves):
    return JMsg(**{k: jnp.asarray(v) for k, v in leaves.items()})


CASES = [  # (E, bound, live)
    (1, 4, 0.4), (1, 4, 0.9), (1, 1, 0.5), (1, 10, 0.5), (1, 12, 0.3), (2, 4, 0.5),
]


@pytest.mark.parametrize("E,bound,live", CASES)
def test_plain_equals_engine_compact_wire_carry(E, bound, live):
    spec, jspec = specs(E)
    leaves = outbox(spec, 40, seed=E * 100 + bound, live=live)
    want = jax.jit(lambda m: jeng.compact_wire_carry(jspec, m, bound))(jmsg(leaves))
    got = to_numpy(compact_wire_carry_plain(spec, msg_from_numpy(leaves, "cpu"), bound))
    for k in Msg.names():
        a = np.asarray(getattr(want, k))
        assert a.dtype == got[k].dtype and a.shape == got[k].shape, k
        np.testing.assert_array_equal(a, got[k], err_msg=k)
    # the CPU wrapper is the plain version, and the int16 wire is its cast
    w16 = to_numpy(compact_wire_carry(spec, msg_from_numpy(leaves, "cpu"), bound, torch.int16))
    want16 = jeng.to_wire(want)
    for k in Msg.names():
        np.testing.assert_array_equal(np.asarray(getattr(want16, k)), w16[k], err_msg=k)
        assert w16[k].dtype == np.asarray(getattr(want16, k)).dtype


@pytest.mark.parametrize("E,bound,live", CASES)
def test_plain_equals_per_node_compact_inbox(E, bound, live):
    """raft.compact_inbox per receiver over its from-major slots; it
    returns the slots unchanged once the bound covers them all, so there
    the port's raft.compact_inbox is checked and the engine form is not
    expected to match it."""
    spec, jspec = specs(E)
    M, K = spec.M, spec.K
    S = M * K
    leaves = outbox(spec, 24, seed=E * 7 + bound, live=live)
    flat = {k: v.reshape((S,) + v.shape[2:]) for k, v in leaves.items()}   # [S, to, (E,) C]
    per_node = jax.vmap(jax.vmap(lambda f: jraft.compact_inbox(jspec, f, bound),
                                 in_axes=-1, out_axes=-1), in_axes=1, out_axes=1)
    want = jax.jit(per_node)(jmsg(flat))
    port = to_numpy(traft.compact_inbox(spec, msg_from_numpy(flat, "cpu"), bound))
    plain = to_numpy(compact_wire_carry_plain(spec, msg_from_numpy(leaves, "cpu"), bound))
    for k in Msg.names():
        a = np.asarray(getattr(want, k))                     # [B, to, (E,) C]
        np.testing.assert_array_equal(a, port[k], err_msg=k)
        assert a.dtype == port[k].dtype
        if bound < S:
            np.testing.assert_array_equal(a.reshape(plain[k].shape), plain[k], err_msg=k)


def _pallas_module():
    path = ROOT / "experiments" / "pallas_compact.py"
    mod_spec = importlib.util.spec_from_file_location("pallas_compact", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_equals_pallas_kernel_in_interpret_mode(seed, monkeypatch):
    """The TPU kernel itself, interpreted on the CPU: its grid flattens
    (to, C) onto one column axis and every stream is int32 with E = 1; the
    experiment takes 17 streams besides the type, so the 16 other Msg
    leaves ride with the type repeated as the 17th."""
    pc = _pallas_module()
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    spec, _ = specs(1)
    M, K = spec.M, spec.K
    S, B = pc.S, pc.B
    assert (S, B) == (M * K, M - 1)
    C = 512                       # M * C = 2560 columns, five grid steps
    leaves = outbox(spec, C, seed=seed)
    names = [k for k in Msg.names() if k != "type"]
    cols = {k: leaves[k].astype(np.int32).reshape(S, M * C) for k in Msg.names()}
    fields = [jnp.asarray(cols[k]) for k in names] + [jnp.asarray(cols["type"])]
    assert len(fields) == pc.N_FIELDS
    typ_out, outs = pc.pallas_compact(jnp.asarray(cols["type"]), fields, ct=512)
    plain = to_numpy(compact_wire_carry_plain(spec, msg_from_numpy(leaves, "cpu"), B))
    np.testing.assert_array_equal(np.asarray(typ_out).reshape(B, M, C),
                                  plain["type"].reshape(B, M, C))
    for k, o in zip(names, outs):
        np.testing.assert_array_equal(np.asarray(o).reshape(B, M, C),
                                      plain[k].reshape(B, M, C).astype(np.int32), err_msg=k)


def test_empty_slots_are_all_zero_and_frm_differs_from_empty_msg():
    """A compacted empty slot has frm = 0 (the one-hot sum of nothing),
    while the default message has frm = NONE_ID; both as in JAX."""
    from etcd_tpu_torch.types import NONE_ID, empty_msg

    spec, _ = specs(1)
    leaves = outbox(spec, 8, seed=3, live=0.0, empty_cols=False)
    out = to_numpy(compact_wire_carry_plain(spec, msg_from_numpy(leaves, "cpu"), 4))
    for k, v in out.items():
        assert not v.any(), k
    assert int(empty_msg(spec, (1, 1), "cpu").frm[0, 0]) == NONE_ID


def test_cuda_wrapper_refuses_other_devices():
    spec, _ = specs(1)
    m = msg_from_numpy(outbox(spec, 4, seed=0), "meta")
    with pytest.raises(ValueError, match="no kernel"):
        compact_wire_carry(spec, m, 4)
