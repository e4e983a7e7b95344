"""The port's quorum, log, inflights and outbox ops against the JAX ops.

Random node states (numpy-seeded, fleet layout [N, ..., C]) go through the
JAX function vmapped over nodes and clusters, the way the engine batches it,
and through the port's batched function on the CPU. Every output must be
equal exactly: all leaves are integers or bools.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu.models.state import NodeState as JNodeState
from etcd_tpu.ops import inflights as jinfl
from etcd_tpu.ops import log as jlog
from etcd_tpu.ops import outbox as jout
from etcd_tpu.ops import quorum as jq
from etcd_tpu.types import Msg as JMsg
from etcd_tpu.types import Spec as JSpec
from etcd_tpu.types import empty_msg as jempty_msg
from etcd_tpu_torch.convert import node_state_from_numpy, to_numpy
from etcd_tpu_torch.models.state import init_node
from etcd_tpu_torch.ops import inflights as tinfl
from etcd_tpu_torch.ops import log as tlog
from etcd_tpu_torch.ops import outbox as tout
from etcd_tpu_torch.ops import quorum as tq
from etcd_tpu_torch.types import Msg, Spec

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

torch.set_num_threads(1)

SPEC = Spec(M=5, L=16, E=2, K=2, W=4, R=2, A=2)
JSPEC = JSpec(M=5, L=16, E=2, K=2, W=4, R=2, A=2)
N, C = 5, 96


def fleet_vmap(fn):
    """Batch a per-node JAX function over [N, ..., C] arguments."""
    return jax.jit(jax.vmap(jax.vmap(fn, in_axes=-1, out_axes=-1)))


def random_state(seed):
    """Random but in-range node states: a log window (snap, last] of the
    ring, commit and applied inside it, random progress and inflights."""
    rng = np.random.default_rng(seed)
    M, L, W = SPEC.M, SPEC.L, SPEC.W
    nid = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, C)) % M
    base = to_numpy(init_node(SPEC, torch.from_numpy(nid),
                              torch.from_numpy(rng.random((N, M, C)) < 0.8)))

    def ri(lo, hi, *shape):
        return rng.integers(lo, hi, (N,) + shape + (C,)).astype(np.int32)

    snap = ri(0, 12)
    last = snap + ri(0, L + 1)
    commit = snap + (rng.random((N, C)) * (last - snap + 1)).astype(np.int32)
    base.update(
        term=ri(0, 7), snap_index=snap, snap_term=ri(0, 3), last_index=last,
        commit=commit, applied=np.minimum(commit, snap + ri(0, 3)),
        log_term=ri(0, 7, L), log_data=ri(-1000, 1000, L), log_type=ri(0, 2, L),
        match=ri(0, 20, M), next_idx=ri(1, 22, M), pr_state=ri(0, 3, M),
        probe_sent=rng.random((N, M, C)) < 0.5,
        infl_ends=np.sort(ri(0, 30, M, W), axis=2).reshape(N, M * W, C),
        infl_start=ri(0, W, M), infl_count=ri(0, W + 1, M),
        voters_out=rng.random((N, M, C)) < 0.2,
        votes_responded=rng.random((N, M, C)) < 0.5,
        votes_granted=rng.random((N, M, C)) < 0.5,
    )
    return base, rng


def jax_state(leaves):
    return JNodeState(**{k: jnp.asarray(v) for k, v in leaves.items()})


def assert_same(j, t, what=""):
    j, t = np.asarray(j), t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.dtype == t.dtype and j.shape == t.shape, (what, j.dtype, t.dtype, j.shape, t.shape)
    np.testing.assert_array_equal(j, t, err_msg=what)


def assert_state(jn, tn):
    tl = to_numpy(tn)
    for k in JNodeState.__dataclass_fields__:
        assert_same(getattr(jn, k), tl[k], k)


@pytest.mark.parametrize("seed", [0, 1])
def test_quorum(seed):
    rng = np.random.default_rng(seed)
    M = 7
    v = rng.random((N, M, C)) < 0.6
    vo = rng.random((N, M, C)) < 0.3
    acked = rng.integers(0, 6, (N, M, C)).astype(np.int32)   # many ties
    resp = rng.random((N, M, C)) < 0.6
    gr = rng.random((N, M, C)) < 0.5
    j = fleet_vmap(lambda a, b, c, d, e: (
        jq.committed_index(a, c), jq.joint_committed_index(a, b, c),
        jq.vote_result(a, d, e), jq.joint_vote_result(a, b, d, e)))(v, vo, acked, resp, gr)
    T = [torch.from_numpy(x) for x in (v, vo, acked, resp, gr)]
    t = (tq.committed_index(T[0], T[2]), tq.joint_committed_index(T[0], T[1], T[2]),
         tq.vote_result(T[0], T[3], T[4]), tq.joint_vote_result(T[0], T[1], T[3], T[4]))
    for a, b, name in zip(j, t, ("committed", "joint_committed", "vote", "joint_vote")):
        assert_same(a, b, name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_log_queries(seed):
    leaves, rng = random_state(seed)
    idx = rng.integers(-1, 32, (N, C)).astype(np.int32)
    term = rng.integers(0, 7, (N, C)).astype(np.int32)

    def jf(n, i, t):
        ta, ok = jlog.term_at(JSPEC, n, i)
        return (ta, ok, jlog.match_term(JSPEC, n, i, t), jlog.last_term(JSPEC, n),
                jlog.is_up_to_date(JSPEC, n, i, t),
                jlog.find_conflict_by_term(JSPEC, n, i, t),
                jlog.count_pending_conf(JSPEC, n, n.applied, i),
                jlog.commit_to(n, i).commit,
                *jlog.entries_from(JSPEC, n, jnp.maximum(i, n.snap_index + 1)))

    j = fleet_vmap(jf)(jax_state(leaves), idx, term)
    n = node_state_from_numpy(leaves, "cpu")
    i, t = torch.from_numpy(idx), torch.from_numpy(term)
    ta, ok = tlog.term_at(SPEC, n, i)
    got = (ta, ok, tlog.match_term(SPEC, n, i, t), tlog.last_term(SPEC, n),
           tlog.is_up_to_date(SPEC, n, i, t), tlog.find_conflict_by_term(SPEC, n, i, t),
           tlog.count_pending_conf(SPEC, n, n.applied, i), tlog.commit_to(n, i).commit,
           *tlog.entries_from(SPEC, n, torch.maximum(i, n.snap_index + 1)))
    names = ("term_at", "ok", "match_term", "last_term", "is_up_to_date",
             "find_conflict_by_term", "count_pending_conf", "commit_to",
             "ent_len", "ent_term", "ent_data", "ent_type")
    for a, b, name in zip(j, got, names):
        assert_same(a, b, name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_log_writes(seed):
    """append_span and maybe_append (conflicts, truncation, commit) on
    offered spans built partly from the node's own log, so that matching
    prefixes and conflicts both occur."""
    leaves, rng = random_state(seed)
    E = SPEC.E
    m_index = np.maximum(leaves["last_index"] - rng.integers(0, 4, (N, C)), 0).astype(np.int32)
    m_log_term = np.where(rng.random((N, C)) < 0.7,
                          leaves["log_term"][np.arange(N)[:, None], (m_index - 1) % SPEC.L,
                                             np.arange(C)[None, :]],
                          rng.integers(0, 7, (N, C))).astype(np.int32)
    ent_len = rng.integers(0, E + 1, (N, C)).astype(np.int32)
    ent_term = rng.integers(0, 7, (N, E, C)).astype(np.int32)
    ent_data = rng.integers(-99, 99, (N, E, C)).astype(np.int32)
    ent_type = rng.integers(0, 2, (N, E, C)).astype(np.int32)
    m_commit = rng.integers(0, 40, (N, C)).astype(np.int32)
    enable = rng.random((N, C)) < 0.8
    args = (m_index, m_log_term, m_commit, ent_len, ent_term, ent_data, ent_type, enable)

    def jf(n, mi, mlt, mc, el, et, ed, ety, en):
        a = jlog.append_span(JSPEC, n, mi, el, et, ed, ety, en)
        b, lni, ok = jlog.maybe_append(JSPEC, n, mi, mlt, mc, el, et, ed, ety, en)
        return a, b, lni, ok

    ja, jb, jlni, jok = fleet_vmap(jf)(jax_state(leaves), *args)
    n = node_state_from_numpy(leaves, "cpu")
    T = [torch.from_numpy(x) for x in args]
    ta = tlog.append_span(SPEC, n, T[0], T[3], T[4], T[5], T[6], T[7])
    tb, tlni, tok = tlog.maybe_append(SPEC, n, *T)
    assert_state(ja, ta)
    assert_state(jb, tb)
    assert_same(jlni, tlni, "last_new_i")
    assert_same(jok, tok, "ok")
    assert bool(tok.any()) and bool((~tok).any())


@pytest.mark.parametrize("seed", [0, 1])
def test_ring_read_and_roll(seed):
    rng = np.random.default_rng(seed)
    ring = rng.integers(-50, 50, (N, 8, C)).astype(np.int32)
    s = rng.integers(-2, 10, (N, 3, C)).astype(np.int32)     # out of range reads 0
    k = rng.integers(0, 8, (N, C)).astype(np.int32)
    j = fleet_vmap(lambda r, i, kk: (jlog.ring_read(r, i), jlog.roll_left(r, kk)))(ring, s, k)
    t = (tlog.ring_read(torch.from_numpy(ring), torch.from_numpy(s)),
         tlog.roll_left(torch.from_numpy(ring), torch.from_numpy(k)))
    assert_same(j[0], t[0], "ring_read")
    assert_same(j[1], t[1], "roll_left")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inflights(seed):
    leaves, rng = random_state(seed)
    M = SPEC.M
    mask = rng.random((N, M, C)) < 0.6
    end = rng.integers(0, 30, (N, M, C)).astype(np.int32)
    idx = rng.integers(0, 30, (N, C)).astype(np.int32)

    def jf(n, mk, e, i):
        return (jinfl.add(JSPEC, n, mk, e), jinfl.free_le(JSPEC, n, mk, i),
                jinfl.free_first_one(JSPEC, n, mk), jinfl.reset(n, mk),
                jinfl.full(3, n))

    j = fleet_vmap(jf)(jax_state(leaves), mask, end, idx)
    n = node_state_from_numpy(leaves, "cpu")
    mk, e, i = (torch.from_numpy(x) for x in (mask, end, idx))
    t = (tinfl.add(SPEC, n, mk, e), tinfl.free_le(SPEC, n, mk, i),
         tinfl.free_first_one(SPEC, n, mk), tinfl.reset(n, mk))
    for a, b in zip(j[:4], t):
        assert_state(a, b)
    assert_same(j[4], tinfl.full(3, n), "full")


@pytest.mark.parametrize("seed", [0, 1])
def test_outbox_emit(seed):
    """Three emits into one outbox (overflowing K for some destinations),
    a one-destination emit of a full message and record_sent_commit."""
    rng = np.random.default_rng(seed)
    M, K, E = SPEC.M, SPEC.K, SPEC.E
    masks = [rng.random((N, M, C)) < 0.6 for _ in range(3)]
    to = rng.integers(-1, M, (N, C)).astype(np.int32)
    en = rng.random((N, C)) < 0.7
    vals = rng.integers(-500, 500, (3, N, M, C)).astype(np.int32)
    ents = rng.integers(-500, 500, (N, E, C)).astype(np.int32)
    commit = rng.integers(0, 20, (N, C)).astype(np.int32)
    jempty_msg(JSPEC)   # fill the JAX template cache eagerly, not under trace

    def jf(m0, m1, m2, v0, v1, v2, tt, e, ee, cm):
        v = (v0, v1, v2)
        ob = jout.empty_outbox(JSPEC)
        for i, mk in enumerate((m0, m1, m2)):
            msg = jout.bcast(JSPEC, jout.make_msg(JSPEC)).replace(
                type=jnp.full((M,), i + 1, jnp.int32), term=v[i], index=v[(i + 1) % 3],
                commit=v[(i + 2) % 3], reject=v[i] > 0)
            ob = jout.emit(JSPEC, ob, mk, msg, fields=("index", "commit") if i else None)
            ob = jout.record_sent_commit(ob, mk, v[i])
        one = jout.make_msg(JSPEC, type=7, term=3, frm=2, index=cm, ent_len=2,
                            ent_data=ee, context=5)
        ob = jout.emit_one(JSPEC, ob, tt, one, e)
        return jout.record_sent_commit(ob, e & (tt >= 0), cm)

    j = fleet_vmap(jf)(*masks, *vals, to, en, ents, commit)
    ob = tout.empty_outbox(SPEC, (N, C), "cpu")
    V = torch.from_numpy(vals)
    for i, mk in enumerate(masks):
        mk = torch.from_numpy(mk)
        msg = tout.bcast(SPEC, tout.make_msg(SPEC, V[0, :, 0])).replace(
            type=torch.full((N, M, C), i + 1, dtype=torch.int32), term=V[i],
            index=V[(i + 1) % 3], commit=V[(i + 2) % 3], reject=V[i] > 0)
        ob = tout.emit(SPEC, ob, mk, msg, fields=("index", "commit") if i else None)
        ob = tout.record_sent_commit(ob, mk, V[i])
    tt, e, cm = torch.from_numpy(to), torch.from_numpy(en), torch.from_numpy(commit)
    one = tout.make_msg(SPEC, tt, type=7, term=3, frm=2, index=cm, ent_len=2,
                        ent_data=torch.from_numpy(ents), context=5)
    ob = tout.emit_one(SPEC, ob, tt, one, e)
    ob = tout.record_sent_commit(ob, e & (tt >= 0), cm)

    assert_same(j.counts, ob.counts, "counts")
    assert_same(j.sent_commit, ob.sent_commit, "sent_commit")
    for k in Msg.names():
        want = np.asarray(getattr(j.msgs, k))                # [N, K*M(*E), C]
        assert_same(want, getattr(ob.msgs, k).reshape(want.shape), k)
    assert (np.sum(masks, axis=0) > K).any()                # some emits overflowed
    assert JMsg.__dataclass_fields__.keys() == set(Msg.names())
