"""The port's threefry PRNG against jax.random, bit for bit.

The draws are the ones the Raft state makes: fold_in of a seed and a node id
into PRNGKey(0), split into two, randint of one int32 (seeds include the
int32-wrapped fleet seeds c * 1_000_003 + s of the largest bench groups);
and the chaos tier's: split into n, fold_in of a count, bits and bernoulli
with a float32 p at the fleet shapes of its fault masks, over 200 keys.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu_torch.utils import prng

from torch_jax_memory import release_jax_memory  # noqa: F401  (autouse)

torch.set_num_threads(1)


def _pairs():
    rng = np.random.default_rng(0)
    seeds = rng.integers(-2**31, 2**31, 1000, dtype=np.int64)
    wrapped = [(c * 1_000_003 + s) for c in (2147, 2148, 1_048_575) for s in (0, 3)]
    seeds = np.concatenate([seeds, wrapped, [0, 1, -1, 2**31 - 1, -2**31]])
    seeds = ((seeds + 2**31) % 2**32 - 2**31).astype(np.int32)    # int32 wrap
    nids = rng.integers(0, 31, seeds.shape[0]).astype(np.int32)
    return seeds, nids


@jax.jit
def _jax_draws(seeds, nids):
    def one(s, n):
        k = jax.random.fold_in(jax.random.PRNGKey(0), s)
        k = jax.random.fold_in(k, n)
        new, sub = jax.random.split(k)
        return (k, new, sub,
                jax.random.randint(sub, (), 0, 10, dtype=jnp.int32),
                jax.random.randint(k, (), 3, 17, dtype=jnp.int32),
                jax.random.randint(new, (), 0, 100_000, dtype=jnp.int32),
                jax.random.randint(sub, (), -5, 2**31 - 1, dtype=jnp.int32))
    return jax.vmap(one)(seeds, nids)


def test_draws_match_jax_over_seed_nid_pairs():
    seeds, nids = _pairs()
    assert seeds.shape[0] >= 1000
    jk, jnew, jsub, r10, r3_17, r1e5, rwide = map(np.asarray, _jax_draws(seeds, nids))
    k = prng.fold_in(prng.prng_key(0), torch.from_numpy(seeds))
    k = prng.fold_in(k, torch.from_numpy(nids))
    new, sub = prng.split2(k)

    def pairs(t):          # port keys [2, N] (pair on axis -2) -> [N, 2]
        return t.T.numpy().astype(np.uint32)

    np.testing.assert_array_equal(pairs(k), jk)
    np.testing.assert_array_equal(pairs(new), jnew)
    np.testing.assert_array_equal(pairs(sub), jsub)
    np.testing.assert_array_equal(prng.randint(sub, 0, 10).numpy(), r10)
    np.testing.assert_array_equal(prng.randint(k, 3, 17).numpy(), r3_17)
    np.testing.assert_array_equal(prng.randint(new, 0, 100_000).numpy(), r1e5)
    np.testing.assert_array_equal(prng.randint(sub, -5, 2**31 - 1).numpy(), rwide)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_prng_key_and_stored_round_trip(seed):
    key = jax.random.PRNGKey(seed)
    mine = prng.prng_key(seed)
    np.testing.assert_array_equal(mine.numpy().astype(np.uint32), np.asarray(key))
    stored = prng.stored(mine)
    assert stored.dtype == torch.int32
    np.testing.assert_array_equal(stored.numpy().view(np.uint32), np.asarray(key))


def test_threefry_known_answer():
    """Threefry-2x32, 20 rounds: the Random123 known-answer vector that
    jax's own tests check (key = 0x13198a2e 0x03707344, counts 0x243f6a88
    0x85a308d3)."""
    y0, y1 = prng.threefry2x32(torch.tensor(0x13198A2E), torch.tensor(0x03707344),
                               torch.tensor(0x243F6A88), torch.tensor(0x85A308D3))
    assert (int(y0), int(y1)) == (0xC4923A9C, 0x483DF7A0)


# ---------------------------------------------------------------------------
# the chaos tier's draws: split into n, fold_in of a count, bits, bernoulli
# ---------------------------------------------------------------------------

CHAOS_M, CHAOS_K, CHAOS_C = 5, 2, 16
# the four fleet shapes of the fault masks (etcd_tpu/harness/chaos.py
# sample_keep and the delay draw): sides, partitioned groups, drops, delays
SHAPES = {"sides": (CHAOS_M, CHAOS_C), "groups": (CHAOS_C,),
          "drops": (CHAOS_M, CHAOS_M, CHAOS_C),
          "delays": (CHAOS_M, CHAOS_K * CHAOS_M, CHAOS_C)}
# 1 - drop_p as the chaos epoch forms it: a float32 subtraction
KEEP_P = np.float32(1.0) - np.float32(0.02)
PROBS = {"0.5": 0.5, "1-0.02": KEEP_P, "0.05": 0.05, "0.1": 0.1}
SEEDS = 200


def _keys():
    rng = np.random.default_rng(1)
    return rng.integers(0, 2**32, (SEEDS, 2), dtype=np.uint64).astype(np.uint32)


def _key(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(k.astype(np.int64))


def test_split_into_n_matches_jax():
    keys = _keys()
    for n in (2, 3, 5):
        want = np.asarray(jax.vmap(lambda k: jax.random.split(k, n))(jnp.asarray(keys)))
        for i, k in enumerate(keys):
            got = prng.split(_key(k), n)
            assert len(got) == n
            np.testing.assert_array_equal(np.stack([g.numpy() for g in got]).astype(np.uint32),
                                          want[i])


def test_fold_in_of_counts_matches_jax():
    """fold_in with the chaos epoch's counts (the partition period r // 25
    and the constant 1), as Python ints and as int32 tensors."""
    keys = _keys()
    counts = np.array([0, 1, 2, 7, 2**31 - 1, -1], np.int32)
    want = np.asarray(jax.vmap(lambda k: jax.vmap(
        lambda d: jax.random.fold_in(k, d))(jnp.asarray(counts)))(jnp.asarray(keys)))
    for i, k in enumerate(keys):
        key = _key(k)
        tens = prng.fold_in(key.view(2, 1), torch.from_numpy(counts))   # [2, n]
        np.testing.assert_array_equal(tens.T.numpy().astype(np.uint32), want[i])
        for j, d in enumerate(counts.tolist()):
            np.testing.assert_array_equal(prng.fold_in(key, d).numpy().astype(np.uint32),
                                          want[i, j])


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bits_match_jax(shape):
    keys = _keys()
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, SHAPES[shape]))(
        jnp.asarray(keys)))
    for i, k in enumerate(keys):
        np.testing.assert_array_equal(
            prng.bits(_key(k), SHAPES[shape]).numpy().astype(np.uint32), want[i])


@pytest.mark.parametrize("p", sorted(PROBS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bernoulli_matches_jax(shape, p):
    """jax.random.bernoulli(key, float32 p, shape) over 200 keys."""
    keys = _keys()
    pv = np.float32(PROBS[p])
    want = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(
        k, jnp.float32(pv), SHAPES[shape]))(jnp.asarray(keys)))
    tp = torch.tensor(pv, dtype=torch.float32)
    hits = 0
    for i, k in enumerate(keys):
        got = prng.bernoulli(_key(k), tp, SHAPES[shape]).numpy()
        np.testing.assert_array_equal(got, want[i])
        hits += int(got.sum())
    assert 0 < hits < want.size


def test_keep_probability_is_a_float32_subtraction():
    """1.0 - drop_p is a float32 subtraction from the float32 operand in
    both packages; for some drop rates (0.058) it differs from the float32
    rounding of the float64 difference."""
    for d in (0.02, 0.058):
        drop = torch.tensor(d, dtype=torch.float32)
        assert (1.0 - drop).dtype == torch.float32
        assert float(1.0 - drop) == float(jnp.float32(1.0) - jnp.float32(d)) \
            == float(np.float32(1.0) - np.float32(d))
    assert float(1.0 - torch.tensor(0.058, dtype=torch.float32)) != float(np.float32(1.0 - 0.058))


def test_chaos_round_draws_match_jax():
    """The whole draw chain of one chaos round (harness/chaos.py sample_keep
    and the delay mask) for 200 seeds and two rounds of two partition
    periods."""
    M, K, C = CHAOS_M, CHAOS_K, CHAOS_C
    drop_p, delay_p, part_p = (jnp.float32(x) for x in (0.02, 0.05, 0.1))

    def jdraws(seed, r):
        key, pkey = jax.random.split(jax.random.PRNGKey(seed))
        key, kd, kl = jax.random.split(key, 3)
        kp = jax.random.fold_in(pkey, r // 25)
        return (jax.random.bernoulli(kp, 0.5, (M, C)),
                jax.random.bernoulli(jax.random.fold_in(kp, 1), part_p, (C,)),
                jax.random.bernoulli(kd, 1.0 - drop_p, (M, M, C)),
                jax.random.bernoulli(kl, delay_p, (M, K * M, C)))

    jd = jax.jit(jax.vmap(jdraws, in_axes=(0, None)))
    seeds = np.arange(SEEDS, dtype=np.int32)
    tdrop, tdelay, tpart = (torch.tensor(x, dtype=torch.float32) for x in (0.02, 0.05, 0.1))
    for r in (3, 30):
        want = [np.asarray(a) for a in jd(jnp.asarray(seeds), r)]
        for s in seeds.tolist():
            key, pkey = prng.split(prng.prng_key(s), 2)
            key, kd, kl = prng.split(key, 3)
            kp = prng.fold_in(pkey, r // 25)
            got = (prng.bernoulli(kp, 0.5, (M, C)),
                   prng.bernoulli(prng.fold_in(kp, 1), tpart, (C,)),
                   prng.bernoulli(kd, 1.0 - tdrop, (M, M, C)),
                   prng.bernoulli(kl, tdelay, (M, K * M, C)))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w[s])


def test_threefry_broadcasts_its_operands_as_jax_hashes_them():
    """threefry2x32 on operands of different shapes that broadcast (a key
    per column, counts per row, as the fleet's draws give them) equals
    jax's threefry2x32 primitive on the operands broadcast out."""
    from jax.extend.random import threefry2x32_p

    rng = np.random.default_rng(5)
    k0, k1 = (rng.integers(0, 2**32, (1, 7), dtype=np.int64) for _ in range(2))
    x0, x1 = (rng.integers(0, 2**32, (3, 1), dtype=np.int64) for _ in range(2))
    got = prng.threefry2x32(*map(torch.from_numpy, (k0, k1, x0, x1)))
    u32 = [np.broadcast_to(a, (3, 7)).astype(np.uint32) for a in (k0, k1, x0, x1)]
    want = threefry2x32_p.bind(*map(jnp.asarray, u32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), w)
