"""The port's threefry PRNG against jax.random, bit for bit.

The draws are the ones the Raft state makes: fold_in of a seed and a node id
into PRNGKey(0), split into two, randint of one int32. Seeds include the
int32-wrapped fleet seeds c * 1_000_003 + s of the largest bench groups.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etcd_tpu_torch.utils import prng

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
