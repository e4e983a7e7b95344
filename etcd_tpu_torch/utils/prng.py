"""JAX's threefry2x32 PRNG, bit-exact, on int64 tensors.

Reproduces ``jax.random`` under jax 0.9's defaults (impl ``threefry2x32``,
``jax_threefry_partitionable=True``) for the draws the Raft state and the
chaos harness make: ``PRNGKey``, ``fold_in``, ``split``, ``randint`` of
int32 in [lo, hi) per key or over a shape, and ``bits``, ``uniform`` and
``bernoulli`` over a shape. A key is a pair of uint32 words. torch's uint32
coverage is partial, so every add, shift and modulo is done on int64 tensors in
[0, 2**32) and masked back to 32 bits; the node state stores a key as int32
bit patterns (``stored``), the same bytes as the JAX package's uint32 key.

Algorithm (jax/_src/prng.py threefry_2x32 / _threefry_split_foldlike /
_threefry_fold_in / _threefry_random_bits_partitionable, and
jax/_src/random.py _randint):
  * threefry(k, (x0, x1)) is 20 rounds of Threefry-2x32 with key injection
    every 4 rounds.
  * PRNGKey(s) = (s >> 32, s & 0xffffffff) = (0, s) for 32-bit seeds.
  * fold_in(k, d) = threefry(k, (0, d)).
  * split(k, n)[i] = threefry(k, (0, i)): the partitionable split hashes
    the 64-bit iota (hi, lo) of each subkey.
  * bits(k, shape) = xor of the pair threefry(k, (0, i)) for the row-major
    flat index i of each element (the 64-bit iota of the shape; its high
    word is 0 below 2**32 elements); a scalar draw is bits(k, ()).
  * uniform(k, shape) in [0, 1), float32 = (bits >> 9) * 2**-23: jax sets
    the 23 mantissa bits of 1.0 and subtracts 1.0, which is exact.
  * bernoulli(k, p, shape) = uniform(k, shape) < p, p a float32 (shape
    defaults to p's).
  * randint(k, shape, lo, hi): k1, k2 = split(k); w1 = bits(k1, shape),
    w2 = bits(k2, shape); offset = ((w1 % span) * (2**32 % span) + w2 %
    span) % span.
"""
from __future__ import annotations

import torch

from etcd_tpu_torch.types import wrap_int32

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & M32) | (x >> (32 - d))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the count pair (x0, x1) under key (k0, k1). All
    arguments are int64 tensors of uint32 values that broadcast together;
    returns the hashed pair."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: int64[2]."""
    return torch.tensor([0, seed & M32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key [..., 2, C'] (the pair on axis -2 when
    batched, or a bare [2]), data an integer tensor broadcasting against one
    word, or a Python int (made on the key's device, no host copy);
    negative int32 data wraps to uint32 as in jax."""
    k0, k1 = _words(key)
    if not isinstance(data, torch.Tensor):
        data = torch.full((), data & M32, dtype=torch.int64, device=key.device)
    d = data.to(torch.int64) & M32
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return _pair(y0, y1)


def split(key: torch.Tensor, n: int) -> list:
    """``jax.random.split(key, n)`` as a list of ``n`` keys shaped like
    ``key``."""
    k0, k1 = _words(key)
    cnt = torch.arange(n, dtype=torch.int64, device=key.device)
    cnt = cnt.view((n,) + (1,) * k0.dim())
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(cnt), cnt)
    return [_pair(y0[i], y1[i]) for i in range(n)]


def split2(key: torch.Tensor):
    """``jax.random.split(key)`` into (new_key, subkey)."""
    return tuple(split(key, 2))


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) for one bare key [2]: int64
    tensor of uint32 values."""
    k0, k1 = _words(key)
    numel = 1
    for d in shape:
        numel *= d
    if numel >= 2**32:
        raise ValueError("bits: a draw of 2**32 or more words needs the high "
                         "count word, which this port does not form")
    lo = torch.arange(numel, dtype=torch.int64, device=key.device).view(tuple(shape))
    y0, y1 = threefry2x32(k0, k1, torch.zeros((), dtype=torch.int64,
                                              device=key.device), lo)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1), float32."""
    return (bits(key, shape) >> 9).to(torch.float32) * (2.0 ** -23)


def bernoulli(key: torch.Tensor, p, shape=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: bool. ``p`` is a float32
    tensor or a Python float (rounded to float32, as jax converts it); the
    comparison is in float32, as in jax. ``shape=None`` draws one value per
    element of ``p`` (jax's default shape, ``p.shape``)."""
    if not isinstance(p, torch.Tensor):
        p = torch.full((), p, dtype=torch.float32, device=key.device)
    if p.dtype != torch.float32:
        raise TypeError(f"bernoulli: p must be float32, got {p.dtype}")
    return uniform(key, tuple(p.shape) if shape is None else shape) < p


def randint(key: torch.Tensor, lo: int, hi: int, shape=None) -> torch.Tensor:
    """``jax.random.randint(key, (), lo, hi, int32)`` per key: int32. With
    ``shape``, one bare key [2] draws ``jax.random.randint(key, shape, lo,
    hi, int32)``: the two words of each element are ``bits(k1, shape)`` and
    ``bits(k2, shape)``."""
    span = hi - lo if hi > lo else 1
    k1, k2 = split2(key)
    if shape is not None:
        w = [bits(k1, shape), bits(k2, shape)]
    else:
        w = []
        for k in (k1, k2):
            a0, a1 = _words(k)
            zero = torch.zeros_like(a0)
            b0, b1 = threefry2x32(a0, a1, zero, zero)
            w.append(b0 ^ b1)
    mult = (1 << 16) % span                  # 2**32 % span, formed in
    mult = ((mult * mult) & M32) % span      # uint32 the way jax does
    off = (((w[0] % span) * mult) & M32) + (w[1] % span)
    off = (off & M32) % span
    return (lo + off).to(torch.int32)


def stored(key: torch.Tensor) -> torch.Tensor:
    """A key as the state stores it: int32 holding the uint32 bit pattern."""
    return wrap_int32(key)


def _words(key: torch.Tensor):
    """The two words (int64 in [0, 2**32)) of a key [2] or of a batch of
    keys [N, 2, C], given as int64 words or as stored int32 bit patterns."""
    key = key.to(torch.int64) & M32
    if key.dim() == 1:
        return key[0], key[1]
    return key.select(-2, 0), key.select(-2, 1)


def _pair(y0: torch.Tensor, y1: torch.Tensor) -> torch.Tensor:
    return torch.stack([y0, y1], dim=0 if y0.dim() == 0 else -2)
