"""The port's copy of the JAX RNG that the engines consume: threefry-2x32
under ``jax_threefry_partitionable=True``, written as integer tensor ops.

The JAX engines draw exactly one kind of random number: per event ``i``,
``randint(fold_in(key, i), (), 0, m)`` with ``m = max(num_partitions, 1)``
(``repro.core.transition._rand_index`` / ``_choose_random`` /
``rand_index_table``). Reproducing those bits is what lets the port's SDP,
greedy and random policies choose bit-identically: the no-overlap branch
of the affinity choice draws at random for every vertex that arrives with
no assigned neighbour.

``randint`` splits the folded key in two, draws one 32-bit word from each,
and maps the pair onto ``[0, m)`` with a multiply/mod range reduction. The
two words do not depend on ``m``, so :func:`draw_words` computes them for
a whole run of event indices at once, and :func:`randint_words` reduces
them for any ``m`` — a few integer ops per event inside the engine loops.

Words are carried as int64 tensors holding uint32 values; every sum and
shift is masked back to 32 bits. Keys are (2,) ``torch.uint32`` tensors,
the same words as a JAX key's ``key_data``; they are reinterpreted through
int32 (``view``) rather than cast, because casts of unsigned 32-bit
tensors are not implemented on every device.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 block cipher (20 rounds) on broadcastable int64
    tensors of uint32 values; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for j in range(5):
        for r in _ROTATIONS[j % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(j + 1) % 3]) & _M32
        x1 = (x1 + ks[(j + 2) % 3] + (j + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s words: (seed >> 32, seed & 0xffffffff)
    for a 64-bit seed; a seed that fits in int32 has a zero high word."""
    seed = int(seed)
    hi = 0 if -2**31 <= seed < 2**31 else (seed >> 32) & _M32
    return _as_key(torch.tensor([hi, seed & _M32], dtype=torch.int64,
                                device=device))


def _as_key(words: torch.Tensor) -> torch.Tensor:
    """int64 words (< 2**32) -> uint32 key bits, via int32 (wraps)."""
    return words.to(torch.int32).view(torch.uint32)


def _words(key: torch.Tensor):
    k = key.view(torch.int32).to(torch.int64) & _M32
    return k[..., 0], k[..., 1]


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a scalar or a tensor of
    indices; returns keys of shape ``data.shape + (2,)``."""
    k0, k1 = _words(key)
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(data), data)
    return _as_key(torch.stack([y0, y1], dim=-1))


def _draw_pair(k0, k1):
    """The two 32-bit words ``randint`` draws from key (k0, k1): split the
    key in two (fold-like split, counters 0 and 1), then one word of
    random bits from each half (counter 0, the xor of the output pair)."""
    zero = torch.zeros_like(k0)
    a0, a1 = threefry2x32(k0, k1, zero, zero)
    b0, b1 = threefry2x32(k0, k1, zero, zero + 1)
    h0, h1 = threefry2x32(a0, a1, zero, zero)
    l0, l1 = threefry2x32(b0, b1, zero, zero)
    return h0 ^ h1, l0 ^ l1


def draw_words(key: torch.Tensor, idx: torch.Tensor):
    """``(hi, lo)``, the words ``randint(fold_in(key, i), ...)`` reduces,
    for every event index ``i`` in ``idx`` at once."""
    k0, k1 = _words(key)
    idx = idx.to(torch.int64) & _M32
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(idx), idx)
    return _draw_pair(y0, y1)


def randint_words(hi, lo, m):
    """``jax.random.randint``'s range reduction of the words ``(hi, lo)``
    onto ``[0, m)`` (``m <= 0`` draws 0, as JAX does); int32 result."""
    span = torch.as_tensor(m, device=hi.device).to(torch.int64)
    span = torch.where(span <= 0, 1, span)
    mult = 65536 % span
    mult = ((mult * mult) & _M32) % span
    off = (((hi % span) * mult) & _M32) + (lo % span)
    return ((off & _M32) % span).to(torch.int32)


def randint(key: torch.Tensor, minval: int, maxval) -> torch.Tensor:
    """``jax.random.randint(key, (), minval, maxval)`` for int32 bounds."""
    hi, lo = _draw_pair(*_words(key))
    span = torch.as_tensor(maxval, device=key.device).to(torch.int64) - minval
    return randint_words(hi, lo, span) + minval
