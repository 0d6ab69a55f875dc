"""The part of ``jax.random`` that a seeded request's sampling uses, in torch.

The reference samples a row with a per-request ``seed`` from the key
``fold_in(PRNGKey(seed), counter)`` (``clearml_serving_tpu/llm/sampling.py``
``_row_keys``) and draws ``jax.random.categorical(key, logits)``, which is
``argmax(logits + gumbel(key, (V,)))``. This module reproduces those draws
bit for bit, so a seeded request gives the JAX server's tokens:

- ``threefry2x32``: the Threefry-2x32 hash (20 rounds, key injection every
  four), as ``jax._src.prng._threefry2x32_lowering``;
- ``prng_key`` (``jax.random.PRNGKey`` of a 32-bit seed: ``(0, seed)``) and
  ``fold_in`` (the hash of ``(0, data)`` under the key);
- ``random_bits``/``row_bits``: 32-bit draws in the partitionable layout
  (``jax_threefry_partitionable``, the default since jax 0.5): element i of
  the flattened shape hashes the counter pair ``(i >> 32, i & 0xFFFFFFFF)``
  and keeps the xor of the two output words;
- ``uniform``: the bits -> float construction (the top 23 bits as the
  mantissa of a float in [1, 2), minus 1, scaled into [minval, maxval));
- ``gumbel``: ``-log(-log(u))`` over ``uniform(tiny, 1)``, the ``"low"``
  mode of ``jax.random.gumbel``.

Every value is a uint32 held in an int64 tensor (torch has little uint32
arithmetic on CUDA): sums are masked to 32 bits after each add, rotations
shift within 64 bits and mask. The integer results are the same on the CPU
and on the card; the floats follow from them by the same float32 ops, and
``log`` may differ by an ulp between libraries. It is plain tensor ops, so
it runs inside a CUDA graph from device tensors of seeds and counters.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words ``(x1, x2)`` under the key
    ``(k1, k2)``; all int64 tensors of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.PRNGKey`` of non-negative seeds below 2**32: the key
    words ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    seed = seed.long()
    return (seed >> 32) & MASK, seed & MASK


def fold_in(k1, k2, data) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in``: the key hashed over the counter ``(0, data)``."""
    data = torch.as_tensor(data, device=k1.device).long() & MASK
    return threefry2x32(k1, k2, torch.zeros_like(data), data)


def random_bits(k1, k2, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32, partitionable layout) for
    one key given as two 0-d int64 tensors."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return (b1 ^ b2).reshape(tuple(shape))


def row_bits(k1, k2, n: int) -> torch.Tensor:
    """One row of ``n`` 32-bit draws per key: keys [B] -> [B, n], row b
    equal to ``random_bits`` of key b over ``(n,)`` (n < 2**32)."""
    idx = torch.arange(n, dtype=torch.int64, device=k1.device)[None, :]
    b1, b2 = threefry2x32(k1[:, None], k2[:, None], torch.zeros_like(idx), idx)
    return b1 ^ b2


def uniform(bits: torch.Tensor, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``'s float32 construction from 32-bit draws. The
    bounds enter as float32 scalars (no host tensor, so it captures in a
    CUDA graph)."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(floats * scale + lo, min=lo)


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low", float32) from 32-bit draws."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(bits, tiny, 1.0)))


def seeded_gumbel(seeds: torch.Tensor, counters: torch.Tensor, n: int) -> torch.Tensor:
    """The Gumbel row a seeded request's categorical draw adds to its
    logits: row b from the key ``fold_in(PRNGKey(max(seeds[b], 0)),
    counters[b])`` (the reference's ``_row_keys``) over ``(n,)``. seeds,
    counters [B] -> [B, n] float32."""
    k1, k2 = prng_key(torch.clamp(seeds.long(), min=0))
    k1, k2 = fold_in(k1, k2, counters)
    return gumbel(row_bits(k1, k2, n))
