"""Counter-based threefry2x32 random stream, bitwise equal to
``jax.random`` under ``jax_default_prng_impl=threefry2x32`` with the
partitionable bit layout (``jax_threefry_partitionable=True``).

The sampler folds (step, layer, edge block) and, in serving, each
frontier node id into a key and draws one uniform 32-bit word per
(row, fanout) slot from it, so the reference and the port draw the same
neighbors for the same seed.

Representation:

- a single key is a tuple of two Python ints ``(k1, k2)``, each in
  ``[0, 2^32)``; deriving scalar keys therefore launches nothing;
- a batch of keys is an int64 tensor of shape ``(..., 2)``;
- 32-bit words are computed in int64 and masked to 32 bits, because
  torch's uint32 arithmetic is incomplete; ``bits`` returns them as int32
  tensors holding the uint32 bit pattern (``.view(torch.uint32)`` or
  numpy's ``.view(np.uint32)`` reads them back unsigned).

Recipes, after ``jax._src.prng``:

- ``PRNGKey(s) = (0, s mod 2^32)`` for a 32-bit seed;
- ``fold_in(k, d) = threefry2x32(k, (0, uint32(d)))``;
- ``bits(k, shape)``: counters are the row-major 64-bit iota over
  ``shape`` split into (hi, lo) words; the word is ``y1 ^ y2`` of
  ``threefry2x32(k, (hi, lo))``.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Union[Tuple[int, int], torch.Tensor]


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key ``(k1, k2)``.  Works on Python ints and on int64 tensors
    (broadcasting) holding values in ``[0, 2^32)``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed: int) -> Tuple[int, int]:
    """The key ``jax.random.PRNGKey(seed)`` makes for a 32-bit seed."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return (0, seed & MASK)


def _split_key(key: Key, extra_dims: int = 0):
    if isinstance(key, tuple):
        return key
    view = key.shape[:-1] + (1,) * extra_dims
    return key[..., 0].reshape(view), key[..., 1].reshape(view)


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in``.  With an int ``data`` and a scalar key the
    result is a scalar key; with an integer tensor ``data`` the result is
    an int64 ``data.shape + (2,)`` tensor of row keys (the counterpart of
    ``jax.vmap(fold_in, in_axes=(None, 0))``, or of a vmap over both
    when ``key`` is itself a batch of keys of ``data``'s shape)."""
    k1, k2 = _split_key(key)
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64) & MASK
        y1, y2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
        return torch.stack([y1, y2], dim=-1)
    return threefry2x32(k1, k2, 0, int(data) & MASK)


def bits(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int32 tensor holding
    the uint32 bit pattern.  A batch of keys ``(..., 2)`` draws one
    ``shape`` block per key (``jax.vmap`` of ``bits`` over the keys) and
    returns ``(...,) + shape``; a scalar key needs ``device``."""
    shape = tuple(int(s) for s in shape)
    if isinstance(key, torch.Tensor):
        device = key.device
    count = torch.arange(math.prod(shape), dtype=torch.int64,
                         device=device).reshape(shape)
    k1, k2 = _split_key(key, extra_dims=len(shape))
    y1, y2 = threefry2x32(k1, k2, count >> 32, count & MASK)
    return _as_int32_bits(y1 ^ y2)


def _as_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 words in ``[0, 2^32)`` -> int32 with the same low 32 bits."""
    return ((words ^ 0x80000000) - 0x80000000).to(torch.int32)
