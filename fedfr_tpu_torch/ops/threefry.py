"""JAX's threefry PRNG in plain PyTorch, bit for bit.

The ``synth:`` generator (``data/synthetic.py``, ``ops/synth_gen.py``) must
draw the same images as the JAX package's, so it needs the exact bits of
the ``jax.random`` calls that generator makes, as JAX computes them with
``jax_threefry_partitionable=True`` and ``jax_default_prng_impl=threefry2x32``
(the defaults of JAX 0.9):

* ``threefry2x32``: 20 rounds, rotations ``[13, 15, 26, 6]`` and
  ``[17, 29, 16, 24]``, key schedule ``k0 ^ k1 ^ 0x1BD11BDA``, 5 injections
  (``jax/_src/prng.py::_threefry2x32_lowering``);
* ``prng_key(seed)`` = ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``fold_in(key, d)`` = ``threefry2x32(key, (0, uint32(d)))``;
* ``split(key)[i]`` = ``threefry2x32(key, (0, i))`` (the fold-like split);
* ``bits32(key, idx)``: the 32-bit ``random_bits`` at flat index ``idx`` of
  the requested shape, ``bits1 ^ bits2`` of ``threefry2x32(key, (idx >> 32,
  idx & 0xFFFFFFFF))``;
* ``randint`` and float32 ``uniform`` on those bits
  (``jax/_src/random.py::_randint``, ``_uniform``).

torch has no general uint32 arithmetic, so every uint32 value is held in an
int64 tensor (or a Python int) in ``[0, 2^32)`` and masked after each add,
shift and multiply; products are split so that no int64 overflows.
``randint`` does its arithmetic in uint32 that WRAPS, as JAX's does: its
multiplier ``((2^16 % span)^2) % span`` is 0 for a span of 2^30 - 2^26, and
``(hi % span) * mult + lo % span`` wraps before the last ``% span``.

Every function takes Python ints or int64 tensors (a key is a pair of them)
and broadcasts as torch does; the CUDA generator ``csrc/synth_gen.cu`` has
the same functions in uint32 and this module is its oracle.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

U32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]
Key = Tuple[Word, Word]


def _rotl(v: Word, r: int) -> Word:
    return ((v << r) & U32) | (v >> (32 - r))


def mul32(a: Word, b: Word) -> Word:
    """``a * b`` mod 2^32 of two uint32 words, with every partial product
    below 2^48."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & U32


def threefry2x32(key: Key, x0: Word, x1: Word) -> Key:
    """The Threefry-2x32 hash of the counter pair ``(x0, x1)``."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & U32
    x1 = (x1 + ks[1]) & U32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & U32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & U32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^63)."""
    return (seed >> 32) & U32, seed & U32


def fold_in(key: Key, data: Word) -> Key:
    """``jax.random.fold_in(key, data)``; ``data`` is taken as uint32."""
    return threefry2x32(key, 0, data & U32)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)`` (partitionable: fold-like)."""
    return tuple(threefry2x32(key, 0, i) for i in range(num))


def bits32(key: Key, idx: Word) -> Word:
    """``jax.random.bits(key, shape, uint32)`` at flat index ``idx``."""
    b0, b1 = threefry2x32(key, idx >> 32, idx & U32)
    return b0 ^ b1


def random_bits(key: Key, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor."""
    n = 1
    for d in shape:
        n *= int(d)
    return torch.as_tensor(bits32(key, torch.arange(n, dtype=torch.int64))).reshape(shape)


def _int32(v: Word) -> Word:
    """A uint32 word read as int32 (two's complement)."""
    return ((v + 0x80000000) & U32) - 0x80000000


class RandInt:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32), split in
    its per-key part (the two split keys, the span and the multiplier) and
    its per-element part (``at``)."""

    def __init__(self, key: Key, minval: int, maxval: int):
        self.k1, self.k2 = split(key)
        self.minval = minval
        span = (maxval - minval) & U32 if maxval > minval else 1
        mult = (1 << 16) % span
        self.span, self.mult = span, mul32(mult, mult) % span

    def at(self, idx: Word) -> Word:
        """The draw at flat index ``idx`` of the shape, as int32 values."""
        hi, lo = bits32(self.k1, idx), bits32(self.k2, idx)
        off = ((mul32(hi % self.span, self.mult) + lo % self.span) & U32) % self.span
        return _int32((self.minval + off) & U32)


def randint(key: Key, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` as int64 values."""
    n = 1
    for d in shape:
        n *= int(d)
    return torch.as_tensor(RandInt(key, minval, maxval).at(
        torch.arange(n, dtype=torch.int64))).reshape(shape)


def uniform_at(key: Key, idx: Word) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` at flat index ``idx``:
    the top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    b = torch.as_tensor(bits32(key, idx), dtype=torch.int64)
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: Key, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1))."""
    n = 1
    for d in shape:
        n *= int(d)
    return uniform_at(key, torch.arange(n, dtype=torch.int64)).reshape(shape)
