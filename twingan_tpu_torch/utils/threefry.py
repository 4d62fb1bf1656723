"""The JAX PRNG's threefry2x32 and its uniform floats, in numpy.

``GanTrainer``'s conditional-label lookup is a fixed random matrix that the
JAX package draws with ``jax.random.uniform(jax.random.PRNGKey(seed),
shape)`` and regenerates from the config rather than checkpointing it. A
state bridged from the JAX package must train against the same matrix, and
the port imports no JAX, so this module reproduces that draw bit for bit:

- ``PRNGKey(seed)``: the key (seed >> 32, seed & 0xffffffff) as uint32;
- the counters of the partitionable layout (``jax_threefry_partitionable``,
  JAX's default since 0.5): each element's flat row-major index as a
  64-bit number split into (high, low) 32-bit words;
- Threefry-2x32 with 20 rounds over them, the two output words XORed;
- ``uniform``: the top 23 bits as the mantissa of a float in [1, 2), minus
  1, floored at 0.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray) -> tuple:
    """The Threefry-2x32 hash of the counter pairs (x0, x1) under ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a non-negative integer seed."""
    seed = int(seed)
    if seed < 0:
        raise ValueError("prng_key takes a non-negative seed")
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def random_bits(key: tuple[int, int], shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element of ``shape``, as ``jax.random.bits``."""
    index = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    hi = (index >> np.uint64(32)).astype(np.uint32)
    lo = (index & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key: tuple[int, int], shape: tuple[int, ...]) -> np.ndarray:
    """fp32 draws in [0, 1), as ``jax.random.uniform(key, shape)``."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(32 - 23)) | one).view(np.float32) - np.float32(1.0)
    return np.maximum(np.float32(0.0), floats)
