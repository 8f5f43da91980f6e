"""Counter-based random numbers that reproduce ``jax.random`` bit for bit.

The strength sweeps draw their start vectors with
``jax.random.uniform(PRNGKey(seed), shape, -0.5, 0.5)``; strengths, and so
aggregates, depend on every bit of that draw. This module recomputes it:
Threefry-2x32 (20 rounds, key schedule with the 0x1BD11BDA parity
constant) over the flat element counter split into (high, low) 32-bit
words — JAX's ``jax_threefry_partitionable=True`` bit layout, its default
since 0.5 — then the two output words xor-ed into 32 random bits, whose
top 23 become the mantissa of a float in [1, 2).

uint32 arithmetic is done in int64 with ``& 0xFFFFFFFF`` masks (torch has
no ``>>`` on uint32). ``normal`` follows ``jax.random.normal``
(``√2·erfinv`` of a uniform draw on (-1, 1)); torch's ``erfinv`` may differ
from XLA's in the last bits, which only the λmax estimate sees.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: tuple[int, int], x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words (x0, x1), int64 in [0, 2^32)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """The two key words of ``jax.random.PRNGKey(seed)``."""
    seed = int(seed)
    return (seed >> 32) & _M32, seed & _M32


def random_bits(seed: int, shape, device) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2^32)), as
    ``jax.random.bits(PRNGKey(seed), shape)``."""
    count = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(prng_key(seed), count >> 32, count & _M32)
    return (b0 ^ b1).reshape(shape)


def uniform(seed: int, shape, minval: float, maxval: float,
            device) -> torch.Tensor:
    """float32 ``jax.random.uniform(PRNGKey(seed), shape, minval=,
    maxval=)``, bit for bit."""
    bits = random_bits(seed, shape, device)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    # filled on the device: a copy of a host value would make it wait
    lo = torch.full((), minval, dtype=torch.float32, device=device)
    hi = torch.full((), maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def normal(seed: int, shape, device) -> torch.Tensor:
    """float32 ``jax.random.normal(PRNGKey(seed), shape)`` up to the last
    bits of ``erfinv``."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(seed, shape, lo, 1.0, device)
    return math.sqrt(2) * torch.erfinv(u)
