"""JAX's default random numbers in torch tensor arithmetic.

The port draws what the JAX package draws wherever a number must be the
same in both: the serving streams' Gumbel noise (``serve/sampling.py``) and
PowerSGD's initial ``q`` (``kernel/compressor.py``). JAX's default PRNG is
Threefry-2x32 (20 rounds) in its partitionable form; this module computes
its uint32 bits in ``int64`` tensors masked to 32 bits, so no ``uint32``
shift or rotate support is needed on any device, and maps them to floats
as ``jax.random`` does:

- :func:`prng_key`: ``jax.random.PRNGKey(seed)``, the key ``(0, seed)``
  under JAX's default 32-bit types;
- :func:`threefry2x32`, :func:`fold_in`, :func:`random_bits`: the hash,
  ``jax.random.fold_in`` and ``jax.random.bits``, bit for bit;
- :func:`uniform`: ``jax.random.uniform`` for float32, the top 23 bits as
  a mantissa under exponent 0, then scaled into ``[minval, maxval)``;
- :func:`normal`: ``jax.random.normal`` for float32, ``sqrt(2) *
  erfinv(u)`` for ``u`` uniform over the open interval ``(-1, 1)``.

The bits and the uniform floats are JAX's exactly; the floats of
:func:`normal` are within a few ulps of JAX's (XLA's erfinv polynomial, in
another order of fused operations).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counters ``(x1, x2)`` under
    key ``(k1, k2)``: ``int64`` tensors holding uint32 values, broadcast
    together; returns two such tensors. Every add is masked to 32 bits, so
    the results are JAX's ``threefry2x32_p`` bits exactly."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` under JAX's default 32-bit types: the
    raw threefry key ``(0, seed mod 2^32)``. A seed outside
    ``[-2^31, 2^32)`` raises, as JAX's conversion to int32 would not keep
    it."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} does not fit JAX's 32-bit seed")
    return 0, seed & _M32


def fold_in(key_hi, key_lo, data):
    """``jax.random.fold_in`` on raw threefry keys: the new key is the hash
    of the counter pair ``(0, data)`` (``threefry_seed`` of a uint32 puts
    it in the low word). All arguments are ``int64`` tensors of uint32
    values, broadcast; returns the new ``(hi, lo)``."""
    return threefry2x32(key_hi, key_lo, torch.zeros_like(data), data & _M32)


def random_bits(key_hi, key_lo, n: int):
    """``jax.random.bits(key, (n,))`` under the partitionable threefry
    (JAX's default): counters are the 64-bit iota split into a high word (0
    below 2^32) and a low word, and the 32-bit result is the xor of the two
    hash words. ``key_*`` are ``int64 [...]``; returns ``int64 [..., n]``
    holding uint32 values. A shape's bits are the flat count's, reshaped
    row-major."""
    lo = torch.arange(n, dtype=torch.int64, device=key_hi.device)
    b1, b2 = threefry2x32(key_hi[..., None], key_lo[..., None], torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` on the
    CPU: the top 23 bits of each word as the mantissa of a float in
    ``[1, 2)``, minus 1, scaled by ``maxval - minval`` and shifted by
    ``minval`` (each step in fp32, as JAX computes it), and held at
    ``minval`` from below."""
    shape = tuple(int(s) for s in shape)
    hi, lo = (torch.tensor(int(k), dtype=torch.int64) for k in key)
    bits = random_bits(hi, lo, math.prod(shape)).reshape(shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo_t, hi_t = torch.tensor(minval), torch.tensor(maxval)
    return torch.maximum(lo_t, floats * (hi_t - lo_t) + lo_t)


# XLA's float32 erfinv (M. Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w - 2.5 below w = 5, in sqrt(w) - 3 above, where
# w = -log1p(-x^2).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (the polynomial above), which
    ``jax.random.normal`` calls; ``torch.erfinv`` computes another
    approximation, tens of ulps apart in the tails."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coeff(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], device=x.device),
                           torch.tensor(_ERFINV_GE5[i], device=x.device))

    p = coeff(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coeff(i) + p * w
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max, p * x)


def normal(key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on the CPU: ``sqrt(2) *
    erfinv(u)`` for ``u`` uniform in ``(nextafter(-1, inf), 1)``, with XLA's
    erfinv."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(math.inf)).item()
    return torch.tensor(math.sqrt(2.0)) * erfinv32(uniform(key, shape, lo, 1.0))


__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits", "uniform", "erfinv32",
           "normal"]
