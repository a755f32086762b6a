"""Threefry-2x32 counter-based random numbers in torch integer ops.

Reproduces ``jax.random`` under its default ``jax_threefry_partitionable
= True`` so a request's noise is the reference's
``normal(fold_in(PRNGKey(seed), i))`` bit for bit (the uint32 draws and
``randint``) and closely (the normals: ``erfinv`` is computed differently
by torch and XLA, most ulps apart near |u| = 0.94, where torch's CPU
float32 erfinv is 833 ulps off the float64 value and XLA's 91). Keys
are int64 tensors of shape (..., 2) holding uint32 words; everything
runs on whatever device the key lives on, and nothing copies between
host and device once the key (and any counter tensor) is there.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key words (k1, k2); all int64 tensors of uint32 values, broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    x1 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def PRNGKey(seed, device=None):
    """Key(s) from integer seed(s): [seed >> 32, seed & 0xFFFFFFFF] (a
    32-bit seed has a zero high word). ``seed`` may be an int, a 1-D
    integer array, or an integer tensor (kept on its device); returns
    (2,) or (B, 2)."""
    if isinstance(seed, torch.Tensor):
        s = seed.to(torch.int64)
    else:
        s = torch.as_tensor(np.asarray(seed, dtype=np.int64), device=device)
    return torch.stack([(s >> 32) & _M32, s & _M32], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in``: hash the counter pair (0, data)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    b1, b2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def split(key, num: int = 2):
    """``jax.random.split`` of one (2,) key -> (num, 2)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], i >> 32, i & _M32)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key, shape):
    """uint32 draws (as int64) of ``shape`` per key: key (..., 2) ->
    (..., *shape). The counter of element j is the 64-bit iota j."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    k1, k2 = key[..., 0:1], key[..., 1:2]
    b1, b2 = threefry2x32(k1, k2, i >> 32, i & _M32)
    return (b1 ^ b2).reshape(tuple(key.shape[:-1]) + tuple(shape))


def uniform(key, shape, minval, maxval):
    """float32 uniform in [minval, maxval) from the top 23 bits, as
    ``jax.random.uniform``. XLA fuses its ``floats * span + minval`` into
    one FMA, rounded once: where ``span`` is a power of two (``normal``'s
    2.0) the product is exact and the float32 add rounds once too;
    otherwise the product and the sum are exact in float64 (under 50
    significant bits), so one rounding to float32 gives the FMA's value."""
    bits = random_bits(key, shape)
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fb.view(torch.float32) - 1.0
    # f32 bounds as host scalars so no value is copied to the device
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    if math.frexp(span)[0] == 0.5:
        return torch.clamp(floats * span + lo, min=lo)
    return torch.clamp((floats.double() * span + lo).float(), min=lo)


_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key, shape):
    """float32 standard normals, ``sqrt(2) * erfinv(u)`` with u uniform in
    (-1, 1) — ``jax.random.normal``'s construction."""
    u = uniform(key, shape, _LO, 1.0)
    return torch.erfinv(u) * _SQRT2


def _mul32(a, b: int):
    """``a * b`` modulo 2^32 for a tensor ``a`` and an int ``b``, both
    uint32 values, without leaving int64's range."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def randint(key, shape, minval: int, maxval: int):
    """int32 draws in [minval, maxval), ``jax.random.randint``'s
    construction bit for bit: 32 high and 32 low bits from the two halves
    of ``split(key)``, reduced modulo the span as
    ``((hi % span) * (2^32 % span) + lo % span) % span`` in uint32
    arithmetic (every product and sum wraps). ``maxval <= minval`` gives
    ``minval``. Returns an int64 tensor of int32 values on the key's
    device."""
    minval, maxval = int(minval), int(maxval)
    if not (-2 ** 31 <= minval < 2 ** 31 and -2 ** 31 <= maxval < 2 ** 31):
        raise ValueError(f"randint bounds [{minval}, {maxval}) leave int32")
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & _M32) % span
    offset = ((_mul32(hi % span, mult) + lo % span) & _M32) % span
    return offset + minval


def truncated_normal(key, lower: float, upper: float, shape):
    """float32 normals truncated to (lower, upper), as
    ``jax.random.truncated_normal``: u uniform between ``erf(lower/√2)``
    and ``erf(upper/√2)`` (float32), ``√2 · erfinv(u)``, clipped to the
    open interval."""
    sqrt2 = torch.tensor(_SQRT2, dtype=torch.float32)
    lo = torch.tensor(lower, dtype=torch.float32)
    up = torch.tensor(upper, dtype=torch.float32)
    a, b = torch.erf(lo / sqrt2), torch.erf(up / sqrt2)
    u = uniform(key, shape, float(a), float(b))
    inf = torch.tensor(float("inf"))
    return torch.clamp(torch.erfinv(u) * _SQRT2,
                       float(torch.nextafter(lo, inf)),
                       float(torch.nextafter(up, -inf)))


_TINY = float(np.finfo(np.float32).tiny)


def gumbel(key, shape):
    """float32 standard Gumbel draws, ``jax.random.gumbel``'s default
    ("low") construction: ``-log(-log(u))`` with u uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key, logits, axis: int = -1):
    """``jax.random.categorical(key, logits, axis)`` (with replacement):
    ``argmax(logits + gumbel(key, logits.shape))`` along ``axis``, in
    float32 (bf16 logits are widened first). Returns int64 indices."""
    lg = logits.float()
    return torch.argmax(gumbel(key, tuple(lg.shape)) + lg, dim=axis)
