"""Quantizer primitives — port of ``repro/core/quantizers.py``.

Fake-quant (quantize-dequantize) math plus the parameter containers the
range calibration produces and the artifact carries. Conventions as in
the reference: per-output-channel symmetric weights (``ChannelQ``),
per-tensor asymmetric activations (``UniformQ``), symmetric attention
operands (``SymQ``), the MRQ two-region quantizers for post-softmax
(``MRQSoftmaxQ``) and post-GELU (``MRQSignedQ``) tensors, and ``TGQ``
stacking any of them along a leading timestep-group axis.

Rounding is ``torch.round`` (half to even, as ``jnp.round``). Each
function promotes its input to the result type of the operation first,
as JAX does for a bf16 array meeting an f32 parameter.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


def _promote(x, *params):
    dt = x.dtype
    for p in params:
        if isinstance(p, torch.Tensor):
            dt = torch.promote_types(dt, p.dtype)
    return x.to(dt)


def uniform_qdq(x, scale, zero, bits: int):
    """Asymmetric affine: xhat = s*(clip(round(x/s)+z, 0, 2^k-1) - z)."""
    x = _promote(x, scale, zero)
    n = 2 ** bits - 1
    q = torch.clamp(torch.round(x / scale) + zero, 0, n)
    return scale * (q - zero)


def symmetric_qdq(x, scale, bits: int):
    """Symmetric signed: q in [-2^{k-1}, 2^{k-1}-1]."""
    x = _promote(x, scale)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return scale * torch.clamp(torch.round(x / scale), lo, hi)


def sym_act_qdq(x, scale, bits: int):
    """Symmetric activation quant-dequant over [-(2^{k-1}-1), 2^{k-1}-1]."""
    x = _promote(x, scale)
    hi = 2 ** (bits - 1) - 1
    return scale * torch.clamp(torch.round(x / scale), -hi, hi)


def mrq_softmax_qdq(x, s1, bits: int):
    """Two-region post-softmax quantizer: fine step s1 below 2^{k-1}s1,
    fixed coarse step s2 = 1/2^{k-1} above."""
    x = _promote(x, s1)
    half = 2 ** (bits - 1)
    s2 = 1.0 / half
    thr = half * s1
    q1 = torch.clamp(torch.round(x / s1), 0, half - 1) * s1
    q2 = torch.clamp(torch.round(x / s2), 0, half) * s2
    return torch.where(x < thr, q1, q2)


def mrq_signed_qdq(x, s_neg, s_pos, bits: int):
    """Two-region post-GELU quantizer: negative lobe step s_neg,
    positive lobe step s_pos."""
    x = _promote(x, s_neg, s_pos)
    half = 2 ** (bits - 1)
    qn = torch.clamp(torch.round(x / s_neg), -half, 0) * s_neg
    qp = torch.clamp(torch.round(x / s_pos), 0, half - 1) * s_pos
    return torch.where(x < 0, qn, qp)


@dataclasses.dataclass
class UniformQ:
    scale: Any
    zero: Any
    bits: int = 8

    def __call__(self, x):
        return uniform_qdq(x, self.scale, self.zero, self.bits)


@dataclasses.dataclass
class SymQ:
    scale: Any
    bits: int = 8

    def __call__(self, x):
        return sym_act_qdq(x, self.scale, self.bits)


@dataclasses.dataclass
class ChannelQ:
    scale: Any
    bits: int = 8
    axes: tuple = ()

    def __call__(self, w):
        return symmetric_qdq(w, self.scale, self.bits)


@dataclasses.dataclass
class MRQSoftmaxQ:
    s1: Any
    bits: int = 8

    def __call__(self, x):
        return mrq_softmax_qdq(x, self.s1, self.bits)


@dataclasses.dataclass
class MRQSignedQ:
    s_neg: Any
    s_pos: Any
    bits: int = 8

    def __call__(self, x):
        return mrq_signed_qdq(x, self.s_neg, self.s_pos, self.bits)


# array fields of each container (the rest are static metadata)
ARRAY_FIELDS = {UniformQ: ("scale", "zero"), SymQ: ("scale",),
                ChannelQ: ("scale",), MRQSoftmaxQ: ("s1",),
                MRQSignedQ: ("s_neg", "s_pos")}


@dataclasses.dataclass
class TGQ:
    """Time-grouped wrapper: ``inner`` holds a quantizer whose array
    fields are stacked (G, ...); ``select(g)`` takes group g, or gathers
    (B, ...) rows for a (B,) group tensor."""
    inner: Any

    def select(self, g):
        fields = ARRAY_FIELDS[type(self.inner)]
        if isinstance(g, torch.Tensor):
            g = g.long()
        return dataclasses.replace(
            self.inner, **{f: getattr(self.inner, f)[g] for f in fields})

    def __call__(self, x, g=None):
        q = self.inner if g is None else self.select(g)
        return q(x)


def apply_quantizer(q, x, tgroup=None):
    """Applies q to x, selecting the TGQ group.

    ``tgroup`` may be a per-slot (B,) tensor (the continuous-batching
    path): each stacked (G,) leaf gathers to (B,) and is reshaped to
    broadcast along x's leading batch axis, so slot b's rows take slot b's
    group — the fake-quant twin of the ``*_vec`` kernels' per-row
    gather."""
    if q is None:
        return x
    if isinstance(q, TGQ):
        if tgroup is None:
            tgroup = 0
        if isinstance(tgroup, torch.Tensor) and tgroup.ndim == 1:
            B = tgroup.shape[0]
            sel = q.select(tgroup)
            fields = ARRAY_FIELDS[type(sel)]
            return dataclasses.replace(sel, **{
                f: getattr(sel, f).reshape((B,) + (1,) * (x.ndim - 1))
                for f in fields})(x)
        return q(x, int(tgroup))
    return q(x)


# ---------------------------------------------------------------------------
# calibration helpers: closed-form params from ranges
# ---------------------------------------------------------------------------
def uniform_params_from_range(lo, hi, bits: int):
    """(scale, zero) covering [lo, hi] (f32 tensors)."""
    lo = torch.minimum(lo, torch.zeros_like(lo))
    hi = torch.maximum(hi, torch.zeros_like(hi))
    scale = torch.clamp((hi - lo) / (2 ** bits - 1), min=1e-8)
    zero = torch.round(-lo / scale)
    return scale, zero


def channel_scale_from_absmax(absmax, bits: int):
    return torch.clamp(absmax / (2 ** (bits - 1) - 1), min=1e-8)


def sym_scale_from_absmax(absmax, bits: int):
    return torch.clamp(absmax.float() / (2 ** (bits - 1) - 1), min=1e-8)


def weight_absmax(w, channel_axis: int = -1):
    """Per-output-channel absmax, keepdims."""
    axes = tuple(i for i in range(w.ndim) if i != channel_axis % w.ndim)
    return torch.amax(torch.abs(w), dim=axes, keepdim=True)
