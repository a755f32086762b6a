"""Op context — the seam between the model and the PTQ engine.

Port of ``repro/nn/ctx.py``. The model routes every matmul-like op and
every quantization-relevant activation through an :class:`OpContext`:
``linear`` (activation x weight, with the optional adaLN ``norm_mod`` /
``gate_residual`` fusion seams), ``einsum`` (activation x activation),
``act`` (identity hook marking post-softmax / post-GELU tensors) and
``attention`` (the whole QK^T -> softmax -> P·V block; the default
composes the three finer seams so calibration contexts see
``{name}/qk``, ``{name}/probs`` and ``{name}/pv``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

NEG_INF = -1e9          # additive mask value for attention scores


def apply_norm_mod(x, norm_mod, eps: float = 1e-6):
    """adaLN norm-modulate: non-affine layernorm (mean, biased var,
    ``rsqrt(var + eps)``) then ``y * (1 + scale) + shift`` with per-batch
    (B, K) rows broadcast over x's middle axes."""
    if norm_mod is None:
        return x
    shift, scale = norm_mod
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    bshape = (shift.shape[0],) + (1,) * (x.ndim - 2) + (shift.shape[-1],)
    return y * (1.0 + scale.reshape(bshape)) + shift.reshape(bshape)


def apply_gate_residual(y, gate_residual):
    """adaLN gate + residual: ``residual + gate * y`` (gate (B, N) rows)."""
    if gate_residual is None:
        return y
    gate, res = gate_residual
    bshape = (gate.shape[0],) + (1,) * (y.ndim - 2) + (gate.shape[-1],)
    return res + gate.reshape(bshape) * y


@dataclasses.dataclass
class OpContext:
    """Base class. ``tgroup`` is the TGQ timestep-group index (a python
    int, or None outside diffusion); ``layer`` the current layer index."""

    tgroup: Optional[Any] = None
    layer: Optional[Any] = None

    def at_layer(self, layer) -> "OpContext":
        return dataclasses.replace(self, layer=layer)

    def with_tgroup(self, tgroup) -> "OpContext":
        return dataclasses.replace(self, tgroup=tgroup)

    def linear(self, name: str, x, w, b=None, norm_mod=None,
               gate_residual=None):
        raise NotImplementedError

    def einsum(self, name: str, spec: str, a, b, b_is_weight: bool = False):
        raise NotImplementedError

    def act(self, name: str, x, kind: str):
        raise NotImplementedError

    def attention(self, name: str, q, k, v, *, mask=None, scale=1.0):
        """q: (B, Sq, Hk, G, hd); k, v: (B, Skv, Hk, hd); mask
        broadcastable to (B, Hk, G, Sq, Skv) boolean or None. Returns
        (B, Sq, Hk, G, hd)."""
        scores = self.einsum(f"{name}/qk", "bqhgd,bkhd->bhgqk", q, k) * scale
        if mask is not None:
            scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        probs = self.act(f"{name}/probs", probs, "post_softmax")
        return self.einsum(f"{name}/pv", "bhgqk,bkhd->bqhgd", probs, v)


@dataclasses.dataclass
class FPContext(OpContext):
    """Full-precision passthrough."""

    def linear(self, name, x, w, b=None, norm_mod=None, gate_residual=None):
        x = apply_norm_mod(x, norm_mod)
        y = x @ w
        if b is not None:
            y = y + b
        return apply_gate_residual(y, gate_residual)

    def einsum(self, name, spec, a, b, b_is_weight=False):
        return torch.einsum(spec, a, b)

    def act(self, name, x, kind):
        return x
