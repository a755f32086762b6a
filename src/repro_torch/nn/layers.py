"""Core layers — port of ``repro/nn/layers.py``: linear, embedding, the
norms, RoPE and the DiT positional / conditioning embeddings.

The bf16 rounding order is the reference's: ``rmsnorm_apply`` takes the
variance in f32 and casts the ``rsqrt`` to x's dtype before the two
products; ``rope_apply`` casts cos / sin to x's dtype before its
products; ``rope_freqs`` is float32 numpy."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.nn import initializers as init
from repro_torch.nn.ctx import FPContext

_FP = FPContext()


# --------------------------------------------------------------------------
# Linear / Embedding
# --------------------------------------------------------------------------
def linear_init(key, d_in, d_out, bias=True, dtype=torch.float32,
                w_init=None):
    w_init = w_init or init.normal(0.02)
    p = {"w": w_init(key, (d_in, d_out), dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=key.device)
    return p


def linear_apply(p, x, ctx=_FP, name="linear"):
    return ctx.linear(name, x, p["w"], p.get("b"))


def embedding_init(key, vocab, d, dtype=torch.float32, stddev=0.02):
    return {"emb": init.normal(stddev)(key, (vocab, d), dtype)}


def embedding_apply(p, ids):
    return p["emb"][ids]


def embedding_logits(p, x, ctx=_FP, name="lm_head"):
    """Tied-embedding output projection: the weight is the (d, vocab)
    transposed view of the embedding, not a copy."""
    return ctx.linear(name, x, p["emb"].T)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def layernorm_init(key, d, dtype=torch.float32, affine=True):
    if not affine:
        return {}
    return {"scale": torch.ones((d,), dtype=dtype, device=key.device),
            "bias": torch.zeros((d,), dtype=dtype, device=key.device)}


def layernorm_apply(p, x, eps=1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if p:
        y = y * p["scale"] + p["bias"]
    return y


def rmsnorm_init(key, d, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype, device=key.device)}


def rmsnorm_apply(p, x, eps=1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["scale"]


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------
def rope_freqs(head_dim, theta=10000.0) -> np.ndarray:
    """Inverse frequencies for RoPE; shape (head_dim//2,) float32."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def rope_apply(x, positions, inv_freq):
    """Rotary embedding, the split-half (GPT-NeoX / llama) convention.

    x: (..., S, n_heads, head_dim); positions: (..., S) integers;
    inv_freq: ``rope_freqs``' float32 array."""
    inv = torch.as_tensor(inv_freq, dtype=torch.float32, device=x.device)
    ang = positions[..., :, None].float() * inv             # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :].to(x.dtype)
    sin = torch.sin(ang)[..., :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# --------------------------------------------------------------------------
# DiT positional / conditioning embeddings
# --------------------------------------------------------------------------
def sincos_2d(d, grid_h, grid_w) -> np.ndarray:
    """Fixed 2D sin-cos positional embedding, (grid_h*grid_w, d) float32
    (computed in float64 numpy, exactly as the reference)."""
    assert d % 4 == 0

    def _1d(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64)
                                / (dim / 2.0))
        out = np.einsum("p,f->pf", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)
    gh = np.arange(grid_h, dtype=np.float64)
    gw = np.arange(grid_w, dtype=np.float64)
    eh = _1d(d // 2, np.repeat(gh, grid_w))
    ew = _1d(d // 2, np.tile(gw, grid_h))
    return np.concatenate([eh, ew], axis=1).astype(np.float32)


def timestep_embedding(t, d, max_period=10000.0):
    """DDPM sinusoidal timestep embedding. t: (B,) -> (B, d) float32."""
    half = d // 2
    freqs = torch.exp(-float(np.log(max_period))
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    if d % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
