"""DiT positional / conditioning embeddings (port of ``repro/nn/layers.py``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.nn import initializers as init


def embedding_init(key, vocab, d, dtype=torch.float32, stddev=0.02):
    return {"emb": init.normal(stddev)(key, (vocab, d), dtype)}


def embedding_apply(p, ids):
    return p["emb"][ids]


def layernorm_apply(p, x, eps=1e-6):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if p:
        y = y * p["scale"] + p["bias"]
    return y


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
