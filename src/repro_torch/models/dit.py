"""Diffusion Transformer (DiT) with adaLN-Zero — port of ``repro/models/dit.py``.

Parameters are a nested dict of tensors in the reference's layout: linear
weights (K, N), block parameters stacked along a leading layer axis,
latents (B, H, W, C). Every quantization-relevant op routes through the
op context, so the same forward serves fp, fake-quant and the kernels.
"""
from __future__ import annotations

import dataclasses
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.diffusion import rng
from repro_torch.nn import initializers as init
from repro_torch.nn.ctx import FPContext
from repro_torch.nn.layers import (embedding_apply, embedding_init,
                                   sincos_2d, timestep_embedding)
from repro_torch.nn.tree import (  # noqa: F401  (re-exported)
    map_tree, params_from_numpy, stack_trees,
)

_FP = FPContext()
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class DiTCfg:
    img_size: int = 32            # latent spatial size
    in_ch: int = 4                # latent channels
    patch: int = 2
    d_model: int = 1152
    n_layers: int = 28
    n_heads: int = 16
    mlp_ratio: float = 4.0
    n_classes: int = 1000
    dtype: str = "float32"
    scan_layers: bool = False
    remat: bool = False
    class_dropout: float = 0.1

    @property
    def tdtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def n_tokens(self):
        return (self.img_size // self.patch) ** 2

    @property
    def d_ff(self):
        return int(self.d_model * self.mlp_ratio)

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def patch_dim(self):
        return self.patch * self.patch * self.in_ch


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def dit_init(seed: int, cfg: DiTCfg, device=None):
    """Initialised parameters drawn from a seeded ``torch.Generator``
    (normal(0.02) weights, zero biases; ``ada``, ``final_ada`` and
    ``final`` zero-initialised as adaLN-Zero prescribes). Not the
    reference's draws: ``dit_init_from_key`` replays those."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    d, f, L, dt = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.tdtype

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dt)

    def z(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    grid = cfg.img_size // cfg.patch
    return {
        "x_proj": {"w": w(cfg.patch_dim, d), "b": z(d)},
        "pos": torch.from_numpy(sincos_2d(d, grid, grid)).to(dev, dt),
        "t_mlp1": {"w": w(256, d), "b": z(d)},
        "t_mlp2": {"w": w(d, d), "b": z(d)},
        "y_embed": {"emb": w(cfg.n_classes + 1, d)},
        "blocks": {
            "qkv": {"w": w(L, d, 3 * d), "b": z(L, 3 * d)},
            "proj": {"w": w(L, d, d), "b": z(L, d)},
            "fc1": {"w": w(L, d, f), "b": z(L, f)},
            "fc2": {"w": w(L, f, d), "b": z(L, d)},
            "ada": {"w": z(L, d, 6 * d), "b": z(L, 6 * d)},
        },
        "final_ada": {"w": z(d, 2 * d), "b": z(2 * d)},
        "final": {"w": z(d, cfg.patch_dim), "b": z(cfg.patch_dim)},
    }


def _block_init(key, cfg: DiTCfg):
    ks = rng.split(key, 7)
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.tdtype
    w = init.normal(0.02)
    z = lambda *shape: torch.zeros(shape, dtype=dt, device=key.device)
    return {
        "qkv": {"w": w(ks[0], (d, 3 * d), dt), "b": z(3 * d)},
        "proj": {"w": w(ks[1], (d, d), dt), "b": z(d)},
        "fc1": {"w": w(ks[2], (d, f), dt), "b": z(f)},
        "fc2": {"w": w(ks[3], (f, d), dt), "b": z(d)},
        # adaLN-Zero: each residual branch starts as identity (DiT §3.2)
        "ada": {"w": z(d, 6 * d), "b": z(6 * d)},
    }


def dit_init_from_key(key, cfg: DiTCfg, device=None):
    """``repro.models.dit.dit_init(key, cfg)``'s parameters from the same
    threefry key (``rng.PRNGKey(seed)``): ``split(key, 8)``, the layer
    keys ``split(ks[0], n_layers)``, ``split(k, 7)`` in each block and
    the blocks stacked on a leading axis, as ``jax.vmap`` stacks them.
    Uniform draws and zeros equal the reference's bit for bit, normals
    within ``rng.normal``'s few ulps."""
    dev = resolve_device(device)
    ks = rng.split(key.to(dev), 8)
    d, dt = cfg.d_model, cfg.tdtype
    w = init.normal(0.02)
    z = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)
    blocks = [_block_init(k, cfg) for k in rng.split(ks[0], cfg.n_layers)]
    grid = cfg.img_size // cfg.patch
    return {
        "x_proj": {"w": w(ks[1], (cfg.patch_dim, d), dt), "b": z(d)},
        "pos": torch.from_numpy(sincos_2d(d, grid, grid)).to(dev, dt),
        "t_mlp1": {"w": w(ks[2], (256, d), dt), "b": z(d)},
        "t_mlp2": {"w": w(ks[3], (d, d), dt), "b": z(d)},
        "y_embed": embedding_init(ks[4], cfg.n_classes + 1, d, dt),
        "blocks": stack_trees(blocks),
        "final_ada": {"w": z(d, 2 * d), "b": z(2 * d)},
        "final": {"w": z(d, cfg.patch_dim), "b": z(cfg.patch_dim)},
    }


# ---------------------------------------------------------------------------
# patchify
# ---------------------------------------------------------------------------
def patchify(x, patch):
    """(B,H,W,C) -> (B, (H/p)*(W/p), p*p*C)"""
    B, H, W, C = x.shape
    p = patch
    x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def unpatchify(x, patch, img_size, ch):
    B = x.shape[0]
    p, g = patch, img_size // patch
    x = x.reshape(B, g, g, p, p, ch).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, img_size, img_size, ch)


# ---------------------------------------------------------------------------
# block + forward
# ---------------------------------------------------------------------------
def dit_block_apply(p, cfg: DiTCfg, x, c, *, ctx=_FP, name="blk"):
    """x: (B,N,d); c: (B,d). adaLN-Zero MHSA + MLP; the norm-modulate
    and gate+residual chains ride the ``ctx.linear`` fusion seams."""
    B, N, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    mod = ctx.linear(f"{name}/ada", F.silu(c), p["ada"]["w"], p["ada"]["b"])
    sh1, sc1, g1, sh2, sc2, g2 = torch.chunk(mod, 6, dim=-1)

    qkv = ctx.linear(f"{name}/qkv", x, p["qkv"]["w"], p["qkv"]["b"],
                     norm_mod=(sh1, sc1))
    qkv = qkv.reshape(B, N, 3, H, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]      # (B,N,H,hd)
    o = ctx.attention(f"{name}/attn", q.reshape(B, N, H, 1, hd), k, v,
                      scale=hd ** -0.5)
    x = ctx.linear(f"{name}/proj", o.reshape(B, N, d), p["proj"]["w"],
                   p["proj"]["b"], gate_residual=(g1, x))

    h = ctx.linear(f"{name}/fc1", x, p["fc1"]["w"], p["fc1"]["b"],
                   norm_mod=(sh2, sc2))
    h = F.gelu(h, approximate="tanh")
    h = ctx.act(f"{name}/gelu", h, "post_gelu")
    return ctx.linear(f"{name}/fc2", h, p["fc2"]["w"], p["fc2"]["b"],
                      gate_residual=(g2, x))


def dit_apply(p, cfg: DiTCfg, x, t, y, *, ctx=_FP):
    """Noise prediction. x: (B,H,W,C) latents; t: (B,) int timesteps;
    y: (B,) int class labels (cfg.n_classes = the null/uncond row)."""
    dt = cfg.tdtype
    tok = patchify(x.to(dt), cfg.patch)
    h = ctx.linear("x_proj", tok, p["x_proj"]["w"], p["x_proj"]["b"])
    h = h + p["pos"][None]

    temb = timestep_embedding(t, 256).to(dt)
    temb = ctx.linear("t_mlp1", temb, p["t_mlp1"]["w"], p["t_mlp1"]["b"])
    temb = F.silu(temb)
    temb = ctx.linear("t_mlp2", temb, p["t_mlp2"]["w"], p["t_mlp2"]["b"])
    yemb = embedding_apply(p["y_embed"], y).to(dt)
    c = temb + yemb

    # one view a layer (unbind: the backward stacks the layers' gradients
    # once); with cfg.remat each block's activations are recomputed in the
    # backward, as the reference's jax.checkpoint(body)
    layers = map_tree(lambda a: a.unbind(0), p["blocks"])
    for i in range(cfg.n_layers):
        bp = map_tree(lambda a: a[i], layers)
        lctx, name = ctx.at_layer(i), f"blk{i}"
        if cfg.remat:
            h = checkpoint(lambda bp, h, c, lctx=lctx, name=name:
                           dit_block_apply(bp, cfg, h, c, ctx=lctx,
                                           name=name),
                           bp, h, c, use_reentrant=False)
        else:
            h = dit_block_apply(bp, cfg, h, c, ctx=lctx, name=name)

    mod = ctx.linear("final_ada", F.silu(c), p["final_ada"]["w"],
                     p["final_ada"]["b"])
    sh, sc = torch.chunk(mod, 2, dim=-1)
    out = ctx.linear("final", h, p["final"]["w"], p["final"]["b"],
                     norm_mod=(sh, sc))
    return unpatchify(out, cfg.patch, cfg.img_size, cfg.in_ch)


def dit_apply_cfg_guidance(p, cfg: DiTCfg, x, t, y, scale, *, ctx=_FP):
    """Classifier-free guidance: eps = eps_u + s * (eps_c - eps_u), from
    one 2B forward (the conditional half on the null class
    ``cfg.n_classes``'s)."""
    null = torch.full_like(y, cfg.n_classes)
    eps = dit_apply(p, cfg, torch.cat([x, x]), torch.cat([t, t]),
                    torch.cat([y, null]), ctx=ctx)
    eps_c, eps_u = torch.chunk(eps, 2)
    return eps_u + scale * (eps_c - eps_u)
