"""Attention layers — port of the GQA part of ``repro/nn/attention.py``
(plain / q-chunked / windowed / meta tokens / cross, prefill and decode).

Every quantization-relevant matmul routes through the op context:
``{name}/{q,k,v,o}`` (the projections) on ``ctx.linear``, and the whole
QK^T -> softmax -> P·V block on ``ctx.attention`` (the default composes
the ``{name}/qk`` einsum, the post-softmax act hook and the ``{name}/pv``
einsum; ``QuantContext(kernel=True)`` lowers it onto the flash kernel B3,
mask included). q is laid out (B, S, Hk, G, hd): query head h reads kv
head h // G.

The decode cache is written in place: ``attention_decode`` stores the new
token's k and v at their slot of the caller's preallocated (B, size, Hk,
hd) buffers (a ring buffer when windowed) and returns those buffers, so
no step reallocates the cache; ``index`` is a python int.

``MLACfg`` comes over as data; the MLA layer (``mla_*``) waits for
ROADMAP queue 1, item 8(d), and cross-attention decode
(``cross_attention_cache`` / ``_decode``) for item 8(c). A set
``sp_spec`` (a sequence-parallel sharding constraint) raises, naming item
9.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.diffusion import rng
from repro_torch.nn import initializers as init
from repro_torch.nn.ctx import FPContext
from repro_torch.nn.layers import (linear_init, rmsnorm_apply, rmsnorm_init,
                                   rope_apply, rope_freqs)

_FP = FPContext()
ENCDEC_ITEM = "ROADMAP queue 1, item 8(c) (encoder-decoder)"
MLA_ITEM = "ROADMAP queue 1, item 8(d) (MoE and MLA)"
SP_ITEM = "ROADMAP queue 1, item 9 (multi-GPU)"


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    window: Optional[int] = None        # sliding-window size (None = global)
    q_chunk: int = 512                  # q-tile for the chunked impl
    out_bias: bool = False
    n_meta: int = 0                     # learnable prefix (meta) tokens
    sp_spec: Optional[tuple] = None     # sequence-parallel sharding


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def attention_init(key, cfg: AttnCfg, dtype=torch.float32):
    ks = rng.split(key, 7)
    H, Hk, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    p = {
        "q": linear_init(ks[0], d, H * hd, bias=cfg.qkv_bias, dtype=dtype),
        "k": linear_init(ks[1], d, Hk * hd, bias=cfg.qkv_bias, dtype=dtype),
        "v": linear_init(ks[2], d, Hk * hd, bias=cfg.qkv_bias, dtype=dtype),
        "o": linear_init(ks[3], H * hd, d, bias=cfg.out_bias, dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(ks[4], hd, dtype)
        p["k_norm"] = rmsnorm_init(ks[5], hd, dtype)
    if cfg.n_meta:
        p["meta"] = init.normal(0.02)(ks[6], (cfg.n_meta, d), dtype)
    return p


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
_INV_FREQ: dict = {}


def _inv_freq(head_dim, theta, device):
    """``rope_freqs`` as a float32 tensor, made once per device."""
    key = (head_dim, float(theta), str(device))
    t = _INV_FREQ.get(key)
    if t is None:
        t = _INV_FREQ[key] = torch.from_numpy(
            rope_freqs(head_dim, theta)).to(device)
    return t


def _project_qkv(p, cfg, x, kv_x, positions, kv_positions, ctx, name):
    """Project and shape q (B,S,Hk,G,hd), k and v (B,Skv,Hk,hd); qk-norm
    before RoPE."""
    B, S, _ = x.shape
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Hk
    q = ctx.linear(f"{name}/q", x, p["q"]["w"], p["q"].get("b"))
    k = ctx.linear(f"{name}/k", kv_x, p["k"]["w"], p["k"].get("b"))
    v = ctx.linear(f"{name}/v", kv_x, p["v"]["w"], p["v"].get("b"))
    q = q.reshape(B, S, Hk * G, hd)
    k = k.reshape(B, kv_x.shape[1], Hk, hd)
    v = v.reshape(B, kv_x.shape[1], Hk, hd)
    if cfg.qk_norm:
        q = rmsnorm_apply(p["q_norm"], q)
        k = rmsnorm_apply(p["k_norm"], k)
    if cfg.rope:
        inv = _inv_freq(hd, cfg.rope_theta, x.device)
        q = rope_apply(q, positions, inv)
        k = rope_apply(k, kv_positions, inv)
    q = q.reshape(B, S, Hk, G, hd)
    return q, k, v


def _sdpa(q, k, v, mask, ctx, name, scale):
    """Grouped scaled-dot-product attention on the context's ``attention``
    seam. q: (B,Sq,Hk,G,hd); k, v: (B,Skv,Hk,hd); mask broadcastable to
    (B,Hk,G,Sq,Skv) boolean (True = attend) or None."""
    return ctx.attention(name, q, k, v, mask=mask, scale=scale)


def _causal_mask(q_pos, k_pos, window=None):
    """(..., Sq, Skv) boolean mask from absolute positions."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    return m


def _meta_kv(p, cfg, B, dtype, ctx, name):
    """The learnable meta tokens' k and v (B, n_meta, Hk, hd)."""
    Hk, hd = cfg.n_kv_heads, cfg.head_dim
    meta = p["meta"].expand(B, cfg.n_meta, cfg.d_model).to(dtype)
    mk = ctx.linear(f"{name}/k", meta, p["k"]["w"], p["k"].get("b"))
    mv = ctx.linear(f"{name}/v", meta, p["v"]["w"], p["v"].get("b"))
    mk = mk.reshape(B, cfg.n_meta, Hk, hd)
    mv = mv.reshape(B, cfg.n_meta, Hk, hd)
    if cfg.qk_norm:
        mk = rmsnorm_apply(p["k_norm"], mk)
    return mk, mv


def _no_sp(cfg):
    if cfg.sp_spec is not None:
        raise NotImplementedError(
            f"AttnCfg.sp_spec={cfg.sp_spec}: sequence-parallel attention is "
            f"a sharding constraint across devices, {SP_ITEM}")


# --------------------------------------------------------------------------
# forward (train / prefill) — plain and q-chunked
# --------------------------------------------------------------------------
_UNSET = object()


def attention_apply(p, cfg: AttnCfg, x, *, ctx=_FP, name="attn",
                    positions=None, causal=True, kv_x=None,
                    kv_positions=None, impl="plain", window=_UNSET):
    """Full-sequence attention. Returns y (B,S,d).

    kv_x: cross-attention onto that memory (no causal mask). impl:
    'plain' materialises (Sq,Skv) scores; 'qchunk' runs ``cfg.q_chunk``
    query rows a call. window: overrides ``cfg.window`` for the mask."""
    return _attend(p, cfg, x, ctx=ctx, name=name, positions=positions,
                   causal=causal, kv_x=kv_x, kv_positions=kv_positions,
                   impl=impl, window=window)[0]


def _attend(p, cfg, x, *, ctx, name, positions, causal=True, kv_x=None,
            kv_positions=None, impl="plain", window=_UNSET):
    """``attention_apply``'s body; also returns the projected k and v
    (without the meta prefix), which the prefill keeps as its cache."""
    _no_sp(cfg)
    window = cfg.window if window is _UNSET else window
    B, S, _ = x.shape
    dev = x.device
    cross = kv_x is not None
    if kv_x is None:
        kv_x = x
    Skv = kv_x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=dev).expand(B, S)
    if kv_positions is None:
        kv_positions = (torch.arange(Skv, device=dev).expand(B, Skv)
                        if not cross else
                        torch.zeros((B, Skv), dtype=torch.int32, device=dev))
    q, k, v = _project_qkv(p, cfg, x, kv_x, positions, kv_positions, ctx,
                           name)
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = hd ** -0.5

    # learnable meta-token KV prefix: attended by every query
    n_meta = cfg.n_meta if not cross else 0
    k_att, v_att = k, v
    if n_meta:
        mk, mv = _meta_kv(p, cfg, B, x.dtype, ctx, name)
        k_att = torch.cat([mk, k], dim=1)
        v_att = torch.cat([mv, v], dim=1)
        kv_positions = torch.cat(
            [torch.zeros((B, n_meta), dtype=kv_positions.dtype, device=dev),
             kv_positions], dim=1)

    masked = causal or (window is not None)

    def _mask_for(qpos):
        if cross:
            return None
        m = _causal_mask(qpos, kv_positions, window)       # (B,Sq,Skv)
        if n_meta:
            m[..., :n_meta] = True                         # meta always visible
        return m[:, None, None]                            # (B,1,1,Sq,Skv)

    if impl == "plain" or S <= cfg.q_chunk:
        out = _sdpa(q, k_att, v_att, _mask_for(positions) if masked else None,
                    ctx, name, scale)
    elif impl == "qchunk":
        C = cfg.q_chunk
        assert S % C == 0, f"seq {S} not divisible by q_chunk {C}"
        out = torch.cat([
            _sdpa(q[:, i:i + C], k_att, v_att,
                  _mask_for(positions[:, i:i + C]) if masked else None,
                  ctx, name, scale)
            for i in range(0, S, C)], dim=1)
    else:
        raise ValueError(impl)

    out = out.reshape(B, S, H * hd)
    y = ctx.linear(f"{name}/o", out, p["o"]["w"], p["o"].get("b"))
    return y, k, v


# --------------------------------------------------------------------------
# KV cache (decode)
# --------------------------------------------------------------------------
def kv_cache_init(cfg: AttnCfg, batch, max_len, dtype=torch.float32,
                  device=None):
    """Ring buffer of size ``window`` when sliding-window, else
    ``max_len``; zeros on ``device`` (default: the card)."""
    dev = resolve_device(device)
    size = min(cfg.window, max_len) if cfg.window else max_len
    Hk, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, size, Hk, hd), dtype=dtype, device=dev),
        "v": torch.zeros((batch, size, Hk, hd), dtype=dtype, device=dev),
    }


def attention_prefill(p, cfg: AttnCfg, x, *, ctx=_FP, name="attn",
                      positions=None, impl="qchunk", max_len=None,
                      window=_UNSET, full_cache=False):
    """Forward attention and the decode cache. Returns (y, cache).

    full_cache=True allocates a full ``max_len`` cache even when windowed
    (hybrid archs stack windowed and global layer caches uniformly). The
    cache holds the k and v the forward projected (the reference projects
    them a second time; the values are the same)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    y, k, v = _attend(p, cfg, x, ctx=ctx, name=name, positions=positions,
                      impl=impl, window=window)
    ring = cfg.window and not full_cache
    size = min(cfg.window, max_len or S) if ring else (max_len or S)
    if ring and S > size:
        k, v = k[:, -size:].contiguous(), v[:, -size:].contiguous()
    elif size > S:
        k = F.pad(k, (0, 0, 0, 0, 0, size - S))
        v = F.pad(v, (0, 0, 0, 0, 0, size - S))
    return y, {"k": k, "v": v}


def attention_decode(p, cfg: AttnCfg, x, cache, index, *, ctx=_FP,
                     name="attn", window=_UNSET):
    """One decode step. x (B,1,d); index: python int, the absolute
    position of the new token. Writes its k and v into ``cache`` in place
    (a ring buffer when ``cfg.window`` is set; a dynamic ``window`` over a
    full-size cache only tightens the mask). Returns (y, cache)."""
    _no_sp(cfg)
    dyn_window = None if window is _UNSET else window
    B = x.shape[0]
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = x.device
    pos = torch.full((B, 1), index, dtype=torch.int64, device=dev)
    q, k_new, v_new = _project_qkv(p, cfg, x, x, pos, pos, ctx, name)
    k, v = cache["k"], cache["v"]
    size = k.shape[1]
    slot = (index % size) if cfg.window else index
    if not 0 <= slot < size:
        raise IndexError(f"decode position {index} past the cache ({size})")
    k[:, slot] = k_new[:, 0]
    v[:, slot] = v_new[:, 0]

    # absolute positions held in each cache slot
    slots = torch.arange(size, device=dev)
    if cfg.window:
        # ring: slot s holds the latest position p with p % size == s
        k_pos = index - ((index - slots) % size)
    else:
        k_pos = slots
    valid = (k_pos >= 0) & (k_pos <= index)
    if cfg.window:
        valid &= k_pos > index - cfg.window
    if dyn_window is not None:
        valid &= k_pos > index - dyn_window
    mask = valid[None, None, None, None, :]     # (1,1,1,1,size)

    k_att, v_att = k, v
    if cfg.n_meta:
        mk, mv = _meta_kv(p, cfg, B, x.dtype, ctx, name)
        k_att = torch.cat([mk, k], dim=1)
        v_att = torch.cat([mv, v], dim=1)
        mask = torch.cat([torch.ones((1, 1, 1, 1, cfg.n_meta),
                                     dtype=torch.bool, device=dev), mask],
                         dim=-1)

    out = _sdpa(q, k_att, v_att, mask, ctx, name, hd ** -0.5)
    out = out.reshape(B, 1, H * hd)
    y = ctx.linear(f"{name}/o", out, p["o"]["w"], p["o"].get("b"))
    return y, {"k": k, "v": v}


def cross_attention_cache(p, cfg: AttnCfg, memory, *, ctx=_FP,
                          name="xattn"):
    raise NotImplementedError(
        f"cross_attention_cache: whisper's decoder is {ENCDEC_ITEM}")


def cross_attention_decode(p, cfg: AttnCfg, x, xcache, *, ctx=_FP,
                           name="xattn"):
    raise NotImplementedError(
        f"cross_attention_decode: whisper's decoder is {ENCDEC_ITEM}")


# --------------------------------------------------------------------------
# MLA — multi-head latent attention (configuration only)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MLACfg:
    d_model: int
    n_heads: int
    kv_lora: int = 512
    q_lora: int = 0          # 0 = direct q projection
    nope_dim: int = 128
    rope_dim: int = 64
    v_dim: int = 128
    rope_theta: float = 10000.0
    q_chunk: int = 512


def _mla_waits(fn_name):
    def fn(*a, **kw):
        raise NotImplementedError(f"{fn_name}: MLA is {MLA_ITEM}")
    fn.__name__ = fn_name
    return fn


mla_init = _mla_waits("mla_init")
mla_apply = _mla_waits("mla_apply")
mla_cache_init = _mla_waits("mla_cache_init")
mla_prefill = _mla_waits("mla_prefill")
mla_decode = _mla_waits("mla_decode")
