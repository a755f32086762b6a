"""Decoder-only LM — port of the ``attn_mlp``, ``ssm_only`` and ``hymba``
block paths of ``repro/models/lm.py`` (the dense family: qwen3, qwen2.5,
stablelm, chameleon's backbone; mamba2's SSD blocks; hymba's parallel
attention and SSD heads).

One parameter layout, the reference's: per-layer parameters stacked on a
leading ``L`` axis. The layers run in a Python loop with layer-distinct
op names (``blk3/attn/qk``), so the PTQ engine and the kernel context see
each layer's op on its own; ``cfg.scan_layers`` runs the same loop, and
``cfg.remat`` wraps each block of ``lm_apply`` in
``torch.utils.checkpoint`` (its activations are recomputed in the
backward, as the reference's ``jax.checkpoint(body)``).

Step functions: ``lm_apply`` / ``lm_loss_fn`` (next-token CE), ``lm_prefill``
(forward + decode cache), ``lm_decode_step`` (one token against the
cache, written in place) and ``lm_generate`` (greedy, or sampled with
``rng.categorical``). The decode cache holds {'kv': (L, B, max_len, Hk,
hd) k and v} for attention blocks and {'ssm': {'h': (L, B, H, P, N)
f32, 'conv': (L, B, d_conv - 1, conv_ch)}} for SSD blocks; hymba blocks
hold both. The encoder-decoder waits for ROADMAP queue 1, item 8(c),
``attn_type="mla"`` and ``moe`` for 8(d); they raise.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.diffusion import rng
from repro_torch.models.config import ModelCfg
from repro_torch.nn import initializers as init
from repro_torch.nn.attention import (
    ENCDEC_ITEM, MLA_ITEM, attention_apply, attention_decode, attention_init,
    attention_prefill, kv_cache_init,
)
from repro_torch.nn.ctx import FPContext
from repro_torch.nn.layers import (
    embedding_apply, embedding_init, embedding_logits, layernorm_apply,
    layernorm_init, linear_init, rmsnorm_apply, rmsnorm_init,
)
from repro_torch.nn.mlp import mlp_apply, mlp_init
from repro_torch.nn.ssm import (ssd_apply, ssd_decode, ssd_init,
                                ssd_state_init)
from repro_torch.nn.tree import map_tree, stack_trees

_FP = FPContext()
_ZERO_AUX = {"aux_loss": 0.0, "router_z": 0.0}
_ATTN = ("attn_mlp", "hymba")       # block types with an attention mixer
_SSD = ("ssm_only", "hymba")         # block types with an SSD mixer


def _supported(cfg: ModelCfg):
    """Raise for the families this module does not run yet."""
    if cfg.encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder is {ENCDEC_ITEM}")
    if cfg.attn_type == "mla" or cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: {'MLA' if cfg.attn_type == 'mla' else 'MoE'} is "
            f"{MLA_ITEM}")
    if cfg.block_type not in _ATTN + _SSD:
        raise ValueError(cfg.block_type)


# ---------------------------------------------------------------------------
# norms (dispatch on cfg.norm)
# ---------------------------------------------------------------------------
def _norm_init(key, cfg: ModelCfg, d=None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return layernorm_init(key, d, cfg.tdtype)
    return rmsnorm_init(key, d, cfg.tdtype)


def _norm_apply(p, cfg: ModelCfg, x):
    if cfg.norm == "layernorm":
        return layernorm_apply(p, x)
    return rmsnorm_apply(p, x)


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------
def block_init(key, cfg: ModelCfg):
    """One layer's parameters: ``split(key, 8)`` as the reference."""
    _supported(cfg)
    ks = rng.split(key, 8)
    dt = cfg.tdtype
    p: Dict[str, Any] = {"norm1": _norm_init(ks[0], cfg)}
    if cfg.block_type in _ATTN:
        p["attn"] = attention_init(ks[1], cfg.attn_cfg(window=cfg.window), dt)
        if cfg.block_type == "attn_mlp":
            p["norm2"] = _norm_init(ks[2], cfg)
            if cfg.d_ff:
                p["mlp"] = mlp_init(ks[3], cfg.mlp_cfg(), dt)
    if cfg.block_type in _SSD:
        p["ssm"] = ssd_init(ks[4], cfg.ssd_cfg(), dt)
        if cfg.block_type == "hymba":
            # per-branch output norms for head fusion (Hymba §3.2)
            p["attn_out_norm"] = rmsnorm_init(ks[5], cfg.d_model, dt)
            p["ssm_out_norm"] = rmsnorm_init(ks[6], cfg.d_model, dt)
            p["norm2"] = _norm_init(ks[2], cfg)
            p["mlp"] = mlp_init(ks[3], cfg.mlp_cfg(), dt)
    if cfg.block_type == "ssm_only" and cfg.d_ff:
        p["norm2"] = _norm_init(ks[2], cfg)
        p["mlp"] = mlp_init(ks[3], cfg.mlp_cfg(), dt)
    return p


def _mlp_fwd(p, cfg, x, *, ctx, name):
    return mlp_apply(p["mlp"], cfg.mlp_cfg(), x, ctx=ctx, name=f"{name}/mlp")


def _mlp_residual(p, cfg, x, *, ctx, name):
    if "mlp" in p:
        x = x + _mlp_fwd(p, cfg, _norm_apply(p["norm2"], cfg, x), ctx=ctx,
                         name=name)
    return x


def _mix(p, cfg, x, ya, ys):
    """The residual after the token mixers: attention's or the SSD's
    output, or Hymba's head fusion (each branch's own RMSNorm, then the
    mean of the two)."""
    if cfg.block_type == "attn_mlp":
        return x + ya
    if cfg.block_type == "ssm_only":
        return x + ys
    ya = rmsnorm_apply(p["attn_out_norm"], ya)
    ys = rmsnorm_apply(p["ssm_out_norm"], ys)
    return x + 0.5 * (ya + ys)


def block_apply(p, cfg: ModelCfg, x, *, ctx=_FP, name="blk", positions=None,
                window=None, impl=None):
    """Full-sequence block forward. Returns (x, aux)."""
    _supported(cfg)
    impl = impl or cfg.attn_impl
    h = _norm_apply(p["norm1"], cfg, x)
    ya = ys = None
    if cfg.block_type in _ATTN:
        ya = attention_apply(p["attn"], cfg.attn_cfg(window=None), h,
                             ctx=ctx, name=f"{name}/attn",
                             positions=positions, impl=impl, window=window)
    if cfg.block_type in _SSD:
        ys = ssd_apply(p["ssm"], cfg.ssd_cfg(), h, ctx=ctx,
                       name=f"{name}/ssm")
    x = _mix(p, cfg, x, ya, ys)
    return _mlp_residual(p, cfg, x, ctx=ctx, name=name), dict(_ZERO_AUX)


def block_cache_init(cfg: ModelCfg, batch, max_len, dtype=None, device=None):
    """Decode cache for ONE layer: a full ``max_len`` kv buffer whatever
    the window (windowed layers mask within it), and the SSD state."""
    _supported(cfg)
    dtype = dtype or cfg.tdtype
    c: Dict[str, Any] = {}
    if cfg.block_type in _ATTN:
        c["kv"] = kv_cache_init(cfg.attn_cfg(window=None), batch, max_len,
                                dtype, device)
    if cfg.block_type in _SSD:
        c["ssm"] = ssd_state_init(cfg.ssd_cfg(), batch, dtype, device)
    return c


def block_prefill(p, cfg: ModelCfg, x, *, ctx=_FP, name="blk", positions=None,
                  window=None, max_len=None, impl=None):
    """Forward + cache build. Returns (x, cache)."""
    _supported(cfg)
    impl = impl or cfg.attn_impl
    cache: Dict[str, Any] = {}
    h = _norm_apply(p["norm1"], cfg, x)
    ya = ys = None
    if cfg.block_type in _ATTN:
        ya, cache["kv"] = attention_prefill(
            p["attn"], cfg.attn_cfg(window=None), h, ctx=ctx,
            name=f"{name}/attn", positions=positions, impl=impl,
            max_len=max_len, window=window, full_cache=True)
    if cfg.block_type in _SSD:
        ys, cache["ssm"] = ssd_apply(p["ssm"], cfg.ssd_cfg(), h, ctx=ctx,
                                     name=f"{name}/ssm", return_state=True)
    x = _mix(p, cfg, x, ya, ys)
    return _mlp_residual(p, cfg, x, ctx=ctx, name=name), cache


def block_decode(p, cfg: ModelCfg, x, cache, index, *, ctx=_FP, name="blk",
                 window=None):
    """One-token decode. x (B,1,d); the kv cache is written in place, the
    SSD state is returned new (``lm_decode_step`` copies it into the
    stacked cache). Returns (x, cache)."""
    _supported(cfg)
    h = _norm_apply(p["norm1"], cfg, x)
    new: Dict[str, Any] = {}
    ya = ys = None
    if cfg.block_type in _ATTN:
        ya, new["kv"] = attention_decode(
            p["attn"], cfg.attn_cfg(window=None), h, cache["kv"], index,
            ctx=ctx, name=f"{name}/attn",
            **({} if window is None else {"window": window}))
    if cfg.block_type in _SSD:
        ys, new["ssm"] = ssd_decode(p["ssm"], cfg.ssd_cfg(), h, cache["ssm"],
                                    ctx=ctx, name=f"{name}/ssm")
    x = _mix(p, cfg, x, ya, ys)
    return _mlp_residual(p, cfg, x, ctx=ctx, name=name), new


# ---------------------------------------------------------------------------
# model level: init / windows / forward
# ---------------------------------------------------------------------------
def lm_init(key, cfg: ModelCfg, device=None):
    """``repro.models.lm.lm_init(key, cfg)``'s parameters from the same
    threefry key (``rng.PRNGKey(seed)``), on ``device`` (default: the
    card): ``split(key, 5)`` at the top, ``split(k_blocks, n_layers)`` for
    the layers, ``split(k, 8)`` per block, ``split(k, 7)`` per attention
    and ``split(k, 3)`` per MLP, the layers stacked on a leading axis as
    ``jax.vmap`` stacks them. Uniform-based draws and zeros equal the
    reference's bit for bit, normals within ``rng.normal``'s ulps.

    Params: {'embed', 'blocks' (stacked L), 'final_norm', ['head'],
    ['pos']}."""
    _supported(cfg)
    dev = resolve_device(device)
    k_emb, k_blocks, k_norm, k_head, k_pos = rng.split(key.to(dev), 5)
    dt = cfg.tdtype
    p: Dict[str, Any] = {
        "embed": embedding_init(k_emb, cfg.vocab, cfg.d_model, dt),
        "final_norm": _norm_init(k_norm, cfg),
    }
    p["blocks"] = stack_trees([block_init(k, cfg) for k in
                               rng.split(k_blocks, cfg.n_layers)])
    if not cfg.tie_embeddings:
        p["head"] = linear_init(k_head, cfg.d_model, cfg.vocab, bias=False,
                                dtype=dt)
    if cfg.pos_embed == "learned":
        p["pos"] = init.normal(0.01)(k_pos, (cfg.max_seq, cfg.d_model), dt)
    return p


def layer_windows(cfg: ModelCfg, seq_hint: int):
    """Per-layer attention window sizes as python ints (None = all
    global); global layers get a window past any position."""
    if cfg.window is None:
        return None
    big = max(seq_hint * 2, cfg.max_seq)
    ws = [cfg.window] * cfg.n_layers
    for g in cfg.global_layers:
        ws[g] = big
    return ws


def _layers(p, cfg: ModelCfg):
    """The stacked block parameters as one tree per layer (views; unbind
    so the backward stacks the layers' gradients once)."""
    per = map_tree(lambda a: a.unbind(0), p["blocks"])
    return [map_tree(lambda a, i=i: a[i], per) for i in range(cfg.n_layers)]


def _embed_in(p, cfg, tokens):
    x = embedding_apply(p["embed"], tokens).to(cfg.tdtype)
    if cfg.pos_embed == "learned":
        x = x + p["pos"][:tokens.shape[1]][None]
    return x


def _logits_out(p, cfg, x, ctx):
    x = _norm_apply(p["final_norm"], cfg, x)
    if cfg.tie_embeddings:
        return embedding_logits(p["embed"], x, ctx=ctx, name="lm_head")
    return ctx.linear("lm_head", x, p["head"]["w"])


def lm_apply(p, cfg: ModelCfg, tokens, *, ctx=_FP, positions=None):
    """Full forward to logits. tokens (B,S) integers. Returns (logits,
    aux)."""
    _supported(cfg)
    x = _embed_in(p, cfg, tokens)
    wins = layer_windows(cfg, tokens.shape[1])
    aux_loss = router_z = 0.0
    for i, bp in enumerate(_layers(p, cfg)):
        w = None if wins is None else wins[i]
        lctx, name = ctx.at_layer(i), f"blk{i}"
        if cfg.remat:
            x, aux = checkpoint(
                lambda bp, x, lctx=lctx, name=name, w=w: block_apply(
                    bp, cfg, x, ctx=lctx, name=name, positions=positions,
                    window=w),
                bp, x, use_reentrant=False)
        else:
            x, aux = block_apply(bp, cfg, x, ctx=lctx, name=name,
                                 positions=positions, window=w)
        aux_loss = aux_loss + aux["aux_loss"]
        router_z = router_z + aux["router_z"]
    logits = _logits_out(p, cfg, x, ctx)
    return logits, {"aux_loss": aux_loss, "router_z": router_z}


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def ce_loss(logits, labels, ignore_id=-1):
    """Mean next-token cross-entropy in f32 (labels already shifted by the
    caller; ``ignore_id`` positions count for nothing): the reference's
    max-shifted log-sum-exp, the label logit picked exactly."""
    lg = logits.float()
    m = lg.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lg - m).sum(dim=-1)) + m[..., 0]
    ll = torch.gather(lg, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def lm_loss_fn(p, cfg: ModelCfg, batch, *, ctx=_FP):
    logits, aux = lm_apply(p, cfg, batch["tokens"], ctx=ctx)
    loss = ce_loss(logits, batch["labels"])
    return loss + aux["aux_loss"] + aux["router_z"], {
        "ce": loss, "aux_loss": aux["aux_loss"]}


# ---------------------------------------------------------------------------
# prefill / decode at model level
# ---------------------------------------------------------------------------
def lm_cache_init(cfg: ModelCfg, batch, max_len, dtype=None, device=None):
    """Zero decode cache, each of ``block_cache_init``'s leaves stacked
    on a leading (L,) axis."""
    one = block_cache_init(cfg, batch, max_len, dtype, device)
    return map_tree(lambda a: torch.zeros((cfg.n_layers,) + tuple(a.shape),
                                          dtype=a.dtype, device=a.device),
                    one)


def lm_prefill(p, cfg: ModelCfg, tokens, *, ctx=_FP, max_len=None):
    """Returns (logits of the last position (B,1,V), cache); cache leaves
    stacked on a leading (L,) axis. An SSD model's S must be a multiple
    of ``cfg.ssm_chunk``."""
    _supported(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    x = _embed_in(p, cfg, tokens)
    wins = layer_windows(cfg, max_len)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    caches = []
    for i, bp in enumerate(_layers(p, cfg)):
        w = None if wins is None else wins[i]
        x, c = block_prefill(bp, cfg, x, ctx=ctx.at_layer(i), name=f"blk{i}",
                             positions=positions, window=w, max_len=max_len)
        caches.append(c)
    cache = stack_trees(caches)
    return _logits_out(p, cfg, x[:, -1:], ctx), cache


def cache_len(cfg: ModelCfg, cache) -> int:
    if cfg.block_type == "ssm_only":
        return cfg.max_seq
    return cache["kv"]["k"].shape[2]          # (L, B, S, ...)


def lm_decode_step(p, cfg: ModelCfg, token, cache, index, *, ctx=_FP):
    """One decode step. token (B,1) integers; index: python int, the
    absolute position. Writes the cache in place (the kv slot, and each
    layer's new SSD state copied over its old one). Returns (logits
    (B,1,V), cache)."""
    _supported(cfg)
    x = embedding_apply(p["embed"], token).to(cfg.tdtype)
    if cfg.pos_embed == "learned":
        x = x + p["pos"][index:index + 1][None]
    wins = layer_windows(cfg, cache_len(cfg, cache))
    for i, bp in enumerate(_layers(p, cfg)):
        c = map_tree(lambda a: a[i], cache)
        w = None if wins is None else wins[i]
        x, new = block_decode(bp, cfg, x, c, index, ctx=ctx.at_layer(i),
                              name=f"blk{i}", window=w)
        if "ssm" in new:
            c["ssm"]["h"].copy_(new["ssm"]["h"])
            c["ssm"]["conv"].copy_(new["ssm"]["conv"])
    return _logits_out(p, cfg, x, ctx), cache


def lm_generate(p, cfg: ModelCfg, prompt, n_new, *, ctx=_FP, max_len=None,
                greedy=True, key=None, temperature=1.0):
    """Autoregressive generation: prefill, then ``n_new`` decode steps;
    returns the (B, n_new) int32 tokens the steps chose (greedy argmax, or
    ``rng.categorical`` of ``logits / temperature`` under ``key``'s
    stream, ``split`` once a step as the reference; default key
    ``PRNGKey(0)``)."""
    B, S = prompt.shape
    max_len = max_len or (S + n_new)
    logits, cache = lm_prefill(p, cfg, prompt, ctx=ctx, max_len=max_len)
    tok = torch.argmax(logits[:, -1], dim=-1)
    key = key if key is not None else rng.PRNGKey(0, device=prompt.device)
    toks = []
    for i in range(n_new):
        lg, cache = lm_decode_step(p, cfg, tok[:, None], cache, S + i,
                                   ctx=ctx)
        lg = lg[:, 0]
        if greedy:
            tok = torch.argmax(lg, dim=-1)
        else:
            key, sub = rng.split(key)
            tok = rng.categorical(sub, lg / temperature)
        toks.append(tok)
    return torch.stack(toks, dim=1).to(torch.int32)
