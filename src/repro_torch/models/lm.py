"""Decoder-only LM — port of the ``attn_mlp`` block path of
``repro/models/lm.py`` (the dense family: qwen3, qwen2.5, stablelm,
chameleon's backbone).

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
``rng.categorical``). The other block types wait for ROADMAP queue 1,
item 8: ``ssm_only`` and ``hymba`` for 8(b), ``attn_type="mla"`` and
``moe`` for 8(d); they raise.
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
from repro_torch.nn.ssm import SSM_ITEM
from repro_torch.nn.tree import map_tree, stack_trees

_FP = FPContext()
_ZERO_AUX = {"aux_loss": 0.0, "router_z": 0.0}


def _dense_only(cfg: ModelCfg):
    """Raise for the families this module does not run yet."""
    if cfg.encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder is {ENCDEC_ITEM}")
    if cfg.block_type in ("ssm_only", "hymba") or cfg.attn_type == "none":
        raise NotImplementedError(
            f"{cfg.name}: block_type={cfg.block_type!r} is {SSM_ITEM}")
    if cfg.attn_type == "mla" or cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: {'MLA' if cfg.attn_type == 'mla' else 'MoE'} is "
            f"{MLA_ITEM}")
    if cfg.block_type != "attn_mlp":
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
    _dense_only(cfg)
    ks = rng.split(key, 8)
    p: Dict[str, Any] = {"norm1": _norm_init(ks[0], cfg),
                         "attn": attention_init(
                             ks[1], cfg.attn_cfg(window=cfg.window),
                             cfg.tdtype),
                         "norm2": _norm_init(ks[2], cfg)}
    if cfg.d_ff:
        p["mlp"] = mlp_init(ks[3], cfg.mlp_cfg(), cfg.tdtype)
    return p


def _mlp_fwd(p, cfg, x, *, ctx, name):
    return mlp_apply(p["mlp"], cfg.mlp_cfg(), x, ctx=ctx, name=f"{name}/mlp")


def _mlp_residual(p, cfg, x, *, ctx, name):
    if "mlp" in p:
        x = x + _mlp_fwd(p, cfg, _norm_apply(p["norm2"], cfg, x), ctx=ctx,
                         name=name)
    return x


def block_apply(p, cfg: ModelCfg, x, *, ctx=_FP, name="blk", positions=None,
                window=None, impl=None):
    """Full-sequence block forward. Returns (x, aux)."""
    _dense_only(cfg)
    impl = impl or cfg.attn_impl
    h = _norm_apply(p["norm1"], cfg, x)
    x = x + attention_apply(p["attn"], cfg.attn_cfg(window=None), h,
                            ctx=ctx, name=f"{name}/attn",
                            positions=positions, impl=impl, window=window)
    return _mlp_residual(p, cfg, x, ctx=ctx, name=name), dict(_ZERO_AUX)


def block_cache_init(cfg: ModelCfg, batch, max_len, dtype=None, device=None):
    """Decode cache for ONE layer: a full ``max_len`` buffer whatever the
    window (windowed layers mask within it)."""
    _dense_only(cfg)
    return {"kv": kv_cache_init(cfg.attn_cfg(window=None), batch, max_len,
                                dtype or cfg.tdtype, device)}


def block_prefill(p, cfg: ModelCfg, x, *, ctx=_FP, name="blk", positions=None,
                  window=None, max_len=None, impl=None):
    """Forward + cache build. Returns (x, cache)."""
    _dense_only(cfg)
    impl = impl or cfg.attn_impl
    h = _norm_apply(p["norm1"], cfg, x)
    ya, kv = attention_prefill(p["attn"], cfg.attn_cfg(window=None), h,
                               ctx=ctx, name=f"{name}/attn",
                               positions=positions, impl=impl,
                               max_len=max_len, window=window,
                               full_cache=True)
    return _mlp_residual(p, cfg, x + ya, ctx=ctx, name=name), {"kv": kv}


def block_decode(p, cfg: ModelCfg, x, cache, index, *, ctx=_FP, name="blk",
                 window=None):
    """One-token decode. x (B,1,d); the cache is written in place.
    Returns (x, cache)."""
    _dense_only(cfg)
    h = _norm_apply(p["norm1"], cfg, x)
    ya, kv = attention_decode(
        p["attn"], cfg.attn_cfg(window=None), h, cache["kv"], index,
        ctx=ctx, name=f"{name}/attn",
        **({} if window is None else {"window": window}))
    return _mlp_residual(p, cfg, x + ya, ctx=ctx, name=name), {"kv": kv}


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
    _dense_only(cfg)
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
    _dense_only(cfg)
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
    """Zero decode cache, leaves (L, B, max_len, Hk, hd)."""
    one = block_cache_init(cfg, batch, max_len, dtype, device)
    return map_tree(lambda a: torch.zeros((cfg.n_layers,) + tuple(a.shape),
                                          dtype=a.dtype, device=a.device),
                    one)


def lm_prefill(p, cfg: ModelCfg, tokens, *, ctx=_FP, max_len=None):
    """Returns (logits of the last position (B,1,V), cache); cache leaves
    stacked (L, B, max_len, Hk, hd)."""
    _dense_only(cfg)
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
    absolute position. Writes the cache in place. Returns (logits
    (B,1,V), cache)."""
    _dense_only(cfg)
    x = embedding_apply(p["embed"], token).to(cfg.tdtype)
    if cfg.pos_embed == "learned":
        x = x + p["pos"][index:index + 1][None]
    wins = layer_windows(cfg, cache_len(cfg, cache))
    for i, bp in enumerate(_layers(p, cfg)):
        c = map_tree(lambda a: a[i], cache)
        w = None if wins is None else wins[i]
        x, _ = block_decode(bp, cfg, x, c, index, ctx=ctx.at_layer(i),
                            name=f"blk{i}", window=w)
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
