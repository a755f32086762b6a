"""Mamba-2 SSD (state-space duality) mixer — port of ``repro/nn/ssm.py``.

The forward runs the chunked SSD algorithm (Dao & Gu 2024,
arXiv:2405.21060): quadratic attention-like work inside each chunk of
``cfg.chunk`` tokens, a linear recurrence across chunks carrying the
state ``h`` in float32 (a Python loop over the chunks, where the
reference runs a ``lax.scan``). Decode is the O(1) per-token recurrence
with a depthwise-conv window of the last ``d_conv - 1`` inputs.

Only ``in_proj`` and ``out_proj`` go through the op context
(``{name}/in_proj``, ``{name}/out_proj``); the SiLUs are plain, as in the
reference. The dtype casts inside a chunk are the reference's one by
one; its two three-operand einsums are contracted pairwise in one fixed
order each, the pair's product rounded to the operands' dtype
(``jnp.einsum`` picks the order by shape; in bf16 either order is as
far from the reference, see ``ssm_bf16_vs_jax_rel``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.diffusion import rng
from repro_torch.nn import initializers as init
from repro_torch.nn.ctx import FPContext
from repro_torch.nn.layers import linear_init, rmsnorm_init

_FP = FPContext()


@dataclasses.dataclass(frozen=True)
class SSDCfg:
    d_model: int
    d_inner: int                 # = n_heads * head_dim
    d_state: int = 128
    head_dim: int = 64
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def n_heads(self):
        return self.d_inner // self.head_dim

    @property
    def conv_ch(self):
        return self.d_inner + 2 * self.n_groups * self.d_state


def _log_f32(v: float, device):
    return torch.log(torch.tensor(v, dtype=torch.float32, device=device))


def ssd_init(key, cfg: SSDCfg, dtype=torch.float32):
    """The reference's parameters from the same key (``split(key, 6)``):
    the dt draw's uniforms, zeros and ones bit for bit; ``dt_bias`` and
    ``A_log`` go through float32 exp / log / expm1, which round by ulps
    in each library; ``conv_w`` and the projections are ``rng.normal``."""
    ks = rng.split(key, 6)
    dev = key.device
    H = cfg.n_heads
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state + H
    # dt bias so that softplus(dt_bias) spans [dt_min, dt_max] (mamba init)
    u = rng.uniform(ks[2], (H,), 0.0, 1.0)
    lo = _log_f32(cfg.dt_min, dev)
    dt = torch.exp(u * (_log_f32(cfg.dt_max, dev) - lo) + lo)
    dt_bias = dt + torch.log(-torch.expm1(-dt))        # inverse softplus
    return {
        "in_proj": linear_init(ks[0], cfg.d_model, d_in_proj, bias=False,
                               dtype=dtype),
        "conv_w": init.normal(0.2)(ks[1], (cfg.d_conv, cfg.conv_ch), dtype),
        "conv_b": torch.zeros((cfg.conv_ch,), dtype=dtype, device=dev),
        "dt_bias": dt_bias,
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(ks[3], cfg.d_inner, dtype),
        "out_proj": linear_init(ks[4], cfg.d_inner, cfg.d_model, bias=False,
                                dtype=dtype),
    }


def _causal_conv(xBC, w, b):
    """Depthwise causal conv1d. xBC (B,S,C); w (K,C): the reference's
    running sum over the K taps, then the bias."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return out + b


def _split_proj(cfg: SSDCfg, zxbcdt):
    """(z, xBC, dt) views of the in-projection's output."""
    return torch.split(zxbcdt, [cfg.d_inner, cfg.conv_ch, cfg.n_heads],
                       dim=-1)


def _segsum(a):
    """a (..., Q) -> (..., Q, Q); out[q, k] = sum_{i=k+1..q} a_i for
    q >= k, else -inf (which ``exp`` makes an exact 0)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, -math.inf)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _gated_rmsnorm(y, z, scale):
    """The reference's gated RMSNorm: ``y * silu(z)``, the variance in f32,
    its ``rsqrt`` cast to y's dtype before the two products (eps 1e-6)."""
    y = y * F.silu(z)
    var = y.float().square().mean(dim=-1, keepdim=True)
    return (y * torch.rsqrt(var + 1e-6).to(y.dtype)) * scale


def ssd_apply(p, cfg: SSDCfg, x, *, ctx=_FP, name="ssd", initial_state=None,
              return_state=False):
    """Full-sequence SSD. x (B,S,d). Returns y (and the final state when
    ``return_state``: {'h': (B,H,P,N) f32, 'conv': (B,d_conv-1,conv_ch)}).

    S need not be a multiple of ``cfg.chunk`` on the stateless path (the
    input is padded and the output sliced back); with ``return_state``
    it must be, as the padded tail would pollute the state."""
    B, S, _ = x.shape
    H, P, N, Gs, Q = (cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups,
                      cfg.chunk)
    if S % Q:
        if return_state:
            raise ValueError(f"seq {S} % chunk {Q} != 0 with return_state")
        y = ssd_apply(p, cfg, F.pad(x, (0, 0, 0, Q - S % Q)), ctx=ctx,
                      name=name, initial_state=initial_state)
        return y[:, :S]
    nc = S // Q

    zxbcdt = ctx.linear(f"{name}/in_proj", x, p["in_proj"]["w"])
    z, xBC, dt_raw = _split_proj(cfg, zxbcdt)
    conv_tail = xBC[:, S - (cfg.d_conv - 1):, :]          # decode handoff
    xBC = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
    xs, Bc, Cc = torch.split(xBC, [cfg.d_inner, Gs * N, Gs * N], dim=-1)

    dt = _softplus(dt_raw.float() + p["dt_bias"])          # (B,S,H)
    A = -torch.exp(p["A_log"])                              # (H,)

    xs = xs.reshape(B, nc, Q, H, P)
    Bc = Bc.reshape(B, nc, Q, Gs, N)
    Cc = Cc.reshape(B, nc, Q, Gs, N)
    dt = dt.reshape(B, nc, Q, H)
    hpg = H // Gs                                           # heads a group

    dA = dt * A                                             # (B,nc,Q,H)
    xdt = xs * dt[..., None].to(xs.dtype)

    h = (initial_state["h"] if initial_state is not None
         else torch.zeros((B, H, P, N), dtype=torch.float32,
                          device=x.device))
    ys = []
    for c in range(nc):
        xc, bc, cc, dac = xdt[:, c], Bc[:, c], Cc[:, c], dA[:, c]
        cs = torch.cumsum(dac, dim=1)                       # (B,Q,H)
        L = torch.exp(_segsum(dac.movedim(1, -1)))          # (B,H,Q,Q) f32
        CB = torch.einsum("bqgn,bkgn->bgqk", cc, bc)        # (B,Gs,Q,Q)
        CB = CB.repeat_interleave(hpg, dim=1)               # (B,H,Q,Q)
        Yd = torch.einsum("bhqk,bkhp->bqhp", (CB * L).to(xc.dtype), xc)
        # the carried state's contribution, and this chunk's state update
        ccr = cc.repeat_interleave(hpg, dim=2)              # (B,Q,H,N)
        bcr = bc.repeat_interleave(hpg, dim=2)
        sdec = torch.exp(cs).to(xc.dtype)                   # (B,Q,H)
        Yo = torch.einsum("bqhn,bhpn->bqhp", ccr,
                          h.to(xc.dtype)) * sdec[..., None]
        decay_state = torch.exp(cs[:, -1:, :] - cs).to(xc.dtype)
        new_contrib = torch.einsum("bqhn,bqhp->bhpn", bcr,
                                   xc * decay_state[..., None])
        chunk_decay = torch.exp(cs[:, -1, :])               # (B,H)
        h = h * chunk_decay[..., None, None] + new_contrib.float()
        ys.append(Yd + Yo)
    Y = torch.stack(ys, dim=1).reshape(B, S, H, P)
    Y = Y + p["D"][:, None].to(Y.dtype) * xs.reshape(B, S, H, P)

    y = _gated_rmsnorm(Y.reshape(B, S, cfg.d_inner), z, p["norm"]["scale"])
    out = ctx.linear(f"{name}/out_proj", y, p["out_proj"]["w"])
    if return_state:
        return out, {"h": h, "conv": conv_tail}
    return out


def ssd_state_init(cfg: SSDCfg, batch, dtype=torch.float32, device=None):
    """Zero decode state on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                         dtype=torch.float32, device=dev),
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_ch),
                            dtype=dtype, device=dev),
    }


def ssd_decode(p, cfg: SSDCfg, x, state, *, ctx=_FP, name="ssd"):
    """One-token recurrence. x (B,1,d). Returns (y, new state); the
    caller's state is not written."""
    B = x.shape[0]
    H, P, N, Gs = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    zxbcdt = ctx.linear(f"{name}/in_proj", x, p["in_proj"]["w"])
    z, xBC, dt_raw = (t[:, 0] for t in _split_proj(cfg, zxbcdt))

    window = torch.cat([state["conv"], xBC[:, None, :]], dim=1)  # (B,K,C)
    cdt = torch.promote_types(window.dtype, p["conv_w"].dtype)
    conv_out = torch.einsum("bkc,kc->bc", window.to(cdt),
                            p["conv_w"].to(cdt)) + p["conv_b"].to(cdt)
    xBC_a = F.silu(conv_out)
    xs, Bc, Cc = torch.split(xBC_a, [cfg.d_inner, Gs * N, Gs * N], dim=-1)
    xs = xs.reshape(B, H, P)
    Bc = Bc.reshape(B, Gs, N)
    Cc = Cc.reshape(B, Gs, N)

    dt = _softplus(dt_raw.float() + p["dt_bias"])           # (B,H)
    A = -torch.exp(p["A_log"])
    da = torch.exp(dt * A)                                  # (B,H)
    Bh = Bc.repeat_interleave(H // Gs, dim=1)               # (B,H,N)
    Ch = Cc.repeat_interleave(H // Gs, dim=1)
    # einsum("bhn,bhp,bh->bhpn") in f32
    xdt = xs.float() * dt[..., None]
    upd = xdt[..., :, None] * Bh.float()[..., None, :]
    h = state["h"] * da[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", h.to(xs.dtype), Ch)
    y = y + p["D"][:, None].to(y.dtype) * xs
    y = _gated_rmsnorm(y.reshape(B, 1, cfg.d_inner), z[:, None, :],
                       p["norm"]["scale"])
    out = ctx.linear(f"{name}/out_proj", y, p["out_proj"]["w"])
    return out, {"h": h, "conv": window[:, 1:]}
