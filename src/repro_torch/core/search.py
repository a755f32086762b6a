"""Candidate search for quantization parameters (Algorithm 1, Phase 3) —
port of ``repro/core/search.py``.

Every op minimizes the Hessian-guided objective (Eq. 16/17):

    err(D) = sum over calibration samples of  G . (op(q(A);D) - op(A))^2

where G = (dL/dz)^2 is the diagonal Fisher of the op's output (HO), or
G = 1 for the MSE ablation. Candidates scale the min/max-derived step
size by a grid of alphas; weight and activation parameters alternate for
R rounds (paper: R = 3).

Output format (the serving contract, as the reference's): time-grouped
activation quantizers stack every scalar parameter along a leading (G,)
axis dense over ALL ``cfg.tgq_groups`` — groups without calibration data
borrow the nearest calibrated group (ties to the lower one) — and wrap it
in ``TGQ``; attention q/k/v operands get per-tensor symmetric ``SymQ``;
post-softmax probs a TGQ-stacked ``MRQSoftmaxQ``. Every parameter is a
0-d (or stacked) float32 tensor on the search device.

The candidates equal the reference's bit for bit: an f32 tensor times an
alpha rounds the alpha to f32 first (as JAX does with a numpy float64),
while the step sizes built from Python floats (the MRQ steps, the
uniform ranges, the symmetric absmax, the softmax ``s1`` grid) are formed
in float64 and rounded to f32 once. A round's errors are computed on the
device, copied to the host once, and the choice is numpy's first
``argmin`` over them (summed over batches in batch order as Python
floats for einsums), the reference's rule.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.contexts import OpInfo
from repro_torch.core.quantizers import (
    TGQ, ChannelQ, MRQSignedQ, MRQSoftmaxQ, SymQ, UniformQ,
    channel_scale_from_absmax, sym_scale_from_absmax,
    uniform_params_from_range,
)
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SearchCfg:
    wbits: int = 8
    abits: int = 8
    rounds: int = 3               # R in Algorithm 1
    n_alpha: int = 20
    alpha_lo: float = 0.30
    alpha_hi: float = 1.15
    use_fisher: bool = True
    use_mrq: bool = True
    use_tgq: bool = True
    tgq_groups: int = 10

    @property
    def alphas(self):
        return np.linspace(self.alpha_lo, self.alpha_hi, self.n_alpha)


def _f32(v, device=None) -> torch.Tensor:
    """A Python / numpy float64 value rounded once to a 0-d f32 tensor."""
    return torch.from_numpy(np.asarray(v, np.float32)).to(device)


def _dev_f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.require(a, np.float32, ["C", "W"])).to(device)


# ---------------------------------------------------------------------------
# weighted error and the host-side choice
# ---------------------------------------------------------------------------
def _werr(delta, fisher):
    d2 = torch.square(delta)
    if fisher is not None:
        d2 = d2 * fisher
    return torch.sum(d2)


def _argmin(cands: list, err_of: Callable) -> int:
    """Index of the candidate with the least error: ``err_of(c)`` gives
    one f32 0-d tensor per batch; all are copied to the host at once and
    summed per candidate in batch order as Python floats."""
    per = [err_of(c) for c in cands]
    vals = torch.stack([torch.stack(p) for p in per]).cpu().numpy()
    tots = []
    for row in vals:
        tot = 0.0
        for v in row:
            tot += float(v)
        tots.append(tot)
    return int(np.argmin(tots))


def _contracted_axes(spec: str) -> tuple:
    """Axes of einsum operand b that are contracted (reduced) in ``spec``."""
    lhs, out = spec.split("->")
    _, b_l = lhs.split(",")
    return tuple(i for i, ch in enumerate(b_l) if ch not in out)


def _b_channel_absmax(w, spec: Optional[str]):
    """Per-output-channel absmax of a weight operand: reduce contracted dims."""
    axes = (0,) if spec is None else _contracted_axes(spec)
    return torch.amax(torch.abs(w), dim=axes, keepdim=True)


# ---------------------------------------------------------------------------
# candidate generators
# ---------------------------------------------------------------------------
def _weight_candidates(w, cfg: SearchCfg, spec=None):
    absmax = _b_channel_absmax(w, spec)
    return [ChannelQ(scale=channel_scale_from_absmax(absmax * float(a),
                                                     cfg.wbits),
                     bits=cfg.wbits)
            for a in cfg.alphas]


def _uniform_act_candidates(lo, hi, cfg: SearchCfg, device=None):
    out = []
    for a in cfg.alphas:
        s, z = uniform_params_from_range(_f32(a * lo, device),
                                         _f32(a * hi, device), cfg.abits)
        out.append(UniformQ(scale=s, zero=z, bits=cfg.abits))
    return out


def _sym_act_candidates(absmax, cfg: SearchCfg, device=None):
    """Per-tensor SYMMETRIC grid for activation x activation einsum
    operands (attention q/k/v): the codes the int8 attention kernels take
    with no zero-point correction."""
    return [SymQ(scale=sym_scale_from_absmax(_f32(a * absmax, device),
                                             cfg.abits),
                 bits=cfg.abits)
            for a in cfg.alphas]


def _mrq_softmax_candidates(cfg: SearchCfg, device=None):
    """s1 grid: R1 must sit below 1, so s1 in (0, 1/2^{k-1}); log-grid."""
    half = 2 ** (cfg.abits - 1)
    s1s = np.geomspace(1.0 / (half * half * 8), 1.0 / half, cfg.n_alpha)
    return [MRQSoftmaxQ(s1=_f32(s, device), bits=cfg.abits) for s in s1s]


def _mrq_signed_candidates_neg(neg_max, cfg: SearchCfg, device=None):
    half = 2 ** (cfg.abits - 1)
    return [_f32(max(a * neg_max / half, 1e-8), device) for a in cfg.alphas]


def _mrq_signed_candidates_pos(pos_max, cfg: SearchCfg, device=None):
    half = 2 ** (cfg.abits - 1)
    return [_f32(max(a * pos_max / half, 1e-8), device) for a in cfg.alphas]


# ---------------------------------------------------------------------------
# op-level searches
# ---------------------------------------------------------------------------
def _apply(q, x):
    return x if q is None else q(x)


def _lobes(X):
    """(neg, pos): the post-GELU lobes' extents, each at least 1e-6."""
    neg = float(torch.clamp(-torch.min(X), min=1e-6))
    pos = float(torch.clamp(torch.max(X), min=1e-6))
    return neg, pos


def search_linear(info: OpInfo, xs: List[np.ndarray],
                  gs: List[Optional[np.ndarray]], w: np.ndarray,
                  cfg: SearchCfg, weight_only: bool = False,
                  prescale: Optional[np.ndarray] = None,
                  tgs: Optional[List[int]] = None,
                  device=None) -> Dict[str, Any]:
    """HO alternating search for a linear op (Algorithm 1 lines 15-22).

    xs: stored input ROWS per batch (n_i, d_in); gs: aligned Fisher rows
    (n_i, d_out) or None; w: (d_in, d_out); tgs: TGQ group tag per batch.
    With ``cfg.use_tgq`` and more than one calibrated group, the
    activation quantizer is refined PER GROUP against the chosen weight
    quantizer and returned TGQ-wrapped. The search runs on ``device``
    (default ``"cuda"``)."""
    dev = resolve_device(device)
    if prescale is not None:
        ps = np.asarray(prescale, np.float32)
        xs = [np.asarray(x) / ps for x in xs]
        w = np.asarray(w) * ps[:, None]
    X = _dev_f32(np.concatenate(xs, axis=0), dev)
    G = (_dev_f32(np.concatenate([np.square(g) for g in gs], axis=0), dev)
         if cfg.use_fisher and gs[0] is not None else None)
    W = _dev_f32(w, dev)
    Y = X @ W

    w_cands = _weight_candidates(W, cfg)
    a_kind = info.a_kind if cfg.use_mrq else "plain"
    if a_kind in ("post_gelu", "post_silu"):
        neg, pos = _lobes(X)
        xq: Any = MRQSignedQ(
            s_neg=_mrq_signed_candidates_neg(neg, cfg, dev)[-1],
            s_pos=_mrq_signed_candidates_pos(pos, cfg, dev)[-1],
            bits=cfg.abits)
    else:
        xq = _uniform_act_candidates(float(torch.min(X)),
                                     float(torch.max(X)), cfg, dev)[-1]
    wq = w_cands[-1]
    if weight_only:
        xq = None

    for _ in range(cfg.rounds):
        # ---- update W given the current xq ---------------------------------
        xhat = _apply(xq, X)
        wq = w_cands[_argmin(w_cands,
                             lambda c: [_werr(xhat @ c(W) - Y, G)])]
        if weight_only:
            break
        # ---- update X given the current wq ---------------------------------
        xq = _best_act_quantizer(X, G, Y, wq(W), a_kind, cfg)

    if (cfg.use_tgq and not weight_only and tgs is not None
            and len(set(tgs)) > 1):
        xq = _tgq_linear_acts(xs, gs, tgs, W, wq(W), a_kind, cfg)

    out = {"w": wq, "x": xq}
    if prescale is not None:
        out["x_prescale"] = _dev_f32(prescale, dev)
    return out


def _best_act_quantizer(X, G, Y, what, a_kind, cfg: SearchCfg):
    """The best activation quantizer for rows X against the fp target Y
    with quantized weights ``what``: independent neg/pos step grids for
    MRQ-signed inputs (§III-C), the range-scaled uniform grid otherwise.
    Shared by the pooled search and the per-group TGQ refinement."""
    dev = X.device
    err = lambda xhat: [_werr(xhat @ what - Y, G)]
    if a_kind in ("post_gelu", "post_silu"):
        neg, pos = _lobes(X)
        negs = _mrq_signed_candidates_neg(neg, cfg, dev)
        poss = _mrq_signed_candidates_pos(pos, cfg, dev)
        s_neg = negs[_argmin(negs, lambda s: err(
            MRQSignedQ(s, poss[-1], cfg.abits)(X)))]
        s_pos = poss[_argmin(poss, lambda s: err(
            MRQSignedQ(s_neg, s, cfg.abits)(X)))]
        return MRQSignedQ(s_neg=s_neg, s_pos=s_pos, bits=cfg.abits)
    cands = _uniform_act_candidates(float(torch.min(X)), float(torch.max(X)),
                                    cfg, dev)
    return cands[_argmin(cands, lambda c: err(c(X)))]


def _nearest_group(groups, g):
    """The calibrated group nearest ``g`` (ties to the lower group)."""
    return min(groups, key=lambda x: abs(x - g))


def _tgq_linear_acts(xs, gs, tgs, W, what, a_kind, cfg: SearchCfg):
    """Per-group activation search for a linear, stacked into a ``TGQ``
    dense over ``range(cfg.tgq_groups)`` (groups without calibration data
    borrow the nearest calibrated group's parameters)."""
    dev = W.device
    groups = sorted(set(tgs))
    per_group: Dict[int, Any] = {}
    for g in groups:
        idx = [i for i, t in enumerate(tgs) if t == g]
        X = _dev_f32(np.concatenate([xs[i] for i in idx], 0), dev)
        G = (_dev_f32(np.concatenate([np.square(gs[i]) for i in idx], 0),
                      dev)
             if cfg.use_fisher and gs[idx[0]] is not None else None)
        per_group[g] = _best_act_quantizer(X, G, X @ W, what, a_kind, cfg)

    def leaf(attr):
        return torch.stack([getattr(per_group[_nearest_group(groups, g)],
                                    attr)
                            for g in range(cfg.tgq_groups)])

    if a_kind in ("post_gelu", "post_silu"):
        inner = MRQSignedQ(s_neg=leaf("s_neg"), s_pos=leaf("s_pos"),
                           bits=cfg.abits)
    else:
        inner = UniformQ(scale=leaf("scale"), zero=leaf("zero"),
                         bits=cfg.abits)
    return TGQ(inner=inner)


def search_einsum(info: OpInfo, recs: List[dict],
                  gs: List[Optional[np.ndarray]], cfg: SearchCfg,
                  w: Optional[np.ndarray] = None,
                  weight_only: bool = False, device=None) -> Dict[str, Any]:
    """HO alternating search for a MatMul op (Algorithm 1 lines 23-31).

    recs: per-batch {'a', ['b'], 'tg'}; gs: aligned Fisher arrays
    (batch-subsampled like 'a'); w: operand b when b_is_weight. Runs on
    ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    spec = info.spec
    A = [_dev_f32(r["a"], dev) for r in recs]
    tgs = [r["tg"] for r in recs]
    if w is not None:
        Bs = [_dev_f32(w, dev)] * len(A)
    else:
        Bs = [_dev_f32(r["b"], dev) for r in recs]
    G = ([torch.square(_dev_f32(g, dev)) for g in gs]
         if cfg.use_fisher and gs[0] is not None else [None] * len(A))
    Y = [torch.einsum(spec, a, b) for a, b in zip(A, Bs)]

    def batch_errs(aq, bq, idxs):
        out = []
        for i in idxs:
            q = aq.select(tgs[i]) if isinstance(aq, TGQ) else aq
            out.append(_werr(torch.einsum(spec, _apply(q, A[i]),
                                          _apply(bq, Bs[i])) - Y[i], G[i]))
        return out

    all_idx = list(range(len(A)))
    a_kind = info.a_kind if cfg.use_mrq else "plain"
    tgq_on = cfg.use_tgq and info.a_kind == "post_softmax" and cfg.use_mrq

    # ---- candidate spaces --------------------------------------------------
    if info.b_is_weight:
        b_cands = _weight_candidates(Bs[0], cfg, spec)
    else:
        bmax = max(float(torch.amax(torch.abs(b))) for b in Bs)
        b_cands = _sym_act_candidates(max(bmax, 1e-6), cfg, dev)
    bq = b_cands[-1]

    if a_kind == "post_softmax":
        a_cands = _mrq_softmax_candidates(cfg, dev)
    elif a_kind in ("post_gelu", "post_silu"):
        neg = float(max(-min(float(torch.min(a)) for a in A), 1e-6))
        pos = float(max(max(float(torch.max(a)) for a in A), 1e-6))
        a_cands = [MRQSignedQ(s_neg=n, s_pos=p, bits=cfg.abits)
                   for n, p in zip(_mrq_signed_candidates_neg(neg, cfg, dev),
                                   _mrq_signed_candidates_pos(pos, cfg,
                                                              dev))]
    elif not info.b_is_weight and info.a_kind == "plain":
        # the raw a_kind, as the reference: a post-softmax operand under the
        # no-MRQ ablation keeps the asymmetric grid
        amax = max(float(torch.amax(torch.abs(a))) for a in A)
        a_cands = _sym_act_candidates(max(amax, 1e-6), cfg, dev)
    else:
        lo = min(float(torch.min(a)) for a in A)
        hi = max(float(torch.max(a)) for a in A)
        a_cands = _uniform_act_candidates(lo, hi, cfg, dev)

    if tgq_on:
        groups = sorted(set(tgs))
        idx_of = {g: [i for i in all_idx if tgs[i] == g] for g in groups}

        def stack_groups(per_group):
            """{g: MRQSoftmaxQ} -> TGQ over ALL cfg.tgq_groups."""
            s1s = [per_group[_nearest_group(groups, g)].s1
                   for g in range(cfg.tgq_groups)]
            return TGQ(inner=MRQSoftmaxQ(s1=torch.stack(s1s),
                                         bits=cfg.abits))
        aq: Any = stack_groups({g: a_cands[-1] for g in groups})
    else:
        aq = a_cands[-1]
    if weight_only and info.b_is_weight:
        aq = None

    for _ in range(cfg.rounds):
        # ---- update A (TGQ per group if post-softmax) ------------------------
        if aq is not None:
            if tgq_on:
                aq = stack_groups({g: a_cands[_argmin(
                    a_cands, lambda c: batch_errs(c, bq, idx_of[g]))]
                    for g in groups})
            else:
                aq = a_cands[_argmin(a_cands,
                                     lambda c: batch_errs(c, bq, all_idx))]
        # ---- update B ----------------------------------------------------------
        bq = b_cands[_argmin(b_cands, lambda c: batch_errs(aq, c, all_idx))]

    out: Dict[str, Any] = {"x": aq}
    out["w" if info.b_is_weight else "b"] = bq
    return out


def search_hook_act(samples: List[np.ndarray], cfg: SearchCfg,
                    device=None) -> MRQSignedQ:
    """MRQ-signed search for a hook-quantized activation (SwiGLU silu
    gate): independent neg/pos step grids minimizing plain MSE over the
    stored rows."""
    dev = resolve_device(device)
    X = _dev_f32(np.concatenate(samples, axis=0), dev)
    neg, pos = _lobes(X)
    negs = _mrq_signed_candidates_neg(neg, cfg, dev)
    poss = _mrq_signed_candidates_pos(pos, cfg, dev)
    mse = lambda q: [torch.mean(torch.square(q(X) - X))]
    s_neg = negs[_argmin(negs, lambda s: mse(
        MRQSignedQ(s, poss[-1], cfg.abits)))]
    s_pos = poss[_argmin(poss, lambda s: mse(
        MRQSignedQ(s_neg, s, cfg.abits)))]
    return MRQSignedQ(s_neg=s_neg, s_pos=s_pos, bits=cfg.abits)
