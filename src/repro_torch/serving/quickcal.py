"""Range-only calibration for serving bring-up — port of
``repro/serving/quickcal.py``.

Derives structurally correct time-grouped quantizers from plain min/max
ranges of captured activations, in seconds:

- weights: per-output-channel symmetric ``ChannelQ`` from absmax;
- plain inputs: ``TGQ(UniformQ)`` per-group [min, max];
- post-GELU inputs: ``TGQ(MRQSignedQ)`` per-group lobe maxima;
- attention: per-group symmetric ``TGQ(SymQ)`` for q/k/v and a per-group
  ``TGQ(MRQSoftmaxQ)`` region split sized to ~8x the mean probability.

Groups the capture never hit borrow the nearest calibrated group. The
derivation (:func:`derive_qparams`) is separate from the capture, so it
can be held against the reference on identical captured batches.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.calib import build_dit_calibration, dit_loss_fn
from repro_torch.core.contexts import CalibrationContext, RecordingContext
from repro_torch.core.quantizers import (
    TGQ, ChannelQ, MRQSignedQ, MRQSoftmaxQ, SymQ, UniformQ,
    channel_scale_from_absmax, sym_scale_from_absmax,
    uniform_params_from_range, weight_absmax,
)
from repro_torch.diffusion.ddpm import DiffusionCfg, make_schedule
from repro_torch.models.dit import DiTCfg
from repro_torch.quant.groups import resolve_group


def _nearest(groups, g):
    return resolve_group(g, calibrated=groups)


def _f32(vals) -> torch.Tensor:
    return torch.as_tensor(np.asarray(vals, np.float32))


def derive_qparams(registry, store: Dict[str, List[dict]],
                   weights: Dict[str, np.ndarray], G: int, wbits: int,
                   abits: int) -> Dict[str, dict]:
    """Quantizer params from a capture (``RecordingContext.registry``,
    ``CalibrationContext.store`` / ``.weights``). CPU float32 tensors."""
    half = 2 ** (abits - 1)
    qparams: Dict[str, dict] = {}
    for name, info in registry.items():
        if info.kind != "einsum" or info.b_is_weight or name not in store:
            continue
        recs = store[name]
        groups = sorted({r["tg"] for r in recs})

        def stat(f, key):
            vals = {g: max(f(r[key]) for r in recs if r["tg"] == g)
                    for g in groups}
            return _f32([vals[_nearest(groups, g)] for g in range(G)])

        absmax = lambda a: max(float(np.max(np.abs(a))), 1e-6)
        if info.a_kind == "post_softmax":
            mean_p = stat(lambda a: float(np.mean(a)), "a")
            s1 = torch.clamp(8.0 * mean_p / half,
                             1.0 / (half * half * 8), 1.0 / half)
            xq: Any = TGQ(MRQSoftmaxQ(s1=s1, bits=abits))
        else:
            xq = TGQ(SymQ(scale=sym_scale_from_absmax(stat(absmax, "a"),
                                                      abits), bits=abits))
        qparams[name] = {
            "x": xq,
            "b": TGQ(SymQ(scale=sym_scale_from_absmax(stat(absmax, "b"),
                                                      abits), bits=abits)),
        }

    for name, info in registry.items():
        if info.kind != "linear" or name not in store:
            continue
        recs = store[name]
        groups = sorted({r["tg"] for r in recs})
        lo_hi = {g: (min(float(r["x"].min()) for r in recs if r["tg"] == g),
                     max(float(r["x"].max()) for r in recs if r["tg"] == g))
                 for g in groups}
        if info.a_kind in ("post_gelu", "post_silu"):
            s_neg, s_pos = [], []
            for g in range(G):
                lo, hi = lo_hi[_nearest(groups, g)]
                s_neg.append(max(-lo, 1e-6) / half)
                s_pos.append(max(hi, 1e-6) / half)
            xq = TGQ(MRQSignedQ(s_neg=_f32(s_neg), s_pos=_f32(s_pos),
                                bits=abits))
        else:
            scales, zeros = [], []
            for g in range(G):
                lo, hi = lo_hi[_nearest(groups, g)]
                s, z = uniform_params_from_range(
                    torch.tensor(lo, dtype=torch.float32),
                    torch.tensor(hi, dtype=torch.float32), abits)
                scales.append(s)
                zeros.append(z)
            xq = TGQ(UniformQ(scale=torch.stack(scales),
                              zero=torch.stack(zeros), bits=abits))
        w = torch.as_tensor(weights[name]).float()
        qparams[name] = {
            "x": xq,
            "w": ChannelQ(channel_scale_from_absmax(weight_absmax(w), wbits),
                          bits=wbits),
        }
    return qparams


def capture(params, dcfg: DiTCfg, calib, max_rows: int = 128):
    """Record the op graph, then run the calibration batches eagerly
    through a ``CalibrationContext``. Returns (registry, store, weights)."""
    loss = dit_loss_fn(params, dcfg)
    rec = RecordingContext()
    with torch.no_grad():
        loss(rec, calib[0][0])
        cal = CalibrationContext(registry=rec.registry,
                                 max_rows_per_batch=max_rows)
        for b, tg in calib:
            cal.begin_batch()
            loss(dataclasses.replace(cal, tgroup=tg), b)
    return rec.registry, cal.store, cal.weights


def range_calibrate(params, dcfg: DiTCfg, dif: DiffusionCfg, sched=None,
                    *, calib: Optional[list] = None, seed: int = 0,
                    wbits: int = 8, abits: int = 8, n_per_group: int = 2,
                    batch: int = 2, max_rows: int = 128
                    ) -> Tuple[Dict[str, dict], Dict[str, np.ndarray]]:
    """Min/max calibration of every DiT op, time-grouped. ``calib``
    (``[(batch_dict, group)]``) defaults to forward-diffused Gaussian
    latents drawn from ``torch.Generator().manual_seed(seed)`` on the
    params' device. Returns ``(qparams, weights)`` for
    ``convert_for_kernels``."""
    dev = params["x_proj"]["w"].device
    sched = sched if sched is not None else make_schedule(dif, device=dev)
    if calib is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        x0 = lambda n, g: torch.randn(
            (n, dcfg.img_size, dcfg.img_size, dcfg.in_ch), generator=g,
            device=dev)
        calib = build_dit_calibration(dcfg, dif, sched, x0, gen,
                                      n_per_group=n_per_group, batch=batch,
                                      device=dev)
    registry, store, weights = capture(params, dcfg, calib, max_rows)
    return (derive_qparams(registry, store, weights, dif.tgq_groups, wbits,
                           abits), weights)
