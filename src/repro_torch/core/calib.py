"""Phase 1 of Algorithm 1 — calibration-set construction with time
grouping (§III-A) — and the loss closures that drive calibration capture
and the Fisher backward; port of ``repro/core/calib.py`` (the DiT's and
the LM's).

Default protocol: tuples (x_t, t, y) come from forward diffusion of
source latents with a known noise target, timesteps drawn uniformly
within each TGQ group G_i = [i*T/G, (i+1)*T/G). ``harvest_trajectory=True``
takes x_t from the model's own sampling trajectory instead (the
Q-Diffusion protocol, ``diffusion.ddpm.collect_xt_dataset``) and pairs it
with a fresh noise target. Draws come from a seeded ``torch.Generator``
(not bit-equal to the reference's ``jax.random`` draws; the tests hand
both packages the same batches instead).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.diffusion.ddpm import (
    DiffusionCfg, collect_xt_dataset, q_sample,
)
from repro_torch.models.dit import DiTCfg, dit_apply


def build_dit_calibration(dcfg: DiTCfg, dif: DiffusionCfg, sched,
                          x0_source: Callable[[int, torch.Generator], Any],
                          generator: torch.Generator, n_per_group: int = 32,
                          batch: int = 8, n_classes: Optional[int] = None,
                          device=None, *, params=None,
                          harvest_trajectory: bool = False,
                          steps: Optional[int] = None
                          ) -> List[Tuple[Dict[str, Any], int]]:
    """[(batch_dict, group)] with ``n_per_group`` samples per group;
    batch_dict = {'xt', 't', 'y', 'noise'}. ``x0_source(n, generator)``
    returns (n, H, W, C) source latents on ``device``.

    With ``harvest_trajectory`` (``params`` required; ``x0_source`` is
    unused) each group's x_t is harvested at t = (g + 0.5) T / G from a
    sampler run of ``steps`` respaced steps (default T); a t the respaced
    chain skips yields no batch for that group, as in the reference."""
    G, T = dif.tgq_groups, dif.T
    n_classes = n_classes or dcfg.n_classes
    out = []
    if harvest_trajectory:
        if params is None:
            raise ValueError("harvest_trajectory=True needs params")
        eps_fn = lambda x, t, y, ctx: dit_apply(params, dcfg, x, t, y)
        for g in range(G):
            want = np.array([int((g + 0.5) * T / G)])
            y = torch.randint(0, n_classes, (n_per_group,),
                              generator=generator, device=device)
            shape = (n_per_group, dcfg.img_size, dcfg.img_size, dcfg.in_ch)
            tuples = collect_xt_dataset(eps_fn, dif, sched, shape, y,
                                        generator, steps or T, want,
                                        device=device)
            for xt, t, yy in tuples:
                xt = torch.from_numpy(xt).to(device)
                yy = torch.from_numpy(yy).to(device)
                noise = torch.randn(xt.shape, generator=generator,
                                    device=device)
                for s in range(0, n_per_group, batch):
                    sl = slice(s, s + batch)
                    n = xt[sl].shape[0]
                    out.append(({"xt": xt[sl],
                                 "t": torch.full((n,), t, dtype=torch.int64,
                                                 device=device),
                                 "y": yy[sl], "noise": noise[sl]}, g))
        return out
    for g in range(G):
        lo, hi = g * T // G, (g + 1) * T // G
        for s in range(0, n_per_group, batch):
            b = min(batch, n_per_group - s)
            x0 = x0_source(b, generator)
            t = torch.randint(lo, hi, (b,), generator=generator,
                              device=device)
            y = torch.randint(0, n_classes, (b,), generator=generator,
                              device=device)
            noise = torch.randn(x0.shape, generator=generator, device=device)
            out.append(({"xt": q_sample(sched, x0, t, noise), "t": t,
                         "y": y, "noise": noise}, g))
    return out


def dit_loss_fn(params, dcfg: DiTCfg) -> Callable:
    """DDPM noise-prediction loss routing ops through ``ctx``."""
    def loss(ctx, batch):
        eps = dit_apply(params, dcfg, batch["xt"], batch["t"], batch["y"],
                        ctx=ctx)
        return torch.mean(torch.square(eps.float() - batch["noise"]))
    return loss


def build_lm_calibration(token_batches: List[torch.Tensor]
                         ) -> List[Tuple[Dict[str, Any], int]]:
    """LM calibration: [(batch, 0)] — no diffusion timestep, so a single
    TGQ group (the technique's time axis does not apply). Each batch is
    {'tokens', 'labels'}: labels the next token, -1 past the end."""
    out = []
    for toks in token_batches:
        labels = torch.cat([toks[:, 1:], torch.full(
            (toks.shape[0], 1), -1, dtype=toks.dtype, device=toks.device)],
            dim=1)
        out.append(({"tokens": toks, "labels": labels}, 0))
    return out


def lm_loss_fn(params, cfg) -> Callable:
    """Next-token CE (``models.lm.lm_loss_fn``) routing ops through
    ``ctx``."""
    from repro_torch.models.lm import lm_loss_fn as _lm_loss

    def loss(ctx, batch):
        return _lm_loss(params, cfg, batch, ctx=ctx)[0]
    return loss
