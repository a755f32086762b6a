"""Calibration-set construction (forward-diffusion protocol) and the loss
closure that drives calibration capture — port of the serving-path part
of ``repro/core/calib.py``.

Tuples (x_t, t, y) come from forward diffusion of source latents with a
known noise target; timesteps are drawn uniformly within each TGQ group
G_i = [i*T/G, (i+1)*T/G). Draws come from a seeded ``torch.Generator``
(not bit-equal to the reference's ``jax.random`` draws; the tests hand
both packages the same batches instead).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.diffusion.ddpm import DiffusionCfg, q_sample
from repro_torch.models.dit import DiTCfg, dit_apply


def build_dit_calibration(dcfg: DiTCfg, dif: DiffusionCfg, sched,
                          x0_source: Callable[[int, torch.Generator], Any],
                          generator: torch.Generator, n_per_group: int = 32,
                          batch: int = 8, n_classes: Optional[int] = None,
                          device=None) -> List[Tuple[Dict[str, Any], int]]:
    """[(batch_dict, group)] with ``n_per_group`` samples per group;
    batch_dict = {'xt', 't', 'y', 'noise'}. ``x0_source(n, generator)``
    returns (n, H, W, C) source latents on ``device``."""
    G, T = dif.tgq_groups, dif.T
    n_classes = n_classes or dcfg.n_classes
    out = []
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
