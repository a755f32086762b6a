"""DDPM substrate for serving — port of the sync-serving part of
``repro/diffusion/ddpm.py``: schedules, the forward process, respacing,
TGQ group lookup and the CFG-paired per-request-key sampler.

PyTorch runs eagerly, so the reference's ``lax.scan`` is a Python loop;
the timestep and its TGQ group are host ints, and every kernel reads the
group's parameters on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.diffusion import rng
from repro_torch.nn.ctx import FPContext

_FP = FPContext()


@dataclasses.dataclass(frozen=True)
class DiffusionCfg:
    T: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    schedule: str = "linear"       # linear | cosine
    tgq_groups: int = 10


def _f32(sched: dict, device=None) -> dict:
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in sched.items()}


def make_schedule(cfg: DiffusionCfg, device=None):
    """dict of (T,) float32 schedule tensors (computed in float64 numpy)."""
    if cfg.schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, cfg.T,
                            dtype=np.float64)
    elif cfg.schedule == "cosine":
        s = 0.008
        ts = np.arange(cfg.T + 1, dtype=np.float64) / cfg.T
        f = np.cos((ts + s) / (1 + s) * np.pi / 2) ** 2
        betas = np.clip(1 - f[1:] / f[:-1], 0, 0.999)
    else:
        raise ValueError(cfg.schedule)
    alphas = 1.0 - betas
    abar = np.cumprod(alphas)
    abar_prev = np.concatenate([[1.0], abar[:-1]])
    post_var = betas * (1.0 - abar_prev) / (1.0 - abar)
    return _f32({
        "betas": betas, "alphas": alphas, "abar": abar,
        "abar_prev": abar_prev, "sqrt_abar": np.sqrt(abar),
        "sqrt_1m_abar": np.sqrt(1 - abar), "post_var": post_var,
        "post_logvar": np.log(np.maximum(post_var, 1e-20)),
    }, device)


def q_sample(sched, x0, t, noise):
    """x_t = sqrt(abar_t) x0 + sqrt(1-abar_t) eps; t: (B,) int."""
    shape = (-1,) + (1,) * (x0.ndim - 1)
    a = sched["sqrt_abar"].to(x0.device)[t].reshape(shape)
    b = sched["sqrt_1m_abar"].to(x0.device)[t].reshape(shape)
    return a * x0 + b * noise


def respaced_timesteps(T: int, steps: int) -> np.ndarray:
    """Evenly respaced subset of {0..T-1}, descending (sampling order)."""
    ts = np.linspace(0, T - 1, steps).round().astype(np.int64)
    return np.unique(ts)[::-1].copy()


def respaced_schedule(sched, use_ts: np.ndarray):
    """Alphas/betas over the respaced chain (Nichol & Dhariwal), as float32
    numpy arrays — the reference's numpy arithmetic verbatim."""
    abar = np.asarray(sched["abar"].cpu())[use_ts[::-1]]          # ascending
    abar_prev = np.concatenate([[1.0], abar[:-1]])
    alphas = abar / abar_prev
    betas = 1.0 - alphas
    post_var = betas * (1.0 - abar_prev) / (1.0 - abar)
    f = lambda a: np.asarray(a, np.float32)
    return {"betas": f(betas), "alphas": f(alphas), "abar": f(abar),
            "abar_prev": f(abar_prev), "sqrt_abar": f(np.sqrt(abar)),
            "sqrt_1m_abar": f(np.sqrt(1 - abar)), "post_var": f(post_var),
            "post_logvar": f(np.log(np.maximum(post_var, 1e-20)))}


def tgroup_of(t: int, T: int, G: int) -> int:
    """TGQ group g(t) = floor(t*G/T), clamped to [0, G)."""
    return min(max((int(t) * G) // T, 0), G - 1)


def request_keys(seeds, device=None):
    """(B,) per-request integer seeds -> (B, 2) threefry keys."""
    return rng.PRNGKey(np.asarray(seeds, np.uint32).astype(np.int64),
                       device=device)


def _f(v):
    """A float32 scalar as a 0-d float32 numpy value (f32 arithmetic)."""
    return np.float32(v)


def ddpm_sample_paired(eps_fn: Callable, cfg: DiffusionCfg, sched, shape, y,
                       seeds, guidance, *, null_label: int,
                       steps: Optional[int] = None, ctx=_FP, device=None):
    """Serving-path ancestral sampler: CFG-paired 2B forwards and
    per-request noise ``normal(fold_in(PRNGKey(seed), i))`` (``i`` the
    step position, ``i = n`` for the initial latent), so a request's
    sample depends only on its seed. The TGQ group of each step reaches
    the model through ``ctx.with_tgroup``.

    y: (B,) labels; seeds: (B,) ints; guidance: (B,) CFG scales.
    Returns (B, H, W, C) float32 samples."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    steps = steps or cfg.T
    use_ts = respaced_timesteps(cfg.T, steps)
    rs = respaced_schedule(sched, use_ts)
    n = len(use_ts)
    B = shape[0]
    keys = request_keys(seeds, device=dev)
    sshape = tuple(shape[1:])

    def draw(salt):
        return rng.normal(rng.fold_in(keys, salt), sshape)

    gsc = torch.as_tensor(np.asarray(guidance, np.float32), device=dev
                          ).reshape((B,) + (1,) * (len(shape) - 1))
    yy = torch.cat([torch.as_tensor(np.asarray(y, np.int64), device=dev),
                    torch.full((B,), null_label, dtype=torch.int64,
                               device=dev)])
    x = draw(n)
    for i in range(n):
        t_orig = int(use_ts[i])
        idx = n - 1 - i
        tb = torch.full((2 * B,), t_orig, dtype=torch.int64, device=dev)
        g = tgroup_of(t_orig, cfg.T, cfg.tgq_groups)
        eps2 = eps_fn(torch.cat([x, x]), tb, yy, ctx.with_tgroup(g))
        eps_c, eps_u = eps2[:B], eps2[B:]
        eps = eps_u + gsc * (eps_c - eps_u)

        abar, abar_prev = _f(rs["abar"][idx]), _f(rs["abar_prev"][idx])
        beta, alpha = _f(rs["betas"][idx]), _f(rs["alphas"][idx])
        x0 = (x - float(np.sqrt(_f(1) - abar)) * eps) / float(np.sqrt(abar))
        c0 = float(np.sqrt(abar_prev) * beta / (_f(1) - abar))
        c1 = float(np.sqrt(alpha) * (_f(1) - abar_prev) / (_f(1) - abar))
        mean = c0 * x0 + c1 * x
        if idx > 0:
            x = mean + float(np.sqrt(_f(rs["post_var"][idx]))) * draw(i)
        else:
            x = mean
    return x
