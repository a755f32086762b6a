"""Quality evaluation of (quantized) DiT contexts — port of
``repro/quant/eval.py``, the library behind the quality tables
(``launch/tables.py``) and, later, autotune.

- :func:`eval_assets` — real latents, feature net and class proxy for
  the FD / sFD / IS* metrics (``core.metrics``, numpy), cached under an
  explicit key of every input that shapes them (and the device whose
  draws built the latents).
- :func:`generate` — ``n`` samples through the model with the research
  sampler (``diffusion.ddpm.ddpm_sample``), following the reference's
  key stream; each batch goes to the host once.
- :func:`generate_grouped` — the same chain with a per-TGQ-group context
  (mixed precision). Both run one loop (``ddpm.ancestral_chain``), so a
  constant map gives :func:`generate`'s samples bit for bit.
- :func:`score` — FD / sFD / IS* against the cached assets.
- :func:`noise_mse` / :func:`noise_mse_by_group` — quantized-vs-FP noise
  prediction MSE, overall or per TGQ group (one float to the host a
  group).

Every entry point takes ``device`` (default ``"cuda"``; raises where
CUDA is absent). Keys are the port's threefry keys, so the labels are
the reference's bit for bit and the normals within a few ulps.
"""
from __future__ import annotations

from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from repro_torch.core.metrics import (
    ClassProxy, FeatureNet, fd_score, inception_score_proxy, sfd_score,
)
from repro_torch.data.synthetic import LatentPipeline
from repro_torch.device import resolve_device
from repro_torch.diffusion import rng
from repro_torch.diffusion.ddpm import (
    DiffusionCfg, ancestral_chain, key_draws, make_schedule, q_sample,
)
from repro_torch.models.dit import dit_apply
from repro_torch.nn.ctx import FPContext

# a per-group context spec: one context for every group, or an explicit
# group -> context mapping (dict keyed by int, or a G-long sequence)
CtxOfGroup = Union[Dict[int, object], List[object], Tuple[object, ...]]


def make_pipeline(model_cfg, *, pipe_seed: int = 11,
                  pipe_noise: float = 0.3) -> LatentPipeline:
    """The synthetic latent data source matching ``model_cfg``'s shape."""
    return LatentPipeline(model_cfg.img_size, model_cfg.in_ch,
                          model_cfg.n_classes, seed=pipe_seed,
                          noise=pipe_noise)


# ---------------------------------------------------------------------------
# eval assets (real set + feature nets), cached under an explicit key
# ---------------------------------------------------------------------------
_ASSET_CACHE: Dict[tuple, tuple] = {}


def asset_cache_key(model_cfg, n_real: int, data_seed: int, net_seed: int,
                    pipe_seed: int, pipe_noise: float,
                    device: str = "cuda") -> tuple:
    """The full identity of one assets build. ``model_cfg`` is a frozen
    dataclass (hashable); every other field is a scalar. ``device`` is
    where the real latents were drawn (normals differ by ulps between
    devices). Two calls share a cache entry iff they would have built
    identical assets."""
    return (model_cfg, int(n_real), int(data_seed), int(net_seed),
            int(pipe_seed), float(pipe_noise), str(device))


def eval_assets(model_cfg, *, n_real: int = 1024, data_seed: int = 999,
                net_seed: int = 1234, pipe_seed: int = 11,
                pipe_noise: float = 0.3, device=None):
    """(real latents, labels, feature net, class proxy), numpy — cached
    per :func:`asset_cache_key`. The latents are drawn on ``device``."""
    dev = resolve_device(device)
    key = asset_cache_key(model_cfg, n_real, data_seed, net_seed,
                          pipe_seed, pipe_noise, dev.type)
    if key not in _ASSET_CACHE:
        pipe = make_pipeline(model_cfg, pipe_seed=pipe_seed,
                             pipe_noise=pipe_noise)
        real, labels = pipe.labeled_set(n_real,
                                        rng.PRNGKey(data_seed, device=dev))
        net = FeatureNet.make(int(np.prod(real.shape[1:])), seed=net_seed)
        proxy = ClassProxy.fit(real, labels, model_cfg.n_classes)
        _ASSET_CACHE[key] = (real, labels, net, proxy)
    return _ASSET_CACHE[key]


def clear_eval_caches() -> None:
    _ASSET_CACHE.clear()


def score(gen: np.ndarray, model_cfg, *, n_real: int = 1024,
          data_seed: int = 999, net_seed: int = 1234, pipe_seed: int = 11,
          pipe_noise: float = 0.3, device=None) -> dict:
    """FD / sFD / IS* of ``gen`` (numpy) against the cached real assets."""
    real, _, net, proxy = eval_assets(
        model_cfg, n_real=n_real, data_seed=data_seed, net_seed=net_seed,
        pipe_seed=pipe_seed, pipe_noise=pipe_noise, device=device)
    return {
        "FD": round(fd_score(real, gen, net), 3),
        "sFD": round(sfd_score(real, gen), 3),
        "IS*": round(inception_score_proxy(gen, proxy), 3),
    }


# ---------------------------------------------------------------------------
# sampling through a (possibly quantized) model
# ---------------------------------------------------------------------------
def _eps_fn(params, model_cfg):
    return lambda x, t, y, c: dit_apply(params, model_cfg, x, t, y, ctx=c)


def _generate(params, model_cfg, dif_cfg: DiffusionCfg, ctx_of, *,
              steps: int, n: int, seed: int, batch: int, sched, device):
    """The batches of :func:`generate`: per batch ``key, k1, k2 =
    split(key, 3)``, labels ``randint(k1)``, the chain from ``k2``."""
    dev = resolve_device(device)
    sched = sched if sched is not None else make_schedule(dif_cfg)
    eps = _eps_fn(params, model_cfg)
    outs, labels = [], []
    key = rng.PRNGKey(seed, device=dev)
    with torch.no_grad():
        for s in range(0, n, batch):
            b = min(batch, n - s)
            key, k1, k2 = rng.split(key, 3)
            y = rng.randint(k1, (b,), 0, model_cfg.n_classes)
            shape = (b, model_cfg.img_size, model_cfg.img_size,
                     model_cfg.in_ch)
            x = ancestral_chain(eps, dif_cfg, sched, shape, y,
                                key_draws(k2, shape), steps, ctx_of)
            outs.append(x.cpu().numpy())
            labels.append(y.cpu().numpy().astype(np.int32))
    return np.concatenate(outs), np.concatenate(labels)


def generate(params, model_cfg, dif_cfg: DiffusionCfg, *, ctx=None,
             steps: int = 50, n: int = 128, seed: int = 123,
             batch: int = 64, sched=None, device=None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Sample ``n`` latents (+ labels), numpy, with the research sampler
    (``ddpm_sample``'s chain) on ``device``."""
    ctx = ctx or FPContext()
    return _generate(params, model_cfg, dif_cfg, lambda g: ctx, steps=steps,
                     n=n, seed=seed, batch=batch, sched=sched, device=device)


def generate_grouped(params, model_cfg, dif_cfg: DiffusionCfg,
                     ctx_of_group: CtxOfGroup, *, steps: int = 50,
                     n: int = 128, seed: int = 123, batch: int = 64,
                     sched=None, device=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`generate` with a per-TGQ-group context (mixed precision):
    group g's steps run under ``ctx_of_group[g]``. The same loop as
    :func:`generate`, so a constant map gives its samples bit for bit."""
    return _generate(params, model_cfg, dif_cfg,
                     ctx_of_group.__getitem__, steps=steps, n=n,
                     seed=seed, batch=batch, sched=sched, device=device)


# ---------------------------------------------------------------------------
# noise-prediction MSE (the cheap stage-1 signal + sensitivity vector)
# ---------------------------------------------------------------------------
def noise_mse_by_group(params, model_cfg, dif_cfg: DiffusionCfg, ctx, *,
                       n: int = 128, seed: int = 55, pipe_seed: int = 11,
                       pipe_noise: float = 0.3, device=None) -> List[float]:
    """Quantized-vs-FP noise prediction MSE, one value per TGQ group: per
    group ``key, k1, k2, k3 = split(key, 4)``, ``n // G`` pipeline samples
    from k1 at timesteps ``randint(k2)`` in the group's range, noise from
    k3, and the FP and quantized forwards on the same ``q_sample`` input;
    the f32 mean of the squared difference.

    ``ctx`` may also be a per-group context spec (see :data:`CtxOfGroup`)
    — group g's MSE is then measured under group g's context."""
    dev = resolve_device(device)
    sched = make_schedule(dif_cfg)
    pipe = make_pipeline(model_cfg, pipe_seed=pipe_seed,
                         pipe_noise=pipe_noise)
    key = rng.PRNGKey(seed, device=dev)
    G, T = dif_cfg.tgq_groups, dif_cfg.T
    per_group = isinstance(ctx, (dict, list, tuple))
    out = []
    with torch.no_grad():
        for g in range(G):
            key, k1, k2, k3 = rng.split(key, 4)
            x0, y = pipe.sample(max(n // G, 1), k1)
            t = rng.randint(k2, (x0.shape[0],), g * T // G,
                            (g + 1) * T // G)
            noise = rng.normal(k3, tuple(x0.shape))
            xt = q_sample(sched, x0, t, noise)
            gctx = ctx[g] if per_group else ctx
            fp = dit_apply(params, model_cfg, xt, t, y).float()
            qt = dit_apply(params, model_cfg, xt, t, y,
                           ctx=gctx.with_tgroup(g)).float()
            out.append(float(torch.mean((fp - qt) ** 2)))
    return out


def noise_mse(params, model_cfg, dif_cfg: DiffusionCfg, ctx, *,
              n: int = 128, seed: int = 55, pipe_seed: int = 11,
              pipe_noise: float = 0.3, device=None) -> float:
    """Mean of :func:`noise_mse_by_group` — the scalar the quality tables
    report."""
    return float(np.mean(noise_mse_by_group(
        params, model_cfg, dif_cfg, ctx, n=n, seed=seed,
        pipe_seed=pipe_seed, pipe_noise=pipe_noise, device=device)))
