"""DDPM substrate — port of ``repro/diffusion/ddpm.py``: schedules, the
forward process and the training loss (``ddpm_loss``), respacing, TGQ group lookup, the research sampler of
the quality tables (``ddpm_sample``), the CFG-paired per-request-key
sampler, the slot-wise chunked sampler of the continuous-batching engine
(``make_slot_schedule``, ``ddpm_init_latent``, ``ddpm_chunk_slots``), and
the calibration-side Python-loop sampler and trajectory harvest
(``ddpm_sample_python``, ``collect_xt_dataset``), which share the research
sampler's loop (``ancestral_chain``).

PyTorch runs eagerly, so the reference's ``lax.scan`` is a Python loop.
In the sync sampler the timestep and its TGQ group are host ints; in the
chunked sampler every slot's position, timestep and group are device
tensors and nothing in a chunk reads the device from the host. Every
kernel reads its group's parameters on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
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


def ddpm_loss(eps_fn: Callable, sched, x0, t, y, key):
    """E ||eps - eps_theta(x_t, t)||^2 (Eq. 11); the noise is
    ``rng.normal(key, x0.shape)``, the reference's draw from ``key``."""
    if x0.dtype != torch.float32:
        raise ValueError(f"ddpm_loss draws float32 noise; x0 is {x0.dtype} "
                         "(jax.random.normal draws other dtypes from other "
                         "bits)")
    noise = rng.normal(key, tuple(x0.shape))
    xt = q_sample(sched, x0, t, noise)
    pred = eps_fn(xt, t, y)
    return torch.mean(torch.square(pred - noise))


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


def tgroup_of(t, T: int, G: int):
    """TGQ group g(t) = floor(t*G/T), clamped to [0, G): an int for an
    int ``t``, an int32 tensor (on t's device) for a tensor of timesteps."""
    if isinstance(t, torch.Tensor):
        return torch.clamp((t * G) // T, 0, G - 1).to(torch.int32)
    return min(max((int(t) * G) // T, 0), G - 1)


def request_keys(seeds, device=None):
    """(B,) per-request integer seeds -> (B, 2) threefry keys."""
    return rng.PRNGKey(np.asarray(seeds, np.uint32).astype(np.int64),
                       device=device)


def _f(v):
    """A float32 scalar as a 0-d float32 numpy value (f32 arithmetic)."""
    return np.float32(v)


def step_coefs(rs, idx: int):
    """The update coefficients of respaced index ``idx`` as f32 host
    scalars, formed in the reference's order: ``(sqrt(1 - abar),
    1 / sqrt(abar), c0, c1, sqrt(post_var), sqrt(abar))``, with
    ``mean = c0 * x0 + c1 * x`` and ``x = mean + sv * noise``. Every
    sampler takes them from here, so all round alike on every device:
    numpy's f32 sqrt is correctly rounded (torch's CPU sqrt is not
    always). The serving samplers form ``x0 = (x - s1m * eps) * inv_sa``
    (the f32 reciprocal is what PyTorch's CUDA kernels compute for a
    division by a host scalar); the research and calibration samplers
    divide by ``sqrt(abar)``, as the reference's do."""
    abar, abar_prev = _f(rs["abar"][idx]), _f(rs["abar_prev"][idx])
    beta, alpha = _f(rs["betas"][idx]), _f(rs["alphas"][idx])
    return (np.sqrt(_f(1) - abar), _f(1) / np.sqrt(abar),
            np.sqrt(abar_prev) * beta / (_f(1) - abar),
            np.sqrt(alpha) * (_f(1) - abar_prev) / (_f(1) - abar),
            np.sqrt(_f(rs["post_var"][idx])), np.sqrt(abar))


def ddpm_sample_paired(eps_fn: Callable, cfg: DiffusionCfg, sched, shape, y,
                       seeds, guidance, *, null_label: int,
                       steps: Optional[int] = None, ctx=_FP, device=None):
    """Serving-path ancestral sampler: CFG-paired 2B forwards and
    per-request noise ``normal(fold_in(PRNGKey(seed), i))`` (``i`` the
    step position, ``i = n`` for the initial latent), so a request's
    sample depends only on its seed. The TGQ group of each step reaches
    the model through ``ctx.with_tgroup``.

    y: (B,) labels; seeds: (B,) ints; guidance: (B,) CFG scales.
    Returns (B, H, W, C) float32 samples on ``device`` (default
    ``"cuda"``; raises where CUDA is absent)."""
    dev = resolve_device(device)
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

        s1m, inv_sa, c0, c1, sv, _ = map(float, step_coefs(rs, idx))
        x0 = (x - s1m * eps) * inv_sa
        mean = c0 * x0 + c1 * x
        if idx > 0:
            x = mean + sv * draw(i)
        else:
            x = mean
    return x


# ---------------------------------------------------------------------------
# the research sampler (quality evaluation)
# ---------------------------------------------------------------------------
def ancestral_chain(eps_fn: Callable, cfg: DiffusionCfg, sched, shape, y,
                    draw: Callable, steps: int, ctx_of: Callable,
                    clip_x0: Optional[float] = None, visit=None):
    """The ancestral loop of the research and calibration samplers, one
    forward a respaced step under ``ctx_of(g)`` for the step's TGQ group
    g (a host int). ``draw()`` gives a normal of ``shape``: once for the
    initial latent, then after each step's forward but the last (whose
    noise is multiplied by 0). ``visit(x, t)`` sees each x_t before its
    step. Everything runs on the draws' device; the coefficients are
    host scalars, so nothing is copied between host and device."""
    use_ts = respaced_timesteps(cfg.T, steps)
    rs = respaced_schedule(sched, use_ts)
    n = len(use_ts)
    x = draw()
    for i in range(n):
        t_orig = int(use_ts[i])
        idx = n - 1 - i
        if visit is not None:
            visit(x, t_orig)
        tb = torch.full((shape[0],), t_orig, dtype=torch.int64,
                        device=x.device)
        g = tgroup_of(t_orig, cfg.T, cfg.tgq_groups)
        eps = eps_fn(x, tb, y, ctx_of(g).with_tgroup(g)).float()
        s1m, _, c0, c1, sv, sa = map(float, step_coefs(rs, idx))
        x0 = (x - s1m * eps) / sa
        if clip_x0 is not None:
            x0 = torch.clamp(x0, -clip_x0, clip_x0)
        mean = c0 * x0 + c1 * x
        x = mean + sv * draw() if idx > 0 else mean
    return x


def key_draws(key, shape) -> Callable:
    """The reference's key stream as a ``draw`` for :func:`ancestral_chain`:
    each draw is ``key, k = split(key)``, then ``normal(k, shape)``. The
    reference splits at the last step too, but never uses that key."""
    state = [key]
    shape = tuple(shape)

    def draw():
        state[0], k = rng.split(state[0])
        return rng.normal(k, shape)
    return draw


def ddpm_sample(eps_fn: Callable, cfg: DiffusionCfg, sched, shape, y, key,
                steps: Optional[int] = None, ctx=_FP,
                clip_x0: Optional[float] = None, device=None):
    """Ancestral DDPM sampling with respacing — the research sampler of
    the quality tables (one forward a step, no CFG pairing, one key for
    the whole batch).

    eps_fn(x, t, y, ctx) -> predicted noise, ``t`` the original-chain
    timestep; the context receives the TGQ group of t at every step.
    ``key`` is a threefry key (``rng.PRNGKey``); it is moved to ``device``
    (default ``"cuda"``; raises where CUDA is absent), where the chain
    runs. Returns (B, H, W, C) float32 samples."""
    dev = resolve_device(device)
    with torch.no_grad():
        return ancestral_chain(eps_fn, cfg, sched, shape,
                               torch.as_tensor(y, device=dev),
                               key_draws(key.to(dev), shape),
                               steps or cfg.T, lambda g: ctx, clip_x0)


# ---------------------------------------------------------------------------
# slot-wise chunked sampler (continuous batching)
# ---------------------------------------------------------------------------
_SLOT_FIELDS = ("sqrt_1m_abar", "inv_sqrt_abar", "c0", "c1",
                "sqrt_post_var")


def make_slot_schedule(cfg: DiffusionCfg, sched, step_buckets, device=None):
    """Stacked per-bucket schedules for :func:`ddpm_chunk_slots`, as device
    tensors: per configured bucket (ascending) one row of ``use_ts``
    (descending original-chain timesteps) and of each update coefficient
    of :func:`step_coefs` (ascending respaced index), padded to the
    longest bucket; ``n_of`` holds each bucket's chain length. Padding
    cells are never gathered: a slot's index is clamped into its chain.
    The coefficients are the sync sampler's own f32 host values, so the
    two samplers' updates agree bit for bit."""
    dev = resolve_device(device)
    buckets = tuple(sorted(int(b) for b in step_buckets))
    uts = [respaced_timesteps(cfg.T, b) for b in buckets]
    rss = [respaced_schedule(sched, u) for u in uts]
    n_of = np.asarray([len(u) for u in uts], np.int64)
    n_max = int(n_of.max())
    use_ts = np.zeros((len(buckets), n_max), np.int64)
    stk = {f: np.ones((len(buckets), n_max), np.float32)
           for f in _SLOT_FIELDS}
    for k, (u, rs) in enumerate(zip(uts, rss)):
        use_ts[k, :len(u)] = u
        for idx in range(len(u)):
            for f, c in zip(_SLOT_FIELDS, step_coefs(rs, idx)[:5]):
                stk[f][k, idx] = c
    out = {"buckets": buckets, "n_of": torch.as_tensor(n_of, device=dev),
           "use_ts": torch.as_tensor(use_ts, device=dev)}
    out.update({f: torch.as_tensor(stk[f], device=dev) for f in _SLOT_FIELDS})
    return out


def ddpm_init_latent(seed: int, n: int, sshape, device=None):
    """The initial latent of :func:`ddpm_sample_paired` for one request:
    ``normal(fold_in(PRNGKey(seed), n))`` with ``n`` the request's
    respaced chain length (default device ``"cuda"``)."""
    dev = resolve_device(device)
    return rng.normal(rng.fold_in(rng.PRNGKey(int(seed), device=dev), n),
                      tuple(sshape))


def ddpm_chunk_slots(eps_fn: Callable, cfg: DiffusionCfg, slot_sched, x,
                     pos, bk, y, seeds, guidance, *, null_label: int,
                     chunk: int, ctx=_FP, device=None):
    """Advance every slot ``chunk`` denoising steps from its OWN position.

    ``x[b]`` is slot b's latent, ``pos[b]`` its scan position in bucket
    ``bk[b]``'s respaced chain (``slot_sched`` from
    :func:`make_slot_schedule`); a slot with ``pos >= n_of[bk]`` is
    finished or free, and its latent and position pass through unchanged
    (``torch.where`` gating). y, seeds (uint32 values as int64), guidance
    and the slot state are (B,) device tensors.

    Bit-identity contract: a slot's trajectory equals
    :func:`ddpm_sample_paired` on its request alone — the same
    ``fold_in(PRNGKey(seed), i)`` noise, the same CFG-paired forward
    (conditional half stacked on the unconditional one) and the same f32
    update operations in the same order on the same coefficients
    (gathered per slot where the sync sampler has host scalars). Each step runs the model ONCE on
    the 2B batch, the per-slot timesteps as a vector and the per-slot TGQ
    groups as a (2B,) device vector through ``ctx.with_tgroup``, so the
    ``*_vec`` kernels stream the weights once per step whatever mix of
    timesteps the slots hold. Nothing here reads the device from the
    host: a chunk only enqueues work.

    ``device`` (default ``"cuda"``; raises where CUDA is absent) must be
    the slot state's device. Returns ``(x, pos, bad)``; ``bad[b]`` flags a
    non-finite value in slot b's latent, computed on the device.
    """
    dev = resolve_device(device)
    if x.device.type != dev.type:
        raise ValueError(f"slot state on {x.device}, expected {dev}")
    S = slot_sched
    B = x.shape[0]
    bshape = (B,) + (1,) * (x.ndim - 1)
    sshape = tuple(x.shape[1:])
    n = S["n_of"][bk]                                 # (B,) chain lengths
    yy = torch.cat([y, torch.full_like(y, null_label)])
    gsc = guidance.reshape(bshape)
    keys = rng.PRNGKey(seeds)
    for _ in range(chunk):
        run = pos < n
        i = torch.minimum(pos, n - 1)                 # safe gather when done
        idx = n - 1 - i                               # respaced index (asc)
        t_orig = S["use_ts"][bk, i]                   # (B,) original-chain t
        g = tgroup_of(t_orig, cfg.T, cfg.tgq_groups)
        eps2 = eps_fn(torch.cat([x, x]), torch.cat([t_orig, t_orig]), yy,
                      ctx.with_tgroup(torch.cat([g, g])))
        eps_c, eps_u = eps2[:B], eps2[B:]
        eps = eps_u + gsc * (eps_c - eps_u)

        s1m, inv_sa, c0, c1, sv = (S[f][bk, idx].reshape(bshape)
                                   for f in _SLOT_FIELDS)
        x0 = (x - s1m * eps) * inv_sa
        mean = c0 * x0 + c1 * x
        noise = rng.normal(rng.fold_in(keys, i), sshape)
        nonzero = (idx > 0).to(torch.float32).reshape(bshape)
        xn = mean + nonzero * sv * noise
        x = torch.where(run.reshape(bshape), xn, x)
        pos = torch.where(run, pos + 1, pos)
    bad = ~torch.isfinite(x.reshape(B, -1)).all(dim=1)
    return x, pos, bad


# ---------------------------------------------------------------------------
# calibration-side sampling (Phase 1 of Algorithm 1)
# ---------------------------------------------------------------------------
def _ancestral(eps_fn: Callable, cfg: DiffusionCfg, sched, shape, y,
               generator: torch.Generator, steps: Optional[int], ctx,
               clip_x0: Optional[float], device, visit=None):
    """The research sampler's loop with its draws from ``generator``."""
    dev = resolve_device(device)
    return ancestral_chain(
        eps_fn, cfg, sched, shape, y,
        lambda: torch.randn(shape, generator=generator, device=dev),
        steps or cfg.T, lambda g: ctx, clip_x0, visit)


def ddpm_sample_python(eps_fn: Callable, cfg: DiffusionCfg, sched, shape, y,
                       generator: torch.Generator,
                       steps: Optional[int] = None, ctx=_FP,
                       clip_x0: Optional[float] = None, device=None):
    """Python-loop sampler for calibration capture: eager contexts see
    every step's activations. Draws come from ``generator`` (on
    ``device``, default ``"cuda"``)."""
    with torch.no_grad():
        return _ancestral(eps_fn, cfg, sched, shape, y, generator, steps,
                          ctx, clip_x0, device)


def collect_xt_dataset(eps_fn: Callable, cfg: DiffusionCfg, sched, shape, y,
                       generator: torch.Generator, steps: int, want_ts,
                       ctx=_FP, device=None):
    """Run the sampler and harvest (x_t, t, y) tuples (numpy x_t and y) at
    the requested original-chain timesteps — the calibration set from the
    model's own sampling trajectory (Q-Diffusion / TQ-DiT protocol)."""
    want = set(int(t) for t in want_ts)
    out = []

    def visit(x, t):
        if t in want:
            out.append((x.detach().cpu().numpy(), t,
                        torch.as_tensor(y).cpu().numpy()))
    with torch.no_grad():
        _ancestral(eps_fn, cfg, sched, shape, y, generator, steps, ctx,
                   None, device, visit)
    return out
