"""Optimizers: AdamW and Adafactor (factored second moment), plus global-
norm clipping, schedules, gradient accumulation, and int8 gradient
compression with error feedback — port of ``repro/optim/optimizers.py``.

The same functional optax-style API on nested dicts of tensors:
  opt = adamw(lr=...); state = opt.init(params);
  updates, state = opt.update(grads, state, params);
  params = apply_updates(params, updates).

Computed as the reference computes it: the step counter is an int32 0-d
tensor; the learning rate and the bias corrections are float32 tensors;
every moment is float32 whatever the parameter's dtype; the gradients
are clipped first and an update is cast to its parameter's dtype last.
Call ``update`` under ``torch.no_grad()``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

_F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable
    update: Callable          # (grads, state, params) -> (updates, state)


# ---------------------------------------------------------------------------
# trees: nested dicts of tensors (dict keys sorted, as jax.tree flattens)
# ---------------------------------------------------------------------------
def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    return [tree]


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32, device=like.device)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable:
    def lr(step):
        step = torch.as_tensor(step).to(_F32)
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_schedule(lr_val: float) -> Callable:
    return lambda step: _f32(lr_val, torch.as_tensor(step))


# ---------------------------------------------------------------------------
# global-norm clip
# ---------------------------------------------------------------------------
def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.to(_F32)))
                          for l in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    # a float32 0-d array promotes a bf16 gradient to float32 in JAX
    return tree_map(lambda g: g.to(torch.promote_types(g.dtype, _F32))
                    * scale, grads), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw(lr: Callable | float, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          max_grad_norm: Optional[float] = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        dev = tree_leaves(params)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device)
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(grads, state, params):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state["step"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(_F32),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
            g.to(_F32)), state["nu"], grads)
        fstep = step.to(_F32)
        bc1 = 1 - torch.pow(_f32(b1, fstep), fstep)
        bc2 = 1 - torch.pow(_f32(b2, fstep), fstep)
        lr_t = lr_fn(step)

        def upd(p, m, v):
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(_F32)
            return (-lr_t * u).to(p.dtype)

        updates = tree_map(upd, params, mu, nu)
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init=init, update=update)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018) — factored 2nd moment, no 1st moment
# ---------------------------------------------------------------------------
def adafactor(lr: Callable | float, eps: float = 1e-30,
              clip_threshold: float = 1.0, decay: float = 0.8,
              weight_decay: float = 0.0,
              max_grad_norm: Optional[float] = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else constant_schedule(lr)

    def _factored(shape):
        return len(shape) >= 2

    def init(params):
        def per(p):
            z = lambda shape: torch.zeros(shape, dtype=_F32, device=p.device)
            if _factored(p.shape):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        dev = tree_leaves(params)[0].device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "v": tree_map(per, params)}

    def update(grads, state, params):
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state["step"] + 1
        beta = 1.0 - torch.pow(step.to(_F32), -decay)
        lr_t = lr_fn(step)

        def upd(p, g, v):
            g = g.to(_F32)
            g2 = torch.square(g) + eps
            if _factored(p.shape):
                vr = beta * v["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * v["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                     min=eps)
                u = g / (torch.sqrt(r)[..., None]
                         * torch.sqrt(vc)[..., None, :] + eps)
                nv = {"vr": vr, "vc": vc}
            else:
                nvv = beta * v["v"] + (1 - beta) * g2
                u = g / (torch.sqrt(nvv) + eps)
                nv = {"v": nvv}
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.to(_F32)
            return (-lr_t * u).to(p.dtype), nv

        # per-parameter state dicts ride along as leaves: tree_map
        # descends by params' keys only
        outs = tree_map(upd, params, grads, state["v"])
        return (_split(outs, 0), {"step": step, "v": _split(outs, 1)})

    return Optimizer(init=init, update=update)


def _split(outs, i):
    if isinstance(outs, dict):
        return {k: _split(o, i) for k, o in outs.items()}
    return outs[i]


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


# ---------------------------------------------------------------------------
# gradient accumulation
# ---------------------------------------------------------------------------
def accumulate_grads(loss_and_grad_fn: Callable, params, batches):
    """Average grads over a leading microbatch axis (a loop in place of
    the reference's ``lax.scan``). batches: a tree with leading
    (n_micro, ...) axes; ``loss_and_grad_fn(params, mb)`` returns
    ``((loss, aux), grads)``. Returns (grads, mean loss, aux stacked on a
    leading axis, or None)."""
    n = tree_leaves(batches)[0].shape[0]
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                         device=p.device), params)
    loss_sum = torch.zeros((), dtype=_F32,
                           device=tree_leaves(params)[0].device)
    auxs = []
    for i in range(n):
        (loss, aux), g = loss_and_grad_fn(
            params, tree_map(lambda b: b[i], batches))
        acc = tree_map(torch.add, acc, g)
        loss_sum = loss_sum + loss
        auxs.append(aux)
    grads = tree_map(lambda a: a / n, acc)
    aux = None if auxs[0] is None else tree_map(
        lambda *a: torch.stack(a), *auxs)
    return grads, loss_sum / n, aux


# ---------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ---------------------------------------------------------------------------
def compress_grads_int8(grads, error_state):
    """Quantize gradients to int8 (per-leaf symmetric scale) with error
    feedback: the residual is carried to the next step so compression
    noise is unbiased over time. Returns (decompressed_grads,
    new_error_state)."""
    def per(g, e):
        g = g.to(_F32) + e
        s = torch.clamp(torch.max(torch.abs(g)) / 127.0, min=1e-12)
        q = torch.clamp(torch.round(g / s), -127, 127)
        deq = q * s
        return deq, g - deq

    outs = tree_map(per, grads, error_state)
    return _split(outs, 0), _split(outs, 1)


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=_F32,
                                          device=p.device), params)
