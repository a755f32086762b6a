"""Training steps — the DiT part of ``repro/launch/steps.py``:
``make_dit_train_step`` and ``pick_optimizer_dit``.

PyTorch runs eagerly, so a step is a plain function: the loss of one
batch, its gradients with respect to every parameter (``pos`` included,
as ``jax.value_and_grad`` differentiates it), the optimizer's update and
the new parameters. With ``cfg.remat`` the forward recomputes each
block's activations in the backward (``models/dit.py``), as the
reference's ``runtime_cfg`` sets for ``dit_train``.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten
from repro_torch.diffusion.ddpm import q_sample
from repro_torch.models.dit import DiTCfg, dit_apply
from repro_torch.optim import adamw, apply_updates, cosine_schedule
from repro_torch.optim.optimizers import tree_map


def dit_loss_and_grads(cfg: DiTCfg, sched, params, batch):
    """(loss, gradients) of one batch: the loss ``mean((eps_theta(x_t, t,
    y) - noise)^2)`` and its gradients with respect to every leaf of
    ``params``, as a tree shaped as ``params``. ``batch`` holds ``x0``
    (B, H, W, C) float32, ``t`` and ``y`` (B,) integers and ``noise``
    shaped as ``x0``."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        xt = q_sample(sched, batch["x0"], batch["t"], batch["noise"])
        eps = dit_apply(live, cfg, xt, batch["t"], batch["y"])
        loss = torch.mean(torch.square(eps - batch["noise"]))
        grads = torch.autograd.grad(loss, flatten(live))
    return loss.detach(), unflatten(params, list(grads))


def make_dit_train_step(cfg: DiTCfg, opt, sched):
    """``step(params, opt_state, batch) -> (loss, params, opt_state)``
    (``batch`` as ``dit_loss_and_grads`` takes it)."""
    def step(params, opt_state, batch):
        loss, grads = dit_loss_and_grads(cfg, sched, params, batch)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            return loss, apply_updates(params, updates), opt_state

    return step


def pick_optimizer_dit(cfg: DiTCfg):
    lr = cosine_schedule(1e-4, 1000, 400_000)
    return adamw(lr, weight_decay=0.0), "adamw"
