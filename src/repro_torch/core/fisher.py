"""Hessian-guided optimization (HO) — the Fisher weights (§III-B), port of
``repro/core/fisher.py``.

The pre-activation Hessian is approximated by the diagonal empirical
Fisher diag((dL/dz)^2) (Eq. 15). dL/dz of EVERY op output z comes from one
backward pass: a zero "tap" tensor is added at each op output
(``TapContext``) and ``torch.autograd.grad`` differentiates the loss with
respect to the taps.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core.contexts import ShapeContext, TapContext, _subsample_rows
from repro_torch.device import resolve_device


def discover_tap_shapes(loss_fn: Callable, batch) -> Dict[str, tuple]:
    """One forward through the loss with a ``ShapeContext``; returns
    {op_name: (shape, dtype)} for every op output."""
    ctx = ShapeContext()
    with torch.no_grad():
        loss_fn(ctx, batch)
    return ctx.shapes


def make_fisher_fn(loss_fn: Callable, tap_shapes: Dict[str, tuple],
                   device=None):
    """Returns fisher(batch) -> {name: dL/dz tensor} (NOT squared), the
    taps made on ``device`` (default ``"cuda"``). A tap the loss does not
    reach (an op it never calls, or a call site of another shape) gets a
    zero gradient, as ``jax.grad`` gives, so its op keeps the Fisher
    weighting (of zeros) rather than losing it."""
    dev = resolve_device(device)

    def fisher(batch):
        taps = {n: torch.zeros(s, dtype=d, device=dev, requires_grad=True)
                for n, (s, d) in tap_shapes.items()}
        names = list(taps)
        with torch.enable_grad():
            loss = loss_fn(TapContext(taps=taps), batch)
            grads = torch.autograd.grad(loss, [taps[n] for n in names],
                                        allow_unused=True)
        return {n: torch.zeros_like(taps[n]).detach() if g is None else g
                for n, g in zip(names, grads)}

    return fisher


def subsample_rows_like(g, max_rows: int, seed: int) -> np.ndarray:
    """The rows ``CalibrationContext`` stores for an op (flatten leading
    dims, the same seeded subset), so Fisher rows align with the stored
    activation rows."""
    return _subsample_rows(g, max_rows, seed)
