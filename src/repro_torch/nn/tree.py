"""Parameter trees: nested dicts of tensors, as both packages lay them out."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_trees(trees):
    """A list of same-shaped trees -> one tree, each leaf the list's
    leaves stacked on a new leading axis (as ``jax.vmap`` stacks the
    per-layer parameters of an init)."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def params_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None):
    """A nested dict of numpy arrays (``experiments/*.pkl``, or a
    reference init's leaves through ``np.asarray``) -> the same tree of
    tensors on ``device``; ``dtype`` casts the floating leaves."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.ascontiguousarray(tree)).to(dev)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t
