"""Timestep-group resolution — port of ``repro/quant/groups.py``.

``resolve_group(g, n_groups)`` clamps a serving-side group into
``[0, n_groups)`` (None and per-tensor packs resolve to 0); a per-slot
(B,) group vector (the continuous-batching path) is clamped elementwise
on its device, with no host read, and stays a tensor;
``resolve_group(g, calibrated=...)`` returns the nearest calibrated group
(ties toward the smaller one) for the calibration side.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def resolve_group(g, n_groups: Optional[int] = None, *,
                  calibrated: Optional[Sequence[int]] = None):
    if calibrated is not None:
        if not len(calibrated):
            raise ValueError("resolve_group: empty `calibrated` sequence")
        return min(calibrated, key=lambda x: abs(int(x) - int(g)))
    if n_groups is None:
        raise ValueError("resolve_group: need n_groups (or calibrated=)")
    if g is None or n_groups == 1:
        return 0
    if isinstance(g, torch.Tensor) and g.ndim == 1:
        return torch.clamp(g.to(torch.int32), 0, n_groups - 1)
    return min(max(int(g), 0), n_groups - 1)


def group_boundaries(T: int, G: int) -> List[Tuple[int, int]]:
    """[(lo, hi)) original-chain timestep range of each TGQ group."""
    return [(g * T // G, (g + 1) * T // G) for g in range(G)]
