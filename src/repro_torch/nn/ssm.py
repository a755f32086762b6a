"""Mamba-2 SSD mixer — ``SSDCfg`` from ``repro/nn/ssm.py`` as data (the
model configuration names it); the mixer itself waits for ROADMAP queue
1, item 8(b) (SSM and hybrid), and raises."""
from __future__ import annotations

import dataclasses

SSM_ITEM = "ROADMAP queue 1, item 8(b) (SSM and hybrid)"


@dataclasses.dataclass(frozen=True)
class SSDCfg:
    d_model: int
    d_inner: int                 # = n_heads * head_dim
    d_state: int = 128
    head_dim: int = 64
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


def _waits(name):
    def fn(*a, **kw):
        raise NotImplementedError(f"{name}: the SSD mixer is {SSM_ITEM}")
    fn.__name__ = name
    return fn


ssd_init = _waits("ssd_init")
ssd_apply = _waits("ssd_apply")
ssd_decode = _waits("ssd_decode")
ssd_state_init = _waits("ssd_state_init")
