"""Baseline PTQ schemes (§IV-A) as PTQConfig presets — port of
``repro/core/baselines.py``.

All schemes consume the SAME calibration protocol so comparisons isolate
the quantizer/optimizer design, matching the paper's setup ("the same
number of calibration samples for all baseline schemes"):

  - baseline      — uniform quantizers, plain-MSE search (ablation row a)
  - q_diffusion   — Q-Diffusion-like: time-distributed calibration +
                    uniform quantizers with MSE search (on DiT)
  - ptqd          — PTQD-like: baseline + quantization-noise bias
                    correction on linear outputs
  - ptq4dit       — PTQ4DiT-like: salience-based channel balancing
                    (activation<->weight magnitude redistribution) before
                    MSE search; heavier calibration (Table IV)
  - tq_dit        — the paper: HO + MRQ + TGQ
  - ablations     — +HO, +HO+MRQ rows of Table III
"""
from __future__ import annotations

from repro_torch.core.ptq import PTQConfig


def baseline(w: int = 8, a: int = 8, **kw) -> PTQConfig:
    return PTQConfig(wbits=w, abits=a, use_fisher=False, use_mrq=False,
                     use_tgq=False, **kw)


def q_diffusion(w: int = 8, a: int = 8, **kw) -> PTQConfig:
    # time-distributed calibration is supplied by Phase 1; quantizer side
    # is uniform + MSE.
    return PTQConfig(wbits=w, abits=a, use_fisher=False, use_mrq=False,
                     use_tgq=False, **kw)


def ptqd(w: int = 8, a: int = 8, **kw) -> PTQConfig:
    return PTQConfig(wbits=w, abits=a, use_fisher=False, use_mrq=False,
                     use_tgq=False, bias_correct=True, **kw)


def ptq4dit(w: int = 8, a: int = 8, **kw) -> PTQConfig:
    # salience redistribution + larger capture (the benchmark feeds it a
    # bigger calibration set per Table IV's overhead comparison).
    kw.setdefault("max_rows_per_batch", 1024)
    return PTQConfig(wbits=w, abits=a, use_fisher=True, use_mrq=False,
                     use_tgq=False, channel_balance=True, **kw)


def tq_dit(w: int = 8, a: int = 8, **kw) -> PTQConfig:
    return PTQConfig(wbits=w, abits=a, use_fisher=True, use_mrq=True,
                     use_tgq=True, **kw)


def ablation_ho(w: int = 8, a: int = 8, **kw) -> PTQConfig:
    return PTQConfig(wbits=w, abits=a, use_fisher=True, use_mrq=False,
                     use_tgq=False, **kw)


def ablation_ho_mrq(w: int = 8, a: int = 8, **kw) -> PTQConfig:
    return PTQConfig(wbits=w, abits=a, use_fisher=True, use_mrq=True,
                     use_tgq=False, **kw)


SCHEMES = {
    "baseline": baseline,
    "q_diffusion": q_diffusion,
    "ptqd": ptqd,
    "ptq4dit": ptq4dit,
    "tq_dit": tq_dit,
    "+HO": ablation_ho,
    "+HO+MRQ": ablation_ho_mrq,
}
