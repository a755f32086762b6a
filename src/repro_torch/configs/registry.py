"""Architecture registry (port of ``repro/configs/registry.py``): ``get(arch_id)`` -> full ModelCfg/DiTCfg;
``get_smoke(arch_id)`` -> reduced same-family config for CPU smoke tests.

Every entry matches the assigned public config exactly (see per-file
provenance comments). ``--arch <id>`` in the launchers resolves here.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict

ARCHS = (
    "whisper-tiny", "mamba2-130m", "qwen2.5-3b", "qwen3-1.7b", "stablelm-3b",
    "qwen2.5-14b", "hymba-1.5b", "deepseek-v2-236b", "kimi-k2-1t-a32b",
    "chameleon-34b", "dit-xl-2",
)

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def _module(arch: str):
    if arch not in _MOD:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[arch]}")


def get(arch: str, **overrides):
    cfg = _module(arch).full()
    if overrides:
        import dataclasses
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_smoke(arch: str, **overrides):
    cfg = _module(arch).smoke()
    if overrides:
        import dataclasses
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


# ---------------------------------------------------------------------------
# assigned input shapes (LM family; per-arch applicability in launch/shapes)
# ---------------------------------------------------------------------------
SHAPES: Dict[str, dict] = {
    "train_4k":    {"kind": "train",   "seq": 4096,   "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768,  "batch": 32},
    "decode_32k":  {"kind": "decode",  "seq": 32768,  "batch": 128},
    "long_500k":   {"kind": "decode",  "seq": 524288, "batch": 1},
}

# archs with sub-quadratic token mixing run long_500k; pure full-attention
# archs skip it (assignment rule; DESIGN §6).
SUBQUADRATIC = {"mamba2-130m", "hymba-1.5b"}

# DiT-specific shape set (the paper's own model; extra beyond the 40 cells)
DIT_SHAPES: Dict[str, dict] = {
    "train_256":  {"kind": "dit_train",  "batch": 256},
    "sample_128": {"kind": "dit_sample", "batch": 128},
}


def cells(arch: str):
    """Valid (shape_id, meta) pairs for an arch (assignment matrix)."""
    if arch == "dit-xl-2":
        return list(DIT_SHAPES.items())
    out = []
    for sid, meta in SHAPES.items():
        if sid == "long_500k" and arch not in SUBQUADRATIC:
            continue
        out.append((sid, meta))
    return out
