"""Pointwise feed-forward layers — port of ``repro/nn/mlp.py``: the dense
MLP (GELU or SwiGLU). ``MoECfg`` comes over as data; the mixture of
experts itself (``moe_init`` / ``moe_apply``) waits for ROADMAP queue 1,
item 8(d), and raises."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.diffusion import rng
from repro_torch.nn.ctx import FPContext
from repro_torch.nn.layers import linear_init

_FP = FPContext()
MOE_ITEM = "ROADMAP queue 1, item 8(d) (MoE and MLA)"


# --------------------------------------------------------------------------
# Dense MLP
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MLPCfg:
    d_model: int
    d_ff: int
    act: str = "swiglu"          # 'gelu' | 'swiglu'
    bias: bool = False


def mlp_init(key, cfg: MLPCfg, dtype=torch.float32):
    ks = rng.split(key, 3)
    if cfg.act == "gelu":
        return {
            "fc1": linear_init(ks[0], cfg.d_model, cfg.d_ff, bias=cfg.bias,
                               dtype=dtype),
            "fc2": linear_init(ks[1], cfg.d_ff, cfg.d_model, bias=cfg.bias,
                               dtype=dtype),
        }
    return {
        "gate": linear_init(ks[0], cfg.d_model, cfg.d_ff, bias=cfg.bias,
                            dtype=dtype),
        "up": linear_init(ks[1], cfg.d_model, cfg.d_ff, bias=cfg.bias,
                          dtype=dtype),
        "down": linear_init(ks[2], cfg.d_ff, cfg.d_model, bias=cfg.bias,
                            dtype=dtype),
    }


def mlp_apply(p, cfg: MLPCfg, x, *, ctx=_FP, name="mlp"):
    if cfg.act == "gelu":
        h = ctx.linear(f"{name}/fc1", x, p["fc1"]["w"], p["fc1"].get("b"))
        h = F.gelu(h, approximate="tanh")
        h = ctx.act(f"{name}/gelu", h, "post_gelu")
        return ctx.linear(f"{name}/fc2", h, p["fc2"]["w"], p["fc2"].get("b"))
    g = ctx.linear(f"{name}/gate", x, p["gate"]["w"], p["gate"].get("b"))
    u = ctx.linear(f"{name}/up", x, p["up"]["w"], p["up"].get("b"))
    g = F.silu(g)
    g = ctx.act(f"{name}/silu", g, "post_silu")
    return ctx.linear(f"{name}/down", g * u, p["down"]["w"],
                      p["down"].get("b"))


# --------------------------------------------------------------------------
# Mixture of Experts (configuration only)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    d_expert: int                # per-expert hidden dim
    n_experts: int               # routed experts
    top_k: int
    n_shared: int = 0            # shared experts (each of size d_expert)
    capacity_factor: float = 1.25
    groups: int = 1              # dispatch groups
    act: str = "swiglu"
    norm_topk: bool = True       # renormalize top-k gates to sum 1
    aux_loss_coef: float = 0.01
    shard_spec: Optional[tuple] = None


def moe_init(key, cfg: MoECfg, dtype=torch.float32):
    raise NotImplementedError(f"moe_init: the MoE layer is {MOE_ITEM}")


def moe_apply(p, cfg: MoECfg, x, *, ctx=_FP, name="moe"):
    raise NotImplementedError(f"moe_apply: the MoE layer is {MOE_ITEM}")
