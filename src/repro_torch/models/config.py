"""Unified model configuration covering every architecture family — port
of ``repro/models/config.py`` (``tdtype`` is the torch dtype the
reference's ``jdtype`` names)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.nn.attention import AttnCfg, MLACfg
from repro_torch.nn.mlp import MLPCfg, MoECfg
from repro_torch.nn.ssm import SSDCfg


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                    # dense|moe|ssm|hybrid|audio|vlm|dit
    n_layers: int
    d_model: int
    vocab: int

    # ---- attention -------------------------------------------------------
    attn_type: str = "gqa"         # gqa|mla|none
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None
    global_layers: Tuple[int, ...] = ()   # layers with global attn when window set
    n_meta: int = 0
    # MLA
    kv_lora: int = 0
    q_lora: int = 0
    nope_dim: int = 128
    rope_dim: int = 64
    v_dim: int = 128

    # ---- feedforward -----------------------------------------------------
    d_ff: int = 0
    mlp_act: str = "swiglu"
    mlp_bias: bool = False
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1

    # ---- SSM (mamba2 / hymba) ---------------------------------------------
    ssm: bool = False
    d_inner: int = 0
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # ---- block & embedding layout ------------------------------------------
    block_type: str = "attn_mlp"   # attn_mlp|ssm_only|hymba
    norm: str = "rmsnorm"          # rmsnorm|layernorm
    tie_embeddings: bool = True
    pos_embed: str = "rope"        # rope|learned|sincos_fixed
    max_seq: int = 8192

    # ---- encoder-decoder (whisper) -------------------------------------------
    encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500            # precomputed frame embeddings (frontend stub)

    # ---- runtime -----------------------------------------------------------
    dtype: str = "float32"
    scan_layers: bool = False
    remat: bool = False
    attn_impl: str = "plain"       # plain|qchunk
    q_chunk: int = 512
    grad_accum: int = 1            # microbatches per train step
    attn_sp: Optional[tuple] = None  # SP attention (batch_axes, seq_axis)
    moe_shard: Optional[tuple] = None  # EP dispatch pin (batch_axes, ep_axis)

    # --- derived nn-layer configs ---------------------------------------------
    @property
    def tdtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]

    def attn_cfg(self, window=None, cross=False) -> AttnCfg:
        return AttnCfg(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            qkv_bias=self.qkv_bias, qk_norm=self.qk_norm and not cross,
            rope=(self.pos_embed == "rope") and not cross,
            rope_theta=self.rope_theta, window=window,
            q_chunk=self.q_chunk, out_bias=self.qkv_bias,
            n_meta=self.n_meta if not cross else 0,
            sp_spec=self.attn_sp)

    def mla_cfg(self) -> MLACfg:
        return MLACfg(
            d_model=self.d_model, n_heads=self.n_heads, kv_lora=self.kv_lora,
            q_lora=self.q_lora, nope_dim=self.nope_dim, rope_dim=self.rope_dim,
            v_dim=self.v_dim, rope_theta=self.rope_theta, q_chunk=self.q_chunk)

    def mlp_cfg(self) -> MLPCfg:
        return MLPCfg(self.d_model, self.d_ff, act=self.mlp_act, bias=self.mlp_bias)

    def moe_cfg(self, groups=None) -> MoECfg:
        return MoECfg(
            d_model=self.d_model, d_expert=self.d_expert,
            n_experts=self.n_experts, top_k=self.top_k, n_shared=self.n_shared,
            capacity_factor=self.capacity_factor,
            groups=groups or self.moe_groups, act=self.mlp_act,
            shard_spec=self.moe_shard)

    def ssd_cfg(self) -> SSDCfg:
        return SSDCfg(
            d_model=self.d_model, d_inner=self.d_inner, d_state=self.ssm_state,
            head_dim=self.ssm_head_dim, n_groups=self.ssm_groups,
            chunk=self.ssm_chunk)

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, L = self.d_model, self.n_layers
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        per = 0
        if self.block_type in ("attn_mlp", "hymba"):
            if self.attn_type == "gqa":
                per += d * self.n_heads * self.head_dim * 2          # q, o
                per += d * self.n_kv_heads * self.head_dim * 2       # k, v
            elif self.attn_type == "mla":
                qd = self.nope_dim + self.rope_dim
                per += (self.q_lora and (d * self.q_lora + self.q_lora * self.n_heads * qd)
                        or d * self.n_heads * qd)
                per += d * (self.kv_lora + self.rope_dim)
                per += self.kv_lora * self.n_heads * (self.nope_dim + self.v_dim)
                per += self.n_heads * self.v_dim * d
            if self.moe:
                per += d * self.n_experts                            # router
                per += self.n_experts * 3 * d * self.d_expert
                per += self.n_shared * 3 * d * self.d_expert
            elif self.d_ff:
                per += d * self.d_ff * (2 if self.mlp_act == "gelu" else 3)
        if self.block_type in ("ssm_only", "hymba"):
            di, gs, ns = self.d_inner, self.ssm_groups, self.ssm_state
            per += d * (2 * di + 2 * gs * ns + di // self.ssm_head_dim)
            per += di * d
        if self.encdec:
            # encoder layers: MHA + MLP (counted with same formula)
            enc = d * self.n_heads * self.head_dim * 2 + d * self.n_kv_heads * self.head_dim * 2
            enc += d * self.d_ff * 2
            n += self.n_enc_layers * enc
            per += d * self.n_heads * self.head_dim * 2 + d * self.n_kv_heads * self.head_dim * 2  # cross-attn
        return n + L * per

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        full = self.n_params()
        routed_all = L * self.n_experts * 3 * d * self.d_expert
        routed_act = L * self.top_k * 3 * d * self.d_expert
        return full - routed_all + routed_act
