"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE: 384 routed experts
top-8 + 1 shared. 61L d_model=7168 64H (GQA kv=8 per assignment)
d_expert=2048 vocab=163840. [arXiv:2501.kimi2; unverified, paper-table]
"""
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, vocab=163840,
        attn_type="gqa", n_heads=64, n_kv_heads=8, head_dim=128,
        qkv_bias=False, rope_theta=5e6,
        moe=True, n_experts=384, top_k=8, n_shared=1, d_expert=2048,
        d_ff=0, mlp_act="swiglu", capacity_factor=1.25,
        norm="rmsnorm", tie_embeddings=False, pos_embed="rope",
        max_seq=131072, dtype="bfloat16",
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="kimi-k2-smoke", family="moe",
        n_layers=2, d_model=64, vocab=256,
        attn_type="gqa", n_heads=4, n_kv_heads=2, head_dim=16,
        moe=True, n_experts=8, top_k=2, n_shared=1, d_expert=32,
        d_ff=0, mlp_act="swiglu",
        norm="rmsnorm", tie_embeddings=False, max_seq=1024,
    )
