"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed
experts top-6. 60L d_model=5120 128H d_expert=1536 vocab=102400.
[arXiv:2405.04434; hf]

Deviation noted in DESIGN: the real model's first layer is a dense MLP;
we keep all layers MoE so the stacked-layer scan stays uniform.
"""
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, vocab=102400,
        attn_type="mla", n_heads=128,
        kv_lora=512, q_lora=1536, nope_dim=128, rope_dim=64, v_dim=128,
        moe=True, n_experts=160, top_k=6, n_shared=2, d_expert=1536,
        d_ff=0, mlp_act="swiglu", capacity_factor=1.25,
        norm="rmsnorm", tie_embeddings=False, pos_embed="rope",
        max_seq=32768, dtype="bfloat16",
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="deepseek-v2-smoke", family="moe",
        n_layers=2, d_model=64, vocab=256,
        attn_type="mla", n_heads=4,
        kv_lora=32, q_lora=32, nope_dim=16, rope_dim=8, v_dim=16,
        moe=True, n_experts=8, top_k=2, n_shared=1, d_expert=32,
        d_ff=0, mlp_act="swiglu",
        norm="rmsnorm", tie_embeddings=False, max_seq=1024,
    )
