"""qwen3-1.7b [dense] — qk_norm, GQA (kv=8), no QKV bias.
28L d_model=2048 16H d_ff=6144 vocab=151936. [hf:Qwen/Qwen3; hf]
"""
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="qwen3-1.7b", family="dense",
        n_layers=28, d_model=2048, vocab=151936,
        attn_type="gqa", n_heads=16, n_kv_heads=8, head_dim=128,
        qkv_bias=False, qk_norm=True, rope_theta=1e6,
        d_ff=6144, mlp_act="swiglu",
        norm="rmsnorm", tie_embeddings=True, pos_embed="rope",
        max_seq=32768, dtype="bfloat16",
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="qwen3-smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        attn_type="gqa", n_heads=4, n_kv_heads=2, head_dim=16,
        qk_norm=True, d_ff=128, mlp_act="swiglu",
        norm="rmsnorm", tie_embeddings=True, max_seq=1024,
    )
