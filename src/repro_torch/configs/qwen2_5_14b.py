"""qwen2.5-14b [dense] — GQA (kv=8), QKV bias.
48L d_model=5120 40H d_ff=13824 vocab=152064. [hf:Qwen/Qwen2.5; hf]
"""
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="qwen2.5-14b", family="dense",
        n_layers=48, d_model=5120, vocab=152064,
        attn_type="gqa", n_heads=40, n_kv_heads=8, head_dim=128,
        qkv_bias=True, rope_theta=1e6,
        d_ff=13824, mlp_act="swiglu",
        norm="rmsnorm", tie_embeddings=False, pos_embed="rope",
        max_seq=32768, dtype="bfloat16",
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="qwen2.5-14b-smoke", family="dense",
        n_layers=2, d_model=96, vocab=256,
        attn_type="gqa", n_heads=6, n_kv_heads=2, head_dim=16,
        qkv_bias=True, d_ff=192, mlp_act="swiglu",
        norm="rmsnorm", tie_embeddings=False, max_seq=1024,
    )
