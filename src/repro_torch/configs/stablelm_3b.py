"""stablelm-3b [dense] — MHA (kv=32).
32L d_model=2560 32H d_ff=6912 vocab=50304. [hf:stabilityai/stablelm; unverified]
"""
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="stablelm-3b", family="dense",
        n_layers=32, d_model=2560, vocab=50304,
        attn_type="gqa", n_heads=32, n_kv_heads=32, head_dim=80,
        qkv_bias=False, rope_theta=10000.0,
        d_ff=6912, mlp_act="swiglu",
        norm="layernorm", tie_embeddings=False, pos_embed="rope",
        max_seq=32768, dtype="bfloat16",
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="stablelm-smoke", family="dense",
        n_layers=2, d_model=64, vocab=256,
        attn_type="gqa", n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, mlp_act="swiglu",
        norm="layernorm", tie_embeddings=False, max_seq=1024,
    )
