"""chameleon-34b [vlm] — early-fusion VLM backbone: VQ image tokens share
the 65536-token vocabulary (frontend STUB: inputs are token ids).
48L d_model=8192 64H (kv=8) d_ff=22016 vocab=65536, qk-norm.
[arXiv:2405.09818; unverified]
"""
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="chameleon-34b", family="vlm",
        n_layers=48, d_model=8192, vocab=65536,
        attn_type="gqa", n_heads=64, n_kv_heads=8, head_dim=128,
        qkv_bias=False, qk_norm=True, rope_theta=10000.0,
        d_ff=22016, mlp_act="swiglu",
        norm="rmsnorm", tie_embeddings=False, pos_embed="rope",
        max_seq=32768, dtype="bfloat16",
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="chameleon-smoke", family="vlm",
        n_layers=2, d_model=64, vocab=256,
        attn_type="gqa", n_heads=4, n_kv_heads=2, head_dim=16,
        qk_norm=True, d_ff=128, mlp_act="swiglu",
        norm="rmsnorm", tie_embeddings=False, max_seq=1024,
    )
