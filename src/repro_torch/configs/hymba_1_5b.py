"""hymba-1.5b [hybrid] — parallel attention + Mamba heads per block,
sliding-window attention with 3 global layers and 128 meta tokens.
32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001 ssm_state=16.
[arXiv:2411.13676; hf]
"""
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, vocab=32001,
        attn_type="gqa", n_heads=25, n_kv_heads=5, head_dim=64,
        window=1024, global_layers=(0, 15, 31), n_meta=128,
        block_type="hymba", d_ff=5504, mlp_act="swiglu",
        ssm=True, d_inner=3200, ssm_state=16, ssm_head_dim=64,
        ssm_chunk=256, ssm_groups=1,
        norm="rmsnorm", tie_embeddings=True, pos_embed="rope",
        max_seq=1 << 20, dtype="bfloat16",
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="hymba-smoke", family="hybrid",
        n_layers=3, d_model=64, vocab=256,
        attn_type="gqa", n_heads=4, n_kv_heads=2, head_dim=16,
        window=8, global_layers=(0, 2), n_meta=4,
        block_type="hymba", d_ff=128, mlp_act="swiglu",
        ssm=True, d_inner=128, ssm_state=8, ssm_head_dim=32,
        ssm_chunk=8, ssm_groups=1,
        norm="rmsnorm", tie_embeddings=True, max_seq=4096,
    )
