"""mamba2-130m [ssm] — attention-free SSD (state-space duality).
24L d_model=768 d_ff=0 vocab=50280 ssm_state=128. [arXiv:2405.21060; unverified]
"""
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, vocab=50280,
        attn_type="none", block_type="ssm_only", d_ff=0,
        ssm=True, d_inner=1536, ssm_state=128, ssm_head_dim=64,
        ssm_chunk=256, ssm_groups=1,
        norm="rmsnorm", tie_embeddings=True, pos_embed="none",
        max_seq=1 << 20, dtype="bfloat16",
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, vocab=256,
        attn_type="none", block_type="ssm_only", d_ff=0,
        ssm=True, d_inner=128, ssm_state=16, ssm_head_dim=32,
        ssm_chunk=8, ssm_groups=1,
        norm="rmsnorm", tie_embeddings=True, pos_embed="none", max_seq=4096,
    )
