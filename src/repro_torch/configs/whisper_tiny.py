"""whisper-tiny [audio] — enc-dec, conv frontend STUB (precomputed frame
embeddings). 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
[arXiv:2212.04356; unverified]
"""
from repro_torch.models.config import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="whisper-tiny", family="audio",
        n_layers=4, d_model=384, vocab=51865,
        attn_type="gqa", n_heads=6, n_kv_heads=6, head_dim=64,
        qkv_bias=True, d_ff=1536, mlp_act="gelu", mlp_bias=True,
        norm="layernorm", tie_embeddings=True, pos_embed="learned",
        encdec=True, n_enc_layers=4, enc_seq=1500,
        max_seq=32768, dtype="bfloat16",
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="whisper-tiny-smoke", family="audio",
        n_layers=2, d_model=64, vocab=256,
        attn_type="gqa", n_heads=4, n_kv_heads=4, head_dim=16,
        qkv_bias=True, d_ff=128, mlp_act="gelu", mlp_bias=True,
        norm="layernorm", tie_embeddings=True, pos_embed="learned",
        encdec=True, n_enc_layers=2, enc_seq=30, max_seq=128,
    )
