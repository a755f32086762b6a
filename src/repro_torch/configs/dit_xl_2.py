"""dit-xl-2 — the paper's own model (Peebles & Xie 2023): DiT-XL/2 on
256x256 ImageNet latents (32x32x4 SD-VAE, patch 2 -> 256 tokens).
28L d_model=1152 16H mlp_ratio=4 n_classes=1000.
"""
from repro_torch.models.dit import DiTCfg


def full() -> DiTCfg:
    return DiTCfg(
        img_size=32, in_ch=4, patch=2, d_model=1152, n_layers=28,
        n_heads=16, mlp_ratio=4.0, n_classes=1000, dtype="bfloat16",
    )


def smoke() -> DiTCfg:
    return DiTCfg(
        img_size=8, in_ch=4, patch=2, d_model=64, n_layers=2,
        n_heads=4, mlp_ratio=4.0, n_classes=8,
    )
