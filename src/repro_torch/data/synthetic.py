"""Seeded synthetic latents for DiT evaluation — port of the DiT part of
``repro/data/synthetic.py``.

Each class is a fixed smooth pattern (a low-frequency Fourier mix) plus
scaled noise, so classes separate in feature space and the FD / IS*
metrics (``repro_torch.core.metrics``) order schemes meaningfully. The
patterns come from numpy's ``default_rng`` exactly as the reference
builds them (equal bit for bit); labels and noise are threefry draws
(``diffusion/rng.py``) on the key's device, so the port draws JAX's
labels bit for bit and its normals within a few ulps.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.diffusion import rng


@dataclasses.dataclass
class LatentPipeline:
    img_size: int
    channels: int
    n_classes: int
    seed: int = 0
    noise: float = 0.35
    n_modes: int = 4                 # Fourier modes per class pattern

    def __post_init__(self):
        gen = np.random.default_rng(self.seed)
        H = self.img_size
        yy, xx = np.meshgrid(np.arange(H), np.arange(H), indexing="ij")
        pats = []
        for _ in range(self.n_classes):
            pat = np.zeros((H, H, self.channels), np.float32)
            for _ in range(self.n_modes):
                fx, fy = gen.uniform(0.5, 2.5, 2)
                ph = gen.uniform(0, 2 * np.pi, self.channels)
                amp = gen.uniform(0.4, 1.0, self.channels)
                for c in range(self.channels):
                    pat[..., c] += amp[c] * np.sin(
                        2 * np.pi * (fx * xx + fy * yy) / H + ph[c])
            pats.append(pat / max(self.n_modes, 1) * 1.6)
        self.patterns = np.stack(pats)           # (K, H, H, C)
        self._on = {}                            # device -> patterns tensor

    def sample(self, n: int, key) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x0 (n, H, H, C) float32, labels (n,) int64) on the key's
        device: ``k1, k2 = split(key)``, labels ``randint(k1)``, noise
        ``normal(k2) * noise``, as the reference."""
        k1, k2 = rng.split(key)
        y = rng.randint(k1, (n,), 0, self.n_classes)
        dev = key.device
        if dev not in self._on:
            self._on[dev] = torch.from_numpy(self.patterns).to(dev)
        base = self._on[dev][y]
        eps = rng.normal(k2, tuple(base.shape)) * self.noise
        return base + eps, y

    def x0_source(self, n: int, key) -> torch.Tensor:
        return self.sample(n, key)[0]

    def labeled_set(self, n: int, key) -> Tuple[np.ndarray, np.ndarray]:
        """The sample as numpy (labels int32, as the reference's)."""
        x, y = self.sample(n, key)
        return x.cpu().numpy(), y.cpu().numpy().astype(np.int32)
