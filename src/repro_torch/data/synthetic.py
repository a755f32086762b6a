"""Seeded synthetic data — port of ``repro/data/synthetic.py``: token
streams for the LMs (``TokenPipeline``: order-2 Markov sources over a
vocab head, pure numpy, so its batches equal the reference's bit for
bit), latents for the DiT (``LatentPipeline``) and a host-side
``prefetch``.

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
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.diffusion import rng


# ---------------------------------------------------------------------------
# LM token pipeline
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq_len: int
    batch: int                      # per-host batch
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    order: int = 2

    def __post_init__(self):
        gen = np.random.default_rng(self.seed)
        v = min(self.vocab, 512)     # transition table over a vocab head
        self._v = v
        # sparse-ish row-stochastic transition logits
        self._trans = gen.normal(0, 1.5, (v, v)).astype(np.float32)

    def batches(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def batch_at(self, step: int, device=None) -> dict:
        """Deterministic batch for a global step (host-sharded): int32
        ``tokens`` and ``labels`` (the next token, -1 past the end) on
        ``device`` (default: where numpy made them, the CPU)."""
        gen = np.random.default_rng(
            (self.seed * 1_000_003 + step) * self.n_hosts + self.host_id)
        v = self._v
        toks = np.empty((self.batch, self.seq_len), np.int64)
        toks[:, 0] = gen.integers(0, v, self.batch)
        logits = self._trans
        for t in range(1, self.seq_len):
            row = logits[toks[:, t - 1] % v]
            row = row - row.max(axis=1, keepdims=True)
            p = np.exp(row)
            p /= p.sum(axis=1, keepdims=True)
            cum = p.cumsum(axis=1)
            u = gen.random((self.batch, 1))
            toks[:, t] = (u < cum).argmax(axis=1)
        toks = toks % self.vocab
        labels = np.concatenate(
            [toks[:, 1:], np.full((self.batch, 1), -1, np.int64)], axis=1)
        return {"tokens": torch.from_numpy(toks.astype(np.int32)).to(device),
                "labels": torch.from_numpy(labels.astype(np.int32)
                                           ).to(device)}


# ---------------------------------------------------------------------------
# DiT latent pipeline
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# double-buffered prefetch
# ---------------------------------------------------------------------------
def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Host-side prefetch: keeps ``depth`` batches made ahead of the
    consumer on a daemon thread."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def producer():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(stop)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
