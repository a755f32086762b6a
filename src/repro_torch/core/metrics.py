"""Generation-quality metrics (CPU-scale stand-ins for FID / sFID / IS).

FID's math is the Fréchet distance between Gaussians fitted to features;
we keep the math and swap InceptionV3 for a FIXED seeded random-projection
feature net (two-layer tanh MLP), which preserves orderings between
quantization schemes — the quantity Tables I-III compare. sFID's
spatial sensitivity is approximated by extracting features from spatial
patches. IS is replaced by a class-separation proxy: a Gaussian
class-conditional classifier is fitted on REAL features, and
IS* = exp(E_x KL(p(y|x) || p(y))) is computed on generated samples —
identical formula to IS with the fitted classifier standing in for
Inception's.

The port's own copy of ``repro/core/metrics.py``, kept numpy and scipy
(no kernel lies on these small f32 products), so the same arrays give
the reference's FD, sFD and IS* exactly. One change: the matrix square
root goes through :func:`_sqrtm`, which also runs on SciPy releases
without ``sqrtm``'s ``disp`` argument.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.linalg


# ---------------------------------------------------------------------------
# feature extractor (fixed random projection net)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FeatureNet:
    w1: np.ndarray
    w2: np.ndarray

    @staticmethod
    def make(in_dim: int, hidden: int = 256, out: int = 64, seed: int = 1234):
        rng = np.random.default_rng(seed)
        w1 = rng.normal(0, 1.0 / np.sqrt(in_dim), (in_dim, hidden))
        w2 = rng.normal(0, 1.0 / np.sqrt(hidden), (hidden, out))
        return FeatureNet(w1=w1.astype(np.float32), w2=w2.astype(np.float32))

    def __call__(self, x: np.ndarray) -> np.ndarray:
        """x: (N, ...) -> (N, out)."""
        flat = np.asarray(x, np.float32).reshape(x.shape[0], -1)
        h = np.tanh(flat @ self.w1)
        return h @ self.w2


def spatial_features(x: np.ndarray, net: FeatureNet, patches: int = 2
                     ) -> np.ndarray:
    """sFID-style: features per spatial quadrant, concatenated stats dims."""
    N, H, W = x.shape[0], x.shape[1], x.shape[2]
    hs, ws = H // patches, W // patches
    feats = []
    for i in range(patches):
        for j in range(patches):
            feats.append(net(x[:, i * hs:(i + 1) * hs, j * ws:(j + 1) * ws]))
    return np.concatenate(feats, axis=1)


# ---------------------------------------------------------------------------
# Fréchet distance
# ---------------------------------------------------------------------------
def gaussian_stats(f: np.ndarray):
    mu = f.mean(axis=0)
    cov = np.cov(f, rowvar=False)
    return mu, cov


def _sqrtm(m: np.ndarray) -> np.ndarray:
    """scipy's principal matrix square root, as the reference takes it
    (``sqrtm(m, disp=False)[0]``); SciPy releases that dropped ``disp``
    return the root alone."""
    try:
        return scipy.linalg.sqrtm(m, disp=False)[0]
    except TypeError:
        return scipy.linalg.sqrtm(m)


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(C1 + C2 - 2 (C1 C2)^{1/2}) — identical to FID."""
    diff = mu1 - mu2
    covmean = _sqrtm(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        off = eps * np.eye(cov1.shape[0])
        covmean = _sqrtm((cov1 + off) @ (cov2 + off))
    covmean = np.real(covmean)
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2)
                 - 2 * np.trace(covmean))


def fd_score(real: np.ndarray, gen: np.ndarray, net: Optional[FeatureNet] = None
             ) -> float:
    """FID stand-in on raw sample tensors (N,H,W,C)."""
    net = net or FeatureNet.make(int(np.prod(real.shape[1:])))
    m1, c1 = gaussian_stats(net(real))
    m2, c2 = gaussian_stats(net(gen))
    return frechet_distance(m1, c1, m2, c2)


def sfd_score(real: np.ndarray, gen: np.ndarray, seed: int = 77) -> float:
    """sFID stand-in: Fréchet distance over spatial-patch features."""
    H, W, C = real.shape[1:]
    net = FeatureNet.make((H // 2) * (W // 2) * C, seed=seed)
    m1, c1 = gaussian_stats(spatial_features(real, net))
    m2, c2 = gaussian_stats(spatial_features(gen, net))
    return frechet_distance(m1, c1, m2, c2)


# ---------------------------------------------------------------------------
# IS proxy: Gaussian class-conditional classifier fitted on real data
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ClassProxy:
    net: FeatureNet
    means: np.ndarray            # (K, F)
    prec: np.ndarray             # shared precision (F, F)
    logdet: float

    @staticmethod
    def fit(real: np.ndarray, labels: np.ndarray, n_classes: int,
            net: Optional[FeatureNet] = None, ridge: float = 1e-3):
        net = net or FeatureNet.make(int(np.prod(real.shape[1:])))
        f = net(real)
        means = np.stack([
            f[labels == k].mean(axis=0) if np.any(labels == k)
            else f.mean(axis=0)
            for k in range(n_classes)])
        centered = f - means[labels]
        cov = np.cov(centered, rowvar=False) + ridge * np.eye(f.shape[1])
        prec = np.linalg.inv(cov)
        sign, logdet = np.linalg.slogdet(cov)
        return ClassProxy(net=net, means=means, prec=prec, logdet=float(logdet))

    def posterior(self, x: np.ndarray) -> np.ndarray:
        f = self.net(x)                                  # (N, F)
        d = f[:, None, :] - self.means[None]             # (N, K, F)
        logp = -0.5 * np.einsum("nkf,fg,nkg->nk", d, self.prec, d)
        logp -= logp.max(axis=1, keepdims=True)
        p = np.exp(logp)
        return p / p.sum(axis=1, keepdims=True)


def inception_score_proxy(gen: np.ndarray, proxy: ClassProxy) -> float:
    """exp(E_x KL(p(y|x) || p(y))) with the fitted class-conditional model."""
    p = proxy.posterior(gen)                             # (N, K)
    marg = p.mean(axis=0, keepdims=True)
    kl = np.sum(p * (np.log(p + 1e-12) - np.log(marg + 1e-12)), axis=1)
    return float(np.exp(kl.mean()))
