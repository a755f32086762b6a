"""Request coalescing: variable requests -> fixed-shape microbatches.

Port of ``repro/serving/batching.py`` (pure python, copied verbatim).

The compiled sampler executable is shaped by exactly two things: the
microbatch size B and its step count (the sampler's loop length). To
keep serving on ONE executable per step bucket:

- requests are **bucketed** by step count — a request asking for ``s``
  steps runs at the smallest configured bucket ``>= s`` (a few extra
  denoising steps, never fewer — except above the largest bucket, which
  is the deployment's configured ceiling and clamps; ``GenResult.steps``
  always reports what actually ran),
- each bucket's requests are **packed** into microbatches of exactly B
  slots; a trailing partial batch is **padded** with inert slots
  (``valid=False``) that compute alongside real requests and are dropped
  before results are returned. Padding is harmless by construction: the
  paired sampler draws noise per-slot from per-request keys and the DiT
  forward mixes nothing across the batch dim, so a real request's sample
  is bit-identical whatever rides in the other slots
  (``tests/test_torch_serving.py``).

Classifier-free guidance does NOT change the microbatch shape: the
engine's sampler runs the conditional/unconditional halves as one 2B
forward internally (see ``repro_torch.diffusion.ddpm.ddpm_sample_paired``), so a
CFG request costs two model rows but one scheduling slot.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_STEP_BUCKETS: Tuple[int, ...] = (25, 50, 100)


@dataclasses.dataclass(frozen=True)
class GenRequest:
    """One generation request as it arrives at the frontend."""
    request_id: int
    label: int                   # class id (0..n_classes-1)
    steps: int = 50              # requested sampler steps (bucketed up)
    cfg_scale: float = 1.0       # CFG: 1 = conditional, 0 = uncond, >1 guided
    seed: int = 0                # per-request PRNG seed
    requested_steps: Optional[int] = None   # pre-bucketing ask (None: == steps)
    deadline_s: Optional[float] = None      # relative deadline from submit
                                            # (async engine; None = no deadline)


@dataclasses.dataclass(frozen=True)
class GenResult:
    """One finished request."""
    request_id: int
    sample: np.ndarray           # (H, W, C) latent
    steps: int                   # bucketed step count actually run
    microbatch: int              # size of the batch it rode in
    wall_s: float                # wall time of that microbatch
    requested_steps: Optional[int] = None   # what the caller asked for
                                            # before `bucket_steps` rounding


@dataclasses.dataclass(frozen=True)
class MicroBatch:
    """A fixed-shape unit of work: exactly ``batch`` slots, one bucket.

    The first ``len(request_ids)`` slots hold real requests (in submission
    order); the rest are padding with ``valid=False``.
    """
    steps: int                   # bucketed step count (compile key)
    labels: np.ndarray           # (B,) int32
    seeds: np.ndarray            # (B,) uint32
    guidance: np.ndarray         # (B,) float32 CFG scales
    valid: np.ndarray            # (B,) bool
    request_ids: Tuple[int, ...]
    requested_steps: Tuple[int, ...] = ()   # pre-bucketing asks, parallel to
                                            # request_ids (() for legacy
                                            # hand-built microbatches)

    @property
    def batch(self) -> int:
        return int(self.labels.shape[0])

    @property
    def n_valid(self) -> int:
        return len(self.request_ids)

    @property
    def n_padded(self) -> int:
        return self.batch - self.n_valid


def bucket_steps(steps: int, buckets: Sequence[int]) -> int:
    """Smallest configured bucket >= steps. Requests above the largest
    bucket CLAMP DOWN to it — the bucket list is the deployment's step
    ceiling, and per-request overshoot is not a supported shape."""
    bs = sorted(int(b) for b in buckets)
    for b in bs:
        if steps <= b:
            return b
    return bs[-1]


def coalesce(requests: Sequence[GenRequest], batch: int,
             step_buckets: Sequence[int] = DEFAULT_STEP_BUCKETS
             ) -> List[MicroBatch]:
    """Pack requests into fixed-shape microbatches.

    Requests are grouped by step bucket (preserving submission order
    within a bucket) and cut into chunks of ``batch``; the final chunk of
    each bucket is padded. Padding slots copy benign values (label 0,
    seed 0, guidance 1) — they are dropped by ``valid`` on the way out.
    """
    if batch <= 0:
        raise ValueError(f"microbatch size must be positive, got {batch}")
    by_bucket: dict = {}
    for r in requests:
        by_bucket.setdefault(bucket_steps(r.steps, step_buckets), []).append(r)

    out: List[MicroBatch] = []
    for steps in sorted(by_bucket):
        rs = by_bucket[steps]
        for s in range(0, len(rs), batch):
            chunk = rs[s:s + batch]
            pad = batch - len(chunk)
            out.append(MicroBatch(
                steps=steps,
                labels=np.asarray([r.label for r in chunk] + [0] * pad,
                                  np.int32),
                seeds=np.asarray([r.seed for r in chunk] + [0] * pad,
                                 np.uint32),
                guidance=np.asarray(
                    [r.cfg_scale for r in chunk] + [1.0] * pad, np.float32),
                valid=np.asarray([True] * len(chunk) + [False] * pad, bool),
                request_ids=tuple(r.request_id for r in chunk),
                requested_steps=tuple(
                    r.requested_steps if r.requested_steps is not None
                    else r.steps for r in chunk),
            ))
    return out
