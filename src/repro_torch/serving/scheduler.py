"""Request-level scheduler: the stateful frontend over the pure batching
functions. Port of ``repro/serving/scheduler.py`` (pure python).

``submit()`` assigns request ids and queues requests; ``flush()`` cuts
the queue into fixed-shape microbatches (bucketing + padding, see
``repro_torch.serving.batching``); ``run()`` drains everything through an
engine and hands back per-request results.

Policy knobs:

- ``max_wait`` requests: ``flush(partial=False)`` only emits FULL
  microbatches and keeps the remainder queued — the steady-state policy
  under load (padding wastes compute). ``run()``/``flush(partial=True)``
  emit the trailing partial batch padded — the drain policy.
- per-request seeds default to a deterministic counter so repeated runs
  of the same submission order reproduce bit-identical samples.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence

from repro_torch.serving.batching import (
    DEFAULT_STEP_BUCKETS, GenRequest, GenResult, MicroBatch, bucket_steps,
    coalesce,
)


def validate_label(label: int, n_classes: Optional[int],
                   request_id) -> None:
    """Admission-time label check. An out-of-range label does NOT fail the
    model forward — the class-embedding gather silently reads garbage (or
    the null-label row) and the request gets back a corrupt sample — so
    the only safe place to catch it is BEFORE the request enters a
    microbatch, with an error that names the request."""
    if n_classes is None:
        return
    if not 0 <= int(label) < int(n_classes):
        raise ValueError(
            f"request {request_id}: label {int(label)} out of range "
            f"[0, {int(n_classes)}) — an out-of-range label would gather "
            "garbage from the class-embedding table and return a corrupt "
            "sample instead of failing")


class RequestScheduler:
    """Coalesces an incoming request stream into engine-ready microbatches.

    ``n_classes`` (when given, usually ``dcfg.n_classes``) enables
    admission-time label validation in :meth:`submit`/:meth:`submit_all`.
    """

    def __init__(self, microbatch: int = 8,
                 step_buckets: Sequence[int] = DEFAULT_STEP_BUCKETS,
                 n_classes: Optional[int] = None):
        self.microbatch = int(microbatch)
        self.step_buckets = tuple(sorted(int(b) for b in step_buckets))
        self.n_classes = None if n_classes is None else int(n_classes)
        self.pending: List[GenRequest] = []
        self._next_id = 0
        self._warned_roundings: set = set()

    def _warn_rounding(self, requested: int, bucketed: int) -> None:
        """Once per distinct requested step count: the caller asked for a
        step count the deployment doesn't compile and is silently getting
        a different one — worth a warning, not worth per-request spam."""
        if bucketed == requested or requested in self._warned_roundings:
            return
        self._warned_roundings.add(requested)
        warnings.warn(
            f"requested {requested} sampler steps rounded to the "
            f"{'larger' if bucketed > requested else 'SMALLER'} configured "
            f"bucket {bucketed} (step_buckets={self.step_buckets}); "
            "GenResult.requested_steps records the original ask",
            stacklevel=3)

    def submit(self, label: int, steps: int = 50, cfg_scale: float = 1.0,
               seed: Optional[int] = None) -> int:
        """Queue one request; returns its request id. Raises ``ValueError``
        (naming the request id) on an out-of-range label when the
        scheduler knows ``n_classes``."""
        rid = self._next_id
        validate_label(label, self.n_classes, rid)
        bucketed = bucket_steps(steps, self.step_buckets)
        self._warn_rounding(int(steps), bucketed)
        self._next_id += 1
        self.pending.append(GenRequest(
            request_id=rid, label=int(label), steps=bucketed,
            cfg_scale=float(cfg_scale),
            seed=int(seed) if seed is not None else rid,
            requested_steps=int(steps)))
        return rid

    def submit_all(self, requests: Sequence[GenRequest]) -> List[int]:
        """Queue pre-built requests, keeping their ids. Engine results are
        keyed by request id, so duplicates would silently overwrite each
        other: clashing ids are rejected here, and the internal counter
        jumps past the largest external id to keep later ``submit()`` calls
        collision-free."""
        ids = [r.request_id for r in requests]
        taken = {r.request_id for r in self.pending}
        dups = sorted({i for i in ids if ids.count(i) > 1 or i in taken})
        if dups:
            raise ValueError(f"duplicate request ids: {dups}")
        for r in requests:
            validate_label(r.label, self.n_classes, r.request_id)
        self.pending.extend(requests)
        if requests:
            self._next_id = max([self._next_id] + [i + 1 for i in ids])
        return ids

    def flush(self, partial: bool = True) -> List[MicroBatch]:
        """Cut the queue into microbatches. ``partial=False`` keeps any
        incomplete trailing batch (per bucket) queued for later arrivals."""
        batches = coalesce(self.pending, self.microbatch, self.step_buckets)
        if partial:
            self.pending = []
            return batches
        keep: List[GenRequest] = []
        out: List[MicroBatch] = []
        by_id = {r.request_id: r for r in self.pending}
        for mb in batches:
            if mb.n_padded == 0:
                out.append(mb)
            else:
                keep.extend(by_id[rid] for rid in mb.request_ids)
        self.pending = keep
        return out

    def run(self, engine) -> Dict[int, GenResult]:
        """Drain the queue through ``engine`` (padding the tail).

        Scheduler/engine shape compatibility is checked BEFORE the queue
        is flushed — a mismatch must not empty the queue and lose every
        pending request to a mid-run ValueError.
        """
        if engine.microbatch != self.microbatch:
            raise ValueError(
                f"scheduler microbatch {self.microbatch} != engine "
                f"microbatch {engine.microbatch}")
        missing = set(self.step_buckets) - set(engine.step_buckets)
        if missing:
            raise ValueError(f"scheduler step buckets {sorted(missing)} "
                             f"not compiled by the engine "
                             f"{engine.step_buckets}")
        return engine.run(self.flush(partial=True))
