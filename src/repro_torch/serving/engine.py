"""The synchronous serving engine — port of ``repro/serving/engine.py::
ServeEngine`` for one device.

A :class:`ServeEngine` owns the model (params + ``DiTCfg``), the op
context (``FPContext``, a fake-quant ``QuantContext``, or the artifact's
``QuantContext(kernel=True)`` whose linears and attention run the CUDA
kernels), and the diffusion setup. Each fixed-shape microbatch runs the
CFG-paired sampler (``ddpm_sample_paired``) eagerly on the engine's
device. Data-parallel meshes and the async slot pool are later slices.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.diffusion.ddpm import (
    DiffusionCfg, ddpm_sample_paired, make_schedule,
)
from repro_torch.models.dit import DiTCfg, dit_apply
from repro_torch.nn.ctx import FPContext
from repro_torch.serving.batching import (
    DEFAULT_STEP_BUCKETS, GenRequest, GenResult, MicroBatch, coalesce,
)


class ServeEngine:
    """Executes fixed-shape microbatches of DiT generation requests.

    params, dcfg : the DiT model (tensors on ``device``).
    dif, sched   : diffusion config + schedule (built if omitted).
    ctx          : op context (default fp); ``artifact.context()`` serves
                   through the kernels — or use :meth:`from_artifact`.
    microbatch   : slots per microbatch.
    step_buckets : allowed step counts.
    device       : default ``"cuda"``; raises where CUDA is absent.
    """

    def __init__(self, params, dcfg: DiTCfg, dif: DiffusionCfg, sched=None,
                 *, ctx=None, microbatch: int = 8,
                 step_buckets: Sequence[int] = DEFAULT_STEP_BUCKETS,
                 device=None):
        self.device = resolve_device(device)
        self.dcfg = dcfg
        self.dif = dif
        self.sched = sched if sched is not None else make_schedule(dif)
        self.ctx = ctx if ctx is not None else FPContext()
        self.microbatch = int(microbatch)
        self.step_buckets = tuple(sorted(int(b) for b in step_buckets))
        w = params["x_proj"]["w"]
        if w.device.type != self.device.type:
            raise ValueError(f"params live on {w.device}, engine device is "
                             f"{self.device}")
        self.params = params
        self.stats = {"microbatches": 0, "requests": 0, "padded_slots": 0,
                      "wall_s": 0.0}

    @classmethod
    def from_artifact(cls, params, artifact, *, kernel=None,
                      attn_impl: Optional[str] = None, sched=None,
                      microbatch: int = 8,
                      step_buckets: Sequence[int] = DEFAULT_STEP_BUCKETS,
                      device=None) -> "ServeEngine":
        """Quantized engine straight from a ``QuantArtifact``; fails fast
        on params other than the ones the artifact was calibrated against
        (content hash) or of another width."""
        artifact.check_params(params)
        dcfg = artifact.model_cfg()
        d = params["x_proj"]["w"].shape[-1]
        if d != dcfg.d_model:
            raise ValueError(f"params d_model {d} != artifact's recorded "
                             f"DiTCfg.d_model {dcfg.d_model}")
        return cls(params, dcfg, artifact.dif_cfg(), sched,
                   ctx=artifact.context(kernel=kernel, attn_impl=attn_impl),
                   microbatch=microbatch, step_buckets=step_buckets,
                   device=device)

    def run_microbatch(self, mb: MicroBatch) -> np.ndarray:
        """One microbatch -> (B, H, W, C) samples (padding slots included;
        callers drop them via ``mb.valid``)."""
        if mb.batch != self.microbatch:
            raise ValueError(f"microbatch has {mb.batch} slots, engine "
                             f"expects {self.microbatch}")
        if mb.steps not in self.step_buckets:
            raise ValueError(f"steps {mb.steps} not in configured buckets "
                             f"{self.step_buckets}")
        dcfg = self.dcfg
        eps = lambda x, t, y, c: dit_apply(self.params, dcfg, x, t, y, ctx=c)
        shape = (mb.batch, dcfg.img_size, dcfg.img_size, dcfg.in_ch)
        with torch.no_grad():
            out = ddpm_sample_paired(
                eps, self.dif, self.sched, shape, mb.labels, mb.seeds,
                mb.guidance, null_label=dcfg.n_classes, steps=mb.steps,
                ctx=self.ctx, device=self.device)
        return out.float().cpu().numpy()

    def run(self, microbatches: Sequence[MicroBatch]) -> Dict[int, GenResult]:
        """Run microbatches in order; returns {request_id: GenResult}."""
        results: Dict[int, GenResult] = {}
        for mb in microbatches:
            t0 = time.perf_counter()
            samples = self.run_microbatch(mb)
            dt = time.perf_counter() - t0
            for slot, rid in enumerate(mb.request_ids):
                results[rid] = GenResult(
                    request_id=rid, sample=samples[slot], steps=mb.steps,
                    microbatch=mb.batch, wall_s=dt,
                    requested_steps=(mb.requested_steps[slot]
                                     if slot < len(mb.requested_steps)
                                     else None))
            self.stats["microbatches"] += 1
            self.stats["requests"] += mb.n_valid
            self.stats["padded_slots"] += mb.n_padded
            self.stats["wall_s"] += dt
        return results

    def serve(self, requests: Sequence[GenRequest]) -> Dict[int, GenResult]:
        """Coalesce + run a request list in one call."""
        return self.run(coalesce(requests, self.microbatch,
                                 self.step_buckets))
