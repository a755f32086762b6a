"""The serving engines — port of ``repro/serving/engine.py`` for one
device.

A :class:`ServeEngine` owns the model (params + ``DiTCfg``), the op
context (``FPContext``, a fake-quant ``QuantContext``, or the artifact's
``QuantContext(kernel=True)`` whose linears and attention run the CUDA
kernels), and the diffusion setup. Each fixed-shape microbatch runs the
CFG-paired sampler (``ddpm_sample_paired``) eagerly on the engine's
device.

An :class:`AsyncServeEngine` serves the same requests through a pool of
slots advanced ``chunk`` steps per dispatch (``ddpm_chunk_slots``), each
slot from its own timestep, with the request-lifecycle layer of
``serving/lifecycle.py`` and ``serving/faults.py``. Its samples equal the
sync engine's bit for bit. Data-parallel meshes (the sharded slot pool)
are a later slice.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.diffusion.ddpm import (
    DiffusionCfg, ddpm_chunk_slots, ddpm_init_latent, ddpm_sample_paired,
    make_schedule, make_slot_schedule,
)
from repro_torch.kernels.build import KernelError
from repro_torch.models.dit import DiTCfg, dit_apply
from repro_torch.nn.ctx import FPContext
from repro_torch.serving import lifecycle as lc
from repro_torch.serving.batching import (
    DEFAULT_STEP_BUCKETS, GenRequest, GenResult, MicroBatch, bucket_steps,
    coalesce,
)
from repro_torch.serving.faults import EngineFault, degrade_context
from repro_torch.serving.scheduler import validate_label


def _check_params_device(params, device: torch.device) -> None:
    w = params["x_proj"]["w"]
    if w.device.type != device.type:
        raise ValueError(f"params live on {w.device}, engine device is "
                         f"{device}")


def _check_artifact(params, artifact) -> DiTCfg:
    """The artifact's model config, after its guards: the params' content
    hash (when recorded) and width."""
    artifact.check_params(params)
    dcfg = artifact.model_cfg()
    d = params["x_proj"]["w"].shape[-1]
    if d != dcfg.d_model:
        raise ValueError(f"params d_model {d} != artifact's recorded "
                         f"DiTCfg.d_model {dcfg.d_model}")
    return dcfg


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
        _check_params_device(params, self.device)
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
        dcfg = _check_artifact(params, artifact)
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


def _set(t, slot: int, value):
    """``t`` with row ``slot`` replaced (a new tensor: the caller's
    tensor, possibly an in-flight chunk's input, is left as it was)."""
    t = t.clone()
    t[slot] = value
    return t


class AsyncServeEngine:
    """Continuous-batching engine: a pool of ``microbatch`` slots, each
    with its own ``(pos, bucket, label, seed, guidance)`` state, advanced
    ``chunk`` denoising steps per dispatch — requests at different
    timesteps, even different step buckets, share one CFG-paired 2B
    forward per step (the ``*_vec`` kernels take one TGQ group per row).
    Finished slots are freed and queued requests admitted at the next
    chunk boundary, so a short request never waits for a long neighbour.

    Lifecycle layer (``serving/lifecycle.py``, ``serving/faults.py``):

    - bounded-queue admission: ``submit`` records a structured
      ``queue_full`` / ``bad_label`` rejection instead of dropping;
    - per-request deadlines and ``cancel``, checked at chunk boundaries
      (a request that finishes by the boundary still delivers ``OK``);
    - NaN/Inf quarantine: the finiteness flag is computed on the device
      after each chunk; only the poisoned slot is reset and retried with
      the same ``fold_in(PRNGKey(seed), i)`` keys (bit-identical on
      success), and fails with ``nan_poisoned`` after ``max_retries``;
    - degradation ladder on dispatch faults: flash attention -> composed
      chain -> fake-quant, every rung logged in
      ``stats["degradations"]``; an exhausted ladder fails every live
      request and raises :class:`EngineFault`. A kernel that does not
      build or launch (``kernels.build.KernelError``) takes no rung: it
      fails every live request and propagates.

    ``pipeline >= 2`` dispatches ahead: the next chunk is enqueued on the
    current stream, on this chunk's device-resident outputs, before the
    host waits for this chunk's (B,) positions and flags (their copies to
    the host are enqueued right after this chunk, so the wait does not
    include the next one). A boundary that changes any slot discards the
    speculative chunk, so outcomes are those of ``pipeline=1``. Unlike
    the reference, the engine does not speculate past a boundary it
    knows will change the pool — a slot whose chain ends within the
    chunk, or a running request with a cancel pending — since that chunk
    would be discarded (eager PyTorch pays the host's whole enqueue time
    for it).

    Slot state lives on the device; per chunk the host reads two (B,)
    arrays, and a latent leaves the device once, when its request
    finishes. ``clock`` is injectable (``faults.FakeClock``). ``stats``
    keeps the reference's keys and adds ``forwards``, the model forwards
    run (speculative chunks that were discarded included), and
    ``ahead``, the chunks dispatched ahead and then used.
    """

    def __init__(self, params, dcfg: DiTCfg, dif: DiffusionCfg, sched=None,
                 *, ctx=None, microbatch: int = 4,
                 step_buckets: Sequence[int] = DEFAULT_STEP_BUCKETS,
                 chunk: int = 4, pipeline: int = 2, max_queue: int = 64,
                 max_retries: int = 2, deadline_s: Optional[float] = None,
                 clock=time.monotonic, injector=None, device=None):
        self.device = resolve_device(device)
        self.dcfg = dcfg
        self.dif = dif
        self.sched = sched if sched is not None else make_schedule(dif)
        self.ctx = ctx if ctx is not None else FPContext()
        self.microbatch = int(microbatch)
        self.step_buckets = tuple(sorted(int(b) for b in step_buckets))
        self.chunk = int(chunk)
        self.pipeline = max(1, int(pipeline))
        self.max_queue = int(max_queue)
        self.max_retries = int(max_retries)
        self.deadline_s = deadline_s
        self._clock = clock
        self._injector = injector
        _check_params_device(params, self.device)
        self.params = params

        dev = self.device
        self._slot_sched = make_slot_schedule(dif, self.sched,
                                              self.step_buckets, device=dev)
        self._n_of = self._slot_sched["n_of"].cpu().numpy()
        self._n_max = int(self._n_of.max())
        self._bucket_idx = {b: i for i, b in
                            enumerate(self._slot_sched["buckets"])}
        B = self.microbatch
        self._sshape = (dcfg.img_size, dcfg.img_size, dcfg.in_ch)
        self._x = torch.zeros((B,) + self._sshape, dtype=torch.float32,
                              device=dev)
        # a free slot parks at pos >= every bucket length
        self._pos = torch.full((B,), self._n_max, dtype=torch.int64,
                               device=dev)
        self._bk = torch.zeros((B,), dtype=torch.int64, device=dev)
        self._y = torch.zeros((B,), dtype=torch.int64, device=dev)
        self._seeds = torch.zeros((B,), dtype=torch.int64, device=dev)
        self._gs = torch.ones((B,), dtype=torch.float32, device=dev)

        self._slot_rid: List[Optional[int]] = [None] * B
        self._pos_host = np.full((B,), self._n_max, np.int64)
        self.queue: deque = deque()                  # request ids, FIFO
        self.records: Dict[int, lc.RequestRecord] = {}
        self.outcomes: Dict[int, lc.RequestOutcome] = {}
        self._next_id = 0
        self._warned_roundings: set = set()
        self._t0 = clock()

        self.stats: Dict[str, Any] = {
            "dispatches": 0, "chunk_traces": 0, "degradations": [],
            "admitted": 0, "completed": 0, "failed": 0, "rejected": 0,
            "cancelled": 0, "retries": 0, "queue_peak": 0, "forwards": 0,
            "ahead": 0,
        }
        self._pending = None            # dispatch-ahead in-flight chunk
        self._chunk_fn = self._build_chunk()

    @classmethod
    def from_artifact(cls, params, artifact, *, kernel=None,
                      attn_impl: Optional[str] = None, sched=None,
                      **kw) -> "AsyncServeEngine":
        """Async engine from a ``QuantArtifact`` (the same guards as
        ``ServeEngine.from_artifact``)."""
        dcfg = _check_artifact(params, artifact)
        return cls(params, dcfg, artifact.dif_cfg(), sched,
                   ctx=artifact.context(kernel=kernel, attn_impl=attn_impl),
                   **kw)

    # -- the chunk function ----------------------------------------------------
    def _build_chunk(self):
        """The chunk function for the current context; counted in
        ``stats["chunk_traces"]`` (one per context: the first, and one
        per degradation)."""
        self.stats["chunk_traces"] += 1
        dcfg, dif, S = self.dcfg, self.dif, self._slot_sched
        ctx, chunk, params, stats = self.ctx, self.chunk, self.params, \
            self.stats

        def eps(xx, t, yy, c):
            stats["forwards"] += 1
            return dit_apply(params, dcfg, xx, t, yy, ctx=c)

        def run(x, pos, bk, y, seeds, gs):
            with torch.no_grad():
                return ddpm_chunk_slots(
                    eps, dif, S, x, pos, bk, y, seeds, gs,
                    null_label=dcfg.n_classes, chunk=chunk, ctx=ctx,
                    device=self.device)
        return run

    def _launch_chunk(self, x, pos):
        """Enqueue one chunk from (x, pos) and, right behind it on the
        stream, the copies of its (B,) positions and flags to the host.
        Returns (x, pos, bad, wait); ``wait()`` blocks until those copies
        land and returns them as numpy arrays."""
        x, pos, bad = self._chunk_fn(x, pos, self._bk, self._y, self._seeds,
                                     self._gs)
        if self.device.type != "cuda":
            return x, pos, bad, lambda: (pos.numpy().copy(),
                                         bad.numpy().copy())
        pos_h = torch.empty(pos.shape, dtype=pos.dtype, pin_memory=True)
        bad_h = torch.empty(bad.shape, dtype=bad.dtype, pin_memory=True)
        pos_h.copy_(pos, non_blocking=True)
        bad_h.copy_(bad, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()

        def wait():
            ready.synchronize()
            return pos_h.numpy().copy(), bad_h.numpy().copy()
        return x, pos, bad, wait

    # -- admission ---------------------------------------------------------------
    def _reject(self, req: GenRequest, code: str, message: str) -> int:
        now = self._clock()
        rec = lc.RequestRecord(request=req, status=lc.REJECTED,
                               submit_ts=now, finish_ts=now,
                               error=lc.FaultInfo(code=code, message=message))
        self.records[req.request_id] = rec
        self.outcomes[req.request_id] = lc.outcome_of(rec, None, now)
        self.stats["rejected"] += 1
        return req.request_id

    def submit_request(self, req: GenRequest) -> int:
        """Admission control for a pre-built request: validates the label,
        applies bounded-queue backpressure, and queues the request or
        records a structured ``REJECTED`` outcome (never raises on a bad
        request, never drops one). Returns the request id."""
        rid = req.request_id
        if rid in self.records:
            raise ValueError(f"duplicate request id {rid}")
        try:
            validate_label(req.label, self.dcfg.n_classes, rid)
        except ValueError as e:
            return self._reject(req, lc.BAD_LABEL, str(e))
        if len(self.queue) >= self.max_queue:
            return self._reject(
                req, lc.QUEUE_FULL,
                f"request {rid}: queue full ({self.max_queue} waiting) — "
                "retry with backoff")
        now = self._clock()
        dl = req.deadline_s if req.deadline_s is not None else self.deadline_s
        rec = lc.RequestRecord(
            request=req, submit_ts=now,
            deadline_ts=(now + dl) if dl is not None else None)
        rec.log(now, "queued")
        self.records[rid] = rec
        self.queue.append(rid)
        self.stats["queue_peak"] = max(self.stats["queue_peak"],
                                       len(self.queue))
        return rid

    def submit(self, label: int, steps: int = 50, cfg_scale: float = 1.0,
               seed: Optional[int] = None,
               deadline_s: Optional[float] = None) -> int:
        """Build and submit one request; returns its id. ``outcomes[rid]``
        holds an immediate structured rejection, if any."""
        rid = self._next_id
        self._next_id += 1
        bucketed = bucket_steps(steps, self.step_buckets)
        if bucketed != int(steps) and int(steps) not in self._warned_roundings:
            self._warned_roundings.add(int(steps))
            warnings.warn(
                f"requested {int(steps)} sampler steps rounded to bucket "
                f"{bucketed} (step_buckets={self.step_buckets}); "
                "RequestOutcome.requested_steps records the original ask",
                stacklevel=2)
        return self.submit_request(GenRequest(
            request_id=rid, label=int(label), steps=bucketed,
            cfg_scale=float(cfg_scale),
            seed=int(seed) if seed is not None else rid,
            requested_steps=int(steps), deadline_s=deadline_s))

    def cancel(self, rid: int) -> bool:
        """Request cancellation: a queued request resolves at admission, a
        running one frees its slot at the next chunk boundary. False if
        the request is already terminal."""
        rec = self.records.get(rid)
        if rec is None or rec.status in lc.TERMINAL:
            return False
        rec.cancel_requested = True
        return True

    # -- slot management -------------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [s for s, rid in enumerate(self._slot_rid) if rid is None]

    def _chain_len(self, req: GenRequest) -> int:
        return int(self._n_of[self._bucket_idx[
            bucket_steps(req.steps, self.step_buckets)]])

    def _init_latent(self, req: GenRequest):
        return ddpm_init_latent(int(req.seed) & 0xFFFFFFFF,
                                self._chain_len(req), self._sshape,
                                device=self.device)

    def _place(self, slot: int, rec: lc.RequestRecord) -> None:
        self._drain_pipeline()          # pool mutates: in-flight chunk stale
        req = rec.request
        bi = self._bucket_idx[bucket_steps(req.steps, self.step_buckets)]
        self._x = _set(self._x, slot, self._init_latent(req))
        self._pos = _set(self._pos, slot, 0)
        self._bk = _set(self._bk, slot, bi)
        self._y = _set(self._y, slot, int(req.label))
        self._seeds = _set(self._seeds, slot, int(req.seed) & 0xFFFFFFFF)
        self._gs = _set(self._gs, slot, float(np.float32(req.cfg_scale)))
        self._slot_rid[slot] = req.request_id
        self._pos_host[slot] = 0
        rec.slot = slot
        if rec.admit_ts is None:       # retries keep the original admit time
            rec.admit_ts = self._clock()
            self.stats["admitted"] += 1
        rec.status = lc.RUNNING
        rec.log(self._clock(), f"slot {slot}")

    def _release(self, slot: int) -> None:
        self._drain_pipeline()          # pool mutates: in-flight chunk stale
        self._x = _set(self._x, slot, 0.0)     # clear poison from the pool
        self._pos = _set(self._pos, slot, self._n_max)
        self._bk = _set(self._bk, slot, 0)
        self._slot_rid[slot] = None
        self._pos_host[slot] = self._n_max

    def _finish(self, rec: lc.RequestRecord, status: str,
                sample: Optional[np.ndarray],
                error: Optional[lc.FaultInfo] = None) -> None:
        now = self._clock()
        rec.status = status
        rec.error = error
        rec.finish_ts = now
        rec.log(now, status)
        if rec.slot is not None:
            self._release(rec.slot)
            rec.slot = None
        self.outcomes[rec.request.request_id] = lc.outcome_of(
            rec, sample, now)
        key = {lc.OK: "completed", lc.FAILED: "failed",
               lc.CANCELLED: "cancelled"}[status]
        self.stats[key] += 1

    def _admit(self) -> None:
        free = self._free_slots()
        while free and self.queue:
            rid = self.queue.popleft()
            rec = self.records[rid]
            now = self._clock()
            if rec.cancel_requested:
                self._finish(rec, lc.CANCELLED, None, lc.FaultInfo(
                    code=lc.CANCELLED_BY_USER,
                    message=f"request {rid} cancelled while queued"))
                continue
            if rec.deadline_ts is not None and now > rec.deadline_ts:
                self._finish(rec, lc.CANCELLED, None, lc.FaultInfo(
                    code=lc.DEADLINE,
                    message=f"request {rid} deadline passed after "
                            f"{now - rec.submit_ts:.3f}s in queue"))
                continue
            self._place(free.pop(0), rec)

    # -- the pump ----------------------------------------------------------------
    @property
    def active(self) -> int:
        return sum(1 for r in self._slot_rid if r is not None)

    def _fail_all_live(self, error: lc.FaultInfo) -> None:
        for rid in list(self.queue):
            self._finish(self.records[rid], lc.FAILED, None, error)
        self.queue.clear()
        for rid in self._slot_rid:
            if rid is not None:
                self._finish(self.records[rid], lc.FAILED, None, error)

    def _drain_pipeline(self) -> None:
        """Discard the dispatch-ahead chunk: its inputs no longer match the
        slot pool (admission, release, quarantine reset, degradation)."""
        self._pending = None

    def _boundary_changes_pool(self) -> bool:
        """True when the coming chunk boundary will change a slot for a
        reason the host already knows: a chain ends within the chunk, or
        a running request has a cancel pending."""
        for slot, rid in enumerate(self._slot_rid):
            if rid is None:
                continue
            rec = self.records[rid]
            if (rec.cancel_requested or self._pos_host[slot] + self.chunk
                    >= self._chain_len(rec.request)):
                return True
        return False

    def _dispatch(self):
        """One chunk dispatch with the degradation ladder and dispatch-ahead.
        Slot state is replaced only after the blocking reads succeed, so a
        failed dispatch (a fault on the rung's path, an injected fault)
        has no side effect and the same chunk is retried one rung down; a
        ``KernelError`` is re-raised after failing every live request."""
        while True:
            self.stats["dispatches"] += 1
            try:
                if self._injector is not None:
                    self._injector.before_dispatch(self.stats["dispatches"])
                if self._pending is not None:
                    x, pos, _, wait = self._pending
                    self._pending = None
                    self.stats["ahead"] += 1
                else:
                    x, pos, _, wait = self._launch_chunk(self._x, self._pos)
                if self.pipeline >= 2 and not self._boundary_changes_pool():
                    # dispatch-ahead: the next chunk is enqueued before the
                    # host waits on this one's (B,) reads
                    self._pending = self._launch_chunk(x, pos)
                pos_h, bad_h = wait()
                return x, pos_h, bad_h
            except KernelError as e:
                # a kernel that does not build or launch is no fault of one
                # context: no rung may replace it with another computation
                self._drain_pipeline()
                self._fail_all_live(lc.FaultInfo(
                    code=lc.ENGINE_FAULT,
                    message=f"kernel failed: {type(e).__name__}: {e}"))
                raise
            except Exception as e:            # noqa: BLE001 — ladder seam
                self._drain_pipeline()
                down = degrade_context(self.ctx)
                if down is None:
                    err = lc.FaultInfo(
                        code=lc.ENGINE_FAULT,
                        message=f"dispatch failed with no degradation rung "
                                f"left: {type(e).__name__}: {e}")
                    self._fail_all_live(err)
                    raise EngineFault(err.message) from e
                self.ctx, reason = down
                self.stats["degradations"].append(
                    {"reason": reason, "error": f"{type(e).__name__}: {e}"})
                self._chunk_fn = self._build_chunk()

    def pump(self) -> bool:
        """One engine cycle: admit -> dispatch one chunk -> resolve slots.
        False when there was nothing to do (pool and queue empty after
        admission)."""
        self._admit()
        if self.active == 0:
            return False
        x, pos_h, bad_h = self._dispatch()
        didx = self.stats["dispatches"]
        now = self._clock()

        for slot, rid in enumerate(self._slot_rid):
            if rid is None:
                continue
            rec = self.records[rid]
            n = self._chain_len(rec.request)
            p_before, p_after = int(self._pos_host[slot]), int(pos_h[slot])
            poisoned = bool(bad_h[slot])
            fault = None
            if self._injector is not None:
                fault = self._injector.poison(didx, rid, p_before, p_after)
                if fault is not None:
                    x = _set(x, slot, float("nan"))   # poison ONLY this slot
                    poisoned = True
            if poisoned:
                step = fault.at_step if fault is not None else p_before
                code = (lc.SLOT_ERROR if fault is not None
                        and fault.kind == "slot_error" else lc.NAN_POISONED)
                if rec.retries >= self.max_retries:
                    self._x = x   # keep the pool consistent before release
                    self._finish(rec, lc.FAILED, None, lc.FaultInfo(
                        code=code, step=step, retries=rec.retries,
                        message=f"request {rid}: non-finite latent at scan "
                                f"position ~{step}; gave up after "
                                f"{rec.retries} retries"))
                    x = self._x
                    continue
                # quarantine: reset THIS slot to scan position 0 with the
                # same fold_in(PRNGKey(seed), i) keys — the retry replays
                # the identical trajectory, bit-identical on success
                rec.retries += 1
                self.stats["retries"] += 1
                rec.log(now, f"quarantined@{step} retry {rec.retries}")
                self._drain_pipeline()  # slot resets: in-flight chunk stale
                x = _set(x, slot, self._init_latent(rec.request))
                pos_h[slot] = 0
                continue
            if p_after >= n:                      # finished: the ONE place
                self._x = x                       # a latent leaves the
                sample = self._x[slot].cpu().numpy()        # device
                self._finish(rec, lc.OK, sample)
                x = self._x
                continue
            if rec.cancel_requested:
                self._x = x
                self._finish(rec, lc.CANCELLED, None, lc.FaultInfo(
                    code=lc.CANCELLED_BY_USER, step=p_after,
                    message=f"request {rid} cancelled at chunk boundary"))
                x = self._x
                continue
            if rec.deadline_ts is not None and now > rec.deadline_ts:
                self._x = x
                self._finish(rec, lc.CANCELLED, None, lc.FaultInfo(
                    code=lc.DEADLINE, step=p_after,
                    message=f"request {rid}: deadline exceeded at chunk "
                            f"boundary (scan position {p_after}/{n})"))
                x = self._x
                continue

        self._x = x
        self._pos = torch.as_tensor(pos_h, dtype=torch.int64,
                                    device=self.device)
        for slot, rid in enumerate(self._slot_rid):
            if rid is not None:
                self._pos_host[slot] = int(pos_h[slot])
        return True

    def run_until_drained(self, max_pumps: int = 100_000
                          ) -> Dict[int, lc.RequestOutcome]:
        """Pump until every submitted request is terminal."""
        pumps = 0
        while self.queue or self.active:
            if not self.pump():
                break
            pumps += 1
            if pumps > max_pumps:
                raise EngineFault(
                    f"async loop did not drain within {max_pumps} pumps — "
                    f"{self.active} slots active, {len(self.queue)} queued")
        return self.outcomes

    def serve(self, requests: Sequence[GenRequest]
              ) -> Dict[int, lc.RequestOutcome]:
        """Submit pre-built requests (keeping their ids) and drain."""
        for r in requests:
            self.submit_request(r)
        return self.run_until_drained()

    def metrics(self) -> Dict[str, Any]:
        """Lifecycle metrics over everything terminal so far."""
        return lc.summarize(list(self.outcomes.values()),
                            self._clock() - self._t0)
