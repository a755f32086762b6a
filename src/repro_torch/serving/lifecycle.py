"""Request lifecycle: states, structured outcomes, and serving metrics —
port of ``repro/serving/lifecycle.py`` (pure python, copied verbatim).

Every request admitted to the async engine walks a small state machine:

    QUEUED ──admit──> RUNNING ──finish──────────────> OK
      │                 │  │
      │                 │  └─nan/inf quarantine──> RUNNING (retry, same keys)
      │                 │         └─max_retries──> FAILED
      │                 ├─deadline / cancel──────> CANCELLED
      │                 └─engine fault (ladder exhausted)──> FAILED
      └─reject (queue full / bad label)──────────> REJECTED

Nothing is dropped silently: every submitted request ends in exactly one
terminal state with a :class:`RequestOutcome`, and non-OK outcomes carry a
:class:`FaultInfo` naming the reason. The records double as the metrics
source — :func:`summarize` derives queue-wait, latency percentiles, and
goodput (OK requests per wall-second) from the per-request timestamps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# -- states -----------------------------------------------------------------
QUEUED = "QUEUED"
RUNNING = "RUNNING"
OK = "OK"
FAILED = "FAILED"
REJECTED = "REJECTED"
CANCELLED = "CANCELLED"

TERMINAL = frozenset({OK, FAILED, REJECTED, CANCELLED})

# -- fault codes (FaultInfo.code) -------------------------------------------
NAN_POISONED = "nan_poisoned"      # non-finite latent after a chunk
DEADLINE = "deadline"              # deadline passed at a chunk boundary
QUEUE_FULL = "queue_full"          # bounded-queue backpressure
BAD_LABEL = "bad_label"            # admission-time label validation
ENGINE_FAULT = "engine_fault"      # dispatch failed, ladder exhausted
CANCELLED_BY_USER = "cancelled"    # explicit cancel()
SLOT_ERROR = "slot_error"          # injected/observed per-slot failure


@dataclasses.dataclass(frozen=True)
class FaultInfo:
    """Structured reason attached to every non-OK outcome."""
    code: str                      # one of the module's fault codes
    message: str
    step: Optional[int] = None     # scan position when the fault surfaced
    retries: int = 0               # retries consumed before giving up


@dataclasses.dataclass
class RequestRecord:
    """Mutable per-request bookkeeping while a request is live."""
    request: Any                   # the GenRequest
    status: str = QUEUED
    submit_ts: float = 0.0
    admit_ts: Optional[float] = None
    finish_ts: Optional[float] = None
    deadline_ts: Optional[float] = None   # absolute (engine clock)
    retries: int = 0
    slot: Optional[int] = None
    error: Optional[FaultInfo] = None
    cancel_requested: bool = False
    events: List[Tuple[float, str]] = dataclasses.field(default_factory=list)

    def log(self, ts: float, event: str) -> None:
        self.events.append((float(ts), event))


@dataclasses.dataclass(frozen=True)
class RequestOutcome:
    """One request's terminal result — the async analogue of GenResult,
    extended with the lifecycle fields a service caller needs."""
    request_id: int
    status: str                    # OK | FAILED | REJECTED | CANCELLED
    sample: Optional[np.ndarray]   # (H, W, C); None unless OK
    steps: int                     # bucketed step count (what would/did run)
    requested_steps: Optional[int]
    error: Optional[FaultInfo]
    queue_wait_s: float = 0.0      # submit -> admit (0 if never admitted)
    latency_s: float = 0.0         # submit -> terminal
    retries: int = 0


def outcome_of(rec: RequestRecord, sample: Optional[np.ndarray],
               now: float) -> RequestOutcome:
    """Freeze a record into its terminal outcome (record must be terminal)."""
    if rec.status not in TERMINAL:
        raise ValueError(f"request {rec.request.request_id} not terminal: "
                         f"{rec.status}")
    wait = (rec.admit_ts - rec.submit_ts) if rec.admit_ts is not None else 0.0
    fin = rec.finish_ts if rec.finish_ts is not None else now
    return RequestOutcome(
        request_id=rec.request.request_id, status=rec.status, sample=sample,
        steps=rec.request.steps,
        requested_steps=rec.request.requested_steps, error=rec.error,
        queue_wait_s=float(wait), latency_s=float(fin - rec.submit_ts),
        retries=rec.retries)


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def summarize(outcomes: List[RequestOutcome], wall_s: float
              ) -> Dict[str, Any]:
    """Lifecycle metrics over a set of terminal outcomes.

    goodput counts only OK requests — a retried-to-death or deadline-missed
    request consumed compute but delivered nothing, which is the number a
    capacity planner actually needs (vs. raw throughput).
    """
    by_status: Dict[str, int] = {}
    for o in outcomes:
        by_status[o.status] = by_status.get(o.status, 0) + 1
    ok = [o for o in outcomes if o.status == OK]
    lat = [o.latency_s for o in ok]
    waits = [o.queue_wait_s for o in ok]
    return {
        "requests": len(outcomes),
        "by_status": by_status,
        "ok": len(ok),
        "goodput_rps": (len(ok) / wall_s) if wall_s > 0 else 0.0,
        "queue_wait_p50_s": _pct(waits, 50), "queue_wait_p99_s": _pct(waits, 99),
        "latency_p50_s": _pct(lat, 50), "latency_p99_s": _pct(lat, 99),
        "retries": sum(o.retries for o in outcomes),
        "wall_s": float(wall_s),
    }
