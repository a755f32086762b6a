"""Deterministic fault injection + graceful degradation for the async engine
— port of ``repro/serving/faults.py``.

Chaos testing a compiled-sampler service needs faults that are (a)
deterministic — the retry-determinism contract is "bit-identical to the
uninjected run", which is unverifiable against random faults — and (b)
injected at the same seams real faults hit: poisoned latents after a
chunk, dispatch-time executable failures, wall-clock stalls. The
:class:`FaultInjector` sits on exactly those seams inside
``AsyncServeEngine.pump``; production engines run with ``injector=None``
and pay one ``is None`` check per seam.

The degradation ladder (:func:`degrade_context`) is the engine-fault
response: when a dispatch raises, the engine steps the op context down one
rung — fused flash attention -> the composed three-kernel chain -> fake
quant (no CUDA kernel at all) — rebuilds the chunk function, and retries
the SAME chunk (slot state is only mutated after a successful blocking
read, so a failed dispatch is side-effect free). Each rung trades speed
for a smaller trusted surface; each step is logged with a reason in
``engine.stats['degradations']``. The composed rung runs the per-slot
composed chain (B9c -> B10b -> B9d) in place of flash (B8); the linears
stay on their kernels. A kernel that does not build or launch
(``kernels.build.KernelError``) is never a rung: the engine fails its
live requests and re-raises it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


class EngineFault(RuntimeError):
    """Raised when a dispatch keeps failing after the degradation ladder is
    exhausted — the engine cannot make progress on ANY context."""


class FaultInjected(RuntimeError):
    """An injected dispatch/slot failure (chaos tests only)."""


class FakeClock:
    """Injectable monotonic clock — deadline/stall tests advance time
    explicitly instead of sleeping (deterministic, instant)."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def advance(self, dt: float) -> None:
        self.t += float(dt)

    def __call__(self) -> float:
        return self.t


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.

    kind:
      'nan'            poison request ``request_id``'s latent when its scan
                       position crosses ``at_step`` (a NaN burst mid-chain);
                       ``sticky`` re-fires on every retry (unrecoverable).
      'slot_error'     like 'nan' but modelling a non-numeric per-slot
                       failure (bad DMA, corrupt slot state).
      'dispatch_error' raise FaultInjected out of dispatch number
                       ``at_dispatch`` — exercises the degradation ladder.
      'stall'          advance the engine clock by ``seconds`` before
                       dispatch ``at_dispatch`` — exercises deadlines
                       (with a FakeClock; never sleeps).
    """
    kind: str
    request_id: Optional[int] = None
    at_step: int = 0
    at_dispatch: Optional[int] = None
    sticky: bool = False
    seconds: float = 0.0


class FaultInjector:
    """Deterministic schedule of faults, consumed as the engine hits the
    matching seams. ``fired`` logs ``(dispatch_idx, fault)`` for assertions.
    """

    def __init__(self, faults: List[Fault], clock: Optional[FakeClock] = None):
        self.pending = list(faults)
        self.clock = clock
        self.fired: List[Tuple[int, Fault]] = []

    def _take(self, pred) -> Optional[Fault]:
        for i, f in enumerate(self.pending):
            if pred(f):
                if not f.sticky:
                    self.pending.pop(i)
                return f
        return None

    def before_dispatch(self, dispatch_idx: int) -> None:
        """Dispatch seam: stalls advance the fake clock, dispatch errors
        raise (the engine's ladder catches them)."""
        st = self._take(lambda f: f.kind == "stall"
                        and f.at_dispatch == dispatch_idx)
        if st is not None:
            self.fired.append((dispatch_idx, st))
            if self.clock is None:
                raise ValueError("stall fault needs a FakeClock")
            self.clock.advance(st.seconds)
        de = self._take(lambda f: f.kind == "dispatch_error"
                        and (f.at_dispatch is None
                             or f.at_dispatch == dispatch_idx))
        if de is not None:
            self.fired.append((dispatch_idx, de))
            raise FaultInjected(
                f"injected dispatch error at dispatch {dispatch_idx}")

    def poison(self, dispatch_idx: int, request_id: int, pos_before: int,
               pos_after: int) -> Optional[Fault]:
        """Post-chunk seam: returns the fault poisoning ``request_id`` if
        its scan position crossed ``at_step`` in this chunk."""
        f = self._take(lambda f: f.kind in ("nan", "slot_error")
                       and f.request_id == request_id
                       and pos_before <= f.at_step < pos_after)
        if f is not None:
            self.fired.append((dispatch_idx, f))
        return f


def degrade_context(ctx) -> Optional[Tuple[object, str]]:
    """One rung down the ladder, or None when already at the bottom.

    flash attn -> composed three-kernel chain -> fake-quant (kernel=False).
    Only meaningful for kernel-path QuantContexts; fp / fake-quant contexts
    have no rung below them.
    """
    kernel = getattr(ctx, "kernel", False)
    if not kernel:
        return None
    if getattr(ctx, "attn_impl", None) == "flash":
        return (dataclasses.replace(ctx, attn_impl="composed"),
                "flash attention -> composed three-kernel chain")
    return (dataclasses.replace(ctx, kernel=False),
            "fused int8 kernels -> fake-quant (simulated quantization)")
