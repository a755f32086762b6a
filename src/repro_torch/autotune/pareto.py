"""Pareto dominance over recipe trial points — port of
``repro/autotune/pareto.py`` (pure Python).

The autotune deliverable is not one recipe but the quality-vs-throughput
FRONTIER: every trial lands at (measured requests/sec, FD), and a trial
is worth reporting iff no other trial is at least as good on both axes
and strictly better on one. Objectives are named dict keys so the same
functions serve tests, the driver, and any future objective mix (e.g.
adding an IS* axis); throughput-like keys are maximized, quality-like
keys (distances) minimized.

Guarantees (property-tested in ``tests/test_torch_autotune.py``):

- no frontier point is dominated by ANY input point,
- every excluded point is dominated by some frontier point,
- the result is invariant under input permutation (deterministic sort
  plus stable tie-breaking on the ``key`` field when present),
- exact objective duplicates are collapsed to one representative, so a
  frontier sorted by falling throughput has STRICTLY improving quality —
  the shape ``launch/autotune.py`` asserts before emitting it.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def _get(p, k) -> float:
    v = p[k]
    if v is None:
        raise ValueError(f"point {p.get('key', p)!r} has no value for "
                         f"objective {k!r}")
    return float(v)


def dominates(a: Dict, b: Dict, *, maximize: Sequence[str],
              minimize: Sequence[str]) -> bool:
    """True iff ``a`` is >= ``b`` on every objective and > on at least
    one (maximize keys: larger is better; minimize keys: smaller)."""
    ge = all(_get(a, k) >= _get(b, k) for k in maximize) and \
        all(_get(a, k) <= _get(b, k) for k in minimize)
    strict = any(_get(a, k) > _get(b, k) for k in maximize) or \
        any(_get(a, k) < _get(b, k) for k in minimize)
    return ge and strict


def objective_tuple(p: Dict, maximize: Sequence[str],
                    minimize: Sequence[str]) -> Tuple[float, ...]:
    """Sort key: maximized objectives negated so ascending sort walks the
    frontier from the fastest point toward the highest-quality one."""
    return tuple([-_get(p, k) for k in maximize]
                 + [_get(p, k) for k in minimize])


def pareto_frontier(points: Sequence[Dict], *,
                    maximize: Sequence[str] = ("req_per_s",),
                    minimize: Sequence[str] = ("FD",)) -> List[Dict]:
    """The non-dominated subset, sorted by falling first-maximize key.

    Exact duplicates (equal on EVERY objective) keep one representative
    — chosen by the smallest ``key`` field, so the result is stable
    under permutation of the input list."""
    pts = list(points)
    front = [p for p in pts
             if not any(dominates(q, p, maximize=maximize,
                                  minimize=minimize) for q in pts)]
    # collapse exact-objective duplicates deterministically
    by_obj: Dict[Tuple[float, ...], Dict] = {}
    for p in front:
        t = objective_tuple(p, maximize, minimize)
        cur = by_obj.get(t)
        if cur is None or str(p.get("key", "")) < str(cur.get("key", "")):
            by_obj[t] = p
    return [by_obj[t] for t in sorted(by_obj)]


def is_strict_tradeoff(frontier: Sequence[Dict], *,
                       maximize: str = "req_per_s",
                       minimize: str = "FD") -> bool:
    """True iff walking the frontier from fastest to slowest, quality
    STRICTLY improves at every step — the shape a correct frontier must
    have once duplicates are collapsed."""
    for a, b in zip(frontier, frontier[1:]):
        if not (_get(a, maximize) > _get(b, maximize)
                and _get(a, minimize) > _get(b, minimize)):
            return False
    return True
