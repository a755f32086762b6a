"""Declarative recipe search space -> concrete trial list — port of
``repro/autotune/space.py``. Keys are ``QuantRecipe.content_hash()``, the
same in both packages, so :func:`expand` gives the reference's trials
key for key.

A ``SearchSpace`` names the axes the sweep varies (bit-widths,
calibration methods, TGQ group counts, and — under 'ho' only — the
MRQ/TGQ structure switches); :func:`expand` takes the cartesian product,
drops combinations ``quantize()`` would reject, and dedupes by recipe
content hash so the driver never runs the same calibration twice.

The knob asymmetry is inherited from the API, not invented here:
``quantize(method='range')`` REJECTS non-default HO-only fields
(``use_mrq``/``use_tgq``/``rounds``/``n_alpha``/...), so those axes
expand only under 'ho' while 'range' rows always carry the full default
MRQ+TGQ structure. Encoding that rule in expansion (rather than letting
trials fail at run time) keeps the ledger free of dead entries.

Besides uniform-precision trials the space can request AdaTSQ-style
MIXED trials (``bit_budgets``): one trial per mean-bit budget, realized
at evaluation time by scoring each TGQ timestep group's noise-MSE
sensitivity per component bit-width and greedily assigning bits under
the budget (``repro_torch.autotune.evaluate.allocate_bits``). A mixed trial
carries the full set of uniform component recipes it composes; its
ledger key hashes the budget plus the component hashes, so it cache-hits
on resume exactly like a uniform trial.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List, Optional, Tuple

from repro_torch.quant.recipe import ATTN_IMPLS, BITS, METHODS, QuantRecipe


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """The axes of one sweep. Tuples are alternatives (cartesian
    product); scalars are shared by every trial.

    bits / methods / tgq_groups : swept axes. ``tgq_groups`` entries of
        ``None`` inherit the DiffusionCfg's group count.
    use_mrq / use_tgq : structure switches — swept ONLY under 'ho'
        (range rows pin both True; see module docstring).
    bit_budgets : mean weight-bit budgets for AdaTSQ-style mixed trials
        (empty = uniform-only sweep). Requires >= 2 bits levels.
    attn_impl / seed / n_per_group / calib_batch : shared trial knobs.
    ho_rounds / ho_n_alpha : search effort for 'ho' rows (the recipe
        defaults are table-grade; sweeps usually want them smaller).
    """
    bits: Tuple[str, ...] = ("w8a8", "w6a6", "w4a4")
    methods: Tuple[str, ...] = ("range",)
    tgq_groups: Tuple[Optional[int], ...] = (None,)
    use_mrq: Tuple[bool, ...] = (True,)
    use_tgq: Tuple[bool, ...] = (True,)
    bit_budgets: Tuple[float, ...] = ()
    attn_impl: str = "flash"
    seed: int = 0
    n_per_group: int = 4
    calib_batch: int = 4
    ho_rounds: int = 2
    ho_n_alpha: int = 8

    def __post_init__(self):
        for f in ("bits", "methods", "tgq_groups", "use_mrq", "use_tgq",
                  "bit_budgets"):
            object.__setattr__(self, f, tuple(getattr(self, f)))
        bad = [b for b in self.bits if b not in BITS]
        if bad:
            raise ValueError(f"unknown bits levels {bad}; "
                             f"supported: {sorted(BITS)}")
        bad = [m for m in self.methods if m not in METHODS]
        if bad:
            raise ValueError(f"unknown methods {bad}; "
                             f"supported: {list(METHODS)}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}; "
                             f"supported: {list(ATTN_IMPLS)}")
        if not (self.bits and self.methods and self.tgq_groups):
            raise ValueError("bits, methods and tgq_groups must each "
                             "have at least one entry")
        if self.bit_budgets and len(set(self.bits)) < 2:
            raise ValueError("bit_budgets (mixed trials) need >= 2 "
                             "distinct bits levels to allocate between")
        wb = sorted(BITS[b][0] for b in set(self.bits))
        for budget in self.bit_budgets:
            if not wb[0] <= float(budget) <= wb[-1]:
                raise ValueError(
                    f"bit budget {budget} outside the achievable mean-bit "
                    f"range [{wb[0]}, {wb[-1]}] of levels {sorted(set(self.bits))}")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for f in ("bits", "methods", "tgq_groups", "use_mrq", "use_tgq",
                  "bit_budgets"):
            d[f] = list(d[f])
        return d

    def content_hash(self) -> str:
        """Identity of the sweep definition — written into the ledger
        header so a resume against a DIFFERENT space fails fast instead
        of silently mixing trial sets."""
        doc = json.dumps(self.to_dict(), sort_keys=True,
                         separators=(",", ":"))
        return hashlib.sha256(doc.encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class Trial:
    """One ledger-keyed unit of work.

    kind='uniform': ``recipe`` is the full QuantRecipe; the key is its
    content hash. kind='mixed': ``budget`` is the mean weight-bit
    budget and ``components`` the uniform recipes (sorted by wbits)
    whose artifacts the allocation composes; the key hashes budget +
    component hashes, so it inherits content-identity from them.
    """
    kind: str
    label: str
    recipe: Optional[QuantRecipe] = None
    budget: Optional[float] = None
    components: Tuple[QuantRecipe, ...] = ()

    def key(self) -> str:
        if self.kind == "uniform":
            return self.recipe.content_hash()
        doc = json.dumps(
            {"kind": "mixed", "budget": float(self.budget),
             "components": [r.content_hash() for r in self.components]},
            sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(doc.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "label": self.label, "key": self.key()}
        if self.kind == "uniform":
            d["recipe"] = self.recipe.to_dict()
        else:
            d["budget"] = float(self.budget)
            d["components"] = [r.to_dict() for r in self.components]
        return d


def _label(recipe: QuantRecipe) -> str:
    parts = [recipe.bits, recipe.method]
    if recipe.tgq_groups is not None:
        parts.append(f"G{recipe.tgq_groups}")
    if recipe.method == "ho":
        if not recipe.use_mrq:
            parts.append("nomrq")
        if not recipe.use_tgq:
            parts.append("notgq")
    return "/".join(parts)


def expand(space: SearchSpace) -> List[Trial]:
    """The concrete trial list: uniform recipes (deduped by content
    hash, grid order preserved) followed by one mixed trial per bit
    budget. Mixed components are the *default-structure* recipe of each
    distinct bits level under the space's first method/group setting —
    guaranteed (by construction here) to also appear as uniform trials,
    so the driver has their artifacts and per-group sensitivities in
    hand before any mixed trial runs."""
    trials: List[Trial] = []
    seen = set()

    def add_uniform(recipe: QuantRecipe) -> QuantRecipe:
        t = Trial(kind="uniform", label=_label(recipe), recipe=recipe)
        if t.key() not in seen:
            seen.add(t.key())
            trials.append(t)
        return recipe

    components = {}                       # bits -> component recipe
    for method in space.methods:
        for groups in space.tgq_groups:
            for bits in space.bits:
                if method == "range":
                    r = add_uniform(QuantRecipe(
                        bits=bits, method="range", tgq_groups=groups,
                        attn_impl=space.attn_impl, seed=space.seed,
                        n_per_group=space.n_per_group,
                        calib_batch=space.calib_batch))
                    components.setdefault((bits, groups), r)
                else:
                    for mrq in space.use_mrq:
                        for tgq in space.use_tgq:
                            r = add_uniform(QuantRecipe(
                                bits=bits, method="ho", tgq_groups=groups,
                                use_mrq=mrq, use_tgq=tgq,
                                rounds=space.ho_rounds,
                                n_alpha=space.ho_n_alpha,
                                attn_impl=space.attn_impl, seed=space.seed,
                                n_per_group=space.n_per_group,
                                calib_batch=space.calib_batch))
                            if mrq and tgq:
                                components.setdefault((bits, groups), r)

    if space.bit_budgets:
        g0 = space.tgq_groups[0]
        missing = sorted(b for b in set(space.bits)
                         if (b, g0) not in components)
        if missing:
            raise ValueError(
                f"mixed trials need a full-structure component recipe per "
                f"bits level, but {missing} never expanded with "
                "use_mrq=use_tgq=True — add True to those axes")
        comps = sorted(
            {b: components[(b, g0)] for b in set(space.bits)}.values(),
            key=lambda r: r.wbits)
        for budget in space.bit_budgets:
            trials.append(Trial(
                kind="mixed", label=f"mixed-b{float(budget):g}",
                budget=float(budget), components=tuple(comps)))
    return trials
