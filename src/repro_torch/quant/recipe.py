"""`QuantRecipe` — the one frozen description of HOW to quantize.

Port of ``repro/quant/recipe.py`` (numpy/json only, so the hash of a
recipe is the same in both packages).

Before the unified API the same knobs lived in three places:
``core.ptq.PTQConfig`` (the HO pipeline), ``core.search.SearchCfg``
(derived from it), and the ad-hoc kwargs of
``serving.quickcal.range_calibrate`` (bits, samples per group). A recipe
collapses all of them into one hashable, JSON-round-trippable value that

- ``repro.quant.quantize`` dispatches on (``method`` picks the pipeline,
  every other field parameterizes it),
- ``QuantArtifact`` embeds verbatim, so a loaded artifact can be checked
  against the recipe a deployment expects (`QuantArtifact.load(path,
  expect_recipe=...)`).

Bit-widths are named (``w8a8``/``w6a6``/``w4a4``) rather than two free
ints because those are the repo's supported deployment points — every
one of them is kernel-real: w8a8/w6a6 run the fused int8 kernel family
(byte codes, only the clip range differs), w4a4 the nibble-packed int4
family with per-K-group weight scales.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Tuple

BITS = {"w8a8": (8, 8), "w6a6": (6, 6), "w4a4": (4, 4)}
METHODS = ("range", "ho")
ATTN_IMPLS = ("flash", "composed")


@dataclasses.dataclass(frozen=True)
class QuantRecipe:
    """One frozen value describing a quantization run end to end.

    bits    : 'w8a8' | 'w6a6' | 'w4a4' (weight/activation bit-widths).
    method  : 'range' — min/max calibration in seconds (serving bring-up;
              ``serving.quickcal.range_calibrate``); 'ho' — the paper's
              full Hessian-guided candidate search (``core.ptq.run_ptq``).
    use_mrq / use_tgq / tgq_groups : the paper's multi-region quantizers
              and time-grouped parameters. ``tgq_groups=None`` inherits
              the DiffusionCfg's group count (the usual case — the groups
              must agree with the sampler threading them).
    use_fisher / rounds / n_alpha / max_rows_per_batch / fisher_norm /
    bias_correct / channel_balance / balance_alpha : HO-search knobs
              (ignored by 'range'); see ``core.ptq.PTQConfig``.
    n_per_group / calib_batch : Phase-1 calibration sampling (both
              methods) when the caller does not supply ``calib_data``.
    skip_patterns / weight_only_patterns : op-name substrings excluded
              from (activation) quantization. 'ho' only — together with
              ``use_mrq``/``use_tgq``, ``quantize()`` REJECTS non-default
              values under method='range' (that pipeline has no such
              knobs, and silently recording them in the artifact would
              describe a calibration that never happened).
    attn_impl : how w8a8 serving lowers the attention seam — 'flash'
              (default: one fused Pallas kernel, no (S,S) HBM
              round-trip) or 'composed' (the three-kernel exactness
              oracle). A serving-lowering choice, not a calibration
              one — both impls consume the identical packs — but it
              rides the recipe so an artifact records the lowering its
              deployment was validated against (both methods honor it).
    seed    : base PRNG seed for calibration draws and row subsampling.
    """
    bits: str = "w8a8"
    method: str = "range"
    use_mrq: bool = True
    use_tgq: bool = True
    tgq_groups: Optional[int] = None
    use_fisher: bool = True
    rounds: int = 3
    n_alpha: int = 20
    max_rows_per_batch: int = 256
    fisher_norm: str = "batch"
    bias_correct: bool = False
    channel_balance: bool = False
    balance_alpha: float = 0.5
    n_per_group: int = 4
    calib_batch: int = 4
    skip_patterns: Tuple[str, ...] = ("router",)
    weight_only_patterns: Tuple[str, ...] = ()
    attn_impl: str = "flash"
    seed: int = 0

    def __post_init__(self):
        if self.bits not in BITS:
            raise ValueError(
                f"QuantRecipe.bits must be one of {sorted(BITS)}, "
                f"got {self.bits!r}")
        if self.method not in METHODS:
            raise ValueError(
                f"QuantRecipe.method must be one of {METHODS}, "
                f"got {self.method!r}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"QuantRecipe.attn_impl must be one of {ATTN_IMPLS}, "
                f"got {self.attn_impl!r}")
        # frozen dataclass: normalize list -> tuple via object.__setattr__
        for f in ("skip_patterns", "weight_only_patterns"):
            object.__setattr__(self, f, tuple(getattr(self, f)))

    @property
    def wbits(self) -> int:
        return BITS[self.bits][0]

    @property
    def abits(self) -> int:
        return BITS[self.bits][1]

    def ptq_config(self, tgq_groups: int):
        """The equivalent ``PTQConfig`` for the 'ho' pipeline."""
        from repro_torch.core.ptq import PTQConfig
        return PTQConfig(
            wbits=self.wbits, abits=self.abits, rounds=self.rounds,
            n_alpha=self.n_alpha, use_fisher=self.use_fisher,
            use_mrq=self.use_mrq, use_tgq=self.use_tgq,
            tgq_groups=tgq_groups,
            max_rows_per_batch=self.max_rows_per_batch,
            skip_patterns=self.skip_patterns,
            weight_only_patterns=self.weight_only_patterns,
            fisher_norm=self.fisher_norm, bias_correct=self.bias_correct,
            channel_balance=self.channel_balance,
            balance_alpha=self.balance_alpha, seed=self.seed)

    @property
    def kernel_deployable(self) -> bool:
        """Every named bit-width lowers onto a CUDA kernel family:
        w8a8/w6a6 on the fused int8 kernels (byte codes, narrower clip
        range at 6 bits), w4a4 on the packed-int4 kernels (two nibbles
        per byte, per-K-group weight scales)."""
        return self.bits in BITS

    # -- serialization (artifact metadata + mismatch checks) ---------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for f in ("skip_patterns", "weight_only_patterns"):
            d[f] = list(d[f])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "QuantRecipe":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown QuantRecipe fields: {sorted(unknown)} "
                             "(artifact written by a newer version?)")
        return cls(**d)

    def diff(self, other: "QuantRecipe") -> dict:
        """{field: (self_value, other_value)} for every differing field."""
        a, b = self.to_dict(), other.to_dict()
        return {k: (a[k], b[k]) for k in a if a[k] != b[k]}

    # -- content identity ---------------------------------------------------
    def canonical_json(self) -> str:
        """The recipe as canonical JSON: keys sorted, no whitespace.
        Field *declaration* order never leaks in, so the serialization —
        and therefore :meth:`content_hash` — is stable across dataclass
        reorderings and across dicts built in any key order."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    def content_hash(self) -> str:
        """Stable content digest of the frozen recipe (sha256 of
        :meth:`canonical_json`, first 16 hex chars).

        Two recipes hash equal iff they are field-for-field equal; any
        single field change changes the hash (tested exhaustively in
        ``tests/test_quant_api.py``). This is the identity
        ``repro.autotune`` keys its trial ledger by — a resumed sweep
        recognizes a completed trial by recipe content, not by position
        in the grid — and ``quantize()`` records it under
        ``meta["recipe_hash"]`` so a saved artifact names the exact
        configuration that produced it."""
        return hashlib.sha256(
            self.canonical_json().encode()).hexdigest()[:16]
