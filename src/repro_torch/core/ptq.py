"""TQ-DiT PTQ pipeline — Algorithm 1 end to end, port of ``repro/core/ptq.py``.

Phase 1 (calibration data) is the caller's (for DiT:
``core.calib.build_dit_calibration`` draws n samples per timestep group).
Phase 2 runs fp forwards storing activations (``CalibrationContext``) and
one tap-backward per batch for the Fisher weights (``core.fisher``).
Phase 3 runs the HO candidate search per op (``core.search``: TGQ + MRQ
for post-softmax MatMuls, MRQ for post-GELU/SiLU inputs, symmetric
per-tensor for attention q/k/v, uniform elsewhere).

The result is a ``qparams`` dict for ``QuantContext``; with
``report["weights"]`` it feeds ``kernels.ops.convert_for_kernels``, which
packs every eligible linear and attention einsum pair for the CUDA
kernels. ``repro_torch.quant.quantize(..., QuantRecipe(method="ho"))``
runs this pipeline, packs and returns a ``QuantArtifact``; ``run_ptq``
stays public for research loops that want the raw (qparams, report).

The searches run their f32 products at
``torch.set_float32_matmul_precision("highest")`` (no TF32 on the card);
the caller's setting is restored afterwards.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.contexts import (
    CalibrationContext, QuantContext, RecordingContext, _host, stable_seed,
)
from repro_torch.core.fisher import (
    discover_tap_shapes, make_fisher_fn, subsample_rows_like,
)
from repro_torch.core.search import (
    SearchCfg, search_einsum, search_hook_act, search_linear,
)
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PTQConfig:
    wbits: int = 8
    abits: int = 8
    rounds: int = 3
    n_alpha: int = 20
    use_fisher: bool = True          # HO (vs plain MSE)
    use_mrq: bool = True             # multi-region quantizers
    use_tgq: bool = True             # time-grouped post-softmax params
    tgq_groups: int = 10             # G
    max_rows_per_batch: int = 256
    max_batch_sub: int = 4
    skip_patterns: Tuple[str, ...] = ("router",)
    weight_only_patterns: Tuple[str, ...] = ()
    # 'batch' scales each calibration batch's Fisher to unit RMS per op
    # (the empirical Fisher shrinks at high-noise timesteps, and raw
    # weighting over-clips exactly those samples); 'raw' keeps it as is.
    fisher_norm: str = "batch"
    bias_correct: bool = False       # PTQD-like output correction
    channel_balance: bool = False    # PTQ4DiT-like salience balancing
    balance_alpha: float = 0.5
    seed: int = 0

    def search_cfg(self) -> SearchCfg:
        return SearchCfg(wbits=self.wbits, abits=self.abits,
                         rounds=self.rounds, n_alpha=self.n_alpha,
                         use_fisher=self.use_fisher, use_mrq=self.use_mrq,
                         use_tgq=self.use_tgq, tgq_groups=self.tgq_groups)


def _skip(name: str, patterns) -> bool:
    return any(p in name for p in patterns)


def _batch_device(batch):
    """The device of the first tensor in a calibration batch, or None."""
    vals = batch.values() if isinstance(batch, dict) else [batch]
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
    return None


def run_ptq(loss_fn: Callable, calib_batches: List[Tuple[Any, int]],
            cfg: PTQConfig, device=None
            ) -> Tuple[Dict[str, dict], Dict[str, Any]]:
    """Run Algorithm 1.

    loss_fn(ctx, batch) -> scalar task loss (Eq. 11 for DiT), the forward
    routing its ops through ``ctx``; calib_batches: [(batch, tgroup)].
    The taps and the search run on ``device`` (default: the batches'
    device, else ``"cuda"``). Returns (qparams, report)."""
    dev = resolve_device(device if device is not None
                         else _batch_device(calib_batches[0][0]))
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return _run_ptq(loss_fn, calib_batches, cfg, dev)
    finally:
        torch.set_float32_matmul_precision(precision)


def _run_ptq(loss_fn, calib_batches, cfg: PTQConfig, dev):
    t0 = time.perf_counter()
    report: Dict[str, Any] = {}

    # ---- Phase 2a: op discovery ----------------------------------------------
    rec = RecordingContext()
    with torch.no_grad():
        loss_fn(rec, calib_batches[0][0])
    registry = rec.registry
    report["n_ops"] = len(registry)
    # act hooks not directly consumed by a matmul (SwiGLU silu gates) are
    # quantized at the hook: the two-lobe MRQ lives on the silu output
    hook_acts = frozenset(n for n, kind in rec.acts.items()
                          if kind == "post_silu" and cfg.use_mrq)

    # ---- Phase 2b: calibration capture ---------------------------------------
    cal = CalibrationContext(registry=registry, hook_acts=hook_acts,
                             max_rows_per_batch=cfg.max_rows_per_batch,
                             max_batch_sub=cfg.max_batch_sub, seed=cfg.seed)
    with torch.no_grad():
        for batch, tg in calib_batches:
            cal.begin_batch()
            loss_fn(dataclasses.replace(cal, tgroup=tg), batch)

    # ---- Phase 2c: Fisher taps (HO) ------------------------------------------
    fish: Dict[str, List[Optional[np.ndarray]]] = {n: [] for n in registry}
    if cfg.use_fisher:
        shapes = discover_tap_shapes(loss_fn, calib_batches[0][0])
        fisher_fn = make_fisher_fn(loss_fn, shapes, device=dev)
        for batch, _ in calib_batches:
            g = fisher_fn(batch)
            for name, info in registry.items():
                if name not in g:
                    fish[name].append(None)
                    continue
                garr = _host(g[name])
                if info.kind == "linear":
                    rows = subsample_rows_like(garr, cfg.max_rows_per_batch,
                                               stable_seed(name, cfg.seed))
                else:
                    rows = garr[: cfg.max_batch_sub]
                if cfg.fisher_norm == "batch":
                    # the whole batch's RMS, applied to the kept rows
                    # (elementwise: the reference's values bit for bit)
                    rows = rows / (np.sqrt(np.mean(np.square(garr)))
                                   + 1e-20)
                fish[name].append(rows)
            del g
    else:
        for name in registry:
            fish[name] = [None] * len(calib_batches)

    t_capture = time.perf_counter() - t0

    # ---- Phase 3: per-op candidate search ------------------------------------
    scfg = cfg.search_cfg()
    qparams: Dict[str, dict] = {}
    op_s: Dict[str, float] = {}             # each op's search, wall seconds
    for name, info in registry.items():
        if _skip(name, cfg.skip_patterns) or name not in cal.store:
            continue
        t_op = time.perf_counter()
        weight_only = _skip(name, cfg.weight_only_patterns)
        if info.kind == "linear":
            xs = [r["x"] for r in cal.store[name]]
            prescale = None
            if cfg.channel_balance:
                prescale = _balance_vector(np.concatenate(xs, 0),
                                           cal.weights[name],
                                           cfg.balance_alpha)
            qparams[name] = search_linear(
                info, xs, fish[name], cal.weights[name], scfg,
                weight_only=weight_only, prescale=prescale,
                tgs=[r["tg"] for r in cal.store[name]], device=dev)
        else:
            qparams[name] = search_einsum(
                info, cal.store[name], fish[name], scfg,
                w=cal.weights.get(name), weight_only=weight_only,
                device=dev)
        op_s[name] = time.perf_counter() - t_op

    # hook-quantized activations (MRQ-SiLU): plain-MSE grid over the stored
    # samples; the downstream projection's own HO search covers the joint
    # error
    for name in sorted(cal.act_store):
        t_op = time.perf_counter()
        qparams[name] = {"act": search_hook_act(cal.act_store[name], scfg,
                                                device=dev)}
        op_s[name] = time.perf_counter() - t_op

    # ---- optional PTQD-like bias correction ----------------------------------
    if cfg.bias_correct:
        for name, info in registry.items():
            if name not in qparams or info.kind != "linear":
                continue
            qp = qparams[name]
            X = torch.from_numpy(np.concatenate(
                [r["x"] for r in cal.store[name]], 0)).float().to(dev)
            W = torch.from_numpy(cal.weights[name]).float().to(dev)
            yq = QuantContext(qparams={name: qp}).linear(name, X, W)
            qp["out_bias"] = torch.mean(X @ W - yq, dim=0)

    calib_bytes = sum(
        sum((r["x"].nbytes if "x" in r else
             r["a"].nbytes + r.get("b", np.zeros(0)).nbytes)
            for r in recs)
        for recs in cal.store.values())
    calib_bytes += sum(sum(0 if g is None else g.nbytes for g in gl)
                       for gl in fish.values())

    report.update({
        "wall_s": time.perf_counter() - t0,
        "capture_s": t_capture,
        # attention blocks whose serving packs can be complete: BOTH the
        # /qk and /pv einsum of the block were quantized
        "n_attention_einsums": sum(
            1 for n, i in registry.items()
            if i.kind == "einsum" and n.endswith("/qk")
            and n in qparams and n[:-3] + "/pv" in qparams),
        "search_s": time.perf_counter() - t0 - t_capture,
        "op_search_s": op_s,
        "calib_bytes": int(calib_bytes),
        "n_quantized": len(qparams),
        "n_batches": len(calib_batches),
        # the fp weights of Phase 2b by op name (numpy): the second
        # argument of convert_for_kernels. In-process only — a full
        # weight copy, never persisted.
        "weights": dict(cal.weights),
    })
    return qparams, report


def _balance_vector(X: np.ndarray, W: np.ndarray, alpha: float) -> np.ndarray:
    """PTQ4DiT/SmoothQuant-style per-input-channel salience balancing:
    s_j = max|X_j|^a / max|W_j|^(1-a)."""
    ax = np.maximum(np.max(np.abs(X), axis=0), 1e-5)
    aw = np.maximum(np.max(np.abs(W), axis=1), 1e-5)
    s = ax ** alpha / aw ** (1 - alpha)
    return np.clip(s / np.sqrt(np.median(s ** 2) + 1e-12), 0.1, 10.0)


def make_quant_context(qparams: Dict[str, dict], kernel: bool = False
                       ) -> QuantContext:
    """DEPRECATED shim, as in the reference: use
    ``repro_torch.quant.quantize(...).context(...)``, or
    ``QuantContext(qparams=..., kernel=...)`` for a raw qparams dict."""
    import warnings
    warnings.warn(
        "make_quant_context is deprecated: use repro_torch.quant.api."
        "quantize(...).context(...) (or QuantContext(qparams=..., "
        "kernel=...) for a raw qparams dict)", DeprecationWarning,
        stacklevel=2)
    return QuantContext(qparams=qparams, kernel=kernel)
