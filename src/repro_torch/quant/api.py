"""`quantize()` — the single quantization entry point (port of
``repro/quant/api.py``).

    artifact = quantize(params, dcfg, dif, QuantRecipe(bits="w8a8",
                                                       method="ho"))
    artifact.save("/ckpts/dit_w8a8")
    # ... later, in a fresh process (no recalibration):
    artifact = QuantArtifact.load("/ckpts/dit_w8a8")
    engine = ServeEngine.from_artifact(params, artifact)

Dispatch is by ``recipe.method``: 'range' runs
``serving.quickcal.range_calibrate`` (min/max ranges, seconds); 'ho' runs
the paper's Algorithm 1 (``core.ptq.run_ptq``: Fisher taps, alternating
candidate search, MRQ and TGQ). Either way the results are packed for the
kernel family of the recipe's bit-width
(``kernels.ops.convert_for_kernels``) and moved to the params' device, so
``artifact.context()`` serves through the CUDA kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint import ckpt
from repro_torch.quant.artifact import ARTIFACT_VERSION, QuantArtifact
from repro_torch.quant.groups import group_boundaries
from repro_torch.quant.recipe import QuantRecipe

# calibrations run in this process (``launch/serve.py`` reports it: a cold
# start from a saved artifact runs none)
CALIBRATIONS = 0

_HO_ONLY = ("skip_patterns", "weight_only_patterns", "use_mrq", "use_tgq",
            "use_fisher", "rounds", "n_alpha", "fisher_norm", "bias_correct",
            "channel_balance", "balance_alpha")


def quantize(params, model_cfg, dif_cfg, recipe: QuantRecipe,
             calib_data: Optional[List[Tuple[Dict[str, Any], int]]] = None,
             *, sched=None, provenance: Optional[dict] = None
             ) -> QuantArtifact:
    """Calibrate + pack in one call; returns a QuantArtifact whose
    meta records the model/diffusion configs, the params' content hash,
    the TGQ group boundaries and the recipe hash, as the reference's.

    ``calib_data`` (``[(batch_dict, group)]``, ``core.calib.
    build_dit_calibration``'s output) is validated for every method,
    before the method is dispatched, as the reference does: a group tag
    outside [0, G) raises ``ValueError``. 'ho' calibrates on it; ``None``
    builds a Gaussian-latent set from ``torch.Generator`` seeded with
    ``recipe.seed`` on the params' device, sized by
    ``recipe.n_per_group`` / ``recipe.calib_batch``. The 'range' method
    ignores it and draws its own capture set (its protocol is part of the
    method). ``meta["calib"]`` records the pipeline's scalar stats."""
    global CALIBRATIONS
    if recipe.tgq_groups is not None \
            and recipe.tgq_groups != dif_cfg.tgq_groups:
        if calib_data is not None:
            raise ValueError(
                f"recipe.tgq_groups={recipe.tgq_groups} overrides "
                f"dif_cfg.tgq_groups={dif_cfg.tgq_groups} but calib_data "
                "was supplied — build it under the intended group count")
        dif_cfg = dataclasses.replace(dif_cfg, tgq_groups=recipe.tgq_groups)
    if calib_data is not None:
        bad = sorted({int(tg) for _, tg in calib_data
                      if not 0 <= int(tg) < dif_cfg.tgq_groups})
        if bad:
            raise ValueError(
                f"calib_data group tags {bad} out of range for "
                f"tgq_groups={dif_cfg.tgq_groups}")
    dev = params["x_proj"]["w"].device
    if recipe.method == "range":
        defaults = QuantRecipe()
        unsupported = [f for f in _HO_ONLY
                       if getattr(recipe, f) != getattr(defaults, f)]
        if unsupported:
            raise ValueError(
                f"QuantRecipe(method='range') cannot honor {unsupported}: "
                "the range pipeline quantizes every op with the full "
                "MRQ+TGQ structure and runs no search — use method='ho' "
                "for these knobs")
        from repro_torch.serving.quickcal import range_calibrate
        qparams, weights = range_calibrate(
            params, model_cfg, dif_cfg, sched, seed=recipe.seed,
            wbits=recipe.wbits, abits=recipe.abits,
            n_per_group=recipe.n_per_group, batch=recipe.calib_batch,
            max_rows=recipe.max_rows_per_batch)
        calib_stats: Dict[str, Any] = {"n_quantized": len(qparams)}
    else:                                               # "ho"
        import torch

        from repro_torch.core.calib import build_dit_calibration, dit_loss_fn
        from repro_torch.core.ptq import run_ptq
        from repro_torch.diffusion.ddpm import make_schedule
        if calib_data is None:
            gen = torch.Generator(device=dev).manual_seed(int(recipe.seed))
            x0 = lambda n, g: torch.randn(
                (n, model_cfg.img_size, model_cfg.img_size, model_cfg.in_ch),
                generator=g, device=dev)
            calib_data = build_dit_calibration(
                model_cfg, dif_cfg,
                sched if sched is not None else make_schedule(dif_cfg), x0,
                gen, n_per_group=recipe.n_per_group,
                batch=recipe.calib_batch, device=dev)
        qparams, report = run_ptq(dit_loss_fn(params, model_cfg), calib_data,
                                  recipe.ptq_config(dif_cfg.tgq_groups),
                                  device=dev)
        weights = report.pop("weights")     # full fp copy — never persisted
        calib_stats = {k: v for k, v in report.items()
                       if isinstance(v, (int, float, str))}
        qparams = to_device(qparams, "cpu")  # beside the captured weights
    CALIBRATIONS += 1

    from repro_torch.kernels.ops import convert_for_kernels
    qparams = to_device(convert_for_kernels(qparams, weights), dev)
    meta = {
        "format_version": ARTIFACT_VERSION,
        "model": {"class": type(model_cfg).__name__,
                  "cfg": dataclasses.asdict(model_cfg)},
        "params_hash": ckpt.content_hash(params),
        "dif": dataclasses.asdict(dif_cfg),
        "tgq_groups": dif_cfg.tgq_groups,
        "tgq_group_boundaries": [list(b) for b in group_boundaries(
            dif_cfg.T, dif_cfg.tgq_groups)],
        "calib": calib_stats,
        "recipe_hash": recipe.content_hash(),
        "provenance": dict(provenance or {}),
    }
    return QuantArtifact(qparams=qparams, recipe=recipe, meta=meta)


def to_device(tree, dev):
    """A qparams tree (dicts, quantizer dataclasses, tensors) with every
    tensor moved to ``dev``."""
    import torch
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: to_device(getattr(tree, f.name), dev)
            for f in dataclasses.fields(tree)})
    return tree
