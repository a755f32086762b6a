"""`quantize()` — the single quantization entry point (port of
``repro/quant/api.py``, 'range' method).

    artifact = quantize(params, dcfg, dif, QuantRecipe(bits="w8a8"))
    engine = ServeEngine.from_artifact(params, artifact)

Runs the range calibration (``serving.quickcal.range_calibrate``) on the
params' device, packs the results for the kernel family of the recipe's
bit-width (``kernels.ops.convert_for_kernels``) and returns a
:class:`QuantArtifact` whose ``context()`` serves through the kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint import ckpt
from repro_torch.quant.artifact import ARTIFACT_VERSION, QuantArtifact
from repro_torch.quant.groups import group_boundaries
from repro_torch.quant.recipe import QuantRecipe

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

    ``calib_data`` (``[(batch_dict, group)]``) is validated for every
    method, before the method is dispatched, as the reference does: a
    group tag outside [0, G) raises ``ValueError``. The 'range' method
    then ignores it and draws its own capture set (its protocol is part
    of the method); 'ho' is not ported yet and raises
    ``NotImplementedError``."""
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
    if recipe.method == "ho":
        raise NotImplementedError(
            "method='ho' (the Hessian-guided search) is not ported yet: "
            "ROADMAP queue 1, item 3 (the HO calibration)")
    defaults = QuantRecipe()
    unsupported = [f for f in _HO_ONLY
                   if getattr(recipe, f) != getattr(defaults, f)]
    if unsupported:
        raise ValueError(
            f"QuantRecipe(method='range') cannot honor {unsupported}: the "
            "range pipeline quantizes every op with the full MRQ+TGQ "
            "structure and runs no search")

    from repro_torch.kernels.ops import convert_for_kernels
    from repro_torch.serving.quickcal import range_calibrate
    qparams, weights = range_calibrate(
        params, model_cfg, dif_cfg, sched, seed=recipe.seed,
        wbits=recipe.wbits, abits=recipe.abits, n_per_group=recipe.n_per_group, batch=recipe.calib_batch,
        max_rows=recipe.max_rows_per_batch)
    qparams = convert_for_kernels(qparams, weights)
    dev = params["x_proj"]["w"].device
    qparams = _to_device(qparams, dev)
    meta = {
        "format_version": ARTIFACT_VERSION,
        "model": {"class": type(model_cfg).__name__,
                  "cfg": dataclasses.asdict(model_cfg)},
        "params_hash": ckpt.content_hash(params),
        "dif": dataclasses.asdict(dif_cfg),
        "tgq_groups": dif_cfg.tgq_groups,
        "tgq_group_boundaries": [list(b) for b in group_boundaries(
            dif_cfg.T, dif_cfg.tgq_groups)],
        "calib": {"n_quantized": len(qparams)},
        "recipe_hash": recipe.content_hash(),
        "provenance": dict(provenance or {}),
    }
    return QuantArtifact(qparams=qparams, recipe=recipe, meta=meta)


def _to_device(tree, dev):
    import torch
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _to_device(getattr(tree, f.name), dev)
            for f in dataclasses.fields(tree)})
    return tree
