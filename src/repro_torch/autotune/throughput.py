"""The sweep's throughput axis, measured on the card — the port's
counterpart of ``benchmarks/serve_throughput.py::recipe_model_path`` and
``modeled_goodput``, which model a TPU's roofline.

:func:`measure_step_s` serves DiT-XL/2 (``configs/dit_xl_2.py::full``)
through the sync ``ServeEngine`` with CFG, once per serving path a sweep
needs, and returns the median seconds per CFG-paired step of each. The
driver measures once per sweep and keeps the result in the ledger
(``driver.py``), so a resumed sweep charges its trials the same table.
"""
from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

# path -> (the recipe bits it is calibrated at, attention lowering)
PATHS = {"int8": ("w8a8", "flash"), "int8_composed": ("w8a8", "composed"),
         "int4": ("w4a4", "flash")}
CFG_SCALE = 1.5


def recipe_path(recipe) -> str:
    """The serving path a recipe (anything with ``bits`` and
    ``attn_impl``) runs on: w8a8 and w6a6 ride the fused int8 kernels
    (byte codes; only the clip range differs), with flash or the composed
    three-kernel attention by ``attn_impl``; w4a4 rides the packed-int4
    kernels with packed-kv flash."""
    if recipe.bits == "w4a4":
        return "int4"
    if recipe.attn_impl == "composed":
        return "int8_composed"
    return "int8"


def card(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them; ``"cpu"`` for
    the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.splitlines()
    return out[dev.index or 0].strip()


def measure_step_s(paths: Sequence[str], ecfg, *, serve_cfg=None,
                   device=None, params=None, artifacts=None,
                   runs: int = 3) -> dict:
    """Seconds per CFG-paired step of each serving path in ``paths``.

    For each path: ``ecfg.serve_b_local`` requests of ``ecfg.serve_steps``
    steps (CFG 1.5) through the sync ``ServeEngine`` on the path's kernel
    context — one warm-up serve, then ``runs`` timed serves with the card
    synchronised around each. Every timed serve must launch each packed
    op's kernel once a forward and nothing else (on the CPU: nothing),
    and the artifact must have no fallback op.

    serve_cfg : the DiTCfg served (default DiT-XL/2,
        ``configs/dit_xl_2.py::full``).
    params    : its weights on ``device`` (default: initialised from seed
        0 and perturbed as ``launch/serve.py::perturb_init`` does).
    artifacts : {path: QuantArtifact} calibrated against ``params``; a
        path without one is range-calibrated at its bits first, outside
        the timed serves.

    Returns the ledger's throughput row without its ``kind``: ``step_s``
    (the median a path), ``spread_s`` (max - min), ``runs_s`` (every
    run), ``launches`` (the timed serves' kernel launches a path), the
    card, the serving point and the seconds the measurement took.
    """
    from repro_torch import kernels
    from repro_torch.configs import dit_xl_2
    from repro_torch.diffusion.ddpm import DiffusionCfg
    from repro_torch.launch.serve import perturb_init
    from repro_torch.models.dit import dit_init
    from repro_torch.quant.api import quantize
    from repro_torch.quant.recipe import QuantRecipe
    from repro_torch.serving.batching import GenRequest
    from repro_torch.serving.engine import ServeEngine

    t_all = time.perf_counter()
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = serve_cfg if serve_cfg is not None else dit_xl_2.full()
    if params is None:
        params = perturb_init(dit_init(0, cfg, device=dev), 0)
    artifacts = dict(artifacts or {})
    b, steps = ecfg.serve_b_local, ecfg.serve_steps
    reqs = [GenRequest(request_id=i, label=i % cfg.n_classes, steps=steps,
                       cfg_scale=CFG_SCALE, seed=i) for i in range(b)]
    row = {"card": card(dev), "device": dev.type,
           "serve": {"cfg": dataclasses.asdict(cfg), "b_local": b,
                     "steps": steps, "cfg_scale": CFG_SCALE},
           "runs": runs, "step_s": {}, "spread_s": {}, "runs_s": {},
           "launches": {}}
    for path in sorted(paths):
        bits, attn_impl = PATHS[path]
        art = artifacts.get(path)
        if art is None:
            art = quantize(params, cfg, DiffusionCfg(T=1000),
                           QuantRecipe(bits=bits, attn_impl=attn_impl))
        if art.fallback_ops():
            raise ValueError(f"{path}: the artifact's ops "
                             f"{art.fallback_ops()} carry no kernel pack")
        engine = ServeEngine.from_artifact(
            params, art, attn_impl=attn_impl, microbatch=b,
            step_buckets=(steps,), device=dev)
        want = {k: 0 for k in kernels.LAUNCHES}
        if dev.type == "cuda":
            want.update({k: n * steps for k, n
                         in art.packed_counts(attn_impl).items()})
        engine.serve(reqs)                              # warm-up
        times, total = [], {}
        for _ in range(runs):
            sync()
            kernels.reset_launches()
            t0 = time.perf_counter()
            engine.serve(reqs)
            sync()
            times.append((time.perf_counter() - t0) / steps)
            launches = dict(kernels.LAUNCHES)
            if launches != want:
                raise RuntimeError(
                    f"{path}: launch counts {launches} != packed ops x "
                    f"forwards {want}")
            for k, n in launches.items():
                if n:
                    total[k] = total.get(k, 0) + n
        row["step_s"][path] = float(np.median(times))
        row["spread_s"][path] = max(times) - min(times)
        row["runs_s"][path] = times
        row["launches"][path] = total
        del engine
    row["wall_s"] = time.perf_counter() - t_all
    return row

