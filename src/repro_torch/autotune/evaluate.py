"""Trial scoring: two-stage quality evaluation + throughput — port of
``repro/autotune/evaluate.py``.

Every trial gets a CHEAP stage-1 score first — quantized-vs-FP noise
prediction MSE per TGQ timestep group (one forward per group; no
sampling, no feature nets). Only survivors of the stage-1 gate run
stage 2: full respaced-DDPM generation scored with the FD / sFD /
IS-proxy stack (``repro_torch.quant.eval``), the expensive part of a
sweep. The gate (:func:`select_survivors`) is a deterministic pure
function of ALL stage-1 results, so a resumed sweep reaches the identical
verdicts:

- every trial with ``noise_mse <= prune_factor * best`` survives,
- the ``keep_at_least`` lowest-MSE trials always survive, and
- the max-throughput trial always survives — the frontier's fast
  endpoint must be quality-scored or the Pareto set would be missing it
  by construction, not by evidence.

Throughput is where the port departs from the reference. The reference
charges each trial at a closed-form roofline of the TPU; the port serves
DiT-XL/2 on the card once per sweep (``autotune.throughput.
measure_step_s``) and charges each trial from that table of seconds per
CFG-paired step, ``step_s = {path: s}``. :func:`uniform_throughput` and
:func:`mixed_throughput` are pure functions of the table, with the
reference's expressions in the reference's order, so a table holding the
reference's own step times reproduces its floats bit for bit. Mixed (per
group bit) trials charge each respaced denoising step at its group's
kernel path and sum.

The AdaTSQ-style allocator lives here too: :func:`sensitivity_by_bits`
reads each uniform component's per-group stage-1 MSE as the sensitivity
signal, and :func:`allocate_bits` greedily upgrades the group with the
best MSE-drop-per-bit until the mean-bit budget is spent.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.autotune.throughput import recipe_path
from repro_torch.diffusion.ddpm import respaced_timesteps, tgroup_of
from repro_torch.quant import eval as qeval
from repro_torch.quant.recipe import BITS


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """The evaluation protocol — every knob that shapes a trial's score.

    Hash-guarded in the ledger header: scores taken under different
    protocols are not comparable, so a resume under a changed protocol
    must fail fast rather than mix them. The fields and the hash are the
    reference's.

    steps/n_gen/gen_batch/gen_seed : stage-2 generation.
    n_real/data_seed/net_seed/pipe_seed/pipe_noise : scoring assets
        (see ``repro_torch.quant.eval.eval_assets``).
    n_mse/mse_seed : stage-1 noise-MSE sampling.
    prune_factor/keep_at_least : the stage-1 gate (module docstring).
    serve_* : the serving point every trial's throughput is charged at
        (devices, requests per device, denoising steps). The port
        measures one card, so ``serve_n_dev`` must be 1.
    """
    steps: int = 12
    n_gen: int = 64
    gen_batch: int = 32
    gen_seed: int = 123
    n_real: int = 512
    data_seed: int = 999
    net_seed: int = 1234
    pipe_seed: int = 11
    pipe_noise: float = 0.3
    n_mse: int = 64
    mse_seed: int = 55
    prune_factor: float = 50.0
    keep_at_least: int = 2
    serve_n_dev: int = 1
    serve_b_local: int = 1
    serve_steps: int = 100

    def __post_init__(self):
        if self.serve_n_dev != 1:
            raise ValueError(
                f"serve_n_dev={self.serve_n_dev}: the port measures "
                "throughput on one card and models no others; serving "
                "across GPUs is ROADMAP queue 1, item 9 (multi-GPU)")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def content_hash(self) -> str:
        doc = json.dumps(self.to_dict(), sort_keys=True,
                         separators=(",", ":"))
        return hashlib.sha256(doc.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# stage 1: cheap per-group noise-MSE
# ---------------------------------------------------------------------------
def stage1(params, model_cfg, dif_cfg, ctx, ecfg: EvalConfig,
           device=None) -> dict:
    """Per-group + mean quantized-vs-FP noise MSE. ``ctx`` may be a
    per-group context spec (mixed allocation)."""
    by_group = qeval.noise_mse_by_group(
        params, model_cfg, dif_cfg, ctx, n=ecfg.n_mse, seed=ecfg.mse_seed,
        pipe_seed=ecfg.pipe_seed, pipe_noise=ecfg.pipe_noise, device=device)
    return {"noise_mse": float(np.mean(by_group)),
            "noise_mse_by_group": [float(v) for v in by_group]}


# ---------------------------------------------------------------------------
# stage 2: generation + FD / sFD / IS-proxy
# ---------------------------------------------------------------------------
def stage2(params, model_cfg, dif_cfg, ctx, ecfg: EvalConfig,
           device=None) -> dict:
    """Full sample-and-score. A per-group context spec routes through
    the grouped sampler (equal to the fused one bit for bit for a
    constant map, so mixed and uniform FDs share one protocol)."""
    if isinstance(ctx, (dict, list, tuple)):
        gen, _ = qeval.generate_grouped(
            params, model_cfg, dif_cfg, ctx, steps=ecfg.steps,
            n=ecfg.n_gen, seed=ecfg.gen_seed, batch=ecfg.gen_batch,
            device=device)
    else:
        gen, _ = qeval.generate(
            params, model_cfg, dif_cfg, ctx=ctx, steps=ecfg.steps,
            n=ecfg.n_gen, seed=ecfg.gen_seed, batch=ecfg.gen_batch,
            device=device)
    return qeval.score(gen, model_cfg, n_real=ecfg.n_real,
                       data_seed=ecfg.data_seed, net_seed=ecfg.net_seed,
                       pipe_seed=ecfg.pipe_seed, pipe_noise=ecfg.pipe_noise,
                       device=device)


# ---------------------------------------------------------------------------
# stage-1 gate
# ---------------------------------------------------------------------------
def select_survivors(mse_by_key: Dict[str, float],
                     req_per_s_by_key: Dict[str, float],
                     ecfg: EvalConfig) -> List[str]:
    """The keys advancing to stage 2 (deterministic; see module
    docstring). Sorted for stable iteration/ledger order."""
    if not mse_by_key:
        return []
    best = min(mse_by_key.values())
    keep = {k for k, v in mse_by_key.items()
            if v <= ecfg.prune_factor * best}
    by_mse = sorted(mse_by_key, key=lambda k: (mse_by_key[k], k))
    keep.update(by_mse[:max(ecfg.keep_at_least, 0)])
    # the fast endpoint always advances (ties: lower MSE, then key)
    keep.add(min(req_per_s_by_key,
                 key=lambda k: (-req_per_s_by_key[k], mse_by_key[k], k)))
    return sorted(keep)


# ---------------------------------------------------------------------------
# AdaTSQ-style sensitivity + greedy bit allocation
# ---------------------------------------------------------------------------
def sensitivity_by_bits(stage1_by_bits: Dict[str, dict]) -> Dict[str, List[float]]:
    """{bits level -> per-group noise MSE} from the uniform components'
    stage-1 records — the allocator's input. Free by construction: the
    components are themselves trials, so their per-group vectors are
    already in the ledger before any mixed trial runs."""
    return {b: list(rec["noise_mse_by_group"])
            for b, rec in stage1_by_bits.items()}


def mean_bits(allocation: Sequence[str]) -> float:
    return float(np.mean([BITS[b][0] for b in allocation]))


def allocate_bits(sens: Dict[str, List[float]], budget: float) -> List[str]:
    """Greedy per-group bit assignment under a mean-bit budget.

    Start every group at the lowest level; repeatedly upgrade the group
    with the best sensitivity drop per added bit (one level at a time)
    while the mean stays within ``budget``. Upgrades continue even at a
    measured gain of ~0 — more bits are a-priori no worse, and leaving
    budget unspent would make the budget axis meaningless. Deterministic
    (ties: lower group index), so resumed sweeps re-derive the identical
    allocation."""
    levels = sorted(sens, key=lambda b: BITS[b][0])
    if len(levels) < 2:
        raise ValueError(f"allocation needs >= 2 bits levels, got {levels}")
    G = len(sens[levels[0]])
    if any(len(v) != G for v in sens.values()):
        raise ValueError("sensitivity vectors disagree on group count: "
                         f"{ {b: len(v) for b, v in sens.items()} }")
    alloc = [0] * G                                   # level index per group
    wb = [BITS[b][0] for b in levels]
    total = wb[0] * G
    while True:
        best = None                                   # (gain, -g) max
        for g in range(G):
            lv = alloc[g]
            if lv + 1 >= len(levels):
                continue
            if (total + wb[lv + 1] - wb[lv]) / G > budget + 1e-9:
                continue
            gain = (sens[levels[lv]][g] - sens[levels[lv + 1]][g]) \
                / (wb[lv + 1] - wb[lv])
            if best is None or (gain, -g) > best[0]:
                best = ((gain, -g), g)
        if best is None:
            return [levels[i] for i in alloc]
        g = best[1]
        total += wb[alloc[g] + 1] - wb[alloc[g]]
        alloc[g] += 1


# ---------------------------------------------------------------------------
# throughput from a table of seconds per CFG-paired step
# ---------------------------------------------------------------------------
def uniform_throughput(recipe, ecfg: EvalConfig,
                       step_s: Dict[str, float]) -> Dict[str, float]:
    """Throughput of one uniform recipe at the eval's serving point:
    ``serve_b_local`` requests of ``serve_steps`` CFG-paired steps, each
    at ``step_s[path]`` seconds."""
    path = recipe_path(recipe)
    batch = ecfg.serve_b_local * ecfg.serve_n_dev
    s = step_s[path]
    return {"req_per_s": batch / (ecfg.serve_steps * s),
            "ms_per_step": s * 1e3,
            "path": path,
            "s_per_slot_step_async": s / ecfg.serve_b_local}


def mixed_throughput(allocation: Sequence[str], attn_impl: str,
                     dif_cfg, ecfg: EvalConfig,
                     step_s: Dict[str, float]) -> Dict[str, float]:
    """Throughput of a per-group bit allocation: every respaced
    denoising step is charged at ITS group's kernel-path step time, so a
    chain spending most steps in low-bit groups is as fast as those
    groups' path makes it."""
    paths = {b: recipe_path(_Bits(b, attn_impl)) for b in set(allocation)}
    t_of_path = {p: step_s[p] for p in set(paths.values())}
    use_ts = respaced_timesteps(dif_cfg.T, ecfg.serve_steps)
    total = 0.0
    for t in use_ts:
        g = int(tgroup_of(int(t), dif_cfg.T, dif_cfg.tgq_groups))
        total += t_of_path[paths[allocation[g]]]
    batch = ecfg.serve_b_local * ecfg.serve_n_dev
    return {"req_per_s": batch / total,
            "ms_per_step": total / len(use_ts) * 1e3,
            "path": "+".join(sorted(set(paths.values()))),
            "mean_bits": mean_bits(allocation)}


@dataclasses.dataclass(frozen=True)
class _Bits:
    """Duck-typed stand-in with the two fields ``recipe_path`` reads —
    avoids fabricating a full QuantRecipe per lookup."""
    bits: str
    attn_impl: str
