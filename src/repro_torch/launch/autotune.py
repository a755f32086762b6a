"""Recipe auto-search launcher — a thin CLI over ``repro_torch.autotune``;
port of ``repro/launch/autotune.py``.

Expands a declarative search space (bits x method x TGQ group counts,
plus AdaTSQ-style mixed-precision mean-bit budgets), runs every trial
through ``quantize()`` and the two-stage evaluator, measures the serving
paths' seconds per step on the card (DiT-XL/2 through the kernels, once
per sweep), and emits the quality-vs-throughput Pareto frontier:
``BENCH_autotune.json`` + ``report.md`` + one saved ``QuantArtifact``
per trial under ``--out``.

The sweep is RESUMABLE: trials are keyed by recipe content hash in
``<out>/ledger.jsonl``, and the measurement is a ledger row too, so
re-running the same command after a kill cache-hits every completed
trial and measures nothing (``--assert-resumed`` verifies that: zero
recomputed trials, no measurement, and a frontier identical to the one
already on disk). ``--max-new-stage1 N`` stops the run after N
newly-calibrated trials — the deterministic stand-in for ``kill -9``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.autotune --arch bench \\
      --out DIR --budgets 6 --max-new-stage1 1
  PYTHONPATH=src python -m repro_torch.launch.autotune --arch bench \\
      --out DIR --budgets 6
  PYTHONPATH=src python -m repro_torch.launch.autotune --arch bench \\
      --out DIR --budgets 6 --assert-resumed

``--arch bench`` sweeps the trained 6-layer checkpoint
``experiments/dit_bench_450.pkl`` (``launch/tables.py::BENCH_DIT`` and
``DIF``; a missing one exits with a message); ``--arch tiny`` a 2-layer
DiT under the reference's tiny config, trained once with the reference's
recipe for ``--train-steps`` steps and cached as ``dit_tiny_{N}.pkl``
(a numpy pytree the reference loads) under ``REPRO_EXP_DIR`` or
``experiments/``.
``--device cpu`` runs the plain versions on the CPU and measures the
throughput at the smoke config (``configs/dit_xl_2.py::smoke``): a CPU
time, not the card's.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

TINY_STEPS = 200


def tiny_dit():
    """The reference's tiny config (``repro/launch/autotune.py:40-57``:
    2 layers, d 64, ``DiffusionCfg(T=1000, tgq_groups=10)``)."""
    from repro_torch.diffusion.ddpm import DiffusionCfg
    from repro_torch.models.dit import DiTCfg
    return (DiTCfg(img_size=8, in_ch=4, patch=2, d_model=64, n_layers=2,
                   n_heads=4, n_classes=8),
            DiffusionCfg(T=1000, tgq_groups=10))


def train_tiny(train_steps: int, device):
    """The reference's ``tiny_dit`` recipe: the keyed init from
    ``PRNGKey(0)``, ``quant.eval.make_pipeline``'s latents, AdamW under
    ``cosine_schedule(2e-3, 20, train_steps)`` without weight decay, batch
    32, each step drawn from ``split(key, 4)``. Returns (params, the loss
    of every step as a float32 tensor)."""
    import time

    import torch

    from repro_torch.diffusion import rng
    from repro_torch.diffusion.ddpm import make_schedule
    from repro_torch.launch.steps import make_dit_train_step
    from repro_torch.launch.train import batch_at
    from repro_torch.models.dit import dit_init_from_key
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.quant import eval as qeval

    cfg, dif = tiny_dit()
    key = rng.PRNGKey(0, device=device)
    params = dit_init_from_key(key, cfg, device=device)
    opt = adamw(cosine_schedule(2e-3, 20, train_steps), weight_decay=0.0)
    opt_state = opt.init(params)
    step = make_dit_train_step(cfg, opt, make_schedule(dif, device=device))
    pipe = qeval.make_pipeline(cfg)
    losses = []
    t0 = time.time()
    for i in range(train_steps):
        key, batch = batch_at(pipe, key, 32)     # t in [0, 1000 = dif.T)
        loss, params, opt_state = step(params, opt_state, batch)
        losses.append(loss)
        if i % 100 == 0 or i == train_steps - 1:
            print(f"  [tiny-train] step {i} loss {float(loss):.4f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
    return params, torch.stack(losses)


def load_model(arch: str, train_steps: int, device):
    """(model cfg, DiffusionCfg, params on ``device``) of ``--arch``; the
    tiny DiT is trained and cached on first use."""
    from repro_torch.launch.tables import BENCH_DIT, DIF, ROOT
    from repro_torch.models.dit import map_tree, params_from_numpy
    if arch == "bench":
        path = os.path.join(ROOT, "experiments", "dit_bench_450.pkl")
        if not os.path.exists(path):
            raise SystemExit(f"{path} is missing: the port does not train "
                             "the bench checkpoint")
        model_cfg, dif_cfg = BENCH_DIT, DIF
    else:
        exp = os.environ.get("REPRO_EXP_DIR",
                             os.path.join(ROOT, "experiments"))
        path = os.path.join(exp, f"dit_tiny_{train_steps}.pkl")
        model_cfg, dif_cfg = tiny_dit()
        if not os.path.exists(path):
            params, _ = train_tiny(train_steps, device)
            os.makedirs(exp, exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump(map_tree(lambda t: t.cpu().numpy(), params), f)
            return model_cfg, dif_cfg, params
    with open(path, "rb") as f:
        params = params_from_numpy(pickle.load(f), device=device)
    return model_cfg, dif_cfg, params


def _parse_groups(s: str):
    out = []
    for tok in s.split(","):
        tok = tok.strip()
        out.append(None if tok in ("default", "none", "") else int(tok))
    return tuple(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Recipe auto-search emitting the quality-vs-"
                    "throughput Pareto frontier (resumable).")
    ap.add_argument("--out", required=True,
                    help="sweep directory (ledger + artifacts + report)")
    ap.add_argument("--arch", choices=("bench", "tiny"), default="bench")
    ap.add_argument("--train-steps", type=int, default=TINY_STEPS,
                    help="tiny arch: training steps for the cached model")
    ap.add_argument("--bits", default="w8a8,w6a6,w4a4")
    ap.add_argument("--methods", default="range")
    ap.add_argument("--groups", default="default",
                    help="comma list of TGQ group counts; 'default' "
                         "inherits the DiffusionCfg's")
    ap.add_argument("--budgets", default="",
                    help="comma list of mean-bit budgets for AdaTSQ-style "
                         "mixed trials (empty: uniform only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=12,
                    help="stage-2 sampling steps")
    ap.add_argument("--n-gen", type=int, default=64)
    ap.add_argument("--gen-batch", type=int, default=32)
    ap.add_argument("--n-real", type=int, default=512)
    ap.add_argument("--n-mse", type=int, default=64)
    ap.add_argument("--prune-factor", type=float, default=50.0)
    ap.add_argument("--keep-at-least", type=int, default=2)
    ap.add_argument("--max-new-stage1", type=int, default=None,
                    help="stop after N newly-calibrated trials (the "
                         "deterministic kill for resume testing)")
    ap.add_argument("--assert-endpoints", action="store_true",
                    help="fail unless the frontier is non-empty, shows a "
                         "strict quality/throughput trade-off, its "
                         "fastest point is w4a4 and it contains a w8a8 "
                         "point")
    ap.add_argument("--assert-resumed", action="store_true",
                    help="fail unless this run recomputed and measured "
                         "nothing and reproduced the frontier already on "
                         "disk")
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs the plain versions")
    args = ap.parse_args(argv)

    from repro_torch.autotune import EvalConfig, SearchSpace, expand, \
        load_trial_artifact, run_autotune
    from repro_torch.configs import dit_xl_2
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    model_cfg, dif_cfg, params = load_model(args.arch, args.train_steps, dev)

    space = SearchSpace(
        bits=tuple(b.strip() for b in args.bits.split(",") if b.strip()),
        methods=tuple(m.strip() for m in args.methods.split(",")
                      if m.strip()),
        tgq_groups=_parse_groups(args.groups),
        bit_budgets=tuple(float(b) for b in args.budgets.split(",")
                          if b.strip()),
        seed=args.seed)
    ecfg = EvalConfig(
        steps=args.steps, n_gen=args.n_gen, gen_batch=args.gen_batch,
        n_real=args.n_real, n_mse=args.n_mse,
        prune_factor=args.prune_factor, keep_at_least=args.keep_at_least)
    measure_kw = {} if dev.type == "cuda" else {
        "serve_cfg": dit_xl_2.smoke()}

    trials = expand(space)
    print(f"[autotune] {len(trials)} trials -> {args.out}", flush=True)

    bench_path = os.path.join(args.out, "BENCH_autotune.json")
    prior_frontier = None
    if args.assert_resumed and os.path.exists(bench_path):
        with open(bench_path) as f:
            prior_frontier = json.load(f)["frontier"]

    result = run_autotune(params, model_cfg, dif_cfg, space, ecfg,
                          args.out, max_new_stage1=args.max_new_stage1,
                          device=dev, measure_kw=measure_kw)
    if result.stopped_early:
        print(f"[autotune] stopped early: {result.recomputed} new trials "
              f"calibrated, ledger at {args.out}/ledger.jsonl resumes "
              "them", flush=True)
        return

    print(f"[autotune] done: {len(result.records)} trials "
          f"({result.pruned} pruned, {result.cache_hits} cache hits, "
          f"{result.recomputed} newly calibrated)", flush=True)
    tput = result.throughput
    print(f"[autotune] throughput {tput['source']}"
          + (" this run" if result.measured else ", replayed from the ledger")
          + (f" on {tput['card']}" if "card" in tput else "") + ": "
          + ", ".join(f"{p} {s * 1e3:.3f} ms/step"
                      for p, s in sorted(tput["step_s"].items())),
          flush=True)
    for p in result.frontier:
        print(f"  frontier: {p['label']:<14} req/s={p['req_per_s']:9.2f} "
              f"FD={p['FD']:8.3f} -> {p['artifact']}", flush=True)

    def fail(msg: str) -> None:
        print(f"[autotune] ASSERTION FAILED: {msg}", file=sys.stderr,
              flush=True)
        raise SystemExit(1)

    # every frontier artifact must actually load (acceptance: the frontier
    # is a set of DEPLOYABLE artifacts, not just scores)
    by_key = {r["key"]: r for r in result.records}
    for p in result.frontier:
        art = load_trial_artifact(args.out, by_key[p["key"]], device=dev)
        if art is None:
            fail(f"frontier artifact {p['artifact']} failed to load")

    if args.assert_endpoints:
        if not result.frontier:
            fail("empty frontier")
        if not result.strict_tradeoff:
            fail("frontier is not a strict quality-vs-throughput "
                 "trade-off")
        fastest = result.frontier[0]
        if fastest.get("bits") != "w4a4":
            fail(f"fastest frontier point is {fastest['label']}, "
                 "expected a w4a4 recipe")
        if not any(p.get("bits") == "w8a8" for p in result.frontier):
            fail("no w8a8 (max-quality) point on the frontier")
        print("[autotune] endpoint asserts passed", flush=True)

    if args.assert_resumed:
        if result.recomputed != 0:
            fail(f"resume recomputed {result.recomputed} trials")
        if result.cache_hits != len(trials):
            fail(f"resume cache-hit {result.cache_hits}/{len(trials)} "
                 "trials")
        if result.measured:
            fail("resume measured the throughput again")
        if prior_frontier is not None and prior_frontier != result.frontier:
            fail("resumed frontier differs from the one on disk")
        print("[autotune] resume asserts passed "
              f"({result.cache_hits} cache hits, 0 recomputed)",
              flush=True)


if __name__ == "__main__":
    main()
