"""Serving launcher for the port — the DiT branch of ``repro/launch/serve.py``.

A request stream is coalesced into fixed-shape microbatches (step
bucketed, padded, CFG-paired) and served by ``ServeEngine`` on one GPU.
``--quantize w8a8|w6a6|w4a4`` calibrates on the card — ``--calib range``
(min/max ranges, seconds) or ``--calib ho`` (the paper's Hessian-guided
search, ``n_alpha=8, rounds=2``) — and serves through the CUDA kernels
(w8a8 and w6a6: fused int8 linears and flash MRQ attention; w4a4:
packed-int4 linears and packed-kv flash). ``--attn-impl composed``
records the composed three-kernel attention chain in the recipe instead
(B9a -> B10a -> B9b; unset keeps the recipe's default, flash).

``--save-artifact DIR`` saves the calibrated ``QuantArtifact`` (needs
``--quantize``); ``--load-artifact DIR`` cold-starts from one: no
calibration runs, the artifact's own ``DiffusionCfg`` is served, and a
``--quantize`` width other than the artifact's exits with a message. The
served samples equal the calibrating process's bit for bit.

  python -m repro_torch.launch.serve --arch dit-xl-2 --quantize w8a8 \\
      --calib ho --save-artifact /ckpts/dit_w8a8 --requests 8 --steps 20
  python -m repro_torch.launch.serve --arch dit-xl-2 --quantize w8a8 \\
      --load-artifact /ckpts/dit_w8a8 --requests 8 --steps 20

``--async`` serves the same requests through ``AsyncServeEngine``'s
continuous-batching slot pool (``--chunk`` steps per dispatch, the
per-row-group kernels B6a/B6b/B7a/B7b/B8 under a quantized context;
``--deadline-ms``, ``--max-retries``); its samples equal the sync
engine's bit for bit, and a serve that took a rung of the degradation
ladder exits non-zero.

The dense LMs (``qwen3-1.7b``, ``qwen2.5-3b``, ``qwen2.5-14b``,
``stablelm-3b``, ``chameleon-34b``) take the reference's batched-decode
path: ``lm_init(PRNGKey(seed))``, ``--batch`` prompts of ``--prompt_len``
tokens drawn with ``randint`` from the same key, greedy ``lm_generate`` of
``--gen`` tokens in full precision; it prints the reference's two lines.
LM PTQ runs through the API (``core.ptq.run_ptq``, then
``kernels.ops.convert_for_kernels`` and ``QuantContext(kernel=True)``, as
``examples/lm_ptq.py`` drives it), so an LM takes no ``--quantize``,
``--save-artifact``, ``--load-artifact``, ``--dump-samples`` or
``--async``. The other families exit naming their ROADMAP item.

  python -m repro_torch.launch.serve --arch qwen3-1.7b --batch 4 \\
      --prompt_len 32 --gen 16

``--smoke`` uses the tiny config; ``--device cpu`` runs the plain
versions on the CPU. ``--dp`` waits for a later slice.
"""
from __future__ import annotations

import argparse
import time
import warnings


def fake_quant_fallback_warning(artifact):
    """The warning for an artifact whose quantized ops do not all lower
    onto the kernels, or None when every one does."""
    if not artifact.has_kernel_packs:
        return (f"artifact {artifact.recipe.bits}/{artifact.recipe.method} "
                "carries no kernel packs: serving falls back to FAKE-QUANT")
    fb = artifact.fallback_ops()
    if not fb:
        return None
    shown = ", ".join(fb[:8]) + (", ..." if len(fb) > 8 else "")
    return (f"artifact {artifact.recipe.bits}/{artifact.recipe.method}: "
            f"{len(fb)} quantized op(s) carry no kernel pack and fall back "
            f"to FAKE-QUANT: {shown}")


def build(arch: str, smoke: bool, quantize: str, seed: int, requests: int,
          microbatch: int, steps: int, cfg_scale: float, device=None,
          async_kw=None, attn_impl=None, calib: str = "range",
          save_artifact=None, load_artifact=None):
    """Model, artifact (or None), engine and scheduler for one serve —
    the launcher's whole set-up, shared with ``chip_smoke.py``. With
    ``async_kw`` (``chunk``, ``max_retries``, ``deadline_s``, ...) the
    engine is an ``AsyncServeEngine``; the scheduler's queue then holds
    the requests to submit to it. ``attn_impl`` ('flash' or 'composed';
    None keeps the recipe's default) goes into the calibration recipe,
    whose context the engine serves (or overrides a loaded artifact's).
    ``calib`` picks the method ('range' or 'ho'); ``save_artifact`` saves
    the calibrated artifact there; ``load_artifact`` serves a saved one
    instead of calibrating. ``info`` holds ``calib_s`` / ``save_s`` or
    ``load_s``, wall seconds."""
    import torch

    from repro_torch.configs import dit_xl_2
    from repro_torch.device import resolve_device
    from repro_torch.diffusion.ddpm import DiffusionCfg, make_schedule
    from repro_torch.models.dit import dit_init
    from repro_torch.serving.engine import AsyncServeEngine, ServeEngine
    from repro_torch.serving.scheduler import RequestScheduler

    if arch != "dit-xl-2":
        raise SystemExit(f"--arch {arch}: build() sets up the DiT serve; "
                         "the dense LMs take main()'s LM branch")
    if save_artifact is not None and (quantize == "none"
                                      or load_artifact is not None):
        raise ValueError("save_artifact needs quantize and excludes "
                         "load_artifact: there is no freshly calibrated "
                         "artifact to save otherwise")
    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" \
        else (lambda: None)
    cfg = dit_xl_2.smoke() if smoke else dit_xl_2.full()
    params = perturb_init(dit_init(seed, cfg, device=dev), seed)
    dif = DiffusionCfg(T=1000)
    sched = make_schedule(dif)
    artifact, ctx = None, None
    info = {}
    if load_artifact is not None:
        from repro_torch.quant.artifact import QuantArtifact
        t0 = time.perf_counter()
        artifact = QuantArtifact.load(load_artifact, device=dev)
        sync()
        info["load_s"] = time.perf_counter() - t0
        if quantize != "none" and artifact.recipe.bits != quantize:
            raise SystemExit(
                f"--quantize {quantize} but the artifact at {load_artifact} "
                f"was calibrated at {artifact.recipe.bits} "
                f"({artifact.summary()})")
        artifact.check_params(params)
        # the artifact's own DiffusionCfg is served, not the CLI's chain
        dif = artifact.dif_cfg()
        sched = make_schedule(dif)
    elif quantize != "none":
        from repro_torch.quant.api import quantize as run_quantize
        from repro_torch.quant.recipe import QuantRecipe
        kw = {"n_alpha": 8, "rounds": 2} if calib == "ho" else {}
        if attn_impl is not None:
            kw["attn_impl"] = attn_impl
        t0 = time.perf_counter()
        artifact = run_quantize(params, cfg, dif,
                                QuantRecipe(bits=quantize, method=calib,
                                            seed=seed, **kw),
                                sched=sched,
                                provenance={"arch": arch, "smoke": smoke})
        sync()
        info["calib_s"] = time.perf_counter() - t0
        if save_artifact is not None:
            t0 = time.perf_counter()
            artifact.save(save_artifact)
            info["save_s"] = time.perf_counter() - t0
    if artifact is not None:
        msg = fake_quant_fallback_warning(artifact)
        if msg is not None:
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        ctx = artifact.context(attn_impl=attn_impl)
    if async_kw is not None:
        engine = AsyncServeEngine(params, cfg, dif, sched, ctx=ctx,
                                  microbatch=microbatch,
                                  step_buckets=(steps,), device=dev,
                                  **async_kw)
    else:
        engine = ServeEngine(params, cfg, dif, sched, ctx=ctx,
                             microbatch=microbatch, step_buckets=(steps,),
                             device=dev)
    gen = torch.Generator().manual_seed(seed + 1)
    labels = torch.randint(0, cfg.n_classes, (requests,), generator=gen)
    sq = RequestScheduler(microbatch=microbatch, step_buckets=(steps,),
                          n_classes=cfg.n_classes)
    for i in range(requests):
        sq.submit(int(labels[i]), steps=steps, cfg_scale=cfg_scale,
                  seed=seed * 100_000 + i)
    return cfg, params, artifact, engine, sq, info


def perturb_init(params, seed: int):
    """adaLN-Zero initialises every gate to 0, so an initialised DiT
    predicts a constant and no block reaches the sample. Perturb it as the
    tests' tiny DiT is: blocks += 0.01 N(0,1), final.w = 0.02 N(0,1)."""
    import torch

    from repro_torch.models.dit import map_tree
    w = params["final"]["w"]
    gen = torch.Generator(device=w.device).manual_seed(int(seed) + 9)
    noise = lambda a: torch.randn(a.shape, generator=gen, device=a.device)
    params = dict(params)
    params["final"] = {"w": (noise(w) * 0.02).to(w.dtype),
                       "b": params["final"]["b"]}
    params["blocks"] = map_tree(
        lambda a: (a.float() + noise(a) * 0.01).to(a.dtype),
        params["blocks"])
    return params


def serve_lm(args) -> None:
    """The reference launcher's LM branch: greedy generation in full
    precision from the keyed init, timed on the device."""
    import numpy as np
    import torch

    from repro_torch.configs import get, get_smoke
    from repro_torch.device import resolve_device
    from repro_torch.diffusion import rng
    from repro_torch.models.lm import lm_generate, lm_init

    if args.save_artifact or args.load_artifact or args.dump_samples:
        raise SystemExit(
            f"--save-artifact/--load-artifact/--dump-samples are DiT-only "
            f"({args.arch} takes the LM decode path, which has no artifact "
            "support); drive LM PTQ via repro_torch.core.ptq.run_ptq")
    if args.quantize != "none" or args.async_mode:
        raise SystemExit(
            f"--quantize/--async are DiT-only: {args.arch} is served in "
            "full precision here; drive LM PTQ via repro_torch.core.ptq."
            "run_ptq and kernels.ops.convert_for_kernels")
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    dev = resolve_device(args.device)
    key = rng.PRNGKey(args.seed, device=dev)
    try:
        params = lm_init(key, cfg, device=dev)
    except NotImplementedError as e:      # a family the port waits on
        raise SystemExit(f"--arch {args.arch}: {e}") from None
    prompts = rng.randint(key, (args.batch, args.prompt_len), 0, cfg.vocab)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    toks = lm_generate(params, cfg, prompts, args.gen,
                       max_len=args.prompt_len + args.gen)
    sync()
    dt = time.perf_counter() - t0
    print(f"generated {args.batch}x{args.gen} tokens in {dt:.2f}s "
          f"({dt / args.gen * 1000:.0f} ms/token batched)")
    print("sample:", np.asarray(toks[0].cpu())[:16])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4, help="LM decode batch")
    ap.add_argument("--prompt_len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--cfg-scale", type=float, default=1.0)
    ap.add_argument("--quantize", default="none",
                    choices=("none", "w8a8", "w6a6", "w4a4"))
    ap.add_argument("--calib", default="range", choices=("range", "ho"),
                    help="calibration: range (min/max, seconds) or ho (the "
                         "paper's Hessian-guided search)")
    ap.add_argument("--save-artifact", default=None, metavar="DIR",
                    help="after calibrating, save the QuantArtifact so later "
                         "processes cold-start with --load-artifact")
    ap.add_argument("--load-artifact", default=None, metavar="DIR",
                    help="serve a saved QuantArtifact: no calibration runs; "
                         "with --quantize the artifact's bits must match")
    ap.add_argument("--attn-impl", default=None,
                    choices=("flash", "composed"),
                    help="attention lowering: 'flash' = one fused CUDA "
                         "kernel (default; no (S,S) HBM round-trip), "
                         "'composed' = the three-kernel exactness oracle. "
                         "Unset keeps the recipe/artifact default")
    ap.add_argument("--dump-samples", default=None, metavar="NPY")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "versions)")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="serve through the continuous-batching slot pool "
                         "(AsyncServeEngine: chunked dispatches, NaN "
                         "quarantine, deadlines); samples equal the sync "
                         "path's bit for bit")
    ap.add_argument("--chunk", type=int, default=4,
                    help="async: denoising steps per dispatch (the "
                         "admission and cancellation granularity)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="async: per-request deadline; a request not done "
                         "by a chunk boundary past it is CANCELLED")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="async: NaN-quarantine retries per request before "
                         "a structured FAILED outcome")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.save_artifact is not None and (args.quantize == "none"
                                           or args.load_artifact is not None):
        ap.error("--save-artifact requires --quantize (and excludes "
                 "--load-artifact): there is no freshly calibrated "
                 "artifact to save otherwise")

    if args.arch != "dit-xl-2":
        serve_lm(args)
        return

    import numpy as np

    from repro_torch.quant import api

    async_kw = None
    if args.async_mode:
        async_kw = dict(chunk=args.chunk, max_retries=args.max_retries,
                        deadline_s=(None if args.deadline_ms is None
                                    else args.deadline_ms / 1e3))
    cfg, _, artifact, engine, sq, info = build(
        args.arch, args.smoke, args.quantize, args.seed, args.requests,
        args.microbatch, args.steps, args.cfg_scale, device=args.device,
        async_kw=async_kw, attn_impl=args.attn_impl, calib=args.calib,
        save_artifact=args.save_artifact, load_artifact=args.load_artifact)
    if args.load_artifact is not None:
        print(f"loaded {artifact.summary()} in {info['load_s']:.2f}s; "
              f"calibrations run: {api.CALIBRATIONS}; attention "
              f"{engine.ctx.attn_impl}")
    elif artifact is not None:
        print(f"{args.calib}-calibrated {artifact.summary()} in "
              f"{info['calib_s']:.1f}s; attention "
              f"{artifact.recipe.attn_impl}")
        if args.save_artifact is not None:
            print(f"saved artifact -> {args.save_artifact} in "
                  f"{info['save_s']:.2f}s")
    if args.async_mode:
        _serve_async(engine, sq, args)
        return
    t0 = time.perf_counter()
    results = sq.run(engine)
    dt = time.perf_counter() - t0
    samples = np.stack([results[r].sample for r in sorted(results)])
    if args.dump_samples is not None:
        np.save(args.dump_samples, samples)
        print(f"dumped {samples.shape} samples -> {args.dump_samples}")
    st = engine.stats
    print(f"served {len(results)} requests x {args.steps} steps on "
          f"{engine.device} in {dt:.2f}s ({len(results) / dt:.2f} req/s, "
          f"{dt / (st['microbatches'] * args.steps) * 1000:.1f} ms/step); "
          f"{st['microbatches']} microbatches, {st['padded_slots']} padded "
          "slots")
    print(f"sample mean={samples.mean():.4f} std={samples.std():.4f}")


def _serve_async(engine, sq, args) -> None:
    """Submit the scheduler's queued requests to the async engine, drain
    it, and print the reference launcher's async summary lines."""
    import numpy as np

    t0 = time.perf_counter()
    for r in sq.pending:
        engine.submit_request(r)
    outcomes = engine.run_until_drained()
    dt = time.perf_counter() - t0
    ok = {r: o for r, o in outcomes.items() if o.status == "OK"}
    samples = np.stack([ok[r].sample for r in sorted(ok)])
    if args.dump_samples is not None:
        np.save(args.dump_samples, samples)
        print(f"dumped {samples.shape} samples -> {args.dump_samples}")
    st, m = engine.stats, engine.metrics()
    print(f"async-served {len(outcomes)} requests x {args.steps} steps "
          f"(chunk={args.chunk}) on {engine.device} in {dt:.2f}s: "
          f"{m['by_status']}, goodput {m['goodput_rps']:.2f} ok/s, "
          f"latency p50/p99 {m['latency_p50_s']:.2f}/"
          f"{m['latency_p99_s']:.2f}s, queue-wait p50 "
          f"{m['queue_wait_p50_s']:.2f}s")
    print(f"{st['dispatches']} dispatches, {st['chunk_traces']} chunk "
          f"trace(s), {st['retries']} retries, "
          f"{len(st['degradations'])} degradations")
    print(f"sample mean={samples.mean():.4f} std={samples.std():.4f}")
    fail_on_degradation(engine)


def fail_on_degradation(engine) -> None:
    """Exit non-zero when the async engine stepped down its ladder: a
    serve that left its context did not serve what was asked."""
    deg = engine.stats["degradations"]
    if deg:
        raise SystemExit(f"{len(deg)} degradation(s) on {engine.device}: "
                         + "; ".join(f"{d['reason']} ({d['error']})"
                                     for d in deg))


if __name__ == "__main__":
    main()
