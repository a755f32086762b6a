"""Where a serving step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_step \
        [--quantize w8a8|w6a6|w4a4] [--steps 4] [--async] \
        [--attn-impl flash|composed]

Builds the full-width DiT-XL/2 serve of ``launch/serve.py`` (range
calibration, microbatch 4 -> CFG 2B = 8 rows per forward), runs one
warm-up microbatch, then traces a second one with ``torch.profiler`` and
prints, per denoising step: the wall time, the device time summed over
the CUDA kernels, the idle share (1 - device / wall), and the kernels by
device time — the port's own (``prologue_rows_kernel`` and
``prologue_chunks_kernel``, ``gemm_kernel``, ``gemm4_kernel``,
``flash_kernel``; under
``--attn-impl composed`` ``qk_kernel``, ``softmax_codes_kernel`` and
``pv_kernel`` in its place) and the PyTorch glue
around them — and the host side: the ops by self CPU time (the torch
operators and the CUDA runtime calls the host makes for them), with
their calls per step. ``--async`` traces one chunk of ``--steps`` steps
of the continuous-batching engine instead (``AsyncServeEngine``, 4
slots, after one warm-up chunk): the same forward through the
per-row-group kernels. ``--ops-json PATH`` writes every host op and
kernel as ``{"host"|"device": {name: [calls/step, ms/step]}}``.

The GEMMs (``gemm_kernel``, one kernel for every int8 linear, and
``gemm4_kernel`` for every packed-int4 one) are split by op: the traced
run records each linear launch's (M, K, N) in order, and each GEMM kernel
event, in start order, takes the op of its launch (qkv, proj, fc1, fc2,
ada; the others under "rest").

The profiler can drop kernel events on the H100 (one in 90, or every
event of a trace). Every counted launch (``kernels.LAUNCHES``) makes at least
one event of the port's own kernels, and every recorded GEMM launch one
GEMM event, so a trace with fewer is profiled again (another step, or
chunk), up to ``gemm_times.PROFILE_TRIES`` traces, and then this raises:
a step's device time never silently misses a kernel.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time

# the port's own kernels (``csrc/``): each counted launch makes at least
# one event of these
PORT_KERNELS = ("gemm_kernel", "gemm4_kernel", "flash_kernel",
                "prologue_rows_kernel", "prologue_chunks_kernel",
                "qk_kernel", "softmax_codes_kernel", "pv_kernel",
                "act_mrq_kernel")


def op_of(M: int, K: int, N: int, cfg) -> str:
    """The DiT op of a linear launch of shape (M, K, N)."""
    d, f, tokens = cfg.d_model, cfg.d_ff, M % cfg.n_tokens == 0
    return {(True, d, 3 * d): "qkv", (True, d, d): "proj",
            (True, d, f): "fc1", (True, f, d): "fc2",
            (False, d, 6 * d): "ada"}.get((tokens, K, N), "rest")


def lost_events(names, launched: int, shapes) -> "str | None":
    """Why a trace's kernel events (``names``) must have lost some, or
    None: fewer events of the port's own kernels than ``launched`` counted
    launches, or a GEMM family (``shapes``: its recorded launch shapes by
    event-name key) with another number of events than launches."""
    from repro_torch.launch.gemm_times import kernel_name
    ours = sum(kernel_name(n).split("<")[0] in PORT_KERNELS for n in names)
    short = [k for k, v in shapes.items()
             if len(v) != sum(k in n for n in names)]
    if ours >= launched and not short:
        return None
    return (f"the profiler recorded {ours} events of the port's kernels for "
            f"{launched} launches (GEMM families short: {short})")


def gemm_by_op(events, shapes, cfg):
    """{op: [calls, us]} of the GEMM kernel events (start order) paired
    with the recorded launch shapes, or None if their counts differ."""
    events = sorted(events, key=lambda e: e[0])
    if len(events) != len(shapes):
        return None
    out = collections.OrderedDict(
        (k, [0, 0.0]) for k in ("qkv", "proj", "fc1", "fc2", "ada", "rest"))
    for (_, us), shape in zip(events, shapes):
        row = out[op_of(*shape, cfg)]
        row[0] += 1
        row[1] += us
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--quantize", default="w8a8",
                    choices=("w8a8", "w6a6", "w4a4"))
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="trace one chunk of the async engine")
    ap.add_argument("--ops-json", default=None, metavar="PATH")
    ap.add_argument("--attn-impl", default=None,
                    choices=("flash", "composed"),
                    help="attention lowering (unset keeps the recipe's "
                         "default, flash)")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.launch.gemm_times import PROFILE_TRIES
    from repro_torch.launch.serve import build, fail_on_degradation
    from repro_torch.serving.batching import coalesce

    if args.async_mode:        # a chain long enough for every trace's chunk
        cfg, _, art, engine, sq, _ = build(
            "dit-xl-2", False, args.quantize, 0, 4, 4,
            (PROFILE_TRIES + 2) * args.steps, 1.5,
            device="cuda", async_kw=dict(chunk=args.steps, pipeline=1),
            attn_impl=args.attn_impl)
        for r in sq.pending:
            engine.submit_request(r)
        run = engine.pump
    else:
        cfg, _, art, engine, sq, _ = build(
            "dit-xl-2", False, args.quantize, 0, 4, 4, args.steps, 1.5,
            device="cuda", attn_impl=args.attn_impl)
        mb = coalesce(sq.pending, 4, (args.steps,))[0]
        run = lambda: engine.run_microbatch(mb)
    run()                                       # warm-up: builds, caches
    torch.cuda.synchronize()
    from repro_torch.kernels import int4_packed, int8_fused
    # each GEMM launch's shape, by kernel: gemm_kernel (int8), gemm4_kernel
    families = {"gemm_kernel<": int8_fused, "gemm4_kernel<": int4_packed}
    shapes = {k: [] for k in families}
    launches = {k: m._launch for k, m in families.items()}

    def recorder(key):
        def recorded(mrq, x, w, *a, **k):
            shapes[key].append((x.shape[0], x.shape[1], w.shape[1]))
            return launches[key](mrq, x, w, *a, **k)
        return recorded
    for key, mod in families.items():
        mod._launch = recorder(key)
    try:
        for _ in range(PROFILE_TRIES):
            for v in shapes.values():
                v.clear()
            before = sum(kernels.LAUNCHES.values())
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launched = sum(kernels.LAUNCHES.values()) - before
            events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            lost = lost_events([e.name for e in events], launched, shapes)
            if lost is None:
                break
            print(f"{lost}; profiling again", file=sys.stderr, flush=True)
        else:
            raise RuntimeError(f"the profiler lost kernel events in "
                               f"{PROFILE_TRIES} traced steps")
    finally:
        for key, mod in families.items():
            mod._launch = launches[key]
    if args.async_mode:
        fail_on_degradation(engine)
    by_name = collections.Counter()
    calls = collections.Counter()
    gemm = {k: [] for k in families}
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us()
        calls[e.name] += 1
        for key in families:
            if key in e.name:
                gemm[key].append((e.time_range.start,
                                  e.time_range.elapsed_us()))
    dev_us = sum(by_name.values())
    n = args.steps
    smi = torch.cuda.get_device_name(0)
    print(f"card: {smi}; {args.quantize} {art.recipe.attn_impl}"
          f"{' async chunk' if args.async_mode else ''}, {cfg.n_layers} "
          f"layers, d {cfg.d_model}, 2B = 8 rows per forward, {n} steps "
          "traced")
    print(f"per step: wall {wall / n * 1e3:.3f} ms, device "
          f"{dev_us / n / 1e3:.3f} ms, idle share "
          f"{1 - dev_us / 1e6 / wall:.3f}" if dev_us else
          "per step: device time not visible to the profiler (not measured)")
    for name, us in by_name.most_common(args.top):
        print(f"  {us / n / 1e3:9.3f} ms/step {100 * us / dev_us:5.1f}% "
              f"{calls[name] // n:5d} calls/step  {name[:90]}")
    for key in families:
        if not shapes[key]:
            continue
        split = gemm_by_op(gemm[key], shapes[key], cfg)
        if split is None:
            print(f"  {key[:-1]} by op: {len(gemm[key])} kernel events for "
                  f"{len(shapes[key])} launches, not split")
        else:
            print(f"  {key[:-1]} by op: " + "; ".join(
                f"{op} {us / n / 1e3:.3f} ms/step ({c // n} calls, "
                f"{us / c:.2f} us each)" for op, (c, us) in split.items()
                if c))
    host, hcalls = collections.Counter(), collections.Counter()
    for ka in prof.key_averages():
        if ka.device_type == torch.autograd.DeviceType.CPU:
            host[ka.key] += ka.self_cpu_time_total
            hcalls[ka.key] += ka.count
    print(f"host per step: {sum(hcalls.values()) / n:.1f} ops, self CPU "
          f"{sum(host.values()) / n / 1e3:.3f} ms; cudaLaunchKernel "
          f"{hcalls['cudaLaunchKernel'] / n:.1f} calls")
    for name, us in host.most_common(args.top):
        print(f"  {us / n / 1e3:9.3f} ms/step host {hcalls[name] / n:8.2f} "
              f"calls/step  {name[:80]}")
    if args.ops_json:
        per = lambda c, t: {k: [c[k] / n, t[k] / n / 1e3] for k in t}
        with open(args.ops_json, "w") as f:
            json.dump({"host": per(hcalls, host),
                       "device": per(calls, by_name)}, f, indent=1)


if __name__ == "__main__":
    main()
