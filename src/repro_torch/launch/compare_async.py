"""Sync against async serving on the card, interleaved, with the host's
time split by phase.

    PYTHONPATH=src python -m repro_torch.launch.compare_async \
        [--quantize w8a8 w6a6 w4a4] [--rounds 3] [--smoke --device cpu]

Per width, builds the full-width DiT-XL/2 serve of ``launch/serve.py``
(range calibration), warms each engine up on four requests, then for
``--rounds`` rounds serves ``chip_smoke.py``'s async mix (12 requests
alternating 10 and 20 steps, CFG 1.5, 4 slots, buckets (10, 20), chunk 4)
through ``ServeEngine``, ``AsyncServeEngine(pipeline=2)`` and
``AsyncServeEngine(pipeline=1)``, the order rotated each round so a drift
in the host's load spreads over all three. Each run prints its ms/step
(wall over forwards) and req/s, and where the host's wall time went:

- sync: ``enqueue`` (the sampler issuing every step of a microbatch) and
  ``wait`` (the samples' copy to the host, which waits for the card);
- async: ``admit`` (new slots: their latents and state), ``enqueue`` (the
  chunks' steps), ``wait`` (for each chunk's (B,) positions and flags)
  and ``boundary`` (the rest of a pump: finished samples to the host and
  the slots' bookkeeping).

Every async sample must equal the sync engine's of the same round, bit
for bit. ``--smoke --device cpu`` runs the tiny config on the CPU (plain
versions), to try the script.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import time

N_REQ, CHUNK, MICROBATCH, BUCKETS = 12, 4, 4, (10, 20)


def _timed(fn, acc, key):
    def run(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            acc[key] += time.perf_counter() - t0
    return run


@contextlib.contextmanager
def _timed_sampler(acc):
    """Time the sync engine's sampler calls (its enqueue of every step)."""
    from repro_torch.serving import engine as eng_mod
    real = eng_mod.ddpm_sample_paired
    eng_mod.ddpm_sample_paired = _timed(real, acc, "enqueue")
    try:
        yield
    finally:
        eng_mod.ddpm_sample_paired = real


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_sync(engine, reqs):
    acc = collections.Counter()
    _sync(engine.device)
    t0 = time.perf_counter()
    with _timed_sampler(acc):
        out = engine.serve(reqs)
    _sync(engine.device)
    wall = time.perf_counter() - t0
    acc["wait"] = wall - acc["enqueue"]
    return out, wall, acc


def serve_async(engine, reqs):
    """Serve through ``engine`` with its pump's phases timed."""
    acc = collections.Counter()
    launch = engine._launch_chunk

    def launch_timed(x, pos):
        t0 = time.perf_counter()
        x, pos, bad, wait = launch(x, pos)
        acc["enqueue"] += time.perf_counter() - t0
        return x, pos, bad, _timed(wait, acc, "wait")
    engine._launch_chunk = launch_timed
    engine._admit = _timed(engine._admit, acc, "admit")
    engine.pump = _timed(engine.pump, acc, "pump")
    _sync(engine.device)
    t0 = time.perf_counter()
    out = engine.serve(reqs)
    _sync(engine.device)
    wall = time.perf_counter() - t0
    acc["boundary"] = acc.pop("pump") - acc["admit"] - acc["enqueue"] \
        - acc["wait"]
    return out, wall, acc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quantize", nargs="+",
                    default=["w8a8", "w6a6", "w4a4"],
                    choices=("w8a8", "w6a6", "w4a4"))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import build
    from repro_torch.serving.batching import GenRequest, coalesce
    from repro_torch.serving.engine import AsyncServeEngine, ServeEngine

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"card: {torch.cuda.get_device_name(dev)}")
    for bits in args.quantize:
        cfg, params, art, _, _, _ = build(
            "dit-xl-2", args.smoke, bits, 0, 1, MICROBATCH, BUCKETS[0], 1.5,
            device=dev)
        gen = torch.Generator().manual_seed(11)      # chip_smoke's requests
        labels = torch.randint(0, cfg.n_classes, (N_REQ,), generator=gen)
        reqs = [GenRequest(request_id=i, label=int(labels[i]),
                           steps=BUCKETS[i % 2], cfg_scale=1.5, seed=500 + i)
                for i in range(N_REQ)]
        sync_forwards = sum(mb.steps for mb in coalesce(reqs, MICROBATCH,
                                                        BUCKETS))
        kw = dict(ctx=art.context(), microbatch=MICROBATCH,
                  step_buckets=BUCKETS, device=dev)
        same = (params, cfg, art.dif_cfg())
        make = {"sync": lambda: ServeEngine(*same, **kw),
                "async p2": lambda: AsyncServeEngine(*same, chunk=CHUNK,
                                                     pipeline=2, **kw),
                "async p1": lambda: AsyncServeEngine(*same, chunk=CHUNK,
                                                     pipeline=1, **kw)}
        for name, mk in make.items():                    # warm-up
            mk().serve(reqs[:4])
        names = list(make)
        for r in range(args.rounds):
            order = names[r % 3:] + names[:r % 3]
            lines = {}
            for name in order:
                eng = make[name]()
                if name == "sync":
                    out, wall, acc = serve_sync(eng, reqs)
                    f = sync_forwards
                else:
                    out, wall, acc = serve_async(eng, reqs)
                    f = eng.stats["forwards"]
                lines[name] = (out, wall, acc, f, eng.stats)
            ref = lines["sync"][0]
            for name in names:
                out, wall, acc, f, st = lines[name]
                if name != "sync":
                    bad = [rid for rid, o in out.items() if o.status != "OK"
                           or not np.array_equal(o.sample, ref[rid].sample)]
                    if bad or st["degradations"]:
                        raise SystemExit(f"{bits} {name}: requests {bad} "
                                         "differ from the sync engine's; "
                                         f"degradations {st['degradations']}")
                phases = ", ".join(f"{k} {1e3 * v / f:.3f}"
                                   for k, v in sorted(acc.items()))
                extra = ("" if name == "sync" else
                         f"; {st['dispatches']} dispatches, {st['ahead']} "
                         "ahead")
                print(f"{bits} round {r} (order {'/'.join(order)}) {name}: "
                      f"{1e3 * wall / f:.3f} ms/step over {f} forwards, "
                      f"{N_REQ / wall:.4f} req/s; host ms per forward: "
                      f"{phases}{extra}")
        del params, art
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
