"""Where a serving step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_step \
        [--quantize w8a8|w6a6|w4a4] [--steps 4]

Builds the full-width DiT-XL/2 serve of ``launch/serve.py`` (range
calibration, microbatch 4 -> CFG 2B = 8 rows per forward), runs one
warm-up microbatch, then traces a second one with ``torch.profiler`` and
prints, per denoising step: the wall time, the device time summed over
the CUDA kernels, the idle share (1 - device / wall), and the kernels by
device time — the port's own (``quantize_kernel``, ``gemm_kernel``,
``gemm4_kernel``, ``codes_kernel``, ``flash_kernel``) and the PyTorch glue
around them.
"""
from __future__ import annotations

import argparse
import collections
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--quantize", default="w8a8",
                    choices=("w8a8", "w6a6", "w4a4"))
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import build
    from repro_torch.serving.batching import coalesce

    cfg, _, art, engine, sq, _ = build(
        "dit-xl-2", False, args.quantize, 0, 4, 4, args.steps, 1.5,
        device="cuda")
    mb = coalesce(sq.pending, 4, (args.steps,))[0]
    engine.run_microbatch(mb)                   # warm-up: builds, caches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run_microbatch(mb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = collections.Counter()
    calls = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            calls[e.name] += 1
    dev_us = sum(by_name.values())
    n = args.steps
    smi = torch.cuda.get_device_name(0)
    print(f"card: {smi}; {args.quantize}, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, 2B = 8 rows per forward, {n} steps traced")
    print(f"per step: wall {wall / n * 1e3:.3f} ms, device "
          f"{dev_us / n / 1e3:.3f} ms, idle share "
          f"{1 - dev_us / 1e6 / wall:.3f}" if dev_us else
          "per step: device time not visible to the profiler (not measured)")
    for name, us in by_name.most_common(args.top):
        print(f"  {us / n / 1e3:9.3f} ms/step {100 * us / dev_us:5.1f}% "
              f"{calls[name] // n:5d} calls/step  {name[:90]}")


if __name__ == "__main__":
    main()
