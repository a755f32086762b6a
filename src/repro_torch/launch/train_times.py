"""Where a full-width DiT-XL/2 training step spends its time on the card.

    python src/repro_torch/launch/train_times.py

Builds DiT-XL/2 (``configs/dit_xl_2.py::full`` with remat: bf16, the
reference's keyed init from seed 0) with ``launch/train.py``'s AdamW and
``LatentPipeline`` batches at batch 256 (the reference's
``DIT_SHAPES["train_256"]``) and, after one warm-up step, prints:

- wall ms (host clock around work ended by ``torch.cuda.synchronize``,
  median of 3) of the whole step, of the loss and gradients
  alone (``launch.steps.dit_loss_and_grads``: forward, remat recompute,
  backward) and of the optimizer alone (clip, moments, update, apply);
- one step under ``torch.profiler``: the device time by kernel family
  (GEMM, softmax, reduction, elementwise, indexing, copy, other) with
  its share, the kernel count, and the busy share (device time over the
  step's wall time); then the 12 kernels that take the most time.

The last line is a JSON object of these numbers.
"""
from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys
import time

BATCH, REPS = 256, 3
FAMILIES = [("gemm", r"gemm|xmma|nvjet|cutlass|cublas|wgmma"),
            ("softmax", r"softmax"),
            ("reduction", r"reduce|norm"),
            ("indexing", r"index|scatter|gather|sort|radix"),
            ("copy", r"copy|memcpy|memset|cat|stack"),
            ("elementwise", r"elementwise")]


def family(name: str) -> str:
    low = name.lower()
    for fam, pat in FAMILIES:
        if re.search(pat, low):
            return fam
    return "other"


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import dit_xl_2
    from repro_torch.data.synthetic import LatentPipeline
    from repro_torch.diffusion import rng
    from repro_torch.diffusion.ddpm import DiffusionCfg, make_schedule
    from repro_torch.launch.steps import dit_loss_and_grads
    from repro_torch.launch.train import batch_at
    from repro_torch.models.dit import dit_init_from_key
    from repro_torch.optim import adamw, apply_updates, cosine_schedule

    if not torch.cuda.is_available():
        raise SystemExit("train_times: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(dit_xl_2.full(), remat=True)
    key = rng.PRNGKey(0, device=dev)
    params = dit_init_from_key(key, cfg, device=dev)
    opt = adamw(cosine_schedule(1e-4, 5, 100), weight_decay=0.01)
    state = opt.init(params)
    sched = make_schedule(DiffusionCfg(T=1000), device=dev)
    pipe = LatentPipeline(cfg.img_size, cfg.in_ch, cfg.n_classes, seed=0)
    key, batch = batch_at(pipe, key, BATCH)

    def grads():
        return dit_loss_and_grads(cfg, sched, params, batch)

    def update(g):
        nonlocal params, state
        with torch.no_grad():
            u, state = opt.update(g, state, params)
            params = apply_updates(params, u)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    update(grads()[1])                       # warm-up step
    rows = {"step": [], "loss_and_grads": [], "optimizer": []}
    for _ in range(REPS):
        s, (_, g) = wall(grads)
        rows["loss_and_grads"].append(s)
        rows["optimizer"].append(wall(lambda: update(g))[0])
        del g
        rows["step"].append(wall(lambda: update(grads()[1]))[0])
    ms = {k: float(np.median(v)) * 1e3 for k, v in rows.items()}
    print(f"DiT-XL/2 train step, batch {BATCH}, bf16, remat; card "
          f"{card}: " + ", ".join(
              f"{k} {v:.1f} ms "
              f"({', '.join(f'{x * 1e3:.1f}' for x in rows[k])})"
              for k, v in ms.items()), flush=True)

    torch.cuda.synchronize()
    for _ in range(3):           # the profiler may drop a session's events
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            update(grads()[1])
            torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
        events = [(e.name, e.time_range.elapsed_us())
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    else:
        raise RuntimeError("the profiler recorded no kernel event")
    by_fam, by_name = collections.Counter(), collections.Counter()
    for name, us in events:
        by_fam[family(name)] += us
        by_name[name] += us
    busy = sum(by_fam.values())
    print(f"one traced step: {len(events)} kernels, device {busy / 1e3:.1f} "
          f"ms of {traced_s * 1e3:.1f} ms wall (busy share "
          f"{busy / 1e6 / traced_s:.3f})", flush=True)
    for fam, us in by_fam.most_common():
        print(f"  {fam:<12} {us / 1e3:9.1f} ms  {us / busy * 100:5.1f} %")
    for name, us in by_name.most_common(12):
        print(f"  {us / 1e3:9.1f} ms  {name[:110]}")
    print(json.dumps({"card": card, "batch": BATCH, "wall_ms": ms,
                      "kernels": len(events), "device_ms": busy / 1e3,
                      "traced_wall_ms": traced_s * 1e3,
                      "by_family_ms": {k: v / 1e3 for k, v in
                                       by_fam.items()}}))


if __name__ == "__main__":
    main()
