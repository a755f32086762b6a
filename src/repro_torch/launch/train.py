"""Training launcher — the DiT branch of ``repro/launch/train.py``.

Trains DiT-XL/2 (``--smoke``: the tiny config) with the reference's
recipe: the keyed init from ``PRNGKey(--seed)``, AdamW under a cosine
schedule (warm-up ``max(steps // 20, 5)``, weight decay 0.01), batches
from ``LatentPipeline`` drawn from ``split(key, 4)`` each step, and every
block recomputed in the backward (``remat``). ``--ckpt_dir`` saves
``{"params", "opt"}`` in the reference's checkpoint format every
``--ckpt_every`` steps (in the background) and at the end, and resumes
from the latest one, written by either package.

A resumed run equals an uninterrupted one: the key stream is
step-indexed (a resume at step s advances the key s times first). The
reference's DiT branch starts the key stream again on resume and so
draws the first steps' batches again.

  python -m repro_torch.launch.train --arch dit-xl-2 --steps 100 \\
      --batch 256 --ckpt_dir /ckpts/dit      # float32 only, see below
  python -m repro_torch.launch.train --arch dit-xl-2 --smoke \\
      --device cpu --steps 20 --ckpt_dir /tmp/dit --ckpt_every 5

DiT-XL/2's full config is bfloat16, which neither package's checkpoint
format can restore, so a bf16 run with ``--ckpt_dir`` exits before its
first step. Other architectures, ``--grad_accum`` and the meshes wait
for later slices.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def restore_state(path: str, like):
    """The latest checkpoint under ``path`` as tensors shaped, typed and
    placed as ``like``'s leaves."""
    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.optim.optimizers import tree_map

    def put(a, p):
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"checkpoint leaf {a.dtype}{a.shape} does not "
                             f"fit the model's {p.dtype}{tuple(p.shape)}")
        return torch.from_numpy(a).to(p.device, p.dtype)
    return tree_map(put, ckpt.unflatten(like, ckpt.restore(path)), like)


def batch_at(pipe, key, batch: int):
    """(next key, batch) of one step: ``split(key, 4)``, then
    ``pipe.sample(batch, k1)``, ``randint(k2, (batch,), 0, 1000)`` and
    ``normal(k3, x0.shape)``, as the reference draws them."""
    from repro_torch.diffusion import rng
    key, k1, k2, k3 = rng.split(key, 4)
    x0, y = pipe.sample(batch, k1)
    return key, {"x0": x0, "y": y,
                 "t": rng.randint(k2, (batch,), 0, 1000),
                 "noise": rng.normal(k3, tuple(x0.shape))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-scale)")
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--ckpt_every", type=int, default=20)
    ap.add_argument("--grad_accum", type=int, default=1)
    ap.add_argument("--data_mesh", type=int, default=1)
    ap.add_argument("--model_mesh", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs on the CPU")
    args = ap.parse_args(argv)

    if args.arch != "dit-xl-2":
        raise SystemExit(f"--arch {args.arch}: the port trains dit-xl-2 "
                         "only (LM training is ROADMAP queue 1, item 8(e))")
    if args.grad_accum != 1:
        raise SystemExit("--grad_accum: the DiT branch takes none; "
                         "accumulation is the LM branch's (ROADMAP queue "
                         "1, item 8(e))")
    if args.data_mesh != 1 or args.model_mesh != 1:
        raise SystemExit("--data_mesh / --model_mesh: one device only "
                         "(multi-GPU is ROADMAP queue 1, item 9)")

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import dit_xl_2
    from repro_torch.data.synthetic import LatentPipeline
    from repro_torch.device import resolve_device
    from repro_torch.diffusion import rng
    from repro_torch.diffusion.ddpm import DiffusionCfg, make_schedule
    from repro_torch.launch.steps import make_dit_train_step
    from repro_torch.models.dit import dit_init_from_key
    from repro_torch.optim import adamw, cosine_schedule

    cfg = dit_xl_2.smoke() if args.smoke else dit_xl_2.full()
    cfg = dataclasses.replace(cfg, remat=True)
    if args.ckpt_dir and cfg.dtype != "float32":
        raise SystemExit(
            f"--ckpt_dir with a {cfg.dtype} config: neither package can "
            "restore a bfloat16 checkpoint (ROADMAP queue 3, 'bf16 "
            "checkpoints'); train --smoke (float32) to checkpoint")
    dev = resolve_device(args.device)
    key = rng.PRNGKey(args.seed, device=dev)
    opt = adamw(cosine_schedule(args.lr, max(args.steps // 20, 5),
                                args.steps), weight_decay=0.01)
    params = dit_init_from_key(key, cfg, device=dev)
    step_fn = make_dit_train_step(cfg, opt, make_schedule(
        DiffusionCfg(T=1000), device=dev))
    pipe = LatentPipeline(cfg.img_size, cfg.in_ch, cfg.n_classes,
                          seed=args.seed)

    opt_state = opt.init(params)
    start = 0
    if args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            state = restore_state(args.ckpt_dir,
                                  {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start = latest
            print(f"resumed from step {start}")
    for _ in range(start):
        key = rng.split(key, 4)[0]

    t0 = time.perf_counter()
    for step in range(start, args.steps):
        key, batch = batch_at(pipe, key, args.batch)
        loss, params, opt_state = step_fn(params, opt_state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = (time.perf_counter() - t0) / max(step - start + 1, 1)
            print(f"step {step:5d} loss {float(loss):.4f} "
                  f"({dt*1000:.0f} ms/step)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(args.ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state})
    if args.ckpt_dir:
        ckpt.wait_async()
        ckpt.save(args.ckpt_dir, args.steps,
                  {"params": params, "opt": opt_state})
    print("done.")


if __name__ == "__main__":
    main()
