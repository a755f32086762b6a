"""Device time of the fused linears at the DiT-XL/2 serving shapes.

    python src/repro_torch/launch/gemm_times.py [--src DIR] [--reps 30] \
        [--vec] [--int4] [--label NAME]

For each linear of a DiT-XL/2 forward at 2B = 8 rows (qkv, proj, fc1,
fc2, ada, final, x_proj, t_mlp1, t_mlp2, final_ada; bf16, each with the
fusion it serves with, G = 10 at group 3; with ``--vec`` also the slot
pool's per-row-group kernels at qkv and fc2, one group per CFG row) at
W8A8 through the int8 family (B1/B2, ``--vec`` B6a/B6b), or with
``--int4`` at W4A4 through the packed-int4 family (B4/B5, ``--vec``
B7a/B7b: nibble weights from ``ref.pack_int4``, K groups of 256, x_proj's
16) prints:

- device ms per call: the CUDA kernels' durations summed by
  ``torch.profiler`` over ``--reps`` calls, split into the prologue pass
  (``csrc/prologue.cuh``; an older tree's ``quantize_kernel``), the GEMM
  and anything else (an older tree's torch layernorm statistics and
  casts), with the pass's own bound beside it (x read once, the code
  planes written once, the modulation rows and row map);
- wrapper ms per call: CUDA events around ``--reps`` back-to-back calls
  (the host's checks, allocations and enqueue included: once the
  kernels are fast, the host sets this pace);
- bound ms: the least time the card could take for the call's work, the
  larger of its bytes (each input read once, each output written once)
  at 3.35 TB/s and its int8 operations at 1979 TOP/s (H100 SXM); int4
  weights count K x N / 2 bytes.

The last line is a JSON list of the rows. ``--src`` puts DIR first on
the import path, so one script times another tree's kernels (a parent
commit unpacked with ``git archive``) through the same wrappers; run
both in one process order (parent, change, change, parent) on one card
to compare them.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys

HBM_BPS = 3.35e12          # H100 SXM device memory, bytes/s
INT8_OPS = 1979e12         # dense int8 tensor-core peak, ops/s
# (op, M, K, N, fusion, MRQ) of one DiT-XL/2 forward at 2B = 8 rows
SHAPES = [("qkv", 2048, 1152, 3456, "norm_mod", False),
          ("proj", 2048, 1152, 1152, "gate_residual", False),
          ("fc1", 2048, 1152, 4608, "norm_mod", False),
          ("fc2", 2048, 4608, 1152, "gate_residual", True),
          ("ada", 8, 1152, 6912, "", False),
          ("final", 2048, 1152, 32, "norm_mod", False),
          ("x_proj", 2048, 16, 1152, "", False),
          ("t_mlp1", 8, 256, 1152, "", False),
          ("t_mlp2", 8, 1152, 1152, "", False),
          ("final_ada", 8, 1152, 2304, "", False)]
SLOT_GROUPS = (3, 7, 0, 9, 3, 7, 0, 9)   # one TGQ group per CFG row


def bound(nbytes: float, int8_ops: float):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, int8_ops / INT8_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def make_call(op, M, K, N, fusion, mrq, vec, gen, bits=8, int4=False):
    """(run, bytes, int8 operations) of one fused linear call on the
    card: bf16 x, random weight codes, G = 10 scale stacks (``int4``:
    packed nibbles, per-(K group, channel) scales)."""
    import torch
    from repro_torch.kernels import int4_packed as F4
    from repro_torch.kernels import int8_fused as F8
    from repro_torch.kernels.ref import pack_int4
    dev, dt = torch.device("cuda"), torch.bfloat16
    if int4:
        bits = 4
    half, B, G, g = 2 ** (bits - 1), 8, 10, 3
    group_k = min(256, K)
    nk = -(-K // group_k) if int4 else 1
    x = torch.randn(M, K, device=dev, generator=gen)
    if mrq:                                # post-GELU-like input
        x = torch.nn.functional.gelu(x * 2, approximate="tanh")
    x = x.to(dt)
    wq = torch.randint(-(half - 1), half, (nk * group_k if int4 else K, N),
                       device=dev, generator=gen, dtype=torch.int8)
    wq[K:] = 0
    rate = 1.0 + 0.1 * torch.rand(G, 1, device=dev, generator=gen)
    scale_w = torch.rand(nk, N, device=dev, generator=gen) * 1e-3 + 1e-4
    bias = torch.randn(N, device=dev, generator=gen) * 0.1
    bv = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(
        -(-M // B))[:M].contiguous()
    if int4:
        w_arg = pack_int4(wq)
        colsum = wq.to(torch.int32).reshape(nk, group_k, N).sum(
            1, dtype=torch.int32)
        expand = lambda s: s[:, :, None] * scale_w[None]
        kw = {"group_k": group_k, "out_dtype": dt}
        mod = F4
    else:
        w_arg, colsum = wq, wq.to(torch.int32).sum(0, dtype=torch.int32)[None]
        expand = lambda s: s * scale_w
        kw = {"bits": bits, "out_dtype": dt}
        mod = F8
    nbytes = (M * K * 2 + (K * N // 2 if int4 else K * N)
              + (G if vec else 1) * nk * N * 4 * 2 + N * 4
              + M * N * 2 + (M * 4 if vec else 0))
    Kq = nk * -128 * (-group_k // 128) if int4 else -16 * (-K // 16)
    pass_bytes = M * K * 2 + (2 if mrq else 1) * M * Kq + (M * 4 if vec
                                                           else 0)
    if fusion == "norm_mod":       # shift, scale: chunk views of the adaLN
        ada = (torch.randn(B, 6 * K, device=dev, generator=gen) * 0.1)
        kw.update(nm=torch.chunk(ada.to(dt), 6, dim=-1)[:2], bv=bv)
        nbytes += 2 * B * K * 2 + M * 4
        pass_bytes += 2 * B * K * 2 + M * 4
    if fusion == "gate_residual":
        kw.update(gr=(torch.randn(B, N, device=dev, generator=gen),
                      torch.randn(M, N, device=dev, generator=gen).to(dt)),
                  bv=bv)
        nbytes += B * N * 4 + M * N * 2 + M * 4
    family = "int4" if int4 else "int8"
    if mrq:
        s_neg, s_pos = rate * (0.2 / half), rate * (6.0 / half)
        args = (x, w_arg, s_neg, s_pos, expand(s_neg), expand(s_pos), bias)
        name = f"{family}_matmul_mrq_fq"
    else:
        sx = rate * (8.0 / (2 * half - 1))
        zx = torch.round(4.0 / sx)
        z_eff = torch.round(zx).to(torch.int32) - half
        corr = (z_eff[:, :, None] if int4 else z_eff) * colsum
        args = (x, w_arg, sx, zx, expand(sx), corr, bias)
        name = f"{family}_matmul_fq"
    fn = getattr(mod, name + ("_vec" if vec else ""))
    if vec:
        grp = torch.tensor(SLOT_GROUPS, dtype=torch.int32, device=dev)
        gv = grp.repeat_interleave(-(-M // B))[:M].contiguous()
        run = lambda: fn(*args, gv, **kw)
    else:
        run = lambda: fn(*args, g, **kw)
    return run, nbytes, 2 * M * K * N * (2 if mrq else 1), pass_bytes


def kernel_name(name: str) -> str:
    """``void (anonymous namespace)::gemm_kernel<false>(...)`` ->
    ``gemm_kernel<false>``."""
    m = re.search(r"(\w+_kernel)(<[^(]*?>)?\(", name)
    return m.group(1) + (m.group(2) or "") if m else name[:60]


PROFILE_TRIES = 5
EDGE, EDGES = "spin_kernel", 4     # torch.cuda._sleep's kernel, and how many


def kernel_events(run, reps: int, *, must: bool = True, kinds=None):
    """([(name, device µs)] of the profiler's CUDA kernel events,
    {wrapper: launches}) of ``reps`` calls of ``run`` after one warm-up
    call; the launches are the wrappers' counts (``kernels.LAUNCHES``)
    over those calls.

    The profiler can drop events: on the H100 one in 90, or every event of
    a session, and late in a long run the first or last two of every
    session. So each session opens and closes with ``EDGES`` short
    ``torch.cuda._sleep`` kernels, which take that last loss and are left
    out by name (``EDGE``); where the kept session lost any of them, this
    says so on stderr. Every call runs the same kernels and makes at least
    one event, and every counted launch one, so a session whose events are
    fewer than the calls or the launches, whose count for some kernel is
    not a multiple of ``reps``, or (``kinds``: {wrapper: a substring of
    its kernel's name}) whose events of such a kernel are fewer than its
    wrapper's launches, lost some: the calls are profiled again, up to
    ``PROFILE_TRIES`` sessions, and then this raises, or returns None
    where not ``must``."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels

    def edges():
        for _ in range(EDGES):
            torch.cuda._sleep(1000)
    run()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        before = dict(kernels.LAUNCHES)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            edges()
            for _ in range(reps):
                run()
            edges()
            torch.cuda.synchronize()
        launched = {k: v - before.get(k, 0)
                    for k, v in kernels.LAUNCHES.items()
                    if v != before.get(k, 0)}
        cuda = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        events = [(k, us) for k, us in cuda if EDGE not in k]
        counts = collections.Counter(k for k, _ in events)
        short = {w: key for w, key in (kinds or {}).items()
                 if sum(key in k for k, _ in events) < launched.get(w, 0)}
        if (len(events) >= max(reps, sum(launched.values())) and not short
                and all(n % reps == 0 for n in counts.values())):
            cut = 2 * EDGES - (len(cuda) - len(events))
            if cut:
                print(f"the profiler dropped {cut} of the session's "
                      f"{2 * EDGES} edge kernel events; its {len(events)} "
                      "other events passed the checks", file=sys.stderr,
                      flush=True)
            return events, launched
        print(f"the profiler recorded {len(events)} kernel events for "
              f"{reps} calls and {sum(launched.values())} launches"
              + (f", too few of {sorted(short.values())}" if short else "")
              + "; profiling again", file=sys.stderr, flush=True)
        time.sleep(1.0)
    if not must:
        return None
    raise RuntimeError(f"the profiler lost kernel events in "
                       f"{PROFILE_TRIES} sessions of {reps} calls")


def device_ms(run, reps: int):
    """{kernel: device ms per call} of ``reps`` calls of ``run``, from the
    profiler's CUDA kernel events (``kernel_events``)."""
    per = collections.Counter()
    for name, us in kernel_events(run, reps)[0]:
        per[kernel_name(name)] += us
    return {k: v / reps / 1e3 for k, v in per.items()}


def wrapper_ms(run, reps: int) -> float:
    import torch
    run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_shape(op, M, K, N, fusion, mrq, vec, gen, reps, int4=False):
    """One row: the call's device ms (total, quantize, GEMM), wrapper ms
    and bound."""
    run, nbytes, ops, pass_bytes = make_call(op, M, K, N, fusion, mrq, vec,
                                             gen, int4=int4)
    dev = device_ms(run, reps)
    quant = sum(v for k, v in dev.items()
                if k.startswith(("prologue_", "quantize_kernel")))
    gemm = sum(v for k, v in dev.items() if k.startswith("gemm"))
    row = {"op": op, "M": M, "K": K, "N": N, "fusion": fusion or "plain",
           "kernel": ("int4" if int4 else "int8")
           + ("_matmul_mrq_fq" if mrq else "_matmul_fq")
           + ("_vec" if vec else ""),
           "device_ms": sum(dev.values()), "quantize_ms": quant,
           "gemm_ms": gemm, "other_ms": sum(dev.values()) - quant - gemm,
           "wrapper_ms": wrapper_ms(run, reps),
           "quantize_bound_ms": pass_bytes / HBM_BPS * 1e3}
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops)
    return row


def time_shapes(reps: int = 30, vec: bool = False, shapes=SHAPES,
                log=print, int4: bool = False):
    """Rows for every serving shape (``vec``: also the per-row-group
    kernels at qkv and fc2; ``int4``: the packed-int4 family)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [time_shape(*s, False, gen, reps, int4) for s in shapes]
    if vec:
        rows += [time_shape(*s, True, gen, reps, int4) for s in shapes
                 if s[0] in ("qkv", "fc2")]
    for r in rows:
        log(f"  {r['kernel']:<22} {r['op']:<9} {r['M']:>4}x{r['K']:<4}x"
            f"{r['N']:<4} device {r['device_ms']:.4f} ms (quantize "
            f"{r['quantize_ms']:.4f} [bound {r['quantize_bound_ms']:.4f}], "
            f"gemm {r['gemm_ms']:.4f}, other "
            f"{r['other_ms']:.4f}); wrapper {r['wrapper_ms']:.4f} ms; "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None,
                    help="import repro_torch from this directory")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--vec", action="store_true")
    ap.add_argument("--int4", action="store_true",
                    help="the packed-int4 family (W4A4) instead of int8")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    src = args.src or os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "..")
    sys.path.insert(0, os.path.abspath(src))
    import torch
    import repro_torch
    if not torch.cuda.is_available():
        raise SystemExit("gemm_times: needs a CUDA card")
    print(f"{args.label}: repro_torch from {os.path.dirname(repro_torch.__file__)}"
          f" on {torch.cuda.get_device_name(0)}", flush=True)
    rows = time_shapes(args.reps, args.vec, int4=args.int4)
    print(json.dumps({"label": args.label, "rows": rows}))


if __name__ == "__main__":
    main()
