#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's W8A8, W6A6 and W4A4 serving paths, sync
and continuous-batching, flash and composed attention, its HO calibration
with a saved artifact cold-started in a fresh process, its recipe
auto-search with the throughput measured on the card, its evaluation
path (the research sampler, FD / sFD / IS*, noise MSE) and its public
kernel API (B11, B12, B13, flash's boolean mask), on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases (each fatal on failure; exit code 0 only when all pass):

1. build   — compile ``src/repro_torch/csrc/*.cu`` with nvcc (one process
             per source, in parallel); print the build seconds, ptxas's
             register, spill and wgmma-serialisation lines (the flash
             kernel's per instantiation, fatal on a spill or a C7513;
             the prologue pass's per instantiation, fatal on a spill),
             the card's name and power limit, and the SASS of the int8
             GEMM and of the packed-int4 GEMM (each fatal unless it holds
             wgmma and TMA loads and no mma.sync) and of the flash kernel
             (fatal unless it holds wgmma and no mma.sync), and of the
             composed chain's matmuls (``csrc/int8_bmm.cu``: ptxas lines
             per instantiation, fatal on a spill in the serving ones;
             SASS fatal unless wgmma and no mma.sync), and of the
             softmax-codes pass (``csrc/softmax_mrq.cu``: ptxas lines
             per instantiation, fatal on a spill in the serving ones,
             ``<f32|bf16 scores, codes, 8 columns a lane>``), and of B13
             (``csrc/act_mrq.cu``: ptxas lines per instantiation, fatal on
             a spill in the serving ``<bf16, bf16, GELU>`` and ``<f32,
             f32, GELU>``, whose SASS instructions an element it prints);
             the other libraries' ptxas lines name their kernel
             instantiation.
2. kernels — each kernel against its plain PyTorch version on the card,
             at the DiT-XL/2 serving shapes (microbatch 4 -> CFG 2B = 8,
             M = 2048 rows), f32 and bf16 inputs, with and without the
             fusions, G = 10 at a nonzero group: B1/B2 and B6a/B6b
             (bits 8 and 6, every int8 serving shape: qkv, proj, fc1,
             fc2, ada, final, x_proj, t_mlp2, final_ada), B4/B5 (packed
             int4, every W4A4 serving shape: the ten above with t_mlp1,
             K groups of 256 and x_proj's 16), B3
             (bits 8, 6 and 4) and B3b (packed kv, also held bit for bit
             against unpacked B3); the per-row-group kernels B6a/B6b
             (bits 8), B7a/B7b (bf16 and f32) and B8 (bits 8, and 4 with
             packed kv) in bf16 with a mixed group vector (one group per
             slot), each
             also held bit for bit against its scalar kernel, with a
             constant vector and group by group; the composed
             attention chain B9a -> B10a -> B9b and its per-row-group
             B9c -> B10b -> B9d (bits 8, 6 and 4, bf16; f32 at 8), each
             kernel against its plain version, the vec ones also against
             the scalar ones, the scalar chain against B3 within the
             reference's flash_vs_composed_atol; the public API's B11
             int8_matmul on qkv and fc2 codes and a ragged 130x257x129
             (f32 and bf16 out, with and without bias), B12 softmax_mrq
             on (32768, 256) scores (f32 and bf16, bits 8 and 6), B13
             act_mrq (GELU on fc1's (2048, 4608) output, SiLU on the
             (8, 1152) adaLN input; bf16 and f32, bits 8 and 6; every
             output's bits, signed zeros included, NaN as NaN), and the
             masked B3, B3b, B8 (bits 8 and 4 packed; causal, random with
             fully masked rows, ragged Skv 77 with a padding mask, GQA),
             each also within flash_vs_composed_atol of the masked
             composed chain; max error and mismatches against the
             tolerance registry; kernel, plain-version and library-call
             times (CUDA events) beside the least time the card could
             take (bytes at 3.35 TB/s, int8 operations at 1979 TOP/s,
             fp32 at 67 TFLOP/s), and the masked flash time beside the
             unmasked one; B11, B12 and B13's ms in the kernels line is
             their device time (the profiler over 30 calls), their
             wrapper time beside it; B13's library ms is F.gelu's device
             time. The prologue pass alone
             (``kernels/prologue.py::codes``) against its plain version
             at every int8 and packed-int4 serving shape, bf16 and f32,
             scalar and per-row groups: every code bit for bit. Then the
             int8 and the packed-int4 GEMMs' calls at every serving shape
             in device time (``launch/gemm_times.py [--int4]``: the
             profiler's kernel durations, prologue pass (with its own
             bound) and GEMM apart; fatal if a norm-modulated linear
             launches anything else) beside their wrapper times and
             bounds; the kernels line's ms for B1, B2,
             B4, B5, B6a, B6b, B7a, B7b and B11 is that device time. Then
             one attention call at the serving shape through
             ``ops.flash_attention`` on the qkv views
             (``launch/attn_times.py``: B3, B3b, B8, and B3 with a causal
             mask) in device time, asserting one launch a call, beside
             its bound and SDPA; the kernels line's ms for B3, B3b and B8
             is that device time. Then one composed attention call
             (``ops.int8_attention``, ``attn_times.py --composed``: bits 8
             and 4, scalar and per-slot groups) in device time by kernel,
             asserting three launches a call (B9a, B10a, B9b or B9c, B10b,
             B9d) and no other kernel; the kernels line's ms for B9a-d
             and B10a-b is that device time.
3. trained — the trained 6-layer checkpoint ``experiments/dit_bench_450.pkl``
             range-calibrated (w8a8, w6a6, w4a4; G=10) on the card; the
             same requests served fp and quantized through the kernels;
             prints each drift (w8a8 must read 0.010440).
3b. HO      — the same checkpoint HO-calibrated (the paper's Algorithm 1:
             Fisher taps, alternating candidate search, MRQ + TGQ) at each
             width with the launcher's ``--calib ho`` knobs (n_alpha 8,
             rounds 2; 10 batches of 4); no fallback op, finite samples;
             prints each drift beside range's and the calibration seconds.
             A second W8A8 HO calibration must give the same content hash.
4. serve   — DiT-XL/2 at full width (bf16, perturbed initialised weights)
             through ``repro_torch.launch.serve``'s path at w8a8, w6a6 and
             w4a4: range calibration, then 8 requests, microbatch 4, 20
             steps, CFG 1.5. For each width asserts zero fallback ops,
             finite samples, and launch counts (set to 0 before the serve,
             read after it) equal to ops packed per kernel x forwards, and
             holds one full-width forward on the kernels against the plain
             versions; one more forward under the profiler must launch
             one flash_kernel per block, no codes_kernel and no torch
             MeanOps or pow kernel (the layernorm statistics run in the
             prologue pass), and prints its kernel launches. Then, with the
             same params and artifact, the
             continuous-batching engine (``AsyncServeEngine``: microbatch
             4, buckets (10, 20), chunk 4, pipeline 2, CFG 1.5) serves 12
             requests alternating 10 and 20 steps; asserts every outcome
             OK with no degradation or retry, samples equal to the sync
             engine's bit for bit, ``*_vec`` launch counts (set to 0
             before, read after) equal to ops packed per kernel x
             forwards and no scalar launch, and one chunk dispatch run
             under ``torch.cuda.set_sync_debug_mode("error")`` (the chunk
             never blocks the host); prints ms/step and req/s (at W8A8
             for pipeline 1 too). Each width is then served again with
             ``attn_impl="composed"``: the sync 8 requests (zero flash
             launches, B9a/B10a/B9b = 28 x forwards, one full-width
             forward on the kernels equal to the plain versions) and the
             async mix (samples equal the sync composed engine's,
             B9c/B10b/B9d = 28 x forwards, one chunk under
             ``set_sync_debug_mode("error")``); at W8A8 one injected
             dispatch fault steps the flash async engine to the composed
             rung, which serves every request. Prints flash and composed
             ms/step and req/s side by side.
4b. cold start — DiT-XL/2 at full width HO-calibrated at W8A8 through
             ``launch.serve.build`` and saved (``QuantArtifact.save``); 8
             requests x 20 steps served in process (launch counts set to 0
             before, read after: packed x forwards); then ``python -m
             repro_torch.launch.serve --load-artifact`` in a fresh process
             must report no calibration and dump samples equal to the
             in-memory artifact's bit for bit. Prints the calibration,
             save and load seconds beside range's calibration seconds.
5. eval    — the research sampler and the paper's metrics through the
             kernels (``repro_torch.quant.eval``). (a) The trained
             checkpoint's FP and phases 3 and 3b's range and HO artifacts
             (W8A8, W6A6, W4A4): 128 samples x 40 steps in batches of 64
             (4,096 token rows a forward), FD / sFD / IS* against 1,024
             real latents, noise MSE; one row each, finite, launch counts
             (set to 0 before each sampling, read after) = packed x
             forwards; a constant-map ``generate_grouped`` equal to
             ``generate`` bit for bit at W8A8; a mixed map (W8A8 groups
             0-4, W4A4 5-9) launching both kernel families in one chain.
             (b) DiT-XL/2 at full width under phase 4b's HO W8A8 and phase
             4's W4A4 artifacts: one 32-row forward (8,192 token rows) on
             the kernels equal to the plain versions, 32 samples x 20
             steps (ms/step and samples/s beside the card), scores against
             XL-shaped assets, noise MSE by group.
4c. autotune — ``repro_torch.autotune`` on the trained checkpoint (w8a8,
             w6a6, w4a4, flash, a mixed trial at a mean of 6 bits, the
             default ``EvalConfig``): killed after one trial, resumed,
             whose run measures DiT-XL/2's int8 and int4 serving paths (1
             request x 100 CFG-paired steps through the sync engine and
             phase 4's range artifacts, one warm-up and 3 timed runs:
             zero fallback ops, launch counts = packed x forwards), then
             replayed as a pure cache hit with byte-identical outputs, and
             ``python -m repro_torch.launch.autotune --assert-resumed`` in
             a fresh process (nothing recomputed or measured, the frontier
             reproduced). Prints each path's median seconds per step and
             spread beside the card, each trial (status, req/s, FD, noise
             MSE by group), the frontier (label, req/s, FD) and the
             fastest path.
6. entry points — the public kernel API at the DiT-XL/2 shapes:
             ``repro_torch.kernels.int8_matmul``, ``ops.softmax_mrq_op``,
             ``ops.act_mrq_op`` (GELU and SiLU) and
             ``ops.flash_attention(mask=causal)`` at bits 8 and 4, scalar
             and per-slot groups; launch counts (set to 0 before, read
             after) one per call, outputs finite and equal to the plain
             versions'. Its counts join the serves' in the kernels line,
             so each of the 21 kernels shows the launches of the path
             that reaches it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import importlib
import json
import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BPS = 3.35e12          # H100 SXM device memory, bytes/s
INT8_OPS = 1979e12         # dense int8 tensor-core peak, ops/s
FP32_OPS = 67e12           # fp32 outside the tensor cores, flop/s
SOFTMAX_FP32_PER_SCORE = 10  # fp32 ops per score: scale, max, sub, exp,
                             # sum, 2 divides, compare, round, rescale
CODES_FP32_PER_SCORE = 7     # B10: max, sub, exp, sum, 2 divides, round
QDQ_FP32_PER_SCORE = 8       # B12: B10's 7 and the dequantising multiply
GELU_MRQ_FP32_PER_ELEM = 15  # B13: 5 multiplies, 2 adds, tanh in the GELU;
                             # compare, divide, round, clip (2), multiply


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, int8_ops: float, fp32_ops: float = 0.0):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = (int8_ops / INT8_OPS + fp32_ops / FP32_OPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at the serving shapes
# ---------------------------------------------------------------------------
LINEAR_CASES = [  # (op, M, K, N, fusion, kernel): every int8 serving shape
    ("ada", 8, 1152, 6912, "", "int8_matmul_fq"),
    ("qkv", 2048, 1152, 3456, "norm_mod", "int8_matmul_fq"),
    ("proj", 2048, 1152, 1152, "gate_residual", "int8_matmul_fq"),
    ("fc1", 2048, 1152, 4608, "norm_mod", "int8_matmul_fq"),
    ("fc2", 2048, 4608, 1152, "gate_residual", "int8_matmul_mrq_fq"),
    ("final", 2048, 1152, 32, "norm_mod", "int8_matmul_fq"),
    ("x_proj", 2048, 16, 1152, "", "int8_matmul_fq"),
    ("t_mlp2", 8, 1152, 1152, "", "int8_matmul_fq"),
    ("final_ada", 8, 1152, 2304, "", "int8_matmul_fq"),
]
INT4_CASES = [  # every W4A4 serving shape, with the fusion and without it
    ("qkv", 2048, 1152, 3456, "norm_mod", "int4_matmul_fq"),
    ("proj", 2048, 1152, 1152, "gate_residual", "int4_matmul_fq"),
    ("fc1", 2048, 1152, 4608, "norm_mod", "int4_matmul_fq"),
    ("fc2", 2048, 4608, 1152, "gate_residual", "int4_matmul_mrq_fq"),
    ("ada", 8, 1152, 6912, "", "int4_matmul_fq"),
    ("final", 2048, 1152, 32, "norm_mod", "int4_matmul_fq"),
    ("x_proj", 2048, 16, 1152, "", "int4_matmul_fq"),
    ("t_mlp1", 8, 256, 1152, "", "int4_matmul_fq"),
    ("t_mlp2", 8, 1152, 1152, "", "int4_matmul_fq"),
    ("final_ada", 8, 1152, 2304, "", "int4_matmul_fq"),
]
TIMED = {"int8_matmul_fq": "qkv", "int8_matmul_mrq_fq": "fc2",
         "int4_matmul_fq": "qkv", "int4_matmul_mrq_fq": "fc2"}
MRQ = ("int8_matmul_mrq_fq", "int4_matmul_mrq_fq")
VEC_CASES = [  # (op, M, K, N, fusion, scalar kernel, bits): B6a, B6b, B7a, B7b
    ("qkv", 2048, 1152, 3456, "norm_mod", "int8_matmul_fq", 8),
    ("fc2", 2048, 4608, 1152, "gate_residual", "int8_matmul_mrq_fq", 8),
    ("qkv", 2048, 1152, 3456, "norm_mod", "int4_matmul_fq", 4),
    ("fc2", 2048, 4608, 1152, "gate_residual", "int4_matmul_mrq_fq", 4),
]
SLOT_GROUPS = (3, 7, 0, 9, 3, 7, 0, 9)   # one TGQ group per CFG row (2B = 8)


def slot_rows(n_rows, dev):
    """The per-row group vector of a 2B = 8-row slot batch: each slot's
    group over its n_rows / 8 batch-major rows."""
    import torch
    g = torch.tensor(SLOT_GROUPS, dtype=torch.int32, device=dev)
    return g[:, None].expand(8, n_rows // 8).reshape(n_rows).contiguous()


def check_vec_against_scalar(name, out, vec_run, scalar_run, gv, g0):
    """A vec kernel bit for bit against its scalar kernel: a constant
    vector at group g0, and each group of ``gv`` over its own rows."""
    import torch
    const = vec_run(torch.full_like(gv, g0))
    n_const = int((const != scalar_run(g0)).sum())
    n_split = 0
    for h in sorted(set(gv.tolist())):
        rows = gv == h
        n_split += int((out[rows] != scalar_run(h)[rows]).sum())
    log(f"  {name} vs its scalar kernel: constant vector {n_const} and "
        f"per-group split {n_split} differing outputs (registry "
        f"vec_vs_scalar_kernel: 0.0)")
    if n_const or n_split:
        raise AssertionError(f"{name} differs from its scalar kernel")


def linear_case(op, M, K, N, fusion, kern, bits, dt, gen, timed, vec=False):
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import int4_packed as F4
    from repro_torch.kernels import int8_fused as F8
    from repro_torch.kernels.ref import TOLERANCES, pack_int4

    dev = torch.device("cuda")
    half = 2 ** (bits - 1)
    B, G, g = 8, 10, 3
    int4 = kern.startswith("int4")
    x = torch.randn(M, K, device=dev, generator=gen)
    if kern in MRQ:                        # post-GELU-like input
        x = torch.nn.functional.gelu(x * 2, approximate="tanh")
    x = x.to(dt)
    group_k = min(256, -8 * (-K // 8))
    nk = -(-K // group_k)
    wq = torch.randint(-(half - 1), half, (nk * group_k if int4 else K, N),
                       device=dev, generator=gen, dtype=torch.int8)
    wq[K:] = 0
    rate = 1.0 + 0.1 * torch.rand(G, 1, device=dev, generator=gen)
    scale_w = (torch.rand(nk, N, device=dev, generator=gen) * 1e-3 + 1e-4
               if int4 else
               torch.rand(1, N, device=dev, generator=gen) * 1e-3 + 1e-4)
    bv = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(M // B)
    kw = {}
    if fusion == "norm_mod":   # shift, scale: chunk views, as in serving
        ada = torch.randn(B, 6 * K, device=dev, generator=gen) * 0.1
        kw = {"nm": torch.chunk(ada.to(dt), 6, dim=-1)[:2], "bv": bv}
    if fusion == "gate_residual":
        kw = {"gr": (torch.randn(B, N, device=dev, generator=gen),
                     torch.randn(M, N, device=dev, generator=gen).to(dt)),
              "bv": bv}
    bias = torch.randn(N, device=dev, generator=gen) * 0.1
    if int4:                               # per-(K group, channel) scales
        w_arg, colsum = pack_int4(wq), wq.to(torch.int32).reshape(
            nk, group_k, N).sum(1, dtype=torch.int32)
        expand = lambda s: s[:, :, None] * scale_w[None]
        kw["group_k"] = group_k
    else:
        w_arg, colsum = wq, wq.to(torch.int32).sum(0, dtype=torch.int32)[None]
        expand = lambda s: s * scale_w
        kw["bits"] = bits
    if kern in MRQ:
        s_neg = rate * (0.2 / half)
        s_pos = rate * (6.0 / half)
        args = (x, w_arg, s_neg, s_pos, expand(s_neg), expand(s_pos), bias, g)
    else:
        sx = rate * (8.0 / (2 * half - 1))
        zx = torch.round(4.0 / sx)
        z_eff = torch.round(zx).to(torch.int32) - half
        corr = (z_eff[:, :, None] if int4 else z_eff) * colsum
        args = (x, w_arg, sx, zx, expand(sx), corr, bias, g)
    fn = {"int8_matmul_fq": F8.int8_matmul_fq,
          "int8_matmul_mrq_fq": F8.int8_matmul_mrq_fq,
          "int4_matmul_fq": F4.int4_matmul_fq,
          "int4_matmul_mrq_fq": F4.int4_matmul_mrq_fq}[kern]
    name = kern
    if vec:                                # per-row groups, one per slot
        scalar_fn, fn, name = fn, getattr(F8 if not int4 else F4,
                                          kern + "_vec"), kern + "_vec"
        gv = slot_rows(M, dev)
        args = args[:-1] + (gv,)
    run = lambda: fn(*args, out_dtype=dt, **kw)
    out = run()
    with kernels.plain_on_cuda():
        ref = run()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    max_err, n_bad = float(err.max()), int((err > 0).sum())
    key = {"int8_matmul_fq": "B1_norm_mod_vs_plain" if fusion == "norm_mod"
           else "B1_vs_plain", "int8_matmul_mrq_fq": "B2_vs_plain",
           "int4_matmul_fq": "B4_vs_plain",
           "int4_matmul_mrq_fq": "B5_vs_plain"}[kern]
    if vec:
        key = "vec_vs_plain"
    tol = TOLERANCES[key][0]
    log(f"kernel {name} op={op} M={M} K={K} N={N} {fusion or 'plain'} "
        f"{str(dt)[6:]} bits={bits}: max_abs_err={max_err} "
        f"mismatches={n_bad}/{err.numel()} (registry {key}: {tol})")
    if max_err > tol:
        raise AssertionError(f"{name} {op} bits={bits} {dt}: max error "
                             f"{max_err} > {tol}")
    if vec:
        check_vec_against_scalar(
            name, out, lambda v: fn(*args[:-1], v, out_dtype=dt, **kw),
            lambda h: scalar_fn(*args[:-1], h, out_dtype=dt, **kw), gv, g)
    row = {"max_abs_err": max_err}
    if timed:
        row["ms"] = time_ms(run, 50)
        with kernels.plain_on_cuda():
            row["plain_ms"] = time_ms(run, 5, warmup=1)
        xq = torch.randint(-half, half, (M, K), device=dev, dtype=torch.int8)
        wk = wq[:K].contiguous()           # the widened s8 codes
        row["library_ms"] = time_ms(lambda: torch._int_mm(xq, wk), 50)
        esz = x.element_size()
        # x, weights (nibbles at 4 bits), the group's scale (+ corr) rows
        # (vec: every group's, and the (M,) group vector), bias, out
        nbytes = (M * K * esz + (K * N // 2 if int4 else K * N)
                  + (G if vec else 1) * nk * N * 4 * 2 + N * 4
                  + M * N * esz + (M * 4 if vec else 0))
        if fusion == "norm_mod":
            nbytes += 2 * B * K * esz + M * 4
        if fusion == "gate_residual":
            nbytes += B * N * 4 + M * N * esz + M * 4
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 2 * M * K * N * (2 if kern in MRQ else 1))
        log(f"  time {name} op={op}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, torch._int_mm {row['library_ms']:.4f}"
            f" ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def prologue_cases():
    """The prologue pass alone (``kernels/prologue.py::codes``) against its
    plain version at every int8 (bits 8 and 6) and packed-int4 serving
    shape, bf16 and f32 x, the scalar group and the slot pool's per-row
    vector, shift and scale as chunk views of the adaLN output where the
    linear norm-modulates: every code plane bit for bit."""
    import torch

    from repro_torch.kernels import prologue as P
    from repro_torch.kernels.ref import TOLERANCES
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    B, G, n_calls, n_bad = 8, 10, 0, 0
    cases = [(c, bits) for bits in (8, 6) for c in LINEAR_CASES] + \
        [(c, 4) for c in INT4_CASES]
    for (op, M, K, N, fusion, kern), bits in cases:
        mrq, half = kern in MRQ, 2 ** (bits - 1)
        rate = 1.0 + 0.1 * torch.rand(G, 1, device=dev, generator=gen)
        if mrq:
            s_a, s_b = rate * (0.2 / half), rate * (6.0 / half)
        else:
            s_a = rate * (8.0 / (2 * half - 1))
            s_b = torch.round(4.0 / s_a)
        width = {}
        if bits == 4:
            gk = min(256, -8 * (-K // 8))
            width = {"gk": gk, "gkp": -128 * (-gk // 128)}
        kw = dict(mrq=mrq, bits=bits, **width)
        if fusion == "norm_mod":
            ada = torch.randn(B, 6 * K, device=dev, generator=gen) * 0.1
            kw["bv"] = torch.arange(B, dtype=torch.int32, device=dev) \
                .repeat_interleave(M // B)
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(M, K, device=dev, generator=gen) * 2
            if mrq:
                x = torch.nn.functional.gelu(x, approximate="tanh")
            x = x.to(dt)
            if fusion == "norm_mod":
                kw["nm"] = torch.chunk(ada.to(dt), 6, dim=-1)[:2]
            for g in (3, slot_rows(M, dev) if M >= 8 else 3):
                out = P.codes(x, s_a, s_b, g, **kw)
                ref = P.codes_plain(x, s_a, s_b, g, **kw)
                n_bad += int((out != ref).sum())
                n_calls += 1
    torch.cuda.synchronize()
    key = "B1_norm_mod_vs_plain"
    log(f"prologue pass alone at every serving shape: {n_calls} calls, "
        f"{n_bad} codes differ from the plain version's (registry {key}: "
        f"{TOLERANCES[key][0]})")
    if n_bad:
        raise AssertionError(f"prologue pass: {n_bad} codes differ")


def flash_case(bits, dt, gen, timed, packed_kv=False, vec=False):
    import torch

    from repro_torch import kernels
    from repro_torch.kernels.ref import TOLERANCES
    FA = importlib.import_module("repro_torch.kernels.flash_attn_mrq")

    dev = torch.device("cuda")
    BH, S, D, G = 128, 256, 72, 10
    half = 2 ** (bits - 1)
    q = (torch.randn(BH, S, D, device=dev, generator=gen) * 1.5).to(dt)
    k = (torch.randn(BH, S, D, device=dev, generator=gen) * 1.5).to(dt)
    v = torch.randn(BH, S, D, device=dev, generator=gen).to(dt)
    rate = 1.0 + 0.1 * torch.rand(G, 1, device=dev, generator=gen)
    s_q = rate * (6.0 / (half - 1))
    s_k = s_q * 1.05
    qk = s_q * s_k * torch.tensor(D ** -0.5, dtype=torch.float32)
    s1 = torch.clamp(8.0 * (1.0 / S) / half * rate, 1.0 / (half * half * 8),
                     1.0 / half)
    s_v = rate * (4.0 / (half - 1))
    args = (q, k, v, s_q, s_k, qk, s1, s_v, s1 * s_v, s_v * (1.0 / half), 4, 6)
    kw = dict(bits=bits, packed_kv=packed_kv, out_dtype=dt)
    run = lambda: FA.flash_attn_mrq(*args, **kw)
    if vec:                    # per batch·head row: its slot's group
        gq = slot_rows(BH, dev)
        run = lambda: FA.flash_attn_mrq_vec(*args[:-2], gq, gq, **kw)
    out = run()
    with kernels.plain_on_cuda():
        ref = run()
    name = ("flash_attn_mrq" + ("_vec" if vec else "")
            + ("_packed_kv" if packed_kv else ""))
    if vec:
        check_vec_against_scalar(
            name, out, lambda v: FA.flash_attn_mrq_vec(*args[:-2], v, v, **kw),
            lambda h: FA.flash_attn_mrq(*args[:-2], h, h, **kw), gq, 4)
    elif packed_kv:                        # B3b == unpacked B3, bit for bit
        unpacked = FA.flash_attn_mrq(*args, bits=bits, out_dtype=dt)
        n_diff = int((out != unpacked).sum())
        log(f"kernel {name} vs unpacked flash_attn_mrq {str(dt)[6:]}: "
            f"{n_diff} differing outputs (registry B3b_vs_B3: "
            f"{TOLERANCES['B3b_vs_B3'][0]})")
        if n_diff:
            raise AssertionError(f"{name} differs from unpacked B3")
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    max_err, n_bad = float(err.max()), int((err > 0).sum())
    key = "vec_vs_plain" if vec else "B3_vs_plain"
    tol = TOLERANCES[key][0]
    log(f"kernel {name} BH={BH} S={S} hd={D} {str(dt)[6:]} "
        f"bits={bits}: max_abs_err={max_err} mismatches={n_bad}/"
        f"{out.numel()} (registry {key}: {tol})")
    if max_err > tol:
        raise AssertionError(f"{name} bits={bits} {dt}: max error "
                             f"{max_err} > {tol}")
    row = {"max_abs_err": max_err}
    if timed:
        row["ms"] = time_ms(run, 50)
        with kernels.plain_on_cuda():
            row["plain_ms"] = time_ms(run, 3, warmup=1)
        qb, kb, vb = (t.to(torch.bfloat16).reshape(8, 16, S, D)
                      for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = time_ms(lambda: sdpa(qb, kb, vb), 50)
        esz = q.element_size()
        # q, k, v, out; the group's 7 params (vec: every group's, and the
        # (2BH,) group vector)
        nbytes = (4 * BH * S * D * esz + 7 * 4 * (G if vec else 1)
                  + (2 * BH * 4 if vec else 0))
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 3 * 2 * BH * S * S * D,
            SOFTMAX_FP32_PER_SCORE * BH * S * S)
        log(f"  time {name} bits={bits}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, sdpa(bf16) {row['library_ms']:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


COMPOSED = ("int8_bmm_qk", "softmax_mrq_codes", "int8_bmm_pv")


def composed_case(bits, dt, gen, timed, vec=False):
    """B9a -> B10a -> B9b (vec: B9c -> B10b -> B9d) at the DiT-XL/2
    attention shapes, G = 10 at group 4 (vec: one group per slot), each
    kernel against its plain version on the same inputs (the kernel's own
    upstream output); the scalar chain also against B3 within the
    reference's flash-vs-composed contract; vec kernels also against the
    scalar ones. Returns {kernel: row}."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import int8_bmm as IB
    from repro_torch.kernels.ref import TOLERANCES, flash_vs_composed_atol
    FA = importlib.import_module("repro_torch.kernels.flash_attn_mrq")
    SM = importlib.import_module("repro_torch.kernels.softmax_mrq")

    dev = torch.device("cuda")
    BH, S, D, G, g = 128, 256, 72, 10, 4
    half = 2 ** (bits - 1)
    q = (torch.randn(BH, S, D, device=dev, generator=gen) * 1.5).to(dt)
    k = (torch.randn(BH, S, D, device=dev, generator=gen) * 1.5).to(dt)
    v = torch.randn(BH, S, D, device=dev, generator=gen).to(dt)
    rate = 1.0 + 0.1 * torch.rand(G, 1, device=dev, generator=gen)
    s_q = rate * (6.0 / (half - 1))
    s_k = s_q * 1.05
    qk = (s_q, s_k, s_q * s_k * torch.tensor(D ** -0.5, dtype=torch.float32))
    s1 = torch.clamp(8.0 * (1.0 / S) / half * rate, 1.0 / (half * half * 8),
                     1.0 / half)
    s_v = rate * (4.0 / (half - 1))
    pv = (s_v, s1 * s_v, s_v * (1.0 / half))
    grp = slot_rows(BH, dev) if vec else g
    sfx = "_vec" if vec else ""
    fns = ({"int8_bmm_qk": IB.int8_bmm_qk_vec,
            "softmax_mrq_codes": SM.softmax_mrq_codes_vec,
            "int8_bmm_pv": IB.int8_bmm_pv_vec} if vec else
           {"int8_bmm_qk": IB.int8_bmm_qk,
            "softmax_mrq_codes": SM.softmax_mrq_codes,
            "int8_bmm_pv": IB.int8_bmm_pv})
    scalar = {"int8_bmm_qk": IB.int8_bmm_qk,
              "softmax_mrq_codes": SM.softmax_mrq_codes,
              "int8_bmm_pv": IB.int8_bmm_pv}
    scores = codes = None
    call = {"int8_bmm_qk": lambda f, h: f(q, k, *qk, h, bits=bits),
            "softmax_mrq_codes": lambda f, h: f(scores, s1, h, bits=bits),
            "int8_bmm_pv": lambda f, h: f(codes, v, *pv, h, bits=bits,
                                          out_dtype=dt)}
    rows, outs = {}, {}
    for kern in COMPOSED:
        run = lambda: call[kern](fns[kern], grp)
        out = run()
        with kernels.plain_on_cuda():
            ref = run()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        max_err, n_bad = float(err.max()), int((err > 0).sum())
        key = "vec_vs_plain" if vec else (
            "B10_vs_plain" if kern == "softmax_mrq_codes" else "B9_vs_plain")
        tol = TOLERANCES[key][0]
        log(f"kernel {kern}{sfx} BH={BH} S={S} hd={D} {str(dt)[6:]} "
            f"bits={bits}: max_abs_err={max_err} mismatches={n_bad}/"
            f"{out.numel()} (registry {key}: {tol})")
        if max_err > tol:
            raise AssertionError(f"{kern}{sfx} bits={bits} {dt}: max error "
                                 f"{max_err} > {tol}")
        if vec:
            check_vec_against_scalar(
                kern + sfx, out, lambda gv: call[kern](fns[kern], gv),
                lambda h: call[kern](scalar[kern], h), grp, g)
        rows[kern + sfx] = row = {"max_abs_err": max_err}
        outs[kern] = out
        if kern == "int8_bmm_qk":
            scores = out
        elif kern == "softmax_mrq_codes":
            codes = out
        if timed:
            row["ms"] = time_ms(run, 50)
            with kernels.plain_on_cuda():
                row["plain_ms"] = time_ms(run, 3, warmup=1)
            esz, nv = q.element_size(), (BH * 4 + 3 * 4 * G if vec else 12)
            sc = BH * S * S
            if kern == "int8_bmm_qk":
                qb, kb = (t.to(torch.bfloat16) for t in (q, k))
                lib = lambda: torch.bmm(qb, kb.transpose(1, 2))
                nbytes, i8, f32 = 2 * BH * S * D * esz + sc * 4 + nv, \
                    2 * sc * D, 0
            elif kern == "softmax_mrq_codes":
                lib = lambda: torch.softmax(scores, dim=-1)
                nbytes, i8, f32 = sc * 4 + sc + nv, 0, \
                    CODES_FP32_PER_SCORE * sc
            else:
                pb = torch.rand(BH, S, S, device=dev, generator=gen).to(
                    torch.bfloat16)
                vb = v.to(torch.bfloat16)
                lib = lambda: torch.bmm(pb, vb)
                nbytes, i8, f32 = sc + 2 * BH * S * D * esz + nv, \
                    2 * 2 * sc * D, 0
            row["library_ms"] = time_ms(lib, 50)
            row["bound_ms"], row["bound_by"] = bound(nbytes, i8, f32)
            log(f"  time {kern}{sfx} bits={bits}: kernel {row['ms']:.4f} ms, "
                f"plain {row['plain_ms']:.4f} ms, library "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})")
    if not vec:                            # the chain against flash (B3)
        flash = FA.flash_attn_mrq(q, k, v, *qk, s1, *pv, g, g, bits=bits,
                                  packed_kv=bits == 4, out_dtype=dt)
        atol = flash_vs_composed_atol({"s_v": s_v}, g, S, bits)
        diff = float((outs["int8_bmm_pv"].float() - flash.float()).abs().max())
        log(f"composed chain vs flash_attn_mrq bits={bits} {str(dt)[6:]}: "
            f"max |diff| {diff:.6f} (flash_vs_composed_atol {atol:.6f})")
        if not diff <= atol:
            raise AssertionError(f"composed vs flash bits={bits}: {diff} > "
                                 f"{atol}")
    return rows


# -- the public kernel API: B11, B12, B13 and flash's boolean mask ----------
B11_CASES = [  # (op, M, K, N): the serving linears' codes, and a ragged one
    ("qkv", 2048, 1152, 3456), ("fc2", 2048, 4608, 1152),
    ("ragged", 130, 257, 129)]


def check_plain(name, out, ref, key, what):
    """A kernel's output against its plain version's: max error and
    mismatches, fatal above the registry's bound."""
    from repro_torch.kernels.ref import TOLERANCES
    err = (out.float() - ref.float()).abs()
    max_err, n_bad = float(err.max()), int((err > 0).sum())
    tol = TOLERANCES[key][0]
    log(f"kernel {name} {what}: max_abs_err={max_err} mismatches={n_bad}/"
        f"{err.numel()} (registry {key}: {tol})")
    if max_err > tol:
        raise AssertionError(f"{name} {what}: max error {max_err} > {tol}")
    return max_err


def bit_mismatches(out, ref):
    """Outputs whose bits differ from the plain version's (signed zeros
    included, a NaN equal to a NaN); every output if dtype or shape do."""
    import torch
    if out.dtype != ref.dtype or out.shape != ref.shape:
        return out.numel()
    iv = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[out.dtype]
    nan = torch.isnan(out) & torch.isnan(ref)
    return int(((out.view(iv) != ref.view(iv)) & ~nan).sum())


def timed_row(run, plain_reps, lib, nbytes, i8_ops, f32_ops, name, what,
              lib_name):
    """Kernel, plain-version and library-call times (CUDA events) beside
    the bound."""
    from repro_torch import kernels
    row = {"ms": time_ms(run, 50)}
    with kernels.plain_on_cuda():
        row["plain_ms"] = time_ms(run, plain_reps, warmup=1)
    row["library_ms"] = time_ms(lib, 50)
    row["bound_ms"], row["bound_by"] = bound(nbytes, i8_ops, f32_ops)
    log(f"  time {name} {what}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, {lib_name} {row['library_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def int8_matmul_case(op, M, K, N, with_bias, dt, gen, timed):
    """B11 on the caller's codes against its plain version; timed with
    ``torch._int_mm`` plus the same epilogue as the library call."""
    import torch

    from repro_torch import kernels
    dev = torch.device("cuda")
    xq = torch.randint(-128, 128, (M, K), device=dev, generator=gen,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (K, N), device=dev, generator=gen,
                       dtype=torch.int8)
    scale = torch.rand(N, device=dev, generator=gen) * 1e-3 + 1e-4
    corr = 3 * wq.to(torch.int32).sum(0, dtype=torch.int32)
    bias = torch.randn(N, device=dev, generator=gen) if with_bias else None
    run = lambda: kernels.int8_matmul(xq, wq, scale, corr, bias,
                                      out_dtype=dt)
    out = run()
    with kernels.plain_on_cuda():
        ref = run()
    torch.cuda.synchronize()
    what = (f"op={op} M={M} K={K} N={N} {'bias' if with_bias else 'no bias'}"
            f" out {str(dt)[6:]}")
    row = {"max_abs_err": check_plain("int8_matmul", out, ref,
                                      "B11_vs_plain", what)}
    if timed:
        def lib():
            acc = torch._int_mm(xq, wq)
            y = (acc - corr).float() * scale
            return (y + bias if with_bias else y).to(dt)
        nbytes = M * K + K * N + 3 * N * 4 + M * N * out.element_size()
        row.update(timed_row(run, 5, lib, nbytes, 2 * M * K * N, 0,
                             "int8_matmul", what,
                             "torch._int_mm + epilogue"))
        device_row(row, run, "int8_matmul", what)
    return row


def device_row(row, run, name, what):
    """The row's ms becomes the call's device time (the profiler's kernel
    durations over 30 calls); its wrapper time (CUDA events, the host's
    enqueue included) stays beside it as wrapper_ms."""
    from repro_torch.launch.gemm_times import device_ms
    row["wrapper_ms"], row["ms"] = row["ms"], sum(device_ms(run, 30).values())
    log(f"  device time {name} {what}: {row['ms']:.4f} ms (wrapper "
        f"{row['wrapper_ms']:.4f} ms)")


def softmax_mrq_case(dt, out_dt, bits, gen, timed):
    """B12 on DiT-XL/2's (B*H*Sq, Skv) = (32768, 256) scores against its
    plain version; ``torch.softmax`` is the library call."""
    import torch

    from repro_torch import kernels
    dev = torch.device("cuda")
    half = 2 ** (bits - 1)
    R, C = 8 * 16 * 256, 256
    scores = (torch.randn(R, C, device=dev, generator=gen) * 4).to(dt)
    s1 = torch.tensor(8.0 / C / half, device=dev)
    run = lambda: kernels.softmax_mrq(scores, s1, bits=bits,
                                      out_dtype=out_dt)
    out = run()
    with kernels.plain_on_cuda():
        ref = run()
    torch.cuda.synchronize()
    what = f"R={R} C={C} {str(dt)[6:]} -> {str(out_dt)[6:]} bits={bits}"
    row = {"max_abs_err": check_plain("softmax_mrq", out, ref,
                                      "B12_vs_plain", what)}
    if timed:
        nbytes = R * C * (scores.element_size() + out.element_size()) + 4
        row.update(timed_row(run, 3, lambda: torch.softmax(scores, dim=-1),
                             nbytes, 0, QDQ_FP32_PER_SCORE * R * C,
                             "softmax_mrq", what, "torch.softmax"))
        device_row(row, run, "softmax_mrq", what)
    return row


ACT_CASES = [  # (kind, shape): fc1's output into the GELU; the adaLN input
    ("gelu", (2048, 4608)), ("silu", (8, 1152))]


def act_mrq_case(kind, shape, dt, bits, gen, timed):
    """B13 against its plain version, bit for bit;
    ``F.gelu(approximate="tanh")`` / ``F.silu`` are the library calls (in
    the kernels line: their device time)."""
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels
    dev = torch.device("cuda")
    half = 2 ** (bits - 1)
    x = (torch.randn(shape, device=dev, generator=gen) * 3).to(dt)
    sn = torch.tensor(0.17 / half, device=dev)
    sp = torch.tensor(6.0 / half, device=dev)
    run = lambda: kernels.act_mrq(x, sn, sp, bits=bits, kind=kind,
                                  out_dtype=dt)
    out = run()
    with kernels.plain_on_cuda():
        ref = run()
    torch.cuda.synchronize()
    what = f"{kind} {shape} {str(dt)[6:]} bits={bits}"
    row = {"max_abs_err": check_plain("act_mrq", out, ref, "B13_vs_plain",
                                      what)}
    n_bits = bit_mismatches(out, ref)
    log(f"  bits act_mrq {what}: {n_bits} outputs differ from the plain "
        "version's in their bits (signed zeros included, NaN as NaN)")
    if n_bits:
        raise AssertionError(f"act_mrq {what}: {n_bits} outputs differ in "
                             "their bits")
    if timed:
        from repro_torch.launch.gemm_times import device_ms
        lib = ((lambda: F.gelu(x, approximate="tanh")) if kind == "gelu"
               else (lambda: F.silu(x)))
        n = x.numel()
        row.update(timed_row(run, 5, lib, 2 * n * x.element_size() + 8, 0,
                             GELU_MRQ_FP32_PER_ELEM * n, "act_mrq", what,
                             f"F.{kind}"))
        device_row(row, run, "act_mrq", what)
        row["library_ms"] = sum(device_ms(lib, 30).values())
        log(f"  device time F.{kind} {what}: {row['library_ms']:.4f} ms")
    return row


MASK_CASES = [  # (mask, Sq, Skv, rep): DiT-XL/2's attention; ragged; GQA
    ("causal", 256, 256, 1), ("random", 256, 256, 1),
    ("padding", 77, 77, 1), ("causal", 256, 256, 2)]


def attn_mask(kind, B, M, N, gen):
    """(B, M, N) boolean, True = attend: causal; random at 1/2 with every
    fourth row fully masked; or padding (the last N // 4 keys left out)."""
    import torch
    dev = torch.device("cuda")
    if kind == "causal":
        return torch.ones(M, N, dtype=torch.bool, device=dev).tril().expand(
            B, M, N)
    if kind == "random":
        m = torch.rand(B, M, N, device=dev, generator=gen) < 0.5
        m[:, ::4] = False
        return m
    return (torch.arange(N, device=dev) < N - N // 4).expand(B, M, N)


def masked_flash_case(kind, Sq, Skv, rep, bits, vec, gen, timed):
    """Masked B3 (bits 8), B3b (bits 4, packed kv) or B8 (``vec``, per-row
    groups) against its plain version, bit for bit, and within the
    reference's flash_vs_composed_atol of the masked composed chain (B9a,
    scores set to NEG_INF where masked, B10a, B9b; their vec siblings for
    B8). Returns (kernel name, row)."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import int8_bmm as IB
    from repro_torch.kernels import ref as R
    FA = importlib.import_module("repro_torch.kernels.flash_attn_mrq")
    SM = importlib.import_module("repro_torch.kernels.softmax_mrq")

    dev = torch.device("cuda")
    BH, D, G, g = 128, 72, 10, 4
    dt = torch.bfloat16
    half = 2 ** (bits - 1)
    q = (torch.randn(BH, Sq, D, device=dev, generator=gen) * 1.5).to(dt)
    k, v = ((torch.randn(BH // rep, Skv, D, device=dev, generator=gen)
             * 1.5).to(dt) for _ in "kv")
    rate = 1.0 + 0.1 * torch.rand(G, 1, device=dev, generator=gen)
    s_q = rate * (6.0 / (half - 1))
    qk = (s_q, s_q * 1.05, s_q * s_q * 1.05 * torch.tensor(
        D ** -0.5, dtype=torch.float32))
    s1 = torch.clamp(8.0 * (1.0 / Skv) / half * rate,
                     1.0 / (half * half * 8), 1.0 / half)
    s_v = rate * (4.0 / (half - 1))
    pv = (s_v, s1 * s_v, s_v * (1.0 / half))
    mask = attn_mask(kind, BH, Sq, Skv, gen)
    kw = dict(mask=mask, bits=bits, packed_kv=bits == 4, out_dtype=dt)
    grp = slot_rows(BH, dev) if vec else g
    if vec:
        run = lambda: FA.flash_attn_mrq_vec(q, k, v, *qk, s1, *pv, grp, grp,
                                            **kw)
    else:
        run = lambda: FA.flash_attn_mrq(q, k, v, *qk, s1, *pv, g, g, **kw)
    name = ("flash_attn_mrq" + ("_vec" if vec else "")
            + ("_packed_kv" if bits == 4 else ""))
    out = run()
    with kernels.plain_on_cuda():
        ref = run()
    torch.cuda.synchronize()
    what = (f"{kind} mask BH={BH} Sq={Sq} Skv={Skv} rep={rep} hd={D} bf16 "
            f"bits={bits}")
    row = {"max_abs_err": check_plain(name, out, ref, "B3_mask_vs_plain",
                                      what)}
    if vec:
        scores = IB.int8_bmm_qk_vec(q, k, *qk, grp, bits=bits)
        scores = torch.where(mask, scores, R.NEG_INF)
        codes = SM.softmax_mrq_codes_vec(scores, s1, grp, bits=bits)
        comp = IB.int8_bmm_pv_vec(codes, v, *pv, grp, bits=bits,
                                  out_dtype=dt)
        atol = max(R.flash_vs_composed_atol({"s_v": s_v}, h, Skv, bits)
                   for h in set(SLOT_GROUPS))
    else:
        scores = torch.where(mask, IB.int8_bmm_qk(q, k, *qk, g, bits=bits),
                             R.NEG_INF)
        codes = SM.softmax_mrq_codes(scores, s1, g, bits=bits)
        comp = IB.int8_bmm_pv(codes, v, *pv, g, bits=bits, out_dtype=dt)
        atol = R.flash_vs_composed_atol({"s_v": s_v}, g, Skv, bits)
    diff = float((out.float() - comp.float()).abs().max())
    log(f"  {name} {kind} mask vs the masked composed chain: max |diff| "
        f"{diff:.6f} (flash_vs_composed_atol {atol:.6f})")
    if not diff <= atol:
        raise AssertionError(f"{name} {what}: {diff} > {atol} from composed")
    if timed:
        row["masked_ms"] = time_ms(run, 50)
        log(f"  time {name} {what}: kernel {row['masked_ms']:.4f} ms")
    return name, row


MASKED_MS = {}     # kernel -> masked (causal) time at bits 8, this run


def phase_kernels():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for dt in (torch.bfloat16, torch.float32):
        bf16 = dt == torch.bfloat16
        for bits in (8, 6):
            timed_pass = bf16 and bits == 8
            for op, M, K, N, fusion, kern in LINEAR_CASES:
                r = linear_case(op, M, K, N, fusion, kern, bits, dt, gen,
                                timed_pass and TIMED[kern] == op)
                rows.setdefault(kern, []).append(r)
                r = linear_case(op, M, K, N, fusion, kern, bits, dt, gen,
                                False, vec=True)
                rows.setdefault(kern + "_vec", []).append(r)
            rows.setdefault("flash_attn_mrq", []).append(
                flash_case(bits, dt, gen, timed_pass))
        for op, M, K, N, fusion, kern in INT4_CASES:
            for fused in dict.fromkeys((fusion, "")):
                r = linear_case(op, M, K, N, fused, kern, 4, dt, gen,
                                bf16 and fused and TIMED[kern] == op)
                rows.setdefault(kern, []).append(r)
        # B3 unpacked at 4 bits (timed beside B3b; its row keeps bits 8)
        b3_4bit = flash_case(4, dt, gen, bf16)
        if bf16:
            log(f"flash_attn_mrq bits=4 (unpacked): {b3_4bit['ms']:.4f} ms")
        rows["flash_attn_mrq"].append({"max_abs_err": b3_4bit["max_abs_err"]})
        rows.setdefault("flash_attn_mrq_packed_kv", []).append(
            flash_case(4, dt, gen, bf16, packed_kv=True))
    # the per-row-group kernels of the continuous-batching path, bf16 (the
    # int4 ones in f32 too)
    for op, M, K, N, fusion, kern, bits in VEC_CASES:
        for dt in ((torch.bfloat16, torch.float32) if bits == 4
                   else (torch.bfloat16,)):
            rows.setdefault(kern + "_vec", []).append(linear_case(
                op, M, K, N, fusion, kern, bits, dt, gen,
                dt == torch.bfloat16, vec=True))
    rows["flash_attn_mrq_vec"] = [flash_case(8, torch.bfloat16, gen, True,
                                             vec=True)]
    rows["flash_attn_mrq_vec_packed_kv"] = [flash_case(
        4, torch.bfloat16, gen, True, packed_kv=True, vec=True)]
    # the composed attention chain (B9a, B10a, B9b) and its per-row-group
    # siblings (B9c, B10b, B9d); timed at bits 8, bf16
    for bits in (8, 6, 4):
        for vec in (False, True):
            for name, r in composed_case(bits, torch.bfloat16, gen,
                                         bits == 8, vec=vec).items():
                rows.setdefault(name, []).append(r)
    for name, r in composed_case(8, torch.float32, gen, False).items():
        rows[name].append(r)
    # the public kernel API: B11, B12, B13 and the masked flash kernels
    for op, M, K, N in B11_CASES:
        for dt in (torch.float32, torch.bfloat16):
            for with_bias in (True, False):
                rows.setdefault("int8_matmul", []).append(int8_matmul_case(
                    op, M, K, N, with_bias, dt, gen,
                    (op, dt, with_bias) == ("qkv", torch.float32, True)))
    for dt in (torch.float32, torch.bfloat16):
        for bits in (8, 6):
            rows.setdefault("softmax_mrq", []).append(softmax_mrq_case(
                dt, dt, bits, gen, (dt, bits) == (torch.float32, 8)))
    rows["softmax_mrq"].append(softmax_mrq_case(
        torch.bfloat16, torch.float32, 8, gen, False))
    for kind, shape in ACT_CASES:
        for dt in (torch.bfloat16, torch.float32):
            for bits in (8, 6):
                rows.setdefault("act_mrq", []).append(act_mrq_case(
                    kind, shape, dt, bits, gen,
                    (kind, dt, bits) == ("gelu", torch.bfloat16, 8)))
    for kind, Sq, Skv, rep in MASK_CASES:
        for bits, vec in ((8, False), (4, False), (8, True), (4, True)):
            timed = (kind, rep, bits) == ("causal", 1, 8)
            name, r = masked_flash_case(kind, Sq, Skv, rep, bits, vec, gen,
                                        timed)
            rows[name].append({"max_abs_err": r["max_abs_err"]})
            if timed:
                MASKED_MS[name] = r["masked_ms"]
    merged = {}
    for name, rs in rows.items():
        m = next(r for r in rs if "ms" in r).copy()
        m["max_abs_err"] = max(r["max_abs_err"] for r in rs)
        merged[name] = m
    return merged


GEMM_TIMED = {f"{w}_matmul{m}_fq{v}": "fc2" if m else "qkv"
              for w in ("int8", "int4") for m in ("", "_mrq")
              for v in ("", "_vec")}


def phase_gemm_device(rows):
    """The GEMMs' calls at every serving shape, bf16, in device time: the
    int8 family at bits 8 (B1; B2 at fc2; B6a/B6b at qkv and fc2) and the
    packed-int4 family (B4; B5 at fc2; B7a/B7b at qkv and fc2): the
    profiler's kernel durations over 30 calls, quantize pass and GEMM
    apart, beside the wrapper time (CUDA events, host included) and the
    call's bound. The kernels line's ms for these eight kernels is the
    device time at qkv (fc2 for the MRQ ones)."""
    from repro_torch.launch import gemm_times
    table = []
    for int4, what in ((False, "int8 GEMM (bf16, bits 8)"),
                       (True, "int4 GEMM (bf16, W4A4)")):
        log(f"{what} per serving shape, device time per call (quantize: "
            "the prologue pass, with the layernorm statistics):")
        table += gemm_times.time_shapes(reps=30, vec=True, log=log,
                                        int4=int4)
    stats = [r for r in table
             if r["fusion"] == "norm_mod" and r["other_ms"] > 5e-4]
    if stats:
        raise AssertionError("norm-modulated linears launch work besides "
                             f"the pass and the GEMM: {stats}")
    for r in table:
        if GEMM_TIMED.get(r["kernel"]) == r["op"]:
            row = rows[r["kernel"]]
            row["wrapper_ms"], row["ms"] = row["ms"], r["device_ms"]
            row["bound_ms"], row["bound_by"] = r["bound_ms"], r["bound_by"]
    return table


ATTN_TIMED = {"flash_attn_mrq": "B3 bits 8",
              "flash_attn_mrq_packed_kv": "B3b bits 4 packed kv",
              "flash_attn_mrq_vec": "B8 bits 8",
              "flash_attn_mrq_vec_packed_kv": "B8 bits 4 packed kv"}


def phase_attn_device(rows):
    """One attention call at the serving shape through
    ``ops.flash_attention`` on the qkv views (``launch/attn_times.py``):
    device time by the profiler over 30 calls, launches per call (the
    wrappers' counts and the profiler's kernel events, fatal unless 1 and
    the flash kernel's), bound and SDPA on the same bf16 q, k, v; the kernels line's ms for B3, B3b
    and B8 is that device time (their wrapper time, CUDA events on the
    public entry point, stays beside it), and the causal-masked call is
    shown beside the unmasked one."""
    from repro_torch.launch import attn_times
    log("attention call (ops.flash_attention on the (8, 256, 3, 16, 72) "
        "bf16 qkv views), device time per call:")
    table = {r["case"]: r for r in attn_times.time_cases(reps=30, log=log)}
    for name, case in ATTN_TIMED.items():
        r = table[case]
        if (r["launches"] != 1 or r["events"] != 1
                or any("flash_kernel" not in k for k in r["by_kernel"])):
            raise AssertionError(f"{case}: {r['launches']} launches and "
                                 f"{r['events']} kernel events a call, "
                                 f"kernels {sorted(r['by_kernel'])}")
        row = rows[name]
        row["wrapper_ms"], row["ms"] = row["ms"], r["device_ms"]
        row["bound_ms"], row["bound_by"] = r["bound_ms"], r["bound_by"]
        row["library_ms"] = r["sdpa_ms"]
    masked = table["B3 bits 8 causal mask"]
    log(f"masked B3 (causal, bits 8): device {masked['device_ms']:.4f} ms "
        f"in {masked['events']:.2f} kernel events, of which the kernel "
        + ", ".join(f"{k} {v:.4f}" for k, v in masked["by_kernel"].items()
                    if "flash_kernel" in k)
        + f"; unmasked {table['B3 bits 8']['device_ms']:.4f} ms")
    return table


COMPOSED_TIMED = {"composed bits 8": ("int8_bmm_qk", "softmax_mrq_codes",
                                       "int8_bmm_pv"),
                  "composed vec bits 8": ("int8_bmm_qk_vec",
                                          "softmax_mrq_codes_vec",
                                          "int8_bmm_pv_vec")}


def phase_composed_device(rows):
    """One composed attention call at the serving shape through
    ``ops.int8_attention`` on the qkv views (``launch/attn_times.py
    --composed``): device time by kernel over 30 calls, launches per call
    (the wrappers' counts and the profiler's kernel events, fatal unless
    3: B9a, B10a, B9b or their vec siblings, no code pass and no torch
    copy), each kernel's bound; the kernels line's ms for
    B9a-d and B10a-b is that device time (their wrapper time, CUDA events
    on the public entry point alone, stays beside it as wrapper_ms)."""
    from repro_torch.launch import attn_times
    log("composed attention call (ops.int8_attention on the (8, 256, 3, "
        "16, 72) bf16 qkv views), device time per call:")
    table = {r["case"]: r for r in attn_times.time_composed(reps=30, log=log)}
    for case, r in table.items():
        parts = set(r["by_part"])
        if (r["launches"] != 3 or r["events"] != 3
                or parts != {"qk", "softmax", "pv"}):
            raise AssertionError(f"{case}: {r['launches']} launches and "
                                 f"{r['events']} kernel events a call, "
                                 f"parts {sorted(parts)}")
    for case, names in COMPOSED_TIMED.items():
        r = table[case]
        for name, part in zip(names, ("qk", "softmax", "pv")):
            row = rows[name]
            row["wrapper_ms"], row["ms"] = row["ms"], r["by_part"][part]
            row["bound_ms"], row["bound_by"] = r["bounds"][part]
    return table


# ---------------------------------------------------------------------------
# phase 3: trained checkpoint, quantized vs fp drift at each width
# ---------------------------------------------------------------------------
WIDTHS = ("w8a8", "w6a6", "w4a4")
# The W8A8 figure since the prologue pass computes the layernorm statistics
# in its own order (0.010361 before, with torch's): on this checkpoint 173
# of 106,496,000 norm-modulated codes move, each a .5-boundary flip
# (python src/repro_torch/launch/stats_flips.py).
W8A8_DRIFT = 0.010440
TRAINED_ARTS = {}      # (method, width) -> the artifacts of phases 3, 3b


def trained_setup():
    """The trained 6-layer checkpoint on the card, its DiT and diffusion
    configs, schedule, and the 8 requests (50 steps) phases 3 and 3b
    serve."""
    from repro_torch.diffusion.ddpm import DiffusionCfg, make_schedule
    from repro_torch.models.dit import DiTCfg, params_from_numpy
    from repro_torch.serving.batching import GenRequest

    cfg = DiTCfg(img_size=16, in_ch=4, patch=2, d_model=160, n_layers=6,
                 n_heads=4, n_classes=8)
    dif = DiffusionCfg(T=1000, tgq_groups=10)
    with open(os.path.join(ROOT, "experiments", "dit_bench_450.pkl"),
              "rb") as f:
        params = params_from_numpy(pickle.load(f), device="cuda")
    reqs = [GenRequest(request_id=i, label=i % 8, steps=50, seed=100 + i)
            for i in range(8)]
    return cfg, dif, params, make_schedule(dif), reqs


def serve_trained(setup, name, ctx):
    """The 8 requests served under ``ctx`` (None: fp); finite samples."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.serving.engine import ServeEngine

    cfg, dif, params, sched, reqs = setup
    eng = ServeEngine(params, cfg, dif, sched, ctx=ctx, microbatch=4,
                      step_buckets=(50,), device="cuda")
    before = dict(kernels.LAUNCHES)
    res = eng.serve(reqs)
    out = np.stack([res[i].sample for i in range(8)])
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    log(f"trained {name}: launches {launched}")
    if not np.isfinite(out).all():
        raise AssertionError(f"non-finite trained-checkpoint {name} samples")
    return out


def drift(fp, q) -> float:
    import numpy as np
    return float(np.abs(fp - q).mean() / np.abs(fp).mean())


def phase_trained():
    from repro_torch.quant.api import quantize
    from repro_torch.quant.recipe import QuantRecipe

    setup = trained_setup()
    cfg, dif, params, sched, _ = setup
    fp = serve_trained(setup, "fp", None)
    drifts = {}
    for bits in WIDTHS:
        art = quantize(params, cfg, dif, QuantRecipe(bits=bits), sched=sched)
        if art.fallback_ops():
            raise AssertionError(f"{bits} fallback ops: {art.fallback_ops()}")
        TRAINED_ARTS["range", bits] = art
        drifts[bits] = drift(fp, serve_trained(setup, bits, art.context()))
    for bits, d in drifts.items():
        log(f"trained checkpoint (d=160, 6 layers, 50 steps, 8 requests): "
            f"{bits.upper()} vs FP drift = {d:.6f} (mean|fp-q| / mean|fp|)")
    if round(drifts["w8a8"], 6) != W8A8_DRIFT:
        raise AssertionError(f"W8A8 drift {drifts['w8a8']} moved from "
                             f"{W8A8_DRIFT}")
    return drifts, setup, fp


# ---------------------------------------------------------------------------
# phase 3b: the paper's HO calibration on the trained checkpoint
# ---------------------------------------------------------------------------
HO_KNOBS = {"method": "ho", "n_alpha": 8, "rounds": 2}   # --calib ho's


def phase_trained_ho(setup, fp, range_drifts):
    """HO-calibrate the trained checkpoint at each width with the
    launcher's knobs (no fake-quant fallback, finite samples), print each
    drift beside range's and the calibration seconds; a second W8A8 HO
    calibration must give the same content hash (the search is
    deterministic on the card)."""
    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.quant.api import quantize
    from repro_torch.quant.recipe import QuantRecipe

    cfg, dif, params, sched, _ = setup
    out, hashes = {}, []
    for bits in WIDTHS + ("w8a8",):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        art = quantize(params, cfg, dif, QuantRecipe(bits=bits, **HO_KNOBS),
                       sched=sched)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if art.fallback_ops():
            raise AssertionError(f"HO {bits} fallback ops: "
                                 f"{art.fallback_ops()}")
        if bits == "w8a8":
            hashes.append(ckpt.content_hash(art.qparams)["digest"])
            if len(hashes) == 2:
                log(f"trained checkpoint HO W8A8 again: calibration "
                    f"{secs:.2f} s, content hash {hashes[1]} (first "
                    f"{hashes[0]})")
                if hashes[0] != hashes[1]:
                    raise AssertionError("a second W8A8 HO calibration "
                                         "gave another content hash")
                break
        TRAINED_ARTS["ho", bits] = art
        d = drift(fp, serve_trained(setup, f"HO {bits}", art.context()))
        if d != d:
            raise AssertionError(f"HO {bits} drift is not finite")
        out[bits] = (d, secs)
        log(f"trained checkpoint HO {bits.upper()} (n_alpha 8, rounds 2, "
            f"10 batches of 4): calibration {secs:.2f} s, vs FP drift = "
            f"{d:.6f} (range {range_drifts[bits]:.6f}); "
            f"{art.meta['calib']}")
    return out


# ---------------------------------------------------------------------------
# phase 4: DiT-XL/2 at full width through the launcher's path
# ---------------------------------------------------------------------------
def serve_width(bits):
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.launch.serve import build

    requests, microbatch, steps = 8, 4, 20
    t0 = time.perf_counter()
    cfg, params, art, engine, sq, info = build(
        "dit-xl-2", False, bits, 0, requests, microbatch, steps, 1.5,
        device="cuda")
    log(f"full width {bits}: range calibration {info['calib_s']:.2f} s; "
        f"{art.summary()}")
    RANGE_CALIB_S[bits] = info["calib_s"]
    if art.fallback_ops():
        raise AssertionError(f"{bits} fallback ops: {art.fallback_ops()}")
    reqs = list(sq.pending)
    torch.cuda.synchronize()
    kernels.reset_launches()               # the main path's run starts here
    t1 = time.perf_counter()
    results = sq.run(engine)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)      # ... and ends here
    samples = np.stack([results[r].sample for r in sorted(results)])
    want_shape = (requests, cfg.img_size, cfg.img_size, cfg.in_ch)
    if samples.shape != want_shape or not np.isfinite(samples).all():
        raise AssertionError(f"bad {bits} samples {samples.shape}")
    forwards = engine.stats["microbatches"] * steps
    want = {k: 0 for k in launches}
    want.update({k: n * forwards for k, n in art.packed_counts().items()})
    log(f"full width {bits}: packed per forward {art.packed_counts()}, "
        f"forwards {forwards}, launches {launches}")
    if launches != want:
        raise AssertionError(f"{bits} launch counts {launches} != packed x "
                             f"forwards {want}")
    log(f"full width {bits}: served {requests} requests x {steps} steps "
        f"(cfg 1.5, microbatch {microbatch}) in {dt:.3f} s: "
        f"{requests / dt:.4f} req/s, "
        f"{dt / forwards * 1e3:.3f} ms/step (2B={2 * microbatch} forward); "
        f"setup+calib {t1 - t0:.1f} s; sample mean {samples.mean():.5f} "
        f"std {samples.std():.5f}")
    TIMES[(bits, "flash", "sync 8x20")] = (dt / forwards * 1e3,
                                           requests / dt)
    forward_vs_plain(bits, cfg, params, art.context())
    flash_forward_kernels(bits, cfg, params, art.context())
    return launches, cfg, params, art, reqs, samples


def forward_vs_plain(bits, cfg, params, ctx, batch=8):
    """One full-width forward of ``batch`` rows (8: the serving 2B; the
    research sampler's 64 rows of the trained checkpoint, 4,096 token
    rows, and 32 of DiT-XL/2, 8,192) on the kernels against the same
    forward on the plain versions, on the card."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels.ref import TOLERANCES
    from repro_torch.models.dit import dit_apply

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(batch, cfg.img_size, cfg.img_size, cfg.in_ch,
                    device="cuda", generator=gen)
    t = torch.full((batch,), 500, dtype=torch.int64, device="cuda")
    y = torch.arange(batch, device="cuda") % cfg.n_classes
    ctx = ctx.with_tgroup(5)
    with torch.no_grad():
        out_k = dit_apply(params, cfg, x, t, y, ctx=ctx).float()
        with kernels.plain_on_cuda():
            out_p = dit_apply(params, cfg, x, t, y, ctx=ctx).float()
    rel = float((out_k - out_p).norm() / out_p.norm())
    tol = TOLERANCES["dit_forward_kernel_vs_plain_rel"][0]
    log(f"full width {bits} {ctx.attn_impl} forward ({batch} rows x "
        f"{cfg.n_tokens} tokens), kernels vs plain versions on the card: "
        f"rel L2 {rel:.3e} (registry {tol})")
    if not rel <= tol:
        raise AssertionError(f"{bits} {ctx.attn_impl} forward rel error "
                             f"{rel} > {tol}")


def flash_forward_kernels(bits, cfg, params, ctx):
    """One full-width flash forward under the profiler
    (``gemm_times.kernel_events``, which profiles again where the profiler
    lost events): one flash launch per block (the wrappers' counts) and no
    codes_kernel among the profiler's kernel events (q, k and v are
    quantized inside the flash kernel, read from the qkv views)."""
    import torch

    from repro_torch.launch.gemm_times import kernel_events
    from repro_torch.models.dit import dit_apply
    x = torch.zeros(8, cfg.img_size, cfg.img_size, cfg.in_ch, device="cuda")
    t = torch.full((8,), 500, dtype=torch.int64, device="cuda")
    y = torch.arange(8, device="cuda") % cfg.n_classes
    ctx = ctx.with_tgroup(5)
    with torch.no_grad():
        events, counts = kernel_events(
            lambda: dit_apply(params, cfg, x, t, y, ctx=ctx), 1)
    launched = sum(v for k, v in counts.items()
                   if k.startswith("flash_attn_mrq"))
    names = [n for n, _ in events]
    flash = sum("flash_kernel" in n for n in names)
    codes = sum("codes_kernel" in n for n in names)
    stats = sum("MeanOps" in n or "pow_" in n for n in names)
    passes = sum("prologue_" in n for n in names)
    log(f"full width {bits} flash forward: {launched} flash launches; "
        f"profiler: {len(names)} kernel events (launches per forward), "
        f"{flash} flash_kernel, {codes} codes_kernel, {passes} prologue "
        f"passes, {stats} torch MeanOps / pow kernels")
    if launched != cfg.n_layers or codes or flash != cfg.n_layers:
        raise AssertionError(f"{bits} flash forward: {launched} launches and "
                             f"{flash} flash_kernel events for "
                             f"{cfg.n_layers} blocks, {codes} codes_kernel")
    if stats or not passes:
        raise AssertionError(f"{bits} forward: {stats} torch layernorm "
                             f"statistics kernels, {passes} prologue passes")


TIMES = {}     # (width, attn_impl, serve) -> (ms/step, req/s), this run
XL = {}        # phases 4c and 5b's DiT-XL/2 cfg, params and artifacts
CARD = [""]    # the card's name and power limit (nvidia-smi)
RANGE_CALIB_S = {}     # width -> full-width range calibration s, this run


def serve_composed(bits, cfg, params, art, reqs, flash_samples):
    """The sync serve of ``serve_width`` (same params, artifact and 8
    requests x 20 steps) on ``attn_impl="composed"``: every attention
    block through B9a -> B10a -> B9b, no flash launch."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.serving.engine import ServeEngine

    steps = reqs[0].steps
    eng = ServeEngine(params, cfg, art.dif_cfg(),
                      ctx=art.context(attn_impl="composed"), microbatch=4,
                      step_buckets=(steps,), device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launches()               # the composed run starts here
    t0 = time.perf_counter()
    results = eng.serve(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)      # ... and ends here
    samples = np.stack([results[r.request_id].sample for r in reqs])
    if samples.shape != flash_samples.shape or not np.isfinite(
            samples).all():
        raise AssertionError(f"bad {bits} composed samples {samples.shape}")
    forwards = eng.stats["microbatches"] * steps
    want = {k: 0 for k in launches}
    want.update({k: n * forwards
                 for k, n in art.packed_counts("composed").items()})
    log(f"full width {bits} composed: forwards {forwards}, launches "
        f"{launches}")
    if launches != want:
        raise AssertionError(f"{bits} composed launch counts {launches} != "
                             f"packed x forwards {want}")
    drift = float(np.abs(samples - flash_samples).mean()
                  / np.abs(flash_samples).mean())
    log(f"full width {bits} composed: served {len(reqs)} requests x {steps} "
        f"steps in {dt:.3f} s: {len(reqs) / dt:.4f} req/s, "
        f"{dt / forwards * 1e3:.3f} ms/step; samples vs flash's: mean|d| / "
        f"mean|flash| {drift:.6f}")
    TIMES[(bits, "composed", "sync 8x20")] = (dt / forwards * 1e3,
                                              len(reqs) / dt)
    forward_vs_plain(bits, cfg, params, art.context(attn_impl="composed"))
    return launches


def vec_key(kern):
    """The LAUNCHES key of a scalar kernel's per-row-group sibling."""
    if kern.startswith("flash_attn_mrq"):
        return kern.replace("flash_attn_mrq", "flash_attn_mrq_vec")
    return kern + "_vec"


def async_mix(cfg):
    """The continuous-batching request mix: 12 requests alternating 10
    and 20 steps, CFG 1.5."""
    import torch

    from repro_torch.serving.batching import GenRequest
    n_req = 12
    gen = torch.Generator().manual_seed(11)
    labels = torch.randint(0, cfg.n_classes, (n_req,), generator=gen)
    return [GenRequest(request_id=i, label=int(labels[i]),
                       steps=(10, 20)[i % 2], cfg_scale=1.5, seed=500 + i)
            for i in range(n_req)]


ASYNC_KW = dict(microbatch=4, step_buckets=(10, 20), device="cuda")


def serve_async(bits, cfg, params, art, attn_impl="flash"):
    """The continuous-batching engine at full width, on ``serve_width``'s
    params and artifact (no new calibration), attention through
    ``attn_impl``. Returns the async path's launches and the sync
    engine's results on the same mix."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.serving.batching import coalesce
    from repro_torch.serving.engine import AsyncServeEngine, ServeEngine

    reqs = async_mix(cfg)
    n_req = len(reqs)
    kw = ASYNC_KW
    # engines besides the main run skip from_artifact's params hash
    same = (params, cfg, art.dif_cfg())
    ctx = art.context(attn_impl=attn_impl)
    sync = ServeEngine(*same, ctx=ctx, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = sync.serve(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    f = sum(mb.steps for mb in coalesce(reqs, 4, (10, 20)))    # forwards
    log(f"sync {bits} {attn_impl} on the same {n_req} requests: {dt:.3f} s, "
        f"{n_req / dt:.4f} req/s, {dt / f * 1e3:.3f} ms/step over {f} "
        f"forwards ({sync.stats['padded_slots']} padded slots)")
    TIMES[(bits, attn_impl, "sync 12 mixed")] = (dt / f * 1e3, n_req / dt)
    launches = None
    for pipeline in (2, 1) if (bits, attn_impl) == ("w8a8", "flash") \
            else (2,):
        eng = (AsyncServeEngine.from_artifact(params, art, chunk=4,
                                              pipeline=2, **kw)
               if (pipeline, attn_impl) == (2, "flash") else
               AsyncServeEngine(*same, ctx=ctx, chunk=4, pipeline=pipeline,
                                **kw))
        torch.cuda.synchronize()
        if pipeline == 2:
            kernels.reset_launches()       # the async path's run starts here
        t0 = time.perf_counter()
        out = eng.serve(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if pipeline == 2:
            launches = dict(kernels.LAUNCHES)      # ... and ends here
        st = eng.stats
        bad = {r: (o.status, o.error) for r, o in out.items()
               if o.status != "OK"}
        if bad or st["degradations"] or st["retries"]:
            raise AssertionError(f"async {bits}: not OK {bad}, degradations "
                                 f"{st['degradations']}, retries "
                                 f"{st['retries']}")
        n_diff = sum(not np.array_equal(o.sample, ref[r].sample)
                     for r, o in out.items())
        if len(out) != n_req or n_diff:
            raise AssertionError(f"async {bits} pipeline {pipeline}: "
                                 f"{n_diff} samples differ from the sync "
                                 "engine's")
        f = st["forwards"]
        if pipeline == 2:
            TIMES[(bits, attn_impl, "async 12 mixed")] = (dt / f * 1e3,
                                                          n_req / dt)
        log(f"async {bits} {attn_impl} pipeline={pipeline}: {n_req} "
            f"requests (10/20 steps, chunk 4, microbatch 4, cfg 1.5) in "
            f"{dt:.3f} s: "
            f"{n_req / dt:.4f} req/s, {dt / f * 1e3:.3f} ms/step over "
            f"{f} forwards ({st['dispatches']} dispatches, {st['ahead']} "
            f"of them dispatched ahead; the 180 slot-steps asked fill "
            f"{180 / (4 * f):.3f} of the forwards' slot rows); samples "
            "equal the sync engine's bit for bit")
        if pipeline == 2:
            want = {k: 0 for k in launches}
            for k, n in art.packed_counts(attn_impl).items():
                want[vec_key(k)] = n * f
            log(f"async {bits} {attn_impl}: launches {launches}")
            if launches != want:
                raise AssertionError(f"async {bits} launch counts "
                                     f"{launches} != packed x forwards "
                                     f"{want}")
    # one chunk dispatch with host synchronisation made an error
    eng = AsyncServeEngine(*same, ctx=ctx, chunk=4, pipeline=1, **kw)
    for r in reqs[:4]:
        eng.submit_request(r)
    eng._admit()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x, pos, bad = eng._chunk_fn(eng._x, eng._pos, eng._bk, eng._y,
                                    eng._seeds, eng._gs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if pos.tolist() != [4] * 4 or bool(bad.any()):
        raise AssertionError(f"async {bits} chunk: pos {pos.tolist()}, "
                             f"bad {bad.tolist()}")
    log(f"async {bits} {attn_impl}: one chunk (4 steps x 4 slots) "
        "dispatched under torch.cuda.set_sync_debug_mode('error'): no host "
        "synchronisation")
    return launches, ref


def ladder_check(bits, cfg, params, art, composed_ref):
    """One injected dispatch fault on the flash async engine: the ladder
    steps to the composed rung (once, logged) and serves every request
    there, equal to the sync composed engine bit for bit."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.serving.engine import AsyncServeEngine
    from repro_torch.serving.faults import Fault, FaultInjector

    reqs = async_mix(cfg)
    inj = FaultInjector([Fault(kind="dispatch_error", at_dispatch=1)])
    eng = AsyncServeEngine(params, cfg, art.dif_cfg(), ctx=art.context(),
                           chunk=4, pipeline=2, injector=inj, **ASYNC_KW)
    torch.cuda.synchronize()
    kernels.reset_launches()               # the ladder's run starts here
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)      # ... and ends here
    deg = eng.stats["degradations"]
    bad = {r: o.status for r, o in out.items() if o.status != "OK"}
    n_diff = sum(not np.array_equal(o.sample, composed_ref[r].sample)
                 for r, o in out.items())
    comp = {k: launches[k + "_vec"] for k in COMPOSED}
    log(f"ladder {bits}: one injected dispatch fault -> {len(deg)} "
        f"degradation(s) {[d['reason'] for d in deg]}; {len(out)} requests, "
        f"not OK {bad}; composed vec launches {comp}; {n_diff} samples "
        "differ from the sync composed engine's")
    if (bad or len(out) != len(reqs) or n_diff or eng.ctx.attn_impl !=
            "composed" or [d["reason"] for d in deg] !=
            ["flash attention -> composed three-kernel chain"]
            or not all(comp.values())):
        raise AssertionError(f"ladder {bits}: the composed rung did not "
                             "serve every request")
    return launches


def phase_serve():
    import torch

    total = {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    for bits in WIDTHS:
        launches, cfg, params, art, reqs, samples = serve_width(bits)
        add(launches)
        add(serve_composed(bits, cfg, params, art, reqs, samples))
        add(serve_async(bits, cfg, params, art)[0])
        launches, composed_ref = serve_async(bits, cfg, params, art,
                                             "composed")
        add(launches)
        if bits == "w8a8":
            add(ladder_check(bits, cfg, params, art, composed_ref))
        if bits in ("w8a8", "w4a4"):
            # phase 4c measures through both, phase 5b samples W4A4's
            XL[f"{bits} range"] = art
        del params, art
        torch.cuda.empty_cache()
    log("serve times in this run, flash beside composed (ms/step, req/s):")
    for bits in WIDTHS:
        for serve in ("sync 8x20", "sync 12 mixed", "async 12 mixed"):
            f, c = (TIMES[(bits, a, serve)] for a in ("flash", "composed"))
            log(f"  {bits} {serve}: flash {f[0]!r} ms/step {f[1]!r} req/s; "
                f"composed {c[0]!r} ms/step {c[1]!r} req/s")
    return total


# ---------------------------------------------------------------------------
# phase 4b: HO at full width, saved once, cold-started in a fresh process
# ---------------------------------------------------------------------------
def phase_cold_start():
    """DiT-XL/2 HO-calibrated at W8A8 through ``launch.serve.build``, 8
    requests x 20 steps served (launch counts = packed x forwards) and the
    artifact saved; then ``python -m repro_torch.launch.serve
    --load-artifact`` in a fresh process must run no calibration and dump
    samples equal to the in-memory artifact's bit for bit."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.launch.serve import build

    requests, microbatch, steps = 8, 4, 20
    with tempfile.TemporaryDirectory(prefix="_ho_artifact_",
                                     dir=ROOT) as tmp:
        path = os.path.join(tmp, "dit_xl_2_w8a8_ho")
        cfg, params, art, engine, sq, info = build(
            "dit-xl-2", False, "w8a8", 0, requests, microbatch, steps, 1.5,
            device="cuda", calib="ho", save_artifact=path)
        log(f"full width w8a8 HO: calibration {info['calib_s']:.2f} s "
            f"(range {RANGE_CALIB_S['w8a8']:.2f} s in this run), save "
            f"{info['save_s']:.2f} s "
            f"({sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs) / 2 ** 20:.1f} MiB); "
            f"{art.summary()}; {art.meta['calib']}")
        if art.fallback_ops() or art.recipe.method != "ho":
            raise AssertionError(f"HO fallback ops: {art.fallback_ops()}")
        torch.cuda.synchronize()
        kernels.reset_launches()           # the main path's run starts here
        results = sq.run(engine)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)  # ... and ends here
        samples = np.stack([results[r].sample for r in sorted(results)])
        forwards = engine.stats["microbatches"] * steps
        want = {k: 0 for k in launches}
        want.update({k: n * forwards for k, n in art.packed_counts().items()})
        if launches != want:
            raise AssertionError(f"HO w8a8 launch counts {launches} != "
                                 f"packed x forwards {want}")
        if samples.shape != (requests, cfg.img_size, cfg.img_size,
                             cfg.in_ch) or not np.isfinite(samples).all():
            raise AssertionError(f"bad HO w8a8 samples {samples.shape}")
        # phase 5b samples through the in-memory artifact (the same
        # perturbed seed-0 params as phase 4's)
        XL.update({"cfg": cfg, "params": params, "w8a8 HO": art})
        del engine
        torch.cuda.empty_cache()
        dump = os.path.join(tmp, "cold.npy")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "dit-xl-2", "--quantize", "w8a8", "--load-artifact", path,
             "--requests", str(requests), "--microbatch", str(microbatch),
             "--steps", str(steps), "--cfg-scale", "1.5",
             "--dump-samples", dump],
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        for line in r.stdout.splitlines():
            log(f"  cold start: {line}")
        if r.returncode != 0:
            raise AssertionError(f"cold start exited {r.returncode}: "
                                 f"{r.stderr[-3000:]}")
        if ("calibrations run: 0" not in r.stdout
                or "calibrated" in r.stdout):
            raise AssertionError("the cold start ran a calibration")
        cold = np.load(dump)
        same = cold.shape == samples.shape and np.array_equal(cold, samples)
        log(f"full width w8a8 HO cold start: fresh process {wall:.2f} s "
            f"in all; samples equal to the in-memory artifact's bit for "
            f"bit: {same}")
        if not same:
            raise AssertionError("cold-start samples differ from the "
                                 "in-memory artifact's")
    return launches


# ---------------------------------------------------------------------------
# phase 4c: the recipe auto-search, its throughput measured on the card
# ---------------------------------------------------------------------------
def phase_autotune():
    """A sweep of ``repro_torch.autotune`` on the trained checkpoint (bits
    w8a8, w6a6, w4a4, flash, a mixed trial at a mean of 6 bits, the
    default ``EvalConfig``): killed after one trial, resumed (which
    measures DiT-XL/2's int8 and int4 paths through phase 4's range
    artifacts: zero fallback ops, launches = packed ops x forwards),
    replayed as a pure cache hit with byte-identical outputs, then
    ``python -m repro_torch.launch.autotune --assert-resumed`` in a fresh
    process on the same directory (nothing recomputed or measured, the
    frontier reproduced). Prints each path's seconds per step and spread
    beside the card, the frontier and the fastest path. Returns the
    measurement's launches."""
    import tempfile

    from repro_torch import autotune
    from repro_torch.launch.tables import BENCH_DIT, DIF
    from repro_torch.models.dit import params_from_numpy

    t_phase = time.perf_counter()
    with open(os.path.join(ROOT, "experiments", "dit_bench_450.pkl"),
              "rb") as f:
        params = params_from_numpy(pickle.load(f), device="cuda")
    space = autotune.SearchSpace(bits=WIDTHS, bit_budgets=(6.0,))
    ecfg = autotune.EvalConfig()
    n = len(autotune.expand(space))
    kw = dict(device="cuda", log=lambda m: log(f"  {m}"), measure_kw={
        "params": XL["params"],
        "artifacts": {"int8": XL["w8a8 range"], "int4": XL["w4a4 range"]}})
    names = ("BENCH_autotune.json", "report.md", "ledger.jsonl")

    def outputs(out):
        return {k: open(os.path.join(out, k), "rb").read() for k in names}
    with tempfile.TemporaryDirectory(prefix="_autotune_", dir=ROOT) as out:
        killed = autotune.run_autotune(params, BENCH_DIT, DIF, space, ecfg,
                                       out, max_new_stage1=1, **kw)
        if not (killed.stopped_early and killed.recomputed == 1
                and not killed.measured):
            raise AssertionError(f"autotune kill: {killed}")
        t0 = time.perf_counter()
        full = autotune.run_autotune(params, BENCH_DIT, DIF, space, ecfg,
                                     out, **kw)
        full_s = time.perf_counter() - t0
        if not (full.measured and full.stage1_hits == 1
                and full.recomputed == n - 1 and len(full.records) == n):
            raise AssertionError(f"autotune resume after the kill: {full}")
        done = outputs(out)
        resumed = autotune.run_autotune(params, BENCH_DIT, DIF, space,
                                        ecfg, out, **kw)
        if (resumed.recomputed or resumed.cache_hits != n
                or resumed.measured or resumed.frontier != full.frontier
                or resumed.records != full.records
                or outputs(out) != done):
            raise AssertionError(f"autotune replay was no pure cache hit: "
                                 f"{resumed}")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.autotune", "--arch",
             "bench", "--out", out, "--budgets", "6", "--assert-resumed"],
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        for line in r.stdout.splitlines():
            log(f"  fresh process: {line}")
        if (r.returncode != 0 or "resume asserts passed" not in r.stdout
                or outputs(out) != done):
            raise AssertionError(f"autotune --assert-resumed exited "
                                 f"{r.returncode}: {r.stderr[-3000:]}")
    row = full.throughput
    log(f"autotune: {n} trials, kill + resume {full_s:.1f} s (measurement "
        f"{row['wall_s']:.1f} s), fresh-process --assert-resumed "
        f"{wall:.1f} s: nothing recomputed or measured, frontier and "
        f"outputs reproduced")
    for path in sorted(row["step_s"]):
        log(f"autotune: DiT-XL/2 {path} on {row['card']}: median "
            f"{row['step_s'][path] * 1e3!r} ms/step, spread "
            f"{row['spread_s'][path] * 1e3!r} ms over {row['runs']} runs of "
            f"{ecfg.serve_b_local} request x {ecfg.serve_steps} CFG-paired "
            f"steps: " + ", ".join(f"{t * 1e3:.3f}"
                                   for t in row["runs_s"][path]))
    for r in full.records:
        m = r["metrics"]
        log(f"autotune trial: {r['label']:<12} {r['status']:<6} {m['path']:<9}"
            f" req/s {m['req_per_s']!r} FD {m.get('FD')} noise MSE "
            f"{m['noise_mse']:.6g} by group " + ", ".join(
                f"{v:.3g}" for v in m["noise_mse_by_group"])
            + (f"; bits by group {r['allocation']}" if "allocation" in r
               else ""))
    for p in full.frontier:
        log(f"autotune frontier: {p['label']:<12} {p['path']:<9} req/s "
            f"{p['req_per_s']!r} ms/step {p['ms_per_step']!r} FD {p['FD']} "
            f"sFD {p['sFD']} IS* {p['IS*']} noise MSE {p['noise_mse']:.6g}")
    fastest = min(row["step_s"], key=row["step_s"].get)
    log(f"autotune: the card's fastest path is {fastest}; the frontier's "
        f"fastest point {full.frontier[0]['label']}; phase 4c took "
        f"{time.perf_counter() - t_phase:.1f} s")
    total = {}
    for launches in row["launches"].values():
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


# ---------------------------------------------------------------------------
# phase 5: the evaluation path — research sampler, FD / sFD / IS*, noise MSE
# ---------------------------------------------------------------------------
EVAL = dict(n=128, steps=40, batch=64)   # the quality tables' protocol
XL_EVAL = dict(n=32, steps=20, batch=32)


def counted(fn):
    """``fn()`` with the launch counts set to 0 before and read after:
    (result, launches, wall seconds)."""
    import torch

    from repro_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.LAUNCHES), time.perf_counter() - t0


def check_launches(name, launches, art, forwards):
    """Every kernel of the artifact launched once an op a forward, no
    other kernel."""
    want = {k: 0 for k in launches}
    want.update({k: n * forwards for k, n in art.packed_counts().items()})
    if launches != want:
        raise AssertionError(f"{name} launch counts {launches} != packed x "
                             f"forwards {want}")


def eval_row(name, gen, score, mse, secs, steps_run):
    import numpy as np
    if not (np.isfinite(gen).all() and all(
            np.isfinite(v) for v in score.values()) and np.isfinite(mse)):
        raise AssertionError(f"eval {name}: non-finite samples or scores "
                             f"{score} mse {mse}")
    log(f"eval {name}: FD {score['FD']} sFD {score['sFD']} IS* "
        f"{score['IS*']} noiseMSE {mse:.6g}; sampled {gen.shape[0]} in "
        f"{secs:.2f} s ({secs / steps_run * 1e3:.2f} ms/step, "
        f"{gen.shape[0] / secs:.2f} samples/s)")


def phase_eval(setup):
    """5a: the trained checkpoint's FP and the range and HO artifacts of
    phases 3 and 3b, each first held in one 64-row forward (4,096 token
    rows) against the plain versions, then sampled with the tables'
    protocol (128 samples, 40 steps, batches of 64) through the kernels,
    scored (FD, sFD, IS*
    against 1,024 real latents) and its noise MSE taken; launches of each
    sampling = packed x forwards; a constant-map ``generate_grouped``
    equals ``generate`` bit for bit at W8A8; a mixed map (W8A8 groups
    0-4, W4A4 5-9) runs both kernel families in one chain. 5b: DiT-XL/2
    at full width under phase 4b's HO W8A8 and phase 4's W4A4 artifacts:
    one 32-row forward (8,192 token rows) on the kernels equal to the
    plain versions, 32 samples x 20 steps sampled, scored against
    XL-shaped assets, noise MSE by group. Returns the launches."""
    import numpy as np
    import torch

    from repro_torch.diffusion.ddpm import DiffusionCfg, make_schedule
    from repro_torch.quant import eval as qeval

    cfg, dif, params, sched, _ = setup
    total = {}
    t_phase = time.perf_counter()

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    def sample(ctx, grouped=False, p=params, c=cfg, d=dif, s=sched,
               proto=EVAL):
        kw = dict(steps=proto["steps"], n=proto["n"], batch=proto["batch"],
                  sched=s, device="cuda")
        if grouped:
            return counted(lambda: qeval.generate_grouped(p, c, d, ctx,
                                                          **kw)[0])
        return counted(lambda: qeval.generate(p, c, d, ctx=ctx, **kw)[0])

    forwards = EVAL["steps"] * -(-EVAL["n"] // EVAL["batch"])
    gens = {}
    for method, bits in [(None, "fp")] + [(m, b) for m in ("range", "ho")
                                          for b in WIDTHS]:
        art = None if method is None else TRAINED_ARTS[method, bits]
        ctx = None if art is None else art.context()
        if art is not None:
            # the sampler's 64-row (4,096 token rows) forward, which the
            # mixed map's W4A4 half runs too, against the plain versions
            forward_vs_plain(f"trained {method} {bits}", cfg, params, ctx,
                             batch=EVAL["batch"])
        gen, launches, secs = sample(ctx)
        if art is not None:
            check_launches(f"eval {method} {bits}", launches, art, forwards)
        add(launches)
        score = qeval.score(gen, cfg, device="cuda")
        mse = 0.0 if ctx is None else qeval.noise_mse(params, cfg, dif, ctx,
                                                      device="cuda")
        name = "FP" if art is None else f"{bits.upper()} {method}"
        eval_row(f"trained {name}", gen, score, mse, secs, forwards)
        gens[method, bits] = gen

    ctx8 = TRAINED_ARTS["range", "w8a8"].context()
    same, launches, _ = sample([ctx8] * dif.tgq_groups, grouped=True)
    add(launches)
    equal = np.array_equal(same, gens["range", "w8a8"])
    log(f"eval trained W8A8 range: generate_grouped with a constant map "
        f"equals generate bit for bit: {equal}")
    if not equal:
        raise AssertionError("constant-map generate_grouped differs from "
                             "generate")
    ctx4 = TRAINED_ARTS["range", "w4a4"].context()
    half = dif.tgq_groups // 2
    mixed, launches, secs = sample([ctx8] * half + [ctx4] * half,
                                   grouped=True)
    add(launches)
    fams = {f: sum(n for k, n in launches.items() if k.startswith(f))
            for f in ("int8_", "int4_")}
    log(f"eval trained mixed map (W8A8 groups 0-{half - 1}, W4A4 "
        f"{half}-{dif.tgq_groups - 1}): launches {launches}")
    if not (fams["int8_"] and fams["int4_"]):
        raise AssertionError(f"the mixed chain ran one kernel family: {fams}")
    eval_row("trained mixed W8A8/W4A4 range", mixed,
             qeval.score(mixed, cfg, device="cuda"), 0.0, secs, forwards)

    # 5b: DiT-XL/2 at full width
    xcfg, xparams = XL["cfg"], XL["params"]
    xdif = DiffusionCfg(T=1000)
    xsched = make_schedule(xdif)
    xsteps = XL_EVAL["steps"]
    for name in ("w8a8 HO", "w4a4 range"):
        art = XL[name]
        ctx = art.context()
        forward_vs_plain(name, xcfg, xparams, ctx, batch=XL_EVAL["batch"])
        gen, launches, secs = sample(ctx, p=xparams, c=xcfg, d=xdif,
                                     s=xsched, proto=XL_EVAL)
        check_launches(f"eval DiT-XL/2 {name}", launches, art, xsteps)
        add(launches)
        score = qeval.score(gen, xcfg, device="cuda")
        by_group = qeval.noise_mse_by_group(xparams, xcfg, xdif, ctx, n=40,
                                            device="cuda")
        eval_row(f"DiT-XL/2 {name} on {CARD[0]}", gen, score,
                 float(np.mean(by_group)), secs, xsteps)
        log(f"eval DiT-XL/2 {name}: noise MSE by group "
            + ", ".join(f"{v:.6g}" for v in by_group)
            + " (perturbed initialised weights: the scores run the path, "
            "they say nothing of quality)")
    del XL["params"]
    torch.cuda.empty_cache()
    log(f"eval: phase 5 took {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 6: the public kernel API through its entry points
# ---------------------------------------------------------------------------
def phase_entry_points():
    """``repro_torch.kernels.int8_matmul``, ``ops.softmax_mrq_op``,
    ``ops.act_mrq_op`` and ``ops.flash_attention(mask=...)`` (scalar and
    per-slot groups, bits 8 and 4) at the DiT-XL/2 shapes, the launch
    counts set to 0 before and read after; each output finite, of its
    shape, and equal to the plain versions' on the same inputs."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)
    B, S, H, D, G = 8, 256, 16, 72, 10
    xq = torch.randint(-128, 128, (2048, 1152), device=dev, generator=gen,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (1152, 3456), device=dev, generator=gen,
                       dtype=torch.int8)
    scale = torch.rand(3456, device=dev, generator=gen) * 1e-3 + 1e-4
    corr = 3 * wq.to(torch.int32).sum(0, dtype=torch.int32)
    bias = torch.randn(3456, device=dev, generator=gen)
    scores = torch.randn(B, H, S, S, device=dev, generator=gen) * 4
    h = torch.randn(2048, 4608, device=dev, generator=gen).to(torch.bfloat16)
    c = torch.randn(B, 1152, device=dev, generator=gen).to(torch.bfloat16)
    q = torch.randn(B, S, H, 1, D, device=dev, generator=gen).to(
        torch.bfloat16)
    k, v = (torch.randn(B, S, H, D, device=dev, generator=gen).to(
        torch.bfloat16) for _ in "kv")
    mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    tg = torch.tensor(SLOT_GROUPS, dtype=torch.int32, device=dev)

    def packs(bits):
        half = 2 ** (bits - 1)
        rate = 1.0 + 0.1 * torch.rand(G, 1, device=dev, generator=gen)
        s_q, s1 = rate * (6.0 / (half - 1)), rate * (8.0 / S / half)
        s_v = rate * (4.0 / (half - 1))
        meta = {"groups": G, "bits": bits}
        return ({"s_q": s_q, "s_k": s_q * 1.05, "scale": s_q * s_q * 1.05,
                 **meta},
                {"s1": s1, "s_v": s_v, "scale1": s1 * s_v,
                 "scale2": s_v * (1.0 / half), **meta})
    p8, p4 = packs(8), packs(4)
    calls = [
        ("int8_matmul", lambda: kernels.int8_matmul(
            xq, wq, scale, corr, bias, out_dtype=torch.bfloat16)),
        ("softmax_mrq", lambda: ops.softmax_mrq_op(scores, 0.25 / 128)),
        ("act_mrq", lambda: ops.act_mrq_op(h, 0.17 / 128, 6.0 / 128,
                                           out_dtype=torch.bfloat16)),
        ("act_mrq", lambda: ops.act_mrq_op(c, 0.17 / 32, 6.0 / 32, bits=6,
                                           kind="silu")),
        ("flash_attn_mrq", lambda: ops.flash_attention(
            q, k, v, *p8, mask=mask, scale=D ** -0.5, tgroup=4)),
        ("flash_attn_mrq_packed_kv", lambda: ops.flash_attention(
            q, k, v, *p4, mask=mask, scale=D ** -0.5, tgroup=4)),
        ("flash_attn_mrq_vec", lambda: ops.flash_attention(
            q, k, v, *p8, mask=mask, scale=D ** -0.5, tgroup=tg)),
        ("flash_attn_mrq_vec_packed_kv", lambda: ops.flash_attention(
            q, k, v, *p4, mask=mask, scale=D ** -0.5, tgroup=tg)),
    ]
    torch.cuda.synchronize()
    kernels.reset_launches()               # the entry points' run starts here
    outs = [fn() for _, fn in calls]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)      # ... and ends here
    want = {name: 0 for name in launches}
    for name, _ in calls:
        want[name] += 1
    log(f"entry points: launches {launches}")
    if launches != want:
        raise AssertionError(f"entry point launches {launches} != {want}")
    with kernels.plain_on_cuda():
        refs = [fn() for _, fn in calls]
    for (name, _), out, ref in zip(calls, outs, refs):
        n_diff = (bit_mismatches(out, ref) if name == "act_mrq"
                  else int((out != ref).sum()))
        log(f"  entry point -> {name}: out {tuple(out.shape)} "
            f"{str(out.dtype)[6:]}, {n_diff} outputs differ from the plain "
            "versions'")
        if n_diff or out.shape != ref.shape or not torch.isfinite(
                out).all():
            raise AssertionError(f"entry point {name}: {n_diff} outputs "
                                 "differ from the plain versions' or not "
                                 "finite")
    return launches


def entry_name(symbol):
    """A kernel's name from its mangled symbol, with its template arguments
    as mangled: ``_ZN<n><namespace><n>gemm_kernelILb0EEEv...`` ->
    ``gemm_kernelILb0EEEv...`` (the last name of the nested prefix)."""
    i = 3 if symbol.startswith("_ZN") else 2
    start = i
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        start, i = j, j + int(symbol[i:j])
    return symbol[start:]


def ptxas_lines(lib, kernel=""):
    """(instantiation, line) for ptxas's register, spill and C75xx lines
    of the entry functions of ``lib``'s build whose names start with
    ``kernel`` (every one by default)."""
    import re

    from repro_torch.kernels import build as kbuild
    fn = None
    for line in kbuild.BUILD_LOG.get(lib, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = entry_name(m.group(1))
            fn = fn if fn.startswith(kernel) else None
            continue
        if fn and ("registers" in line or "spill" in line or "C75" in line):
            yield fn, line.strip()


def spill_bytes(line):
    import re
    s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                  line)
    return int(s.group(1)) + int(s.group(2)) if s else 0


def prologue_ptxas():
    """Phase 1 for the prologue pass (``csrc/prologue.cuh``, built into
    both fused-linear libraries): ptxas's registers and spills per
    instantiation; fatal on any spill."""
    spilled = []
    for lib in ("int8_fused", "int4_packed"):
        for fn, line in ptxas_lines(lib, "prologue_"):
            log(f"  ptxas {lib} {fn}: {line}")
            if spill_bytes(line):
                spilled.append((lib, fn))
    if spilled:
        raise AssertionError(f"the prologue pass spills: {spilled}")


def flash_ptxas():
    """Phase 1 for the flash kernel: ptxas's registers, spills and wgmma
    serialisation (C7513) per instantiation, and its SASS: wgmma (IGMMA)
    and no mma.sync (IMMA, HMMA). Fatal on an mma.sync, a C7513, or a
    spill in a serving (FAST, ``...Lb1E``) instantiation; the fallback
    instantiations' spills (masks, ragged kv, unaligned rows) are
    printed."""
    from repro_torch.kernels import build as kbuild
    spilled = []
    for fn, line in ptxas_lines("flash_attn_mrq", "flash_kernel"):
        log(f"  ptxas {fn}: {line}")
        if (spill_bytes(line) and fn.endswith("Lb1EEEvNS_4ArgsE")) \
                or "C7513" in line:
            spilled.append(fn)
    sass = kbuild.sass_counts("flash_attn_mrq", "flash_kernel",
                              ops=("IGMMA", "IMMA", "HMMA"))
    log(f"flash_attn_mrq (flash_kernel) SASS: {sass['IGMMA']} IGMMA (wgmma), "
        f"{sass['IMMA']} IMMA and {sass['HMMA']} HMMA (mma.sync)")
    if not sass["IGMMA"] or sass["IMMA"] or sass["HMMA"]:
        raise AssertionError("flash_kernel is not built on wgmma")
    if spilled:
        raise AssertionError(f"flash_kernel spills or serialises: {spilled}")


def composed_ptxas():
    """Phase 1 for the composed chain's matmuls (``csrc/int8_bmm.cu``):
    ptxas's registers and spills per instantiation, and their SASS:
    wgmma (IGMMA) and no mma.sync (IMMA, HMMA). Fatal on an mma.sync or a
    spill in a serving instantiation (bf16, hd 72, FAST:
    ``qk_kernel<bf16, 3, true>``, ``pv_kernel<bf16, 80, 1, true>``)."""
    from repro_torch.kernels import build as kbuild
    spilled = []
    for kern, serving in (("qk_kernel", "qk_kernelI13__nv_bfloat16Li3ELb1E"),
                          ("pv_kernel",
                           "pv_kernelI13__nv_bfloat16Li80ELi1ELb1E")):
        for fn, line in ptxas_lines("int8_bmm", kern):
            log(f"  ptxas {fn}: {line}")
            if spill_bytes(line) and fn.startswith(serving):
                spilled.append(fn)
        sass = kbuild.sass_counts("int8_bmm", kern,
                                  ops=("IGMMA", "IMMA", "HMMA"))
        log(f"int8_bmm ({kern}) SASS: {sass['IGMMA']} IGMMA (wgmma), "
            f"{sass['IMMA']} IMMA and {sass['HMMA']} HMMA (mma.sync)")
        if not sass["IGMMA"] or sass["IMMA"] or sass["HMMA"]:
            raise AssertionError(f"{kern} is not built on wgmma")
    if spilled:
        raise AssertionError(f"the composed matmuls spill: {spilled}")


def softmax_ptxas():
    """Phase 1 for the softmax-codes pass (``csrc/softmax_mrq.cu``):
    ptxas's registers and spills of the serving instantiations
    ``softmax_codes_kernel<scores, OUT, columns a lane>`` (B10a and B10b on
    C = 256 rows of f32 or bf16 scores: ``<float|bf16, 0, 8>``), fatal on
    a spill there, and any other instantiation's spill line."""
    import re
    spilled = []
    for fn, line in ptxas_lines("softmax_mrq", "softmax_codes_kernel"):
        serving = re.match(r"softmax_codes_kernelI(f|13__nv_bfloat16)Li0ELi8E",
                           fn)
        if serving or spill_bytes(line):
            log(f"  ptxas {fn}: {line}")
        if serving and spill_bytes(line):
            spilled.append(fn)
    if spilled:
        raise AssertionError(f"the softmax-codes pass spills: {spilled}")


ACT_SERVING = {  # B13's serving instantiations: <bf16, bf16, GELU>, <f32, f32, GELU>
    "bf16": r"act_mrq_kernelI13__nv_bfloat16S\d*_Li0E",
    "f32": r"act_mrq_kernelIffLi0E"}


def act_mrq_ptxas():
    """Phase 1 for B13 (``csrc/act_mrq.cu``): ptxas's registers and spills
    per instantiation ``act_mrq_kernel<x, out, kind>``, and the SASS of the
    serving ones: instructions in all, and those of the fast block from its
    first 16-byte load to its last 16-byte store over the elements a thread
    takes there (the instructions an element on the serving path). Fatal on
    a spill in a serving instantiation. Returns {serving: instructions an
    element}."""
    import re

    from repro_torch.kernels import build as kbuild
    spilled = []
    for fn, line in ptxas_lines("act_mrq", "act_mrq_kernel"):
        log(f"  ptxas {fn}: {line}")
        if spill_bytes(line) and any(re.match(p, fn)
                                     for p in ACT_SERVING.values()):
            spilled.append(fn)
    vec = int(re.search(r"constexpr int VEC = (\d+);", (
        kbuild.CSRC / "act_mrq.cu").read_text()).group(1))
    per = {}
    for fn, ops in kbuild.sass_opcodes("act_mrq", "act_mrq_kernel").items():
        name = entry_name(fn)
        dt = next((d for d, p in ACT_SERVING.items() if re.match(p, name)),
                  None)
        if dt is None:
            continue
        first = next(i for i, o in enumerate(ops) if o.startswith("LDG.E.128"))
        last = max(i for i, o in enumerate(ops) if o.startswith("STG.E.128"))
        span = ops[first:last + 1]
        per[dt] = len(span) / vec
        log(f"act_mrq <{dt}, {dt}, gelu> SASS: {len(ops)} instructions; "
            f"fast block {len(span)} over {vec} elements = {per[dt]:.2f} an "
            f"element ({sum(o.startswith('MUFU') for o in span)} MUFU, "
            f"{sum(o.startswith('BRA') for o in span)} BRA in it)")
    if spilled:
        raise AssertionError(f"B13's serving instantiations spill: {spilled}")
    if set(per) != set(ACT_SERVING):
        raise AssertionError(f"B13's serving instantiations not found: {per}")
    return per


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build as kbuild

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    secs = kbuild.build_all()
    log(f"build: {secs:.1f} s for {list(kbuild.SOURCES)} (nvcc, sm_90a)")
    for name in kbuild.BUILD_LOG:        # the rest below, with their gates
        if name in ("flash_attn_mrq", "int8_bmm", "softmax_mrq", "act_mrq"):
            continue
        for fn, line in ptxas_lines(name):
            if not fn.startswith("prologue_"):
                log(f"  ptxas {name} {fn}: {line}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    CARD[0] = smi.stdout.strip()
    log(f"card: {CARD[0]}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    flash_ptxas()
    composed_ptxas()
    softmax_ptxas()
    prologue_ptxas()
    act_mrq_ptxas()
    for lib, kern in (("int8_fused", "gemm_kernel"),
                      ("int4_packed", "gemm4_kernel")):
        sass = kbuild.sass_counts(lib, kern, ops=(
            "IGMMA", "UTMALDG", "UBLKCP", "IMMA", "HMMA"))
        log(f"{lib} GEMM ({kern}) SASS: {sass['IGMMA']} IGMMA (wgmma), "
            f"{sass['UTMALDG']} UTMALDG (TMA tensor loads), {sass['UBLKCP']}"
            f" UBLKCP (TMA bulk copies), {sass['IMMA']} IMMA and "
            f"{sass['HMMA']} HMMA (mma.sync)")
        if (not (sass["IGMMA"] and sass["UTMALDG"]) or sass["IMMA"]
                or sass["HMMA"]):
            raise AssertionError(f"{kern} is not built on wgmma and TMA")

    rows = phase_kernels()
    prologue_cases()
    phase_gemm_device(rows)
    phase_attn_device(rows)
    phase_composed_device(rows)
    drifts, setup, fp = phase_trained()
    ho = phase_trained_ho(setup, fp, drifts)
    del fp
    launches = phase_serve()
    for phase in (phase_cold_start, phase_autotune,
                  lambda: phase_eval(setup), phase_entry_points):
        for name, n in phase().items():
            launches[name] = launches.get(name, 0) + n

    flash = ("src/repro_torch/csrc/flash_attn_mrq.cu",
             "src/repro/kernels/flash_attn_mrq.py:292")
    flash_vec = ("src/repro_torch/csrc/flash_attn_mrq.cu",
                 "src/repro/kernels/flash_attn_mrq.py:401")
    sources = {"int8_matmul_fq": ("src/repro_torch/csrc/int8_fused.cu",
                                  "src/repro/kernels/int8_fused.py:355"),
               "int8_matmul_mrq_fq": ("src/repro_torch/csrc/int8_fused.cu",
                                      "src/repro/kernels/int8_fused.py:483"),
               "flash_attn_mrq": flash,
               "flash_attn_mrq_packed_kv": flash,
               "int4_matmul_fq": ("src/repro_torch/csrc/int4_packed.cu",
                                  "src/repro/kernels/int4_packed.py:244"),
               "int4_matmul_mrq_fq": ("src/repro_torch/csrc/int4_packed.cu",
                                      "src/repro/kernels/int4_packed.py:365"),
               "int8_matmul_fq_vec": ("src/repro_torch/csrc/int8_fused.cu",
                                      "src/repro/kernels/int8_fused.py:583"),
               "int8_matmul_mrq_fq_vec": (
                   "src/repro_torch/csrc/int8_fused.cu",
                   "src/repro/kernels/int8_fused.py:691"),
               "int4_matmul_fq_vec": ("src/repro_torch/csrc/int4_packed.cu",
                                      "src/repro/kernels/int4_packed.py:473"),
               "int4_matmul_mrq_fq_vec": (
                   "src/repro_torch/csrc/int4_packed.cu",
                   "src/repro/kernels/int4_packed.py:589"),
               "flash_attn_mrq_vec": flash_vec,
               "flash_attn_mrq_vec_packed_kv": flash_vec,
               "int8_bmm_qk": ("src/repro_torch/csrc/int8_bmm.cu",
                               "src/repro/kernels/int8_bmm.py:145"),
               "softmax_mrq_codes": ("src/repro_torch/csrc/softmax_mrq.cu",
                                     "src/repro/kernels/softmax_mrq.py:143"),
               "int8_bmm_pv": ("src/repro_torch/csrc/int8_bmm.cu",
                               "src/repro/kernels/int8_bmm.py:240"),
               "int8_bmm_qk_vec": ("src/repro_torch/csrc/int8_bmm.cu",
                                   "src/repro/kernels/int8_bmm.py:299"),
               "softmax_mrq_codes_vec": (
                   "src/repro_torch/csrc/softmax_mrq.cu",
                   "src/repro/kernels/softmax_mrq.py:199"),
               "int8_bmm_pv_vec": ("src/repro_torch/csrc/int8_bmm.cu",
                                   "src/repro/kernels/int8_bmm.py:349"),
               "int8_matmul": ("src/repro_torch/csrc/int8_fused.cu",
                               "src/repro/kernels/int8_matmul.py:79"),
               "softmax_mrq": ("src/repro_torch/csrc/softmax_mrq.cu",
                               "src/repro/kernels/softmax_mrq.py:78"),
               "act_mrq": ("src/repro_torch/csrc/act_mrq.cu",
                           "src/repro/kernels/act_mrq.py:55")}
    idle = [k for k in sources if not launches.get(k)]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{idle}")
    line = {"kernels": [dict(
        name=name, route="cuda", source=src, replaces=rep,
        launches=launches[name], max_abs_err=rows[name]["max_abs_err"],
        ms=rows[name]["ms"], plain_ms=rows[name]["plain_ms"],
        bound_ms=rows[name]["bound_ms"], bound_by=rows[name]["bound_by"],
        library_ms=rows[name]["library_ms"])
        for name, (src, rep) in sources.items()]}
    log("masked flash (causal, bits 8, bf16) beside unmasked, wrapper time "
        "of the public entry point: " + ", ".join(
            f"{k} {MASKED_MS[k]:.4f} ms / {rows[k]['wrapper_ms']:.4f} ms"
            for k in MASKED_MS))
    log(f"total {time.perf_counter() - t0:.1f} s; trained drifts "
        + ", ".join(f"{b} {d:.6f}" for b, d in drifts.items())
        + "; HO " + ", ".join(f"{b} {d:.6f} ({s:.2f} s)"
                              for b, (d, s) in ho.items()))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
