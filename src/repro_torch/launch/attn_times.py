"""Device time of one attention call at the DiT-XL/2 serving shape.

    python src/repro_torch/launch/attn_times.py [--src DIR] [--reps 30] \
        [--label NAME] [--ablate] [--timeline] [--composed]

One call of ``ops.flash_attention`` on the q, k and v views of a
(B = 8, N = 256, 3, H = 16, hd = 72) bf16 qkv projection output (the
serving forward's 2B = 8 rows, G = 10 TGQ groups), as the DiT block makes
it: B3 at bits 8, B3b (bits 4, packed kv), B8 (per-slot groups, one per
CFG row) at bits 8 and 4, and B3 with a causal mask. For each it prints:

- device ms per call: the CUDA kernels' durations summed by
  ``torch.profiler`` over ``--reps`` calls, by kernel (the flash kernel,
  any codes pre-pass and the torch glue around them);
- launches per call: the wrappers' counts over ``--reps`` (and the
  profiler's kernel events, torch glue included);
- wrapper ms per call: CUDA events around ``--reps`` back-to-back calls
  (the host's enqueue included);
- bound ms: the least time the card could take, the larger of the bytes
  (q, k, v read once, out written once, at 3.35 TB/s) and the
  operations (the int8 products at 1979 TOP/s plus 10 fp32 operations
  per score at 67 TFLOP/s: H100 SXM);
- SDPA ms: ``scaled_dot_product_attention`` on the same bf16 q, k, v
  (another function: no int8 products, no MRQ codes), the yardstick.

``--composed`` times ``ops.int8_attention`` (``attn_impl="composed"``)
on the same views instead: B9a -> B10a -> B9b at bits 8 and 4, and B9c
-> B10b -> B9d with per-slot groups. Each row splits the device time
into the chain's parts (``qk_kernel``, ``softmax_codes_kernel``,
``pv_kernel``, any ``codes_kernel`` pre-pass, and the torch glue: head
copies and permutes), gives each kernel's bound (qk: q and k read once,
the f32 scores written once, or its int8 products; B10: the scores read,
the codes written, or 7 fp32 operations a score, each counted once, an
expf or a divide as one; pv: the codes and v
read, the output written, or its two int8 products) and the chain's
(their sum: the scores and codes cross device memory by the reference's
contract), and a sha256 of the call's output bytes, so a parent and a
change can be held bit for bit across trees.

``--ablate`` times throwaway builds of the tree's ``csrc/flash_attn_mrq.cu``
(with ``--composed``: of ``csrc/int8_bmm.cu`` and ``csrc/softmax_mrq.cu``,
``COMPOSED_ABLATIONS``, on the composed call at bits 8)
with one part switched off at a time (``ABLATIONS``: textual patches; the
first six fit the ``mma.sync`` kernel of commit 73ac78a, run with
``--src`` on that tree unpacked by ``git archive``, the rest the
one-launch wgmma kernel that replaced it; the softmax pass's "3-pass"
entries fit the kernel of commit e903e06); a patch may hit a shared
header (``csrc/*.cuh``), which the variant then builds from its own
copy, and a patch whose text the sources do not hold once is reported
and skipped. The outputs of those builds are wrong by construction: only
their times are read.

``--timeline`` (with ``--composed``: the P.V kernel's, ``COMPOSED_TIMELINE``:
per kv tile when v landed and was coded, the codes landed and the
products were done, then the epilogue) builds the tree's flash source
once more with ``clock64``
stamps (``TIMELINE``: textual patches of the one-launch wgmma kernel) and
runs B3 bits 8 three times: for two CTAs, the producer's cycles (from
the kernel's start) at which tile 0's copies were issued, tiles 0 and 1
landed and were coded, and each consumer warpgroup's at which its q
codes were done and, per kv tile, the k codes arrived, QK^T, the
softmax codes and P.V were done, and the CTA ended. The stamps cost a
few instructions each; only the order and the gaps are read.

With ``--composed`` it also times B12 (``kernels.softmax_mrq``, the
softmax-codes kernel with its dequantising epilogue) on scores of the
composed call's shape, (32768, 256) at bits 8, f32 and bf16, in device
time with a sha256 of each output.

``--src`` puts DIR first on the import path, so one script times another
tree's kernels through the same entry point; run parent, change, change,
parent in one call on one card to compare them. The last line is a JSON
object of the rows.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys

HBM_BPS = 3.35e12          # H100 SXM device memory, bytes/s
INT8_OPS = 1979e12         # dense int8 tensor-core peak, ops/s
FP32_OPS = 67e12           # fp32 outside the tensor cores, flop/s
SOFTMAX_FP32_PER_SCORE = 10
B, N, H, HD, G = 8, 256, 16, 72, 10
SLOT_GROUPS = (3, 7, 0, 9, 3, 7, 0, 9)   # one TGQ group per CFG row

# (name, [(text in the source, replacement)]): each switches one part of
# a flash kernel off while keeping the rest alive; the first six fit the
# mma.sync kernel of 73ac78a, the rest the wgmma kernel that replaced it
ABLATIONS = [
    ("no QK^T mma", [(
        "mma_s8(d4, af[kc], ld32(p), ld32(p + 16));",
        "d4[0] += (int)(p[0] & 1);")]),
    ("no exp", [(
        "s[nt][e] = expf(__fsub_rn(s[nt][e], m_new[e >> 1]));",
        "s[nt][e] = __fsub_rn(s[nt][e], m_new[e >> 1]);")]),
    ("no divides or codes", [(
        "        const float p = __fdiv_rn(s[nt][e], l_new[e >> 1]);\n"
        "        int c1 = 0, c2 = 0;\n"
        "        if (p < thr) c1 = (int)fminf(fmaxf(rintf(__fdiv_rn(p, s1)), 0.f), hi);\n"
        "        else c2 = (int)fminf(fmaxf(rintf(__fdiv_rn(p, s2)), 0.f), fhalf);\n",
        "        const float p = __fmul_rn(s[nt][e], l_new[e >> 1]);\n"
        "        const int c1 = (int)p, c2 = c1 + (p < thr);\n")]),
    ("no shared-memory round trip of the codes", [
        ("    // -- MRQ codes against the running normalisation",
         "    unsigned pk = 0;\n"
         "    // -- MRQ codes against the running normalisation"),
        ("        myP1[o] = (uint8_t)c1;\n        myP2[o] = (uint8_t)c2;\n",
         "        pk = pk * 3u + (unsigned)(c1 | (c2 << 8) | o);\n"),
        ("      p1[kc][0] = ld32(myP1 + o);            p2[kc][0] = ld32(myP2 + o);\n"
         "      p1[kc][1] = ld32(myP1 + o + 8 * PROW); p2[kc][1] = ld32(myP2 + o + 8 * PROW);\n"
         "      p1[kc][2] = ld32(myP1 + o + 16);       p2[kc][2] = ld32(myP2 + o + 16);\n"
         "      p1[kc][3] = ld32(myP1 + o + 8 * PROW + 16);\n"
         "      p2[kc][3] = ld32(myP2 + o + 8 * PROW + 16);\n",
         "      p1[kc][0] = pk + o; p2[kc][0] = pk ^ o;\n"
         "      p1[kc][1] = pk + 1; p2[kc][1] = pk ^ 1;\n"
         "      p1[kc][2] = pk + 2; p2[kc][2] = pk ^ 2;\n"
         "      p1[kc][3] = pk + 3; p2[kc][3] = pk ^ 3;\n")]),
    ("no P.V mma", [(
        "        mma_u8s8(d1, p1[kc], b0, b1);\n"
        "        mma_u8s8(d2, p2[kc], b0, b1);\n",
        "        d1[0] += (int)(p1[kc][0] ^ b0);\n"
        "        d2[0] += (int)(p2[kc][1] ^ b1);\n")]),
    ("no kv tile loads after the first", [(
        "if (t + 1 < nkv) load_kv(t + 1);", "if (false) load_kv(t + 1);")]),
    ("producer: kv staged but not quantized", [
        ("const uint2 w = FAST || n < N ? code8(x, sk, yk, hi) : make_uint2(0u, 0u);",
         "const uint2 w = make_uint2(__float_as_uint(x[0]), "
         "__float_as_uint(x[7]));"),
        ("w[j] = FAST || n < N ? code8(x, sv, yv, hi) : make_uint2(0u, 0u);",
         "w[j] = make_uint2(__float_as_uint(x[0]), __float_as_uint(x[7]));")]),
    ("producer: no kv loads (cp.async)", [
        ("cp_async16(raw + 16 * c, ks + 16 * c, n < N);", "(void)ks;"),
        ("cp_async16(raw + BN * L::RB_MAX + 16 * c, vs + 16 * c, n < N);",
         "(void)vs;")]),
    ("q: no loads", [(
        "load_chunk(qr, 8 * ((lt >> 6) + 2 * i), D, vec, x[i]);",
        "for (int e = 0; e < 8; ++e) x[i][e] = (float)(lt + e);")]),
    ("q, k, v quantized without divides", [(
        "const float q = fabsf(q0) < 65536.f ? div_rn(x, s, y, q0) : q0;",
        "const float q = q0;")]),
    ("softmax codes without divides", [
        ("const float p = div_rn(e, l, yl, __fmul_rn(e, yl));",
         "const float p = __fmul_rn(e, yl);"),
        ("const float q = r1 ? div_rn(p, s1, y1, __fmul_rn(p, y1)) : "
         "__fmul_rn(p, fhalf);",
         "const float q = __fmul_rn(p, r1 ? y1 : fhalf);")]),
    ("softmax without expf", [(
        "sc[4 * nt + e] = expf(__fsub_rn(sc[4 * nt + e], m_new[e >> 1]));",
        "sc[4 * nt + e] = __fsub_rn(sc[4 * nt + e], m_new[e >> 1]);")]),
    ("consumer: codes without arithmetic", [(
        "mrq_codes(sc[4 * (nt + (i >> 1)) + 2 * h + (i & 1)], l_new[h], yl[h],\n"
        "                    s1, y1, thr, fhalf, a.half, c1[i], c2[i]);",
        "{ c1[i] = __float_as_int(sc[4 * (nt + (i >> 1)) + 2 * h + (i & 1)]);"
        " c2[i] = c1[i] >> 8; }")]),
    ("producer and consumer arithmetic both off", [
        ("const uint2 w = FAST || n < N ? code8(x, sk, yk, hi) : make_uint2(0u, 0u);",
         "const uint2 w = make_uint2(__float_as_uint(x[0]), "
         "__float_as_uint(x[7]));"),
        ("w[j] = FAST || n < N ? code8(x, sv, yv, hi) : make_uint2(0u, 0u);",
         "w[j] = make_uint2(__float_as_uint(x[0]), __float_as_uint(x[7]));"), (
        "mrq_codes(sc[4 * (nt + (i >> 1)) + 2 * h + (i & 1)], l_new[h], yl[h],\n"
        "                    s1, y1, thr, fhalf, a.half, c1[i], c2[i]);",
        "{ c1[i] = __float_as_int(sc[4 * (nt + (i >> 1)) + 2 * h + (i & 1)]);"
        " c2[i] = c1[i] >> 8; }")]),
    ("no QK^T wgmma", [
        ("wgmma_ss0(sacc, dq, dk);",
         "for (int i = 0; i < 64; ++i) sacc[i] = t + i;"),
        ("for (int kk = 1; kk < NKC; ++kk) wgmma_ss(sacc, dq + 2 * kk, "
         "dk + 2 * kk);", "")]),
    ("no P.V wgmma", [
        ("wgmma_rs0(d, pa1[0], dv);",
         "for (int i = 0; i < NA; ++i) d[i] = pa1[i & 3][(i >> 2) & 3];"),
        ("for (int kc = 1; kc < 4; ++kc) wgmma_rs(d, pa1[kc], dv + 2 * kc);",
         ""),
        ("wgmma_rs0(d, pa2[0], dv);",
         "for (int i = 0; i < NA; ++i) d[i] = pa2[i & 3][(i >> 2) & 3];"),
        ("for (int kc = 1; kc < 4; ++kc) wgmma_rs(d, pa2[kc], dv + 2 * kc);",
         "")]),
]


# (text in the source, replacement): clock64 stamps of the wgmma kernel
TIMELINE = [
    ("  const bool vec = FAST || a.vec_ok;\n",
     "  const bool vec = FAST || a.vec_ok;\n"
     "  const long long T0 = clock64();\n  long long tl[16];\n"
     "  const bool LOGB = blockIdx.x == 0 && (blockIdx.y == 5 "
     "|| blockIdx.y == 127);\n"),
    ("    if (stage) issue(0);                // before the steps' loads\n",
     "    if (stage) issue(0);\n    tl[0] = clock64();\n"),
    ("        bar_sync(3, 128);               // every thread's copies of "
     "tile t\n",
     "        bar_sync(3, 128);\n        tl[1 + 2 * (t & 1)] = clock64();\n"),
    ("      mbar_arrive(vfull + 8 * s);\n",
     "      mbar_arrive(vfull + 8 * s);\n      tl[2 + 2 * (t & 1)] = clock64();\n"),
    ("    }\n    return;\n  }\n\n  // -- consumers",
     "    }\n    if (LOGB && pt == 0) printf(\"producer b%d issue0 %lld landed0 "
     "%lld coded0 %lld landed1 %lld coded1 %lld\\n\", blockIdx.y, "
     "tl[0] - T0, tl[1] - T0, tl[2] - T0, tl[3] - T0, tl[4] - T0);\n"
     "    return;\n  }\n\n  // -- consumers"),
    ("    bar_sync(1 + cw, 128);\n",
     "    bar_sync(1 + cw, 128);\n    tl[0] = clock64();\n"),
    ("    mbar_sleep(kfull + 8 * s, (it / STAGES) & 1);\n",
     "    mbar_sleep(kfull + 8 * s, (it / STAGES) & 1);\n"
     "    tl[1 + 4 * (t & 1)] = clock64();\n"),
    ("    fence_regs(sacc);\n",
     "    fence_regs(sacc);\n    tl[2 + 4 * (t & 1)] = clock64();\n"),
    ("    fence_regs(pa1);\n",
     "    tl[3 + 4 * (t & 1)] = clock64();\n    fence_regs(pa1);\n"),
    ("    if (lt == 0) mbar_arrive(empty + 8 * s);   // tile t's stage is free\n",
     "    tl[4 + 4 * (t & 1)] = clock64();\n"
     "    if (lt == 0) mbar_arrive(empty + 8 * s);\n"),
    ("    __syncwarp();\n  }\n  }\n}\n\n",
     "    __syncwarp();\n  }\n  }\n  if (LOGB && lt == 0) printf(\"consumer %d "
     "b%d q %lld | k0 %lld qk0 %lld codes0 %lld pv0 %lld | k1 %lld qk1 %lld "
     "codes1 %lld pv1 %lld | end %lld\\n\", cw, blockIdx.y, tl[0] - T0, "
     "tl[1] - T0, tl[2] - T0, tl[3] - T0, tl[4] - T0, tl[5] - T0, "
     "tl[6] - T0, tl[7] - T0, tl[8] - T0, clock64() - T0);\n}\n\n"),
]


# (text in the source, replacement): clock64 stamps of the composed P.V
# kernel (csrc/int8_bmm.cu) for threads 0 and 384 of two CTAs: when tile t's
# v rows landed, its v codes were made, its probability codes landed, its
# products were done; the epilogue's start and the end
COMPOSED_TIMELINE = [
    ("  const bool stage = FAST || (L::STAGE && a.vec_ok);\n",
     "  const bool stage = FAST || (L::STAGE && a.vec_ok);\n"
     "  const long long T0 = clock64();\n  long long tl[16];\n  int nt = 0;\n"
     "  const bool LOGB = (blockIdx.y == 5 || blockIdx.y == 77) "
     "&& (threadIdx.x == 0 || threadIdx.x == 384);\n"),
    ("    __syncthreads();                    // ... for every thread; t - 1 "
     "done\n",
     "    __syncthreads();\n    if (nt < 12) tl[nt++] = clock64();\n"),
    ("    cp_async_wait_n(next ? 2 : t == 0 && two ? 1 : 0);   // codes(t) "
     "landed\n",
     "    if (nt < 12) tl[nt++] = clock64();\n"
     "    cp_async_wait_n(next ? 2 : t == 0 && two ? 1 : 0);\n"),
    ("    __syncthreads();                    // the v^T tile is coded\n",
     "    __syncthreads();\n    if (nt < 12) tl[nt++] = clock64();\n"),
    ("    fence_regs(pa[1]);\n  }\n",
     "    fence_regs(pa[1]);\n    if (nt < 12) tl[nt++] = clock64();\n  }\n"),
    ("  __syncthreads();\n  const long ob = q_base(a.os, b, a.rep, a.Hk);\n",
     "  __syncthreads();\n  const long long te = clock64();\n"
     "  const long ob = q_base(a.os, b, a.rep, a.Hk);\n"),
    ("            *reinterpret_cast<const uint4*>(ys + r * L::YROW + 16 * c);\n"
     "    }\n    __syncwarp();\n  }\n}\n",
     "            *reinterpret_cast<const uint4*>(ys + r * L::YROW + 16 * c);\n"
     "    }\n    __syncwarp();\n  }\n"
     "  if (LOGB && nt >= 8) printf(\"pv b%d t%d: v0 %lld coded0 %lld codes0 "
     "%lld mma0 %lld | v1 %lld coded1 %lld codes1 %lld mma1 %lld | epi %lld "
     "end %lld\\n\", blockIdx.y, threadIdx.x, tl[0] - T0, tl[1] - T0, "
     "tl[2] - T0, tl[3] - T0, tl[4] - T0, tl[5] - T0, tl[6] - T0, "
     "tl[7] - T0, te - T0, clock64() - T0);\n}\n"),
]


def _install(text: str, name: str, lib: str = "flash_attn_mrq"):
    """Build ``text`` as the library ``lib`` (the tree's flags) and make it
    the one ``build.lib(lib)`` returns; returns the build's compiler
    output."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(text)
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                        str(build.CSRC), "-o", str(so), str(cu)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{name} failed to build:\n{r.stdout}{r.stderr}")
    _use(so, lib)
    return r.stdout + r.stderr


def _use(so, name="flash_attn_mrq"):
    """Make the built library ``so`` the one ``build.lib(name)`` returns
    (the tree's own signatures)."""
    from repro_torch.kernels import build
    build.lib(name)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in build._SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    build._LIBS[name] = lib


def timeline(composed=False):
    """Three B3 bits 8 calls of the stamped build (``TIMELINE``; with
    ``composed``, three composed calls with the P.V kernel stamped,
    ``COMPOSED_TIMELINE``); the stamps print from the card as each call
    completes."""
    import torch
    from repro_torch.kernels import build
    lib = "int8_bmm" if composed else "flash_attn_mrq"
    text = "#include <cstdio>\n" + (build.CSRC / f"{lib}.cu").read_text()
    for old, new in COMPOSED_TIMELINE if composed else TIMELINE:
        if text.count(old) != 1:
            raise RuntimeError(f"timeline: the source does not hold {old!r}")
        text = text.replace(old, new)
    saved = build.lib(lib)
    try:
        _install(text, "timeline", lib)
        gen = torch.Generator(device="cuda").manual_seed(0)
        run = make_case(8, False, False, gen, composed=composed)[0]
        for _ in range(3):
            run()
            torch.cuda.synchronize()
            print("---", flush=True)
    finally:
        build._LIBS[lib] = saved


def bound(nbytes: float, int8_ops: float, fp32_ops: float):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = (int8_ops / INT8_OPS + fp32_ops / FP32_OPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_name(name: str) -> str:
    """``void (anonymous namespace)::flash_kernel<3, 12, false>(...)`` ->
    ``flash_kernel<3, 12, false>``; other kernels by their first word."""
    m = re.search(r"(\w+_kernel)(<[^(]*?>)?\(", name)
    return m.group(1) + (m.group(2) or "") if m else name[:60]


def device_ms(run, reps: int):
    """({kernel: device ms per call}, kernel events per call, launches per
    call) of ``reps`` calls of ``run``: the times and events from the
    profiler's CUDA kernel events, the launches from the wrappers' counts
    (``gemm_times.kernel_events``, which profiles again where the profiler
    lost events; ``--src`` hence needs a tree that has it)."""
    from repro_torch.launch.gemm_times import kernel_events
    events, launched = kernel_events(run, reps)
    per = collections.Counter()
    for name, us in events:
        per[kernel_name(name)] += us
    return ({k: v / reps / 1e3 for k, v in per.items()}, len(events) / reps,
            sum(launched.values()) / reps)


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


def make_case(bits: int, vec: bool, masked: bool, gen, composed=False):
    """(run, q, k, v) of one ``ops.flash_attention`` (``composed``:
    ``ops.int8_attention``) call on the qkv views at the serving shape."""
    import torch
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    half = 2 ** (bits - 1)
    qkv = (torch.randn(B, N, 3, H, HD, device=dev, generator=gen)
           * 1.5).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    rate = 1.0 + 0.1 * torch.rand(G, 1, device=dev, generator=gen)
    s_q = rate * (6.0 / (half - 1))
    s1 = torch.clamp(8.0 * (1.0 / N) / half * rate, 1.0 / (half * half * 8),
                     1.0 / half)
    s_v = rate * (6.0 / (half - 1))
    qk_pack = {"s_q": s_q, "s_k": s_q * 1.05, "scale": s_q * s_q * 1.05,
               "bits": bits, "groups": G}
    pv_pack = {"s1": s1, "s_v": s_v, "scale1": s1 * s_v,
               "scale2": s_v * (1.0 / half), "bits": bits, "groups": G}
    tgroup = (torch.tensor(SLOT_GROUPS, dtype=torch.int32, device=dev)
              if vec else 3)
    mask = (torch.ones(N, N, dtype=torch.bool, device=dev).tril()
            if masked else None)

    attend = ops.int8_attention if composed else ops.flash_attention

    def run():
        return attend(q.reshape(B, N, H, 1, HD), k, v, qk_pack, pv_pack,
                      mask=mask, scale=HD ** -0.5, tgroup=tgroup)
    return run, q, k, v


CASES = [("B3 bits 8", 8, False, False), ("B3b bits 4 packed kv", 4, False,
                                          False),
         ("B8 bits 8", 8, True, False), ("B8 bits 4 packed kv", 4, True,
                                         False),
         ("B3 bits 8 causal mask", 8, False, True)]


def time_cases(reps: int = 30, cases=CASES, log=print):
    """One row per case: device ms by kernel, launches, wrapper ms, bound
    and SDPA ms."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, bits, vec, masked in cases:
        run, q, k, v = make_case(bits, vec, masked, gen)
        dev, events, launches = device_ms(run, reps)
        qb, kb, vb = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        nbytes = 4 * B * H * N * HD * 2 + 7 * 4 * (G if vec else 1)
        bms, by = bound(nbytes, 3 * 2 * B * H * N * N * HD,
                        SOFTMAX_FP32_PER_SCORE * B * H * N * N)
        row = {"case": name, "device_ms": sum(dev.values()),
               "by_kernel": dev, "launches": launches, "events": events,
               "wrapper_ms": wrapper_ms(run, reps), "bound_ms": bms,
               "bound_by": by, "sdpa_ms": device_ms(
                   lambda: sdpa(qb, kb, vb), reps)[0]}
        row["sdpa_ms"] = sum(row["sdpa_ms"].values())
        rows.append(row)
        log(f"  {name:<24} device {row['device_ms']:.4f} ms in "
            f"{launches:.1f} launches, {events:.2f} kernel events ("
            + ", ".join(f"{k} {t:.4f}" for k, t in sorted(
                dev.items(), key=lambda kv: -kv[1]))
            + f"); wrapper {row['wrapper_ms']:.4f} ms; bound "
            f"{bms:.4f} ms ({by}); sdpa {row['sdpa_ms']:.4f} ms")
    return rows


# (name, library, [(text in the source, replacement)]): each switches one
# part of the composed chain off while keeping the rest alive: the matmuls
# (csrc/int8_bmm.cu) and the softmax-codes pass (csrc/softmax_mrq.cu, the
# B10 entries: those marked "3-pass" fit its three-pass kernel of commit
# e903e06, run with --src on that tree, the others the register kernel
# that replaced it)
COMPOSED_ABLATIONS = [
    ("qk: no wgmma", "int8_bmm", [
        ("wgmma_ss0(acc, dq, dk);",
         "for (int i = 0; i < 64; ++i) acc[i] = t + i;"),
        ("for (int kk = 1; kk < NKC; ++kk) wgmma_ss(acc, dq + 2 * kk, "
         "dk + 2 * kk);", "")]),
    ("qk: no score stores", "int8_bmm", [(
        "            *reinterpret_cast<uint4*>(static_cast<uint8_t*>(a.out)\n"
        "                + (((long)b * M + m) * N + n0) * osz + 16 * c) =\n"
        "                *reinterpret_cast<const uint4*>(ys + rr * yp + 16 * c);",
        "            asm volatile(\"\" :: \"r\"(*reinterpret_cast<const "
        "unsigned*>(ys + rr * yp + 16 * c)));")]),
    ("qk: q and k staged but not coded", "int8_bmm", [(
        "      w = code8(x, s, y, hi);",
        "      w = make_uint2(__float_as_uint(x[0]), __float_as_uint(x[7]));")]),
    ("pv: no wgmma", "int8_bmm", [(
        "        wgmma_rs(acc1[hh], p[0], d);\n"
        "        wgmma_rs(acc2[hh], p[1], d);",
        "        acc1[hh][kc] += (int)p[0][0];\n"
        "        acc2[hh][kc] += (int)p[1][1];")]),
    ("pv: v staged but not coded", "int8_bmm", [(
        "w[j] = n < N ? code8(x, sv, yv, hi) : make_uint2(0u, 0u);",
        "w[j] = make_uint2(__float_as_uint(x[0]), __float_as_uint(x[7]));")]),
    ("pv: no codes loads", "int8_bmm", [(
        "        cp_async16(tp + r * PP + 16 * j,\n"
        "                   cb + (long)min(m, M - 1) * N + min(n, N - 16),\n"
        "                   m < M && n < N);",
        "        (void)tp;")]),
    ("pv: no v loads", "int8_bmm", [(
        "        cp_async16(raw + r * rb + 16 * raw_slot<TX>(c, r, cpc),",
        "        if (false) cp_async16(raw + r * rb + 16 * raw_slot<TX>(c, r, "
        "cpc),")]),
    ("pv: no output stores", "int8_bmm", [(
        "        *reinterpret_cast<uint4*>(static_cast<uint8_t*>(a.out)\n"
        "                                  + (ob + grow * a.os[3]) * osz + 16 * c) =\n"
        "            *reinterpret_cast<const uint4*>(ys + r * L::YROW + 16 * c);",
        "        asm volatile(\"\" :: \"r\"(*reinterpret_cast<const unsigned*>("
        "ys + r * L::YROW + 16 * c)));")]),
    ("B10 3-pass: no score loads", "softmax_mrq", [
        ("for (int j = lane; j < C; j += 32) m = fmaxf(m, ldx(xr, j));",
         "for (int j = lane; j < C; j += 32) m = fmaxf(m, (float)((j * 7) & 15));"),
        ("l = __fadd_rn(l, expf(__fsub_rn(ldx(xr, j), m)));",
         "l = __fadd_rn(l, expf(__fsub_rn((float)((j * 7) & 15), m)));"),
        ("const float p = __fdiv_rn(expf(__fsub_rn(ldx(xr, j), m)), l);",
         "const float p = __fdiv_rn(expf(__fsub_rn((float)((j * 7) & 15), m)), "
         "l);")]),
    ("B10 3-pass: one expf (the codes pass without)", "softmax_mrq", [
        ("const float p = __fdiv_rn(expf(__fsub_rn(ldx(xr, j), m)), l);",
         "const float p = __fdiv_rn(__fsub_rn(ldx(xr, j), m), l);")]),
    ("B10 3-pass: no expf", "softmax_mrq", [
        ("const float p = __fdiv_rn(expf(__fsub_rn(ldx(xr, j), m)), l);",
         "const float p = __fdiv_rn(__fsub_rn(ldx(xr, j), m), l);"),
        ("l = __fadd_rn(l, expf(__fsub_rn(ldx(xr, j), m)));",
         "l = __fadd_rn(l, __fsub_rn(ldx(xr, j), m));")]),
    ("B10 3-pass: no divides", "softmax_mrq", [
        ("const float p = __fdiv_rn(expf(__fsub_rn(ldx(xr, j), m)), l);",
         "const float p = __fmul_rn(expf(__fsub_rn(ldx(xr, j), m)), l);"),
        ("if (p < thr) c = (int)fminf(fmaxf(rintf(__fdiv_rn(p, s1g)), 0.f), hi);",
         "if (p < thr) c = (int)fminf(fmaxf(rintf(__fmul_rn(p, s1g)), 0.f), hi);"),
        ("else c = -(int)fminf(fmaxf(rintf(__fdiv_rn(p, s2)), 0.f), fhalf);",
         "else c = -(int)fminf(fmaxf(rintf(__fmul_rn(p, s2)), 0.f), fhalf);")]),
    ("B10 3-pass: no code stores", "softmax_mrq", [
        ("static_cast<int8_t*>(out)[row * C + j] = (int8_t)c;",
         "if (half < 0) static_cast<int8_t*>(out)[row * C + j] = (int8_t)c;")]),
    ("B10: no score loads", "softmax_mrq", [
        ("for (int j = 0; j < CPL; ++j) e[j] = ldx(xr, lane + 32 * j);",
         "for (int j = 0; j < CPL; ++j) e[j] = (float)(((lane + 32 * j) * 7) "
         "& 15);")]),
    ("B10: no expf", "softmax_mrq", [
        ("e[j] = expf(__fsub_rn(e[j], m));", "e[j] = __fsub_rn(e[j], m);")]),
    ("B10: no divides", "softmax_mrq", [
        ("const float p = div_rn(e, l, yl, __fmul_rn(e, yl));",
         "const float p = __fmul_rn(e, yl);"),
        ("const float q = r1 ? div_rn(p, s1, y1, __fmul_rn(p, y1)) : "
         "__fmul_rn(p, fhalf);",
         "const float q = __fmul_rn(p, r1 ? y1 : fhalf);")]),
    ("B10: no code stores (staged in shared memory)", "softmax_mrq", [
        ("for (int i = 0; i < LB / W; ++i) dst[lane + 32 * i] = "
         "src[lane + 32 * i];",
         "for (int i = 0; i < LB / W; ++i) if (a.half < 0) "
         "dst[lane + 32 * i] = src[lane + 32 * i];")]),
]

COMPOSED_CASES = [("composed bits 8", 8, False),
                  ("composed bits 4", 4, False),
                  ("composed vec bits 8", 8, True),
                  ("composed vec bits 4", 4, True)]
# the composed chain's parts by kernel name (before any "<"); the rest is
# torch glue
PARTS = {"qk_kernel": "qk", "softmax_codes_kernel": "softmax",
         "pv_kernel": "pv", "codes_kernel": "codes pre-pass"}
CODES_FP32_PER_SCORE = 7     # B10: max, sub, exp, sum, 2 divides, round
                             # (each one operation; the instructions that
                             # issue them are about 30 a score)


def composed_bounds():
    """{part: (bound ms, "bytes" or "operations")} of one composed call at
    the serving shape (bf16 q, k, v and out; the per-group parameters are
    a few bytes), and the chain's sum under "chain"."""
    x, sc = B * N * H * HD * 2, B * H * N * N
    parts = {"qk": bound(2 * x + 4 * sc, 2 * sc * HD, 0),
             "softmax": bound(4 * sc + sc, 0, CODES_FP32_PER_SCORE * sc),
             "pv": bound(sc + 2 * x, 2 * 2 * sc * HD, 0)}
    parts["chain"] = (sum(t for t, _ in parts.values()), "bytes")
    return parts


def time_composed(reps: int = 30, cases=COMPOSED_CASES, log=print):
    """One row per composed case: device ms by kernel and by part,
    launches, wrapper ms, bounds and the output's sha256."""
    import hashlib

    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    bounds = composed_bounds()
    rows = []
    for name, bits, vec in cases:
        run = make_case(bits, vec, False, gen, composed=True)[0]
        out = run()
        torch.cuda.synchronize()
        digest = hashlib.sha256(
            out.contiguous().view(torch.uint8).cpu().numpy().tobytes()
        ).hexdigest()
        dev, events, launches = device_ms(run, reps)
        parts = collections.Counter()
        for k, t in dev.items():
            parts[PARTS.get(k.split("<")[0], "torch glue")] += t
        row = {"case": name, "device_ms": sum(dev.values()),
               "by_kernel": dev, "by_part": dict(parts),
               "launches": launches, "events": events,
               "wrapper_ms": wrapper_ms(run, reps),
               "bounds": bounds, "bound_ms": bounds["chain"][0],
               "sha256": digest}
        rows.append(row)
        log(f"  {name:<22} device {row['device_ms']:.4f} ms in "
            f"{launches:.1f} launches, {events:.2f} kernel events ("
            + ", ".join(f"{p} {t:.4f}" + (
                f" [bound {bounds[p][0]:.4f}]" if p in bounds else "")
                for p, t in sorted(parts.items(), key=lambda kv: -kv[1]))
            + f"); wrapper {row['wrapper_ms']:.4f} ms; chain bound "
            f"{row['bound_ms']:.4f} ms; out sha256 {digest[:16]}")
        log("    by kernel: " + ", ".join(f"{k} {t:.4f}" for k, t in sorted(
            dev.items(), key=lambda kv: -kv[1])))
    return rows


def _patched(lib: str, patches):
    """{file name: text} of ``csrc/<lib>.cu`` and the shared headers with
    every (old, new) of ``patches`` applied where its text stands (once in
    all of them), or None where a text does not."""
    from repro_torch.kernels import build
    files = {f"{lib}.cu": (build.CSRC / f"{lib}.cu").read_text()}
    files.update({p.name: p.read_text()
                  for p in sorted(build.CSRC.glob("*.cuh"))})
    for old, new in patches:
        hits = [f for f, text in files.items() if old in text]
        if len(hits) != 1 or files[hits[0]].count(old) != 1:
            return None
        files[hits[0]] = files[hits[0]].replace(old, new)
    return files


def ablate(reps: int, log=print, composed=False):
    """Throwaway builds of the tree's flash kernel (``composed``: of the
    composed chain's libraries, ``csrc/int8_bmm.cu`` and
    ``csrc/softmax_mrq.cu``) with one part switched off each
    (``ABLATIONS``, ``COMPOSED_ABLATIONS``; a patch may hit a shared
    header, which the variant then builds from its own copy), timed on B3
    bits 8 (the composed call at bits 8) beside the tree's own build."""
    from repro_torch.kernels import build
    entries = (COMPOSED_ABLATIONS if composed
               else [(n, "flash_attn_mrq", p) for n, p in ABLATIONS])
    out_dir = build.BUILD_DIR / "ablate"
    variants = []
    for name, lib, patches in entries:
        files = _patched(lib, patches)
        if files is None:
            log(f"  ablation '{name}': source does not hold its text once; "
                "skipped")
            continue
        variants.append((name, lib, files))
    procs = []
    for i, (name, lib, files) in enumerate(variants):
        vdir = out_dir / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():
            (vdir / fname).write_text(text)
        so = vdir / f"lib{lib}.so"
        procs.append((name, lib, so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(vdir), "-o",
             str(so), str(vdir / f"{lib}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    time_row = ((lambda: time_composed(reps, COMPOSED_CASES[:1],
                                       log=lambda *a: None)[0])
                if composed else
                (lambda: time_cases(reps, CASES[:1], log=lambda *a: None)[0]))
    rows = []
    for name, lib, so, p in [("unpatched", None, None, None)] + procs:
        spills = []
        if p is not None:
            log_text, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"ablation '{name}' failed to build:\n"
                                   f"{log_text}")
            spills = [int(x) for x in re.findall(
                r"(\d+) bytes spill stores", log_text)]
            saved = build.lib(lib)           # the signatures' home
            _use(so, lib)
        try:
            row = time_row()
        finally:
            if p is not None:
                build._LIBS[lib] = saved
        row["ablation"] = name
        row["max_spill_bytes"] = max(spills, default=0)
        rows.append(row)
        parts = row["by_part"] if composed else row["by_kernel"]
        log(f"  ablation {name:<48} device {row['device_ms']:.4f} ms "
            f"(spill stores <= {row['max_spill_bytes']} B; "
            + ", ".join(f"{k} {t:.4f}" for k, t in sorted(
                parts.items(), key=lambda kv: -kv[1])) + ")")
    return rows


def time_b12(reps: int = 30, log=print):
    """B12 (``kernels.softmax_mrq``: the softmax-codes kernel with its
    dequantising epilogue) on scores of the composed call's shape, (B * H *
    N, N) = (32768, 256), bits 8: f32 in and out, bf16 in and out. One row
    each: device ms (the profiler over ``reps`` calls), wrapper ms, the
    bytes bound and the output's sha256."""
    import hashlib

    import torch
    from repro_torch import kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
    R = B * H * N
    s1 = torch.tensor(8.0 / N / 128, device="cuda")
    scores = torch.randn(R, N, device="cuda", generator=gen) * 4
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        x = scores.to(dt)
        run = lambda: kernels.softmax_mrq(x, s1, bits=8, out_dtype=dt)
        out = run()
        torch.cuda.synchronize()
        dev, events, launches = device_ms(run, reps)
        nbytes = 2 * R * N * x.element_size() + 4
        row = {"case": f"B12 {str(dt)[6:]}", "device_ms": sum(dev.values()),
               "by_kernel": dev, "launches": launches, "events": events,
               "wrapper_ms": wrapper_ms(run, reps),
               "bound_ms": bound(nbytes, 0, 0)[0],
               "sha256": hashlib.sha256(out.contiguous().view(torch.uint8)
                                        .cpu().numpy().tobytes()).hexdigest()}
        rows.append(row)
        log(f"  {row['case']:<12} device {row['device_ms']:.4f} ms in "
            f"{launches:.1f} launches, {events:.2f} kernel events; wrapper "
            f"{row['wrapper_ms']:.4f} ms; "
            f"bound {row['bound_ms']:.4f} ms (bytes); out sha256 "
            f"{row['sha256'][:16]}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None,
                    help="import repro_torch from this directory")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--label", default="")
    ap.add_argument("--ablate", action="store_true",
                    help="also time builds with one part switched off")
    ap.add_argument("--composed", action="store_true",
                    help="time ops.int8_attention instead of flash")
    ap.add_argument("--timeline", action="store_true",
                    help="print clock64 stamps of one CTA's phases")
    args = ap.parse_args(argv)
    src = args.src or os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "..")
    sys.path.insert(0, os.path.abspath(src))
    import torch
    import repro_torch
    if not torch.cuda.is_available():
        raise SystemExit("attn_times: needs a CUDA card")
    print(f"{args.label}: repro_torch from "
          f"{os.path.dirname(repro_torch.__file__)} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    if args.timeline:
        timeline(composed=args.composed)
        return
    rows = (time_composed(args.reps) + time_b12(args.reps) if args.composed
            else time_cases(args.reps))
    if args.ablate:
        rows += ablate(args.reps, composed=args.composed)
    print(json.dumps({"label": args.label, "rows": rows}))


if __name__ == "__main__":
    main()
