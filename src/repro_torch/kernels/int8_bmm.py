"""Batched int8 matmuls of the composed attention chain (kernels B9a,
B9b, and their per-batch-row-group siblings B9c, B9d) — wrappers, plain
versions and launch counts.

``int8_bmm_qk`` replaces ``repro/kernels/int8_bmm.py::int8_bmm_qk``:
``scores[b] = (q8[b] @ k8[b // rep]^T) * scale[g]``, with q8 and k8 the
symmetric codes ``clip(rint(x / s), -(half-1), half-1)`` of q (steps
``s_q[g]``) and k (``s_k[g]``); ``scale`` is the combined ``s_q * s_k *
alpha`` (the softmax scale folded in by the caller). ``int8_bmm_pv``
replaces ``::int8_bmm_pv``: the region-signed probability codes of
``softmax_mrq_codes`` are split by sign into ``c1 = max(c, 0)`` and ``c2
= max(-c, 0)``, and ``out[b] = (c1 @ v8) * scale1[g] + (c2 @ v8) *
scale2[g]`` with v8 the codes of ``v[b // rep]`` at ``s_v[g]``. Both run
the CUDA kernels of ``csrc/int8_bmm.cu`` on CUDA tensors and their plain
PyTorch versions (``*_plain``, the torch port of the ``ref.py`` oracles)
on CPU tensors.

Shapes: q (B, M, D) f32/bf16; k, v (Bk, N, D) in q's dtype with B = rep *
Bk (GQA: q batch b reads kv batch b // rep, no copy); codes (B, M, N)
int8; s_q/s_k/scale and s_v/scale1/scale2: (G, 1) f32. Scores are f32 by
default, the P.V output ``out_dtype``.

``int8_bmm_qk_vec`` / ``int8_bmm_pv_vec`` (B9c, B9d) replace the ``_vec``
siblings: ``gv`` is a (B,) int32 device vector and batch row b runs at
group ``gv[b]`` (an entry outside [0, G) reads the nearest group, clamped
on the device). Their kv codes depend on the q row's group, so under GQA
(rep > 1) the wrapper repeats k or v over the rep q rows of each kv row
first, as B8 does.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attn_mrq import MAX_HEAD_DIM
from repro_torch.kernels.int8_fused import (
    _DT, _need, clamp_groups, group_arg, is_vec, repeat_batch, row_groups,
)


def int8_bmm_qk_plain(q, k, s_q, s_k, scale, g=0, *, bits=8,
                      out_dtype=torch.float32):
    """Plain version of B9a: ``ref.int8_bmm_qk_ref`` with k gathered per
    q batch."""
    return ref.int8_bmm_qk_ref(q, repeat_batch(k, q.shape[0]), s_q, s_k,
                               scale, g=g, bits=bits, out_dtype=out_dtype)


def int8_bmm_pv_plain(codes, v, s_v, scale1, scale2, g=0, *, bits=8,
                      out_dtype=torch.float32):
    """Plain version of B9b."""
    return ref.int8_bmm_pv_ref(codes, repeat_batch(v, codes.shape[0]), s_v,
                               scale1, scale2, g=g, bits=bits,
                               out_dtype=out_dtype)


def int8_bmm_qk_vec_plain(q, k, s_q, s_k, scale, gv=None, *, bits=8,
                          out_dtype=torch.float32):
    """Plain version of B9c."""
    return ref.int8_bmm_qk_vec_ref(
        q, repeat_batch(k, q.shape[0]), s_q, s_k, scale,
        gv=clamp_groups(gv, s_q.shape[0]), bits=bits, out_dtype=out_dtype)


def int8_bmm_pv_vec_plain(codes, v, s_v, scale1, scale2, gv=None, *, bits=8,
                          out_dtype=torch.float32):
    """Plain version of B9d."""
    return ref.int8_bmm_pv_vec_ref(
        codes, repeat_batch(v, codes.shape[0]), s_v, scale1, scale2,
        gv=clamp_groups(gv, s_v.shape[0]), bits=bits, out_dtype=out_dtype)


def int8_bmm_qk(q, k, s_q, s_k, scale, g=None, *, bits=8,
                out_dtype=torch.float32):
    """B9a (see the module docstring); ``g`` None is group 0. CUDA tensors
    launch the kernel, CPU tensors take the plain version."""
    g = 0 if g is None else g
    if not _k.use_kernel(q):
        return int8_bmm_qk_plain(q, k, s_q, s_k, scale, g, bits=bits,
                                 out_dtype=out_dtype)
    return _launch("qk", q, k, (s_q, s_k, scale), g, bits, out_dtype)


def int8_bmm_pv(codes, v, s_v, scale1, scale2, g=None, *, bits=8,
                out_dtype=torch.float32):
    """B9b (see the module docstring)."""
    g = 0 if g is None else g
    if not _k.use_kernel(codes):
        return int8_bmm_pv_plain(codes, v, s_v, scale1, scale2, g, bits=bits,
                                 out_dtype=out_dtype)
    return _launch("pv", codes, v, (s_v, scale1, scale2), g, bits, out_dtype)


def int8_bmm_qk_vec(q, k, s_q, s_k, scale, gv=None, *, bits=8,
                    out_dtype=torch.float32):
    """B9c: B9a with a per-batch-row (B,) int32 group vector ``gv`` (None:
    group 0 for every row)."""
    B = q.shape[0]
    gv = row_groups(gv, B, q.device)
    if not _k.use_kernel(q):
        return int8_bmm_qk_vec_plain(q, k, s_q, s_k, scale, gv, bits=bits,
                                     out_dtype=out_dtype)
    return _launch("qk", q, repeat_batch(k, B), (s_q, s_k, scale), gv, bits,
                   out_dtype)


def int8_bmm_pv_vec(codes, v, s_v, scale1, scale2, gv=None, *, bits=8,
                    out_dtype=torch.float32):
    """B9d: B9b with a per-batch-row (B,) int32 group vector ``gv``."""
    B = codes.shape[0]
    gv = row_groups(gv, B, codes.device)
    if not _k.use_kernel(codes):
        return int8_bmm_pv_vec_plain(codes, v, s_v, scale1, scale2, gv,
                                     bits=bits, out_dtype=out_dtype)
    return _launch("pv", codes, repeat_batch(v, B), (s_v, scale1, scale2),
                   gv, bits, out_dtype)


def _launch(kind, a, b, params, g, bits, out_dtype):
    """Check the operands and launch B9a/B9b (scalar ``g``) or B9c/B9d
    (a (B,) vector). ``a`` is q (qk) or the codes (pv), ``b`` k or v."""
    vec = is_vec(g)
    B, M, K = a.shape
    Bk, N, D = b.shape
    qk = kind == "qk"
    if B % Bk or not 0 < D <= MAX_HEAD_DIM or (qk and K != D) or (
            not qk and K != N):
        raise ValueError(f"int8_bmm_{kind}: {tuple(a.shape)} against "
                         f"{tuple(b.shape)} (head dim <= {MAX_HEAD_DIM})")
    if out_dtype not in _DT:
        raise ValueError(f"out_dtype {out_dtype} not supported")
    dev = a.device
    a, b = a.contiguous(), b.contiguous()
    if qk:
        _need(a, "q", tuple(_DT), (B, M, D), dev)
        _need(b, "k", (a.dtype,), (Bk, N, D), dev)
    else:
        _need(a, "codes", (torch.int8,), (B, M, N), dev)
        _need(b, "v", tuple(_DT), (Bk, N, D), dev)
    G = params[0].shape[0]
    for i, t in enumerate(params):
        _need(t, f"param {i}", (torch.float32,), (G, 1), dev)
    if vec:
        _need(g, "gv", (torch.int32,), (B,), dev)
        if Bk != B:
            raise ValueError(f"int8_bmm_{kind}_vec codes kv per batch row: "
                             f"{Bk} kv rows for {B} rows")
    elif not 0 <= g < G:
        raise ValueError(f"group {g} outside [0, {G})")
    gptr, gs = group_arg(g, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    so = build.lib("int8_bmm")
    Np = -128 * (-N // 128)
    if qk:
        DQ, Mp = -32 * (-D // 32), -64 * (-M // 64)
        out = torch.empty((B, M, N), dtype=out_dtype, device=dev)
        q8 = torch.empty((B, Mp, DQ), dtype=torch.int8, device=dev)
        k8 = torch.empty((Bk, Np, DQ), dtype=torch.int8, device=dev)
        err = so.int8_bmm_qk_launch(
            a.data_ptr(), b.data_ptr(), *(t.data_ptr() for t in params),
            gptr, out.data_ptr(), q8.data_ptr(), k8.data_ptr(), B, M, N, D,
            B // Bk, 2 ** (bits - 1), _DT[a.dtype], _DT[out_dtype], gs, G,
            stream)
    else:
        out = torch.empty((B, M, D), dtype=out_dtype, device=dev)
        v8t = torch.empty((Bk, -8 * (-D // 8), Np), dtype=torch.int8,
                          device=dev)
        err = so.int8_bmm_pv_launch(
            a.data_ptr(), b.data_ptr(), *(t.data_ptr() for t in params),
            gptr, out.data_ptr(), v8t.data_ptr(), B, M, N, D, B // Bk,
            2 ** (bits - 1), _DT[b.dtype], _DT[out_dtype], gs, G, stream)
    name = f"int8_bmm_{kind}" + ("_vec" if vec else "")
    build.check(err, "int8_bmm", name)
    _k.LAUNCHES[name] += 1
    return out
