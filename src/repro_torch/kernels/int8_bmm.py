"""Batched int8 matmuls of the composed attention chain (kernels B9a,
B9b, and their per-batch-row-group siblings B9c, B9d) — wrappers, plain
versions and launch counts.

``int8_bmm_qk`` replaces ``repro/kernels/int8_bmm.py::int8_bmm_qk``:
``scores[b] = (q8[b] @ k8[b // rep]^T) * scale[g]``, with q8 and k8 the
symmetric codes ``clip(rint(x / s), -(half-1), half-1)`` of q (steps
``s_q[g]``) and k (``s_k[g]``); ``scale`` is the combined ``s_q * s_k``
and ``alpha`` (the softmax scale) multiplies it in f32, in the kernel.
``int8_bmm_pv`` replaces ``::int8_bmm_pv``: the region-signed probability
codes of ``softmax_mrq_codes`` are split by sign into ``c1 = max(c, 0)``
and ``c2 = max(-c, 0)``, and ``out[b] = (c1 @ v8) * scale1[g] + (c2 @
v8) * scale2[g]`` with v8 the codes of ``v[b // rep]`` at ``s_v[g]``.
Both run the CUDA kernels of ``csrc/int8_bmm.cu`` on CUDA tensors (one
launch a call: the kernels code their operands in shared memory) and
their plain PyTorch versions (``*_plain``, the torch port of the
``ref.py`` oracles) on CPU tensors.

Shapes: q (B, M, D) f32/bf16; k, v (Bk, N, D) in q's dtype with B = rep *
Bk (GQA: q batch b reads kv batch b // rep, no copy); codes (B, M, N)
int8; s_q/s_k/scale and s_v/scale1/scale2: (G, 1) f32. Scores are f32 by
default, the P.V output ``out_dtype``.

The serving seam (``ops.int8_attention``): q may be the head view (B,
Sq, Hk, G, hd) of the qkv projection's output with k, v (B, Skv, Hk, hd),
at any strides with the head dim contiguous. The scores are then (B·Hk·G,
Sq, Skv) in slot-major batch·head rows, and ``int8_bmm_pv`` given such a
v returns (B, Sq, Hk, G, hd), the order the proj linear reads; the
kernels read and write those layouts where they lie, with no copy.

``int8_bmm_qk_vec`` / ``int8_bmm_pv_vec`` (B9c, B9d) replace the ``_vec``
siblings: ``gv`` is a (B,) int32 device vector (one entry per batch·head
row) and batch row b runs at group ``gv[b]`` (an entry outside [0, G)
reads the nearest group, clamped on the device). Their kv codes depend on
the q row's group: the kernels code the kv rows each q row reads with
that row's group, so GQA needs no kv copy.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import kernels as _k
from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attn_mrq import (
    MAX_HEAD_DIM, _scaled, _view, heads_view, kv_rows, kv_view,
    launch_strides, q_rows,
)
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
                out_dtype=torch.float32, alpha=1.0):
    """B9a (see the module docstring); ``g`` None is group 0. CUDA tensors
    launch the kernel, CPU tensors take the plain version."""
    g = 0 if g is None else g
    if not _k.use_kernel(q):
        return int8_bmm_qk_plain(*_rows(q, k), s_q, s_k,
                                 _scaled(scale, alpha), g, bits=bits,
                                 out_dtype=out_dtype)
    return _launch_qk(q, k, (s_q, s_k, scale), g, bits, out_dtype, alpha)


def int8_bmm_pv(codes, v, s_v, scale1, scale2, g=None, *, bits=8,
                out_dtype=torch.float32):
    """B9b (see the module docstring)."""
    g = 0 if g is None else g
    if not _k.use_kernel(codes):
        return _as_heads(int8_bmm_pv_plain(
            codes, _kv(v), s_v, scale1, scale2, g, bits=bits,
            out_dtype=out_dtype), v)
    return _launch_pv(codes, v, (s_v, scale1, scale2), g, bits, out_dtype)


def int8_bmm_qk_vec(q, k, s_q, s_k, scale, gv=None, *, bits=8,
                    out_dtype=torch.float32, alpha=1.0):
    """B9c: B9a with a per-batch-row group vector ``gv`` (None: group 0 for
    every row)."""
    B = q.shape[0] * (q.shape[2] * q.shape[3] if q.ndim == 5 else 1)
    gv = row_groups(gv, B, q.device)
    if not _k.use_kernel(q):
        return int8_bmm_qk_vec_plain(*_rows(q, k), s_q, s_k,
                                     _scaled(scale, alpha), gv, bits=bits,
                                     out_dtype=out_dtype)
    return _launch_qk(q, k, (s_q, s_k, scale), gv, bits, out_dtype, alpha)


def int8_bmm_pv_vec(codes, v, s_v, scale1, scale2, gv=None, *, bits=8,
                    out_dtype=torch.float32):
    """B9d: B9b with a per-batch-row group vector ``gv``."""
    gv = row_groups(gv, codes.shape[0], codes.device)
    if not _k.use_kernel(codes):
        return _as_heads(int8_bmm_pv_vec_plain(
            codes, _kv(v), s_v, scale1, scale2, gv, bits=bits,
            out_dtype=out_dtype), v)
    return _launch_pv(codes, v, (s_v, scale1, scale2), gv, bits, out_dtype)


def _rows(q, k):
    """The plain versions' (B, M, D) operands: head views flattened."""
    return (q_rows(q), kv_rows(k)) if q.ndim == 5 else (q, k)


def _kv(v):
    return kv_rows(v) if v.ndim == 4 else v


def _as_heads(out, v):
    """A plain P.V output (B·Hk·G, Sq, hd) in the head order (B, Sq, Hk,
    G, hd) where v was a head view."""
    if v.ndim != 4:
        return out
    B, _, Hk, hd = v.shape
    Bq, Sq = out.shape[:2]
    return out.reshape(B, Hk, Bq // (B * Hk), Sq, hd).permute(0, 3, 1, 2, 4)


def _params(params, g, Bq, dev, name):
    """Check the (G, 1) f32 parameters and the group operand; returns
    (G, group pointer, group stride)."""
    G = params[0].shape[0]
    for i, t in enumerate(params):
        _need(t, f"param {i}", (torch.float32,), (G, 1), dev)
    if is_vec(g):
        _need(g, "gv", (torch.int32,), (Bq,), dev)
    elif not 0 <= g < G:
        raise ValueError(f"{name}: group {g} outside [0, {G})")
    return (G,) + group_arg(g, dev)


def _launch_qk(q, k, params, g, bits, out_dtype, alpha):
    """Check the operands and launch B9a (scalar ``g``) or B9c (a vector)
    on (B, M, D) rows or head views; returns the scores."""
    dev = q.device
    if out_dtype not in _DT:
        raise ValueError(f"out_dtype {out_dtype} not supported")
    if q.ndim == 3 and k.ndim == 3:
        B, M, D = q.shape
        Bk, N = k.shape[:2]
        if B % Bk or tuple(k.shape) != (Bk, N, D):
            raise ValueError(f"int8_bmm_qk: q {tuple(q.shape)} against k "
                             f"{tuple(k.shape)}")
        q, k = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k))
        q, k = heads_view(q, Bk), kv_view(k)
    elif q.ndim != 5 or k.ndim != 4:
        raise ValueError(f"int8_bmm_qk: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)}: expected (B, M, D) and (Bk, N, "
                         "D), or (B, Sq, Hk, G, hd) and (B, Skv, Hk, hd)")
    Bb, M, Hk, G, D = q.shape
    N = k.shape[1]
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"int8_bmm_qk: head dim {D} (<= {MAX_HEAD_DIM})")
    _view(q, "q", tuple(_DT), (Bb, M, Hk, G, D), dev)
    _view(k, "k", (q.dtype,), (Bb, N, Hk, D), dev)
    Bq = Bb * Hk * G
    Gp, gptr, gs = _params(params, g, Bq, dev, "int8_bmm_qk")
    out = torch.empty((Bq, M, N), dtype=out_dtype, device=dev)
    strides = (ctypes.c_long * 14)(*launch_strides(q, k, k, q))
    err = build.lib("int8_bmm").int8_bmm_qk_launch(
        q.data_ptr(), k.data_ptr(), *(t.data_ptr() for t in params), gptr,
        out.data_ptr(), strides, Bq, M, N, D, G, Hk,
        float(np.float32(alpha)), 2 ** (bits - 1), _DT[q.dtype],
        _DT[out_dtype], gs, Gp, torch.cuda.current_stream(dev).cuda_stream)
    name = "int8_bmm_qk" + ("_vec" if is_vec(g) else "")
    build.check(err, "int8_bmm", name)
    _k.LAUNCHES[name] += 1
    return out


def _launch_pv(codes, v, params, g, bits, out_dtype):
    """Check the operands and launch B9b (scalar ``g``) or B9d (a vector):
    v (Bk, N, D) gives (B, M, D) rows, a head view v (B, Skv, Hk, hd)
    gives (B, Sq, Hk, G, hd)."""
    dev = codes.device
    if out_dtype not in _DT:
        raise ValueError(f"out_dtype {out_dtype} not supported")
    if codes.ndim != 3:
        raise ValueError(f"int8_bmm_pv: codes {tuple(codes.shape)}")
    Bq, M, N = codes.shape
    if v.ndim == 3:
        Bk, D = v.shape[0], v.shape[-1]
        if Bq % Bk or v.shape[1] != N:
            raise ValueError(f"int8_bmm_pv: codes {tuple(codes.shape)} "
                             f"against v {tuple(v.shape)}")
        v = v if v.stride(-1) == 1 else v.contiguous()
        result = torch.empty((Bq, M, D), dtype=out_dtype, device=dev)
        v, out = kv_view(v), heads_view(result, Bk)
    elif v.ndim == 4:
        Bb, _, Hk, D = v.shape
        if Bq % (Bb * Hk) or v.shape[1] != N:
            raise ValueError(f"int8_bmm_pv: codes {tuple(codes.shape)} "
                             f"against v {tuple(v.shape)}")
        out = result = torch.empty((Bb, M, Hk, Bq // (Bb * Hk), D),
                                   dtype=out_dtype, device=dev)
    else:
        raise ValueError(f"int8_bmm_pv: v {tuple(v.shape)}")
    Bb, _, Hk, G, D = out.shape
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"int8_bmm_pv: head dim {D} (<= {MAX_HEAD_DIM})")
    _need(codes, "codes", (torch.int8,), (Bq, M, N), dev)
    _view(v, "v", tuple(_DT), (Bb, N, Hk, D), dev)
    Gp, gptr, gs = _params(params, g, Bq, dev, "int8_bmm_pv")
    strides = (ctypes.c_long * 14)(*launch_strides(out, v, v, out))
    err = build.lib("int8_bmm").int8_bmm_pv_launch(
        codes.data_ptr(), v.data_ptr(), *(t.data_ptr() for t in params),
        gptr, out.data_ptr(), strides, Bq, M, N, D, G, Hk, 2 ** (bits - 1),
        _DT[v.dtype], _DT[out_dtype], gs, Gp,
        torch.cuda.current_stream(dev).cuda_stream)
    name = "int8_bmm_pv" + ("_vec" if is_vec(g) else "")
    build.check(err, "int8_bmm", name)
    _k.LAUNCHES[name] += 1
    return result
