"""Row softmax straight to region-signed MRQ probability codes (kernel
B10a, and its per-row-group sibling B10b), and to dequantised MRQ
probabilities (B12) — wrappers, plain versions and launch counts.

``softmax_mrq_codes`` replaces ``repro/kernels/softmax_mrq.py::
softmax_mrq_codes``: over the last axis of ``scores`` (f32 or bf16,
widened to f32), ``p = exp(x - max) / rowsum``, then ``c = clip(rint(p /
s1[g]), 0, half-1)`` where ``p < half * s1[g]`` (region 1) and ``c =
-clip(rint(p / s2), 0, half)`` elsewhere (region 2, ``s2 = 1/half``,
negated so its [0, half] codes fit a signed byte). Returns int8 codes of
the scores' shape, which ``int8_bmm_pv`` consumes. CUDA tensors run the
kernel of ``csrc/softmax_mrq.cu``, CPU tensors the plain version (whose
row sum replays the kernel's order, ``ref.warp_rowsum``). A row whose sum
is NaN (a NaN or +inf score, or only -inf) codes to 0 throughout, as the
reference's int8 cast makes its NaN p; B12 gives NaN there.

``softmax_mrq_codes_vec`` (B10b) replaces ``::softmax_mrq_codes_vec``:
``gv`` is an int32 tensor of shape ``scores.shape[:-1]`` (one group per
row, the reference's contract) or of a leading part of it, each entry
then covering the rows below it: the composed attention passes its
(B*H,) slot vector for (B*H, Sq, Skv) scores, so no per-row vector is
built. An entry outside [0, G) reads the nearest group (clamped on the
device).

``softmax_mrq`` (B12) replaces ``::softmax_mrq``: the same row softmax,
then the value instead of the code, ``clip(rint(p / s1), 0, half-1) *
s1`` in region 1 and ``clip(rint(p / s2), 0, half) * s2`` in region 2,
written in ``out_dtype`` (f32 or bf16); ``s1`` is one scalar (a float or
a 0-d tensor: the caller has picked its TGQ group). It backs
``ops.softmax_mrq_op``, no serving path. Same kernel source, a
dequantising epilogue.
"""
from __future__ import annotations

import math

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import build, ref
from repro_torch.kernels.int8_fused import (
    _DT, _need, clamp_groups, group_arg, group_ptr, is_vec,
)


def softmax_mrq_codes_plain(scores, s1, g=0, *, bits=8):
    """Plain version of B10a: ``ref.softmax_mrq_codes_ref``."""
    return ref.softmax_mrq_codes_ref(scores, s1, g=g, bits=bits)


def softmax_mrq_codes_vec_plain(scores, s1, gv=None, *, bits=8):
    """Plain version of B10b, ``gv`` of any leading shape of
    ``scores.shape[:-1]`` (broadcast over the rows below each entry)."""
    if gv is not None:
        lead = scores.shape[:-1]
        gv = clamp_groups(gv, s1.shape[0]).reshape(
            tuple(gv.shape) + (1,) * (len(lead) - gv.ndim)).expand(lead)
    return ref.softmax_mrq_codes_vec_ref(scores, s1, gv=gv, bits=bits)


def softmax_mrq_plain(scores, s1, *, bits=8, out_dtype=torch.float32):
    """Plain version of B12: ``ref.softmax_mrq_ref``."""
    return ref.softmax_mrq_ref(scores, s1, bits, out_dtype=out_dtype)


def softmax_mrq(scores, s1, *, bits=8, out_dtype=torch.float32):
    """B12 (see the module docstring). CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    if not _k.use_kernel(scores):
        return softmax_mrq_plain(scores, s1, bits=bits, out_dtype=out_dtype)
    dev = scores.device
    x = scores.contiguous()
    _need(x, "scores", tuple(_DT), tuple(scores.shape), dev)
    if out_dtype not in _DT:
        raise ValueError(f"out_dtype {out_dtype} not supported")
    s1 = torch.as_tensor(s1, dtype=torch.float32, device=dev).reshape(1)
    C = scores.shape[-1]
    out = torch.empty(scores.shape, dtype=out_dtype, device=dev)
    err = build.lib("softmax_mrq").softmax_mrq_launch(
        x.data_ptr(), s1.data_ptr(), group_ptr(dev, 0), out.data_ptr(),
        x.numel() // max(C, 1), C, 2 ** (bits - 1), _DT[x.dtype],
        _DT[out_dtype], torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "softmax_mrq", "softmax_mrq")
    _k.LAUNCHES["softmax_mrq"] += 1
    return out


def softmax_mrq_codes(scores, s1, g=None, *, bits=8):
    """B10a (see the module docstring); ``g`` None is group 0."""
    g = 0 if g is None else g
    if not _k.use_kernel(scores):
        return softmax_mrq_codes_plain(scores, s1, g, bits=bits)
    return _launch(scores, s1, g, 1, bits)


def softmax_mrq_codes_vec(scores, s1, gv=None, *, bits=8):
    """B10b (see the module docstring); ``gv`` None is group 0 for every
    row."""
    lead = tuple(scores.shape[:-1])
    if gv is None:
        gv = torch.zeros(lead[:1], dtype=torch.int32, device=scores.device)
    if gv.ndim < 1 or tuple(gv.shape) != lead[:gv.ndim]:
        raise ValueError(f"softmax_mrq_codes_vec: gv {tuple(gv.shape)} is "
                         f"not a leading part of the rows {lead}")
    if not _k.use_kernel(scores):
        return softmax_mrq_codes_vec_plain(scores, s1, gv, bits=bits)
    return _launch(scores, s1, gv.reshape(-1).to(torch.int32).contiguous(),
                   math.prod(lead[gv.ndim:]), bits)


def _launch(scores, s1, g, rpg: int, bits):
    """Check the operands and launch B10a (scalar ``g``) or B10b (one
    entry of ``g`` per ``rpg`` consecutive rows)."""
    dev = scores.device
    C = scores.shape[-1]
    R = scores.numel() // max(C, 1)
    x = scores.contiguous()
    _need(x, "scores", tuple(_DT), tuple(scores.shape), dev)
    G = s1.shape[0]
    _need(s1, "s1", (torch.float32,), (G, 1), dev)
    if is_vec(g):
        _need(g, "gv", (torch.int32,), (R // rpg,), dev)
    elif not 0 <= g < G:
        raise ValueError(f"group {g} outside [0, {G})")
    out = torch.empty(scores.shape, dtype=torch.int8, device=dev)
    gptr, gs = group_arg(g, dev)
    err = build.lib("softmax_mrq").softmax_mrq_codes_launch(
        x.data_ptr(), s1.data_ptr(), gptr, out.data_ptr(), R, C, rpg,
        2 ** (bits - 1), _DT[x.dtype], gs, G,
        torch.cuda.current_stream(dev).cuda_stream)
    name = "softmax_mrq_codes" + ("_vec" if gs else "")
    build.check(err, "softmax_mrq", name)
    _k.LAUNCHES[name] += 1
    return out
