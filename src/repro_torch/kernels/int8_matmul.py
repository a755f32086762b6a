"""int8 matmul over pre-quantized codes (kernel B11) — wrapper, plain
version and launch count.

``int8_matmul`` replaces ``repro/kernels/int8_matmul.py::int8_matmul``:
``y = (xq @ wq - corr) * scale + bias`` with xq (M, K) and wq (K, N) int8
codes, scale (N,) f32 (``s_x * s_w`` per channel), corr (N,) int32
(``z_eff * colsum(wq)``), bias (N,) f32 or None; out f32 or bf16. It backs
no serving path: the fused linears (B1, ``int8_fused``) quantize inside
their own launch. CUDA tensors run ``csrc/int8_fused.cu``'s GEMM alone
(``int8_gemm_codes_launch``: B1's wgmma GEMM and its epilogue with one
group, no quantize pass), on xq zero-padded along K to 16 bytes and the
weights' k-contiguous copy and its TMA tensor map
(``int8_fused.weight_map``, made once per weight tensor). CPU tensors
take the plain version.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import build, ref
from repro_torch.kernels.int8_fused import (
    _DT, _KPAD, _need, group_ptr, split_args, weight_map,
)


def int8_matmul_plain(xq, wq, scale, corr, bias=None, *,
                      out_dtype=torch.float32):
    """Plain version of B11: ``ref.int8_matmul_ref``."""
    return ref.int8_matmul_ref(xq, wq, scale, corr, bias=bias,
                               out_dtype=out_dtype)


def int8_matmul(xq, wq, scale, corr, bias=None, *, out_dtype=torch.float32):
    """B11 (see the module docstring). CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    scale = scale.float()
    corr = corr.to(torch.int32)
    bias = None if bias is None else bias.float()
    if not _k.use_kernel(xq):
        return int8_matmul_plain(xq, wq, scale, corr, bias,
                                 out_dtype=out_dtype)
    return _launch(xq, wq, scale, corr, bias, out_dtype)


def _launch(xq, wq, scale, corr, bias, out_dtype):
    M, K = xq.shape
    N = wq.shape[1]
    dev = xq.device
    _need(wq, "wq", (torch.int8,), (K, N), dev)
    xq = xq.contiguous()
    _need(xq, "xq", (torch.int8,), (M, K), dev)
    scale, corr = scale.contiguous(), corr.contiguous()
    _need(scale, "scale", (torch.float32,), (N,), dev)
    _need(corr, "corr", (torch.int32,), (N,), dev)
    if bias is None:
        bias = torch.zeros((N,), dtype=torch.float32, device=dev)
    bias = bias.contiguous()
    _need(bias, "bias", (torch.float32,), (N,), dev)
    if out_dtype not in _DT:
        raise ValueError(f"out_dtype {out_dtype} not supported")
    # TMA reads the codes in rows of 16-byte units from a 16-byte
    # boundary: K zero-padded to 16
    Kp = -_KPAD * (-K // _KPAD)
    if Kp != K:
        xq = torch.nn.functional.pad(xq, (0, Kp - K))
    elif xq.data_ptr() % 16:
        xq = xq.clone()
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ks, ws = split_args(M, N, Kp, 1, dev, stream)
    err = build.lib("int8_fused").int8_gemm_codes_launch(
        xq.data_ptr(), weight_map(wq, Kp), scale.data_ptr(),
        corr.data_ptr(), bias.data_ptr(), group_ptr(dev, 0), out.data_ptr(),
        ws, M, Kp, N, _DT[out_dtype], ks, stream)
    build.check(err, "int8_fused", "int8_matmul")
    _k.LAUNCHES["int8_matmul"] += 1
    return out
