"""Fused activation -> MRQ signed quant-dequant (kernel B13) — wrapper,
plain version and launch count.

``act_mrq`` replaces ``repro/kernels/act_mrq.py::act_mrq``: elementwise
over x of any shape (f32 or bf16, widened to f32), ``h = gelu(x)`` (tanh
form, ``jax.nn.gelu(approximate=True)``'s op order) or ``h = silu(x)``,
then ``clip(rint(h / s_neg), -half, 0) * s_neg`` where ``h < 0`` and
``clip(rint(h / s_pos), 0, half-1) * s_pos`` elsewhere, in ``out_dtype``
(f32 or bf16). ``s_neg`` and ``s_pos`` are scalars (floats or 0-d
tensors: the caller has picked the TGQ group). It backs
``ops.act_mrq_op``, no serving path. CUDA tensors run the kernel of
``csrc/act_mrq.cu``, CPU tensors the plain version (``ref.act_mrq_ref``,
which spells GELU and SiLU op by op as the kernel computes them).
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import build, ref
from repro_torch.kernels.int8_fused import _DT, _need

KINDS = {"gelu": 0, "silu": 1}


def act_mrq_plain(x, s_neg, s_pos, *, bits=8, kind="gelu",
                  out_dtype=torch.float32):
    """Plain version of B13: ``ref.act_mrq_ref``."""
    return ref.act_mrq_ref(x, s_neg, s_pos, bits, kind=kind,
                           out_dtype=out_dtype)


def act_mrq(x, s_neg, s_pos, *, bits=8, kind="gelu",
            out_dtype=torch.float32):
    """B13 (see the module docstring). CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    if kind not in KINDS:
        raise ValueError(kind)
    if not _k.use_kernel(x):
        return act_mrq_plain(x, s_neg, s_pos, bits=bits, kind=kind,
                             out_dtype=out_dtype)
    dev = x.device
    x = x.contiguous()
    _need(x, "x", tuple(_DT), tuple(x.shape), dev)
    if out_dtype not in _DT:
        raise ValueError(f"out_dtype {out_dtype} not supported")
    sn, sp = (torch.as_tensor(s, dtype=torch.float32, device=dev).reshape(1)
              for s in (s_neg, s_pos))
    out = torch.empty(x.shape, dtype=out_dtype, device=dev)
    err = build.lib("act_mrq").act_mrq_launch(
        x.data_ptr(), sn.data_ptr(), sp.data_ptr(), out.data_ptr(),
        x.numel(), 2 ** (bits - 1), KINDS[kind], _DT[x.dtype],
        _DT[out_dtype], torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "act_mrq", "act_mrq")
    _k.LAUNCHES["act_mrq"] += 1
    return out
