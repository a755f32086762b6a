"""Hand-written CUDA kernels for the serving path, their wrappers and
their plain PyTorch versions.

``LAUNCHES`` counts kernel launches per kernel: a wrapper adds one where
it launches its CUDA kernel and nowhere else (plain-version calls never
count), so a run can show that its path went through the kernels. The
packed-kv flash variants, the three kernels of the composed attention
chain (B9a, B10a, B9b) and the per-row-group ``*_vec`` kernels of the
continuous-batching path count under their own keys.
"""
from __future__ import annotations

import contextlib

LAUNCHES = {"int8_matmul_fq": 0, "int8_matmul_mrq_fq": 0,
            "int4_matmul_fq": 0, "int4_matmul_mrq_fq": 0,
            "flash_attn_mrq": 0, "flash_attn_mrq_packed_kv": 0,
            "int8_matmul_fq_vec": 0, "int8_matmul_mrq_fq_vec": 0,
            "int4_matmul_fq_vec": 0, "int4_matmul_mrq_fq_vec": 0,
            "flash_attn_mrq_vec": 0, "flash_attn_mrq_vec_packed_kv": 0,
            "int8_bmm_qk": 0, "softmax_mrq_codes": 0, "int8_bmm_pv": 0,
            "int8_bmm_qk_vec": 0, "softmax_mrq_codes_vec": 0,
            "int8_bmm_pv_vec": 0}

_STATE = {"plain_on_cuda": False}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def plain_on_cuda():
    """Within this block the wrappers run their plain versions on CUDA
    tensors too — only for holding a whole forward on the card against
    the kernels' one (``chip_smoke.py``); never a fallback."""
    prev = _STATE["plain_on_cuda"]
    _STATE["plain_on_cuda"] = True
    try:
        yield
    finally:
        _STATE["plain_on_cuda"] = prev


def use_kernel(t) -> bool:
    """Dispatch rule shared by every wrapper: CUDA tensors launch the
    kernel, CPU tensors take the plain version, anything else raises."""
    if t.device.type == "cuda":
        return not _STATE["plain_on_cuda"]
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain version for device {t.device}")
