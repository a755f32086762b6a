"""Hand-written CUDA kernels for the serving path, their wrappers and
their plain PyTorch versions.

``LAUNCHES`` counts kernel launches per kernel: a wrapper adds one where
it launches its CUDA kernel and nowhere else (plain-version calls never
count), so a run can show that its path went through the kernels. The
packed-kv flash variants, the three kernels of the composed attention
chain (B9a, B10a, B9b), the per-row-group ``*_vec`` kernels of the
continuous-batching path and the public API's B11 ``int8_matmul``, B12
``softmax_mrq`` and B13 ``act_mrq`` count under their own keys.

The package exports mirror ``repro.kernels``: the kernels' entry points,
the nibble helpers, ``ops`` and ``ref``.
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
            "int8_bmm_pv_vec": 0, "int8_matmul": 0, "softmax_mrq": 0,
            "act_mrq": 0}

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


# the exports of ``repro.kernels`` (after the names above: the kernel
# modules import this package for LAUNCHES and use_kernel)
from repro_torch.kernels.int8_matmul import int8_matmul  # noqa: E402
from repro_torch.kernels.int8_fused import (  # noqa: E402
    int8_matmul_fq, int8_matmul_mrq_fq,
)
from repro_torch.kernels.int4_packed import (  # noqa: E402
    int4_matmul_fq, int4_matmul_mrq_fq,
)
from repro_torch.kernels.ref import (  # noqa: E402
    nibble_split, pack_int4, unpack_int4,
)
from repro_torch.kernels.int8_bmm import int8_bmm_pv, int8_bmm_qk  # noqa: E402
from repro_torch.kernels.flash_attn_mrq import flash_attn_mrq  # noqa: E402
from repro_torch.kernels.softmax_mrq import (  # noqa: E402
    softmax_mrq, softmax_mrq_codes,
)
from repro_torch.kernels.act_mrq import act_mrq  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
