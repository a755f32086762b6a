"""Build the CUDA sources in ``repro_torch/csrc`` with ``nvcc`` and bind
them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain ``extern "C"`` interface (no PyTorch headers, so a build takes
seconds), named after a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so a stale library is never loaded.
``build_all`` starts one ``nvcc`` per source, all at once. Libraries go
to ``repro_torch/_build/`` (git-ignored). A failed build raises
:class:`KernelError` with the compiler's output, and so does a launch that
CUDA refuses; nothing falls back, and the serving engines never treat
a ``KernelError`` as a fault to degrade around.

Flags: ``sm_90a``; ``-fmad=false`` so no multiply-add contracts into an
FMA (the reference rounds every step); no ``--use_fast_math``, so ``/``
is the IEEE divide and ``expf`` the accurate one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("int8_fused", "int4_packed", "flash_attn_mrq", "int8_bmm",
           "softmax_mrq", "act_mrq")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


class KernelError(RuntimeError):
    """A kernel that could not be built or launched: no ``nvcc``, a failed
    compile, or a CUDA error returned by a launcher."""


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the port's kernels are built on the GPU host")
    return path


def _lib_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                             *sorted(CSRC.glob("*.cuh"))])
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{h}.so"


def build_all(names=SOURCES) -> float:
    """Compile every source not yet built, in parallel. Returns seconds."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        BUILD_LOG[name] = log
        if p.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise KernelError("\n".join(errors))
    return time.perf_counter() - t0


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGNATURES = {
    "int8_fused": {
        # map wt | N Kp
        "int8_weight_map": [_P] * 2 + [_I] * 2,
        # x wmap s_a s_b scale_a scale_b corr bias g ps bv sh sc gate res
        # out codes_a codes_b ws | M K Kp N half x_bf16 nm_bf16 res_bf16
        # out_bf16 mrq gs G ks | sh_rs sc_rs (long) | stream
        "int8_matmul_launch": [_P] * 19 + [_I] * 13 + [_L] * 2 + [_P],
        # x s_a s_b g ps bv sh sc codes_a codes_b | M K Kq half gk gkp
        # x_bf16 nm_bf16 mrq gs G | sh_rs sc_rs (long) | stream
        "prologue_codes_launch": [_P] * 10 + [_I] * 11 + [_L] * 2 + [_P],
        # a b q r | n (long) | stream
        "prologue_div_probe": [_P] * 4 + [_L] + [_P],
        # xq wmap scale corr bias g out ws | M Kp N out_bf16 ks | stream
        "int8_gemm_codes_launch": [_P] * 8 + [_I] * 5 + [_P],
    },
    "int4_packed": {
        # as int8_matmul_launch without ws | M K Kq N gk gkp nk x_bf16
        # nm_bf16 res_bf16 out_bf16 mrq gs G | sh_rs sc_rs (long) | stream
        "int4_matmul_launch": [_P] * 18 + [_I] * 14 + [_L] * 2 + [_P],
    },
    "flash_attn_mrq": {
        # q k v s_q s_k qk_scale s1 s_v scale1 scale2 g_qk g_pv mask out
        # strides (14 longs) | Bq M N D rep Hk | scale (float) | half
        # x_bf16 out_bf16 vec Gq Gp | stream
        "flash_attn_mrq_launch": [_P] * 14 + [ctypes.POINTER(ctypes.c_long)]
                                 + [_I] * 6 + [ctypes.c_float] + [_I] * 6
                                 + [_P],
        # a b q | n (long) | stream
        "flash_div_probe": [_P] * 3 + [ctypes.c_long] + [_P],
    },
    "int8_bmm": {
        # q k s_q s_k scale g out | strides (14 longs, flash's layout) |
        # Bq M N D rep Hk | alpha (float) | half x_bf16 out_bf16 gs G |
        # stream
        "int8_bmm_qk_launch": [_P] * 7 + [ctypes.POINTER(ctypes.c_long)]
                              + [_I] * 6 + [ctypes.c_float] + [_I] * 5
                              + [_P],
        # codes v s_v scale1 scale2 g out | strides | Bq M N D rep Hk half
        # x_bf16 out_bf16 gs G | stream
        "int8_bmm_pv_launch": [_P] * 7 + [ctypes.POINTER(ctypes.c_long)]
                              + [_I] * 11 + [_P],
    },
    "softmax_mrq": {
        # scores s1 g out | R (long) | C rpg half x_bf16 gs G | stream
        "softmax_mrq_codes_launch": [_P] * 4 + [ctypes.c_long] + [_I] * 6
                                    + [_P],
        # scores s1 g out | R (long) | C half x_bf16 out_bf16 | stream
        "softmax_mrq_launch": [_P] * 4 + [ctypes.c_long] + [_I] * 4 + [_P],
    },
    "act_mrq": {
        # x s_neg s_pos out | n (long) | half kind x_bf16 out_bf16 | stream
        "act_mrq_launch": [_P] * 4 + [ctypes.c_long] + [_I] * 4 + [_P],
    },
}


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first."""
    if name not in _LIBS:
        build_all((name,))
        so = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(so, fn).argtypes = argtypes
            getattr(so, fn).restype = ctypes.c_int
        so.cuda_error_string.argtypes = [ctypes.c_int]
        so.cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = so
    return _LIBS[name]


def sass_opcodes(name: str, kernel: str) -> Dict[str, List[str]]:
    """{mangled function name: its SASS instructions' opcodes in address
    order, predicates dropped (``LDG.E.128.CONSTANT``, ``FFMA``, ...)} for
    the functions of the built ``csrc/<name>.cu`` whose names contain
    ``kernel`` (``cuobjdump -sass``; builds the library first)."""
    import re
    build_all((name,))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    out: Dict[str, List[str]] = {}
    for fn in text.split("Function : ")[1:]:
        head, body = fn.split("\n", 1)
        if kernel in head:
            out[head.strip()] = re.findall(
                r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                body, re.M)
    return out


def sass_counts(name: str, kernel: str,
                ops=("IGMMA", "UTMALDG", "IMMA", "HMMA")) -> Dict[str, int]:
    """How many SASS instructions of each opcode in ``ops`` (its first
    dotted part: ``IGMMA`` counts ``IGMMA.64x128x32.S8.S8``) the functions
    of ``sass_opcodes(name, kernel)`` hold; an empty dict if no function
    matches."""
    fns = sass_opcodes(name, kernel)
    heads = [o.split(".", 1)[0] for ops_ in fns.values() for o in ops_]
    return {op: heads.count(op) for op in ops} if fns else {}


def check(err: int, name: str, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and ``torch.cuda.synchronize`` would not report it)."""
    if err != 0:
        msg = _LIBS[name].cuda_error_string(err).decode()
        raise KernelError(f"{what}: CUDA error {err} ({msg}) at launch")
