"""Fused int8 linears (kernels B1 and B2, and their per-row-group
siblings B6a and B6b) — wrappers, plain versions and launch counts.

``int8_matmul_fq`` replaces ``repro/kernels/int8_fused.py::int8_matmul_fq``,
``int8_matmul_mrq_fq`` replaces ``::int8_matmul_mrq_fq``, and
``int8_matmul_fq_vec`` / ``int8_matmul_mrq_fq_vec`` replace their
``_vec`` siblings; all run the CUDA kernels in ``csrc/int8_fused.cu`` on
CUDA tensors and their plain PyTorch version (``*_plain``, the torch port
of the ``ref.py`` oracle) on CPU tensors.

Computes (B1) ``y = ((clip(rint(x'/sx[g]) + zx[g] - half, -half, half-1)
@ wq) - corr[g]) * scale[g] + bias`` and (B2) the MRQ sign split
``accn*scale_neg[g] + accp*scale_pos[g] + bias``, with the optional
prologue ``x' = ((x - mu) * rsig) * (1 + sc[b]) + sh[b]`` then ``/ ps`` and
the optional epilogue ``res + gate[b] * y``. The layernorm row stats
(mu, rsig) are computed inside the kernel's prologue pass
(``csrc/prologue.cuh``); the plain version replays their summation order
(``ref.layernorm_stats``).

Shapes: x (M, K) f32/bf16; wq (K, N) int8; sx/zx (G, 1) f32; scale (G, N)
f32; corr (G, N) int32; bias (N,); ps (K,); nm = (shift, scale) (B, K)
f32 or bf16, read at their row stride (the chunk views of the adaLN
output, no copy); gr = (gate (B, N), residual (M, N)); bv (M,) int32
row -> batch map.

The ``_vec`` forms take ``gv``, an (M,) int32 device tensor, instead of
the scalar ``g``: row i runs with group gv[i] (the slot pool's rows sit
at different timesteps). gv stays on the device all the way into the
kernel — no host read of it. An entry outside [0, G) reads the nearest
group: the kernels clamp each group index on the device (``group_at``,
``csrc/common.cuh``), and the plain versions clamp alike.
"""
from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import build, ref

_DT = {torch.float32: 0, torch.bfloat16: 1}


def is_vec(g) -> bool:
    """True for a per-row group vector (a 1-D tensor), False for a
    scalar group."""
    return isinstance(g, torch.Tensor) and g.ndim == 1


def row_groups(gv, M: int, dev):
    """The ``_vec`` kernels' gv operand: (M,) int32 contiguous on ``dev``
    (group 0 for every row when None)."""
    if gv is None:
        return torch.zeros((M,), dtype=torch.int32, device=dev)
    return gv.to(torch.int32).contiguous()


def repeat_batch(t, B: int):
    """(Bk, ...) -> (B, ...): batch row j serves rows j*rep .. (j+1)*rep
    - 1 (expand, no host read). The ``_vec`` attention kernels code kv
    per q row, so under GQA each q row gets its own kv copy."""
    Bk = t.shape[0]
    if Bk == B:
        return t
    return t[:, None].expand((Bk, B // Bk) + tuple(t.shape[1:])) \
        .reshape((B,) + tuple(t.shape[1:]))


def clamp_groups(gv, G: int):
    """A plain version's group vector clamped into [0, G), as the kernels
    clamp each index they read."""
    return None if gv is None else torch.clamp(gv, 0, G - 1)


def group_arg(g, dev):
    """(device pointer, row stride) of the group operand: a scalar group's
    entry in the cached index table with stride 0, or a per-row vector's
    own storage with stride 1."""
    if is_vec(g):
        return g.data_ptr(), 1
    return group_ptr(dev, g), 0


def group_ptr(dev, g: int) -> int:
    """Device pointer to the int32 group index ``g`` (one cached
    ``arange`` per device, so no host->device copy per launch)."""
    key = ("gidx", str(dev))
    t = _CACHE.get(key)
    if t is None:
        t = _CACHE[key] = torch.arange(4096, dtype=torch.int32, device=dev)
    if not 0 <= g < t.numel():
        raise ValueError(f"group index {g} out of range")
    return t.data_ptr() + 4 * int(g)


_CACHE: dict = {}
_KPAD = 16               # codes and weights pad K to 16 bytes (TMA rows)
_BM, _BN, _BK = 128, 144, 128    # the GEMM's tile (csrc/int8_fused.cu)
_LAYOUTS: dict = {}      # id(weight) -> (weakref to it, {tag: layout copy})


def cached_layout(w, tag, build):
    """``build(w)``, made once per tensor ``w`` (a weight, or a forward's
    group vector) and ``tag`` and freed with ``w``: the table holds a weak
    reference to ``w`` beside the result, and a finalizer drops the entry
    when ``w`` is collected."""
    key = id(w)
    hit = _LAYOUTS.get(key)
    if hit is None or hit[0]() is not w:
        hit = _LAYOUTS[key] = (weakref.ref(w), {})
        weakref.finalize(w, _LAYOUTS.pop, key, None)
    if tag not in hit[1]:
        hit[1][tag] = build(w)
    return hit[1][tag]


def _transposed(wq, Kp: int):
    """The weight codes as (N, Kp), k-contiguous and zero-padded along K —
    the K-major layout the kernel's wgmma B operand reads. Built once per
    weight tensor on the device and kept while the weight lives (int8: the
    weights' own size again)."""
    def build(w):
        K, N = w.shape
        wt = torch.zeros((N, Kp), dtype=torch.int8, device=w.device)
        wt[:, :K] = w.t()
        return wt
    return cached_layout(wq, ("int8", Kp), build)


def weight_map(wq, Kp: int):
    """Address of the TMA tensor map (128 host bytes) of ``_transposed(wq,
    Kp)``, built once per weight tensor and kept with that copy."""
    def encode(w):
        wt = _transposed(w, Kp)
        m = ctypes.create_string_buffer(128)
        build.check(build.lib("int8_fused").int8_weight_map(
            ctypes.addressof(m), wt.data_ptr(), wt.shape[0], Kp),
            "int8_fused", "int8 weight tensor map")
        return m
    return ctypes.addressof(cached_layout(wq, ("int8_map", Kp), encode))


@functools.lru_cache(maxsize=None)
def split_k(M: int, N: int, Kp: int, sms: int) -> int:
    """The GEMM's K splits (one CTA per SM): none where the tile grid
    fills half of the ``sms`` SMs or more; else the fewest splits that
    give the fewest k tiles per CTA within one wave."""
    tiles = -(-M // _BM) * -(-N // _BN)
    nk = -(-Kp // _BK)
    if 2 * tiles > sms:
        return 1
    return min(range(1, min(nk, sms // tiles) + 1),
               key=lambda s: (-(-nk // s), s))


def split_args(M: int, N: int, Kp: int, planes: int, dev, stream):
    """(ks, workspace pointer) of one GEMM launch: the split-K workspace
    (``planes`` M x N s32 sums and one count per tile) when ks > 1, one
    zeroed buffer per (device, stream) that every launch leaves zero."""
    sms = _CACHE.get(("sms", str(dev)))
    if sms is None:
        sms = _CACHE[("sms", str(dev))] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    ks = split_k(M, N, Kp, sms)
    if ks == 1:
        return 1, None
    n = planes * M * N + -(-M // _BM) * -(-N // _BN)
    key = ("ws", str(dev), stream)
    ws = _CACHE.get(key)
    if ws is None or ws.numel() < n:
        ws = _CACHE[key] = torch.zeros((max(n, 1 << 16),), dtype=torch.int32,
                                       device=dev)
    return ks, ws.data_ptr()


def _need(t, name, dtype, shape, dev, contiguous=True):
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if t.dtype not in dtype:
        raise ValueError(f"{name} dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {shape}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def mod_rows(nm, K: int, dev):
    """The kernel's view of the adaLN modulation rows ``nm = (shift,
    scale)``, each (B, K): (shift, scale, shift's row stride, scale's row
    stride, 1 if bf16), in their own dtype where both share one (f32 or
    bf16) and their columns are unit-stride, else as f32 copies."""
    sh, sc = nm
    for name, t in (("shift", sh), ("scale", sc)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if t.ndim != 2 or t.shape[1] != K or t.shape[0] != sh.shape[0]:
            raise ValueError(f"{name} shape {tuple(t.shape)}, expected "
                             f"({sh.shape[0]}, {K})")
    if sh.dtype != sc.dtype or sh.dtype not in _DT:
        sh, sc = sh.float(), sc.float()
    sh, sc = (t if t.stride(1) == 1 else t.contiguous() for t in (sh, sc))
    return sh, sc, sh.stride(0), sc.stride(0), _DT[sh.dtype]


def check_operands(x, scale_shape, s_a, s_b, scale_a, scale_b, corr, bias,
                   g, ps, nm, gr, bv, out_dtype):
    """Validate what every fused linear takes besides its weights: x, the
    (G, 1) activation steps, the scale (and corr) stacks of
    ``scale_shape`` = (G, ..., N), bias, the group and the optional
    fusions. Returns the fusion operands in the launchers' order (shift,
    scale, gate, residual: None where a fusion is off; then the
    modulation rows' strides and bf16 flag, ``mod_rows``)."""
    M, K = x.shape
    G, N = scale_shape[0], scale_shape[-1]
    dev = x.device
    f32, i32 = (torch.float32,), (torch.int32,)
    _need(x, "x", tuple(_DT), (M, K), dev)
    for nm_, t in (("s_a", s_a), ("s_b", s_b)):
        _need(t, nm_, f32, (G, 1), dev)
    _need(scale_a, "scale_a", f32, scale_shape, dev)
    if scale_b is not None:
        _need(scale_b, "scale_b", f32, scale_shape, dev)
    else:
        _need(corr, "corr", i32, scale_shape, dev)
    _need(bias, "bias", f32, (N,), dev)
    if is_vec(g):
        _need(g, "gv", i32, (M,), dev)
    elif not 0 <= g < G:
        raise ValueError(f"group {g} outside [0, {G})")
    if out_dtype not in _DT:
        raise ValueError(f"out_dtype {out_dtype} not supported")
    sh = sc = gate = res = None
    sh_rs = sc_rs = nm_bf16 = 0
    if ps is not None:
        _need(ps, "ps", f32, (K,), dev)
    if nm is not None or gr is not None:
        _need(bv, "bv", i32, (M,), dev)
    if nm is not None:
        sh, sc, sh_rs, sc_rs, nm_bf16 = mod_rows(nm, K, dev)
    if gr is not None:
        gate, res = gr
        _need(gate, "gate", f32, (gate.shape[0], N), dev)
        _need(res, "residual", tuple(_DT), (M, N), dev)
    return sh, sc, gate, res, sh_rs, sc_rs, nm_bf16


def _launch(mrq, x, wq, s_a, s_b, scale_a, scale_b, corr, bias, g, ps,
            nm, gr, bv, bits, out_dtype):
    M, K = x.shape
    N = wq.shape[1]
    dev = x.device
    # any strides: the kernel reads ``_transposed(wq)``, a K-major copy
    # made once per weight (the tied lm_head's codes are emb.T's)
    _need(wq, "wq", (torch.int8,), (K, N), dev, contiguous=False)
    sh, sc, gate, res, sh_rs, sc_rs, nm_bf16 = check_operands(
        x, (scale_a.shape[0], N), s_a, s_b, scale_a, scale_b, corr, bias, g,
        ps, nm, gr, bv, out_dtype)
    Kp = -_KPAD * (-K // _KPAD)
    wmap = weight_map(wq, Kp)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    codes = torch.empty((2 if mrq else 1, M, Kp), dtype=torch.int8, device=dev)
    gptr, gs = group_arg(g, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ks, ws = split_args(M, N, Kp, 2 if mrq else 1, dev, stream)
    so = build.lib("int8_fused")
    err = so.int8_matmul_launch(
        x.data_ptr(), wmap, s_a.data_ptr(), s_b.data_ptr(),
        scale_a.data_ptr(), _ptr(scale_b), _ptr(corr), bias.data_ptr(),
        gptr, _ptr(ps), _ptr(bv), _ptr(sh), _ptr(sc), _ptr(gate),
        _ptr(res), out.data_ptr(), codes[0].data_ptr(),
        codes[-1].data_ptr(), ws, M, K, Kp, N, 2 ** (bits - 1),
        _DT[x.dtype], nm_bf16, _DT[res.dtype] if res is not None else 0,
        _DT[out_dtype], int(mrq), gs, scale_a.shape[0], ks, sh_rs, sc_rs,
        stream)
    name = ("int8_matmul_mrq_fq" if mrq else "int8_matmul_fq") + \
        ("_vec" if gs else "")
    build.check(err, "int8_fused", name)
    _k.LAUNCHES[name] += 1
    return out


def prep(x, gr, bias, N):
    """(bias, gr) as the launchers take them: an f32 bias (zeros where
    None; ``ops`` hands the serving path's cached f32 copy), the gate in
    f32 and both contiguous."""
    if bias is None:
        bias = torch.zeros((N,), dtype=torch.float32, device=x.device)
    if gr is not None:
        gate, res = gr
        gr = (gate.float().contiguous(), res.contiguous())
    return bias.float().contiguous(), gr


def int8_matmul_fq_plain(x, wq, sx, zx, scale, corr, bias=None, g=0, *,
                         ps=None, nm=None, gr=None, bv=None,
                         bits=8, out_dtype=torch.float32):
    """Plain version of B1: ``ref.int8_matmul_fq_fused_ref``."""
    return ref.int8_matmul_fq_fused_ref(
        x, wq, sx, zx, scale, corr, bias=bias, g=g, ps=ps, nm=nm, gr=gr,
        bv=bv, bits=bits, out_dtype=out_dtype)


def int8_matmul_mrq_fq_plain(x, wq, s_neg, s_pos, scale_neg, scale_pos,
                             bias=None, g=0, *, ps=None, nm=None,
                             gr=None, bv=None, bits=8,
                             out_dtype=torch.float32):
    """Plain version of B2."""
    return ref.int8_matmul_mrq_fq_fused_ref(
        x, wq, s_neg, s_pos, scale_neg, scale_pos, bias=bias, g=g, ps=ps,
        nm=nm, gr=gr, bv=bv, bits=bits, out_dtype=out_dtype)


def int8_matmul_fq(x, wq, sx, zx, scale, corr, bias=None, g=0, *, ps=None,
                   nm=None, gr=None, bv=None, bits=8,
                   out_dtype=torch.float32):
    """B1 (see the module docstring). CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    bias, gr = prep(x, gr, bias, wq.shape[1])
    if _k.use_kernel(x):
        return _launch(False, x.contiguous(), wq, sx, zx, scale, None, corr,
                       bias, g, ps, nm, gr, bv, bits, out_dtype)
    return int8_matmul_fq_plain(x, wq, sx, zx, scale, corr, bias, g, ps=ps,
                                nm=nm, gr=gr, bv=bv, bits=bits,
                                out_dtype=out_dtype)


def int8_matmul_mrq_fq(x, wq, s_neg, s_pos, scale_neg, scale_pos, bias=None,
                       g=0, *, ps=None, nm=None, gr=None, bv=None, bits=8,
                       out_dtype=torch.float32):
    """B2 (see the module docstring)."""
    bias, gr = prep(x, gr, bias, wq.shape[1])
    if _k.use_kernel(x):
        return _launch(True, x.contiguous(), wq, s_neg, s_pos, scale_neg,
                       scale_pos, None, bias, g, ps, nm, gr, bv,
                       bits, out_dtype)
    return int8_matmul_mrq_fq_plain(
        x, wq, s_neg, s_pos, scale_neg, scale_pos, bias, g, ps=ps,
        nm=nm, gr=gr, bv=bv, bits=bits, out_dtype=out_dtype)


def int8_matmul_fq_vec_plain(x, wq, sx, zx, scale, corr, bias=None,
                             gv=None, *, ps=None, nm=None,
                             gr=None, bv=None, bits=8,
                             out_dtype=torch.float32):
    """Plain version of B6a: ``ref.int8_matmul_fq_vec_fused_ref``."""
    return ref.int8_matmul_fq_vec_fused_ref(
        x, wq, sx, zx, scale, corr, bias=bias,
        gv=clamp_groups(gv, scale.shape[0]), ps=ps, nm=nm, gr=gr,
        bv=bv, bits=bits, out_dtype=out_dtype)


def int8_matmul_mrq_fq_vec_plain(x, wq, s_neg, s_pos, scale_neg, scale_pos,
                                 bias=None, gv=None, *, ps=None, nm=None,
                                 gr=None, bv=None, bits=8,
                                 out_dtype=torch.float32):
    """Plain version of B6b."""
    return ref.int8_matmul_mrq_fq_vec_fused_ref(
        x, wq, s_neg, s_pos, scale_neg, scale_pos, bias=bias,
        gv=clamp_groups(gv, scale_neg.shape[0]), ps=ps,
        nm=nm, gr=gr, bv=bv, bits=bits, out_dtype=out_dtype)


def int8_matmul_fq_vec(x, wq, sx, zx, scale, corr, bias=None, gv=None, *,
                       ps=None, nm=None, gr=None, bv=None, bits=8,
                       out_dtype=torch.float32):
    """B6a: B1 with a per-row (M,) int32 group vector ``gv`` (see the
    module docstring). CUDA tensors launch the kernel, CPU tensors take
    the plain version."""
    bias, gr = prep(x, gr, bias, wq.shape[1])
    gv = row_groups(gv, x.shape[0], x.device)
    if _k.use_kernel(x):
        return _launch(False, x.contiguous(), wq, sx, zx, scale, None, corr,
                       bias, gv, ps, nm, gr, bv, bits, out_dtype)
    return int8_matmul_fq_vec_plain(x, wq, sx, zx, scale, corr, bias, gv,
                                    ps=ps, nm=nm, gr=gr, bv=bv,
                                    bits=bits, out_dtype=out_dtype)


def int8_matmul_mrq_fq_vec(x, wq, s_neg, s_pos, scale_neg, scale_pos,
                           bias=None, gv=None, *, ps=None, nm=None, gr=None,
                           bv=None, bits=8, out_dtype=torch.float32):
    """B6b: B2 with a per-row group vector ``gv``."""
    bias, gr = prep(x, gr, bias, wq.shape[1])
    gv = row_groups(gv, x.shape[0], x.device)
    if _k.use_kernel(x):
        return _launch(True, x.contiguous(), wq, s_neg, s_pos, scale_neg,
                       scale_pos, None, bias, gv, ps, nm, gr, bv,
                       bits, out_dtype)
    return int8_matmul_mrq_fq_vec_plain(
        x, wq, s_neg, s_pos, scale_neg, scale_pos, bias, gv, ps=ps,
        nm=nm, gr=gr, bv=bv, bits=bits, out_dtype=out_dtype)
