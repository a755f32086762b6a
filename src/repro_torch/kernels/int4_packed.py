"""Packed-int4 fused linears (kernels B4 and B5, and their per-row-group
siblings B7a and B7b) — wrappers, plain versions and launch counts.

``int4_matmul_fq`` replaces ``repro/kernels/int4_packed.py::int4_matmul_fq``,
``int4_matmul_mrq_fq`` replaces ``::int4_matmul_mrq_fq``, and
``int4_matmul_fq_vec`` / ``int4_matmul_mrq_fq_vec`` replace their
``_vec`` siblings; all run the CUDA kernels in ``csrc/int4_packed.cu`` on
CUDA tensors and their plain PyTorch version (``*_plain``, the torch port
of the ``ref.py`` oracle) on CPU tensors.

Weights are signed 4-bit codes two per byte along K (``ref.pack_int4``:
row ``2i`` in byte ``i``'s low nibble, ``2i + 1`` in its high nibble),
with a scale per (K group of ``group_k`` rows, output channel). Computes
(B4) ``y = sum_kg (q4(x') @ w[kg] - corr[g, kg]) * scale[g, kg] + bias``
and (B5) the MRQ sign split ``sum_kg (qn @ w[kg]) * scale_neg[g, kg] +
(qp @ w[kg]) * scale_pos[g, kg] + bias``, each group's partial added into
an f32 accumulator in ascending order; activation codes at 4 bits
(``clip(rint(x'/sx[g]) + zx[g] - 8, -8, 7)``). The fusions (``ps``,
``nm``, ``gr``, ``bv``) are B1's (``kernels/int8_fused.py``).

Shapes: x (M, K) f32/bf16; wp (Kp/2, N) int8 with Kp = nk * group_k >= K;
sx/zx (G, 1) f32; scale (G, nk, N) f32; corr (G, nk, N) int32. The
``_vec`` forms take an (M,) int32 device vector ``gv`` in place of ``g``
(row i rescales each K group with ``scale[gv[i], kg]``), as
``kernels/int8_fused.py`` describes.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import build, ref
from repro_torch.kernels.int8_fused import (
    _DT, _need, _ptr, cached_layout, check_operands, clamp_groups,
    group_arg, prep, row_groups,
)

_BK = 128                # the kernel's k tile (csrc/int4_packed.cu)
_BW = 128                # its channel tile: two consumer warpgroups of 64
_MAX_GROUP_K = 32768     # the kernel's bound (exact s32 and f32 steps)


def _padded_group(group_k: int) -> int:
    """Code columns per K group in the kernel: group_k rounded up to the
    128-deep k tile, so no tile straddles two scale groups."""
    return -_BK * (-group_k // _BK)


# Byte order inside each 16-byte chunk (32 k codes, one k32 step) of a
# channel: bytes 4t..4t+3 hold k 4t..4t+3 (pack bytes 2t, 2t+1) and k
# 16+4t..19+4t (pack bytes 8+2t, 9+2t) — the two registers of wgmma's A
# fragment that thread t of a quad holds for that channel.
_FRAGMENT_ORDER = (0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15)


def _weight_layout(wp, group_k: int):
    """The packed weights as the kernel streams them: a flat int8 tensor of
    8192-byte blocks, one per (tile of 128 channels, k tile of 128), the
    channel tile major. Channels past N and each K group's padding up to
    ``_padded_group(group_k)`` are zero bytes. Within a block, channel
    ``64 c + 16 w + 8 h + q`` (consumer warpgroup c, warp w, quad q) and
    thread ``t`` of the quad own 16 bytes at ``((4 c + w) * 2 + h) * 512 +
    (4 q + t) * 16``: for each of the tile's 4 k32 steps, the 4 bytes of
    ``_FRAGMENT_ORDER`` that thread t reads — one 16-byte load per channel
    and tile. A byte gather of the pack: nibble pairs never straddle a
    group (group_k is even), so the encoding is unchanged. Built once per
    weight tensor and kept while the weight lives (the pack's size, padded)."""
    def build(w):
        half_k, N = w.shape
        nk = 2 * half_k // group_k
        gkp = _padded_group(group_k)
        Np, nkt = -_BW * (-N // _BW), nk * gkp // _BK
        rows = torch.zeros((Np, nk, gkp // 2), dtype=torch.int8,
                           device=w.device)
        rows[:N, :, :group_k // 2] = w.reshape(nk, group_k // 2, N) \
            .permute(2, 0, 1)
        order = torch.tensor(_FRAGMENT_ORDER, device=w.device)
        chunks = rows.reshape(Np, nkt * 4, 16)[:, :, order]
        # (tile, c, w, h, q, k tile, step, t, byte) -> (tile, k tile, c, w,
        # h, q, t, step, byte)
        t = chunks.reshape(Np // _BW, 2, 4, 2, 8, nkt, 4, 4, 4)
        return t.permute(0, 5, 1, 2, 3, 4, 7, 6, 8).reshape(-1).contiguous()
    return cached_layout(wp, ("int4", group_k), build)


def _launch(mrq, x, wp, s_a, s_b, scale_a, scale_b, corr, bias, g, ps,
            nm, gr, bv, group_k, out_dtype):
    M, K = x.shape
    Kp, N = 2 * wp.shape[0], wp.shape[1]
    if group_k <= 0 or group_k % 2 or Kp % group_k or Kp // group_k != \
            -(-K // group_k) or group_k > _MAX_GROUP_K:
        raise ValueError(f"int4: group_k {group_k} does not tile the packed "
                         f"K {Kp} (x has K {K}) or exceeds {_MAX_GROUP_K}")
    nk = Kp // group_k
    dev = x.device
    _need(wp, "wp", (torch.int8,), (Kp // 2, N), dev)
    sh, sc, gate, res, sh_rs, sc_rs, nm_bf16 = check_operands(
        x, (scale_a.shape[0], nk, N), s_a, s_b, scale_a, scale_b, corr, bias,
        g, ps, nm, gr, bv, out_dtype)
    gkp = _padded_group(group_k)
    wt = _weight_layout(wp, group_k)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    codes = torch.empty((2 if mrq else 1, M, nk * gkp), dtype=torch.int8,
                        device=dev)
    gptr, gs = group_arg(g, dev)
    err = build.lib("int4_packed").int4_matmul_launch(
        x.data_ptr(), wt.data_ptr(), s_a.data_ptr(), s_b.data_ptr(),
        scale_a.data_ptr(), _ptr(scale_b), _ptr(corr), bias.data_ptr(),
        gptr, _ptr(ps), _ptr(bv), _ptr(sh), _ptr(sc), _ptr(gate),
        _ptr(res), out.data_ptr(), codes[0].data_ptr(),
        codes[-1].data_ptr(), M, K, nk * gkp, N, group_k, gkp, nk,
        _DT[x.dtype], nm_bf16, _DT[res.dtype] if res is not None else 0,
        _DT[out_dtype], int(mrq), gs, scale_a.shape[0], sh_rs, sc_rs,
        torch.cuda.current_stream(dev).cuda_stream)
    name = ("int4_matmul_mrq_fq" if mrq else "int4_matmul_fq") + \
        ("_vec" if gs else "")
    build.check(err, "int4_packed", name)
    _k.LAUNCHES[name] += 1
    return out


def int4_matmul_fq_plain(x, wp, sx, zx, scale, corr, bias=None, g=0, *,
                         ps=None, nm=None, gr=None, bv=None,
                         group_k=256, out_dtype=torch.float32):
    """Plain version of B4: ``ref.int4_matmul_fq_fused_ref``."""
    return ref.int4_matmul_fq_fused_ref(
        x, wp, sx, zx, scale, corr, bias=bias, g=g, ps=ps, nm=nm, gr=gr,
        bv=bv, group_k=group_k, out_dtype=out_dtype)


def int4_matmul_mrq_fq_plain(x, wp, s_neg, s_pos, scale_neg, scale_pos,
                             bias=None, g=0, *, ps=None, nm=None,
                             gr=None, bv=None, group_k=256,
                             out_dtype=torch.float32):
    """Plain version of B5."""
    return ref.int4_matmul_mrq_fq_fused_ref(
        x, wp, s_neg, s_pos, scale_neg, scale_pos, bias=bias, g=g, ps=ps,
        nm=nm, gr=gr, bv=bv, group_k=group_k, out_dtype=out_dtype)


def int4_matmul_fq(x, wp, sx, zx, scale, corr, bias=None, g=0, *, ps=None,
                   nm=None, gr=None, bv=None, group_k=256,
                   out_dtype=torch.float32):
    """B4 (see the module docstring). CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    bias, gr = prep(x, gr, bias, wp.shape[1])
    if _k.use_kernel(x):
        return _launch(False, x.contiguous(), wp, sx, zx, scale, None, corr,
                       bias, g, ps, nm, gr, bv, group_k, out_dtype)
    return int4_matmul_fq_plain(x, wp, sx, zx, scale, corr, bias, g, ps=ps,
                                nm=nm, gr=gr, bv=bv,
                                group_k=group_k, out_dtype=out_dtype)


def int4_matmul_mrq_fq(x, wp, s_neg, s_pos, scale_neg, scale_pos, bias=None,
                       g=0, *, ps=None, nm=None, gr=None, bv=None,
                       group_k=256, out_dtype=torch.float32):
    """B5 (see the module docstring)."""
    bias, gr = prep(x, gr, bias, wp.shape[1])
    if _k.use_kernel(x):
        return _launch(True, x.contiguous(), wp, s_neg, s_pos, scale_neg,
                       scale_pos, None, bias, g, ps, nm, gr, bv,
                       group_k, out_dtype)
    return int4_matmul_mrq_fq_plain(
        x, wp, s_neg, s_pos, scale_neg, scale_pos, bias, g, ps=ps,
        nm=nm, gr=gr, bv=bv, group_k=group_k,
        out_dtype=out_dtype)


def int4_matmul_fq_vec_plain(x, wp, sx, zx, scale, corr, bias=None,
                             gv=None, *, ps=None, nm=None,
                             gr=None, bv=None, group_k=256,
                             out_dtype=torch.float32):
    """Plain version of B7a: ``ref.int4_matmul_fq_vec_fused_ref``."""
    return ref.int4_matmul_fq_vec_fused_ref(
        x, wp, sx, zx, scale, corr, bias=bias,
        gv=clamp_groups(gv, scale.shape[0]), ps=ps, nm=nm, gr=gr, bv=bv,
        group_k=group_k, out_dtype=out_dtype)


def int4_matmul_mrq_fq_vec_plain(x, wp, s_neg, s_pos, scale_neg, scale_pos,
                                 bias=None, gv=None, *, ps=None, nm=None,
                                 gr=None, bv=None, group_k=256,
                                 out_dtype=torch.float32):
    """Plain version of B7b."""
    return ref.int4_matmul_mrq_fq_vec_fused_ref(
        x, wp, s_neg, s_pos, scale_neg, scale_pos, bias=bias,
        gv=clamp_groups(gv, scale_neg.shape[0]), ps=ps,
        nm=nm, gr=gr, bv=bv, group_k=group_k, out_dtype=out_dtype)


def int4_matmul_fq_vec(x, wp, sx, zx, scale, corr, bias=None, gv=None, *,
                       ps=None, nm=None, gr=None, bv=None, group_k=256,
                       out_dtype=torch.float32):
    """B7a: B4 with a per-row (M,) int32 group vector ``gv``. CUDA tensors
    launch the kernel, CPU tensors take the plain version."""
    bias, gr = prep(x, gr, bias, wp.shape[1])
    gv = row_groups(gv, x.shape[0], x.device)
    if _k.use_kernel(x):
        return _launch(False, x.contiguous(), wp, sx, zx, scale, None, corr,
                       bias, gv, ps, nm, gr, bv, group_k, out_dtype)
    return int4_matmul_fq_vec_plain(x, wp, sx, zx, scale, corr, bias, gv,
                                    ps=ps, nm=nm, gr=gr, bv=bv,
                                    group_k=group_k, out_dtype=out_dtype)


def int4_matmul_mrq_fq_vec(x, wp, s_neg, s_pos, scale_neg, scale_pos,
                           bias=None, gv=None, *, ps=None, nm=None, gr=None,
                           bv=None, group_k=256, out_dtype=torch.float32):
    """B7b: B5 with a per-row group vector ``gv``."""
    bias, gr = prep(x, gr, bias, wp.shape[1])
    gv = row_groups(gv, x.shape[0], x.device)
    if _k.use_kernel(x):
        return _launch(True, x.contiguous(), wp, s_neg, s_pos, scale_neg,
                       scale_pos, None, bias, gv, ps, nm, gr, bv,
                       group_k, out_dtype)
    return int4_matmul_mrq_fq_vec_plain(
        x, wp, s_neg, s_pos, scale_neg, scale_pos, bias, gv, ps=ps,
        nm=nm, gr=gr, bv=bv, group_k=group_k,
        out_dtype=out_dtype)
