"""Flash-style fused int8 MRQ attention (kernel B3, B3b: its 4-bit
packed-kv variant, and B8: both with per-batch-row groups) — wrappers,
plain versions and launch counts.

``flash_attn_mrq`` replaces ``repro/kernels/flash_attn_mrq.py::
flash_attn_mrq``: per (batch·head, q-tile), SymQ int8 QK^T dequantised by
``qk_scale[g_qk]``, ``NEG_INF`` on ragged kv lanes before the online max,
running max and denominator, MRQ two-region probability codes of
``exp(s - m') / l'`` against ``s1[g_pv]`` (``s2 = 1/half``), dual-region
integer P·V with the ``rho = exp(m - m') * l / l'`` rescale, and the
epilogue ``acc1 * scale1 + acc2 * scale2``. kv tiles are 128 wide, as in
the reference: the codes round against the running normalisation per
tile, so another width would be another result.

q: (B, M, D) f32/bf16; k, v: (Bk, N, D) with B = rep * Bk (GQA: q batch b
reads kv batch b // rep). s_q/s_k/qk_scale: (Gq, 1) f32; s1/s_v/scale1/
scale2: (Gp, 1) f32.

``packed_kv=True`` (bits 4 only, the W4A4 serving path, B3b): the k and v
codes are stored two per byte and widened by the kernel as it loads each
tile — the same codes and arithmetic as unpacked 4-bit, half the kv code
bytes; it counts under ``LAUNCHES["flash_attn_mrq_packed_kv"]``.

``mask`` (all three kernels): a boolean broadcastable to (B, M, N), True
= attend, as the reference takes it. The wrapper expands it to one int8
0/1 byte per (q row, kv lane) and the kernel sets each masked lane to the
ragged lanes' finite ``NEG_INF`` before the online max; a fully masked
row then averages every lane up to the reference's padded kv length (e =
exp(0) = 1 on each), the reference's result. The mask is not on the DiT
serving path (``ops.flash_attention(mask=...)`` reaches it).

``flash_attn_mrq_vec`` (B8) replaces ``::flash_attn_mrq_vec``: ``g_qk``
and ``g_pv`` are (B,) int32 device vectors and batch row b runs with its
own groups (the slot pool's rows sit at different timesteps; an index
outside the stacks is clamped on the device, as in ``int8_fused``); it
counts under ``flash_attn_mrq_vec`` (``flash_attn_mrq_vec_packed_kv``). Its k
and v codes are made per q batch row: under GQA (rep > 1) the wrapper
repeats k and v over the rep q rows of each kv row first, so a q row
never reads another row's group.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import build, ref
from repro_torch.kernels.int8_fused import (
    _DT, _need, clamp_groups, is_vec, repeat_batch, row_groups,
)

MAX_HEAD_DIM = 128


def _expand_mask(mask, q, N):
    """A boolean mask broadcast to (B, M, N) (None stays None)."""
    if mask is None:
        return None
    return torch.broadcast_to(torch.as_tensor(mask, device=q.device),
                              (q.shape[0], q.shape[1], N))


def flash_attn_mrq_plain(q, k, v, s_q, s_k, qk_scale, s1, s_v, scale1,
                         scale2, g_qk=0, g_pv=0, mask=None, *, bits=8,
                         packed_kv=False, out_dtype=torch.float32):
    """Plain version of B3 (and B3b): the tile-faithful recurrence
    (``ref.flash_core_ref``) with kv gathered per q batch."""
    rep = q.shape[0] // k.shape[0]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=0)
        v = v.repeat_interleave(rep, dim=0)
    return ref.flash_core_ref(
        q, k, v, s_q[g_qk][0], s_k[g_qk][0], qk_scale[g_qk][0], s1[g_pv][0],
        s_v[g_pv][0], scale1[g_pv][0], scale2[g_pv][0], bits,
        out_dtype=out_dtype, packed_kv=packed_kv,
        mask=_expand_mask(mask, q, k.shape[1]))


def flash_attn_mrq_vec_plain(q, k, v, s_q, s_k, qk_scale, s1, s_v, scale1,
                             scale2, g_qk=None, g_pv=None, mask=None, *,
                             bits=8, packed_kv=False,
                             out_dtype=torch.float32):
    """Plain version of B8: ``ref.flash_attn_mrq_vec_ref`` with kv gathered
    per q batch row."""
    k, v = repeat_batch(k, q.shape[0]), repeat_batch(v, q.shape[0])
    return ref.flash_attn_mrq_vec_ref(
        q, k, v, {"s_q": s_q, "s_k": s_k, "scale": qk_scale},
        {"s1": s1, "s_v": s_v, "scale1": scale1, "scale2": scale2},
        mask=_expand_mask(mask, q, k.shape[1]),
        g_qk=clamp_groups(g_qk, s_q.shape[0]),
        g_pv=clamp_groups(g_pv, s1.shape[0]), bits=bits,
        out_dtype=out_dtype, packed_kv=packed_kv)


def _pair_ptr(dev, g_qk: int, g_pv: int) -> int:
    """Device pointer to the int32 pair [g_qk, g_pv] (cached per pair)."""
    key = ("gpair", str(dev), g_qk, g_pv)
    t = _PAIRS.get(key)
    if t is None:
        t = _PAIRS[key] = torch.tensor([g_qk, g_pv], dtype=torch.int32,
                                       device=dev)
    return t.data_ptr()


_PAIRS: dict = {}


def flash_attn_mrq(q, k, v, s_q, s_k, qk_scale, s1, s_v, scale1, scale2,
                   g_qk=0, g_pv=0, mask=None, *, bits=8, packed_kv=False,
                   out_dtype=torch.float32):
    """B3 / B3b (see the module docstring). CUDA tensors launch the
    kernel, CPU tensors take the plain version."""
    if packed_kv and bits != 4:
        raise ValueError("packed_kv streams nibbles: 4-bit codes only")
    if not _k.use_kernel(q):
        return flash_attn_mrq_plain(q, k, v, s_q, s_k, qk_scale, s1, s_v,
                                    scale1, scale2, g_qk, g_pv, mask,
                                    bits=bits, packed_kv=packed_kv,
                                    out_dtype=out_dtype)
    return _launch(q, k, v, (s_q, s_k, qk_scale, s1, s_v, scale1, scale2),
                   (g_qk, g_pv), mask, bits, packed_kv, out_dtype)


def flash_attn_mrq_vec(q, k, v, s_q, s_k, qk_scale, s1, s_v, scale1, scale2,
                       g_qk=None, g_pv=None, mask=None, *, bits=8,
                       packed_kv=False, out_dtype=torch.float32):
    """B8 (see the module docstring): ``g_qk``/``g_pv`` (B,) int32 device
    vectors, None for group 0. CUDA tensors launch the kernel, CPU tensors
    take the plain version."""
    if packed_kv and bits != 4:
        raise ValueError("packed_kv streams nibbles: 4-bit codes only")
    B = q.shape[0]
    g_qk, g_pv = (row_groups(g, B, q.device) for g in (g_qk, g_pv))
    if not _k.use_kernel(q):
        return flash_attn_mrq_vec_plain(
            q, k, v, s_q, s_k, qk_scale, s1, s_v, scale1, scale2, g_qk, g_pv,
            mask, bits=bits, packed_kv=packed_kv, out_dtype=out_dtype)
    k, v = repeat_batch(k, B), repeat_batch(v, B)
    return _launch(q, k, v, (s_q, s_k, qk_scale, s1, s_v, scale1, scale2),
                   (g_qk, g_pv), mask, bits, packed_kv, out_dtype)


def _launch(q, k, v, params, groups, mask, bits, packed_kv, out_dtype):
    """Check the operands and launch B3/B3b (scalar ``groups``) or B8
    (a pair of (B,) vectors)."""
    s_q, s_k, qk_scale, s1, s_v, scale1, scale2 = params
    g_qk, g_pv = groups
    vec = is_vec(g_qk)
    B, M, D = q.shape
    Bk, N, _ = k.shape
    if B % Bk or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attn_mrq: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} (head dim <= {MAX_HEAD_DIM})")
    dev = q.device
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _need(q, "q", tuple(_DT), (B, M, D), dev)
    _need(k, "k", (q.dtype,), (Bk, N, D), dev)
    _need(v, "v", (q.dtype,), (Bk, N, D), dev)
    Gq, Gp = s_q.shape[0], s1.shape[0]
    for name, t, G in (("s_q", s_q, Gq), ("s_k", s_k, Gq),
                       ("qk_scale", qk_scale, Gq), ("s1", s1, Gp),
                       ("s_v", s_v, Gp), ("scale1", scale1, Gp),
                       ("scale2", scale2, Gp)):
        _need(t, name, (torch.float32,), (G, 1), dev)
    if vec:
        _need(g_qk, "g_qk", (torch.int32,), (B,), dev)
        _need(g_pv, "g_pv", (torch.int32,), (B,), dev)
        if Bk != B:
            raise ValueError("flash_attn_mrq_vec codes kv per q batch row: "
                             f"k has {Bk} rows for {B} q rows")
        gptrs = (g_qk.data_ptr(), g_pv.data_ptr())
    elif not (0 <= g_qk < Gq and 0 <= g_pv < Gp):
        raise ValueError(f"groups ({g_qk}, {g_pv}) outside ({Gq}, {Gp})")
    else:
        pair = _pair_ptr(dev, g_qk, g_pv)
        gptrs = (pair, pair + 4)
    if mask is not None:                   # one int8 0/1 byte per lane
        mask = _expand_mask(mask, q, N).to(torch.int8).contiguous()
        _need(mask, "mask", (torch.int8,), (B, M, N), dev)
    out = torch.empty((B, M, D), dtype=out_dtype, device=dev)
    # int8 code scratch: head dim padded to the 32-deep mma (q, k) and to 8
    # (v, transposed to kv-contiguous rows); rows padded to the tiles;
    # packed_kv halves k's head dim and v's kv axis (two codes per byte)
    DQ, DN = -32 * (-D // 32), -8 * (-D // 8)
    Mp, Np = -64 * (-M // 64), -128 * (-N // 128)
    per = 2 if packed_kv else 1
    q8 = torch.empty((B, Mp, DQ), dtype=torch.int8, device=dev)
    k8 = torch.empty((Bk, Np, DQ // per), dtype=torch.int8, device=dev)
    v8t = torch.empty((Bk, DN, Np // per), dtype=torch.int8, device=dev)
    err = build.lib("flash_attn_mrq").flash_attn_mrq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), s_q.data_ptr(),
        s_k.data_ptr(), qk_scale.data_ptr(), s1.data_ptr(), s_v.data_ptr(),
        scale1.data_ptr(), scale2.data_ptr(), *gptrs,
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        q8.data_ptr(), k8.data_ptr(), v8t.data_ptr(),
        B, M, N, D, B // Bk, 2 ** (bits - 1), int(packed_kv), _DT[q.dtype],
        _DT[out_dtype], int(vec), Gq, Gp,
        torch.cuda.current_stream(dev).cuda_stream)
    name = "flash_attn_mrq" + ("_vec" if vec else "") + \
        ("_packed_kv" if packed_kv else "")
    build.check(err, "flash_attn_mrq", name)
    _k.LAUNCHES[name] += 1
    return out

