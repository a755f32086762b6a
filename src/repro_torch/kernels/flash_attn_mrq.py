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

One launch per call (``csrc/flash_attn_mrq.cu``): the kernel quantizes
q, k and v itself as it reads them, at their strides. The serving path
(``ops.flash_attention``) hands ``flash_attn_mrq`` / ``flash_attn_mrq_vec``
the q, k and v views of the qkv projection's output (a 5-D q: see
``flash_attn_heads``) and gets the output in the (B, Sq, Hk, G, hd) order
the proj linear reads, with no copy on either side; the (B, M, D) calls
reach the same launcher with trivial strides.

``packed_kv=True`` (bits 4 only, the W4A4 serving path, B3b): the same
4-bit codes and arithmetic as unpacked 4-bit. The kernel makes the kv
codes in shared memory, so no packed buffer exists; B3b keeps its check
and counts under ``LAUNCHES["flash_attn_mrq_packed_kv"]``.

``mask`` (all three kernels): a boolean broadcastable to (B, M, N), True
= attend, as the reference takes it. The wrapper packs it into one bit
per (q row, kv lane), and the kernel sets each masked lane to the ragged
lanes' finite ``NEG_INF`` before the online max; a fully masked row then
averages every lane up to the reference's padded kv length (e = exp(0) =
1 on each), the reference's result. The mask is not on the DiT serving
path (``ops.flash_attention(mask=...)`` reaches it).

``flash_attn_mrq_vec`` (B8) replaces ``::flash_attn_mrq_vec``: ``g_qk``
and ``g_pv`` are (B,) int32 device vectors and batch row b runs with its
own groups (the slot pool's rows sit at different timesteps; an index
outside the stacks is clamped on the device, as in ``int8_fused``); it
counts under ``flash_attn_mrq_vec`` (``flash_attn_mrq_vec_packed_kv``).
Each q row quantizes the kv rows it reads with its own groups, so under
GQA (rep > 1) no row ever reads another row's group.
"""
from __future__ import annotations

import ctypes

import numpy as np
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


def q_rows(q):
    """q (B, Sq, Hk, G, hd) -> (B·Hk·G, Sq, hd): slot-major batch·head
    rows (a copy; the kernels read the view)."""
    B, Sq, Hk, G, hd = q.shape
    return q.permute(0, 2, 3, 1, 4).reshape(B * Hk * G, Sq, hd)


def kv_rows(k):
    """k or v (B, Skv, Hk, hd) -> (B·Hk, Skv, hd) (a copy)."""
    B, Skv, Hk, hd = k.shape
    return k.permute(0, 2, 1, 3).reshape(B * Hk, Skv, hd)


def flatten_heads(q, k, v):
    """q (B, Sq, Hk, G, hd) -> (B·Hk·G, Sq, hd) and k, v (B, Skv, Hk, hd)
    -> (B·Hk, Skv, hd): slot-major batch·head rows; GQA stays unmaterialised
    (q row r reads kv row r // G). Copies: the plain versions read rows;
    the kernels read the views."""
    return q_rows(q), kv_rows(k), kv_rows(v)


def heads_view(t, Bk: int):
    """Public (B, M, D) q or output rows as the kernels' head view (1, M,
    Bk, B // Bk, D): row b is kv row b // rep, group b % rep (no copy)."""
    B, M, D = t.shape
    return t.reshape(1, Bk, B // Bk, M, D).permute(0, 3, 1, 2, 4)


def kv_view(t):
    """Public (Bk, N, D) k or v rows as the head view (1, N, Bk, D)."""
    Bk, N, D = t.shape
    return t.reshape(1, Bk, N, D).permute(0, 2, 1, 3)


def rows_as_heads(q, k, v, out):
    """The public (B, M, D) operands as the kernel's head views: q and out
    as (1, M, Bk, rep, D), k and v as (1, N, Bk, D) — q row b is kv row
    b // rep, group b % rep (no copy)."""
    Bk = k.shape[0]
    return heads_view(q, Bk), kv_view(k), kv_view(v), heads_view(out, Bk)


def launch_strides(q5, k4, v4, out5):
    """The launcher's 14 element strides: q and out (batch, head, group,
    row), k and v (batch, head, row); a dimension of size 1 gets stride 0
    (its index is always 0)."""
    def pick(t, dims):
        return [0 if t.shape[d] == 1 else t.stride(d) for d in dims]
    return (pick(q5, (0, 2, 3, 1)) + pick(k4, (0, 2, 1)) + pick(v4, (0, 2, 1))
            + pick(out5, (0, 2, 3, 1)))


def _words(m, N: int):
    """A boolean (..., N) as (..., ceil(N/128) * 4) int32 words, bit j of
    word w = kv lane 32 w + j (1 = attend; 0 on the lanes past N)."""
    Np = -128 * (-N // 128)
    m = torch.nn.functional.pad(m.to(torch.int32), (0, Np - N))
    bit = torch.arange(32, dtype=torch.int32, device=m.device)
    return (m.reshape(tuple(m.shape[:-1]) + (Np // 32, 32)) << bit).sum(
        -1, dtype=torch.int32)


def mask_bits(mask, Bq: int, M: int, N: int, dev):
    """A boolean mask broadcastable to (Bq, M, N) as the kernel reads it:
    (Bq, M, ceil(N/128) * 4) int32 words, bit j of word w = kv lane
    32 w + j (1 = attend; 0 on the lanes past N)."""
    return _words(torch.broadcast_to(torch.as_tensor(mask, device=dev),
                                     (Bq, M, N)), N)


def head_mask_bits(mask, B: int, Hk: int, G: int, M: int, N: int, dev):
    """``mask_bits`` of a 5-D mask broadcastable to (B, Hk, G, M, N), the
    head view's order: the words are packed over the mask's own extent (a
    causal or decode mask does not vary over heads, so B·M·N lanes, not
    B·Hk·G·M·N) and then repeated over the rows it broadcasts along, into
    the (B·Hk·G, M, ceil(N/128) * 4) words the kernel reads."""
    m = torch.as_tensor(mask, device=dev)
    lead = tuple(m.shape[:4])
    m = torch.broadcast_to(m, lead + (N,))
    w = _words(m, N)
    return w.expand(B, Hk, G, M, w.shape[-1]).reshape(
        B * Hk * G, M, w.shape[-1]).contiguous()


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
                   out_dtype=torch.float32, scale=1.0):
    """B3 / B3b (see the module docstring). q may also be a head view
    (B, Sq, Hk, G, hd) with k, v (B, Skv, Hk, hd): the serving seam
    (``flash_attn_heads``). ``scale`` multiplies ``qk_scale[g_qk]``. CUDA
    tensors launch the kernel, CPU tensors take the plain version."""
    if packed_kv and bits != 4:
        raise ValueError("packed_kv streams nibbles: 4-bit codes only")
    params = (s_q, s_k, qk_scale, s1, s_v, scale1, scale2)
    if q.ndim == 5:
        return flash_attn_heads(q, k, v, *params, g_qk, g_pv, mask,
                                scale=scale, bits=bits, packed_kv=packed_kv,
                                out_dtype=out_dtype)
    if not _k.use_kernel(q):
        return flash_attn_mrq_plain(q, k, v, s_q, s_k, _scaled(qk_scale, scale),
                                    s1, s_v, scale1, scale2, g_qk, g_pv, mask,
                                    bits=bits, packed_kv=packed_kv,
                                    out_dtype=out_dtype)
    return _launch_rows(q, k, v, params, (g_qk, g_pv), mask, bits,
                        packed_kv, out_dtype, scale)


def flash_attn_mrq_vec(q, k, v, s_q, s_k, qk_scale, s1, s_v, scale1, scale2,
                       g_qk=None, g_pv=None, mask=None, *, bits=8,
                       packed_kv=False, out_dtype=torch.float32, scale=1.0):
    """B8 (see the module docstring): ``g_qk``/``g_pv`` (B,) int32 device
    vectors, None for group 0; for a head view q (B, Sq, Hk, G, hd), one
    per slot-major q row (B·Hk·G). CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    if packed_kv and bits != 4:
        raise ValueError("packed_kv streams nibbles: 4-bit codes only")
    params = (s_q, s_k, qk_scale, s1, s_v, scale1, scale2)
    rows = q.shape[0] * (q.shape[2] * q.shape[3] if q.ndim == 5 else 1)
    g_qk, g_pv = (row_groups(g, rows, q.device) for g in (g_qk, g_pv))
    if q.ndim == 5:
        return flash_attn_heads(q, k, v, *params, g_qk, g_pv, mask,
                                scale=scale, bits=bits, packed_kv=packed_kv,
                                out_dtype=out_dtype)
    if not _k.use_kernel(q):
        return flash_attn_mrq_vec_plain(
            q, k, v, s_q, s_k, _scaled(qk_scale, scale), s1, s_v, scale1,
            scale2, g_qk, g_pv, mask, bits=bits, packed_kv=packed_kv,
            out_dtype=out_dtype)
    return _launch_rows(q, k, v, params, (g_qk, g_pv), mask, bits,
                        packed_kv, out_dtype, scale)


def _scaled(qk_scale, scale):
    """qk_scale * scale in f32, as the kernel forms it (1.0: unchanged)."""
    return qk_scale if scale == 1.0 else qk_scale * float(np.float32(scale))


def flash_attn_heads(q, k, v, s_q, s_k, qk_scale, s1, s_v, scale1, scale2,
                     g_qk=0, g_pv=0, mask=None, *, scale=1.0, bits=8,
                     packed_kv=False, out_dtype=torch.float32):
    """B3 / B3b / B8 on head views, the serving path's entry: q (B, Sq,
    Hk, G, hd) and k, v (B, Skv, Hk, hd) at any strides with the head dim
    contiguous (the qkv projection's output as the DiT block views it).
    Scalar groups run B3/B3b, (B·Hk·G,) int32 vectors (one per slot-major
    q row) B8. ``scale`` multiplies ``qk_scale[g_qk]`` (in the kernel);
    ``mask``: boolean broadcastable to (B·Hk·G, Sq, Skv) in that row order,
    or a 5-D one broadcastable to (B, Hk, G, Sq, Skv) (its words are packed
    once per distinct row, ``head_mask_bits``). Returns (B, Sq, Hk, G, hd),
    contiguous on the kernel path. CUDA tensors launch the kernel, CPU
    tensors take the plain version on the flattened rows."""
    if packed_kv and bits != 4:
        raise ValueError("packed_kv streams nibbles: 4-bit codes only")
    B, Sq, Hk, G, hd = q.shape
    params = (s_q, s_k, qk_scale, s1, s_v, scale1, scale2)
    if _k.use_kernel(q):
        out = torch.empty((B, Sq, Hk, G, hd), dtype=out_dtype, device=q.device)
        _launch(q, k, v, out, params, (g_qk, g_pv), mask, bits, packed_kv,
                scale)
        return out
    qf, kf, vf = flatten_heads(q, k, v)
    if mask is not None and torch.as_tensor(mask).ndim == 5:
        mask = torch.broadcast_to(torch.as_tensor(mask, device=q.device),
                                  (B, Hk, G, Sq, k.shape[1])).reshape(
            B * Hk * G, Sq, k.shape[1])
    args = (qf, kf, vf, s_q, s_k, qk_scale, s1, s_v, scale1, scale2, g_qk,
            g_pv, mask)
    kw = dict(bits=bits, packed_kv=packed_kv, out_dtype=out_dtype,
              scale=scale)
    out = (flash_attn_mrq_vec(*args, **kw) if is_vec(g_qk)
           else flash_attn_mrq(*args, **kw))
    return out.reshape(B, Hk, G, Sq, hd).permute(0, 3, 1, 2, 4)


def _launch_rows(q, k, v, params, groups, mask, bits, packed_kv, out_dtype,
                 scale):
    """The public (B, M, D) call through the head-view launcher."""
    B, M, D = q.shape
    Bk = k.shape[0]
    if q.ndim != 3 or k.ndim != 3 or B % Bk or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attn_mrq: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} (head dim <= {MAX_HEAD_DIM})")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, M, D), dtype=out_dtype, device=q.device)
    q5, k4, v4, out5 = rows_as_heads(q, k, v, out)
    _launch(q5, k4, v4, out5, params, groups, mask, bits, packed_kv, scale)
    return out


def _view(t, name, dtypes, shape, dev):
    """``_need`` for a strided view: the head dim contiguous."""
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype}, expected {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {shape}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous")


def _launch(q, k, v, out, params, groups, mask, bits, packed_kv, scale):
    """Check the head views and launch B3/B3b (scalar ``groups``) or B8 (a
    pair of (B·Hk·G,) vectors) into ``out``."""
    s_q, s_k, qk_scale, s1, s_v, scale1, scale2 = params
    g_qk, g_pv = groups
    vec = is_vec(g_qk)
    if q.ndim != 5 or k.ndim != 4:
        raise ValueError(f"flash_attn_mrq: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)}: expected (B, Sq, Hk, G, hd) "
                         "and (B, Skv, Hk, hd)")
    B, M, Hk, G, D = q.shape
    N = k.shape[1]
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attn_mrq: head dim {D} (<= {MAX_HEAD_DIM})")
    dev = q.device
    _view(q, "q", tuple(_DT), (B, M, Hk, G, D), dev)
    _view(k, "k", (q.dtype,), (B, N, Hk, D), dev)
    _view(v, "v", (q.dtype,), (B, N, Hk, D), dev)
    _view(out, "out", tuple(_DT), (B, M, Hk, G, D), dev)
    Bq = B * Hk * G
    Gq, Gp = s_q.shape[0], s1.shape[0]
    for name, t, Gn in (("s_q", s_q, Gq), ("s_k", s_k, Gq),
                        ("qk_scale", qk_scale, Gq), ("s1", s1, Gp),
                        ("s_v", s_v, Gp), ("scale1", scale1, Gp),
                        ("scale2", scale2, Gp)):
        _need(t, name, (torch.float32,), (Gn, 1), dev)
    if vec:
        _need(g_qk, "g_qk", (torch.int32,), (Bq,), dev)
        _need(g_pv, "g_pv", (torch.int32,), (Bq,), dev)
        gptrs = (g_qk.data_ptr(), g_pv.data_ptr())
    elif not (0 <= g_qk < Gq and 0 <= g_pv < Gp):
        raise ValueError(f"groups ({g_qk}, {g_pv}) outside ({Gq}, {Gp})")
    else:
        pair = _pair_ptr(dev, g_qk, g_pv)
        gptrs = (pair, pair + 4)
    if mask is None:
        words = None
    elif torch.as_tensor(mask).ndim == 5:
        words = head_mask_bits(mask, B, Hk, G, M, N, dev)
    else:
        words = mask_bits(mask, Bq, M, N, dev)
    strides = (ctypes.c_long * 14)(*launch_strides(q, k, v, out))
    err = build.lib("flash_attn_mrq").flash_attn_mrq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), s_q.data_ptr(),
        s_k.data_ptr(), qk_scale.data_ptr(), s1.data_ptr(), s_v.data_ptr(),
        scale1.data_ptr(), scale2.data_ptr(), *gptrs,
        None if words is None else words.data_ptr(), out.data_ptr(),
        strides, Bq, M, N, D, G, Hk, float(np.float32(scale)),
        2 ** (bits - 1), _DT[q.dtype], _DT[out.dtype], int(vec), Gq, Gp,
        torch.cuda.current_stream(dev).cuda_stream)
    name = "flash_attn_mrq" + ("_vec" if vec else "") + \
        ("_packed_kv" if packed_kv else "")
    build.check(err, "flash_attn_mrq", name)
    _k.LAUNCHES[name] += 1


def div_probe(a, b):
    """``a / b`` elementwise by the kernel's correctly rounded quotient
    (``csrc/flash_attn_mrq.cu::div_rn``) on f32 CUDA tensors, to hold it
    against the IEEE divide; no launch count (not on any path)."""
    a, b = a.contiguous(), b.contiguous()
    _need(b, "b", (torch.float32,), tuple(a.shape), a.device)
    q = torch.empty_like(a)
    err = build.lib("flash_attn_mrq").flash_div_probe(
        a.data_ptr(), b.data_ptr(), q.data_ptr(), a.numel(),
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "flash_attn_mrq", "flash_div_probe")
    return q
