"""Serving-path kernel wrappers and the pack builders — port of the
serving part of ``repro/kernels/ops.py`` (scalar and per-slot groups).

``convert_for_kernels`` turns calibrated qparams plus fp weights into the
packs ``QuantContext(kernel=True)`` dispatches on (``LINEAR_PACKS``): per
plain/TGQ-uniform linear an ``int8`` pack at 8 or 6 bits (-> B1
``int8_matmul_fq``) or an ``int4`` pack at 4 bits (-> B4
``int4_matmul_fq``); per MRQ-signed-input linear an ``int8_mrq`` (-> B2
``int8_matmul_mrq_fq``) or ``int4_mrq`` pack (-> B5
``int4_matmul_mrq_fq``); and the ``int8_qk`` / ``int8_pv`` packs per
attention block (-> B3 ``flash_attn_mrq``, packed kv at 4 bits: B3b; or,
under ``attn_impl="composed"``, the three-kernel chain B9a
``int8_bmm_qk`` -> B10a ``softmax_mrq_codes`` -> B9b ``int8_bmm_pv``).
Activation-side parameters are stacked along a leading (G,) TGQ group
axis; the kernels read the group's row themselves.

``tgroup`` is a scalar group (one per forward: the sync sampler) or a
per-slot (B,) int32 device vector (the continuous-batching slot pool):
then each wrapper calls the ``*_vec`` kernel (B6a, B6b, B7a, B7b, B8;
B9c, B10b, B9d in the composed chain) with one group per matmul row
(batch·head row in attention), so one launch serves slots at different
timesteps and the weights stream once. A pack whose groups resolve to a
scalar (G = 1) beside a vector sibling rides along as a constant vector.
The vector never leaves the device.

Off the serving path, the public kernel API of ``repro/kernels/ops.py``:
``flash_attention(mask=...)`` (the boolean mask of B3, B3b and B8),
``softmax_mrq_op`` (B12), ``act_mrq_op`` (B13) and ``quantize_int8``
(elementwise codes, no kernel in either package).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.quantizers import (
    ChannelQ, MRQSignedQ, MRQSoftmaxQ, SymQ, TGQ, UniformQ,
)
from repro_torch.kernels.act_mrq import act_mrq
from repro_torch.kernels.flash_attn_mrq import (
    flash_attn_mrq, flash_attn_mrq_vec,
)
from repro_torch.kernels.int4_packed import (
    int4_matmul_fq, int4_matmul_fq_vec, int4_matmul_mrq_fq,
    int4_matmul_mrq_fq_vec,
)
from repro_torch.kernels.int8_bmm import (
    int8_bmm_pv, int8_bmm_pv_vec, int8_bmm_qk, int8_bmm_qk_vec,
)
from repro_torch.kernels.int8_fused import (
    int8_matmul_fq, int8_matmul_fq_vec, int8_matmul_mrq_fq,
    int8_matmul_mrq_fq_vec, _CACHE, cached_layout, is_vec,
)
from repro_torch.kernels.ref import (
    NEG_INF, _ceil, pack_int4, quantize_int8_ref,
)
from repro_torch.kernels.softmax_mrq import (
    softmax_mrq, softmax_mrq_codes, softmax_mrq_codes_vec,
)
from repro_torch.quant.groups import resolve_group

# The linear packs, in dispatch order: (pack key, wrapper in this module,
# kernel it launches for a scalar group; a group vector launches the
# kernel's ``_vec`` sibling). ``QuantContext.linear`` and the artifact's
# ``fallback_ops`` / ``packed_counts`` all read this one list.
LINEAR_PACKS = (("int8", "int8_linear", "int8_matmul_fq"),
                ("int8_mrq", "int8_linear_mrq", "int8_matmul_mrq_fq"),
                ("int4", "int4_linear", "int4_matmul_fq"),
                ("int4_mrq", "int4_linear_mrq", "int4_matmul_mrq_fq"))
INT4_GROUP_K = 256       # the largest K group of the int4 packs


# ---------------------------------------------------------------------------
# pack builders
# ---------------------------------------------------------------------------
def _unwrap_tgq(q):
    if isinstance(q, TGQ):
        return q.inner, True
    return q, False


def _stack_param(p, is_tgq) -> torch.Tensor:
    """Activation param -> (G, 1) f32 column (G=1 for per-tensor)."""
    a = torch.as_tensor(p).float()
    if not is_tgq:
        if a.ndim != 0:
            raise ValueError(f"per-tensor param must be scalar, got {a.shape}")
        return a.reshape(1, 1)
    if a.ndim != 1:
        raise ValueError(f"TGQ param must be stacked (G,), got {a.shape}")
    return a.reshape(-1, 1)


def _weight_codes(wq_q: ChannelQ, w, half: int = 128) -> Optional[tuple]:
    """(codes (K,N) int8, sw (N,) f32) or None if not a packable 2D linear."""
    sw = torch.as_tensor(wq_q.scale).float().reshape(-1)
    w = torch.as_tensor(w).float()
    if w.ndim != 2 or sw.shape[0] != w.shape[-1]:
        return None
    codes = torch.clamp(torch.round(w / sw[None, :]), -(half - 1), half - 1
                        ).to(torch.int8)
    return codes, sw


def _prescale_vec(qp: Dict[str, Any], w) -> Optional[torch.Tensor]:
    ps = qp.get("x_prescale")
    if ps is None:
        return None
    ps = torch.as_tensor(ps).float().reshape(-1)
    if w.ndim == 2 and ps.shape[0] != w.shape[0]:
        raise ValueError(
            f"x_prescale length {ps.shape[0]} != weight K {w.shape[0]}")
    return ps


def _balanced_w(w, ps):
    return w if ps is None else w.float() * ps[:, None]


def pack_int8_linear(qp: Dict[str, Any], w) -> Optional[dict]:
    """Pack one linear (``UniformQ`` / ``TGQ(UniformQ)`` input,
    ``ChannelQ`` weight, 8 or 6 bits) for B1."""
    xq_q, is_tgq = _unwrap_tgq(qp.get("x"))
    if not isinstance(xq_q, UniformQ) or not isinstance(qp.get("w"), ChannelQ):
        return None
    wq_q: ChannelQ = qp["w"]
    bits = int(wq_q.bits)
    if bits not in (6, 8) or xq_q.bits != bits:
        return None
    half = 2 ** (bits - 1)
    try:
        sx = _stack_param(xq_q.scale, is_tgq)
        zx = _stack_param(xq_q.zero, is_tgq)
    except ValueError:
        return None
    ps = _prescale_vec(qp, w)
    cw = _weight_codes(wq_q, _balanced_w(w, ps), half)
    if cw is None:
        return None
    codes, sw = cw
    colsum = codes.to(torch.int32).sum(dim=0, dtype=torch.int32)
    z_eff = torch.round(zx).to(torch.int32) - half
    pack = {"wq": codes, "sx": sx, "zx": zx, "scale": sx * sw[None, :],
            "corr": z_eff * colsum[None, :], "groups": int(sx.shape[0]),
            "bits": bits}
    if ps is not None:
        pack["x_prescale"] = ps
    return pack


def pack_int8_mrq_linear(qp: Dict[str, Any], w) -> Optional[dict]:
    """Pack an MRQ-signed-input linear (post-GELU fc2) for B2."""
    xq_q, is_tgq = _unwrap_tgq(qp.get("x"))
    if not isinstance(xq_q, MRQSignedQ) or not isinstance(
            qp.get("w"), ChannelQ):
        return None
    wq_q: ChannelQ = qp["w"]
    bits = int(wq_q.bits)
    if bits not in (6, 8) or xq_q.bits != bits:
        return None
    try:
        s_neg = _stack_param(xq_q.s_neg, is_tgq)
        s_pos = _stack_param(xq_q.s_pos, is_tgq)
    except ValueError:
        return None
    ps = _prescale_vec(qp, w)
    cw = _weight_codes(wq_q, _balanced_w(w, ps), 2 ** (bits - 1))
    if cw is None:
        return None
    codes, sw = cw
    pack = {"wq": codes, "s_neg": s_neg, "s_pos": s_pos,
            "scale_neg": s_neg * sw[None, :], "scale_pos": s_pos * sw[None, :],
            "groups": int(s_neg.shape[0]), "bits": bits}
    if ps is not None:
        pack["x_prescale"] = ps
    return pack


def _int4_group_codes(wq_q: ChannelQ, w) -> Optional[tuple]:
    """(codes3 (nk, group_k, N) int8 in [-7, 7], sw (nk, N) f32, group_k)
    or None if not a packable 2D linear. The calibrated per-channel scale
    is superseded by a per-(K group, channel) absmax / 7, group_k =
    min(256, K rounded up to a multiple of 8)."""
    w = torch.as_tensor(w).float()
    sw_cal = torch.as_tensor(wq_q.scale).float().reshape(-1)
    if w.ndim != 2 or sw_cal.shape[0] != w.shape[-1]:
        return None
    K, N = w.shape
    group_k = min(INT4_GROUP_K, _ceil(K))
    Kp = -group_k * (-K // group_k)
    nk = Kp // group_k
    w3 = torch.nn.functional.pad(w, (0, 0, 0, Kp - K)).reshape(nk, group_k, N)
    sw = torch.clamp(w3.abs().amax(dim=1), min=1e-8) / 7.0
    codes3 = torch.clamp(torch.round(w3 / sw[:, None, :]), -7, 7
                         ).to(torch.int8)
    return codes3, sw, group_k


def pack_int4_linear(qp: Dict[str, Any], w) -> Optional[dict]:
    """Pack one linear (``UniformQ`` / ``TGQ(UniformQ)`` input,
    ``ChannelQ`` weight, 4 bits) for B4: nibble-packed weights, scale and
    corr of shape (G, nk, N)."""
    xq_q, is_tgq = _unwrap_tgq(qp.get("x"))
    if not isinstance(xq_q, UniformQ) or not isinstance(qp.get("w"), ChannelQ):
        return None
    wq_q: ChannelQ = qp["w"]
    if wq_q.bits != 4 or xq_q.bits != 4:
        return None
    try:
        sx = _stack_param(xq_q.scale, is_tgq)
        zx = _stack_param(xq_q.zero, is_tgq)
    except ValueError:
        return None
    ps = _prescale_vec(qp, w)
    gc = _int4_group_codes(wq_q, _balanced_w(w, ps))
    if gc is None:
        return None
    codes3, sw, group_k = gc
    N = codes3.shape[-1]
    colsum = codes3.to(torch.int32).sum(dim=1, dtype=torch.int32)
    z_eff = torch.round(zx).to(torch.int32) - 8
    pack = {"wp": pack_int4(codes3.reshape(-1, N)), "sx": sx, "zx": zx,
            "scale": sx[:, :, None] * sw[None],
            "corr": z_eff[:, :, None] * colsum[None],
            "groups": int(sx.shape[0]), "group_k": int(group_k),
            "k": int(w.shape[0]), "bits": 4}
    if ps is not None:
        pack["x_prescale"] = ps
    return pack


def pack_int4_mrq_linear(qp: Dict[str, Any], w) -> Optional[dict]:
    """Pack an MRQ-signed-input linear (post-GELU fc2) for B5:
    nibble-packed weights, per-region scales of shape (G, nk, N)."""
    xq_q, is_tgq = _unwrap_tgq(qp.get("x"))
    if not isinstance(xq_q, MRQSignedQ) or not isinstance(
            qp.get("w"), ChannelQ):
        return None
    wq_q: ChannelQ = qp["w"]
    if wq_q.bits != 4 or xq_q.bits != 4:
        return None
    try:
        s_neg = _stack_param(xq_q.s_neg, is_tgq)
        s_pos = _stack_param(xq_q.s_pos, is_tgq)
    except ValueError:
        return None
    ps = _prescale_vec(qp, w)
    gc = _int4_group_codes(wq_q, _balanced_w(w, ps))
    if gc is None:
        return None
    codes3, sw, group_k = gc
    N = codes3.shape[-1]
    pack = {"wp": pack_int4(codes3.reshape(-1, N)), "s_neg": s_neg,
            "s_pos": s_pos, "scale_neg": s_neg[:, :, None] * sw[None],
            "scale_pos": s_pos[:, :, None] * sw[None],
            "groups": int(s_neg.shape[0]), "group_k": int(group_k),
            "k": int(w.shape[0]), "bits": 4}
    if ps is not None:
        pack["x_prescale"] = ps
    return pack


def _broadcast_groups(*cols):
    G = max(int(c.shape[0]) for c in cols)
    out = []
    for c in cols:
        if c.shape[0] not in (1, G):
            return None
        out.append(c.expand(G, 1).contiguous())
    return tuple(out) + (G,)


def pack_int8_qk(qp: Dict[str, Any]) -> Optional[dict]:
    """Pack an attention QK^T einsum (``SymQ`` / ``TGQ(SymQ)`` on both)."""
    xq_q, x_tgq = _unwrap_tgq(qp.get("x"))
    bq_q, b_tgq = _unwrap_tgq(qp.get("b"))
    if not isinstance(xq_q, SymQ) or not isinstance(bq_q, SymQ):
        return None
    if xq_q.bits != bq_q.bits or xq_q.bits not in (4, 6, 8):
        return None
    try:
        s_q = _stack_param(xq_q.scale, x_tgq)
        s_k = _stack_param(bq_q.scale, b_tgq)
    except ValueError:
        return None
    bc = _broadcast_groups(s_q, s_k)
    if bc is None:
        return None
    s_q, s_k, G = bc
    return {"s_q": s_q, "s_k": s_k, "scale": s_q * s_k, "groups": G,
            "bits": int(xq_q.bits)}


def pack_int8_pv(qp: Dict[str, Any]) -> Optional[dict]:
    """Pack an attention P·V einsum (``MRQSoftmaxQ`` probs, ``SymQ`` v)."""
    xq_q, x_tgq = _unwrap_tgq(qp.get("x"))
    bq_q, b_tgq = _unwrap_tgq(qp.get("b"))
    if not isinstance(xq_q, MRQSoftmaxQ) or not isinstance(bq_q, SymQ):
        return None
    if xq_q.bits != bq_q.bits or xq_q.bits not in (4, 6, 8):
        return None
    try:
        s1 = _stack_param(xq_q.s1, x_tgq)
        s_v = _stack_param(bq_q.scale, b_tgq)
    except ValueError:
        return None
    bc = _broadcast_groups(s1, s_v)
    if bc is None:
        return None
    s1, s_v, G = bc
    s2 = 1.0 / (2 ** (xq_q.bits - 1))
    return {"s1": s1, "s_v": s_v, "scale1": s1 * s_v, "scale2": s2 * s_v,
            "groups": G, "bits": int(xq_q.bits)}


_BUILDERS = {"int8": pack_int8_linear, "int8_mrq": pack_int8_mrq_linear,
             "int4": pack_int4_linear, "int4_mrq": pack_int4_mrq_linear}


def convert_for_kernels(qparams: Dict[str, dict],
                        weights: Dict[str, Any]) -> Dict[str, dict]:
    """Adds the first linear pack of ``LINEAR_PACKS`` that fits (``int8``
    / ``int8_mrq`` at 8 or 6 bits, ``int4`` / ``int4_mrq`` at 4 bits) to
    every eligible linear and an ``int8_qk`` / ``int8_pv`` pack (bits 8,
    6 or 4) to every eligible attention einsum."""
    out = {}
    for name, qp in qparams.items():
        qp = dict(qp)
        if name in weights:
            w = torch.as_tensor(weights[name])
            for key, _, _ in LINEAR_PACKS:
                pack = _BUILDERS[key](qp, w)
                if pack is not None:
                    qp[key] = pack
                    break
        if name.endswith("/qk"):
            qpack = pack_int8_qk(qp)
            if qpack is not None:
                qp["int8_qk"] = qpack
        elif name.endswith("/pv"):
            ppack = pack_int8_pv(qp)
            if ppack is not None:
                qp["int8_pv"] = ppack
        out[name] = qp
    return out


def quantize_int8(x, scale, zero):
    """fp -> signed int8 codes, elementwise with any broadcast of
    ``scale`` / ``zero`` (``ref.quantize_int8_ref``, on every device, as
    the reference computes it: an elementwise op, not a kernel). The
    serving path codes inside the fused linears' prologue pass and never
    materialises these codes."""
    return quantize_int8_ref(x, scale, zero)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _groups(pack: dict, tgroup, n_rows: int):
    """The pack's group operand for ``n_rows`` batch-major rows: the TGQ
    group clamped into the pack's range (an int), or, for a per-slot
    (B,) ``tgroup`` and a pack of G > 1 groups, one group per row (an
    (n_rows,) int32 device tensor, clamped into [0, G) by the kernel as
    it reads each entry). One forward hands every op the same ``tgroup``
    tensor, so each row vector is built once per (tgroup, n_rows) and
    shared by the ops of that forward."""
    G = pack["groups"]
    if G == 1 or not is_vec(tgroup):
        return resolve_group(tgroup, G)
    return cached_layout(tgroup, ("rows", n_rows), lambda t: _rows_vec(
        t.to(torch.int32), n_rows))


def _rows_vec(g, n_rows: int):
    """A per-slot (B,) group vector -> one entry per matmul row.
    ``x.reshape(-1, K)`` keeps rows batch-major, so slot b owns rows
    [b * n_rows / B, (b + 1) * n_rows / B); expand + reshape, no host
    read."""
    B = int(g.shape[0])
    if n_rows % B != 0:
        raise ValueError(f"vector tgroup: {n_rows} matmul rows not "
                         f"divisible by {B} slots")
    return g[:, None].expand(B, n_rows // B).reshape(n_rows)


def _as_vec(g, n: int, device):
    """A scalar group lifted to a constant (n,) int32 vector (a G = 1 pack
    riding beside a vector sibling); a vector passes through."""
    if is_vec(g):
        return g
    return torch.full((n,), int(g), dtype=torch.int32, device=device)


def _repeat_rows(n: int, B: int, device):
    """(n,) int32 row -> batch map for batch-major rows, n // B rows per
    batch: built once per (n, B, device) and kept beside ``group_ptr``'s
    index table (no launch and no host read per linear)."""
    key = ("rows", n, B, str(device))
    rows = _CACHE.get(key)
    if rows is None:
        rows = _CACHE[key] = torch.arange(
            B, dtype=torch.int32, device=device)[:, None] \
            .expand(B, n // B).reshape(n).contiguous()
    return rows


def _f32(bias):
    """The bias in f32: itself where it is already f32 and contiguous,
    else an f32 copy made once per bias tensor and freed with it
    (``cached_layout``), not one cast per call."""
    if bias is None or (bias.dtype == torch.float32 and bias.is_contiguous()):
        return bias
    return cached_layout(bias, "f32", lambda b: b.float().contiguous())


def _fusion_kwargs(pack: dict, xm, norm_mod, gate_residual) -> dict:
    """Kernel-side ``ps``/``nm``/``gr``/``bv`` operands for one linear;
    matmul rows stay batch-major under ``x.reshape(-1, K)``, so the
    row -> batch map is a plain repeat."""
    kw = {}
    ps = pack.get("x_prescale")
    if ps is not None:
        kw["ps"] = ps
    if norm_mod is None and gate_residual is None:
        return kw
    ref_rows = norm_mod[0] if norm_mod is not None else gate_residual[0]
    B = int(ref_rows.shape[0])
    n_rows = int(xm.shape[0])
    if n_rows % B != 0:
        raise ValueError(
            f"fusion rows: {n_rows} matmul rows not divisible by batch {B}")
    kw["bv"] = _repeat_rows(n_rows, B, xm.device)
    if norm_mod is not None:
        kw["nm"] = tuple(norm_mod)        # read in place by the kernel
    if gate_residual is not None:
        gate, res = gate_residual
        kw["gr"] = (gate.float(), res.reshape(-1, res.shape[-1]))
    return kw


def _linear(kern, kern_vec, wkey, x, pack, bias, out_dtype, tgroup,
            norm_mod, gate_residual, params, width):
    """One fused serving linear: the scalar kernel for a scalar group,
    its ``_vec`` sibling (one group per matmul row) for a vector."""
    out_dtype = out_dtype or x.dtype
    shape = x.shape
    xm = x.reshape(-1, shape[-1])
    g = _groups(pack, tgroup, xm.shape[0])
    kw = dict(bias=_f32(bias),
              out_dtype=out_dtype, **width,
              **_fusion_kwargs(pack, xm, norm_mod, gate_residual))
    args = (xm, pack[wkey]) + tuple(pack[k] for k in params)
    if is_vec(g):
        y = kern_vec(*args, gv=g, **kw)
    else:
        y = kern(*args, g=g, **kw)
    return y.reshape(shape[:-1] + (pack[wkey].shape[1],))


_AFFINE = ("sx", "zx", "scale", "corr")
_MRQ = ("s_neg", "s_pos", "scale_neg", "scale_pos")


def int8_linear(x, pack: dict, bias=None, out_dtype=None, tgroup=None,
                norm_mod=None, gate_residual=None):
    """Fused quantize -> matmul -> dequant serving linear (B1; B6a for a
    group vector)."""
    return _linear(int8_matmul_fq, int8_matmul_fq_vec, "wq", x, pack, bias,
                   out_dtype, tgroup, norm_mod, gate_residual, _AFFINE,
                   {"bits": pack.get("bits", 8)})


def int8_linear_mrq(x, pack: dict, bias=None, out_dtype=None, tgroup=None,
                    norm_mod=None, gate_residual=None):
    """MRQ-input serving linear (B2; B6b for a group vector): one weight
    traversal, two region accumulators."""
    return _linear(int8_matmul_mrq_fq, int8_matmul_mrq_fq_vec, "wq", x,
                   pack, bias, out_dtype, tgroup, norm_mod, gate_residual,
                   _MRQ, {"bits": pack.get("bits", 8)})


def int4_linear(x, pack: dict, bias=None, out_dtype=None, tgroup=None,
                norm_mod=None, gate_residual=None):
    """Packed-int4 serving linear (B4; B7a for a group vector): nibble
    weights, per-K-group dequant into an f32 accumulator."""
    return _linear(int4_matmul_fq, int4_matmul_fq_vec, "wp", x, pack, bias,
                   out_dtype, tgroup, norm_mod, gate_residual, _AFFINE,
                   {"group_k": pack["group_k"]})


def int4_linear_mrq(x, pack: dict, bias=None, out_dtype=None, tgroup=None,
                    norm_mod=None, gate_residual=None):
    """Packed-int4 MRQ-input serving linear (B5; B7b for a group vector):
    one nibble-weight traversal, two region accumulators, per-K-group
    dequant."""
    return _linear(int4_matmul_mrq_fq, int4_matmul_mrq_fq_vec, "wp", x,
                   pack, bias, out_dtype, tgroup, norm_mod, gate_residual,
                   _MRQ, {"group_k": pack["group_k"]})


def _one_dtype(q, k, v):
    """q, k and v in their promoted dtype: a bf16 operand beside an f32 one
    is widened (exactly), as the reference's kernels read every operand in
    f32. A quantized LM meets this: the act hook's f32 steps promote its
    activations to f32 after layer 0's SwiGLU, so layer 0's bf16 q reads
    an f32 decode cache."""
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    return tuple(t if t.dtype == dt else t.to(dt) for t in (q, k, v))


def int8_attention(q, k, v, qk_pack: dict, pv_pack: dict, *, mask=None,
                   scale=1.0, tgroup=None, out_dtype=None):
    """int8 grouped SDPA as the composed three-kernel chain (B9a -> B10a
    -> B9b; B9c -> B10b -> B9d for a group vector): the exactness oracle
    beside flash, ``attn_impl="composed"``.

    Same contract and packs as :func:`flash_attention`: q (B, Sq, Hk, G,
    hd); k, v (B, Skv, Hk, hd), at any strides with the head dim
    contiguous: B9a reads the q and k views of the qkv projection's output
    where they lie, and B9b reads v and writes (B, Sq, Hk, G, hd)
    contiguous, so neither side copies. mask broadcastable to (B, Hk, G,
    Sq, Skv) boolean or None, applied to the f32 (B·Hk·G, Sq, Skv) scores
    between B9a and B10a; ``scale`` multiplies the QK^T dequant scale (in
    the kernel). Returns (B, Sq, Hk, G, hd) in ``out_dtype`` (q's dtype by
    default). The probabilities travel from B10a to B9b as int8
    region-signed codes. With a per-slot (B,) ``tgroup``, the packs'
    (B·Hk·G,) row vectors come from ``_groups`` (built once per forward);
    B10b reads its row's entry at ``row // Sq``."""
    out_dtype = out_dtype or q.dtype
    q, k, v = _one_dtype(q, k, v)
    B, Sq, Hk, G, _ = q.shape
    Skv = k.shape[1]
    BHG = B * Hk * G
    g_qk = _groups(qk_pack, tgroup, BHG)
    g_pv = _groups(pv_pack, tgroup, BHG)
    vec = is_vec(g_qk) or is_vec(g_pv)
    qk_bits = int(qk_pack.get("bits", 8))
    pv_bits = int(pv_pack.get("bits", 8))
    qk_args = (q, k, qk_pack["s_q"], qk_pack["s_k"], qk_pack["scale"])
    pv_params = (pv_pack["s_v"], pv_pack["scale1"], pv_pack["scale2"])
    if vec:
        g_qk, g_pv = (_as_vec(g, BHG, q.device) for g in (g_qk, g_pv))
        scores = int8_bmm_qk_vec(*qk_args, gv=g_qk, bits=qk_bits,
                                 alpha=scale)
    else:
        scores = int8_bmm_qk(*qk_args, g=g_qk, bits=qk_bits, alpha=scale)
    if mask is not None:
        scores = torch.where(mask, scores.reshape(B, Hk, G, Sq, Skv),
                             NEG_INF).reshape(BHG, Sq, Skv)
    if vec:
        codes = softmax_mrq_codes_vec(scores, pv_pack["s1"], gv=g_pv,
                                      bits=pv_bits)
        return int8_bmm_pv_vec(codes, v, *pv_params, gv=g_pv, bits=pv_bits,
                               out_dtype=out_dtype)
    codes = softmax_mrq_codes(scores, pv_pack["s1"], g=g_pv, bits=pv_bits)
    return int8_bmm_pv(codes, v, *pv_params, g=g_pv, bits=pv_bits,
                       out_dtype=out_dtype)


def flash_attention(q, k, v, qk_pack: dict, pv_pack: dict, *, mask=None,
                    scale=1.0, tgroup=None, out_dtype=None):
    """int8 grouped SDPA as ONE flash kernel launch (B3; at 4 bits with
    packed kv, B3b; B8 for a group vector).

    q: (B, Sq, Hk, G, hd); k, v: (B, Skv, Hk, hd), at any strides with the
    head dim contiguous: the kernel reads the q, k and v views of the qkv
    projection's output where they lie and writes (B, Sq, Hk, G, hd)
    contiguous, so neither side copies. ``scale`` multiplies the QK^T
    dequant scale (in the kernel). With a per-slot (B,) ``tgroup`` each
    slot's group repeats over its Hk * G batch·head rows (slot-major).
    ``mask``: boolean, broadcastable to (B, Hk, G, Sq, Skv), True = attend;
    the kernel sets each masked lane to ``NEG_INF`` before the online
    max. A mask that does not vary over heads (the LM's causal and decode
    masks) has its bits packed once per (batch, q row)."""
    out_dtype = out_dtype or q.dtype
    q, k, v = _one_dtype(q, k, v)
    B, Sq, Hk, G, hd = q.shape
    Skv = k.shape[1]
    BHG = B * Hk * G
    mf = None
    if mask is not None:
        # kept 5-D: the kernel path packs its bits once per distinct
        # (batch, q row), not once per head (``head_mask_bits``)
        mf = torch.as_tensor(mask, device=q.device)
        mf = mf.reshape((1,) * (5 - mf.ndim) + tuple(mf.shape))
        torch.broadcast_shapes(mf.shape, (B, Hk, G, Sq, Skv))
    bits = int(qk_pack.get("bits", 8))
    g_qk = _groups(qk_pack, tgroup, BHG)
    g_pv = _groups(pv_pack, tgroup, BHG)
    if is_vec(g_qk) or is_vec(g_pv):
        g_qk, g_pv = (_as_vec(g, BHG, q.device) for g in (g_qk, g_pv))
    args = (q, k, v, qk_pack["s_q"], qk_pack["s_k"], qk_pack["scale"],
            pv_pack["s1"], pv_pack["s_v"], pv_pack["scale1"],
            pv_pack["scale2"], g_qk, g_pv, mf)
    kw = dict(scale=scale, bits=bits, packed_kv=bits == 4,
              out_dtype=out_dtype)
    if is_vec(g_qk):
        return flash_attn_mrq_vec(*args, **kw)
    return flash_attn_mrq(*args, **kw)


# ---------------------------------------------------------------------------
# fused activation kernels (public API)
# ---------------------------------------------------------------------------
def softmax_mrq_op(scores, s1, bits: int = 8, out_dtype=torch.float32):
    """Row softmax then MRQ two-region quant-dequant (B12)."""
    return softmax_mrq(scores, s1, bits=bits, out_dtype=out_dtype)


def act_mrq_op(x, s_neg, s_pos, bits: int = 8, kind: str = "gelu",
               out_dtype=torch.float32):
    """GELU (tanh) or SiLU then MRQ signed quant-dequant (B13)."""
    return act_mrq(x, s_neg, s_pos, bits=bits, kind=kind,
                   out_dtype=out_dtype)
