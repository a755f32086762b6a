"""Plain PyTorch oracles for the serving-path kernels, and the port's
tolerance registry.

Torch ports of the main-path entries of ``repro/kernels/ref.py``. Each
``*_ref`` computes exactly what the corresponding kernel must produce, op
for op and rounding step for rounding step (``torch.round`` rounds half
to even as ``jnp.round`` does; every multiply and add is its own torch
op, so nothing contracts into an FMA). Integer products are exact:
int32 ``torch.matmul`` on the CPU, float64 on the GPU (|sum| stays far
below 2^53 at every serving shape).

The kernel modules' ``*_plain`` functions are these oracles with the
wrapper's layernorm statistics injected (``stats=``), so a kernel and its
plain version see identical prologue inputs.
"""
from __future__ import annotations

import torch

NEG_INF = -1e9
_M_INIT = -1e30


# ---------------------------------------------------------------------------
# tolerance registry: (bound, reason) per comparison
# ---------------------------------------------------------------------------
TOLERANCES = {
    # kernel (CUDA, card) vs its plain version (card)
    "B1_vs_plain": (0.0, "integer-exact codes and s32 sums; each prologue "
                    "and epilogue step rounds once in both (IEEE divide, "
                    "no FMA contraction: -fmad=false / __f*_rn)"),
    "B1_norm_mod_vs_plain": (0.0, "layernorm stats are computed once in "
                             "torch by the wrapper and shared by kernel "
                             "and plain version"),
    "B2_vs_plain": (0.0, "as B1: disjoint sign-split codes, two exact s32 "
                    "accumulators, per-step rounding in the epilogue"),
    "B3_flipped_row_rate": (0.02, "rowsum(e) over each 128-wide kv tile is "
                            "summed in another order by the kernel (per "
                            "thread, then warp shuffles) than by torch.sum "
                            "(and by XLA): l' differs by an ulp, so rho and "
                            "every accumulator of the row differ by ulps "
                            "(not counted: below 1e-5 x max|out| in f32, one "
                            "bf16 ulp of max|out| in bf16), and now and then "
                            "a probability code on a .5 boundary flips; at "
                            "most 2% of output rows may carry a flip"),
    "B3_atol_steps": (2.0, "a flip moves an output by at most one coarse "
                      "region step x max|v code| (s2 * s_v * (half-1)); "
                      "bound: two such steps"),
    # port's plain version (CPU) vs JAX's ref (CPU)
    "B1_B2_plain_vs_jax": (0.0, "no norm_mod: same f32 ops, same rounding "
                           "(the jnp oracles run eagerly, op by op)"),
    "B1_B2_norm_mod_plain_vs_jax_flip_rate": (
        1e-3, "torch and XLA sum the layernorm mean/var in different "
        "orders and differ in rsqrt by an ulp; a code sitting on a "
        ".5 boundary flips"),
    # whole forwards
    "dit_forward_plain_vs_jax_rel": (2e-2, "ulp differences (gelu, "
                                     "softmax, layernorm stats) flip a few "
                                     "codes; each flip moves an output by "
                                     "one quantization step"),
    "dit_forward_kernel_vs_plain_rel": (5e-2, "full-width bf16 forward: "
                                        "B3 code flips (see above) "
                                        "propagate through 28 blocks"),
}


def flash_flip_stats(out, ref):
    """(fraction of output rows carrying a flipped probability code,
    max |out - ref|) — see ``B3_flipped_row_rate``. out/ref: (..., D)."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    ulp = 2.0 ** -8 if out.dtype == torch.bfloat16 else 1e-5
    flipped = (err > ulp * r.abs().max()).any(dim=-1)
    return float(flipped.float().mean()), float(err.max())


def imatmul(a, b):
    """Exact integer product of integer-valued tensors -> int32."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    return torch.matmul(a.double(), b.double()).round().to(torch.int32)


# ---------------------------------------------------------------------------
# fused linears
# ---------------------------------------------------------------------------
def quantize_int8_ref(x, scale, zero, bits: int = 8):
    """Signed affine codes: clip(round(x/s)+z-h, -h, h-1), h=2^{b-1}."""
    half = 2 ** (bits - 1)
    q = torch.clamp(torch.round(x / scale) + zero - half, -half, half - 1)
    return q.to(torch.int8)


def int8_matmul_ref(xq, wq, scale, corr, bias=None, out_dtype=torch.float32):
    """y = (xq @ wq - corr) * scale (+ bias)."""
    acc = imatmul(xq, wq)
    y = (acc - corr[None, :]).float() * scale[None, :]
    if bias is not None:
        y = y + bias[None, :].float()
    return y.to(out_dtype)


def int8_matmul_fq_ref(x, wq, sx, zx, scale, corr, bias=None, g=0,
                       bits: int = 8, out_dtype=torch.float32):
    xq = quantize_int8_ref(x.float(), sx[g][0], zx[g][0], bits)
    return int8_matmul_ref(xq, wq, scale[g], corr[g], bias=bias,
                           out_dtype=out_dtype)


def mrq_codes_ref(xf, s_neg, s_pos, half):
    """Disjoint sign-split codes of the MRQ-signed linear input."""
    neg = xf < 0
    zero = torch.zeros((), dtype=xf.dtype, device=xf.device)
    qn = torch.where(neg, torch.clamp(torch.round(xf / s_neg), -half, 0),
                     zero).to(torch.int8)
    qp = torch.where(neg, zero, torch.clamp(torch.round(xf / s_pos), 0,
                                            half - 1)).to(torch.int8)
    return qn, qp


def int8_matmul_mrq_fq_ref(x, wq, s_neg, s_pos, scale_neg, scale_pos,
                           bias=None, g=0, bits: int = 8,
                           out_dtype=torch.float32):
    half = 2 ** (bits - 1)
    qn, qp = mrq_codes_ref(x.float(), s_neg[g][0], s_pos[g][0], half)
    y = (imatmul(qn, wq).float() * scale_neg[g][None]
         + imatmul(qp, wq).float() * scale_pos[g][None])
    if bias is not None:
        y = y + bias[None, :].float()
    return y.to(out_dtype)


def layernorm_stats(x, eps: float = 1e-6):
    """(mu, rsig) per row of x in f32 — the wrapper's prologue stats
    (mean, biased variance as the mean of squared deviations, rsqrt)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return mu, torch.rsqrt(var + eps)


def fused_prologue_ref(x, nm=None, ps=None, bv=None, eps: float = 1e-6,
                       stats=None):
    """Layernorm -> adaLN modulate (per-batch rows gathered by ``bv``) ->
    channel-balance divide, as the kernels' prologue computes it."""
    x = x.float()
    if nm is not None:
        sh, sc = nm
        mu, rsig = stats if stats is not None else layernorm_stats(x, eps)
        x = (x - mu) * rsig
        x = x * (1.0 + sc.float()[bv]) + sh.float()[bv]
    if ps is not None:
        x = x / ps.float()[None, :]
    return x


def fused_epilogue_ref(y, gr=None, bv=None):
    """``residual + gate[bv] * y``."""
    if gr is not None:
        gate, res = gr
        y = res.float() + gate.float()[bv] * y
    return y


def int8_matmul_fq_fused_ref(x, wq, sx, zx, scale, corr, bias=None, g=0,
                             ps=None, nm=None, gr=None, bv=None,
                             bits: int = 8, out_dtype=torch.float32,
                             stats=None):
    xf = fused_prologue_ref(x, nm=nm, ps=ps, bv=bv, stats=stats)
    y = int8_matmul_fq_ref(xf, wq, sx, zx, scale, corr, bias=bias, g=g,
                           bits=bits)
    return fused_epilogue_ref(y, gr=gr, bv=bv).to(out_dtype)


def int8_matmul_mrq_fq_fused_ref(x, wq, s_neg, s_pos, scale_neg, scale_pos,
                                 bias=None, g=0, ps=None, nm=None, gr=None,
                                 bv=None, bits: int = 8,
                                 out_dtype=torch.float32, stats=None):
    xf = fused_prologue_ref(x, nm=nm, ps=ps, bv=bv, stats=stats)
    y = int8_matmul_mrq_fq_ref(xf, wq, s_neg, s_pos, scale_neg, scale_pos,
                               bias=bias, g=g, bits=bits)
    return fused_epilogue_ref(y, gr=gr, bv=bv).to(out_dtype)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def sym_quantize_int8_ref(x, scale, bits: int = 8):
    """Symmetric codes over [-(h-1), h-1]."""
    hi = 2 ** (bits - 1) - 1
    return torch.clamp(torch.round(x.float() / scale), -hi, hi).to(torch.int8)


def _ceil(x, to=8):
    return max(to, -to * (-x // to))


def flash_core_ref(q, k, v, sq, sk, qs, s1, sv, sc1, sc2, bits: int,
                   bn: int = 128, out_dtype=torch.float32):
    """The flash kernel's per-kv-tile recurrence over (B, S, hd) operands
    with per-call scalar params (0-d f32 tensors): int8 QK^T, NEG_INF on
    ragged lanes BEFORE the online max, running max/denominator, MRQ
    codes against the running normalisation, dual-region integer P·V with
    the fp rescale ``rho = corr * l_prev / l_new``."""
    B, M, D = q.shape
    N = k.shape[1]
    half = 2 ** (bits - 1)
    bn_ = min(bn, _ceil(N))
    Np = -bn_ * (-N // bn_)
    s2 = 1.0 / half
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, 0, 0, Np - N))
    q8 = sym_quantize_int8_ref(q, sq, bits)
    k8 = sym_quantize_int8_ref(pad(k), sk, bits)
    v8 = sym_quantize_int8_ref(pad(v), sv, bits)

    dev = q.device
    m_run = torch.full((B, M, 1), _M_INIT, dtype=torch.float32, device=dev)
    l_run = torch.zeros((B, M, 1), dtype=torch.float32, device=dev)
    acc1 = torch.zeros((B, M, D), dtype=torch.float32, device=dev)
    acc2 = torch.zeros((B, M, D), dtype=torch.float32, device=dev)
    col = torch.arange(Np, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for n0 in range(0, Np, bn_):
        kt, vt = k8[:, n0:n0 + bn_], v8[:, n0:n0 + bn_]
        s = imatmul(q8, kt.transpose(1, 2)).float() * qs
        s = torch.where(col[n0:n0 + bn_][None, None, :] < N, s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        e = torch.exp(s - m_new)
        corr = torch.exp(m_run - m_new)
        l_new = l_run * corr + e.sum(dim=-1, keepdim=True)
        p = e / l_new
        region1 = p < half * s1
        c1 = torch.where(region1, torch.clamp(torch.round(p / s1), 0,
                                              half - 1), zero)
        c2 = torch.where(region1, zero,
                         torch.clamp(torch.round(p / s2), 0, half))
        d1 = imatmul(c1, vt)
        d2 = imatmul(c2, vt)
        rho = corr * l_run / l_new
        acc1 = acc1 * rho + d1.float()
        acc2 = acc2 * rho + d2.float()
        m_run, l_run = m_new, l_new
    return (acc1 * sc1 + acc2 * sc2).to(out_dtype)


def flash_attn_mrq_ref(q, k, v, qk_pack, pv_pack, scale=1.0, g_qk=0,
                       g_pv=0, bits: int = 8, bn: int = 128,
                       out_dtype=torch.float32):
    """Tile-faithful oracle over FLATTENED (B, S, hd) operands (kv
    materialised per q batch), mirroring ``repro.kernels.ref``."""
    return flash_core_ref(
        q, k, v, qk_pack["s_q"][g_qk][0], qk_pack["s_k"][g_qk][0],
        qk_pack["scale"][g_qk][0] * scale, pv_pack["s1"][g_pv][0],
        pv_pack["s_v"][g_pv][0], pv_pack["scale1"][g_pv][0],
        pv_pack["scale2"][g_pv][0], bits, bn=bn, out_dtype=out_dtype)
