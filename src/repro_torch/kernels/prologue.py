"""The activation prologue pass of the fused linears, on its own.

Every fused linear (B1, B2, B6a, B6b in ``int8_fused``; B4, B5, B7a, B7b
in ``int4_packed``) launches the pass of ``csrc/prologue.cuh`` before its
GEMM, inside the same launcher call: with ``nm``, the layernorm row
statistics, then normalise -> adaLN modulate -> ``/ ps`` -> affine or MRQ
codes, written as (M, Kq) int8 code planes. This module holds what is
the pass's alone:

- ``codes`` runs the pass without a GEMM (CUDA tensors) and returns its
  code planes; ``codes_plain`` is its plain version (CPU tensors, or the
  card for the comparison), bit for bit equal (``B1_norm_mod_vs_plain``).
  The card tests and ``chip_smoke.py`` hold them against each other.
- ``chunk_map`` models the kernel's ``chunk_src``: which x columns each
  16-column code chunk reads, and which of its columns are padding.
- ``div_probe`` runs the shared quotient helpers (``div_rn``,
  ``rint_div`` of ``csrc/common.cuh``) on given numerators and divisors.

The code layout: code column c holds x column ``(c // gkp) * gk + c %
gkp`` (K cut into groups of ``gk`` columns, each zero-padded to ``gkp``
code columns; the int8 family passes gk = gkp = Kq, the identity);
columns past K and each group's padding hold code 0.
"""
from __future__ import annotations

import torch

from repro_torch import kernels as _k
from repro_torch.kernels import build, ref
from repro_torch.kernels.int8_fused import (
    _DT, _need, _ptr, clamp_groups, group_arg, is_vec, mod_rows,
)

QC = 16          # code columns per chunk: one 16-byte store per code plane


def chunk_map(K: int, Kq: int, gk: int, gkp: int):
    """(k0, n) per code chunk j of a row, as ``chunk_src`` computes them:
    the chunk's code columns 16 j .. 16 j + 15 read x columns k0 .. k0 +
    n - 1 (n <= 0: the chunk is all padding). gkp must be a multiple of
    16, so no chunk straddles two groups."""
    if Kq % QC or gkp % QC or not 0 < gk <= gkp:
        raise ValueError(f"chunk map: Kq {Kq}, gk {gk}, gkp {gkp}")
    out = []
    for j in range(Kq // QC):
        c = j * QC
        grp, cg = divmod(c, gkp)
        k0 = grp * gk + cg
        out.append((k0, min(QC, gk - cg, K - k0)))
    return out


def code_layout(c, Kq: int, gk: int, gkp: int):
    """(M, K) codes -> the pass's (M, Kq) int8 layout: group i's columns
    [i gk, i gk + gk) at code columns [i gkp, ...), zeros elsewhere."""
    M, K = c.shape
    out = torch.zeros((M, Kq), dtype=torch.int8, device=c.device)
    for i in range(Kq // gkp):
        n = max(0, min(gk, K - i * gk))
        out[:, i * gkp:i * gkp + n] = c[:, i * gk:i * gk + n]
    return out


def _width(K: int, bits: int, gk, gkp):
    """(half, gk, gkp, Kq): the int8 family's identity map when gk is
    None, else the int4 family's groups."""
    if gk is None:
        Kq = -QC * (-K // QC)
        return 2 ** (bits - 1), Kq, Kq, Kq
    return 2 ** (bits - 1), gk, gkp, -(-K // gk) * gkp


def codes_plain(x, s_a, s_b, g=0, *, mrq=False, bits=8, gk=None, gkp=None,
                ps=None, nm=None, bv=None):
    """Plain version of the pass: ``ref.fused_prologue_ref`` (the
    statistics in the pass's order), then the affine codes
    (``ref.quantize_int8_ref``; s_a the step, s_b the zero point) or the
    MRQ region codes (``ref.mrq_codes_ref``; s_a, s_b the steps) at row
    i's group (``g`` an int, or an (M,) vector clamped into [0, G)), laid
    out by ``code_layout``. Returns (planes, M, Kq) int8, planes 2 for
    MRQ."""
    half, gk, gkp, Kq = _width(x.shape[1], bits, gk, gkp)
    xf = ref.fused_prologue_ref(
        x, nm=nm, ps=ps, bv=None if bv is None else bv.long())
    if is_vec(g):
        gv = clamp_groups(g, s_a.shape[0]).long()
        sa, sb = s_a[gv], s_b[gv]
    else:
        sa, sb = s_a[g][0], s_b[g][0]
    if mrq:
        planes = ref.mrq_codes_ref(xf, sa, sb, half)
    else:
        planes = (ref.quantize_int8_ref(xf, sa, sb, bits),)
    return torch.stack([code_layout(c, Kq, gk, gkp) for c in planes])


def codes(x, s_a, s_b, g=0, *, mrq=False, bits=8, gk=None, gkp=None,
          ps=None, nm=None, bv=None):
    """The pass alone (arguments as ``codes_plain``; x (M, K) f32/bf16,
    s_a, s_b (G, 1) f32, nm = (shift, scale) (B, K) f32 or bf16 at any
    row stride). CUDA tensors launch the kernel (no launch count: the
    fused linears count theirs), CPU tensors take the plain version."""
    if not _k.use_kernel(x):
        return codes_plain(x, s_a, s_b, g, mrq=mrq, bits=bits, gk=gk,
                           gkp=gkp, ps=ps, nm=nm, bv=bv)
    x = x.contiguous()
    M, K = x.shape
    dev = x.device
    half, gk, gkp, Kq = _width(K, bits, gk, gkp)
    G = s_a.shape[0]
    _need(x, "x", tuple(_DT), (M, K), dev)
    for name, t in (("s_a", s_a), ("s_b", s_b)):
        _need(t, name, (torch.float32,), (G, 1), dev)
    if ps is not None:
        _need(ps, "ps", (torch.float32,), (K,), dev)
    sh = sc = None
    sh_rs = sc_rs = nm_bf16 = 0
    if nm is not None:
        _need(bv, "bv", (torch.int32,), (M,), dev)
        sh, sc, sh_rs, sc_rs, nm_bf16 = mod_rows(nm, K, dev)
    if is_vec(g):
        g = g.to(torch.int32).contiguous()
    gptr, gs = group_arg(g, dev)
    out = torch.empty((2 if mrq else 1, M, Kq), dtype=torch.int8, device=dev)
    err = build.lib("int8_fused").prologue_codes_launch(
        x.data_ptr(), s_a.data_ptr(), s_b.data_ptr(), gptr, _ptr(ps),
        _ptr(bv), _ptr(sh), _ptr(sc), out[0].data_ptr(), out[-1].data_ptr(),
        M, K, Kq, half, gk, gkp, _DT[x.dtype], nm_bf16, int(mrq), gs, G,
        sh_rs, sc_rs, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "int8_fused", "prologue pass")
    return out


def div_probe(a, b):
    """(div_rn(a, b), rint_div(a, b)) elementwise on the card: the shared
    correctly rounded quotient and the pass's rounded quotient (a, b f32
    CUDA tensors of one shape)."""
    a, b = a.float().contiguous(), b.float().contiguous()
    q, r = torch.empty_like(a), torch.empty_like(a)
    err = build.lib("int8_fused").prologue_div_probe(
        a.data_ptr(), b.data_ptr(), q.data_ptr(), r.data_ptr(), a.numel(),
        torch.cuda.current_stream(a.device).cuda_stream)
    build.check(err, "int8_fused", "prologue_div_probe")
    return q, r
