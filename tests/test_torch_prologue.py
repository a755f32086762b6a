"""The prologue pass of the fused linears (``csrc/prologue.cuh``),
modelled on the CPU.

The pass computes the layernorm row statistics of the norm-modulated
linears itself, in a fixed order, and writes the activation codes in
chunks of 16 code columns. The kernel cannot run here; these tests hold
what the plain version and the wrappers replay of it:

- ``ref.layernorm_stats`` (``ref.chunk_rowsum``) equals a numpy model of
  the kernel's summation order bit for bit (lane t of a warp adds the
  16-column chunks t, t + 32, ... in order from 0, then five butterfly
  steps; IEEE divides by K, a correctly rounded sqrt and reciprocal), at
  d = 1152, at ragged K and at a K past the pass's registers;
- those statistics stay within ``B1_B2_norm_mod_plain_vs_jax_flip_rate``
  of the JAX package's (``_prep_fusions``: jnp mean, var, rsqrt) in the
  codes they give, at d = 1152 and at ragged K;
- ``prologue.chunk_map`` (the kernel's ``chunk_src``) and
  ``prologue.code_layout`` (the plain version's layout) address the same
  x column for every code column as the layout of the pass this one
  replaced, ``c -> (c // gkp) * gk + c % gkp`` with padding at 0: the
  int8 family's identity map and the int4 family's groups of 16, 40 and
  256 at ragged K;
- ``prologue.codes`` on CPU tensors (the plain version) equals the JAX
  package's codes wherever no statistics are involved;
- the serving glue builds the row -> batch map once per shape and the
  f32 bias once per bias tensor.

Serial time about 10 s.
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import int8_fused as jfused
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

PRO = importlib.import_module("repro_torch.kernels.prologue")
NM_FLIP_RATE = tref.TOLERANCES["B1_B2_norm_mod_plain_vs_jax_flip_rate"][0]
f32 = np.float32


def _kernel_order_stats(x, eps=1e-6):
    """numpy model of ``prologue_rows_kernel``: per row, 32 lane partials
    over the 16-column chunks lane, lane + 32, ... (each in column order,
    from 0), five butterfly steps, then mu = S / K, var = S2 / K and rsig = 1 /
    sqrt(var + eps), every step rounded to f32."""
    M, K = x.shape
    ns = -(-K // 16)
    mus, rsigs = [], []

    def warp(vals):
        p = [f32(0)] * 32
        for lane in range(32):
            for c in range(lane, ns, 32):
                for i in range(16):
                    k = 16 * c + i
                    if k < K:
                        p[lane] = f32(p[lane] + vals[k])
        for o in (16, 8, 4, 2, 1):
            p = [f32(p[t] + p[t ^ o]) for t in range(32)]
        return p[0]
    for row in x.astype(f32):
        mu = f32(warp(row) / f32(K))
        d = (row - mu).astype(f32)
        var = f32(warp((d * d).astype(f32)) / f32(K))
        mus.append(mu)
        rsigs.append(f32(f32(1) / np.sqrt(f32(var + f32(eps)))))
    return np.array(mus, f32)[:, None], np.array(rsigs, f32)[:, None]


@pytest.mark.parametrize("K", [1152, 70, 16, 4608])
def test_layernorm_stats_follow_the_kernel_order(K):
    r = np.random.default_rng(K)
    x = (r.standard_normal((3, K)) * 2 + 0.5).astype(f32)
    mu, rsig = tref.layernorm_stats(torch.from_numpy(x))
    want_mu, want_rsig = _kernel_order_stats(x)
    np.testing.assert_array_equal(mu.numpy(), want_mu)
    np.testing.assert_array_equal(rsig.numpy(), want_rsig)


def _codes(x, mu, rsig, sh, sc, bv, step, zero, half):
    """Affine codes of the norm-modulated rows (numpy, f32 op by op)."""
    xn = ((x - mu).astype(f32) * rsig).astype(f32)
    xm = ((xn * (f32(1) + sc[bv]).astype(f32)).astype(f32)
          + sh[bv]).astype(f32)
    q = np.round((xm / step).astype(f32)) + zero - half
    return np.clip(q, -half, half - 1)


@pytest.mark.parametrize("K", [1152, 70])
def test_layernorm_stats_within_the_jax_flip_budget(K):
    """Codes from the port's statistics against codes from the JAX
    package's ``_prep_fusions`` statistics, the same modulate and quantize
    after them: at most ``NM_FLIP_RATE`` of them differ."""
    r = np.random.default_rng(7 + K)
    M, B = 256, 4
    x = (r.standard_normal((M, K)) * 1.5).astype(f32)
    sh, sc = ((r.standard_normal((B, K)) * 0.2).astype(f32)
              for _ in range(2))
    bv = np.repeat(np.arange(B, dtype=np.int32), M // B)
    _, _, nm_rows, _ = jfused._prep_fusions(
        jnp.asarray(x), None, (jnp.asarray(sh), jnp.asarray(sc)), None,
        jnp.asarray(bv), M=M, K=K, N=1, Mp=M, Kp=K, Np=1)
    j_mu, j_rsig = (np.asarray(a) for a in nm_rows[:2])
    t_mu, t_rsig = (a.numpy() for a in
                    tref.layernorm_stats(torch.from_numpy(x)))
    np.testing.assert_allclose(t_mu, j_mu, rtol=0, atol=4e-7 * K)
    np.testing.assert_allclose(t_rsig, j_rsig, rtol=1e-6, atol=0)
    for half in (128, 32, 8):
        step, zero = f32(8.0 / (2 * half - 1)), f32(np.round(4.0 * (2 * half
                                                                  - 1) / 8.0))
        cj = _codes(x, j_mu, j_rsig, sh, sc, bv, step, zero, half)
        ct = _codes(x, t_mu, t_rsig, sh, sc, bv, step, zero, half)
        assert (cj != ct).mean() <= NM_FLIP_RATE, (half, (cj != ct).sum())


def _old_layout(K, Kq, gk, gkp):
    """The replaced pass's map: code column c reads x column (c // gkp) *
    gk + c % gkp when c % gkp < gk and that column is below K, else -1
    (code 0)."""
    c = np.arange(Kq)
    kk = (c // gkp) * gk + c % gkp
    return np.where((c % gkp < gk) & (kk < K), kk, -1)


LAYOUTS = ([(K, None) for K in (1, 16, 70, 1152, 4608)]
           + [(K, gk) for gk in (16, 40, 256)
              for K in (16, 70, 300, 1152, 4608) if gk <= K or gk == 16])


@pytest.mark.parametrize("K,gk", LAYOUTS)
def test_chunk_map_matches_the_code_layout(K, gk):
    if gk is None:
        Kq = -16 * (-K // 16)
        gk_, gkp = Kq, Kq
    else:
        gk_, gkp = gk, -128 * (-gk // 128)
        Kq = -(-K // gk) * gkp
    want = _old_layout(K, Kq, gk_, gkp)
    got = np.full(Kq, -1)
    for j, (k0, n) in enumerate(PRO.chunk_map(K, Kq, gk_, gkp)):
        for i in range(max(n, 0)):
            got[16 * j + i] = k0 + i
    np.testing.assert_array_equal(got, want)
    # the plain version's layout puts x column want[c] at code column c
    codes = torch.arange(1, K + 1, dtype=torch.int32).remainder(127) + 1
    laid = PRO.code_layout(codes[None].to(torch.int8), Kq, gk_, gkp)[0]
    expect = np.where(want >= 0, codes.numpy()[np.maximum(want, 0)], 0)
    np.testing.assert_array_equal(laid.numpy(), expect)


@pytest.mark.parametrize("mrq", [False, True])
@pytest.mark.parametrize("bits,gk", [(8, None), (6, None), (4, 16), (4, 40)])
def test_plain_codes_match_jax_without_stats(bits, gk, mrq):
    """``prologue.codes`` on CPU tensors (the plain version) against the
    JAX package's quantizers after its prologue, ``/ ps`` only, per-row
    groups with out-of-range entries clamped: equal code for code."""
    r = np.random.default_rng(bits + (gk or 0) + mrq)
    M, K, G, half = 36, 70, 5, 2 ** (bits - 1)
    x = (r.standard_normal((M, K)) * 2).astype(f32)
    ps = (0.75 + 0.5 * r.random(K)).astype(f32)
    rate = (1 + 0.1 * r.random((G, 1))).astype(f32)
    if mrq:
        s_a, s_b = rate * f32(0.2 / half), rate * f32(6.0 / half)
    else:
        s_a = rate * f32(8.0 / (2 * half - 1))
        s_b = np.round(f32(4.0) / s_a).astype(f32)
    gv = r.integers(-1, G + 1, M).astype(np.int32)
    gkp = None if gk is None else -128 * (-gk // 128)
    got = PRO.codes(torch.from_numpy(x), torch.from_numpy(s_a),
                    torch.from_numpy(s_b), torch.from_numpy(gv), mrq=mrq,
                    bits=bits, gk=gk, gkp=gkp, ps=torch.from_numpy(ps))
    xj = jref.fused_prologue_ref(jnp.asarray(x), ps=jnp.asarray(ps))
    gc = np.clip(gv, 0, G - 1)
    if mrq:                  # the JAX oracle's region codes, inline
        neg = xj < 0
        planes = (jnp.where(neg, jnp.clip(jnp.round(xj / s_a[gc]), -half, 0),
                            0).astype(jnp.int8),
                  jnp.where(neg, 0, jnp.clip(jnp.round(xj / s_b[gc]), 0,
                                             half - 1)).astype(jnp.int8))
    else:
        planes = (jref.quantize_int8_ref(xj, s_a[gc], s_b[gc], bits),)
    _, gk_, gkp_, Kq = PRO._width(K, bits, gk, gkp)
    want = torch.stack([PRO.code_layout(torch.from_numpy(np.array(p)),
                                        Kq, gk_, gkp_) for p in planes])
    assert got.shape == want.shape == (2 if mrq else 1, M, Kq)
    assert torch.equal(got, want)


def test_serving_glue_is_built_once():
    rows = ops._repeat_rows(2048, 8, torch.device("cpu"))
    assert ops._repeat_rows(2048, 8, torch.device("cpu")) is rows
    assert torch.equal(rows, torch.arange(8, dtype=torch.int32)
                       .repeat_interleave(256))
    b = torch.randn(7).to(torch.bfloat16)
    f = ops._f32(b)
    assert f.dtype == torch.float32 and ops._f32(b) is f
    assert torch.equal(f, b.float())
    b32 = torch.randn(7)
    assert ops._f32(b32) is b32 and ops._f32(None) is None
