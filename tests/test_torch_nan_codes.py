"""The port's plain versions against the JAX package's oracles where the
inputs are not finite: a NaN (of either sign) and +-inf among the
activations of

- the SymQ codes (``sym_quantize_int8_ref``), which flash (B3, B3b, B8)
  and the composed matmuls (B9a-d) make of q, k and v;
- the affine codes (``quantize_int8_ref``) of B1, B4, B6a and B7a;
- the MRQ sign-split codes (``mrq_codes_ref``) of B2, B5, B6b and B7b
  (the JAX side through ``int8_matmul_mrq_fq_ref`` with an identity
  weight, whose output is the sum of the two disjoint code planes);
- the softmax codes B10a and B10b, the softmax quant-dequant B12 and the
  activation quant-dequant B13, on rows with a NaN, a +inf, only -inf or
  both infinities (a NaN row sum: codes 0, values NaN), beside rows whose
  softmax is exact in both packages (-inf among equal scores).

Each output equals the oracle's, a NaN equal to a NaN; the card tests
(``tests/test_torch_cuda.py``) hold the kernels to these plain versions on
the same kinds of input. The port's wrappers run their plain versions on
CPU tensors. About 4 s serial beyond the imports (9 s for the file alone
with them).
"""
from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.kernels import ref as tref

SM = importlib.import_module("repro_torch.kernels.softmax_mrq")

NAN, INF = float("nan"), float("inf")
# NaN of both signs, +-inf, signed zeros, and finite values off the
# half-way points of every step below
ACTS = np.array([NAN, -NAN, INF, -INF, 0.0, -0.0, 0.3, -0.3, 1.1, -7.9,
                 1e30, -1e30], np.float32)
# rows of 8 scores: NaN, +inf, -inf among equal scores (p = 1/2 exactly),
# only -inf, both infinities, all NaN, all equal (p = 1/8 exactly)
ROWS = np.array([[NAN, 0, 1, 2, 3, 4, 5, 6],
                 [INF, 0, 1, 2, 3, 4, 5, 6],
                 [-INF, -INF, 0, 0, -INF, -INF, -INF, -INF],
                 [-INF] * 8,
                 [INF, -INF, 0, 0, 0, 0, 0, 0],
                 [NAN] * 8,
                 [0.0] * 8], np.float32)
BAD = [0, 1, 3, 4, 5]                    # the rows whose sum is NaN


def _same(t, j):
    """Equal as f32, a NaN equal to a NaN."""
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j).astype(np.float32))


@pytest.mark.parametrize("bits", [8, 6, 4])
def test_activation_codes_match_jax_on_non_finite(bits):
    """SymQ, affine and MRQ sign-split codes: NaN codes to 0 (the int8
    cast of the NaN that round and clip keep), +-inf saturates."""
    half = 2 ** (bits - 1)
    x, xt = jnp.asarray(ACTS), torch.from_numpy(ACTS)
    s, zero, sn, sp = 0.0123, 3.0, 0.17 / half, 6.0 / half
    t = tref.sym_quantize_int8_ref(xt, s, bits)
    _same(t, jref.sym_quantize_int8_ref(x, s, bits))
    assert t[:2].tolist() == [0, 0] and t[2:4].tolist() == [half - 1,
                                                           1 - half]
    t = tref.quantize_int8_ref(xt, s, zero, bits)
    _same(t, jref.quantize_int8_ref(x, s, zero, bits))
    assert t[:2].tolist() == [0, 0] and t[2:4].tolist() == [half - 1, -half]
    qn, qp = tref.mrq_codes_ref(xt[None], torch.tensor(sn),
                                torch.tensor(sp), half)
    K = ACTS.size
    j = jref.int8_matmul_mrq_fq_ref(
        x[None], jnp.eye(K, dtype=jnp.int8), jnp.full((1, 1), sn),
        jnp.full((1, 1), sp), jnp.ones((1, K)), jnp.ones((1, K)), bits=bits)
    _same(qn.float() + qp.float(), j)
    assert qn[0, :2].tolist() == qp[0, :2].tolist() == [0, 0]


@pytest.mark.parametrize("bits", [8, 6, 4])
def test_softmax_codes_match_jax_on_non_finite_rows(bits):
    """B10a and B10b: a row with a NaN sum codes to 0; the exact rows
    code as the reference."""
    half = 2 ** (bits - 1)
    s1 = np.array([[0.01], [0.2 / half]], np.float32)
    gv = np.array([1, 0, 1, 0, 1, 0, 1], np.int32)
    sc = torch.from_numpy(ROWS)
    for g in (0, 1):
        t = SM.softmax_mrq_codes(sc, torch.from_numpy(s1), g, bits=bits)
        _same(t, jref.softmax_mrq_codes_ref(jnp.asarray(ROWS),
                                            jnp.asarray(s1), g, bits))
        assert not t[BAD].any()
    t = SM.softmax_mrq_codes_vec(sc, torch.from_numpy(s1),
                                 torch.from_numpy(gv), bits=bits)
    _same(t, jref.softmax_mrq_codes_vec_ref(
        jnp.asarray(ROWS), jnp.asarray(s1), jnp.asarray(gv), bits))
    assert not t[BAD].any()


@pytest.mark.parametrize("bits", [8, 6, 4])
def test_softmax_mrq_matches_jax_on_non_finite_rows(bits):
    """B12: a row with a NaN sum is NaN throughout, f32 and bf16 out."""
    half = 2 ** (bits - 1)
    for s1 in (0.01, 0.2 / half):
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            t = kernels.softmax_mrq(torch.from_numpy(ROWS), s1, bits=bits,
                                    out_dtype=tdt)
            assert t.dtype == tdt
            _same(t, jref.softmax_mrq_ref(jnp.asarray(ROWS), s1, bits,
                                          out_dtype=jdt))
            assert bool(torch.isnan(t[BAD]).all())
            assert not torch.isnan(t[[2, 6]]).any()


@pytest.mark.parametrize("bits", [8, 6, 4])
@pytest.mark.parametrize("kind", ["gelu", "silu"])
def test_act_mrq_matches_jax_on_non_finite(kind, bits):
    """B13: NaN in gives NaN out, +inf the top code's value, -inf NaN (the
    activation makes -inf * 0)."""
    half = 2 ** (bits - 1)
    x = ACTS[[0, 1, 2, 3, 4, 5]]
    sn, sp = 0.17 / half, 6.0 / half
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        t = kernels.act_mrq(torch.from_numpy(x), sn, sp, bits=bits,
                            kind=kind, out_dtype=tdt)
        _same(t, jref.act_mrq_ref(jnp.asarray(x), sn, sp, bits, kind,
                                  out_dtype=jdt))
        assert bool(torch.isnan(t[[0, 1, 3]]).all())
        assert t[2].item() == torch.tensor((half - 1) * sp).to(tdt).item()
