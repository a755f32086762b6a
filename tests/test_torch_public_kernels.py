"""The port's public kernel API off the serving path — B11 ``int8_matmul``,
B12 ``softmax_mrq``, B13 ``act_mrq`` and the boolean mask of flash
attention (B3, B3b, B8) — held against the JAX package on the CPU.

Inputs are made from numpy seeds and handed to both packages; the port's
wrappers run their plain versions on CPU tensors, the JAX side its eager
jnp oracles (``repro.kernels.ref``), except for the last test, where the
JAX entry points run their Pallas kernels in interpret mode at a tiny
size. Tolerances (``repro_torch.kernels.ref.TOLERANCES``):

- B11: bit-exact (``B11_plain_vs_jax``), with and without bias, f32 and
  bf16 out, over the reference's ``MM_SHAPES``;
- B12, B13: at most ``B12_flip_rate_vs_jax`` / ``B13_flip_rate_vs_jax``
  of the outputs differ (XLA's exp, tanh and row-sum order), each by one
  quantization step of its region;
- masked flash (causal, random with fully masked rows, ragged Skv with a
  padding mask, GQA; scalar, packed-kv and per-row-group): at most
  ``B3_flipped_row_rate`` of the output rows carry a flip, each within
  ``B3_atol_steps`` coarse steps; every other row is bit-exact.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = tref.TOLERANCES
MM_SHAPES = [(8, 16, 8), (64, 96, 80), (128, 256, 128), (7, 13, 5),
             (130, 257, 129), (256, 512, 384)]
SM_SHAPES = [(4, 16), (2, 3, 64), (2, 4, 8, 32), (5, 100), (64, 256)]
ACT_SHAPES = [(16, 100), (3, 5, 130), (64, 512), (2048, 1024)]
DTYPES = ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16))
TDTYPES = (torch.float32, torch.bfloat16)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _round_to(a, tdt):
    """f32 values of ``a`` rounded to ``tdt`` (round to nearest even, as
    jnp's cast), so that both packages see the same inputs."""
    return _t(a).to(tdt).float().numpy()


def _mm_inputs(M, K, N):
    r = np.random.default_rng(M * K + N)
    xq = r.integers(-128, 128, (M, K)).astype(np.int8)
    wq = r.integers(-128, 128, (K, N)).astype(np.int8)
    scale = (r.random(N) * 0.01 + 1e-4).astype(np.float32)
    corr = (3 * wq.astype(np.int32).sum(0)).astype(np.int32)
    bias = r.standard_normal(N).astype(np.float32)
    return xq, wq, scale, corr, bias


@pytest.mark.parametrize("shape", MM_SHAPES)
def test_int8_matmul_matches_jax_ref(shape):
    """B11's plain version, through the public wrapper, equals the jnp
    oracle bit for bit: bias and no bias, f32 and bf16 out."""
    xq, wq, scale, corr, bias = _mm_inputs(*shape)
    for b in (bias, None):
        for jdt, tdt in DTYPES:
            j = jref.int8_matmul_ref(
                jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
                jnp.asarray(corr), None if b is None else jnp.asarray(b),
                out_dtype=jdt)
            t = kernels.int8_matmul(_t(xq), _t(wq), _t(scale), _t(corr),
                                    None if b is None else _t(b),
                                    out_dtype=tdt)
            assert t.dtype == tdt and tuple(t.shape) == j.shape
            np.testing.assert_array_equal(_f32(t), _f32(j))
    assert TOL["B11_plain_vs_jax"][0] == 0.0


def _flips_one_step(t, j, steps, key):
    """At most ``TOL[key]`` of the outputs (one of a smaller tensor)
    differ, each by one of ``steps`` (within f32 rounding of the
    dequantised values)."""
    t, j = _f32(t), _f32(j)
    d = np.abs(t - j)
    flipped = d > 0
    assert flipped.sum() <= max(1.0, TOL[key][0] * d.size), flipped.sum()
    if flipped.any():
        near = np.zeros(d.shape, bool)
        for s in steps:
            near |= np.isclose(d, s, rtol=1e-5, atol=0)
        assert near[flipped].all(), d[flipped & ~near]


@pytest.mark.parametrize("bits", [8, 6])
@pytest.mark.parametrize("shape", SM_SHAPES)
def test_softmax_mrq_matches_jax_ref(shape, bits):
    """B12's plain version against ``softmax_mrq_ref``, f32 and bf16
    scores, both step kinds (the reference's test step and a small one)."""
    r = np.random.default_rng(sum(shape) + bits)
    half = 2 ** (bits - 1)
    s = (r.standard_normal(shape) * 4).astype(np.float32)
    for s1 in (np.float32(0.25 / half),
               np.float32(8.0 / shape[-1] / half)):
        for tdt in TDTYPES:
            sc = _round_to(s, tdt)
            j = jref.softmax_mrq_ref(jnp.asarray(sc), s1, bits)
            t = kernels.softmax_mrq(_t(sc).to(tdt), float(s1), bits=bits)
            assert t.dtype == torch.float32 and tuple(t.shape) == shape
            _flips_one_step(t, j, (float(s1), 1.0 / half),
                            "B12_flip_rate_vs_jax")
        tb = kernels.softmax_mrq(_t(s), float(s1), bits=bits,
                                 out_dtype=torch.bfloat16)
        assert tb.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _f32(tb), _f32(tref.softmax_mrq_ref(_t(s), float(s1), bits)
                           .to(torch.bfloat16)))


@pytest.mark.parametrize("shape", ACT_SHAPES)
@pytest.mark.parametrize("bits", [8, 6])
@pytest.mark.parametrize("kind", ["gelu", "silu"])
def test_act_mrq_matches_jax_ref(kind, bits, shape):
    """B13's plain version against ``act_mrq_ref`` over the reference's
    shape sweep, at the reference's steps and at calibrated-size ones,
    f32 and bf16 in and out."""
    r = np.random.default_rng(bits + len(shape) + shape[-1])
    half = 2 ** (bits - 1)
    x = (r.standard_normal(shape) * 3).astype(np.float32)
    for sn, sp in ((0.005, 0.03), (0.17 / half, 6.0 / half)):
        for tdt in TDTYPES:
            xc = _round_to(x, tdt)
            j = jref.act_mrq_ref(jnp.asarray(xc), sn, sp, bits, kind)
            t = kernels.act_mrq(_t(xc).to(tdt), sn, sp, bits=bits, kind=kind)
            assert t.dtype == torch.float32 and tuple(t.shape) == shape
            steps = [float(np.float32(s)) for s in (sn, sp)]
            _flips_one_step(t, j, steps, "B13_flip_rate_vs_jax")
    tb = kernels.act_mrq(_t(x), 0.005, 0.03, bits=bits, kind=kind,
                         out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        _f32(tb), _f32(tref.act_mrq_ref(_t(x), 0.005, 0.03, bits, kind)
                       .to(torch.bfloat16)))


def _packs(r, G, bits, S):
    half = 2 ** (bits - 1)
    rate = (1 + 0.1 * r.random((G, 1))).astype(np.float32)
    s_q = rate * np.float32(6.0 / (half - 1))
    s1 = np.clip(rate * np.float32(8.0 / S / half), 1 / (half * half * 8),
                 1 / half).astype(np.float32)
    s_v = rate * np.float32(4.0 / (half - 1))
    qk = {"s_q": s_q, "s_k": s_q * np.float32(1.05)}
    qk["scale"] = qk["s_q"] * qk["s_k"]
    pv = {"s1": s1, "s_v": s_v, "scale1": s1 * s_v,
          "scale2": np.float32(1.0 / half) * s_v}
    return qk, pv


def _mask(kind, r, B, M, N):
    """(B, M, N) boolean: causal; random at 1/2 with every fourth row fully
    masked; or a padding mask leaving out the last N // 4 keys."""
    if kind == "causal":
        return np.broadcast_to(np.tril(np.ones((M, N), bool)), (B, M, N))
    if kind == "random":
        m = r.random((B, M, N)) < 0.5
        m[:, ::4] = False
        return m
    return np.broadcast_to(np.arange(N) < N - N // 4, (B, M, N))


def _flash_close(t, j, pv, g, bits):
    rate, max_err = tref.flash_flip_stats(torch.from_numpy(np.asarray(t)),
                                          torch.from_numpy(np.asarray(j)))
    half = 2 ** (bits - 1)
    assert rate <= TOL["B3_flipped_row_rate"][0], rate
    step = float(pv["s_v"][g, 0]) * (half - 1) / half
    assert max_err <= TOL["B3_atol_steps"][0] * step, max_err


# (mask, B, Sq, Skv, hd, rep, bits, vec): causal, fully masked rows, ragged
# Skv = 77 with a padding mask, GQA, packed kv at 4 bits, per-row groups
FLASH_MASK_CASES = [
    ("causal", 2, 37, 200, 16, 1, 8, False),
    ("random", 2, 37, 200, 16, 1, 6, False),
    ("causal", 2, 37, 200, 16, 1, 4, False),
    ("padding", 1, 37, 77, 16, 2, 8, False),
    ("random", 1, 37, 77, 16, 2, 8, True),
    ("padding", 2, 37, 200, 16, 1, 4, True),
]


@pytest.mark.parametrize("case", FLASH_MASK_CASES,
                         ids=["-".join(map(str, c)) for c in FLASH_MASK_CASES])
def test_masked_flash_matches_jax_ref(case):
    """Masked B3/B3b (scalar groups) and B8 (per-row groups) plain versions
    against ``flash_attn_mrq_ref(mask=...)`` / ``flash_attn_mrq_vec_ref``
    on kv repeated per q row."""
    kind, B, Sq, Skv, D, rep, bits, vec = case
    r = np.random.default_rng(FLASH_MASK_CASES.index(case))
    G = 3
    qk, pv = _packs(r, G, bits, Skv)
    q = r.standard_normal((B * rep, Sq, D)).astype(np.float32) * 1.5
    k, v = (r.standard_normal((B, Skv, D)).astype(np.float32) * 1.5
            for _ in "kv")
    mask = _mask(kind, r, B * rep, Sq, Skv)
    kr, vr = (np.repeat(a, rep, axis=0) for a in (k, v))
    jq = {a: jnp.asarray(b) for a, b in qk.items()}
    jp = {a: jnp.asarray(b) for a, b in pv.items()}
    tq = [_t(qk[a]) for a in ("s_q", "s_k", "scale")]
    tp = [_t(pv[a]) for a in ("s1", "s_v", "scale1", "scale2")]
    args = (_t(q), _t(k), _t(v), *tq, *tp)
    kw = dict(mask=_t(mask), bits=bits, packed_kv=bits == 4)
    if vec:
        gv = np.arange(B * rep, dtype=np.int32) % G
        j = jref.flash_attn_mrq_vec_ref(
            jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr), jq, jp,
            mask=jnp.asarray(mask), g_qk=jnp.asarray(gv),
            g_pv=jnp.asarray(gv), bits=bits)
        t = ops.flash_attn_mrq_vec(*args, _t(gv), _t(gv), **kw)
        g_err = G - 1
    else:
        j = jref.flash_attn_mrq_ref(
            jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr), jq, jp,
            mask=jnp.asarray(mask), g_qk=G - 1, g_pv=1, bits=bits)
        t = ops.flash_attn_mrq(*args, G - 1, 1, **kw)
        g_err = 1
    assert tuple(t.shape) == j.shape == (B * rep, Sq, D)
    assert np.isfinite(t.numpy()).all()
    _flash_close(t, j, pv, g_err, bits)


def test_fully_masked_row_averages_the_padded_tile():
    """A fully masked row of ragged Skv: every lane of the reference's
    padded tile gets e = exp(0) = 1, so the plain version gives the same
    row as a mask of all-True over a kv padded with zero keys and values
    to that tile (ceil8(Skv) lanes), never NaN."""
    r = np.random.default_rng(5)
    bits, Skv, D = 8, 13, 8
    qk, pv = _packs(r, 1, bits, Skv)
    q = r.standard_normal((1, 2, D)).astype(np.float32)
    k, v = (r.standard_normal((1, Skv, D)).astype(np.float32)
            for _ in "kv")
    args = [_t(qk[a]) for a in ("s_q", "s_k", "scale")] + \
        [_t(pv[a]) for a in ("s1", "s_v", "scale1", "scale2")]
    mask = np.zeros((1, 2, Skv), bool)
    mask[0, 1] = True
    out = ops.flash_attn_mrq(_t(q), _t(k), _t(v), *args, 0, 0,
                             mask=_t(mask), bits=bits)
    Np = 16                                # ceil8(13)
    kp, vp = (np.pad(a, ((0, 0), (0, Np - Skv), (0, 0))) for a in (k, v))
    zero_q = np.zeros_like(q[:, :1])       # all scores equal: uniform p
    uni = ops.flash_attn_mrq(_t(zero_q), _t(kp), _t(vp), *args, 0, 0,
                             bits=bits)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_array_equal(out[0, 0].numpy(), uni[0, 0].numpy())


def test_entry_points_match_jax_entry_points():
    """The slice as a whole at a tiny size: ``kernels.int8_matmul``,
    ``ops.softmax_mrq_op``, ``ops.act_mrq_op`` and
    ``ops.flash_attention(mask=...)`` against the JAX package's same entry
    points, which run their Pallas kernels in interpret mode here."""
    xq, wq, scale, corr, bias = _mm_inputs(7, 13, 5)
    j = jk.int8_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(scale),
                       jnp.asarray(corr), jnp.asarray(bias), interpret=True)
    t = kernels.int8_matmul(_t(xq), _t(wq), _t(scale), _t(corr), _t(bias))
    prod = (xq.astype(np.int32) @ wq.astype(np.int32) - corr).astype(
        np.float32) * scale
    ulp = np.spacing(np.maximum(np.abs(prod), np.abs(np.asarray(j))))
    assert (np.abs(t.numpy() - np.asarray(j))
            <= TOL["B11_plain_vs_jax_jit_ulps"][0] * ulp).all()

    r = np.random.default_rng(3)
    s = (r.standard_normal((2, 5, 100)) * 4).astype(np.float32)
    j = jops.softmax_mrq_op(jnp.asarray(s), 0.25 / 128, bits=8)
    t = ops.softmax_mrq_op(_t(s), 0.25 / 128, bits=8)
    _flips_one_step(t, j, (0.25 / 128, 1 / 128), "B12_flip_rate_vs_jax")

    x = (r.standard_normal((3, 5, 130)) * 3).astype(np.float32)
    for kind in ("gelu", "silu"):
        j = jops.act_mrq_op(jnp.asarray(x), 0.005, 0.03, bits=6, kind=kind)
        t = ops.act_mrq_op(_t(x), 0.005, 0.03, bits=6, kind=kind)
        _flips_one_step(t, j, (float(np.float32(0.005)),
                               float(np.float32(0.03))),
                        "B13_flip_rate_vs_jax")

    B, S, Hk, G, hd, bits = 1, 16, 2, 2, 8, 8
    qk, pv = _packs(r, 1, bits, S)
    q = r.standard_normal((B, S, Hk, G, hd)).astype(np.float32)
    k, v = (r.standard_normal((B, S, Hk, hd)).astype(np.float32)
            for _ in "kv")
    mask = np.tril(np.ones((S, S), bool))
    mask[3] = False                        # one fully masked row
    meta = {"groups": 1, "bits": bits}
    j = jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        {**{a: jnp.asarray(b) for a, b in qk.items()}, **meta},
        {**{a: jnp.asarray(b) for a, b in pv.items()}, **meta},
        mask=jnp.asarray(mask), scale=hd ** -0.5)
    t = ops.flash_attention(_t(q), _t(k), _t(v),
                            {**{a: _t(b) for a, b in qk.items()}, **meta},
                            {**{a: _t(b) for a, b in pv.items()}, **meta},
                            mask=_t(mask), scale=hd ** -0.5)
    assert tuple(t.shape) == j.shape == (B, S, Hk, G, hd)
    _flash_close(t, j, pv, 0, bits)
    assert kernels.LAUNCHES == {k_: 0 for k_ in kernels.LAUNCHES}


def _flip_counts():
    """The CPU measurements behind ``B12_flip_rate_vs_jax`` and
    ``B13_flip_rate_vs_jax``: outputs of the port's plain versions that
    differ from the jnp oracles at larger sizes, how often torch's tanh
    and exp differ from XLA's, and the GELU / SiLU spelling with XLA's
    tanh and exp put in."""
    import jax
    n = fl = 0
    for seed in range(8):
        r = np.random.default_rng(seed)
        for bits in (8, 6):
            half = 2 ** (bits - 1)
            for C, sd in ((256, 4.0), (100, 4.0), (64, 2.0), (16, 4.0)):
                s = (r.standard_normal((131072 // C, C)) * sd).astype(
                    np.float32)
                s1 = np.float32(0.25 / half if seed % 2 else 8.0 / C / half)
                j = np.asarray(jref.softmax_mrq_ref(jnp.asarray(s), s1, bits))
                t = tref.softmax_mrq_ref(_t(s), float(s1), bits).numpy()
                n, fl = n + j.size, fl + int((j != t).sum())
    print(f"B12: {fl} of {n} outputs differ")
    x = (np.random.default_rng(1).standard_normal((2048, 2048)) * 3).astype(
        np.float32)
    for kind in ("gelu", "silu"):
        for bits in (8, 6):
            half = 2 ** (bits - 1)
            for sn, sp in ((0.005, 0.03), (0.17 / half, 6.0 / half)):
                for tdt in TDTYPES:
                    xc = _round_to(x, tdt)
                    j = np.asarray(jref.act_mrq_ref(jnp.asarray(xc), sn, sp,
                                                    bits, kind))
                    t = tref.act_mrq_ref(_t(xc), sn, sp, bits, kind).numpy()
                    print(f"B13 {kind} bits {bits} s_neg {sn:.6g} "
                          f"{str(tdt)[6:]}: {int((j != t).sum())} of "
                          f"{j.size} outputs differ")
    xj, xt = jnp.asarray(x), _t(x)
    for name, jf, tf in (("tanh", jnp.tanh, torch.tanh),
                         ("exp", jnp.exp, torch.exp)):
        d = (np.asarray(jf(xj)) != tf(xt).numpy()).mean()
        print(f"{name}: XLA and torch differ on {d:.3f} of the elements")
    inner = tref.SQRT_2_OVER_PI * (xt + 0.044715 * (xt * xt * xt))
    th = _t(np.asarray(jnp.tanh(jnp.asarray(inner.numpy()))))
    g = (xt * (0.5 * (1.0 + th))).numpy()
    e = _t(np.asarray(jnp.exp(-xj)))
    si = (xt * torch.reciprocal(1.0 + e)).numpy()
    print("GELU, SiLU with XLA's tanh / exp equal jax.nn's:",
          bool((g == np.asarray(jax.nn.gelu(xj, approximate=True))).all()),
          bool((si == np.asarray(jax.nn.silu(xj))).all()))


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_public_kernels.py
    _flip_counts()
