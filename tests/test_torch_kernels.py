"""The port's plain kernel versions held against the JAX package's oracles.

Inputs are made from a seed with numpy and handed to both packages. The
port's wrappers run their plain PyTorch versions on CPU tensors; the JAX
side runs the jnp oracles of ``repro.kernels.ref`` eagerly (op by op, so
XLA contracts no multiply-add). Tolerances (see
``repro_torch.kernels.ref.TOLERANCES``):

- B1/B2 without ``norm_mod``: bit-exact.
- B1/B2 with ``norm_mod``: the layernorm statistics differ by ulps between
  torch and XLA, so a code sitting on a rounding boundary may flip: at
  most 1e-3 of the codes, and every output row whose codes agree is
  bit-exact.
- B3: exp and the row sums differ by ulps between torch and XLA, so the
  rescaled accumulators differ by ulps (relative 1e-5 bounds them) and a
  probability code may flip: at most 2% of the output rows carry a flip
  (each flip moves one row), and no element moves by more than two
  coarse region steps x max|v|.
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.kernels import int8_fused as F8
from repro_torch.kernels import ref as tref

FA = importlib.import_module("repro_torch.kernels.flash_attn_mrq")

EXACT = tref.TOLERANCES["B1_B2_plain_vs_jax"][0]
NM_FLIP_RATE = tref.TOLERANCES["B1_B2_norm_mod_plain_vs_jax_flip_rate"][0]
ROW_FLIP_RATE = tref.TOLERANCES["B3_flipped_row_rate"][0]
M, K, N, B = 36, 70, 45, 4          # ragged on every axis


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _linear_inputs(seed, bits, G, mrq, fusion):
    r = np.random.default_rng(seed)
    half = 2 ** (bits - 1)
    x = r.standard_normal((M, K)).astype(np.float32)
    if mrq:
        x = np.where(x < 0, 0.1 * x, 2 * x).astype(np.float32)
    wq = r.integers(-(half - 1), half, (K, N)).astype(np.int8)
    p = {"x": x, "wq": wq,
         "bias": r.standard_normal(N).astype(np.float32) * 0.1,
         "bv": np.repeat(np.arange(B, dtype=np.int32), M // B)}
    rate = (1 + 0.1 * r.random((G, 1))).astype(np.float32)
    sw = (r.random((1, N)) * 1e-3 + 1e-4).astype(np.float32)
    if mrq:
        p["s_a"] = rate * np.float32(0.3 / half)
        p["s_b"] = rate * np.float32(6.0 / half)
        p["scale_a"], p["scale_b"] = p["s_a"] * sw, p["s_b"] * sw
    else:
        p["s_a"] = rate * np.float32(8.0 / (2 * half - 1))
        p["s_b"] = np.round(np.float32(4.0) / p["s_a"]).astype(np.float32)
        p["scale_a"] = p["s_a"] * sw
        p["corr"] = ((p["s_b"].astype(np.int32) - half)
                     * wq.astype(np.int32).sum(0)[None]).astype(np.int32)
    if "nm" in fusion:
        p["nm"] = tuple(r.standard_normal((B, K)).astype(np.float32) * 0.2
                        for _ in range(2))
    if "gr" in fusion:
        p["gr"] = (r.standard_normal((B, N)).astype(np.float32),
                   r.standard_normal((M, N)).astype(np.float32))
    return p


def _run_both(p, g, bits, mrq):
    kw_j = {"bits": bits, "g": g, "bias": jnp.asarray(p["bias"])}
    kw_t = {}
    if "nm" in p:
        kw_j["nm"] = tuple(jnp.asarray(a) for a in p["nm"])
        kw_t["nm"] = tuple(_t(a) for a in p["nm"])
    if "gr" in p:
        kw_j["gr"] = tuple(jnp.asarray(a) for a in p["gr"])
        kw_t["gr"] = tuple(_t(a) for a in p["gr"])
    if "nm" in p or "gr" in p:
        kw_j["bv"] = jnp.asarray(p["bv"])
        kw_t["bv"] = _t(p["bv"])
    if mrq:
        j = jref.int8_matmul_mrq_fq_fused_ref(
            jnp.asarray(p["x"]), jnp.asarray(p["wq"]), p["s_a"], p["s_b"],
            p["scale_a"], p["scale_b"], **kw_j)
        t = F8.int8_matmul_mrq_fq(
            _t(p["x"]), _t(p["wq"]), _t(p["s_a"]), _t(p["s_b"]),
            _t(p["scale_a"]), _t(p["scale_b"]), _t(p["bias"]), g, bits=bits,
            **kw_t)
    else:
        j = jref.int8_matmul_fq_fused_ref(
            jnp.asarray(p["x"]), jnp.asarray(p["wq"]), p["s_a"], p["s_b"],
            p["scale_a"], p["corr"], **kw_j)
        t = F8.int8_matmul_fq(
            _t(p["x"]), _t(p["wq"]), _t(p["s_a"]), _t(p["s_b"]),
            _t(p["scale_a"]), _t(p["corr"]), _t(p["bias"]), g, bits=bits,
            **kw_t)
    return np.asarray(j), t.numpy()


def _codes_both(p, g, bits, mrq):
    """The activation codes each package quantizes to (post-prologue)."""
    nm_j = tuple(jnp.asarray(a) for a in p["nm"])
    xj = np.asarray(jref.fused_prologue_ref(jnp.asarray(p["x"]), nm=nm_j,
                                            bv=jnp.asarray(p["bv"])))
    xt = tref.fused_prologue_ref(_t(p["x"]), nm=tuple(map(_t, p["nm"])),
                                 bv=_t(p["bv"]).long())
    if mrq:
        half = 2 ** (bits - 1)
        cj = [np.asarray(c) for c in (jnp.where(
            xj < 0, jnp.clip(jnp.round(xj / p["s_a"][g, 0]), -half, 0), 0),
            jnp.where(xj < 0, 0, jnp.clip(jnp.round(xj / p["s_b"][g, 0]),
                                          0, half - 1)))]
        ct = [c.numpy() for c in tref.mrq_codes_ref(
            xt, _t(p["s_a"])[g, 0], _t(p["s_b"])[g, 0], half)]
        return np.stack(cj).astype(np.int32), np.stack(ct).astype(np.int32)
    cj = np.asarray(jref.quantize_int8_ref(jnp.asarray(xj), p["s_a"][g, 0],
                                           p["s_b"][g, 0], bits))
    ct = tref.quantize_int8_ref(xt, _t(p["s_a"])[g, 0], _t(p["s_b"])[g, 0],
                                bits).numpy()
    return cj[None].astype(np.int32), ct[None].astype(np.int32)


LINEAR_CASES = [(mrq, fusion, bits, G)
                for mrq, fusions in ((False, ("", "nm", "gr")),
                                     (True, ("", "gr")))
                for fusion in fusions for bits in (8, 6) for G in (1, 3)]


@pytest.mark.parametrize("mrq,fusion,bits,G", LINEAR_CASES)
def test_plain_linear_matches_jax_ref(mrq, fusion, bits, G):
    p = _linear_inputs(7 + bits + G + 10 * len(fusion), bits, G, mrq, fusion)
    g = G - 1
    j, t = _run_both(p, g, bits, mrq)
    assert j.dtype == t.dtype == np.float32 and j.shape == t.shape == (M, N)
    if "nm" not in fusion:
        np.testing.assert_allclose(t, j, rtol=0, atol=EXACT)
        return
    cj, ct = _codes_both(p, g, bits, mrq)
    flips = cj != ct
    assert flips.mean() <= NM_FLIP_RATE, flips.mean()
    clean_rows = ~flips.any(axis=(0, 2))
    np.testing.assert_array_equal(t[clean_rows], j[clean_rows])


def test_wrapper_counts_only_kernel_launches():
    """CPU tensors take the plain version and count no launch; a tensor on
    another device raises instead of falling back."""
    p = _linear_inputs(1, 8, 1, False, "")
    kernels.reset_launches()
    _run_both(p, 0, 8, False)
    assert kernels.LAUNCHES == {k: 0 for k in kernels.LAUNCHES}
    with pytest.raises(RuntimeError, match="no kernel or plain version"):
        F8.int8_matmul_fq(torch.empty((2, 3), device="meta"),
                          _t(p["wq"][:3]), *(None,) * 4)


# (op, M, K, N, splits K) at the DiT-XL/2 serving shapes, 2B = 8 rows
SERVING_GEMMS = [("qkv", 2048, 1152, 3456, False),
                 ("proj", 2048, 1152, 1152, False),
                 ("fc1", 2048, 1152, 4608, False),
                 ("fc2", 2048, 4608, 1152, False),
                 ("x_proj", 2048, 16, 1152, False),
                 ("ada", 8, 1152, 6912, True),
                 ("t_mlp1", 8, 256, 1152, True),
                 ("t_mlp2", 8, 1152, 1152, True),
                 ("final_ada", 8, 1152, 2304, True),
                 ("final", 2048, 1152, 32, True)]


@pytest.mark.parametrize("op,M,K,N,splits", SERVING_GEMMS)
def test_gemm_split_k_fills_the_card(op, M, K, N, splits):
    """On an H100's 132 SMs the int8 GEMM (128 x 144 tiles, 128-deep k
    tiles) splits K only where its tile grid leaves SMs idle, into no
    more splits than k tiles and no more CTAs than SMs."""
    Kp = -F8._KPAD * (-K // F8._KPAD)
    ks = F8.split_k(M, N, Kp, 132)
    tiles = -(-M // F8._BM) * -(-N // F8._BN)
    assert (ks > 1) == splits, (op, ks)
    assert 1 <= ks <= -(-Kp // F8._BK)
    assert tiles * ks <= 132 or ks == 1


def test_profile_step_splits_gemm_by_op():
    """``profile_step`` pairs the GEMM kernel events (start order) with
    the recorded int8 launch shapes of a DiT-XL/2 forward (2B = 8 rows)
    and sums each op's device time; unmatched counts give no split."""
    from repro_torch.configs.dit_xl_2 import full
    from repro_torch.launch.profile_step import gemm_by_op
    cfg = full()
    ops = {op: (M, K, N) for op, M, K, N, _ in SERVING_GEMMS}
    order = ["x_proj", "t_mlp1", "t_mlp2"] + 2 * ["ada", "qkv", "proj",
                                                   "fc1", "fc2"] \
        + ["final_ada", "final"]
    shapes = [ops[o] for o in order]
    events = [(float(i), 1.0 + i) for i in range(len(order))]  # (start, us)
    split = gemm_by_op(events[::-1], shapes, cfg)    # in any order
    assert {k: v[0] for k, v in split.items()} == {
        "qkv": 2, "proj": 2, "fc1": 2, "fc2": 2, "ada": 2, "rest": 5}
    want = dict.fromkeys(split, 0.0)
    for i, o in enumerate(order):
        want[o if o in want else "rest"] += 1.0 + i
    assert {k: v[1] for k, v in split.items()} == want
    assert gemm_by_op(events[1:], shapes, cfg) is None


def test_profile_step_detects_lost_kernel_events():
    """``profile_step`` traces again when the profiler lost events: fewer
    events of the port's own kernels than counted launches, or a GEMM
    family whose events are not one per recorded launch."""
    from repro_torch.launch.profile_step import lost_events
    gemm = "void (anonymous namespace)::gemm_kernel<false>(CUtensorMap_st)"
    names = [gemm, "void (anonymous namespace)::prologue_rows_kernel<false, "
             "__nv_bfloat16, __nv_bfloat16>(int)",
             "void (anonymous namespace)::flash_kernel<__nv_bfloat16, 3, "
             "80, 1, true>(int)", "void at::native::elementwise_kernel<4>()"]
    shapes = {"gemm_kernel<": [(8, 64, 64)], "gemm4_kernel<": []}
    assert lost_events(names, 2, shapes) is None
    assert "3 events of the port's kernels for 4 launches" in \
        lost_events(names, 4, shapes)
    assert "gemm_kernel<" in lost_events(names[1:], 1, shapes)
    assert lost_events([], 2, shapes) is not None     # a whole trace


FLASH_CASES = [(bits, G, S, D) for bits in (8, 6) for G in (1, 3)
               for S, D in ((100, 72), (200, 16))]


@pytest.mark.parametrize("bits,G,S,D", FLASH_CASES)
def test_plain_flash_matches_jax_ref(bits, G, S, D):
    r = np.random.default_rng(100 * bits + 10 * G + S)
    BH, half = 6, 2 ** (bits - 1)
    q, k, v = (r.standard_normal((BH, S, D)).astype(np.float32) * 1.5
               for _ in range(3))
    rate = (1 + 0.1 * r.random((G, 1))).astype(np.float32)
    s_q = rate * np.float32(6.0 / (half - 1))
    s_k = s_q * np.float32(1.05)
    s1 = np.clip(rate * np.float32(8.0 / S / half), 1 / (half * half * 8),
                 1 / half).astype(np.float32)
    s_v = rate * np.float32(4.0 / (half - 1))
    qk_pack = {"s_q": s_q, "s_k": s_k, "scale": s_q * s_k}
    pv_pack = {"s1": s1, "s_v": s_v, "scale1": s1 * s_v,
               "scale2": np.float32(1.0 / half) * s_v}
    scale = D ** -0.5
    g_qk, g_pv = G - 1, 0
    j = np.asarray(jref.flash_attn_mrq_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        {a: jnp.asarray(b) for a, b in qk_pack.items()},
        {a: jnp.asarray(b) for a, b in pv_pack.items()}, scale=scale,
        g_qk=g_qk, g_pv=g_pv, bits=bits))
    qs = _t(qk_pack["scale"]) * torch.tensor(scale, dtype=torch.float32)
    t = FA.flash_attn_mrq(
        _t(q), _t(k), _t(v), _t(s_q), _t(s_k), qs, _t(s1), _t(s_v),
        _t(pv_pack["scale1"]), _t(pv_pack["scale2"]), g_qk, g_pv,
        bits=bits).numpy()
    assert t.shape == j.shape == (BH, S, D)
    rate, max_err = tref.flash_flip_stats(torch.from_numpy(t),
                                          torch.from_numpy(j))
    assert rate <= ROW_FLIP_RATE, rate
    step = float(s_v[g_pv, 0]) * (half - 1) / half
    assert max_err <= tref.TOLERANCES["B3_atol_steps"][0] * step
