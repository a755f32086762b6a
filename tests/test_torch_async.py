"""The port's continuous-batching path held against the JAX package and
against the port's own sync engine, on the CPU.

- The per-row-group plain versions (B6a, B6b, B7a, B7b, B8) against the
  JAX package's vec and fused-vec oracles (``repro.kernels.ref``), G in
  {1, 3}, mixed vectors, ragged M/N/K, with and without the fusions:
  bit-exact without ``norm_mod`` (``vec_plain_vs_jax``); with it at most
  ``B1_B2_norm_mod_plain_vs_jax_flip_rate`` of the codes flip and every
  row whose codes agree is bit-exact; flash within the row-flip budget
  of ``B3_flipped_row_rate`` / ``B3_atol_steps``. A constant vector
  gives exactly the scalar path's output.
- ``ddpm_chunk_slots`` against JAX's on the same slot state and seeds,
  with a linear noise model: positions, flags and the per-slot groups
  equal; latents within relative 1e-5 (the normals differ by a few ulps,
  ``erfinv``).
- ``AsyncServeEngine`` against the port's ``ServeEngine``, bit for bit
  (fp and the w8a8 kernel context, mixed step buckets, chunks 2, 3 and
  5), and against JAX's ``AsyncServeEngine`` at fp within 1e-4 x
  max|jax| (the bound of ``test_serve_engine_fp_matches_jax``).
- The lifecycle layer, mirroring ``tests/test_async_serving.py`` and
  ``tests/test_chaos.py`` (minus the 2-device pool): admission, queue
  bound, cancel, deadlines under ``FakeClock``, NaN quarantine with a
  bit-identical retry, sticky poison, the degradation ladder (both rungs,
  and a stop on the composed rung), and ``pipeline`` 1 against 2.
"""
from __future__ import annotations

import dataclasses
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion import DiffusionCfg as JDiffusionCfg
from repro.diffusion import ddpm as jddpm
from repro.kernels import int4_packed as jint4
from repro.kernels import ref as jref
from repro.serving import AsyncServeEngine as JAsyncServeEngine
from repro.serving import GenRequest as JGenRequest
from repro_torch.diffusion import ddpm
from repro_torch.kernels import int4_packed as F4
from repro_torch.kernels import int8_fused as F8
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models.dit import DiTCfg, params_from_numpy
from repro_torch.quant.api import quantize
from repro_torch.quant.recipe import QuantRecipe
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import AsyncServeEngine, ServeEngine
from repro_torch.serving.faults import (
    EngineFault, FakeClock, Fault, FaultInjector,
)

FA = importlib.import_module("repro_torch.kernels.flash_attn_mrq")

EXACT = tref.TOLERANCES["vec_plain_vs_jax"][0]
NM_FLIP_RATE = tref.TOLERANCES["B1_B2_norm_mod_plain_vs_jax_flip_rate"][0]


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# per-row-group plain versions against the jnp vec oracles
# ---------------------------------------------------------------------------
M, B = 36, 4                 # 9 rows per batch row; ragged on every tile


def _linear_inputs(seed, kind, G, fusion, bits, K=70, N=45, group_k=40):
    r = np.random.default_rng(seed)
    int4, mrq = kind.startswith("int4"), kind.endswith("mrq")
    half = 8 if int4 else 2 ** (bits - 1)
    x = r.standard_normal((M, K)).astype(np.float32)
    if mrq:
        x = np.where(x < 0, 0.1 * x, 2 * x).astype(np.float32)
    if int4:
        nk = -(-K // group_k)
        codes = r.integers(-7, 8, (nk * group_k, N)).astype(np.int8)
        codes[K:] = 0
        w = np.asarray(jint4.pack_int4(jnp.asarray(codes)))
        sw = (r.random((1, nk, N)) * 1e-2 + 1e-3).astype(np.float32)
        colsum = codes.astype(np.int32).reshape(nk, group_k, N).sum(1)[None]
        expand = lambda s: s[:, :, None] * sw
        corr = lambda z: (z[:, :, None] * colsum).astype(np.int32)
    else:
        w = r.integers(-(half - 1), half, (K, N)).astype(np.int8)
        sw = (r.random((1, N)) * 1e-3 + 1e-4).astype(np.float32)
        colsum = w.astype(np.int32).sum(0)[None]
        expand = lambda s: s * sw
        corr = lambda z: (z * colsum).astype(np.int32)
    rate = (1 + 0.1 * r.random((G, 1))).astype(np.float32)
    if mrq:
        s_a, s_b = rate * np.float32(0.3 / half), rate * np.float32(6 / half)
        params = (s_a, s_b, expand(s_a), expand(s_b))
    else:
        s_a = rate * np.float32(8.0 / (2 * half - 1))
        s_b = np.round(np.float32(4.0) / s_a).astype(np.float32)
        params = (s_a, s_b, expand(s_a), corr(s_b.astype(np.int32) - half))
    p = {"x": x, "w": w, "params": params,
         "bias": r.standard_normal(N).astype(np.float32) * 0.1,
         "bv": np.repeat(np.arange(B, dtype=np.int32), M // B),
         "gv": r.integers(0, G, M).astype(np.int32)}
    if "nm" in fusion:
        p["nm"] = tuple(r.standard_normal((B, K)).astype(np.float32) * 0.2
                        for _ in range(2))
    if "gr" in fusion:
        p["gr"] = (r.standard_normal((B, N)).astype(np.float32),
                   r.standard_normal((M, N)).astype(np.float32))
    if "ps" in fusion:
        p["ps"] = (0.5 + r.random(K)).astype(np.float32)
    return p


_FNS = {  # kind -> (jnp fused-vec oracle, port vec wrapper, port scalar)
    "int8": (jref.int8_matmul_fq_vec_fused_ref, F8.int8_matmul_fq_vec,
             F8.int8_matmul_fq),
    "int8_mrq": (jref.int8_matmul_mrq_fq_vec_fused_ref,
                 F8.int8_matmul_mrq_fq_vec, F8.int8_matmul_mrq_fq),
    "int4": (jref.int4_matmul_fq_vec_fused_ref, F4.int4_matmul_fq_vec,
             F4.int4_matmul_fq),
    "int4_mrq": (jref.int4_matmul_mrq_fq_vec_fused_ref,
                 F4.int4_matmul_mrq_fq_vec, F4.int4_matmul_mrq_fq),
}


def _kwargs(p, kind, bits):
    width = ({"group_k": 40} if kind.startswith("int4") else {"bits": bits})
    kw_j, kw_t = dict(width), dict(width)
    for key in ("nm", "gr"):
        if key in p:
            kw_j[key] = tuple(jnp.asarray(a) for a in p[key])
            kw_t[key] = tuple(_t(a) for a in p[key])
    if "ps" in p:
        kw_j["ps"], kw_t["ps"] = jnp.asarray(p["ps"]), _t(p["ps"])
    if "nm" in p or "gr" in p:
        kw_j["bv"], kw_t["bv"] = jnp.asarray(p["bv"]), _t(p["bv"])
    return kw_j, kw_t


def _row_codes(p, kind, bits):
    """Each package's affine activation codes after the norm-modulate
    prologue, per row with its own group (only the affine family takes
    ``norm_mod``)."""
    half_bits = 4 if kind.startswith("int4") else bits
    gv = p["gv"]
    s_a, s_b = p["params"][:2]
    xj = jref.fused_prologue_ref(
        jnp.asarray(p["x"]), nm=tuple(jnp.asarray(a) for a in p["nm"]),
        bv=jnp.asarray(p["bv"]))
    xt = tref.fused_prologue_ref(_t(p["x"]), nm=tuple(map(_t, p["nm"])),
                                 bv=_t(p["bv"]).long())
    cj = np.asarray(jref.quantize_int8_ref(xj, s_a[gv], s_b[gv], half_bits))
    ct = tref.quantize_int8_ref(xt, _t(s_a)[gv], _t(s_b)[gv],
                                half_bits).numpy()
    return cj, ct


VEC_LINEAR_CASES = (
    [("int8", f, bits, G) for f in ("", "nm", "gr_ps") for bits in (8, 6)
     for G in (1, 3)]
    + [("int8_mrq", f, bits, G) for f in ("", "gr") for bits in (8, 6)
       for G in (1, 3)]
    + [("int4", f, 4, G) for f in ("", "nm", "gr_ps") for G in (1, 3)]
    + [("int4_mrq", f, 4, G) for f in ("", "gr") for G in (1, 3)])


@pytest.mark.parametrize("kind,fusion,bits,G", VEC_LINEAR_CASES)
def test_vec_plain_linear_matches_jax_vec_ref(kind, fusion, bits, G):
    p = _linear_inputs(3 * G + bits + 17 * len(fusion) + len(kind), kind, G,
                       fusion, bits)
    jfn, vec, scalar = _FNS[kind]
    kw_j, kw_t = _kwargs(p, kind, bits)
    j = np.asarray(jfn(jnp.asarray(p["x"]), jnp.asarray(p["w"]),
                       *p["params"], bias=jnp.asarray(p["bias"]),
                       gv=jnp.asarray(p["gv"]), **kw_j))
    targs = (_t(p["x"]), _t(p["w"])) + tuple(map(_t, p["params"])) \
        + (_t(p["bias"]),)
    t = vec(*targs, _t(p["gv"]), **kw_t).numpy()
    assert j.dtype == t.dtype == np.float32 and j.shape == t.shape
    if "nm" not in fusion:
        np.testing.assert_allclose(t, j, rtol=0, atol=EXACT)
    else:
        cj, ct = _row_codes(p, kind, bits)
        flips = cj != ct
        assert flips.mean() <= NM_FLIP_RATE, flips.mean()
        clean = ~flips.any(axis=1)
        np.testing.assert_array_equal(t[clean], j[clean])
    # a constant vector is the scalar path at that group, exactly
    const = vec(*targs, torch.full((M,), G - 1, dtype=torch.int32), **kw_t)
    assert torch.equal(const, scalar(*targs, G - 1, **kw_t))


@pytest.mark.parametrize("bits,packed_kv", [(8, False), (6, False),
                                            (4, True)])
@pytest.mark.parametrize("G", [1, 3])
def test_vec_plain_flash_matches_jax_vec_ref(bits, packed_kv, G):
    S, D = (100, 72) if G == 1 else (200, 16)
    r = np.random.default_rng(100 * bits + 10 * G + S)
    BH, half = 6, 2 ** (bits - 1)
    q, k, v = (r.standard_normal((BH, S, D)).astype(np.float32) * 1.5
               for _ in range(3))
    rate = (1 + 0.1 * r.random((G, 1))).astype(np.float32)
    s_q = rate * np.float32(6.0 / (half - 1))
    s1 = np.clip(rate * np.float32(8.0 / S / half), 1 / (half * half * 8),
                 1 / half).astype(np.float32)
    s_v = rate * np.float32(4.0 / (half - 1))
    qk = {"s_q": s_q, "s_k": s_q * np.float32(1.05)}
    qk["scale"] = qk["s_q"] * qk["s_k"]
    pv = {"s1": s1, "s_v": s_v, "scale1": s1 * s_v,
          "scale2": np.float32(1.0 / half) * s_v}
    scale = D ** -0.5
    g_qk = r.integers(0, G, BH).astype(np.int32)
    g_pv = r.integers(0, G, BH).astype(np.int32)
    j = np.asarray(jref.flash_attn_mrq_vec_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        {a: jnp.asarray(b) for a, b in qk.items()},
        {a: jnp.asarray(b) for a, b in pv.items()}, scale=scale,
        g_qk=jnp.asarray(g_qk), g_pv=jnp.asarray(g_pv), bits=bits))
    args = (_t(q), _t(k), _t(v), _t(qk["s_q"]), _t(qk["s_k"]),
            _t(qk["scale"]) * float(np.float32(scale)), _t(s1), _t(s_v),
            _t(pv["scale1"]), _t(pv["scale2"]))
    t = FA.flash_attn_mrq_vec(*args, _t(g_qk), _t(g_pv), bits=bits,
                              packed_kv=packed_kv)
    rate_, max_err = tref.flash_flip_stats(t, torch.from_numpy(j))
    assert rate_ <= tref.TOLERANCES["B3_flipped_row_rate"][0], rate_
    step = float(s_v.max()) * (half - 1) / half
    assert max_err <= tref.TOLERANCES["B3_atol_steps"][0] * step
    const = FA.flash_attn_mrq_vec(
        *args, torch.full((BH,), G - 1, dtype=torch.int32),
        torch.zeros(BH, dtype=torch.int32), bits=bits, packed_kv=packed_kv)
    assert torch.equal(const, FA.flash_attn_mrq(
        *args, G - 1, 0, bits=bits, packed_kv=packed_kv))


@pytest.mark.parametrize("kind", ["int8", "int8_mrq", "int4", "int4_mrq",
                                  "flash"])
def test_vec_plain_clamps_out_of_range_groups(kind):
    """An entry of the group vector outside [0, G) reads the nearest group,
    as the kernels clamp each index they read: the output equals the
    clamped vector's."""
    G = 3
    if kind == "flash":
        r = np.random.default_rng(4)
        q, k, v = (_t(r.standard_normal((4, 30, 16)).astype(np.float32))
                   for _ in range(3))
        s = _t((0.05 * (1 + 0.1 * r.random((G, 1)))).astype(np.float32))
        args = (q, k, v, s, s, s * s * 0.25, s * 0.01, s, s * s * 0.01,
                s / 128)
        wild = torch.tensor([-4, 0, 2, 50], dtype=torch.int32)
        out = FA.flash_attn_mrq_vec(*args, wild, wild.flip(0))
        tame = wild.clamp(0, G - 1)
        assert torch.equal(out, FA.flash_attn_mrq_vec(*args, tame,
                                                       tame.flip(0)))
        return
    p = _linear_inputs(11, kind, G, "gr", 4 if kind.startswith("int4")
                       else 8)
    _, vec, _ = _FNS[kind]
    _, kw_t = _kwargs(p, kind, 4 if kind.startswith("int4") else 8)
    targs = (_t(p["x"]), _t(p["w"])) + tuple(map(_t, p["params"])) \
        + (_t(p["bias"]),)
    wild = torch.tensor([-7, 5, 1, 2 ** 30] * (M // 4), dtype=torch.int32)
    assert torch.equal(vec(*targs, wild, **kw_t),
                       vec(*targs, wild.clamp(0, G - 1), **kw_t))


def test_resolve_group_clamps_vectors_on_their_device():
    from repro_torch.quant.groups import resolve_group
    g = torch.tensor([-2, 0, 3, 9])
    out = resolve_group(g, 4)
    assert out.dtype == torch.int32 and out.tolist() == [0, 0, 3, 3]
    assert resolve_group(g, 1) == 0 and resolve_group(None, 4) == 0
    assert resolve_group(7, 4) == 3


# ---------------------------------------------------------------------------
# the chunked slot sampler against JAX's
# ---------------------------------------------------------------------------
class _GroupLog:
    """A context that records every tgroup handed to ``with_tgroup`` (on
    the JAX side from inside the traced scan, through a debug callback)."""

    def __init__(self, traced=False):
        self.seen, self.traced = [], traced

    def with_tgroup(self, g):
        if self.traced:
            jax.debug.callback(lambda v: self.seen.append(np.asarray(v)), g,
                               ordered=True)
        else:
            self.seen.append(g.numpy().copy())
        return self


def test_chunk_slots_matches_jax():
    dif = (JDiffusionCfg(T=40, tgq_groups=4),
           ddpm.DiffusionCfg(T=40, tgq_groups=4))
    buckets = (4, 6)
    r = np.random.default_rng(0)
    Bs = 4
    x = r.standard_normal((Bs, 4, 4, 2)).astype(np.float32)
    pos = np.array([0, 2, 5, 4], np.int32)           # slot 3 is done
    bk = np.array([0, 1, 1, 0], np.int32)
    y = np.array([1, 2, 3, 0], np.int32)
    seeds = np.array([7, 11, 2 ** 32 - 1, 5], np.uint32)
    gs = np.array([1.5, 1.0, 0.0, 2.0], np.float32)

    def eps_j(xx, t, yy, c):
        col = lambda a: a.astype(jnp.float32)[:, None, None, None]
        return 0.5 * xx + col(t) * np.float32(1e-3) + col(yy) * np.float32(
            1e-2)

    def eps_t(xx, t, yy, c):
        col = lambda a: a.to(torch.float32)[:, None, None, None]
        return 0.5 * xx + col(t) * float(np.float32(1e-3)) + col(yy) * float(
            np.float32(1e-2))

    jlog, tlog = _GroupLog(traced=True), _GroupLog()
    jsched = jddpm.make_slot_schedule(dif[0], jddpm.make_schedule(dif[0]),
                                      buckets)
    xj, pj, bj = jddpm.ddpm_chunk_slots(
        eps_j, dif[0], jsched, jnp.asarray(x), jnp.asarray(pos),
        jnp.asarray(bk), jnp.asarray(y), jnp.asarray(seeds), jnp.asarray(gs),
        null_label=8, chunk=3, ctx=jlog)
    jax.effects_barrier()
    tsched = ddpm.make_slot_schedule(dif[1], ddpm.make_schedule(dif[1]),
                                     buckets, device="cpu")
    xt, pt, bt = ddpm.ddpm_chunk_slots(
        eps_t, dif[1], tsched, _t(x), _t(pos).long(), _t(bk).long(),
        _t(y).long(), _t(seeds.astype(np.int64)), _t(gs), null_label=8,
        chunk=3, ctx=tlog, device="cpu")
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    assert len(tlog.seen) == len(jlog.seen) == 3
    for a, b in zip(tlog.seen, jlog.seen):
        np.testing.assert_array_equal(a, b)
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-5 * np.abs(xj).max()
    np.testing.assert_array_equal(xt.numpy()[3], x[3])    # done: untouched
    # ddpm_init_latent is the sync sampler's initial draw
    lat = ddpm.ddpm_init_latent(11, 6, (4, 4, 2), device="cpu").numpy()
    jlat = np.asarray(jddpm.ddpm_init_latent(11, 6, (4, 4, 2)))
    assert np.abs(lat - jlat).max() <= 1e-5 * np.abs(jlat).max()


# ---------------------------------------------------------------------------
# async engine: bit for bit against the sync engine, and against JAX
# ---------------------------------------------------------------------------
DIF = ddpm.DiffusionCfg(T=40, tgq_groups=4)
BUCKETS = (4, 6)
REQS = [GenRequest(request_id=i, label=y, steps=s, cfg_scale=c, seed=10 + i)
        for i, (y, s, c) in enumerate([(1, 4, 1.5), (2, 6, 1.0),
                                       (3, 4, 0.0), (4, 6, 2.0),
                                       (5, 4, 1.0)])]


@pytest.fixture(scope="module")
def tiny(tiny_dit):
    jcfg, jp = tiny_dit
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, DiTCfg(**dataclasses.asdict(jcfg)), tp


@pytest.fixture(scope="module")
def sync_ref(tiny):
    _, _, cfg, p = tiny
    return ServeEngine(p, cfg, DIF, microbatch=2, step_buckets=BUCKETS,
                       device="cpu").serve(REQS)


@pytest.fixture(scope="module")
def w8a8(tiny):
    _, _, cfg, p = tiny
    return quantize(p, cfg, DIF, QuantRecipe(bits="w8a8", method="range",
                                             n_per_group=1, calib_batch=1))


@pytest.fixture(scope="module")
def w8a8_ref(tiny, w8a8):
    _, _, _, p = tiny
    return ServeEngine.from_artifact(p, w8a8, microbatch=2,
                                     step_buckets=BUCKETS,
                                     device="cpu").serve(REQS)


def _engine(tiny, art=None, **kw):
    _, _, cfg, p = tiny
    kw = dict(dict(microbatch=2, step_buckets=BUCKETS, device="cpu"), **kw)
    if art is not None:
        return AsyncServeEngine.from_artifact(p, art, **kw)
    return AsyncServeEngine(p, cfg, DIF, **kw)


def _assert_equal_samples(out, ref, rids=None):
    for rid in (rids if rids is not None else out):
        assert out[rid].status == "OK", (rid, out[rid].error)
        assert np.array_equal(out[rid].sample, ref[rid].sample), rid


@pytest.mark.parametrize("microbatch,chunk,pipeline", [(2, 2, 2), (3, 5, 1)])
def test_async_matches_sync_fp_mixed_buckets(tiny, sync_ref, microbatch,
                                             chunk, pipeline):
    """Buckets 4 and 6 share the pool, every slot at its own timestep;
    chunk 5 is longer than the shortest chain."""
    eng = _engine(tiny, microbatch=microbatch, chunk=chunk,
                  pipeline=pipeline)
    out = eng.serve(REQS)
    _assert_equal_samples(out, sync_ref)
    assert eng.stats["chunk_traces"] == 1
    assert eng.stats["dispatches"] > 1
    assert eng.stats["admitted"] == len(REQS)


@pytest.mark.parametrize("chunk", [2, 3])
def test_async_matches_sync_w8a8_kernel_ctx(tiny, w8a8, w8a8_ref, chunk,
                                            monkeypatch):
    """Through the kernel context's wrappers (plain versions on the CPU):
    every packed linear and attention block of the async forward takes
    the ``_vec`` wrapper with the slots' group vector, and each forward
    builds its per-row group vectors once per row count (token rows,
    conditioning rows, batch·head rows), not once per op."""
    seen = {"rows": 0}
    real_rows = ops._rows_vec

    def rows_spy(g, n):
        seen["rows"] += 1
        return real_rows(g, n)
    monkeypatch.setattr(ops, "_rows_vec", rows_spy)
    for name in ("int8_matmul_fq_vec", "int8_matmul_mrq_fq_vec",
                 "flash_attn_mrq_vec"):
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen[_name] = seen.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    eng = _engine(tiny, w8a8, chunk=chunk)
    assert eng.ctx.kernel
    out = eng.serve(REQS)
    _assert_equal_samples(out, w8a8_ref)
    counts = w8a8.packed_counts()
    f = eng.stats["forwards"]
    assert seen == {"rows": 3 * f,
                    "int8_matmul_fq_vec": counts["int8_matmul_fq"] * f,
                    "int8_matmul_mrq_fq_vec":
                        counts["int8_matmul_mrq_fq"] * f,
                    "flash_attn_mrq_vec": counts["flash_attn_mrq"] * f}
    assert eng.stats["chunk_traces"] == 1 and not eng.stats["degradations"]


def test_async_fp_matches_jax_async(tiny):
    jcfg, jp, tcfg, tp = tiny
    jeng = JAsyncServeEngine(jp, jcfg, JDiffusionCfg(T=40, tgq_groups=4),
                             microbatch=2, step_buckets=BUCKETS, chunk=2)
    jout = jeng.serve([JGenRequest(request_id=r.request_id, label=r.label,
                                   steps=r.steps, cfg_scale=r.cfg_scale,
                                   seed=r.seed) for r in REQS])
    out = _engine(tiny, chunk=2).serve(REQS)
    for rid, o in out.items():
        j = jout[rid].sample
        assert o.status == jout[rid].status == "OK"
        assert o.sample.shape == j.shape == (8, 8, 4)
        assert np.abs(o.sample - j).max() <= 1e-4 * np.abs(j).max(), rid


# ---------------------------------------------------------------------------
# lifecycle: admission, cancel, deadlines, metrics
# ---------------------------------------------------------------------------
def test_bad_label_and_queue_full_rejected_structured(tiny):
    _, _, cfg, _ = tiny
    eng = _engine(tiny)
    rid = eng.submit(label=cfg.n_classes + 3, steps=4)
    o = eng.outcomes[rid]
    assert o.status == "REJECTED" and o.error.code == "bad_label"
    assert f"request {rid}" in o.error.message
    eng = _engine(tiny, max_queue=2)
    rids = [eng.submit(label=1, steps=4) for _ in range(4)]
    rejected = [r for r in rids if r in eng.outcomes]
    assert len(rejected) == 2
    assert all(eng.outcomes[r].error.code == "queue_full" for r in rejected)
    out = eng.run_until_drained()
    assert sum(o.status == "OK" for o in out.values()) == 2
    assert len(out) == 4 and eng.stats["rejected"] == 2
    with pytest.raises(ValueError, match="duplicate request id"):
        eng.submit_request(GenRequest(request_id=rids[0], label=1))


def test_requested_steps_rounding_warns_once_and_metrics(tiny):
    eng = _engine(tiny)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        rid = eng.submit(label=1, steps=5)           # rounds 5 -> 6
        eng.submit(label=2, steps=5)
        eng.submit(label=3, steps=4)
    assert len(w) == 1 and "rounded" in str(w[0].message)
    out = eng.run_until_drained()
    assert out[rid].steps == 6 and out[rid].requested_steps == 5
    m = eng.metrics()
    assert m["requests"] == 3 and m["by_status"] == {"OK": 3}
    assert m["latency_p99_s"] >= m["latency_p50_s"] > 0


def test_cancel_queued_and_running(tiny):
    eng = _engine(tiny, microbatch=1, chunk=2)
    r0 = eng.submit(label=1, steps=6, seed=1)
    r1 = eng.submit(label=2, steps=6, seed=2)      # waits behind r0
    assert eng.pump()
    assert eng.cancel(r0) and eng.cancel(r1)
    out = eng.run_until_drained()
    assert out[r0].status == "CANCELLED" and out[r0].error.code == "cancelled"
    assert out[r1].status == "CANCELLED"
    assert eng.cancel(r0) is False


@pytest.mark.parametrize("pipeline", [1, 2])
def test_deadline_overrun_cancels_at_chunk_boundary(tiny, sync_ref,
                                                    pipeline):
    clk = FakeClock()
    inj = FaultInjector([Fault(kind="stall", at_dispatch=2, seconds=100.0)],
                        clock=clk)
    eng = _engine(tiny, chunk=2, deadline_s=10.0, clock=clk, injector=inj,
                  pipeline=pipeline)
    out = eng.serve(REQS[:3])
    cancelled = [o for o in out.values() if o.status == "CANCELLED"]
    assert cancelled and all(o.error.code == "deadline" for o in cancelled)
    # request 0 (4 steps, chunk 2) finished BY the stalled boundary
    _assert_equal_samples(out, sync_ref, rids=[0])


def test_pipeline_dispatches_ahead_only_past_quiet_boundaries(tiny,
                                                              sync_ref,
                                                              monkeypatch):
    """pipeline=2 enqueues the next chunk before reading this one's
    positions, but not past a boundary where a chain ends (that chunk
    would be discarded): one 6-step request, chunk 2 -> 3 chunks, two of
    them dispatched ahead, no forward wasted."""
    eng = _engine(tiny, microbatch=1, chunk=2, pipeline=2)
    launched = []
    real = eng._launch_chunk
    monkeypatch.setattr(eng, "_launch_chunk",
                        lambda x, pos: launched.append(1) or real(x, pos))
    out = eng.serve([REQS[1]])
    _assert_equal_samples(out, sync_ref)
    assert len(launched) == eng.stats["dispatches"] == 3
    assert eng.stats["ahead"] == 2 and eng.stats["forwards"] == 6


def test_deadline_expired_in_queue_never_admitted(tiny):
    clk = FakeClock()
    eng = _engine(tiny, microbatch=1, clock=clk)
    rid = eng.submit(label=1, steps=4, deadline_s=5.0)
    clk.advance(50.0)
    out = eng.run_until_drained()
    assert out[rid].status == "CANCELLED" and out[rid].error.code == \
        "deadline"
    assert eng.stats["admitted"] == 0


# ---------------------------------------------------------------------------
# chaos: NaN quarantine, sticky poison, the degradation ladder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pipeline", [1, 2])
def test_nan_burst_retry_is_bit_identical_fp(tiny, sync_ref, pipeline):
    inj = FaultInjector([Fault(kind="nan", request_id=1, at_step=2)])
    eng = _engine(tiny, chunk=2, max_retries=2, injector=inj,
                  pipeline=pipeline)
    out = eng.serve(REQS[:3])
    _assert_equal_samples(out, sync_ref)
    assert out[1].retries == 1 and out[0].retries == 0
    assert len(inj.fired) == 1 and eng.stats["retries"] == 1


def test_nan_burst_retry_is_bit_identical_w8a8(tiny, w8a8, w8a8_ref):
    inj = FaultInjector([Fault(kind="nan", request_id=2, at_step=1)])
    eng = _engine(tiny, w8a8, chunk=3, injector=inj)
    out = eng.serve(REQS[:3])
    _assert_equal_samples(out, w8a8_ref)
    assert out[2].retries == 1


def test_sticky_poison_and_slot_error_fail_structured(tiny, sync_ref):
    inj = FaultInjector([Fault(kind="nan", request_id=0, at_step=1,
                               sticky=True)])
    eng = _engine(tiny, chunk=2, max_retries=2, injector=inj)
    out = eng.serve(REQS[:3])
    o = out[0]
    assert o.status == "FAILED" and o.sample is None
    assert o.error.code == "nan_poisoned" and o.error.retries == 2
    assert "request 0" in o.error.message
    _assert_equal_samples(out, sync_ref, rids=[1, 2])
    inj = FaultInjector([Fault(kind="slot_error", request_id=0, at_step=0,
                               sticky=True)])
    eng = _engine(tiny, chunk=2, max_retries=1, injector=inj)
    out = eng.serve(REQS[:2])
    assert out[0].status == "FAILED" and out[0].error.code == "slot_error"
    assert out[1].status == "OK"


@pytest.mark.parametrize("pipeline", [1, 2])
def test_degradation_ladder_logs_every_rung(tiny, w8a8, pipeline):
    """Two injected dispatch faults, on the first chunk and on its retry,
    take both rungs before any chunk completes: flash -> composed ->
    fake-quant. Both rungs are logged; every request completes on the
    bottom rung, equal to the fake-quant sync engine."""
    _, _, _, p = tiny
    ref = ServeEngine.from_artifact(p, w8a8, kernel=False, microbatch=2,
                                    step_buckets=BUCKETS,
                                    device="cpu").serve(REQS[:3])
    inj = FaultInjector([Fault(kind="dispatch_error", at_dispatch=1),
                         Fault(kind="dispatch_error", at_dispatch=2)])
    eng = _engine(tiny, w8a8, chunk=2, injector=inj, pipeline=pipeline)
    assert eng.ctx.kernel and eng.ctx.attn_impl == "flash"
    out = eng.serve(REQS[:3])
    _assert_equal_samples(out, ref)
    deg = eng.stats["degradations"]
    assert [d["reason"] for d in deg] == [
        "flash attention -> composed three-kernel chain",
        "fused int8 kernels -> fake-quant (simulated quantization)"]
    assert all("FaultInjected" in d["error"] for d in deg)
    assert [d for d, _ in inj.fired] == [1, 2]
    assert eng.ctx.kernel is False and eng.stats["chunk_traces"] == 3


@pytest.mark.parametrize("pipeline", [1, 2])
def test_degradation_ladder_stops_on_the_composed_rung(tiny, w8a8, pipeline,
                                                       monkeypatch):
    """One injected dispatch fault steps flash -> composed, and the
    engine stays there: every request completes OK through the per-slot
    composed chain, equal to the sync engine on the composed context."""
    _, _, _, p = tiny
    ref = ServeEngine.from_artifact(p, w8a8, attn_impl="composed",
                                    microbatch=2, step_buckets=BUCKETS,
                                    device="cpu").serve(REQS[:3])
    calls = []
    real = ops.int8_bmm_qk_vec
    monkeypatch.setattr(ops, "int8_bmm_qk_vec",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    inj = FaultInjector([Fault(kind="dispatch_error", at_dispatch=1)])
    eng = _engine(tiny, w8a8, chunk=2, injector=inj, pipeline=pipeline)
    out = eng.serve(REQS[:3])
    _assert_equal_samples(out, ref)
    deg = eng.stats["degradations"]
    assert [d["reason"] for d in deg] == [
        "flash attention -> composed three-kernel chain"]
    assert eng.ctx.kernel and eng.ctx.attn_impl == "composed"
    assert calls and eng.stats["chunk_traces"] == 2


def test_kernel_error_takes_no_rung(tiny, w8a8, monkeypatch):
    """A kernel that does not build or launch raises ``KernelError``; the
    engine fails every live request and re-raises it instead of stepping
    down to a context that computes without the kernel."""
    from repro_torch.kernels.build import KernelError

    def broken(*a, **kw):
        raise KernelError("int8_matmul_fq_vec: CUDA error 98 at launch")
    monkeypatch.setattr(ops, "int8_matmul_fq_vec", broken)
    eng = _engine(tiny, w8a8, chunk=2)
    for r in REQS[:3]:
        eng.submit_request(r)
    with pytest.raises(KernelError, match="CUDA error 98"):
        eng.run_until_drained()
    assert eng.stats["degradations"] == [] and eng.ctx.kernel
    assert eng.ctx.attn_impl == "flash" and eng.stats["chunk_traces"] == 1
    assert len(eng.outcomes) == 3
    assert all(o.status == "FAILED" and o.error.code == "engine_fault"
               and "KernelError" in o.error.message
               for o in eng.outcomes.values())


def test_missing_nvcc_is_a_kernel_error(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(build.KernelError, match="nvcc not found"):
        build.build_all(("int8_fused",))


def test_serve_launcher_exits_nonzero_on_a_degradation(monkeypatch, capsys):
    """``launch/serve.py --async`` serves clean with no rung taken, and
    exits non-zero, naming each rung, when its dispatches degraded."""
    from repro_torch.launch import serve
    argv = ["--arch", "dit-xl-2", "--smoke", "--quantize", "w8a8",
            "--device", "cpu", "--steps", "4", "--requests", "2",
            "--async", "--chunk", "2"]
    serve.main(argv)
    assert "0 degradations" in capsys.readouterr().out

    def broken(*a, **kw):
        raise RuntimeError("attention dispatch fault")
    monkeypatch.setattr(ops, "flash_attn_mrq_vec", broken)
    monkeypatch.setattr(ops, "int8_bmm_qk_vec", broken)
    with pytest.raises(SystemExit, match="2 degradation") as e:
        serve.main(argv)
    assert e.value.code != 0 and "attention dispatch fault" in str(
        e.value.code)
    assert "composed three-kernel chain" in str(e.value.code)


def test_ladder_exhausted_fails_everything_structured(tiny):
    inj = FaultInjector([Fault(kind="dispatch_error", at_dispatch=1)])
    eng = _engine(tiny, chunk=2, injector=inj)
    for r in REQS[:3]:
        eng.submit_request(r)
    with pytest.raises(EngineFault, match="no degradation rung"):
        eng.run_until_drained()
    assert len(eng.outcomes) == 3
    assert all(o.status == "FAILED" and o.error.code == "engine_fault"
               for o in eng.outcomes.values())
