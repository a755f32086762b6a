"""The port's 4-bit path held against the JAX package: the nibble helpers,
the packed-int4 linears' plain versions (B4, B5), the packed-kv flash
plain version (B3b), W4A4 and W6A6 artifacts written by JAX and served by
the port, and the weight-layout cache's lifetime.

Inputs are made from a seed with numpy and handed to both packages. The
port runs its plain versions on CPU tensors; the JAX side runs the jnp
oracles of ``repro.kernels.ref`` (its kernel context gets them patched in
for the Pallas kernels, which the conformance suite holds to the same
oracles). Tolerances (``repro_torch.kernels.ref.TOLERANCES``):

- nibble helpers: bit-equal;
- B4/B5 without ``norm_mod``: bit-exact (``B4_B5_plain_vs_jax``); with
  it, at most 1e-3 of the codes flip and every row whose codes agree is
  bit-exact (the layernorm statistics differ by ulps);
- B3b: equal to the port's unpacked 4-bit flash, and within B3's
  registry of the JAX oracle;
- forwards and served samples against JAX's kernel context: relative L2
  within ``dit_forward_plain_vs_jax_rel``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ptq as jptq
from repro.core.contexts import RecordingContext as JRecordingContext
from repro.diffusion import DiffusionCfg as JDiffusionCfg
from repro.kernels import int4_packed as jint4
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.dit import dit_apply as jdit_apply
from repro.quant import QuantRecipe as JQuantRecipe, quantize as jquantize
from repro.serving import GenRequest as JGenRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import quickcal as jquickcal
from repro_torch.diffusion.ddpm import DiffusionCfg
from repro_torch.kernels import int4_packed as F4
from repro_torch.kernels import int8_fused as F8
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models.dit import DiTCfg, dit_apply, params_from_numpy
from repro_torch.quant.artifact import QuantArtifact
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ServeEngine

FA = importlib.import_module("repro_torch.kernels.flash_attn_mrq")

EXACT = tref.TOLERANCES["B4_B5_plain_vs_jax"][0]
NM_FLIP_RATE = tref.TOLERANCES["B1_B2_norm_mod_plain_vs_jax_flip_rate"][0]
REL = tref.TOLERANCES["dit_forward_plain_vs_jax_rel"][0]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# nibble helpers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,axis", [((7, 5), 0), ((4, 9), 1),
                                        ((3, 6, 10), -1), ((1, 3), 0)])
def test_pack_helpers_bit_equal_jax(shape, axis):
    c = np.random.default_rng(sum(shape)).integers(-8, 8, shape
                                                   ).astype(np.int8)
    pj = np.asarray(jint4.pack_int4(jnp.asarray(c), axis=axis))
    pt = tref.pack_int4(_t(c), axis=axis).numpy()
    assert pj.dtype == pt.dtype == np.int8
    np.testing.assert_array_equal(pt, pj)
    for a, b in zip(jint4.nibble_split(jnp.asarray(pj)),
                    tref.nibble_split(_t(pj))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    k = shape[axis]
    uj = np.asarray(jint4.unpack_int4(jnp.asarray(pj), k=k, axis=axis))
    ut = tref.unpack_int4(_t(pj), k=k, axis=axis).numpy()
    np.testing.assert_array_equal(ut, uj)
    np.testing.assert_array_equal(ut, c)


# ---------------------------------------------------------------------------
# B4 / B5 plain versions against the jnp oracles
# ---------------------------------------------------------------------------
M, N, B = 36, 45, 4
SHAPES = {16: 16, 40: 70, 256: 300}      # group_k -> K (ragged, nk >= 1)


def _int4_inputs(seed, G, mrq, fusion, group_k):
    r = np.random.default_rng(seed)
    K = SHAPES[group_k]
    nk = -(-K // group_k)
    x = r.standard_normal((M, K)).astype(np.float32)
    if mrq:
        x = np.where(x < 0, 0.1 * x, 2 * x).astype(np.float32)
    codes = r.integers(-7, 8, (nk * group_k, N)).astype(np.int8)
    codes[K:] = 0
    p = {"x": x, "wp": np.asarray(jint4.pack_int4(jnp.asarray(codes))),
         "bias": r.standard_normal(N).astype(np.float32) * 0.1,
         "bv": np.repeat(np.arange(B, dtype=np.int32), M // B)}
    rate = (1 + 0.1 * r.random((G, 1))).astype(np.float32)
    sw = (r.random((1, nk, N)) * 1e-2 + 1e-3).astype(np.float32)
    if mrq:
        p["s_a"] = rate * np.float32(0.3 / 8)
        p["s_b"] = rate * np.float32(6.0 / 8)
        p["scale_a"] = p["s_a"][:, :, None] * sw
        p["scale_b"] = p["s_b"][:, :, None] * sw
    else:
        p["s_a"] = rate * np.float32(8.0 / 15)
        p["s_b"] = np.round(np.float32(4.0) / p["s_a"]).astype(np.float32)
        p["scale_a"] = p["s_a"][:, :, None] * sw
        colsum = codes.astype(np.int32).reshape(nk, group_k, N).sum(1)
        p["corr"] = ((p["s_b"].astype(np.int32) - 8)[:, :, None]
                     * colsum[None]).astype(np.int32)
    if "nm" in fusion:
        p["nm"] = tuple(r.standard_normal((B, K)).astype(np.float32) * 0.2
                        for _ in range(2))
    if "gr" in fusion:
        p["gr"] = (r.standard_normal((B, N)).astype(np.float32),
                   r.standard_normal((M, N)).astype(np.float32))
    if "ps" in fusion:
        p["ps"] = (0.5 + r.random(K)).astype(np.float32)
    return p


def _int4_both(p, g, mrq, group_k):
    kw_j = {"g": g, "bias": jnp.asarray(p["bias"]), "group_k": group_k}
    kw_t = {"group_k": group_k}
    for key in ("nm", "gr"):
        if key in p:
            kw_j[key] = tuple(jnp.asarray(a) for a in p[key])
            kw_t[key] = tuple(_t(a) for a in p[key])
    if "ps" in p:
        kw_j["ps"], kw_t["ps"] = jnp.asarray(p["ps"]), _t(p["ps"])
    if "nm" in p or "gr" in p:
        kw_j["bv"], kw_t["bv"] = jnp.asarray(p["bv"]), _t(p["bv"])
    second = p["scale_b"] if mrq else p["corr"]
    jfn = (jref.int4_matmul_mrq_fq_fused_ref if mrq
           else jref.int4_matmul_fq_fused_ref)
    tfn = F4.int4_matmul_mrq_fq if mrq else F4.int4_matmul_fq
    j = jfn(jnp.asarray(p["x"]), jnp.asarray(p["wp"]), p["s_a"], p["s_b"],
            p["scale_a"], second, **kw_j)
    t = tfn(_t(p["x"]), _t(p["wp"]), _t(p["s_a"]), _t(p["s_b"]),
            _t(p["scale_a"]), _t(second), _t(p["bias"]), g, **kw_t)
    return np.asarray(j), t.numpy()


def _codes_both(p, g):
    """The 4-bit activation codes each package quantizes to (after the
    norm-modulate prologue; only the affine family takes ``norm_mod``)."""
    nm_j = tuple(jnp.asarray(a) for a in p["nm"])
    xj = jref.fused_prologue_ref(jnp.asarray(p["x"]), nm=nm_j,
                                 bv=jnp.asarray(p["bv"]))
    xt = tref.fused_prologue_ref(_t(p["x"]), nm=tuple(map(_t, p["nm"])),
                                 bv=_t(p["bv"]).long())
    cj = np.asarray(jref.quantize_int8_ref(xj, p["s_a"][g, 0],
                                           p["s_b"][g, 0], 4))
    ct = tref.quantize_int8_ref(xt, _t(p["s_a"])[g, 0], _t(p["s_b"])[g, 0],
                                4).numpy()
    return cj, ct


INT4_CASES = [(mrq, fusion, G, group_k)
              for mrq, fusions in ((False, ("", "nm", "gr_ps")),
                                   (True, ("", "gr_ps")))
              for fusion in fusions for G in (1, 3)
              for group_k in (16, 40, 256)]


@pytest.mark.parametrize("mrq,fusion,G,group_k", INT4_CASES)
def test_plain_int4_linear_matches_jax_ref(mrq, fusion, G, group_k):
    p = _int4_inputs(group_k + 7 * G + 31 * len(fusion) + mrq, G, mrq,
                     fusion, group_k)
    g = G - 1
    j, t = _int4_both(p, g, mrq, group_k)
    assert j.dtype == t.dtype == np.float32 and j.shape == t.shape == (M, N)
    if "nm" not in fusion:
        np.testing.assert_allclose(t, j, rtol=0, atol=EXACT)
        return
    cj, ct = _codes_both(p, g)
    flips = cj != ct
    assert flips.mean() <= NM_FLIP_RATE, flips.mean()
    clean_rows = ~flips.any(axis=1)
    np.testing.assert_array_equal(t[clean_rows], j[clean_rows])


def test_int4_weight_layout_regroups_packed_bytes():
    """The kernel's weight copy: 8192-byte blocks per (128 channels, k tile
    of 128), each K group's bytes zero-padded to the 128-deep tile, channels
    past N zero — the pack's bytes, regrouped: channel 64 c + 16 w + 8 h + q
    and thread t of its quad own 16 bytes at ((4 c + w) * 2 + h) * 512 +
    (4 q + t) * 16, whose word s holds k codes 128 kt + 32 s + 4t..4t+3 and
    + 16+4t..19+4t (tests/test_torch_int4_layout.py replays the widening)."""
    group_k, nk, n_cols = 40, 3, 5
    codes = torch.randint(-8, 8, (nk * group_k, n_cols), dtype=torch.int8)
    wp = tref.pack_int4(codes)
    wt = F4._weight_layout(wp, group_k)
    assert wt.shape == (nk * 8192,) and wt.is_contiguous()
    blocks = wt.reshape(nk, 2, 4, 2, 8, 4, 4, 4)  # kt, c, w, h, q, t, s, byte
    for ch in range(128):
        c, w, h, q = ch // 64, (ch // 16) % 4, (ch // 8) % 2, ch % 8
        for kg in range(nk):                       # one k tile per group
            for t in range(4):
                word = tref.unpack_int4(blocks[kg, c, w, h, q, t].reshape(
                    16, 1))[:, 0]                  # 32 codes: s, byte, nibble
                for s_ in range(4):
                    got = word[8 * s_:8 * s_ + 8]
                    ks = ([32 * s_ + 4 * t + i for i in range(4)]
                          + [32 * s_ + 16 + 4 * t + i for i in range(4)])
                    want = torch.tensor([
                        int(codes[kg * group_k + k, ch])
                        if k < group_k and ch < n_cols else 0 for k in ks],
                        dtype=torch.int8)
                    assert torch.equal(got, want), (ch, kg, t, s_)
    assert F4._weight_layout(wp, group_k) is wt         # built once


def test_weight_layout_cache_frees_dropped_weight():
    """A weight's kernel-layout copies live as long as the weight and no
    longer: the table keeps no strong reference to either."""
    wq = torch.randint(-127, 128, (70, 9), dtype=torch.int8)
    wt = F8._transposed(wq, 128)
    assert wt.shape == (9, 128) and torch.equal(wt[:, :70], wq.t())
    assert F8._transposed(wq, 128) is wt
    wp = torch.randint(-128, 128, (20, 9), dtype=torch.int8)
    F4._weight_layout(wp, 40)
    refs = [weakref.ref(t) for t in (wq, wt, wp)]
    keys = [id(wq), id(wp)]
    del wq, wt, wp
    gc.collect()
    assert all(r() is None for r in refs)
    assert not any(k in F8._LAYOUTS for k in keys)


@pytest.mark.parametrize("G,S,D", [(1, 100, 72), (3, 200, 16)])
def test_plain_flash_packed_kv_matches_jax_ref(G, S, D):
    r = np.random.default_rng(10 * G + S)
    BH, half = 6, 8
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
        g_qk=g_qk, g_pv=g_pv, bits=4))
    args = (_t(q), _t(k), _t(v), _t(s_q), _t(s_k),
            _t(qk_pack["scale"]) * torch.tensor(scale, dtype=torch.float32),
            _t(s1), _t(s_v), _t(pv_pack["scale1"]), _t(pv_pack["scale2"]),
            g_qk, g_pv)
    t = FA.flash_attn_mrq(*args, bits=4, packed_kv=True)
    assert torch.equal(t, FA.flash_attn_mrq(*args, bits=4))
    rate, max_err = tref.flash_flip_stats(t, torch.from_numpy(j))
    assert rate <= tref.TOLERANCES["B3_flipped_row_rate"][0], rate
    step = float(s_v[g_pv, 0]) * (half - 1) / half
    assert max_err <= tref.TOLERANCES["B3_atol_steps"][0] * step
    with pytest.raises(ValueError, match="4-bit"):
        FA.flash_attn_mrq(*args, bits=8, packed_kv=True)


# ---------------------------------------------------------------------------
# JAX-written W4A4 / W6A6 artifacts served by the port
# ---------------------------------------------------------------------------
def _jax_oracles(monkeypatch):
    """Route the JAX kernel context's Pallas calls to their jnp oracles."""
    def fq4(x, wp, sx, zx, scale, corr, bias=None, g=None, *, group_k,
            out_dtype, interpret=False, **fkw):
        return jref.int4_matmul_fq_fused_ref(
            x, wp, sx, zx, scale, corr, bias=bias, g=g, group_k=group_k,
            out_dtype=out_dtype, **fkw)

    def mrq4(x, wp, s_neg, s_pos, scale_neg, scale_pos, bias=None, g=None,
             *, group_k, out_dtype, interpret=False, **fkw):
        return jref.int4_matmul_mrq_fq_fused_ref(
            x, wp, s_neg, s_pos, scale_neg, scale_pos, bias=bias, g=g,
            group_k=group_k, out_dtype=out_dtype, **fkw)

    def fq8(x, wq, sx, zx, scale, corr, bias=None, g=None, *, bits,
            out_dtype, interpret=False, **fkw):
        return jref.int8_matmul_fq_fused_ref(
            x, wq, sx, zx, scale, corr, bias=bias, g=g, bits=bits,
            out_dtype=out_dtype, **fkw)

    def mrq8(x, wq, s_neg, s_pos, scale_neg, scale_pos, bias=None, g=None,
             *, bits, out_dtype, interpret=False, **fkw):
        return jref.int8_matmul_mrq_fq_fused_ref(
            x, wq, s_neg, s_pos, scale_neg, scale_pos, bias=bias, g=g,
            bits=bits, out_dtype=out_dtype, **fkw)

    def flash(q, k, v, s_q, s_k, qk_scale, s1, s_v, scale1, scale2,
              g_qk=None, g_pv=None, mask=None, *, bits, packed_kv,
              out_dtype, interpret=False):
        return jref.flash_attn_mrq_ref(
            q, k, v, {"s_q": s_q, "s_k": s_k, "scale": qk_scale},
            {"s1": s1, "s_v": s_v, "scale1": scale1, "scale2": scale2},
            mask=mask, g_qk=g_qk, g_pv=g_pv, bits=bits, out_dtype=out_dtype)

    for name, fn in (("int4_matmul_fq", fq4), ("int4_matmul_mrq_fq", mrq4),
                     ("int8_matmul_fq", fq8), ("int8_matmul_mrq_fq", mrq8),
                     ("flash_attn_mrq", flash)):
        monkeypatch.setattr(jops, name, fn)


class _PinnedRecordingContext(JRecordingContext):
    """The reference's recorder with its marked tensors kept alive, so a
    freed post-GELU tensor's ``id`` cannot pass its mark to a later
    linear's input (ROADMAP queue 3): the artifact's packs do not depend
    on allocation order."""

    pinned: list = []            # shared by the per-layer context copies

    def act(self, name, x, kind):
        self.pinned.append(x)
        return super().act(name, x, kind)


@pytest.fixture(scope="module", params=["w4a4", "w6a6"])
def low_bits(request, tiny_dit, tmp_path_factory):
    """(bits, jax cfg, jax params, port cfg, port params, jax artifact,
    port artifact) — the artifact saved by JAX, loaded by the port."""
    jcfg, jp = tiny_dit
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    dif = JDiffusionCfg(T=1000, tgq_groups=4)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jptq, jquickcal):
            mp.setattr(mod, "RecordingContext", _PinnedRecordingContext)
        jart = jquantize(jp, jcfg, dif, JQuantRecipe(
            bits=request.param, n_per_group=2, calib_batch=2))
    path = str(tmp_path_factory.mktemp("art") / request.param)
    jart.save(path)
    tart = QuantArtifact.load(path, device="cpu", params=tp)
    return (request.param, jcfg, jp, DiTCfg(**dataclasses.asdict(jcfg)), tp,
            jart, tart)


def _leaves_equal(j, t, where="qparams"):
    if isinstance(j, dict):
        assert isinstance(t, dict) and sorted(j) == sorted(t), where
        for k in j:
            _leaves_equal(j[k], t[k], f"{where}/{k}")
    elif dataclasses.is_dataclass(j):
        for f in dataclasses.fields(j):
            _leaves_equal(getattr(j, f.name), getattr(t, f.name),
                          f"{where}.{f.name}")
    elif isinstance(j, (jax.Array, np.ndarray)):
        a, b = np.asarray(j), t.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert j == t, where


def test_low_bit_artifact_loads_with_every_leaf_equal(low_bits):
    bits, *_, jart, tart = low_bits
    _leaves_equal(jart.qparams, tart.qparams)
    assert tart.fallback_ops() == jart.fallback_ops() == []
    fam = "int4" if bits == "w4a4" else "int8"
    flash = "flash_attn_mrq_packed_kv" if bits == "w4a4" else "flash_attn_mrq"
    want = {k: 0 for k in tart.packed_counts()}
    want.update({f"{fam}_matmul_fq": 13, f"{fam}_matmul_mrq_fq": 2,
                 flash: 2})
    assert tart.packed_counts() == want


def test_every_packed_op_reaches_a_kernel_wrapper(low_bits, monkeypatch):
    """Under ``context(kernel=True)`` each quantized matmul op that
    ``fallback_ops()`` does not list goes through a kernel wrapper of
    ``kernels.ops`` with its own pack — none is served by fake-quant."""
    _, jcfg, _, tcfg, tp, _, tart = low_bits
    reached = set()
    for name in [fn for _, fn, _ in ops.LINEAR_PACKS] + ["flash_attention"]:
        real = getattr(ops, name)

        def spy(x, *packs, _real=real, **kw):
            reached.update(id(p) for p in packs if isinstance(p, dict))
            return _real(x, *packs, **kw)
        monkeypatch.setattr(ops, name, spy)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, tcfg.img_size, tcfg.img_size, tcfg.in_ch)).astype(np.float32))
    with torch.no_grad():
        dit_apply(tp, tcfg, x, torch.tensor([10, 900]), torch.tensor([1, 2]),
                  ctx=tart.context(kernel=True))
    keys = [k for k, _, _ in ops.LINEAR_PACKS] + ["int8_qk", "int8_pv"]
    packed = {name for name, qp in tart.qparams.items()
              if any(id(qp.get(k)) in reached for k in keys)}
    quantized = {name for name, qp in tart.qparams.items()
                 if "w" in qp or name.endswith(("/qk", "/pv"))}
    assert quantized and packed == quantized - set(tart.fallback_ops())


def _inputs(cfg, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, cfg.img_size, cfg.img_size, cfg.in_ch)
                          ).astype(np.float32)
    return x, np.asarray([260, 990], np.int32), np.asarray([3, 7], np.int32)


@pytest.mark.parametrize("tgroup", [0, 3])
def test_low_bit_kernel_forward_matches_jax_kernel_ctx(low_bits, tgroup,
                                                       monkeypatch):
    _, jcfg, jp, tcfg, tp, jart, tart = low_bits
    _jax_oracles(monkeypatch)
    x, t, y = _inputs(jcfg, tgroup)
    j = np.asarray(jdit_apply(
        jp, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
        ctx=jart.context(kernel=True).with_tgroup(tgroup)))
    with torch.no_grad():
        o = dit_apply(tp, tcfg, _t(x), _t(t).long(), _t(y).long(),
                      ctx=tart.context(kernel=True).with_tgroup(tgroup)
                      ).numpy()
    assert o.shape == j.shape and np.isfinite(o).all()
    rel = np.linalg.norm(o - j) / np.linalg.norm(j)
    assert rel <= REL, rel


REQS = [(0, 3, 1.5, 11), (1, 5, 1.0, 12)]       # (id, label, cfg, seed)


def test_low_bit_served_samples_match_jax_kernel_ctx(low_bits, monkeypatch):
    _, jcfg, jp, tcfg, tp, jart, tart = low_bits
    _jax_oracles(monkeypatch)
    dif = JDiffusionCfg(T=1000, tgq_groups=4)
    jeng = JServeEngine(jp, jcfg, dif, ctx=jart.context(kernel=True),
                        microbatch=1, step_buckets=(4,))
    jres = jeng.serve([JGenRequest(request_id=i, label=y, steps=4,
                                   cfg_scale=c, seed=s)
                       for i, y, c, s in REQS])
    teng = ServeEngine(tp, tcfg, DiffusionCfg(T=1000, tgq_groups=4),
                       ctx=tart.context(kernel=True), microbatch=1,
                       step_buckets=(4,), device="cpu")
    tres = teng.serve([GenRequest(request_id=i, label=y, steps=4,
                                  cfg_scale=c, seed=s) for i, y, c, s in REQS])
    j = np.stack([jres[i].sample for i, *_ in REQS])
    t = np.stack([tres[i].sample for i, *_ in REQS])
    rel = np.linalg.norm(t - j) / np.linalg.norm(j)
    assert np.isfinite(t).all() and rel <= REL, rel


def jax_trained_drifts(widths=("w8a8", "w6a6", "w4a4")):
    """The JAX package's own figure for ``chip_smoke.py``'s phase 3: the
    trained 6-layer checkpoint range-calibrated per width (its own
    calibration draws), 8 requests x 50 steps served fp and through its
    kernel context (Pallas kernels replaced by their jnp oracles), drift
    ``mean|fp - q| / mean|fp|``. Run on the CPU with
    ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_int4.py``."""
    import pickle

    from repro.models import DiTCfg as JDiTCfg
    from repro.nn.ctx import FPContext as JFPContext

    cfg = JDiTCfg(img_size=16, in_ch=4, patch=2, d_model=160, n_layers=6,
                  n_heads=4, n_classes=8)
    dif = JDiffusionCfg(T=1000, tgq_groups=10)
    with open("experiments/dit_bench_450.pkl", "rb") as f:
        params = jax.tree.map(jnp.asarray, pickle.load(f))
    reqs = [JGenRequest(request_id=i, label=i % 8, steps=50, seed=100 + i)
            for i in range(8)]

    def serve(ctx):
        res = JServeEngine(params, cfg, dif, ctx=ctx, microbatch=4,
                           step_buckets=(50,)).serve(reqs)
        return np.stack([np.asarray(res[i].sample) for i in range(8)])

    fp = serve(JFPContext())
    with pytest.MonkeyPatch.context() as mp:
        _jax_oracles(mp)
        for bits in widths:
            art = jquantize(params, cfg, dif, JQuantRecipe(bits=bits))
            q = serve(art.context(kernel=True))
            print(f"JAX {bits} vs FP drift = "
                  f"{np.abs(fp - q).mean() / np.abs(fp).mean():.6f}")


if __name__ == "__main__":
    jax_trained_drifts()
