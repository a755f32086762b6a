"""The port's composed int8 attention (``attn_impl="composed"``: B9a
``int8_bmm_qk`` -> B10a ``softmax_mrq_codes`` -> B9b ``int8_bmm_pv``, and
the per-row-group B9c, B10b, B9d) held against the JAX package on the CPU.

Inputs are made from numpy seeds and handed to both packages; the port's
wrappers run their plain versions on CPU tensors, the JAX side its eager
jnp oracles (``repro.kernels.ref``), except for the one whole forward,
where JAX's kernel context runs its Pallas kernels in interpret mode.
Tolerances (``repro_torch.kernels.ref.TOLERANCES``):

- B9a/B9b and their ``_vec`` forms, and the code decode: bit-exact
  (``B9_plain_vs_jax``), GQA included (JAX's oracle on kv repeated);
- B10a/B10b: at most ``B10_code_flip_rate_vs_jax`` of the codes differ
  (XLA's row-sum order and exp), each by at most one coarse step of
  dequantised probability (``B10_flip_prob_steps``);
- ``ops.int8_attention`` against ``int8_attention_ref`` /
  ``int8_attention_vec_ref``: at most ``composed_flipped_row_rate`` of
  the output rows differ, by at most ``composed_atol_steps`` coarse
  steps; every other row is bit-exact;
- composed against the port's flash: within ``flash_vs_composed_atol``,
  the reference's own contract;
- the port's ``kernel=True, attn_impl="composed"`` forward against
  JAX's: relative L2 within ``dit_forward_plain_vs_jax_rel``;
- async composed against sync composed, and the launcher's sync and
  ``--async`` dumps: bit for bit.
"""
from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion import DiffusionCfg as JDiffusionCfg
from repro.kernels import ref as jref
from repro.models.dit import dit_apply as jdit_apply
from repro.quant import QuantRecipe as JQuantRecipe, quantize as jquantize
from repro_torch import kernels
from repro_torch.core.contexts import QuantContext
from repro_torch.diffusion import ddpm
from repro_torch.kernels import int8_bmm as IB
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models.dit import DiTCfg, dit_apply, params_from_numpy
from repro_torch.quant.api import quantize
from repro_torch.quant.artifact import QuantArtifact
from repro_torch.quant.recipe import QuantRecipe
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import AsyncServeEngine, ServeEngine

SM = importlib.import_module("repro_torch.kernels.softmax_mrq")
FA = importlib.import_module("repro_torch.kernels.flash_attn_mrq")

TOL = tref.TOLERANCES
# (B, Sq, Skv, hd, rep): ragged on every tile edge, 1-row q, GQA
SHAPES = [(3, 7, 13, 5, 1), (4, 77, 77, 24, 2), (2, 1, 5, 3, 1),
          (1, 130, 129, 17, 1)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _packs(r, G, bits, S):
    """(qk pack, pv pack) as numpy dicts, G groups, steps sized for
    scores of a few units and a softmax over S keys."""
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


def _codes_close(t, j, s1, g, bits):
    """B10 against the jnp oracle: the flip budget, and each flip within
    one coarse step of dequantised probability."""
    t, j = np.asarray(t), np.asarray(j)
    assert t.dtype == j.dtype == np.int8 and t.shape == j.shape
    flips = t != j
    assert flips.mean() <= TOL["B10_code_flip_rate_vs_jax"][0], flips.mean()
    if flips.any():
        half = 2 ** (bits - 1)
        dp = np.abs(np.asarray(jref.mrq_codes_decode_ref(_j(t), _j(s1), g=g,
                                                         bits=bits))
                    - np.asarray(jref.mrq_codes_decode_ref(_j(j), _j(s1),
                                                           g=g, bits=bits)))
        assert dp.max() <= TOL["B10_flip_prob_steps"][0] / half


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("bits", [8, 6, 4])
def test_plain_kernels_match_jax_oracles(bits, G):
    """B9a, B10a, B9b and the code decode against the jnp oracles at each
    shape of ``SHAPES`` and the last group."""
    for n, (B, Sq, Skv, D, rep) in enumerate(SHAPES):
        r = np.random.default_rng(100 * bits + 10 * G + n)
        qk, pv = _packs(r, G, bits, Skv)
        g = G - 1
        q = r.standard_normal((B * rep, Sq, D)).astype(np.float32) * 1.5
        k, v = (r.standard_normal((B, Skv, D)).astype(np.float32) * 1.5
                for _ in "kv")
        kr, vr = (np.repeat(a, rep, axis=0) for a in (k, v))
        alpha = np.float32(D ** -0.5)
        scale = qk["scale"] * alpha
        js = np.asarray(jref.int8_bmm_qk_ref(_j(q), _j(kr), _j(qk["s_q"]),
                                             _j(qk["s_k"]), _j(scale), g=g,
                                             bits=bits))
        ts = IB.int8_bmm_qk(_t(q), _t(k), _t(qk["s_q"]), _t(qk["s_k"]),
                            _t(scale), g, bits=bits)
        np.testing.assert_allclose(ts.numpy(), js, rtol=0,
                                   atol=TOL["B9_plain_vs_jax"][0])
        jc = np.asarray(jref.softmax_mrq_codes_ref(_j(js), _j(pv["s1"]), g=g,
                                                   bits=bits))
        tc = SM.softmax_mrq_codes(_t(js), _t(pv["s1"]), g, bits=bits)
        _codes_close(tc, jc, pv["s1"], g, bits)
        np.testing.assert_array_equal(
            tref.mrq_codes_decode_ref(_t(jc), _t(pv["s1"]), g=g,
                                      bits=bits).numpy(),
            np.asarray(jref.mrq_codes_decode_ref(_j(jc), _j(pv["s1"]), g=g,
                                                 bits=bits)))
        jo = np.asarray(jref.int8_bmm_pv_ref(_j(jc), _j(vr), _j(pv["s_v"]),
                                             _j(pv["scale1"]),
                                             _j(pv["scale2"]), g=g,
                                             bits=bits))
        to = IB.int8_bmm_pv(_t(jc), _t(v), _t(pv["s_v"]), _t(pv["scale1"]),
                            _t(pv["scale2"]), g, bits=bits)
        np.testing.assert_allclose(to.numpy(), jo, rtol=0,
                                   atol=TOL["B9_plain_vs_jax"][0])


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("bits", [8, 6, 4])
def test_plain_vec_kernels_match_jax_vec_oracles(bits, G):
    """B9c, B10b (per-row vector and its compact per-batch-row form),
    B9d against the jnp vec oracles with a mixed group vector; a constant
    vector is the scalar path at that group, exactly."""
    for n, (B, Sq, Skv, D, rep) in enumerate(SHAPES):
        r = np.random.default_rng(1000 + 100 * bits + 10 * G + n)
        qk, pv = _packs(r, G, bits, Skv)
        Bq = B * rep
        q = r.standard_normal((Bq, Sq, D)).astype(np.float32) * 1.5
        k, v = (r.standard_normal((B, Skv, D)).astype(np.float32) * 1.5
                for _ in "kv")
        kr, vr = (np.repeat(a, rep, axis=0) for a in (k, v))
        gv = r.integers(0, G, Bq).astype(np.int32)
        scale = qk["scale"] * np.float32(D ** -0.5)
        js = np.asarray(jref.int8_bmm_qk_vec_ref(
            _j(q), _j(kr), _j(qk["s_q"]), _j(qk["s_k"]), _j(scale),
            gv=_j(gv), bits=bits))
        ts = IB.int8_bmm_qk_vec(_t(q), _t(k), _t(qk["s_q"]), _t(qk["s_k"]),
                                _t(scale), _t(gv), bits=bits)
        np.testing.assert_allclose(ts.numpy(), js, rtol=0,
                                   atol=TOL["B9_plain_vs_jax"][0])
        rows = np.broadcast_to(gv[:, None], (Bq, Sq))
        jc = np.asarray(jref.softmax_mrq_codes_vec_ref(
            _j(js), _j(pv["s1"]), gv=_j(rows), bits=bits))
        tc = SM.softmax_mrq_codes_vec(_t(js), _t(pv["s1"]),
                                      _t(rows.copy()), bits=bits)
        assert torch.equal(tc, SM.softmax_mrq_codes_vec(
            _t(js), _t(pv["s1"]), _t(gv), bits=bits))
        assert np.mean(tc.numpy() != jc) <= \
            TOL["B10_code_flip_rate_vs_jax"][0]
        jo = np.asarray(jref.int8_bmm_pv_vec_ref(
            _j(jc), _j(vr), _j(pv["s_v"]), _j(pv["scale1"]),
            _j(pv["scale2"]), gv=_j(gv), bits=bits))
        to = IB.int8_bmm_pv_vec(_t(jc), _t(v), _t(pv["s_v"]),
                                _t(pv["scale1"]), _t(pv["scale2"]), _t(gv),
                                bits=bits)
        np.testing.assert_allclose(to.numpy(), jo, rtol=0,
                                   atol=TOL["B9_plain_vs_jax"][0])
        const = torch.full((Bq,), G - 1, dtype=torch.int32)
        pvt = tuple(_t(pv[a]) for a in ("s_v", "scale1", "scale2"))
        assert torch.equal(
            IB.int8_bmm_qk_vec(_t(q), _t(k), _t(qk["s_q"]), _t(qk["s_k"]),
                               _t(scale), const, bits=bits),
            IB.int8_bmm_qk(_t(q), _t(k), _t(qk["s_q"]), _t(qk["s_k"]),
                           _t(scale), G - 1, bits=bits))
        assert torch.equal(
            SM.softmax_mrq_codes_vec(_t(js), _t(pv["s1"]), const, bits=bits),
            SM.softmax_mrq_codes(_t(js), _t(pv["s1"]), G - 1, bits=bits))
        assert torch.equal(
            IB.int8_bmm_pv_vec(_t(jc), _t(v), *pvt, const, bits=bits),
            IB.int8_bmm_pv(_t(jc), _t(v), *pvt, G - 1, bits=bits))


def _attn_case(seed, bits, G, B=2, Sq=37, Skv=37, Hk=2, Gq=2, D=16):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, Sq, Hk, Gq, D)).astype(np.float32) * 1.5
    k, v = (r.standard_normal((B, Skv, Hk, D)).astype(np.float32) * 1.5
            for _ in "kv")
    qk, pv = _packs(r, G, bits, Skv)
    return q, k, v, qk, pv


def _flat(q, k, v):
    """Flattened (B·Hk·Gq, S, hd) operands, kv repeated per query group
    (the jnp oracles take equal batches)."""
    B, Sq, Hk, Gq, D = q.shape
    qf = q.transpose(0, 2, 3, 1, 4).reshape(B * Hk * Gq, Sq, D)
    kf, vf = (np.repeat(a.transpose(0, 2, 1, 3), Gq, axis=1)
              .reshape(B * Hk * Gq, -1, D) for a in (k, v))
    return qf, kf, vf


def _qkv_views(q, k, v):
    """q, k, v as strided views of one (B, S, Hk * (Gq + 2), hd) projection
    output, the way the DiT block hands them to the chain (GQA: Gq q
    heads per kv head)."""
    B, S, Hk, Gq, D = q.shape
    qkv = torch.from_numpy(np.concatenate(
        [q.reshape(B, S, Hk * Gq, D), k, v], axis=2))
    return (qkv[:, :, :Hk * Gq].reshape(B, S, Hk, Gq, D),
            qkv[:, :, Hk * Gq:Hk * (Gq + 1)], qkv[:, :, Hk * (Gq + 1):])


@pytest.mark.parametrize("layout", ["rows", "qkv_views"])
@pytest.mark.parametrize("vec", [False, True], ids=["scalar", "vec"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("bits", [8, 4])
def test_int8_attention_matches_jax_ref(bits, masked, vec, layout):
    """``ops.int8_attention`` (GQA, ragged S) against ``int8_attention_ref``
    / ``int8_attention_vec_ref``, with and without a causal mask, on
    contiguous operands and on the strided views of one qkv output (the
    serving seam)."""
    G = 3
    q, k, v, qk, pv = _attn_case(7 * bits + masked + 2 * vec, bits, G)
    B, Sq, Hk, Gq, D = q.shape
    Skv = k.shape[1]
    scale = D ** -0.5
    mask = np.tril(np.ones((Sq, Skv), bool)) if masked else None
    tg = _t(np.array([2, 0], np.int32)) if vec else 1
    ops_in = (_qkv_views(q, k, v) if layout == "qkv_views"
              else (_t(q), _t(k), _t(v)))
    assert (layout == "rows") == all(t.is_contiguous() for t in ops_in)
    t = ops.int8_attention(*ops_in, {**{a: _t(b) for a, b in
                                        qk.items()}, "groups": G,
                                     "bits": bits},
                           {**{a: _t(b) for a, b in pv.items()}, "groups": G,
                            "bits": bits},
                           mask=None if mask is None else _t(mask),
                           scale=scale, tgroup=tg).numpy()
    assert t.shape == q.shape
    jpk = ({a: _j(b) for a, b in qk.items()}, {a: _j(b) for a, b in
                                                pv.items()})
    qf, kf, vf = (_j(a) for a in _flat(q, k, v))
    jm = None if mask is None else _j(mask)
    if vec:
        rows = np.repeat(np.array([2, 0], np.int32), Hk * Gq)
        j = jref.int8_attention_vec_ref(qf, kf, vf, *jpk, mask=jm,
                                        scale=scale, gv=_j(rows), bits=bits)
    else:
        j = jref.int8_attention_ref(qf, kf, vf, *jpk, mask=jm, scale=scale,
                                    g=1, bits=bits)
    j = np.asarray(j).reshape(B, Hk, Gq, Sq, D).transpose(0, 3, 1, 2, 4)
    err = np.abs(t - j)
    assert (err.max(axis=-1) > 0).mean() <= \
        TOL["composed_flipped_row_rate"][0]
    half = 2 ** (bits - 1)
    step = float(pv["s_v"].max()) * (half - 1) / half
    assert err.max() <= TOL["composed_atol_steps"][0] * step


@pytest.mark.parametrize("vec", [False, True], ids=["scalar", "vec"])
@pytest.mark.parametrize("bits", [8, 4])
def test_bmm_seam_on_head_views_equals_rows(bits, vec):
    """B9a/B9c on the head views (q (B, Sq, Hk, Gq, hd), k (B, Skv, Hk,
    hd)) give the (B·Hk·Gq, Sq, Skv) scores of the flattened rows, with
    ``alpha`` folded into the scale as the kernel folds it; B9b/B9d given
    the v view give the rows' output in (B, Sq, Hk, Gq, hd) order."""
    G = 3
    q, k, v, qk, pv = _attn_case(90 + bits + vec, bits, G, Sq=21, Skv=30)
    B, Sq, Hk, Gq, D = q.shape
    qv, kv_, vv = _t(q), _t(k), _t(v)
    qr, kr, vr = (t.contiguous() for t in FA.flatten_heads(qv, kv_, vv))
    g = torch.tensor([2, 1], dtype=torch.int32).repeat_interleave(Hk * Gq) \
        if vec else 2
    qk_fn, pv_fn = ((IB.int8_bmm_qk_vec, IB.int8_bmm_pv_vec) if vec
                    else (IB.int8_bmm_qk, IB.int8_bmm_pv))
    qka = tuple(_t(qk[a]) for a in ("s_q", "s_k", "scale"))
    pva = tuple(_t(pv[a]) for a in ("s_v", "scale1", "scale2"))
    alpha = D ** -0.5
    scores = qk_fn(qv, kv_, *qka, g, bits=bits, alpha=alpha)
    assert torch.equal(scores, qk_fn(qr, kr, *qka, g, bits=bits,
                                     alpha=alpha))
    assert torch.equal(scores, qk_fn(
        qr, kr, qka[0], qka[1], qka[2] * float(np.float32(alpha)), g,
        bits=bits))
    codes = SM.softmax_mrq_codes(scores, _t(pv["s1"]), 1, bits=bits)
    out = pv_fn(codes, vv, *pva, g, bits=bits)
    assert tuple(out.shape) == (B, Sq, Hk, Gq, D)
    assert torch.equal(out, pv_fn(codes, vr, *pva, g, bits=bits)
                       .reshape(B, Hk, Gq, Sq, D).permute(0, 3, 1, 2, 4))


@pytest.mark.parametrize("vec", [False, True], ids=["scalar", "vec"])
@pytest.mark.parametrize("bits", [8, 6, 4])
def test_composed_matches_flash_within_contract(bits, vec):
    """The port's composed chain against its flash kernel's plain version
    on the same packs (two 128-wide kv tiles, so flash rescales), within
    the reference's ``flash_vs_composed_atol``."""
    G = 3
    q, k, v, qk, pv = _attn_case(50 + bits + vec, bits, G, Sq=40, Skv=200,
                                 Hk=2, Gq=1)
    packs = ({**{a: _t(b) for a, b in qk.items()}, "groups": G,
              "bits": bits},
             {**{a: _t(b) for a, b in pv.items()}, "groups": G,
              "bits": bits})
    tg = _t(np.array([0, 2], np.int32)) if vec else 2
    args = (_t(q), _t(k), _t(v)) + packs
    kw = dict(scale=q.shape[-1] ** -0.5, tgroup=tg)
    comp = ops.int8_attention(*args, **kw)
    flash = ops.flash_attention(*args, **kw)
    groups = (0, 2) if vec else (2,)
    atol = max(tref.flash_vs_composed_atol(packs[1], g, k.shape[1], bits)
               for g in groups)
    diff = float((comp - flash).abs().max())
    assert diff <= atol, (diff, atol)


# ---------------------------------------------------------------------------
# the whole slice: model forward, engines, launcher
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def both(tiny_dit, tmp_path_factory):
    """(jax cfg, jax params, port cfg, port params, jax artifact, port
    artifact): a w8a8 artifact written by JAX, read by the port."""
    jcfg, jp = tiny_dit
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jart = jquantize(jp, jcfg, JDiffusionCfg(T=1000, tgq_groups=4),
                     JQuantRecipe(bits="w8a8", n_per_group=1, calib_batch=1,
                                  attn_impl="composed"))
    path = str(tmp_path_factory.mktemp("art") / "w8a8")
    jart.save(path)
    tart = QuantArtifact.load(path, device="cpu", params=tp)
    return jcfg, jp, DiTCfg(**dataclasses.asdict(jcfg)), tp, jart, tart


def test_kernel_composed_forward_matches_jax_kernel_composed(both):
    """The port's ``kernel=True, attn_impl="composed"`` forward (plain
    versions) against JAX's (Pallas kernels in interpret mode), one
    forward at a TGQ group > 0; the composed chain is what both ran."""
    jcfg, jp, tcfg, tp, jart, tart = both
    assert jart.recipe.attn_impl == tart.recipe.attn_impl == "composed"
    r = np.random.default_rng(0)
    x = r.standard_normal((2, jcfg.img_size, jcfg.img_size, jcfg.in_ch)
                          ).astype(np.float32)
    t = np.asarray([260, 990], np.int32)
    y = np.asarray([3, jcfg.n_classes], np.int32)
    jctx = jart.context(kernel=True).with_tgroup(3)
    assert jctx.attn_impl == "composed"
    j = np.asarray(jdit_apply(jp, jcfg, _j(x), _j(t), _j(y), ctx=jctx))
    tctx = tart.context(kernel=True).with_tgroup(3)
    seen = []
    real = ops.int8_attention

    def spy(*a, **kw):
        seen.append(1)
        return real(*a, **kw)
    ops.int8_attention = spy
    try:
        with torch.no_grad():
            o = dit_apply(tp, tcfg, _t(x), _t(t).long(), _t(y).long(),
                          ctx=tctx).numpy()
    finally:
        ops.int8_attention = real
    assert len(seen) == tcfg.n_layers
    rel = np.linalg.norm(o - j) / np.linalg.norm(j)
    print(f"composed forward, port vs JAX: rel L2 {rel:.3e}")
    assert np.isfinite(o).all() and rel <= \
        TOL["dit_forward_plain_vs_jax_rel"][0], rel


def test_unknown_attn_impl_raises_value_error(both):
    """Any ``attn_impl`` other than 'flash' or 'composed' raises
    ``ValueError`` with the reference's message."""
    jcfg, jp, tcfg, tp, jart, tart = both
    x = torch.zeros(1, tcfg.img_size, tcfg.img_size, tcfg.in_ch)
    ctx = QuantContext(qparams=tart.qparams, kernel=True, attn_impl="sdpa")
    with pytest.raises(ValueError) as te:
        dit_apply(tp, tcfg, x, torch.tensor([5]), torch.tensor([1]), ctx=ctx)
    jctx = dataclasses.replace(jart.context(kernel=True), attn_impl="sdpa")
    with pytest.raises(ValueError) as je:
        jdit_apply(jp, jcfg, jnp.zeros(x.shape), jnp.array([5]),
                   jnp.array([1]), ctx=jctx)
    assert str(te.value) == str(je.value) == (
        "QuantContext.attn_impl must be 'flash' or 'composed', got 'sdpa'")


DIF = ddpm.DiffusionCfg(T=40, tgq_groups=4)
BUCKETS = (4, 6)
REQS = [GenRequest(request_id=i, label=y, steps=s, cfg_scale=c, seed=10 + i)
        for i, (y, s, c) in enumerate([(1, 4, 1.5), (2, 6, 1.0),
                                       (3, 4, 0.0), (4, 6, 2.0)])]


@pytest.mark.parametrize("bits", ["w8a8", "w4a4"])
def test_async_composed_matches_sync_composed(both, bits, monkeypatch):
    """The slot pool on the composed chain: every attention block of an
    async forward takes B9c -> B10b -> B9d with the slots' group vector,
    and the samples equal the sync composed engine's bit for bit."""
    _, _, cfg, p, _, _ = both
    art = quantize(p, cfg, DIF, QuantRecipe(bits=bits, method="range",
                                            n_per_group=1, calib_batch=1,
                                            attn_impl="composed"))
    assert art.packed_counts() == dict(
        {k: n for k, n in art.packed_counts("flash").items()
         if not k.startswith("flash")},
        int8_bmm_qk=cfg.n_layers, softmax_mrq_codes=cfg.n_layers,
        int8_bmm_pv=cfg.n_layers)
    kw = dict(microbatch=2, step_buckets=BUCKETS, device="cpu")
    ref = ServeEngine.from_artifact(p, art, **kw).serve(REQS)
    seen = {}
    for name in ("int8_bmm_qk_vec", "softmax_mrq_codes_vec",
                 "int8_bmm_pv_vec", "flash_attn_mrq_vec", "int8_bmm_qk"):
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **k):
            seen[_name] = seen.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(ops, name, spy)
    eng = AsyncServeEngine.from_artifact(p, art, chunk=3, **kw)
    assert eng.ctx.kernel and eng.ctx.attn_impl == "composed"
    out = eng.serve(REQS)
    for rid, o in out.items():
        assert o.status == "OK", (rid, o.error)
        assert np.array_equal(o.sample, ref[rid].sample), rid
    f = eng.stats["forwards"]
    assert seen == {k: cfg.n_layers * f for k in (
        "int8_bmm_qk_vec", "softmax_mrq_codes_vec", "int8_bmm_pv_vec")}
    assert not eng.stats["degradations"]


def test_serve_launcher_attn_impl_composed_sync_and_async(tmp_path, capsys):
    """``launch/serve.py --attn-impl composed --device cpu``: the sync and
    ``--async`` serves dump equal samples, and neither takes a rung."""
    from repro_torch.launch import serve
    argv = ["--arch", "dit-xl-2", "--smoke", "--quantize", "w8a8",
            "--attn-impl", "composed", "--device", "cpu", "--steps", "4",
            "--requests", "3"]
    before = dict(kernels.LAUNCHES)
    calls = []
    real = ops.int8_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    ops.int8_attention = spy
    try:
        serve.main(argv + ["--dump-samples", str(tmp_path / "sync.npy")])
        out = capsys.readouterr().out
        assert "attention composed" in out
        serve.main(argv + ["--async", "--chunk", "2", "--dump-samples",
                           str(tmp_path / "async.npy")])
        out = capsys.readouterr().out
    finally:
        ops.int8_attention = real
    assert "0 degradations" in out and calls
    assert kernels.LAUNCHES == before          # plain versions on the CPU
    a, b = (np.load(tmp_path / f"{m}.npy") for m in ("sync", "async"))
    assert a.shape == (3, 8, 8, 4) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
