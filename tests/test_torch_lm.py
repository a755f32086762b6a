"""The dense LM family of the port (``nn/{layers,mlp,attention}.py``,
``models/{config,lm}.py``, ``configs/``, ``rng.categorical``,
``data/synthetic.py::TokenPipeline``, ``core/calib.py``'s LM half and
the launcher's LM branch) held against the JAX package at float32 on
the CPU, on the smoke configs of ``qwen3-1.7b`` (qk-norm, GQA),
``qwen2.5-3b`` (qkv bias) and ``stablelm-3b`` (layernorm, MHA, untied
head).

Tolerances (``kernels/ref.py::TOLERANCES``):

- the keyed init: split keys bit for bit, normals within
  ``normal_atol`` x stddev, ones and zeros exact;
- logits, prefill + decode, CE: ``lm_forward_vs_jax_rel`` (RoPE's cos /
  sin at theta 1e6, the f32 reductions);
- ``TokenPipeline`` and ``build_lm_calibration``: bit for bit;
- ``categorical``: the Gumbel draws within ``lm_gumbel_rtol``, the draws
  equal;
- ``run_ptq``: parameters within a relative 1e-5, or a counted near-tie
  (``ho_near_tie_rel``) of the float64 objective on JAX's own capture;
- the kernel context (plain versions) against JAX's fake-quant context on
  the same qparams: ``lm_kernel_plain_vs_jax_fq_rel``;
- greedy generation: tokens equal up to a first difference, which must
  be a near-tie of the port's teacher-forced logits
  (``lm_greedy_near_tie_rel``).

The file runs on one torch thread and one BLAS thread; its JAX side
(the eager inits and forwards, one module-scoped ``run_ptq``, the
reference launcher) is most of its time.
"""
from __future__ import annotations

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.configs import registry as jreg
from repro.core import calib as jcalib
from repro.core import ptq as jptq
from repro.core.baselines import tq_dit as jtq_dit
from repro.core.contexts import QuantContext as JQuantContext
from repro.data.synthetic import TokenPipeline as JTokenPipeline
from repro.models import lm as jlm
from repro.nn.ctx import FPContext as JFPContext
from repro_torch.configs import dit_xl_2
from repro_torch.configs import registry as treg
from repro_torch.core import calib as tcalib
from repro_torch.core.baselines import tq_dit
from repro_torch.core.contexts import QuantContext
from repro_torch.core.ptq import run_ptq
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.diffusion import rng
from repro_torch.kernels import ops
from repro_torch.kernels.ref import TOLERANCES
from repro_torch.models import lm as tlm
from repro_torch.nn import attention as tattn
from repro_torch.nn import mlp as tmlp
from repro_torch.nn.ctx import FPContext
from repro_torch.nn.tree import map_tree, params_from_numpy
from test_torch_ho import (NEAR_TIE, _PinnedRecordingContext, _check_choice,
                           _einsum_obj, _linear_obj, _qdq64, _to_port)

CPU = "cpu"
ARCHS = ("qwen3-1.7b", "qwen2.5-3b", "stablelm-3b")
FWD_REL = TOLERANCES["lm_forward_vs_jax_rel"][0]
PTQ_KW = dict(n_alpha=4, rounds=1, max_rows_per_batch=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, pre=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, pre + (k,)))
        return out
    return {pre: tree}


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX cfg, JAX params, port cfg, port params from JAX's)."""
    out = {}
    for arch in ARCHS:
        jc, tc = jreg.get_smoke(arch), treg.get_smoke(arch)
        jp = jlm.lm_init(jax.random.PRNGKey(0), jc)
        out[arch] = (jc, jp, tc, params_from_numpy(_np_tree(jp),
                                                   device=CPU))
    return out


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------
def test_registry_and_configs_equal_jax():
    assert treg.ARCHS == jreg.ARCHS and treg.SHAPES == jreg.SHAPES
    assert treg.DIT_SHAPES == jreg.DIT_SHAPES
    assert treg.SUBQUADRATIC == jreg.SUBQUADRATIC
    for arch in jreg.ARCHS:
        assert treg.cells(arch) == jreg.cells(arch)
        for getter in ("get", "get_smoke"):
            j, t = getattr(jreg, getter)(arch), getattr(treg, getter)(arch)
            assert dataclasses.asdict(j) == dataclasses.asdict(t), arch
            if arch == "dit-xl-2":
                continue
            assert j.n_params() == t.n_params(), arch
            assert j.n_active_params() == t.n_active_params(), arch
            for sub in ("attn_cfg", "mlp_cfg", "mla_cfg", "moe_cfg",
                        "ssd_cfg"):
                assert dataclasses.asdict(getattr(j, sub)()) == \
                    dataclasses.asdict(getattr(t, sub)()), (arch, sub)
    # the launchers' DiT config is the registry's
    assert treg.get("dit-xl-2") == dit_xl_2.full()
    assert treg.get_smoke("dit-xl-2") == dit_xl_2.smoke()
    assert treg.get("qwen3-1.7b", n_layers=3).n_layers == 3
    assert treg.get("qwen3-1.7b").tdtype == torch.bfloat16
    with pytest.raises(KeyError):
        treg.get("gpt-5")


# ---------------------------------------------------------------------------
# the keyed init
# ---------------------------------------------------------------------------
def test_init_key_stream_bit_for_bit():
    """The split keys at every level of ``lm_init``'s tree: top, layers,
    block, attention, MLP."""
    jk, tk = jax.random.PRNGKey(7), rng.PRNGKey(7)

    def same(j, t):
        assert np.array_equal(np.asarray(jax.random.key_data(j)
                                          if hasattr(j, "dtype") and
                                          jnp.issubdtype(j.dtype,
                                                         jax.dtypes.prng_key)
                                          else j).astype(np.int64),
                              t.numpy())
    top_j, top_t = jax.random.split(jk, 5), rng.split(tk, 5)
    same(top_j, top_t)
    lay_j, lay_t = jax.random.split(top_j[1], 4), rng.split(top_t[1], 4)
    same(lay_j, lay_t)
    blk_j, blk_t = jax.random.split(lay_j[2], 8), rng.split(lay_t[2], 8)
    same(blk_j, blk_t)
    same(jax.random.split(blk_j[1], 7), rng.split(blk_t[1], 7))
    same(jax.random.split(blk_j[3], 3), rng.split(blk_t[3], 3))
    # the uniforms under every normal of the init: bit for bit
    u_j = jax.random.uniform(blk_j[1], (64, 48), minval=-1.0, maxval=1.0)
    u_t = rng.uniform(blk_t[1], (64, 48), -1.0, 1.0)
    assert np.array_equal(np.asarray(u_j), u_t.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_init_matches_jax(arch, models):
    jc, jp, tc, _ = models[arch]
    tp = tlm.lm_init(rng.PRNGKey(0), tc, device=CPU)
    jf, tf = _flat(_np_tree(jp)), _flat(tp)
    assert sorted(jf) == sorted(tf)
    atol = TOLERANCES["normal_atol"][0]
    for path, a in jf.items():
        b = tf[path].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if np.all((a == 0) | (a == 1)):
            assert np.array_equal(a, b), path          # norms, biases
            continue
        std = 0.01 if path == ("pos",) else 0.02
        assert np.abs(a - b).max() <= atol * std, path
    assert ("blocks", "attn", "q", "w") in tf
    L = tc.n_layers
    assert tf[("blocks", "attn", "q", "w")].shape[0] == L
    assert (("head", "w") in tf) == (not tc.tie_embeddings)


def test_other_families_raise_naming_their_item():
    key = rng.PRNGKey(0)
    for arch, item in (("whisper-tiny", "8(c)"),
                       ("deepseek-v2-236b", "8(d)"),
                       ("kimi-k2-1t-a32b", "8(d)")):
        with pytest.raises(NotImplementedError, match=item.replace(
                "(", r"\(").replace(")", r"\)")):
            tlm.lm_init(key, treg.get_smoke(arch), device=CPU)
    with pytest.raises(NotImplementedError, match="8\\(d\\)"):
        tmlp.moe_apply({}, None, None)
    with pytest.raises(NotImplementedError, match="8\\(c\\)"):
        tattn.cross_attention_decode({}, None, None, None)
    with pytest.raises(NotImplementedError, match="item 9"):
        cfg = dataclasses.replace(treg.get_smoke("qwen3-1.7b").attn_cfg(),
                                  sp_spec=(("data",), "model"))
        tattn.attention_apply({}, cfg, torch.zeros(1, 2, 64))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tlm.lm_init(key, treg.get_smoke("qwen3-1.7b"))


# ---------------------------------------------------------------------------
# forward, prefill + decode, CE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_apply_matches_jax(arch, models):
    jc, jp, tc, tp = models[arch]
    toks = _tokens(jc.vocab, (2, 24))
    jl, _ = jlm.lm_apply(jp, jc, jnp.asarray(toks))
    tl, aux = tlm.lm_apply(tp, tc, torch.from_numpy(toks))
    assert tl.shape == (2, 24, jc.vocab) and aux["aux_loss"] == 0.0
    assert _rel(tl.numpy(), jl) <= FWD_REL


@pytest.mark.parametrize("arch,window", [
    ("qwen3-1.7b", None), ("qwen2.5-3b", None), ("stablelm-3b", None),
    ("qwen3-1.7b", 5)], ids=["qwen3", "qwen2.5", "stablelm", "qwen3-window"])
def test_prefill_decode_equals_forward(arch, window, models):
    """``lm_prefill`` of 7 tokens then ``lm_decode_step`` over 5 more:
    each step's logits equal the full forward's at that position; with a
    window override (window 5, layer 1 global), the full forward is held
    against JAX's too."""
    jc, jp, tc, tp = models[arch]
    if window is not None:
        jc = dataclasses.replace(jc, window=window, global_layers=(1,))
        tc = dataclasses.replace(tc, window=window, global_layers=(1,))
    toks = _tokens(jc.vocab, (2, 12), seed=1)
    full, _ = tlm.lm_apply(tp, tc, torch.from_numpy(toks))
    if window is not None:
        jl, _ = jlm.lm_apply(jp, jc, jnp.asarray(toks))
        assert _rel(full.numpy(), jl) <= FWD_REL
        assert tlm.layer_windows(tc, 12) == [5, 1024]
    t = torch.from_numpy(toks)
    lg, cache = tlm.lm_prefill(tp, tc, t[:, :7], max_len=12)
    assert cache["kv"]["k"].shape == (tc.n_layers, 2, 12, tc.n_kv_heads,
                                      tc.head_dim)
    k_buf = cache["kv"]["k"]
    assert _rel(lg[:, 0].numpy(), full[:, 6].numpy()) <= FWD_REL
    for i in range(7, 12):
        lg, cache = tlm.lm_decode_step(tp, tc, t[:, i:i + 1], cache, i)
        assert cache["kv"]["k"] is k_buf               # written in place
        assert _rel(lg[:, 0].numpy(), full[:, i].numpy()) <= FWD_REL


def test_prefill_cache_matches_jax(models):
    jc, jp, tc, tp = models["qwen3-1.7b"]
    toks = _tokens(jc.vocab, (2, 9), seed=2)
    jl, jcache = jlm.lm_prefill(jp, jc, jnp.asarray(toks), max_len=13)
    tl, tcache = tlm.lm_prefill(tp, tc, torch.from_numpy(toks), max_len=13)
    assert _rel(tl.numpy(), jl) <= FWD_REL
    for name in ("k", "v"):
        a, b = np.asarray(jcache["kv"][name]), tcache["kv"][name].numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= FWD_REL * np.abs(a).max()
        assert not b[:, :, 9:].any()


def test_ce_loss_and_loss_fn_match_jax(models):
    rs = np.random.default_rng(3)
    logits = (rs.standard_normal((3, 10, 256)) * 3).astype(np.float32)
    labels = rs.integers(0, 256, (3, 10)).astype(np.int32)
    labels[:, -1] = -1
    labels[1, 2] = -1
    j = float(jlm.ce_loss(jnp.asarray(logits), jnp.asarray(labels)))
    t = float(tlm.ce_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(t - j) <= FWD_REL * abs(j)
    assert float(tlm.ce_loss(torch.zeros(1, 2, 4),
                             torch.full((1, 2), -1))) == 0.0
    jc, jp, tc, tp = models["stablelm-3b"]
    toks = _tokens(jc.vocab, (2, 16), seed=4)
    jb = jcalib.build_lm_calibration([jnp.asarray(toks)])[0][0]
    tb = tcalib.build_lm_calibration([torch.from_numpy(toks)])[0][0]
    jv = float(jcalib.lm_loss_fn(jp, jc)(JFPContext(), jb))
    tv = float(tcalib.lm_loss_fn(tp, tc)(FPContext(), tb))
    assert abs(tv - jv) <= FWD_REL * abs(jv)


def test_remat_equals_no_remat(models):
    _, _, tc, tp = models["qwen3-1.7b"]
    toks = torch.from_numpy(_tokens(tc.vocab, (2, 8)))
    batch = tcalib.build_lm_calibration([toks])[0][0]
    out = []
    for remat in (False, True):
        c = dataclasses.replace(tc, remat=remat)
        p = map_tree(lambda a: a.clone().requires_grad_(True), tp)
        loss, _ = tlm.lm_loss_fn(p, c, batch)
        g = torch.autograd.grad(loss, p["blocks"]["attn"]["q"]["w"])[0]
        out.append((loss.detach(), g))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


# ---------------------------------------------------------------------------
# data, calibration batches, categorical
# ---------------------------------------------------------------------------
def test_token_pipeline_and_lm_calibration_bit_for_bit():
    for kw in (dict(vocab=256, seq_len=40, batch=3, seed=5),
               dict(vocab=1000, seq_len=17, batch=2, seed=1, host_id=1,
                    n_hosts=2)):
        jpipe, tpipe = JTokenPipeline(**kw), TokenPipeline(**kw)
        for step in (0, 3, 100):
            jb, tb = jpipe.batch_at(step), tpipe.batch_at(step)
            for k in ("tokens", "labels"):
                assert tb[k].dtype == torch.int32
                assert np.array_equal(np.asarray(jb[k]), tb[k].numpy())
        jcal = jcalib.build_lm_calibration(
            [jpipe.batch_at(i)["tokens"] for i in range(2)])
        tcal = tcalib.build_lm_calibration(
            [tpipe.batch_at(i)["tokens"] for i in range(2)])
        for (jb, jg), (tb, tg) in zip(jcal, tcal):
            assert jg == tg == 0
            for k in ("tokens", "labels"):
                assert np.array_equal(np.asarray(jb[k]), tb[k].numpy())
    it = TokenPipeline(vocab=64, seq_len=4, batch=1).batches()
    from repro_torch.data.synthetic import prefetch
    got = [b["tokens"] for _, b in zip(range(3), prefetch(it))]
    ref = TokenPipeline(vocab=64, seq_len=4, batch=1)
    assert all(torch.equal(g, ref.batch_at(i)["tokens"])
               for i, g in enumerate(got))


def test_categorical_matches_jax():
    rs = np.random.default_rng(6)
    logits = (rs.standard_normal((16, 256)) * 2).astype(np.float32)
    rtol = TOLERANCES["lm_gumbel_rtol"][0]
    for seed in range(4):
        jk, tk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
        jg = np.asarray(jax.random.gumbel(jk, (16, 256)))
        tg = rng.gumbel(tk, (16, 256)).numpy()
        assert np.allclose(tg, jg, rtol=rtol, atol=rtol)
        jd = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
        td = rng.categorical(tk, torch.from_numpy(logits)).numpy()
        assert np.array_equal(jd, td), seed
    # bf16 logits are widened to f32 first
    bf = torch.from_numpy(logits).bfloat16()
    assert torch.equal(rng.categorical(rng.PRNGKey(1), bf),
                       rng.categorical(rng.PRNGKey(1), bf.float()))


# ---------------------------------------------------------------------------
# LM PTQ: run_ptq, the packs, the kernel context
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ptq(models):
    """Both packages' ``run_ptq`` (tq_dit, W8A8) on the same two
    ``TokenPipeline`` batches of 2 x 32 at the qwen3 smoke config; the
    reference's marks pinned (see test_torch_ho.py)."""
    jc, jp, tc, tp = models["qwen3-1.7b"]
    pipe = TokenPipeline(vocab=tc.vocab, seq_len=32, batch=2, seed=5)
    toks = [pipe.batch_at(i)["tokens"] for i in range(2)]
    jcal = jcalib.build_lm_calibration([jnp.asarray(t.numpy())
                                        for t in toks])
    tcal = tcalib.build_lm_calibration(toks)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jptq, "RecordingContext", _PinnedRecordingContext)
        jq, jrep = jptq.run_ptq(jcalib.lm_loss_fn(jp, jc), jcal,
                                jtq_dit(8, 8, **PTQ_KW))
    tq_, trep = run_ptq(tcalib.lm_loss_fn(tp, tc), tcal,
                        tq_dit(8, 8, **PTQ_KW))
    return dict(jc=jc, jp=jp, tc=tc, tp=tp, jcal=jcal, tcal=tcal, jq=jq,
                jrep=jrep, tq=tq_, trep=trep)


def _lm_capture_obj(d, name, qp):
    """The float64 objective of ``qp`` for op ``name`` on the reference's
    own capture and normalised Fisher rows (built once)."""
    from repro.core import fisher as jfisher
    from repro.core.contexts import CalibrationContext, stable_seed
    if "capture" not in d:
        loss = jcalib.lm_loss_fn(d["jp"], d["jc"])
        rec = _PinnedRecordingContext()
        loss(rec, d["jcal"][0][0])
        hooks = frozenset(n for n, k in rec.acts.items() if k == "post_silu")
        cal = CalibrationContext(registry=rec.registry, hook_acts=hooks,
                                 max_rows_per_batch=PTQ_KW[
                                     "max_rows_per_batch"])
        fisher = jfisher.make_fisher_fn(
            loss, jfisher.discover_tap_shapes(loss, d["jcal"][0][0]))
        grads = []
        for b, tg in d["jcal"]:
            cal.begin_batch()
            loss(dataclasses.replace(cal, tgroup=tg), b)
            grads.append(fisher(b))
        d["capture"] = (rec.registry, cal, grads)
    registry, cal, grads = d["capture"]
    if name in cal.act_store:
        X = np.concatenate(cal.act_store[name]).astype(np.float64)
        return float(np.mean(np.square(_qdq64(qp["act"], X) - X)))
    info, recs = registry[name], cal.store[name]
    gs = []
    for g in grads:
        a = np.asarray(g[name])
        a = a / (np.sqrt(np.mean(np.square(a))) + 1e-20)
        gs.append(jfisher.subsample_rows_like(
            a, PTQ_KW["max_rows_per_batch"], stable_seed(name))
            if info.kind == "linear" else a[:4])
    if info.kind == "linear":
        return _linear_obj(qp, [r["x"] for r in recs], gs,
                           cal.weights[name], [r["tg"] for r in recs])
    return _einsum_obj(qp, info.spec, recs, gs)


def test_run_ptq_matches_jax(ptq):
    jq, tq_, jrep, trep = ptq["jq"], ptq["tq"], ptq["jrep"], ptq["trep"]
    for k in ("n_ops", "n_quantized", "n_batches", "n_attention_einsums",
              "calib_bytes"):
        assert jrep[k] == trep[k], k
    assert sorted(jq) == sorted(tq_)
    assert sorted(jrep["weights"]) == sorted(trep["weights"])
    for name in jrep["weights"]:
        np.testing.assert_array_equal(np.asarray(jrep["weights"][name]),
                                      trep["weights"][name])
    # the silu gates are quantized at their hook (two-lobe MRQ), the
    # probabilities by a TGQ-stacked MRQ softmax quantizer
    assert type(tq_["blk0/mlp/silu"]["act"]).__name__ == "MRQSignedQ"
    assert type(tq_["blk0/attn/pv"]["x"]).__name__ == "TGQ"
    ties = []
    for name in jq:
        _check_choice(name, jq[name], tq_[name],
                      lambda qp: _lm_capture_obj(ptq, name, qp), ties,
                      rtol=1e-5)
    print(f"LM run_ptq tq_dit: {len(ties)} near-ties {ties} "
          f"(budget {NEAR_TIE})")


@pytest.mark.parametrize("skip_head", [False, True],
                         ids=["lm_head", "skip-lm_head"])
def test_pack_counts(ptq, skip_head):
    """15 ``int8`` packs (7 a layer and ``lm_head``) and 2 attention pairs
    at the qwen3 smoke config, none MRQ; ``skip_patterns`` may leave
    ``lm_head`` out, which then runs in full precision."""
    qp, weights = ptq["tq"], ptq["trep"]["weights"]
    if skip_head:
        qp, _ = run_ptq(tcalib.lm_loss_fn(ptq["tp"], ptq["tc"]), ptq["tcal"],
                        tq_dit(8, 8, skip_patterns=("router", "lm_head"),
                               **PTQ_KW))
        assert "lm_head" not in qp
    packed = ops.convert_for_kernels(qp, weights)
    n = lambda key: sum(key in p for p in packed.values())
    assert n("int8") == (14 if skip_head else 15)
    assert n("int8_qk") == n("int8_pv") == 2
    assert n("int8_mrq") == 0
    # the tied head's weight is emb.T: its codes are packed from that view
    if not skip_head:
        wq = packed["lm_head"]["int8"]["wq"]
        assert tuple(wq.shape) == (ptq["tc"].d_model, ptq["tc"].vocab)


@pytest.mark.parametrize("bits", [8, 6])
def test_weight_codes_clip_as_the_reference(bits):
    """A kernel pack clips a weight's codes to +-(2^(b-1) - 1)
    (``ops._weight_codes``), fake-quant's ``symmetric_qdq`` to [-2^(b-1),
    2^(b-1) - 1]: both packages do so. Where the searched clip puts a
    weight below -(2^(b-1) - 0.5) steps, the kernels read one code more
    than fake-quant (counted on the card by ``chip_smoke.py``'s logits
    witness); elsewhere the codes agree."""
    from repro.core import quantizers as jquant
    from repro.kernels import ops as jops
    from repro_torch.core import quantizers as tquant
    half = 2 ** (bits - 1)
    w = np.random.default_rng(3).normal(size=(64, 8)).astype(np.float32)
    sw = (np.abs(w).max(0) / (half - 1) * 0.5).astype(np.float32)
    tc, tsw = ops._weight_codes(tquant.ChannelQ(torch.from_numpy(sw), bits),
                                torch.from_numpy(w), half)
    jc, _ = jops._weight_codes(jquant.ChannelQ(jnp.asarray(sw), bits),
                               jnp.asarray(w), half)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    fq_t = tquant.symmetric_qdq(torch.from_numpy(w), tsw[None], bits)
    fq_j = jquant.symmetric_qdq(jnp.asarray(w), jnp.asarray(sw)[None], bits)
    codes_t = torch.round(fq_t / tsw[None]).numpy()
    np.testing.assert_array_equal(codes_t, np.round(np.asarray(fq_j) / sw))
    apart = codes_t != tc.numpy()
    assert apart.any()
    assert (codes_t[apart] == -half).all() and (tc.numpy()[apart]
                                                == -(half - 1)).all()


def _eval_batch(tc):
    return TokenPipeline(vocab=tc.vocab, seq_len=32, batch=2,
                         seed=5).batch_at(100)


def test_kernel_context_plain_matches_jax_fake_quant(ptq):
    """JAX's qparams, packed by the port, served on the CPU through the
    kernel context's plain versions (every linear B1's, every attention
    call B3's with its causal mask) against JAX's fake-quant context; the
    port's fake-quant context on the same qparams sits closer."""
    jc, jp, tc, tp = ptq["jc"], ptq["jp"], ptq["tc"], ptq["tp"]
    tq_ = _to_port(ptq["jq"])
    packed = ops.convert_for_kernels(tq_, {k: np.asarray(v) for k, v in
                                           ptq["jrep"]["weights"].items()})
    b = _eval_batch(tc)
    toks = b["tokens"]
    jl, _ = jlm.lm_apply(jp, jc, jnp.asarray(toks.numpy()),
                         ctx=JQuantContext(qparams=ptq["jq"]))
    kl, _ = tlm.lm_apply(tp, tc, toks,
                         ctx=QuantContext(qparams=packed, kernel=True))
    fl, _ = tlm.lm_apply(tp, tc, toks, ctx=QuantContext(qparams=tq_))
    rel_k, rel_f = _rel(kl.numpy(), jl), _rel(fl.numpy(), jl)
    print(f"kernel context (plain) vs JAX fake-quant {rel_k:.3g}, port "
          f"fake-quant {rel_f:.3g}")
    assert rel_k <= TOLERANCES["lm_kernel_plain_vs_jax_fq_rel"][0]
    assert rel_f <= TOLERANCES["lm_kernel_plain_vs_jax_fq_rel"][0]
    # the CE under each context, beside full precision
    jloss = jcalib.lm_loss_fn(jp, jc)
    jb = jcalib.build_lm_calibration([jnp.asarray(toks.numpy())])[0][0]
    tb = tcalib.build_lm_calibration([toks])[0][0]
    ce_j = float(jloss(JQuantContext(qparams=ptq["jq"]), jb))
    ce_k = float(tcalib.lm_loss_fn(tp, tc)(
        QuantContext(qparams=packed, kernel=True), tb))
    ce_fp = float(tcalib.lm_loss_fn(tp, tc)(FPContext(), tb))
    assert abs(ce_k - ce_j) <= TOLERANCES[
        "lm_kernel_plain_vs_jax_fq_rel"][0] * ce_j
    assert abs(ce_k - ce_fp) <= 0.05 * ce_fp
    # the kernel context serves prefill and decode too: the decode
    # attention call takes the (1, 1, 1, 1, Skv) validity mask
    out = tlm.lm_generate(tp, tc, toks[:, :8], 4,
                          ctx=QuantContext(qparams=packed, kernel=True))
    assert out.shape == (2, 4) and int(out.min()) >= 0 \
        and int(out.max()) < tc.vocab


# ---------------------------------------------------------------------------
# generation and the launcher
# ---------------------------------------------------------------------------
def _greedy_agree(tp, tc, prompt, jt, tt):
    """Equal token streams, or a first difference at a near-tie of the
    port's teacher-forced logits; returns the number of positions
    compared before it."""
    jt, tt = np.asarray(jt), np.asarray(tt)
    for b in range(jt.shape[0]):
        diff = np.nonzero(jt[b] != tt[b])[0]
        if not diff.size:
            continue
        j = int(diff[0])
        seq = np.concatenate([np.asarray(prompt[b]), tt[b, :j]])[None]
        lg, _ = tlm.lm_apply(tp, tc, torch.from_numpy(seq.astype(np.int32)))
        last = lg[0, -1].numpy().astype(np.float64)
        gap = abs(last[jt[b, j]] - last[tt[b, j]]) / np.abs(last).max()
        print(f"greedy near-tie row {b} step {j}: gap {gap:.3g}")
        assert gap <= TOLERANCES["lm_greedy_near_tie_rel"][0]
    return jt.size


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_generate_greedy_matches_jax(arch, models):
    jc, jp, tc, tp = models[arch]
    prompt = _tokens(jc.vocab, (3, 6), seed=8)
    jt = jlm.lm_generate(jp, jc, jnp.asarray(prompt), 6)
    tt = tlm.lm_generate(tp, tc, torch.from_numpy(prompt), 6)
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (3, 6)
    _greedy_agree(tp, tc, prompt, jt, tt.numpy())


def test_lm_generate_sampled_matches_jax(models):
    jc, jp, tc, tp = models["qwen2.5-3b"]
    prompt = _tokens(jc.vocab, (2, 5), seed=9)
    jt = jlm.lm_generate(jp, jc, jnp.asarray(prompt), 6, greedy=False,
                         key=jax.random.PRNGKey(3), temperature=0.7)
    tt = tlm.lm_generate(tp, tc, torch.from_numpy(prompt), 6, greedy=False,
                         key=rng.PRNGKey(3), temperature=0.7)
    assert np.array_equal(np.asarray(jt), tt.numpy())


@pytest.mark.parametrize("arch,prompt_len", [
    ("qwen3-1.7b", 12), ("mamba2-130m", 16), ("hymba-1.5b", 16)],
    ids=["qwen3", "mamba2", "hymba"])
def test_launcher_smoke_matches_reference(arch, prompt_len, capsys,
                                          monkeypatch):
    """``python -m repro_torch.launch.serve --arch ARCH --smoke --device
    cpu`` prints the reference launcher's lines for the same seed: the
    generated tokens equal, the timing line's shape. An SSD model's
    prompt is a multiple of its chunk (8 at the smoke size): both
    packages' prefill refuses any other length."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    argv = ["--arch", arch, "--smoke", "--batch", "2",
            "--prompt_len", str(prompt_len), "--gen", "6", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    jout = capsys.readouterr().out.splitlines()
    tserve.main(argv + ["--device", CPU])
    tout = capsys.readouterr().out.splitlines()
    assert len(tout) == 2 and tout[0].startswith("generated 2x6 tokens in ")
    assert tout[0].endswith("ms/token batched)")
    assert tout[1].startswith("sample: ") and tout[1] == jout[-1], \
        (tout, jout)


@pytest.mark.parametrize("argv,match", [
    (["--arch", "whisper-tiny"], r"item 8\(c\)"),
    (["--arch", "deepseek-v2-236b"], r"item 8\(d\)"),
    (["--arch", "kimi-k2-1t-a32b"], r"item 8\(d\)"),
    (["--arch", "qwen3-1.7b", "--dump-samples", "x.npy"], "DiT-only"),
    (["--arch", "qwen3-1.7b", "--load-artifact", "x"], "DiT-only"),
    (["--arch", "qwen3-1.7b", "--quantize", "w8a8"], "run_ptq"),
], ids=["whisper", "deepseek", "kimi", "dump", "load", "quantize"])
def test_launcher_refusals(argv, match):
    from repro_torch.launch import serve as tserve
    with pytest.raises(SystemExit, match=match):
        tserve.main(argv + ["--smoke", "--device", CPU])


@pytest.mark.parametrize("shape", [(2, 1, 1, 9, 130), (1, 1, 1, 1, 130),
                                   (2, 3, 1, 9, 1)],
                         ids=["causal", "decode", "per-head"])
def test_head_mask_bits_equal_the_broadcast_words(shape):
    """The words the flash kernel reads for a 5-D mask, packed once per
    distinct row and repeated over the heads (``head_mask_bits``), equal
    ``mask_bits`` of the mask broadcast to every (batch, head, group)
    row; ``ops.flash_attention`` keeps the LM's masks 5-D for this."""
    import importlib
    FA = importlib.import_module("repro_torch.kernels.flash_attn_mrq")
    B, Hk, G, M, N = 2, 3, 2, 9, 130
    m = torch.from_numpy(np.random.default_rng(1).random(shape) < 0.6)
    full = torch.broadcast_to(m, (B, Hk, G, M, N)).reshape(B * Hk * G, M, N)
    want = FA.mask_bits(full, B * Hk * G, M, N, torch.device(CPU))
    got = FA.head_mask_bits(m, B, Hk, G, M, N, torch.device(CPU))
    assert got.is_contiguous() and torch.equal(got, want)


def test_kernel_context_serves_a_bf16_model(ptq):
    """A bf16 model under the kernel context: the silu hook's f32 steps
    promote the activations to f32 after layer 0's SwiGLU (as the
    reference's type promotion does), so layer 0's bf16 q meets an f32
    decode cache; the attention wrapper widens it exactly, and the
    generation runs."""
    tc = dataclasses.replace(ptq["tc"], dtype="bfloat16")
    tp = map_tree(lambda a: a.to(torch.bfloat16)
                      if a.is_floating_point() else a, ptq["tp"])
    packed = ops.convert_for_kernels(ptq["tq"], ptq["trep"]["weights"])
    ctx = QuantContext(qparams=packed, kernel=True)
    toks = _eval_batch(tc)["tokens"][:, :8]
    lg, cache = tlm.lm_prefill(tp, tc, toks, ctx=ctx, max_len=12)
    assert lg.dtype == torch.float32
    assert cache["kv"]["k"].dtype == torch.float32
    out = tlm.lm_generate(tp, tc, toks, 4, ctx=ctx)
    assert out.shape == (2, 4) and int(out.max()) < tc.vocab
    # the widening is exact: the same call with q widened by the caller
    rs = np.random.default_rng(2)
    q = torch.from_numpy(rs.standard_normal((2, 1, 2, 2, 16)).astype(
        np.float32)).bfloat16()
    k, v = (torch.from_numpy(rs.standard_normal((2, 5, 2, 16)).astype(
        np.float32)) for _ in "kv")
    qk, pv = packed["blk0/attn/qk"]["int8_qk"], packed["blk0/attn/pv"][
        "int8_pv"]
    mixed = ops.flash_attention(q, k, v, qk, pv, scale=0.25)
    wide = ops.flash_attention(q.float(), k, v, qk, pv, scale=0.25,
                               out_dtype=torch.bfloat16)
    assert mixed.dtype == torch.bfloat16 and torch.equal(mixed, wide)
