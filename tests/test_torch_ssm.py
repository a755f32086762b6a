"""The SSM and hybrid families of the port (``nn/ssm.py``, the
``ssm_only`` and ``hymba`` blocks of ``models/lm.py``) held against the
JAX package on the CPU: the Mamba-2 SSD mixer at ``tests/test_models.py``'s
SSM shapes, and the ``mamba2-smoke`` and ``hymba-smoke`` LMs (hymba's
meta tokens, a window of 8 that bites, global layers 0 and 2).

Tolerances (``kernels/ref.py::TOLERANCES``):

- ``ssd_init``: uniforms, zeros and ones bit for bit, ``dt_bias`` and
  ``A_log`` within ``ssd_init_ulps``, normals within ``normal_atol`` x
  stddev;
- float32 forwards, states, decode steps: ``lm_forward_vs_jax_rel``;
  bf16: ``ssm_bf16_vs_jax_rel``;
- greedy generation: tokens equal up to a first difference at a
  near-tie of the port's teacher-forced logits (``lm_greedy_near_tie_rel``
  in float32, ``ssm_bf16_vs_jax_rel`` in bf16);
- ``run_ptq`` at ``mamba2-smoke``: parameters within a relative 1e-5, or
  a counted near-tie (``ho_near_tie_rel``);
- the kernel context's plain versions and the port's fake-quant context,
  each against JAX's fake-quant context on the same qparams (logits and
  CE): ``lm_kernel_plain_vs_jax_fq_rel``.

The file runs on one torch thread and one BLAS thread.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.configs import registry as jreg
from repro.core import calib as jcalib
from repro.core import ptq as jptq
from repro.core import quantizers as jquant
from repro.core.contexts import QuantContext as JQuantContext
from repro.core.baselines import tq_dit as jtq_dit
from repro.models import lm as jlm
from repro.nn import ssm as jssm
from repro_torch.configs import registry as treg
from repro_torch.core import calib as tcalib
from repro_torch.core.baselines import tq_dit
from repro_torch.core.contexts import QuantContext, RecordingContext
from repro_torch.core.ptq import run_ptq
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.diffusion import rng
from repro_torch.kernels import ops
from repro_torch.kernels.ref import TOLERANCES
from repro_torch.models import lm as tlm
from repro_torch.nn import ssm as tssm
from test_torch_ho import (NEAR_TIE, _PinnedRecordingContext, _check_choice,
                           _to_port)
from test_torch_lm import _lm_capture_obj

CPU = "cpu"
ARCHS = ("mamba2-130m", "hymba-1.5b")
DTYPES = ("float32", "bfloat16")
FWD_REL = TOLERANCES["lm_forward_vs_jax_rel"][0]
BF16_REL = TOLERANCES["ssm_bf16_vs_jax_rel"][0]
PTQ_KW = dict(n_alpha=4, rounds=1, max_rows_per_batch=32)
# tests/test_models.py's SSM mixer shapes
SSD = dict(d_model=64, d_inner=128, d_state=16, head_dim=32, chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _rel(a, b):
    a = np.asarray(jnp.asarray(a, jnp.float32) if isinstance(a, jax.Array)
                   else a, np.float64)
    b = np.asarray(jnp.asarray(b, jnp.float32) if isinstance(b, jax.Array)
                   else b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else t


def _tol(dtype):
    return FWD_REL if dtype == "float32" else BF16_REL


def _port_params(jp):
    """The port's parameters from JAX's, leaf for leaf in its dtype (bf16
    widened to f32 by numpy, then cast back: exact)."""
    def leaf(a):
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.array(a.astype(jnp.float32))
                                    ).bfloat16()
        return torch.from_numpy(np.array(a))
    return jax.tree.map(leaf, jp)


def _flat(tree, pre=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, pre + (k,)))
        return out
    return {pre: tree}


def _to_jax(tree):
    """The port's qparams tree as JAX's (``_to_port``'s inverse)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return getattr(jquant, type(tree).__name__)(**{
            f.name: _to_jax(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, torch.Tensor):
        return jnp.asarray(tree.numpy())
    return tree


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float((np.abs(a - b) / np.spacing(np.abs(a))).max())


# ---------------------------------------------------------------------------
# the SSD mixer
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mixers():
    """(n_groups, dtype) -> (JAX cfg, port cfg, JAX params, port params
    from JAX's)."""
    out = {}
    for g in (1, 2):
        jc, tc = jssm.SSDCfg(n_groups=g, **SSD), tssm.SSDCfg(n_groups=g,
                                                            **SSD)
        jp = jssm.ssd_init(jax.random.PRNGKey(3), jc)
        for dt in DTYPES:
            jb = jp if dt == "float32" else _bf16(jp, keep=True)
            out[g, dt] = (jc, tc, jb, _port_params(jb))
    return out


def _x(shape, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else
                               jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16" else
                                torch.float32)
    return jx, tx


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_init_matches_jax(g, mixers):
    jc, tc, jp, _ = mixers[g, "float32"]
    tp = tssm.ssd_init(rng.PRNGKey(3), tc)
    jf, tf = _flat(jax.tree.map(np.asarray, jp)), _flat(tp)
    assert sorted(jf) == sorted(tf)
    assert tc.n_heads == jc.n_heads and tc.conv_ch == jc.conv_ch
    atol = TOLERANCES["normal_atol"][0]
    ulps = TOLERANCES["ssd_init_ulps"][0]
    for path, a in jf.items():
        b = tf[path].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if path in (("dt_bias",), ("A_log",)):
            assert _ulps(a, b) <= ulps, path
        elif np.all((a == 0) | (a == 1)):
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        else:
            std = 0.2 if path == ("conv_w",) else 0.02
            assert np.abs(a - b).max() <= atol * std, path
    # the dt draw's uniforms: bit for bit
    kj, kt = jax.random.split(jax.random.PRNGKey(3), 6)[2], \
        rng.split(rng.PRNGKey(3), 6)[2]
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(kj, (jc.n_heads,))),
        rng.uniform(kt, (tc.n_heads,), 0.0, 1.0).numpy())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("S", [16, 13], ids=["chunked", "padded"])
def test_ssd_apply_matches_jax(S, g, dtype, mixers):
    """The stateless forward: S a multiple of the chunk, and S ragged
    (padded to one and sliced back)."""
    jc, tc, jp, tp = mixers[g, dtype]
    jx, tx = _x((2, S, SSD["d_model"]), dtype)
    jy = jax.jit(jssm.ssd_apply, static_argnums=1)(jp, jc, jx)
    ty = tssm.ssd_apply(tp, tc, tx)
    assert tuple(ty.shape) == (2, S, SSD["d_model"])
    assert str(ty.dtype)[6:] == str(jy.dtype)
    assert _rel(_np(ty), jy) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_state_and_decode_match_jax(dtype, mixers):
    """``return_state``'s {'h', 'conv'}; a second call continuing from it
    (``initial_state``); three ``ssd_decode`` tokens from it; the refusal
    of ``return_state`` at a ragged S."""
    jc, tc, jp, tp = mixers[2, dtype]
    tol = _tol(dtype)
    jx, tx = _x((2, 16, SSD["d_model"]), dtype, seed=1)
    jx2, tx2 = _x((2, 8, SSD["d_model"]), dtype, seed=2)
    toks = [_x((2, 1, SSD["d_model"]), dtype, seed=10 + i) for i in range(3)]

    def run(p, x, x2, ts):
        y, st = jssm.ssd_apply(p, jc, x, return_state=True)
        y2 = jssm.ssd_apply(p, jc, x2, initial_state=st)
        dec, s = [], st
        for t in ts:
            o, s = jssm.ssd_decode(p, jc, t, s)
            dec.append((o, s))
        return y, st, y2, dec
    jy, jst, jy2, jdec = jax.jit(run)(jp, jx, jx2, [t[0] for t in toks])
    ty, tst = tssm.ssd_apply(tp, tc, tx, return_state=True)
    assert _rel(_np(ty), jy) <= tol
    assert tst["h"].dtype == torch.float32
    for k in ("h", "conv"):
        assert tuple(tst[k].shape) == jst[k].shape
        assert _rel(_np(tst[k]), jst[k]) <= tol, k
    ty2 = tssm.ssd_apply(tp, tc, tx2, initial_state=tst)
    assert _rel(_np(ty2), jy2) <= tol
    ts = tst
    for i, (t, (jo, js)) in enumerate(zip(toks, jdec)):
        to, ts = tssm.ssd_decode(tp, tc, t[1], ts)
        assert _rel(_np(to), jo) <= tol, i
        for k in ("h", "conv"):
            assert _rel(_np(ts[k]), js[k]) <= tol, (i, k)
    with pytest.raises(AssertionError, match="return_state"):
        jssm.ssd_apply(jp, jc, jx[:, :13], return_state=True)
    with pytest.raises(ValueError, match="return_state"):
        tssm.ssd_apply(tp, tc, tx[:, :13], return_state=True)


def test_decode_continues_the_chunked_scan():
    """Float32: ``ssd_apply`` over 16 tokens, then ``ssd_decode`` over 8
    more, equals ``ssd_apply`` over all 24 (the chunked scan against the
    per-token recurrence)."""
    cfg = tssm.SSDCfg(**SSD)
    p = tssm.ssd_init(rng.PRNGKey(5, device=CPU), cfg)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 24, SSD["d_model"])).astype(np.float32))
    full = tssm.ssd_apply(p, cfg, x)
    y, st = tssm.ssd_apply(p, cfg, x[:, :16], return_state=True)
    steps = [y]
    for i in range(16, 24):
        o, st = tssm.ssd_decode(p, cfg, x[:, i:i + 1], st)
        steps.append(o)
    assert _rel(torch.cat(steps, 1).numpy(), full.numpy()) <= FWD_REL


# ---------------------------------------------------------------------------
# the LMs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    """(arch, dtype) -> (JAX cfg, JAX params, port cfg, port params from
    JAX's). The JAX side runs jitted: eager, its ops compile one by one
    for each shape and dtype, several times slower at these sizes."""
    out = {}
    for arch in ARCHS:
        jc = jreg.get_smoke(arch)
        jp = jax.jit(jlm.lm_init, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jc)
        for dt in DTYPES:
            # a bf16 init is the float32 draws cast (the SSD's float32
            # leaves kept), as the reference's initialisers cast them
            jb = jp if dt == "float32" else {
                k: _bf16(v, keep=k == "blocks") for k, v in jp.items()}
            out[arch, dt] = (dataclasses.replace(jc, dtype=dt), jb,
                             dataclasses.replace(treg.get_smoke(arch),
                                                 dtype=dt),
                             _port_params(jb))
    return out


def _bf16(tree, keep=False):
    """A float32 parameter tree cast to bf16, except the SSD mixer's
    float32 leaves (``dt_bias``, ``A_log``, ``D``) where ``keep``."""
    if isinstance(tree, dict):
        return {k: (v if keep and k in ("dt_bias", "A_log", "D")
                    else _bf16(v, keep)) for k, v in tree.items()}
    return tree.astype(jnp.bfloat16)


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


PROMPT, NEW = 16, 5          # prefill 16 (two chunks of 8), then decode


@pytest.fixture(scope="module")
def jax_runs(models):
    """(arch, dtype) -> the reference's outputs on ``_tokens(vocab, (2,
    21))``: the full forward's logits, the prefill of the first 16 tokens
    and two decode steps (logits and cache after each), and greedy
    ``lm_generate`` of 5 tokens from the first 16."""
    out = {}
    for (arch, dt), (jc, jp, _, _) in models.items():
        def run(p, toks, c=jc):
            steps = [jlm.lm_prefill(p, c, toks[:, :PROMPT],
                                    max_len=PROMPT + 2)]
            for i in (PROMPT, PROMPT + 1):
                steps.append(jlm.lm_decode_step(p, c, toks[:, i:i + 1],
                                                steps[-1][1], i))
            return dict(logits=jlm.lm_apply(p, c, toks)[0], steps=steps,
                        greedy=jlm.lm_generate(p, c, toks[:, :PROMPT], NEW))
        out[arch, dt] = jax.jit(run)(
            jp, jnp.asarray(_tokens(jc.vocab, (2, PROMPT + NEW))))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_init_matches_jax(arch, models):
    jc, jp, tc, _ = models[arch, "float32"]
    tp = tlm.lm_init(rng.PRNGKey(0), tc, device=CPU)
    jf, tf = _flat(jax.tree.map(np.asarray, jp)), _flat(tp)
    assert sorted(jf) == sorted(tf)
    atol = TOLERANCES["normal_atol"][0]
    for path, a in jf.items():
        b = tf[path].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if path[-1] in ("dt_bias", "A_log"):
            assert _ulps(a, b) <= TOLERANCES["ssd_init_ulps"][0], path
        elif np.all((a == 0) | (a == 1)):
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        else:
            std = {"conv_w": 0.2}.get(path[-1], 0.02)
            assert np.abs(a - b).max() <= atol * std, path
    assert tf[("blocks", "ssm", "A_log")].shape[0] == tc.n_layers
    assert (("blocks", "attn_out_norm", "scale") in tf) == (arch ==
                                                           "hymba-1.5b")
    # bf16: the same draws cast, the SSD's float32 leaves kept
    tb = _flat(tlm.lm_init(rng.PRNGKey(0), dataclasses.replace(
        tc, dtype="bfloat16"), device=CPU))
    for path, b in tb.items():
        keep = path[-1] in ("dt_bias", "A_log", "D")
        assert b.dtype == (torch.float32 if keep else torch.bfloat16), path
        assert torch.equal(b, tf[path] if keep else
                           tf[path].bfloat16()), path


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_apply_matches_jax(arch, dtype, models, jax_runs):
    """21 tokens: the SSD pads them to 24 and slices back."""
    jc, _, tc, tp = models[arch, dtype]
    toks = _tokens(jc.vocab, (2, PROMPT + NEW))
    tl, aux = tlm.lm_apply(tp, tc, torch.from_numpy(toks))
    assert tl.shape == (2, PROMPT + NEW, jc.vocab)
    assert aux["aux_loss"] == 0.0
    assert _rel(_np(tl), jax_runs[arch, dtype]["logits"]) <= _tol(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_two_decode_steps_match_jax(arch, dtype, models,
                                                jax_runs):
    """``lm_prefill`` of 16 tokens (the window of 8 bites on hymba's
    layer 1), then two ``lm_decode_step``s, against JAX's: the logits,
    the SSD state and kv cache after each (written in place into the
    prefill's buffers; a state left unwritten fails the second step), and
    in float32 each step against the port's full forward."""
    jc, _, tc, tp = models[arch, dtype]
    tol = _tol(dtype)
    t = torch.from_numpy(_tokens(jc.vocab, (2, PROMPT + NEW)))
    ref = jax_runs[arch, dtype]["steps"]
    tl, tcache = tlm.lm_prefill(tp, tc, t[:, :PROMPT], max_len=PROMPT + 2)
    L, cfg = tc.n_layers, tc.ssd_cfg()
    assert tuple(tcache["ssm"]["h"].shape) == (L, 2, cfg.n_heads,
                                               cfg.head_dim, cfg.d_state)
    assert tuple(tcache["ssm"]["conv"].shape) == (L, 2, cfg.d_conv - 1,
                                                  cfg.conv_ch)
    assert ("kv" in tcache) == (arch == "hymba-1.5b")
    bufs = [tcache["ssm"]["h"], tcache["ssm"]["conv"]]
    full = tlm.lm_apply(tp, tc, t)[0] if dtype == "float32" else None
    for n, (jl, jcache) in enumerate(ref):
        if n:
            i = PROMPT + n - 1
            tl, tcache = tlm.lm_decode_step(tp, tc, t[:, i:i + 1], tcache, i)
            assert tcache["ssm"]["h"] is bufs[0]
            assert tcache["ssm"]["conv"] is bufs[1]
            if full is not None:
                assert _rel(tl[:, 0].numpy(), full[:, i].numpy()) <= FWD_REL
        assert _rel(_np(tl), jl) <= tol, n
        for k in ("h", "conv"):
            assert _rel(_np(tcache["ssm"][k]), jcache["ssm"][k]) <= tol, k
        if "kv" in tcache:
            for k in ("k", "v"):
                assert _rel(_np(tcache["kv"][k]), jcache["kv"][k]) <= tol
    with pytest.raises(ValueError, match="return_state"):
        tlm.lm_prefill(tp, tc, t[:, :13])


def _greedy_agree(tp, tc, prompt, jt, tt, tie):
    """Equal token streams, or a first difference where the two tokens'
    logits in the port's teacher-forced forward lie within ``tie`` of the
    largest |logit|."""
    for b in range(jt.shape[0]):
        diff = np.nonzero(jt[b] != tt[b])[0]
        if not diff.size:
            continue
        j = int(diff[0])
        seq = np.concatenate([prompt[b], tt[b, :j]])[None].astype(np.int32)
        last = _np(tlm.lm_apply(tp, tc, torch.from_numpy(seq))[0])[0, -1]
        gap = abs(last[jt[b, j]] - last[tt[b, j]]) / np.abs(last).max()
        print(f"greedy near-tie row {b} step {j}: gap {gap:.3g}")
        assert gap <= tie


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_generate_greedy_matches_jax(arch, dtype, models, jax_runs):
    jc, _, tc, tp = models[arch, dtype]
    prompt = _tokens(jc.vocab, (2, PROMPT + NEW))[:, :PROMPT]
    tt = tlm.lm_generate(tp, tc, torch.from_numpy(prompt), NEW)
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (2, NEW)
    _greedy_agree(tp, tc, prompt, np.asarray(jax_runs[arch, dtype]["greedy"]),
                  tt.numpy(), TOLERANCES["lm_greedy_near_tie_rel"][0]
                  if dtype == "float32" else BF16_REL)


# ---------------------------------------------------------------------------
# LM PTQ
# ---------------------------------------------------------------------------
def _calib(tc, n=1, seq=16, seed=5):
    pipe = TokenPipeline(vocab=tc.vocab, seq_len=seq, batch=2, seed=seed)
    return [pipe.batch_at(i)["tokens"] for i in range(n)]


@pytest.fixture(scope="module")
def mamba_ptq(models):
    """Both packages' ``run_ptq`` (tq_dit, W8A8) on one ``TokenPipeline``
    batch of 2 x 16 at ``mamba2-smoke``; the reference's marks pinned."""
    jc, jp, tc, tp = models["mamba2-130m", "float32"]
    toks = _calib(tc)
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


def test_run_ptq_matches_jax_on_mamba2(mamba_ptq):
    """5 quantized ops (each layer's ``ssm/in_proj`` and ``ssm/out_proj``,
    the tied lm_head), each packed ``int8`` for B1."""
    d = mamba_ptq
    jq, tq_, jrep, trep = d["jq"], d["tq"], d["jrep"], d["trep"]
    for k in ("n_ops", "n_quantized", "n_batches", "n_attention_einsums",
              "calib_bytes"):
        assert jrep[k] == trep[k], k
    assert sorted(jq) == sorted(tq_) == sorted(
        [f"blk{i}/ssm/{op}" for i in range(2) for op in ("in_proj",
                                                        "out_proj")]
        + ["lm_head"])
    for name in jrep["weights"]:
        np.testing.assert_array_equal(np.asarray(jrep["weights"][name]),
                                      trep["weights"][name])
    ties = []
    for name in jq:
        _check_choice(name, jq[name], tq_[name],
                      lambda qp: _lm_capture_obj(d, name, qp), ties,
                      rtol=1e-5)
    print(f"mamba2 run_ptq tq_dit: {len(ties)} near-ties {ties} "
          f"(budget {NEAR_TIE})")
    packed = ops.convert_for_kernels(tq_, trep["weights"])
    assert sum("int8" in p for p in packed.values()) == 5


def test_hymba_recording_registry_matches_jax(models):
    """The ops a hymba forward routes through the context, in order, with
    their kinds and call counts: ``attn/k`` and ``attn/v`` are called
    twice (the sequence, and the meta tokens)."""
    from repro.core.contexts import RecordingContext as JRecordingContext
    jc, jp, tc, tp = models["hymba-1.5b", "float32"]
    toks = _tokens(jc.vocab, (2, 16), seed=3)
    jrec, trec = _PinnedRecordingContext(), RecordingContext()
    assert issubclass(_PinnedRecordingContext, JRecordingContext)
    jax.jit(lambda p, t: jlm.lm_apply(p, jc, t, ctx=jrec)[0])(
        jp, jnp.asarray(toks))                     # recorded while tracing
    with torch.no_grad():
        tlm.lm_apply(tp, tc, torch.from_numpy(toks), ctx=trec)
    assert list(jrec.registry) == list(trec.registry)
    for name, ji in jrec.registry.items():
        ti = trec.registry[name]
        for f in ("kind", "a_kind", "n_calls", "spec"):
            assert getattr(ji, f, None) == getattr(ti, f, None), (name, f)
    assert trec.registry["blk0/attn/k"].n_calls == 2
    assert trec.registry["blk0/attn/v"].n_calls == 2
    assert trec.registry["blk0/ssm/in_proj"].n_calls == 1
    assert jrec.acts == trec.acts


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_context_plain_matches_fake_quant(arch, models, mamba_ptq):
    """W8A8 packs served through the kernel context's plain versions
    (every linear B1's, hymba's attention calls B3's with the meta
    prefix and the window in the mask), and the port's fake-quant context
    on the same qparams, each against JAX's fake-quant context: the
    logits and the CE; then a greedy decode on the kernel context.
    mamba2-smoke serves JAX's ``run_ptq`` qparams, hymba-smoke the
    port's, given to JAX as its own quantizers."""
    jc, jp, tc, tp = models[arch, "float32"]
    if arch == "mamba2-130m":
        jq = mamba_ptq["jq"]
        qp, weights = _to_port(jq), mamba_ptq["jrep"]["weights"]
        weights = {k: np.asarray(v) for k, v in weights.items()}
    else:
        qp, rep = run_ptq(tcalib.lm_loss_fn(tp, tc),
                          tcalib.build_lm_calibration(_calib(tc)),
                          tq_dit(8, 8, **PTQ_KW))
        jq, weights = _to_jax(qp), rep["weights"]
    packed = ops.convert_for_kernels(qp, weights)
    n = lambda key: sum(key in p for p in packed.values())
    L = tc.n_layers
    if arch == "hymba-1.5b":
        assert n("int8") == 9 * L + 1 and n("int8_qk") == n("int8_pv") == L
    toks = TokenPipeline(vocab=tc.vocab, seq_len=24, batch=2,
                         seed=5).batch_at(100)["tokens"]
    tb = tcalib.build_lm_calibration([toks])[0][0]
    jb = jcalib.build_lm_calibration([jnp.asarray(toks.numpy())])[0][0]
    jctx = JQuantContext(qparams=jq)
    jl, ce_j = jax.jit(lambda p, t, b: (
        jlm.lm_apply(p, jc, t, ctx=jctx)[0],
        jcalib.lm_loss_fn(p, jc)(jctx, b)))(jp, jnp.asarray(toks.numpy()),
                                            jb)
    ce_j = float(ce_j)
    kctx = QuantContext(qparams=packed, kernel=True)
    fctx = QuantContext(qparams=qp)
    kl, _ = tlm.lm_apply(tp, tc, toks, ctx=kctx)
    fl, _ = tlm.lm_apply(tp, tc, toks, ctx=fctx)
    tol = TOLERANCES["lm_kernel_plain_vs_jax_fq_rel"][0]
    rel_k, rel_f = _rel(kl.numpy(), jl), _rel(fl.numpy(), jl)
    print(f"{arch}: kernel context (plain) vs JAX fake-quant {rel_k:.3g}, "
          f"port fake-quant {rel_f:.3g}")
    assert rel_k <= tol and rel_f <= tol
    loss = tcalib.lm_loss_fn(tp, tc)
    ce_k, ce_f = float(loss(kctx, tb)), float(loss(fctx, tb))
    assert abs(ce_k - ce_j) <= tol * ce_j
    assert abs(ce_f - ce_j) <= tol * ce_j
    out = tlm.lm_generate(tp, tc, toks[:, :16], 3, ctx=kctx)
    assert out.shape == (2, 3) and 0 <= int(out.min()) and \
        int(out.max()) < tc.vocab
