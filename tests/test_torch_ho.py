"""The port's HO calibration (Fisher taps, alternating candidate search,
``run_ptq``, ``quantize(method="ho")``) held against the JAX package.

Tolerances:

- candidate lists: equal bit for bit (same numpy inputs);
- chosen quantizers on the same numpy inputs: equal; a choice may differ
  only at a near-tie (``ref.TOLERANCES["ho_near_tie_rel"]``): the
  objectives of the two choices, recomputed in float64 numpy, lie within
  a relative 1e-4 of each other. Near-ties are counted and printed;
- ``run_ptq`` captures through each package's own forward, so its
  candidates differ by the forwards' ulps: chosen parameters agree within
  a relative 1e-5, or the choice is a counted near-tie as above;
- Fisher gradients: every op's dL/dz within 1e-5 of its RMS, taps the
  loss does not reach zero in both;
- samples served from the two packages' HO results through the port:
  relative L2 within ``dit_forward_plain_vs_jax_rel`` (2e-2);
- ``ops.quantize_int8``: equal bit for bit.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fisher as jfisher
from repro.core import ptq as jptq
from repro.core import search as jsearch
from repro.core.baselines import SCHEMES as JSCHEMES
from repro.core.calib import dit_loss_fn
from repro.core.contexts import OpInfo as JOpInfo
from repro.core.contexts import RecordingContext as JRecordingContext
from repro.kernels import ops as jops
from repro.quant import QuantRecipe as JQuantRecipe
from repro_torch.core import fisher as tfisher
from repro_torch.core import quantizers as tq
from repro_torch.core import search as tsearch
from repro_torch.core.baselines import SCHEMES
from repro_torch.core.calib import dit_loss_fn as tdit_loss_fn
from repro_torch.core.contexts import OpInfo, QuantContext
from repro_torch.core.ptq import run_ptq
from repro_torch.diffusion.ddpm import DiffusionCfg
from repro_torch.kernels import ops
from repro_torch.kernels.ref import TOLERANCES
from repro_torch.models.dit import DiTCfg, params_from_numpy
from repro_torch.quant.api import quantize
from repro_torch.quant.recipe import QuantRecipe
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ServeEngine

NEAR_TIE = TOLERANCES["ho_near_tie_rel"][0]
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny shapes run as fast on one intra-op thread, which spares
    the cores of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# helpers: leaves, the float64 objective, near-tie counting
# ---------------------------------------------------------------------------
def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


def _leaves(q):
    if isinstance(q, dict):
        return {k: _leaves(v) for k, v in q.items()}
    if dataclasses.is_dataclass(q):
        return dict({f.name: _leaves(getattr(q, f.name))
                     for f in dataclasses.fields(q)}, cls=type(q).__name__)
    if isinstance(q, (jax.Array, np.ndarray, torch.Tensor, np.generic)):
        return _np(q)
    return q


def _same(a, b, rtol=0.0):
    """Leaf trees equal (arrays: dtype, shape, values within rtol)."""
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same(a[k], b[k], rtol)
                                              for k in a)
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.allclose(b, a, rtol=rtol, atol=0))
    return a == b


def _qdq64(q, x, g=0):
    """A quantizer of either package applied in float64 numpy."""
    name = type(q).__name__
    if name == "TGQ":
        q = q.inner
        name = type(q).__name__
        p = {f: np.float64(_np(getattr(q, f))[g]) for f in
             tq.ARRAY_FIELDS[getattr(tq, name)]}
    else:
        p = {f: _np(getattr(q, f)).astype(np.float64)
             for f in tq.ARRAY_FIELDS[getattr(tq, name)]}
    half = 2 ** (q.bits - 1)
    if name == "UniformQ":
        s, z = p["scale"], p["zero"]
        return s * (np.clip(np.round(x / s) + z, 0, 2 ** q.bits - 1) - z)
    if name == "SymQ":
        return p["scale"] * np.clip(np.round(x / p["scale"]), 1 - half,
                                    half - 1)
    if name == "ChannelQ":
        return p["scale"] * np.clip(np.round(x / p["scale"]), -half,
                                    half - 1)
    if name == "MRQSoftmaxQ":
        s1 = p["s1"]
        q1 = np.clip(np.round(x / s1), 0, half - 1) * s1
        q2 = np.clip(np.round(x * half), 0, half) / half
        return np.where(x < half * s1, q1, q2)
    sn, sp = p["s_neg"], p["s_pos"]
    return np.where(x < 0, np.clip(np.round(x / sn), -half, 0) * sn,
                    np.clip(np.round(x / sp), 0, half - 1) * sp)


def _apply64(q, x, g=0):
    return x if q is None else _qdq64(q, x, g)


def _linear_obj(qp, xs, gs, w, tgs):
    """sum_i G_i . (q(X_i) q(W) - X_i W)^2 in float64 (x_prescale folded
    in as the search does)."""
    w = np.asarray(w, np.float64)
    ps = qp.get("x_prescale")
    if ps is not None:
        ps = _np(ps).astype(np.float64)
        w = w * ps[:, None]
    wq = _apply64(qp["w"], w)
    tot = 0.0
    for x, g, tg in zip(xs, gs, tgs):
        x = np.asarray(x, np.float64)
        x = x / ps if ps is not None else x
        d2 = np.square(_apply64(qp["x"], x, tg) @ wq - x @ w)
        tot += float(np.sum(d2 if g is None else d2 * np.square(
            np.asarray(g, np.float64))))
    return tot


def _einsum_obj(qp, spec, recs, gs):
    tot = 0.0
    for r, g in zip(recs, gs):
        a, b = (np.asarray(r[k], np.float64) for k in ("a", "b"))
        y = np.einsum(spec, _apply64(qp["x"], a, r["tg"]),
                      _apply64(qp["b"], b, r["tg"]))
        d2 = np.square(y - np.einsum(spec, a, b))
        tot += float(np.sum(d2 if g is None else d2 * np.square(
            np.asarray(g, np.float64))))
    return tot


def _check_choice(name, jq, tq_, obj, ties, rtol=0.0):
    """Equal choices, or a near-tie of the float64 objective ``obj``."""
    if _same(_leaves(jq), _leaves(tq_), rtol):
        return
    ej, et = obj(jq), obj(tq_)
    rel = abs(ej - et) / max(ej, et, 1e-300)
    print(f"near-tie {name}: objective jax {ej!r} port {et!r} rel {rel:.3g}")
    assert rel <= NEAR_TIE, (name, ej, et)
    ties.append(name)


def _scfgs(bits=8):
    """(label, SearchCfg pair) for the baseline and tq_dit settings."""
    kw = dict(wbits=bits, abits=bits, rounds=2, n_alpha=4, tgq_groups=4)
    flags = {"baseline": dict(use_fisher=False, use_mrq=False,
                              use_tgq=False),
             "tq_dit": dict(use_fisher=True, use_mrq=True, use_tgq=True)}
    return {k: (jsearch.SearchCfg(**kw, **f), tsearch.SearchCfg(**kw, **f))
            for k, f in flags.items()}


# ---------------------------------------------------------------------------
# candidate generators
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 6, 4])
def test_candidate_lists_equal_jax_bit_for_bit(bits):
    rng = np.random.default_rng(bits)
    cfg_j, cfg_t = _scfgs(bits)["tq_dit"]
    cfg_j = dataclasses.replace(cfg_j, n_alpha=20)
    cfg_t = dataclasses.replace(cfg_t, n_alpha=20)
    w = (rng.standard_normal((96, 80)) * 0.05).astype(np.float32)
    w3 = (rng.standard_normal((4, 24, 6, 8)) * 0.3).astype(np.float32)
    lo, hi = float(np.float32(-1.7320508)), float(np.float32(3.14159))
    pairs = [
        (jsearch._weight_candidates(jnp.asarray(w), cfg_j),
         tsearch._weight_candidates(torch.from_numpy(w), cfg_t)),
        (jsearch._weight_candidates(jnp.asarray(w3), cfg_j,
                                    "bqhgd,bkhd->bhgqk"),
         tsearch._weight_candidates(torch.from_numpy(w3), cfg_t,
                                    "bqhgd,bkhd->bhgqk")),
        (jsearch._uniform_act_candidates(lo, hi, cfg_j),
         tsearch._uniform_act_candidates(lo, hi, cfg_t, CPU)),
        (jsearch._sym_act_candidates(hi, cfg_j),
         tsearch._sym_act_candidates(hi, cfg_t, CPU)),
        (jsearch._mrq_softmax_candidates(cfg_j),
         tsearch._mrq_softmax_candidates(cfg_t, CPU)),
        (jsearch._mrq_signed_candidates_neg(-lo, cfg_j),
         tsearch._mrq_signed_candidates_neg(-lo, cfg_t, CPU)),
        (jsearch._mrq_signed_candidates_pos(hi, cfg_j),
         tsearch._mrq_signed_candidates_pos(hi, cfg_t, CPU)),
    ]
    for i, (jc, tc) in enumerate(pairs):
        assert len(jc) == len(tc) == 20
        for a, b in zip(jc, tc):
            la, lb = _leaves(a), _leaves(b)
            assert _same(la, lb), (i, la, lb)
            for x, y in zip(jax.tree.leaves(la), jax.tree.leaves(lb)):
                if isinstance(x, np.ndarray):
                    assert x.tobytes() == y.tobytes(), i


# ---------------------------------------------------------------------------
# the op-level searches on the same numpy inputs
# ---------------------------------------------------------------------------
def _linear_inputs(a_kind, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((32, 48)).astype(np.float32) * s
          for s in (1.0, 0.5, 2.0, 1.3)]
    if a_kind == "post_gelu":
        xs = [np.asarray(jax.nn.gelu(jnp.asarray(x)), np.float32)
              for x in xs]
    gs = [(rng.standard_normal((32, 40)) * 1e-3).astype(np.float32)
          for _ in xs]
    w = (rng.standard_normal((48, 40)) * 0.1).astype(np.float32)
    return xs, gs, w, [0, 0, 1, 3]


@pytest.mark.parametrize("a_kind,fisher,setting", [
    ("plain", True, "tq_dit"), ("post_gelu", True, "tq_dit"),
    ("post_gelu", False, "tq_dit"), ("post_gelu", True, "baseline")],
    ids=["plain-fisher-tq_dit", "post_gelu-fisher-tq_dit",
         "post_gelu-mse-tq_dit", "post_gelu-baseline"])
def test_search_linear_matches_jax(a_kind, fisher, setting):
    """Under tq_dit a post-GELU input takes the MRQ-signed grid and the
    TGQ refinement; under baseline (no Fisher, no MRQ, no TGQ) the plain
    uniform grid. The first case also runs with a channel-balance
    prescale and weight-only."""
    xs, gs, w, tgs = _linear_inputs(a_kind)
    if not fisher:
        gs = [None] * len(xs)
    cfg_j, cfg_t = _scfgs()[setting]
    kw = dict(kind="linear", a_kind=a_kind, x_shape=(32, 48),
              w_shape=(48, 40))
    first = a_kind == "plain"
    runs = [dict()]
    if first:
        runs += [dict(prescale=np.linspace(0.5, 2.0, 48).astype(np.float32)),
                 dict(weight_only=True)]
    ties = []
    for extra in runs:
        jq = jsearch.search_linear(JOpInfo(name="lin", **kw), xs, gs, w,
                                   cfg_j, tgs=tgs, **extra)
        tq_ = tsearch.search_linear(OpInfo(name="lin", **kw), xs, gs, w,
                                    cfg_t, tgs=tgs, device=CPU, **extra)
        want = ("TGQ" if setting == "tq_dit" else "UniformQ",
                "MRQSignedQ" if setting == "tq_dit" and a_kind != "plain"
                else "UniformQ")
        if extra.get("weight_only"):
            assert tq_["x"] is None and jq["x"] is None
        else:
            assert type(tq_["x"]).__name__ == want[0]
            assert type(getattr(tq_["x"], "inner", tq_["x"])).__name__ \
                == want[1]
        _check_choice(f"lin {sorted(extra)}", jq, tq_,
                      lambda qp: _linear_obj(qp, xs, gs, w, tgs), ties)
    print(f"search_linear {a_kind}/{setting}: {len(ties)} near-ties")


def _attn_recs(seed=1):
    rng = np.random.default_rng(seed)
    qk, pv = [], []
    for tg in (0, 1, 1, 3):
        q = rng.standard_normal((2, 16, 2, 1, 8)).astype(np.float32)
        k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
        v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
        s = np.einsum("bqhgd,bkhd->bhgqk", q, k) / np.sqrt(8.0)
        p = np.asarray(jax.nn.softmax(jnp.asarray(s), axis=-1), np.float32)
        qk.append({"a": q, "b": k, "tg": tg})
        pv.append({"a": p, "b": v, "tg": tg})
    g_qk = [(rng.standard_normal((2, 2, 1, 16, 16)) * 1e-2
             ).astype(np.float32) for _ in qk]
    g_pv = [(rng.standard_normal((2, 16, 2, 1, 8)) * 1e-2
             ).astype(np.float32) for _ in pv]
    return qk, pv, g_qk, g_pv


@pytest.mark.parametrize("fisher,setting", [
    (True, "tq_dit"), (False, "tq_dit"), (False, "baseline")],
    ids=["fisher-tq_dit", "mse-tq_dit", "baseline"])
def test_search_einsum_matches_jax(fisher, setting):
    """qk (plain q, k: SymQ both sides) and pv (post-softmax probs: the
    TGQ-stacked MRQ softmax quantizer under tq_dit, v: SymQ)."""
    qk, pv, g_qk, g_pv = _attn_recs()
    cfg_j, cfg_t = _scfgs()[setting]
    ties = []
    for name, spec, recs, gs, a_kind in (
            ("attn/qk", "bqhgd,bkhd->bhgqk", qk, g_qk, "plain"),
            ("attn/pv", "bhgqk,bkhd->bqhgd", pv, g_pv, "post_softmax")):
        gs = gs if fisher else [None] * len(recs)
        kw = dict(kind="einsum", spec=spec, a_kind=a_kind)
        jq = jsearch.search_einsum(JOpInfo(name=name, **kw), recs, gs, cfg_j)
        tq_ = tsearch.search_einsum(OpInfo(name=name, **kw), recs, gs, cfg_t,
                                    device=CPU)
        tgq = setting == "tq_dit" and a_kind == "post_softmax"
        assert type(tq_["x"]).__name__ == ("TGQ" if tgq else
                                           type(jq["x"]).__name__)
        assert type(tq_["b"]).__name__ == "SymQ"
        _check_choice(name, jq, tq_,
                      lambda qp: _einsum_obj(qp, spec, recs, gs), ties)
    print(f"search_einsum {setting}: {len(ties)} near-ties")


def test_search_hook_act_matches_jax():
    rng = np.random.default_rng(5)
    samples = [np.asarray(jax.nn.silu(jnp.asarray(
        rng.standard_normal((24, 32)).astype(np.float32) * 3)))
        for _ in range(3)]
    cfg_j, cfg_t = _scfgs()["tq_dit"]
    jq = jsearch.search_hook_act(samples, cfg_j)
    tq_ = tsearch.search_hook_act(samples, cfg_t, device=CPU)
    X = np.concatenate(samples).astype(np.float64)
    ties = []
    _check_choice("hook", jq, tq_, lambda q: float(np.mean(np.square(
        _qdq64(q, X) - X))), ties)


# ---------------------------------------------------------------------------
# Fisher taps and run_ptq on the tiny DiT
# ---------------------------------------------------------------------------
class _PinnedRecordingContext(JRecordingContext):
    """The reference's recorder with its marked tensors kept alive, so a
    freed post-GELU tensor's ``id`` cannot be reused by a later linear's
    input and inherit the mark (ROADMAP queue 3)."""

    pinned: list = []

    def act(self, name, x, kind):
        self.pinned.append(x)
        return super().act(name, x, kind)


PTQ_KW = dict(rounds=1, n_alpha=4, tgq_groups=2, max_rows_per_batch=16)
REQS = [(0, 3, 1.5, 11), (1, 5, 1.0, 12)]       # (id, label, cfg, seed)


def _to_port(tree):
    """A JAX qparams tree as the port's (quantizer classes by name)."""
    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return getattr(tq, type(tree).__name__)(**{
            f.name: _to_port(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (jax.Array, np.ndarray)):
        return torch.from_numpy(np.array(tree))
    return tree


@pytest.fixture(scope="module")
def ho(tiny_dit):
    """Both packages' ``run_ptq`` (tq_dit) on the same two batches (2 TGQ
    groups of T = 1000, 2 samples each, drawn with numpy), the
    reference's marks pinned."""
    jcfg, jp = tiny_dit
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    tcfg = DiTCfg(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(7)
    shape = (2, jcfg.img_size, jcfg.img_size, jcfg.in_ch)
    batches = [({"xt": rng.standard_normal(shape).astype(np.float32),
                 "t": rng.integers(g * 500, (g + 1) * 500, 2),
                 "y": rng.integers(0, jcfg.n_classes, 2),
                 "noise": rng.standard_normal(shape).astype(np.float32)}, g)
               for g in (0, 1)]
    calib = [({k: jnp.asarray(v, jnp.int32 if k in ("t", "y") else None)
               for k, v in b.items()}, g) for b, g in batches]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jptq, "RecordingContext", _PinnedRecordingContext)
        jq, jrep = jptq.run_ptq(dit_loss_fn(jp, jcfg), calib,
                                JSCHEMES["tq_dit"](8, 8, **PTQ_KW))
    tcalib = [({k: torch.from_numpy(v) for k, v in b.items()}, g)
              for b, g in batches]
    tqp, trep = run_ptq(tdit_loss_fn(tp, tcfg), tcalib,
                        SCHEMES["tq_dit"](8, 8, **PTQ_KW))
    return dict(jcfg=jcfg, jp=jp, tcfg=tcfg, tp=tp, calib=calib,
                tcalib=tcalib, jq=jq, jrep=jrep, tq=tqp, trep=trep)


def test_fisher_taps_match_jax(ho):
    jcfg, jp, tcfg, tp = ho["jcfg"], ho["jp"], ho["tcfg"], ho["tp"]
    batch, tbatch = ho["calib"][1][0], ho["tcalib"][1][0]
    jloss, tloss = dit_loss_fn(jp, jcfg), tdit_loss_fn(tp, tcfg)
    jshapes = jfisher.discover_tap_shapes(jloss, batch)
    tshapes = tfisher.discover_tap_shapes(tloss, tbatch)
    assert list(jshapes) == list(tshapes)
    assert all(tuple(jshapes[n][0]) == tshapes[n][0] for n in jshapes)
    # a tap the loss never reaches: zero in both, not None in the port
    jshapes["ghost"] = ((3, 5), jnp.float32)
    tshapes["ghost"] = ((3, 5), torch.float32)
    jg = jfisher.make_fisher_fn(jloss, jshapes)(batch)
    tg = tfisher.make_fisher_fn(tloss, tshapes, device=CPU)(tbatch)
    assert sorted(jg) == sorted(tg)
    for name in jg:
        a, b = np.asarray(jg[name]), _np(tg[name])
        assert a.shape == b.shape, name
        rms = float(np.sqrt(np.mean(np.square(a))))
        if name == "ghost":
            assert rms == 0.0 and not b.any()
            continue
        assert rms > 0, name
        assert np.abs(a - b).max() <= 1e-5 * rms, name
    np.testing.assert_array_equal(tfisher.subsample_rows_like(a, 7, 3),
                                  jfisher.subsample_rows_like(a, 7, 3))


def test_run_ptq_tq_dit_matches_jax(ho):
    jq, tq_, jrep, trep = ho["jq"], ho["tq"], ho["jrep"], ho["trep"]
    for k in ("n_ops", "n_quantized", "n_batches", "n_attention_einsums",
              "calib_bytes"):
        assert jrep[k] == trep[k], k
    assert sorted(jq) == sorted(tq_)
    assert sorted(jrep["weights"]) == sorted(trep["weights"])
    for name in jrep["weights"]:
        np.testing.assert_array_equal(np.asarray(jrep["weights"][name]),
                                      trep["weights"][name])
    assert {n: (i.kind, i.a_kind, i.x_shape) for n, i in
            _pinned_registry(ho).items()} == {
        n: (i.kind, i.a_kind, i.x_shape) for n, i in
        _port_registry(ho).items()}
    ties = []
    for name in jq:
        _check_choice(name, jq[name], tq_[name],
                      lambda qp: _capture_obj(ho, name, qp), ties,
                      rtol=1e-5)
    print(f"run_ptq tq_dit: {len(ties)} near-ties {ties}")


def _pinned_registry(ho):
    rec = _PinnedRecordingContext()
    dit_loss_fn(ho["jp"], ho["jcfg"])(rec, ho["calib"][0][0])
    return rec.registry


def _capture_obj(ho, name, qp):
    """The float64 objective of ``qp`` for op ``name`` on the reference's
    own capture and normalised Fisher rows (built once, on the first
    choice that differs)."""
    from repro.core.contexts import CalibrationContext, stable_seed
    if "capture" not in ho:
        loss = dit_loss_fn(ho["jp"], ho["jcfg"])
        registry = _pinned_registry(ho)
        cal = CalibrationContext(registry=registry,
                                 max_rows_per_batch=PTQ_KW[
                                     "max_rows_per_batch"])
        fisher = jfisher.make_fisher_fn(
            loss, jfisher.discover_tap_shapes(loss, ho["calib"][0][0]))
        grads = []
        for b, tg in ho["calib"]:
            cal.begin_batch()
            loss(dataclasses.replace(cal, tgroup=tg), b)
            grads.append(fisher(b))
        ho["capture"] = (registry, cal, grads)
    registry, cal, grads = ho["capture"]
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


def _port_registry(ho):
    from repro_torch.core.contexts import RecordingContext
    rec = RecordingContext()
    with torch.no_grad():
        tdit_loss_fn(ho["tp"], ho["tcfg"])(rec, ho["tcalib"][0][0])
    return rec.registry


def test_run_ptq_result_serves_like_jax_result(ho):
    """Both packages' HO results, packed by the port, served on the CPU
    through the kernel context's plain versions."""
    dif = DiffusionCfg(T=1000, tgq_groups=2)
    out = []
    for qp, weights in ((ho["tq"], ho["trep"]["weights"]),
                        (_to_port(ho["jq"]), ho["jrep"]["weights"])):
        packed = ops.convert_for_kernels(qp, {k: np.asarray(v) for k, v in
                                              weights.items()})
        assert sum("int8" in p for p in packed.values()) == 13
        assert sum("int8_mrq" in p for p in packed.values()) == 2
        assert sum("int8_qk" in p for p in packed.values()) == 2
        eng = ServeEngine(ho["tp"], ho["tcfg"], dif,
                          ctx=QuantContext(qparams=packed, kernel=True),
                          microbatch=1, step_buckets=(4,), device=CPU)
        res = eng.serve([GenRequest(request_id=i, label=y, steps=4,
                                    cfg_scale=c, seed=s)
                         for i, y, c, s in REQS])
        out.append(np.stack([res[i].sample for i, *_ in REQS]))
    t, j = out
    rel = np.linalg.norm(t - j) / np.linalg.norm(j)
    assert np.isfinite(t).all()
    assert rel <= TOLERANCES["dit_forward_plain_vs_jax_rel"][0], rel


# ---------------------------------------------------------------------------
# quantize(method="ho") and the presets
# ---------------------------------------------------------------------------
def test_recipe_ptq_config_and_schemes_equal_jax():
    for kw in ({}, dict(bits="w4a4", rounds=2, n_alpha=8, seed=3,
                        bias_correct=True, channel_balance=True,
                        skip_patterns=("x_proj",))):
        a = JQuantRecipe(method="ho", **kw).ptq_config(7)
        b = QuantRecipe(method="ho", **kw).ptq_config(7)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert dataclasses.asdict(a.search_cfg()) == \
            dataclasses.asdict(b.search_cfg())
    assert list(JSCHEMES) == list(SCHEMES)
    for name in SCHEMES:
        assert dataclasses.asdict(JSCHEMES[name](6, 6, seed=2)) == \
            dataclasses.asdict(SCHEMES[name](6, 6, seed=2)), name


@pytest.mark.parametrize("bits", ["w8a8", "w6a6", "w4a4"])
def test_quantize_ho_packs_every_op(ho, bits):
    dif = DiffusionCfg(T=1000, tgq_groups=2)
    art = quantize(ho["tp"], ho["tcfg"], dif,
                   QuantRecipe(bits=bits, method="ho", rounds=1, n_alpha=4,
                               n_per_group=1, calib_batch=1))
    assert art.has_kernel_packs and art.fallback_ops() == []
    counts = art.packed_counts()
    family = "int4" if bits == "w4a4" else "int8"
    assert counts[f"{family}_matmul_fq"] == 13
    assert counts[f"{family}_matmul_mrq_fq"] == 2
    assert counts["flash_attn_mrq_packed_kv" if bits == "w4a4"
                  else "flash_attn_mrq"] == 2
    calib = art.meta["calib"]
    assert calib["n_batches"] == 2 and calib["n_quantized"] == 19
    assert "weights" not in calib
    # the search's own output for the post-softmax probs: a TGQ MRQ
    # softmax quantizer with one stacked s1 per group
    s1 = art.qparams["blk0/attn/pv"]["x"].inner.s1
    assert s1.dtype == torch.float32 and tuple(s1.shape) == (2,)


def test_bias_correct_and_channel_balance(ho):
    """``bias_correct`` adds the PTQD ``out_bias`` to every linear and
    ``channel_balance`` its ``x_prescale``, as the reference's presets
    (ptqd, ptq4dit) do; both still pack for the kernels."""
    for scheme, key in (("ptqd", "out_bias"), ("ptq4dit", "x_prescale")):
        qp, rep = run_ptq(tdit_loss_fn(ho["tp"], ho["tcfg"]),
                          ho["tcalib"][:1],
                          SCHEMES[scheme](8, 8, rounds=1, n_alpha=3,
                                          tgq_groups=2))
        lin = [n for n, q in qp.items() if "w" in q]
        assert lin and all(key in qp[n] for n in lin), scheme
        packed = ops.convert_for_kernels(qp, rep["weights"])
        assert all(any(k in packed[n] for k in ("int8", "int8_mrq"))
                   for n in lin), scheme


# ---------------------------------------------------------------------------
# ops.quantize_int8
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["scalar", "rows", "cols", "grid"])
def test_quantize_int8_equals_jax(case):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((6, 40)) * 4).astype(np.float32)
    shape = {"scalar": (), "rows": (6, 1), "cols": (40,),
             "grid": (6, 40)}[case]
    s = np.asarray(rng.uniform(0.01, 0.1, shape), np.float32)
    z = np.asarray(np.round(rng.uniform(60, 190, shape)), np.float32)
    want = np.asarray(jops.quantize_int8(jnp.asarray(x), jnp.asarray(s),
                                         jnp.asarray(z)))
    got = ops.quantize_int8(torch.from_numpy(x), torch.from_numpy(s),
                            torch.from_numpy(z))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 127).any() and (want == -128).any()


# ---------------------------------------------------------------------------
# the trajectory-harvest calibration set (Q-Diffusion protocol)
# ---------------------------------------------------------------------------
def test_harvest_trajectory_calibration(ho):
    """``build_dit_calibration(harvest_trajectory=True)``: per group, x_t
    harvested from the model's own sampler at t = (g + 0.5) T / G where
    the respaced chain visits it (the reference's rule, group by group);
    ``collect_xt_dataset`` sees the sampler's states in order, the first
    being its initial draw."""
    from repro.diffusion import respaced_timesteps
    from repro_torch.core.calib import build_dit_calibration as tbuild
    from repro_torch.diffusion import ddpm
    tcfg, tp = ho["tcfg"], ho["tp"]
    dif = DiffusionCfg(T=40, tgq_groups=4)
    sched = ddpm.make_schedule(dif)
    steps = 11
    use_ts = respaced_timesteps(40, steps)
    gen = torch.Generator().manual_seed(3)
    out = tbuild(tcfg, dif, sched, None, gen, n_per_group=3, batch=2,
                 device=CPU, params=tp, harvest_trajectory=True, steps=steps)
    want = [(g, int((g + 0.5) * 40 / 4)) for g in range(4)
            if int((g + 0.5) * 40 / 4) in set(use_ts.tolist())]
    assert want and len(want) < 4       # the chain skips some groups' t
    got = [(g, int(b["t"][0])) for b, g in out]
    assert got == [w for w in want for _ in (0, 1)]
    assert [b["xt"].shape[0] for b, _ in out] == [2, 1] * len(want)
    for b, _ in out:
        assert b["xt"].shape == b["noise"].shape
        assert torch.isfinite(b["xt"]).all() and (b["y"] < 8).all()
    eps = lambda x, t, y, ctx: torch.zeros_like(x)
    shape = (2, 8, 8, 4)
    tr = ddpm.collect_xt_dataset(eps, dif, sched, shape, [1, 2],
                                 torch.Generator().manual_seed(5), steps,
                                 use_ts, device=CPU)
    assert [t for _, t, _ in tr] == use_ts.tolist()
    x0 = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(tr[0][0], x0.numpy())
    final = ddpm.ddpm_sample_python(eps, dif, sched, shape, [1, 2],
                                    torch.Generator().manual_seed(5),
                                    steps=steps, device=CPU)
    assert final.shape == shape and torch.isfinite(final).all()


def ho_trained_drifts(widths=("w8a8", "w6a6", "w4a4")):
    """The CPU companion of ``chip_smoke.py``'s phase 3b: the trained
    6-layer checkpoint served through the port's kernel context (plain
    versions) fp and quantized, 8 requests x 50 steps, drift
    ``mean|fp - q| / mean|fp|`` for: the port's range and HO calibrations
    (HO with the launcher's n_alpha 8, rounds 2), JAX's HO calibration with
    the same knobs (its own draws, its marks pinned), and the reference's
    saved HO calibrations ``experiments/qparams_{tq_dit,baseline}_*_450
    .pkl`` (their own protocol: 20 or 40 batches). Run with
    ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_ho.py``."""
    import os
    import pickle

    from repro.diffusion import DiffusionCfg as JDiffusionCfg
    from repro.kernels.ops import convert_for_kernels as jconvert
    from repro.models import DiTCfg as JDiTCfg
    from repro.quant import quantize as jquantize

    jcfg = JDiTCfg(img_size=16, in_ch=4, patch=2, d_model=160, n_layers=6,
                   n_heads=4, n_classes=8)
    tcfg = DiTCfg(**dataclasses.asdict(jcfg))
    with open("experiments/dit_bench_450.pkl", "rb") as f:
        raw = pickle.load(f)
    jp = jax.tree.map(jnp.asarray, raw)
    tp = params_from_numpy(raw, device=CPU)
    dif = DiffusionCfg(T=1000, tgq_groups=10)
    reqs = [GenRequest(request_id=i, label=i % 8, steps=50, seed=100 + i)
            for i in range(8)]

    def serve(ctx):
        res = ServeEngine(tp, tcfg, dif, ctx=ctx, microbatch=4,
                          step_buckets=(50,), device=CPU).serve(reqs)
        return np.stack([res[i].sample for i in range(8)])

    fp = serve(None)
    drift = lambda q: float(np.abs(fp - q).mean() / np.abs(fp).mean())
    weights = {k: np.asarray(v) for k, v in _flat_weights(raw).items()}
    for bits in widths:
        row = {}
        for method in ("range", "ho"):
            kw = dict(n_alpha=8, rounds=2) if method == "ho" else {}
            art = quantize(tp, tcfg, dif, QuantRecipe(bits=bits,
                                                      method=method, **kw))
            row[f"port {method}"] = drift(serve(art.context()))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jptq, "RecordingContext", _PinnedRecordingContext)
            jart = jquantize(jp, jcfg, JDiffusionCfg(T=1000, tgq_groups=10),
                             JQuantRecipe(bits=bits, method="ho", n_alpha=8,
                                          rounds=2))
        row["JAX ho"] = drift(serve(QuantContext(
            qparams=_to_port(jart.qparams), kernel=True)))
        for scheme in ("tq_dit", "baseline"):
            path = f"experiments/qparams_{scheme}_{bits}_450.pkl"
            if os.path.exists(path):
                with open(path, "rb") as f:
                    saved = pickle.load(f)["qparams"]
                packed = _to_port(jconvert(saved, weights))
                row[f"saved {scheme}"] = drift(serve(QuantContext(
                    qparams=packed, kernel=True)))
        print(f"{bits}: " + ", ".join(f"{k} {v:.6f}" for k, v in
                                      row.items()), flush=True)


def _flat_weights(raw):
    """{op name: (K, N) weight} of a DiT parameter tree (numpy), as the
    capture records them."""
    out = {"x_proj": raw["x_proj"]["w"], "t_mlp1": raw["t_mlp1"]["w"],
           "t_mlp2": raw["t_mlp2"]["w"], "final_ada": raw["final_ada"]["w"],
           "final": raw["final"]["w"]}
    for op in ("ada", "qkv", "proj", "fc1", "fc2"):
        for i, w in enumerate(raw["blocks"][op]["w"]):
            out[f"blk{i}/{op}"] = w
    return out


if __name__ == "__main__":
    ho_trained_drifts()
