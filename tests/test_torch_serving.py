"""The port's sampler RNG, range calibration and sync serving held against
the JAX package, plus the port's import isolation and device defaults.

Tolerances:

- threefry keys and uint32 draws: equal; normals: within 8 ulps
  (``erfinv`` is computed differently by torch and XLA);
- range calibration derived from the same captured batches: every leaf
  equal; the port's own capture of the same calibration batches: ranges
  within relative 1e-5 (ulp-level forward differences);
- served samples (tiny DiT, 4 steps, CFG): fp within 1e-4 * max|jax|;
  fake-quant within relative L2 2e-2 (a flipped code moves an output by
  one quantization step, and the flips compound over the steps).
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.calib import build_dit_calibration, dit_loss_fn
from repro.core.contexts import CalibrationContext, RecordingContext
from repro.diffusion import DiffusionCfg as JDiffusionCfg
from repro.diffusion import make_schedule as jmake_schedule
from repro.kernels.ops import convert_for_kernels as jconvert
from repro.nn.ctx import FPContext as JFPContext
from repro.quant import QuantRecipe as JQuantRecipe, quantize as jquantize
from repro.serving import GenRequest as JGenRequest
from repro.serving import ServeEngine as JServeEngine
from repro.serving import quickcal as jquickcal
from repro_torch.diffusion import rng
from repro_torch.diffusion.ddpm import DiffusionCfg, make_schedule
from repro_torch.kernels.ops import convert_for_kernels
from repro_torch.models.dit import DiTCfg, params_from_numpy
from repro_torch.nn.ctx import FPContext
from repro_torch.quant.artifact import QuantArtifact
from repro_torch.serving.batching import GenRequest
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.quickcal import derive_qparams, range_calibrate

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---------------------------------------------------------------------------
# threefry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1234, 2 ** 32 - 1])
def test_threefry_bits_equal_jax(seed):
    k = jax.random.PRNGKey(np.uint32(seed))
    kt = rng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(k).astype(np.int64), kt.numpy())
    f, ft = jax.random.fold_in(k, 25), rng.fold_in(kt, 25)
    np.testing.assert_array_equal(np.asarray(f).astype(np.int64), ft.numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.split(f, 5)
                                             ).astype(np.int64),
                                  rng.split(ft, 5).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(f, (3, 50))).astype(np.int64),
        rng.random_bits(ft, (3, 50)).numpy())
    n = np.asarray(jax.random.normal(f, (4, 8, 8)))
    nt = rng.normal(ft, (4, 8, 8)).numpy()
    ulps = np.abs(n.view(np.int32).astype(np.int64)
                  - nt.view(np.int32).astype(np.int64))
    assert ulps.max() <= 8, ulps.max()


# ---------------------------------------------------------------------------
# range calibration
# ---------------------------------------------------------------------------
def _leaves(q):
    if isinstance(q, dict):
        return {k: _leaves(v) for k, v in q.items()}
    if dataclasses.is_dataclass(q):
        return dict({f.name: _leaves(getattr(q, f.name))
                     for f in dataclasses.fields(q)}, cls=type(q).__name__)
    if isinstance(q, (jax.Array, np.ndarray, torch.Tensor)):
        return np.asarray(q)
    return q


def _assert_tree(a, b, rtol=0.0, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_tree(a[k], b[k], rtol, f"{where}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_allclose(b, a, rtol=rtol, atol=0, err_msg=where)
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def tiny(tiny_dit):
    jcfg, jp = tiny_dit
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, DiTCfg(**dataclasses.asdict(jcfg)), tp


class _PinnedRecordingContext(RecordingContext):
    """The reference's recorder with its marked tensors kept alive, so a
    freed post-GELU tensor's ``id`` cannot be reused by a later linear's
    input and inherit the mark (see ROADMAP queue 3)."""

    pinned: list = []            # shared by the per-layer context copies

    def act(self, name, x, kind):
        self.pinned.append(x)
        return super().act(name, x, kind)


def test_range_calibrate_matches_jax_on_same_batches(tiny, monkeypatch):
    _check_range_calibrate(tiny, monkeypatch, 8)


@pytest.mark.parametrize("bits", [6, 4])
def test_range_calibrate_low_bits_matches_jax(tiny, monkeypatch, bits):
    """As at 8 bits; at 4 bits the packs are the int4 family's
    (nibble-packed weights, per-K-group scales), compared leaf by leaf."""
    _check_range_calibrate(tiny, monkeypatch, bits)


def _check_range_calibrate(tiny, monkeypatch, bits):
    jcfg, jp, tcfg, tp = tiny
    dif = JDiffusionCfg(T=1000, tgq_groups=4)
    sched = jmake_schedule(dif)
    key = jax.random.PRNGKey(3)
    monkeypatch.setattr(jquickcal, "RecordingContext",
                        _PinnedRecordingContext)
    want, _ = jquickcal.range_calibrate(jp, jcfg, dif, sched, key,
                                        wbits=bits, abits=bits,
                                        n_per_group=2, batch=2, max_rows=64)
    # the same batches and capture range_calibrate builds internally
    x0 = lambda n, k: jax.random.normal(
        k, (n, jcfg.img_size, jcfg.img_size, jcfg.in_ch))
    calib = build_dit_calibration(jp, jcfg, dif, sched, x0, key,
                                  n_per_group=2, batch=2)
    loss = dit_loss_fn(jp, jcfg)
    rec = _PinnedRecordingContext()
    loss(rec, calib[0][0])
    cal = CalibrationContext(registry=rec.registry, max_rows_per_batch=64)
    for b, tg in calib:
        cal.begin_batch()
        loss(dataclasses.replace(cal, tgroup=tg), b)
    got = derive_qparams(rec.registry, cal.store, cal.weights, 4, bits,
                         bits)
    _assert_tree(_leaves(want), _leaves(got))
    # ... and packed for the kernels, every pack leaf equal too
    jpacked = jconvert(want, cal.weights)
    packed = convert_for_kernels(got, cal.weights)
    _assert_tree(_leaves(jpacked), _leaves(packed))
    family = "int4" if bits == 4 else "int8"
    assert sum(family in qp for qp in packed.values()) == 13

    # the port's own capture (its forward, its contexts) of those batches
    tcalib = [({k: torch.from_numpy(np.asarray(v)).long() if k in ("t", "y")
                else torch.from_numpy(np.asarray(v)) for k, v in b.items()},
               tg) for b, tg in calib]
    own, _ = range_calibrate(tp, tcfg, DiffusionCfg(T=1000, tgq_groups=4),
                             make_schedule(DiffusionCfg(T=1000,
                                                        tgq_groups=4)),
                             calib=tcalib, wbits=bits, abits=bits,
                             max_rows=64)
    _assert_tree(_leaves(want), _leaves(own), rtol=1e-5)


# ---------------------------------------------------------------------------
# sync serving
# ---------------------------------------------------------------------------
REQS = [(0, 3, 1.5, 11), (1, 5, 1.0, 12)]       # (id, label, cfg, seed)


def _serve_jax(jp, jcfg, dif, ctx):
    eng = JServeEngine(jp, jcfg, dif, ctx=ctx, microbatch=1,
                       step_buckets=(4,))
    res = eng.serve([JGenRequest(request_id=i, label=y, steps=4,
                                 cfg_scale=c, seed=s) for i, y, c, s in REQS])
    return np.stack([res[i].sample for i, *_ in REQS])


def _serve_port(tp, tcfg, dif, ctx):
    eng = ServeEngine(tp, tcfg, dif, ctx=ctx, microbatch=1,
                      step_buckets=(4,), device="cpu")
    res = eng.serve([GenRequest(request_id=i, label=y, steps=4,
                                cfg_scale=c, seed=s) for i, y, c, s in REQS])
    assert eng.stats["microbatches"] == 2
    return np.stack([res[i].sample for i, *_ in REQS])


def test_serve_engine_fp_matches_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    j = _serve_jax(jp, jcfg, JDiffusionCfg(T=1000, tgq_groups=4),
                   JFPContext())
    t = _serve_port(tp, tcfg, DiffusionCfg(T=1000, tgq_groups=4),
                    FPContext())
    assert t.shape == j.shape == (2, 8, 8, 4)
    assert np.abs(t - j).max() <= 1e-4 * np.abs(j).max()


@pytest.mark.parametrize("kernel", [False, True],
                         ids=["fake_quant", "kernel_ctx"])
def test_serve_engine_quant_matches_jax_fake_quant(tiny, tmp_path, kernel):
    jcfg, jp, tcfg, tp = tiny
    dif = JDiffusionCfg(T=1000, tgq_groups=4)
    jart = jquantize(jp, jcfg, dif, JQuantRecipe(n_per_group=2,
                                                 calib_batch=2))
    jart.save(str(tmp_path))
    tart = QuantArtifact.load(str(tmp_path), device="cpu")
    j = _serve_jax(jp, jcfg, dif, jart.context(kernel=False))
    eng = ServeEngine.from_artifact(tp, tart, kernel=kernel, microbatch=1,
                                    step_buckets=(4,), device="cpu")
    res = eng.serve([GenRequest(request_id=i, label=y, steps=4, cfg_scale=c,
                                seed=s) for i, y, c, s in REQS])
    t = np.stack([res[i].sample for i, *_ in REQS])
    rel = np.linalg.norm(t - j) / np.linalg.norm(j)
    assert np.isfinite(t).all() and rel <= 2e-2, rel


# ---------------------------------------------------------------------------
# isolation and devices
# ---------------------------------------------------------------------------
def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'repro', "
        "'benchmarks') or k.startswith(('jax.', 'repro.', 'benchmarks.')))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 67


def test_entry_points_default_to_cuda_and_raise_without_it(tiny):
    from repro_torch.device import DEFAULT_DEVICE, resolve_device
    from repro_torch.models.dit import dit_init
    assert DEFAULT_DEVICE == "cuda"
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    from repro_torch.diffusion import ddpm
    from repro_torch.serving.engine import AsyncServeEngine
    _, _, tcfg, tp = tiny
    dif = DiffusionCfg(T=40, tgq_groups=4)
    sched = make_schedule(dif)
    slot = ddpm.make_slot_schedule(dif, sched, (4,), device="cpu")
    z = torch.zeros(2, dtype=torch.int64)
    for call in (lambda: resolve_device(),
                 lambda: dit_init(0, tcfg),
                 lambda: ServeEngine(tp, tcfg, DiffusionCfg()),
                 lambda: AsyncServeEngine(tp, tcfg, DiffusionCfg()),
                 lambda: QuantArtifact.load("/nonexistent"),
                 lambda: ddpm.ddpm_sample_paired(
                     None, dif, sched, (2, 8, 8, 4), [0, 1], [0, 1],
                     [1.0, 1.0], null_label=8, steps=4),
                 lambda: ddpm.make_slot_schedule(dif, sched, (4,)),
                 lambda: ddpm.ddpm_init_latent(0, 4, (8, 8, 4)),
                 lambda: ddpm.ddpm_chunk_slots(
                     None, dif, slot, torch.zeros(2, 8, 8, 4), z, z, z, z,
                     torch.ones(2), null_label=8, chunk=1)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


# ---------------------------------------------------------------------------
# quantize(): calibration batches' group tags
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ["range", "ho"])
def test_calib_data_group_tag_validation(tiny, method):
    """A ``calib_data`` group tag outside [0, G) raises ``ValueError`` in
    both packages' ``quantize``, for either method, before the method is
    dispatched (these batches would fail inside the 'ho' capture
    otherwise); overriding the group count with caller-built batches
    raises too (``tests/test_quant_api.py``'s test of the same name, on
    both packages)."""
    from repro_torch.quant.api import quantize
    from repro_torch.quant.recipe import QuantRecipe
    jcfg, jp, tcfg, tp = tiny
    fake = [({"xt": None}, 0), ({"xt": None}, 7)]      # tag 7 >= G = 4
    calls = ((jquantize, jp, jcfg, JDiffusionCfg(T=1000, tgq_groups=4),
              JQuantRecipe),
             (quantize, tp, tcfg, DiffusionCfg(T=1000, tgq_groups=4),
              QuantRecipe))
    for fn, p, cfg, dif, recipe in calls:
        with pytest.raises(ValueError, match=r"\[7\] out of range"):
            fn(p, cfg, dif, recipe(method=method), calib_data=fake)
        with pytest.raises(ValueError, match="overrides"):
            fn(p, cfg, dif, recipe(method=method, tgq_groups=2),
               calib_data=[({"xt": None}, 0)])


def test_range_quantize_ignores_calib_data(tiny):
    """The 'range' method draws its own capture set, as the reference's
    does: batches with valid tags change nothing in the artifact."""
    from repro_torch.quant.api import quantize
    from repro_torch.quant.recipe import QuantRecipe
    _, _, tcfg, tp = tiny
    dif = DiffusionCfg(T=1000, tgq_groups=4)
    recipe = QuantRecipe(bits="w8a8", n_per_group=1, calib_batch=1)
    own = quantize(tp, tcfg, dif, recipe)
    given = quantize(tp, tcfg, dif, recipe,
                     calib_data=[({"xt": None}, 0), ({"xt": None}, 3)])
    _assert_tree(_leaves(own.qparams), _leaves(given.qparams))
