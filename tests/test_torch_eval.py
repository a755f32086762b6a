"""The port's evaluation stack held against the JAX package: threefry
``randint``, the latent pipeline, the research sampler, CFG guidance,
the metrics, ``quant/eval.py`` and the quality-tables launcher.

Tolerances (``repro_torch.kernels.ref.TOLERANCES`` where not exact):

- ``rng.randint`` labels, pipeline patterns and labels, and FD / sFD /
  IS* on identical arrays: equal;
- pipeline latents: ``eval_latents_atol``;
- ``ddpm_sample`` and ``generate`` fp: ``eval_sample_atol`` (1e-4);
  fake-quant (an artifact written by JAX): ``eval_sample_fake_quant_rel``;
- one eps a TGQ group on shared inputs under the JAX-written artifact:
  ``dit_forward_plain_vs_jax_rel``;
- ``noise_mse_by_group``: ``eval_noise_mse_rel``; ``score``:
  ``eval_score_rel``, and of one set on either package's assets
  ``eval_score_assets_rel``;
- ``generate_grouped`` with a constant map against ``generate``: equal
  bit for bit (one loop).
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmetrics
from repro.data import LatentPipeline as JLatentPipeline
from repro.diffusion import DiffusionCfg as JDiffusionCfg
from repro.diffusion import ddpm_sample as jddpm_sample
from repro.diffusion import make_schedule as jmake_schedule
from repro.models.dit import dit_apply as jdit_apply
from repro.models.dit import dit_apply_cfg_guidance as jcfg_guidance
from repro.nn.ctx import FPContext as JFPContext
from repro.quant import QuantRecipe as JQuantRecipe
from repro.quant import eval as jeval
from repro.quant.artifact import QuantArtifact as JQuantArtifact
from repro.serving.quickcal import range_calibrate as jrange_calibrate
from repro_torch.core import metrics
from repro_torch.data.synthetic import LatentPipeline
from repro_torch.diffusion import rng
from repro_torch.diffusion.ddpm import (
    DiffusionCfg, ddpm_sample, make_schedule,
)
from repro_torch.kernels.ref import TOLERANCES
from repro_torch.launch import tables
from repro_torch.models.dit import (
    DiTCfg, dit_apply, dit_apply_cfg_guidance, params_from_numpy,
)
from repro_torch.nn.ctx import FPContext
from repro_torch.quant import eval as qeval
from repro_torch.quant.api import quantize
from repro_torch.quant.artifact import QuantArtifact
from repro_torch.quant.recipe import QuantRecipe

CPU = "cpu"
JDIF = JDiffusionCfg(T=40, tgq_groups=4)
DIF = DiffusionCfg(T=40, tgq_groups=4)
GEN = dict(steps=4, n=8, seed=3, batch=8)
TOL = {k: v[0] for k, v in TOLERANCES.items()}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny shapes run as fast on one torch intra-op thread and one
    BLAS thread (numpy's OpenBLAS spins its idle threads through the
    metrics' small products), which spares the other test workers'
    cores."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both(tiny_dit, tmp_path_factory):
    """Both packages' tiny DiT, a W8A8 range artifact written by JAX and
    read by the port, and the JAX side's results, computed once (the
    fake-quant forwards first, so the fp ones reuse JAX's op caches).
    The artifact holds the range calibration's qparams without the
    kernel packs, which fake-quant does not read (JAX's
    ``convert_for_kernels`` would add 6 s of compiling)."""
    jcfg, jp = tiny_dit
    tcfg = DiTCfg(**dataclasses.asdict(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    jqp, _ = jrange_calibrate(jp, jcfg, JDIF, jmake_schedule(JDIF),
                              jax.random.PRNGKey(0), n_per_group=1, batch=1)
    jart = JQuantArtifact(qparams=jqp, recipe=JQuantRecipe(bits="w8a8"))
    path = str(tmp_path_factory.mktemp("eval_art") / "w8a8")
    jart.save(path)
    tart = QuantArtifact.load(path, device=CPU)
    jctx = {"fp": JFPContext(), "fake_quant": jart.context(kernel=False)}
    tctx = {"fp": FPContext(), "fake_quant": tart.context(kernel=False)}
    jres = {}
    for kind in ("fake_quant", "fp"):
        jres[kind, "mse"] = jeval.noise_mse_by_group(jp, jcfg, JDIF,
                                                     jctx[kind], n=8)
        jres[kind, "gen"] = jeval.generate(jp, jcfg, JDIF, ctx=jctx[kind],
                                           **GEN)
    return dict(jcfg=jcfg, jp=jp, tcfg=tcfg, tp=tp, jctx=jctx, tctx=tctx,
                jres=jres)


# ---------------------------------------------------------------------------
# threefry randint and the latent pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lo,hi", [(0, 8), (0, 1000), (0, 2 ** 31 - 1),
                                   (7, 1000), (-5, 3), (250, 500),
                                   (100, 100), (100, 50)],
                         ids=["span8", "span1000", "span2^31-1", "min7",
                              "negative", "group_range", "empty",
                              "reversed"])
def test_randint_equals_jax(lo, hi):
    for seed in (0, 123):
        j = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (5, 77),
                                          lo, hi))
        t = rng.randint(rng.PRNGKey(seed), (5, 77), lo, hi)
        np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))
        assert int(t.min()) >= min(lo, hi) and (hi <= lo or
                                                int(t.max()) < hi)


def test_latent_pipeline_matches_jax():
    # 64 latents: the shapes eval_assets(n_real=64) draws, so JAX
    # compiles them once
    jp = JLatentPipeline(8, 4, 8, seed=11, noise=0.3)
    tp = LatentPipeline(8, 4, 8, seed=11, noise=0.3)
    np.testing.assert_array_equal(tp.patterns, jp.patterns)
    jx, jy = jp.labeled_set(64, jax.random.PRNGKey(3))
    tx, ty = tp.labeled_set(64, rng.PRNGKey(3, device=CPU))
    np.testing.assert_array_equal(ty, jy)
    assert tx.dtype == jx.dtype and tx.shape == jx.shape
    assert np.abs(tx - jx).max() <= TOL["eval_latents_atol"]


# ---------------------------------------------------------------------------
# the research sampler and CFG guidance
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("clip_x0", [None, 0.5], ids=["no_clip", "clip"])
def test_ddpm_sample_fp_matches_jax(both, clip_x0):
    """The chain of ``generate``'s one batch: labels and key from
    ``split(PRNGKey(seed), 3)``. Unclipped, JAX's side is the fixture's
    fp ``generate`` (its ``ddpm_sample`` on these labels and key)."""
    b = both
    shape = (GEN["batch"], 8, 8, 4)
    _, k1, k2 = rng.split(rng.PRNGKey(GEN["seed"]), 3)
    y = rng.randint(k1, (GEN["batch"],), 0, 8)
    if clip_x0 is None:
        j = b["jres"]["fp", "gen"][0]
    else:
        _, _, jk2 = jax.random.split(jax.random.PRNGKey(GEN["seed"]), 3)
        j = np.asarray(jddpm_sample(
            lambda x, t, yy, c: jdit_apply(b["jp"], b["jcfg"], x, t, yy,
                                           ctx=c),
            JDIF, jmake_schedule(JDIF), shape, jnp.asarray(y.numpy()), jk2,
            steps=GEN["steps"], clip_x0=clip_x0))
    t = ddpm_sample(
        lambda x, tt, yy, c: dit_apply(b["tp"], b["tcfg"], x, tt, yy, ctx=c),
        DIF, make_schedule(DIF), shape, y, k2, steps=GEN["steps"],
        clip_x0=clip_x0, device=CPU)
    assert t.dtype == torch.float32 and t.shape == j.shape
    assert np.abs(t.numpy() - j).max() <= TOL["eval_sample_atol"]


def test_cfg_guidance_matches_jax(both):
    b = both
    # one row, two with the null half: the shapes noise_mse_by_group's
    # fp forwards compiled
    x = np.random.default_rng(0).standard_normal((1, 8, 8, 4)).astype(
        np.float32)
    t, y = np.array([17]), np.array([5])
    j = np.asarray(jcfg_guidance(b["jp"], b["jcfg"], jnp.asarray(x),
                                 jnp.asarray(t, jnp.int32),
                                 jnp.asarray(y, jnp.int32), 1.5))
    tt = dit_apply_cfg_guidance(b["tp"], b["tcfg"], torch.from_numpy(x),
                                torch.from_numpy(t), torch.from_numpy(y),
                                1.5).numpy()
    assert np.abs(tt - j).max() <= 1e-5 * np.abs(j).max()


# ---------------------------------------------------------------------------
# metrics: numpy copies, the same arrays give the same scores
# ---------------------------------------------------------------------------
def test_metrics_equal_jax_on_identical_arrays():
    g = np.random.default_rng(4)
    real = g.standard_normal((200, 8, 8, 4)).astype(np.float32)
    gen = (real + 0.3 * g.standard_normal(real.shape)).astype(np.float32)
    labels = g.integers(0, 8, 200)
    jnet, tnet = (m.FeatureNet.make(256, seed=5) for m in (jmetrics, metrics))
    np.testing.assert_array_equal(tnet.w1, jnet.w1)
    np.testing.assert_array_equal(tnet(real), jnet(real))
    jq, tq = (m.FeatureNet.make(64, seed=6) for m in (jmetrics, metrics))
    np.testing.assert_array_equal(metrics.spatial_features(real, tq),
                                  jmetrics.spatial_features(real, jq))
    f = tnet(real)
    for a, b in zip(metrics.gaussian_stats(f), jmetrics.gaussian_stats(f)):
        np.testing.assert_array_equal(a, b)
    assert metrics.fd_score(real, gen, tnet) == jmetrics.fd_score(real, gen,
                                                                  jnet)
    assert metrics.sfd_score(real, gen) == jmetrics.sfd_score(real, gen)
    tp = metrics.ClassProxy.fit(real, labels, 8, net=tnet)
    jp = jmetrics.ClassProxy.fit(real, labels, 8, net=jnet)
    np.testing.assert_array_equal(tp.prec, jp.prec)
    assert tp.logdet == jp.logdet
    assert (metrics.inception_score_proxy(gen, tp)
            == jmetrics.inception_score_proxy(gen, jp))


def test_frechet_distance_without_sqrtm_disp(monkeypatch):
    """SciPy releases without sqrtm's ``disp`` argument give the same
    distance."""
    g = np.random.default_rng(5)
    f1 = g.standard_normal((300, 8))
    f2 = f1 + 0.3 * g.standard_normal((300, 8))
    want = jmetrics.frechet_distance(*jmetrics.gaussian_stats(f1),
                                     *jmetrics.gaussian_stats(f2))
    sqrtm = metrics.scipy.linalg.sqrtm
    monkeypatch.setattr(metrics.scipy.linalg, "sqrtm",
                        lambda a, blocksize=64: sqrtm(a, disp=False)[0])
    assert metrics.frechet_distance(*metrics.gaussian_stats(f1),
                                    *metrics.gaussian_stats(f2)) == want


# ---------------------------------------------------------------------------
# asset cache keying (mirrors tests/test_eval_lib.py)
# ---------------------------------------------------------------------------
def test_asset_cache_hit_same_key(both):
    cfg = both["tcfg"]
    a = qeval.eval_assets(cfg, n_real=32, device=CPU)
    b = qeval.eval_assets(cfg, n_real=32, device=CPU)
    assert a[0] is b[0] and a[2] is b[2]


def test_asset_cache_distinguishes_seeds(both):
    cfg = both["tcfg"]
    a_real, _, a_net, _ = qeval.eval_assets(cfg, n_real=32, data_seed=1,
                                            device=CPU)
    b_real, _, b_net, _ = qeval.eval_assets(cfg, n_real=32, data_seed=2,
                                            device=CPU)
    assert a_real is not b_real and not np.allclose(a_real, b_real)
    c_real, _, c_net, _ = qeval.eval_assets(cfg, n_real=32, data_seed=1,
                                            net_seed=7, device=CPU)
    assert c_net is not a_net
    assert not np.array_equal(c_net.w1, a_net.w1)


def test_asset_cache_distinguishes_model_cfg_and_device(both):
    cfg = both["tcfg"]
    other = dataclasses.replace(cfg, img_size=16)
    a_real, *_ = qeval.eval_assets(cfg, n_real=16, device=CPU)
    b_real, *_ = qeval.eval_assets(other, n_real=16, device=CPU)
    assert a_real.shape != b_real.shape
    key = qeval.asset_cache_key(cfg, 16, 999, 1234, 11, 0.3, "cpu")
    assert key in qeval._ASSET_CACHE
    assert qeval.asset_cache_key(cfg, 16, 999, 1234, 11, 0.3, "cuda") != key


def test_asset_cache_clear(both):
    cfg = both["tcfg"]
    a = qeval.eval_assets(cfg, n_real=16, device=CPU)
    qeval.clear_eval_caches()
    b = qeval.eval_assets(cfg, n_real=16, device=CPU)
    assert a[0] is not b[0]
    np.testing.assert_array_equal(a[0], b[0])


def test_eval_assets_match_jax(both):
    """Real latents within eval_latents_atol, labels equal; one
    generated set scores alike on either package's assets."""
    ja = jeval.eval_assets(both["jcfg"], n_real=64)
    ta = qeval.eval_assets(both["tcfg"], n_real=64, device=CPU)
    np.testing.assert_array_equal(ta[1], ja[1])
    assert np.abs(ta[0] - ja[0]).max() <= TOL["eval_latents_atol"]
    gen = both["jres"]["fp", "gen"][0]
    rel = TOL["eval_score_assets_rel"]
    for f in (lambda a: metrics.fd_score(a[0], gen, a[2]),
              lambda a: metrics.sfd_score(a[0], gen),
              lambda a: metrics.inception_score_proxy(gen, a[3])):
        assert f(ta) == pytest.approx(f(ja), rel=rel)


# ---------------------------------------------------------------------------
# generate, score, noise_mse_by_group against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["fp", "fake_quant"])
def test_generate_and_score_match_jax(both, kind):
    jgen, jlab = both["jres"][kind, "gen"]
    tgen, tlab = qeval.generate(both["tp"], both["tcfg"], DIF,
                                ctx=both["tctx"][kind], device=CPU, **GEN)
    np.testing.assert_array_equal(tlab, jlab)
    assert tgen.dtype == np.float32 and tgen.shape == jgen.shape
    if kind == "fp":
        assert np.abs(tgen - jgen).max() <= TOL["eval_sample_atol"]
    else:
        rel = lambda a: np.linalg.norm(a - jgen) / np.linalg.norm(jgen)
        assert rel(tgen) <= TOL["eval_sample_fake_quant_rel"], rel(tgen)
        # the bound tells a chain that ignores the artifact from one that
        # applies it: the port's fp chain lies outside it
        tfp, _ = qeval.generate(both["tp"], both["tcfg"], DIF,
                                ctx=both["tctx"]["fp"], device=CPU, **GEN)
        assert rel(tfp) > TOL["eval_sample_fake_quant_rel"], rel(tfp)
    js = jeval.score(jgen, both["jcfg"], n_real=64)
    ts = qeval.score(tgen, both["tcfg"], n_real=64, device=CPU)
    assert set(ts) == {"FD", "sFD", "IS*"}
    for k in ts:
        assert ts[k] == pytest.approx(js[k], rel=TOL["eval_score_rel"]), k


@pytest.mark.parametrize("kind", ["fp", "fake_quant"])
def test_noise_mse_by_group_matches_jax(both, kind):
    j = both["jres"][kind, "mse"]
    t = qeval.noise_mse_by_group(both["tp"], both["tcfg"], DIF,
                                 both["tctx"][kind], n=8, device=CPU)
    assert len(t) == len(j) == DIF.tgq_groups
    if kind == "fp":
        assert t == j == [0.0] * DIF.tgq_groups
    else:
        np.testing.assert_allclose(t, j, rtol=TOL["eval_noise_mse_rel"])
        assert all(v > 0 for v in t)
    assert qeval.noise_mse(both["tp"], both["tcfg"], DIF, both["tctx"][kind],
                           n=8, device=CPU) == pytest.approx(np.mean(t))


def test_quantized_eps_per_group_matches_jax(both):
    """The quantized chain's forward on shared inputs, one a TGQ group
    (two rows: the shapes noise_mse_by_group's forwards compiled)."""
    x = np.random.default_rng(1).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    y = np.arange(2)
    for g in range(DIF.tgq_groups):
        t = np.full(2, g * 10 + 3)
        j = np.asarray(jdit_apply(
            both["jp"], both["jcfg"], jnp.asarray(x),
            jnp.asarray(t, jnp.int32), jnp.asarray(y, jnp.int32),
            ctx=both["jctx"]["fake_quant"].with_tgroup(g)))
        tt = dit_apply(both["tp"], both["tcfg"], torch.from_numpy(x),
                       torch.from_numpy(t), torch.from_numpy(y),
                       ctx=both["tctx"]["fake_quant"].with_tgroup(g)).numpy()
        rel = np.linalg.norm(tt - j) / np.linalg.norm(j)
        assert rel <= TOL["dit_forward_plain_vs_jax_rel"], (g, rel)


# ---------------------------------------------------------------------------
# generate_grouped: one loop with generate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["fp", "fake_quant"])
def test_generate_grouped_constant_map_bit_for_bit(both, kind):
    ctx = both["tctx"][kind]
    a, la = qeval.generate(both["tp"], both["tcfg"], DIF, ctx=ctx,
                           device=CPU, **GEN)
    b, lb = qeval.generate_grouped(both["tp"], both["tcfg"], DIF,
                                   [ctx] * DIF.tgq_groups, device=CPU, **GEN)
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(a, b)


def test_generate_grouped_mixed_map(both):
    """W8A8 on groups 0-1 and W4A4 on groups 2-3: the chain runs and
    differs from the uniform W8A8 one; a dict map equals a list map."""
    ctx8 = both["tctx"]["fake_quant"]
    ctx4 = quantize(both["tp"], both["tcfg"], DIF,
                    QuantRecipe(bits="w4a4", n_per_group=1, calib_batch=1)
                    ).context(kernel=True)
    cmap = [ctx8, ctx8, ctx4, ctx4]
    kw = dict(GEN, n=4)
    mixed, _ = qeval.generate_grouped(both["tp"], both["tcfg"], DIF, cmap,
                                      device=CPU, **kw)
    as_dict, _ = qeval.generate_grouped(both["tp"], both["tcfg"], DIF,
                                        dict(enumerate(cmap)), device=CPU,
                                        **kw)
    uni8, _ = qeval.generate(both["tp"], both["tcfg"], DIF, ctx=ctx8,
                             device=CPU, **kw)
    np.testing.assert_array_equal(mixed, as_dict)
    assert np.isfinite(mixed).all() and mixed.shape == uni8.shape
    assert not np.allclose(mixed, uni8, atol=1e-6)


def test_eval_entry_points_default_to_cuda(both):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        qeval.generate(both["tp"], both["tcfg"], DIF, n=1, steps=1)
    with pytest.raises(RuntimeError, match="cuda"):
        qeval.noise_mse_by_group(both["tp"], both["tcfg"], DIF, FPContext(),
                                 n=4)


# ---------------------------------------------------------------------------
# the tables launcher
# ---------------------------------------------------------------------------
def test_tables_smoke_writes_tables_1_and_3b(tmp_path, capsys):
    out = tmp_path / "tables.json"
    tables.main(["--smoke", "--device", CPU, "--tables", "1,3b",
                 "--out", str(out)])
    d = json.loads(out.read_text())
    assert d["card"] == "cpu" and d["smoke"] is True
    assert sorted(d["tables"]) == ["table1", "table3b"]
    t1, t3b = d["tables"]["table1"], d["tables"]["table3b"]
    assert [r[:2] for r in t1[1:]] == [["32/32", "FP"]] + [
        [f"{b}/{b}", s] for b in (8, 6) for s in tables.QUALITY]
    assert [r[0] for r in t3b[1:]] == ["FP"] + tables.ABLATION
    for r in t1[1:]:
        assert all(np.isfinite(v) for v in r[2:])
    assert all(r[-1] > 0 for r in t3b[2:])          # ops on the kernels
    assert "table1" in capsys.readouterr().out


def test_tables_serve_saved_qparams(tmp_path, capsys):
    """``--qparams DIR``: a saved calibration in the reference's artifact
    format stands in for its (scheme, bits); the others calibrate."""
    import os
    import pickle

    from repro_torch.serving.quickcal import range_calibrate
    with open(os.path.join(tables.ROOT, "experiments", tables.SMOKE.ckpt),
              "rb") as f:
        params = params_from_numpy(pickle.load(f), device=CPU)
    qp, _ = range_calibrate(params, tables.SMOKE_DIT, tables.SMOKE.dif,
                            wbits=4, abits=4, n_per_group=1, batch=1)
    saved = tmp_path / "saved"
    QuantArtifact(qparams=qp, recipe=QuantRecipe(bits="w4a4")).save(
        str(saved / tables.qparams_name("baseline", 4)))
    out = tmp_path / "tables.json"
    tables.main(["--smoke", "--device", CPU, "--tables", "3b",
                 "--qparams", str(saved), "--out", str(out)])
    printed = capsys.readouterr().out
    assert printed.count(": serving ") == 1
    assert "baseline W4A4: serving" in printed
    d = json.loads(out.read_text())
    assert d["qparams"] == str(saved)
    rows = d["tables"]["table3b"]
    assert [r[0] for r in rows[1:]] == ["FP"] + tables.ABLATION
    assert all(np.isfinite(v) for r in rows[1:] for v in r[1:])
    assert all(r[-1] > 0 for r in rows[2:])


def trained_fp_scores():
    """The tables' FP row on the trained checkpoint, from both packages
    on the CPU (128 samples x 40 steps, batches of 64, 1,024 real
    latents): (JAX's scores, the port's, max |port - jax| sample,
    labels equal)."""
    import os
    import pickle

    from repro.models import DiTCfg as JDiTCfg
    with open(os.path.join(tables.ROOT, "experiments",
                           "dit_bench_450.pkl"), "rb") as f:
        raw = pickle.load(f)
    jcfg = JDiTCfg(**dataclasses.asdict(tables.BENCH_DIT))
    proto = dict(steps=40, n=128, seed=123, batch=64)
    jgen, jlab = jeval.generate(raw, jcfg, JDiffusionCfg(T=1000,
                                                         tgq_groups=10),
                                **proto)
    tgen, tlab = qeval.generate(params_from_numpy(raw, device=CPU),
                                tables.BENCH_DIT, tables.DIF, device=CPU,
                                **proto)
    return (jeval.score(jgen, jcfg), qeval.score(tgen, tables.BENCH_DIT,
                                                 device=CPU),
            float(np.abs(tgen - jgen).max()), bool((tlab == jlab).all()))


def reference_w4a4_rows(out_dir, schemes=tables.ABLATION):
    """Table III-b's quantized rows from the reference's own saved W4A4
    calibrations (``experiments/qparams_{scheme}_w4a4_450.pkl``, which
    its benchmarks load where present), fake-quant on the CPU: JAX's
    chain, and the port's on the same qparams, which JAX writes to
    ``out_dir`` as artifacts named like the pickles (the port reads them;
    ``python -m repro_torch.launch.tables --qparams out_dir`` serves them
    through the kernels). Rows of (scheme, source, FD, sFD, IS*, noise
    MSE)."""
    import os
    import pickle

    from repro.core import QuantContext as JQuantContext
    from repro.models import DiTCfg as JDiTCfg
    from repro.quant.artifact import QuantArtifact as JQuantArtifact
    from repro_torch.core.contexts import QuantContext

    exp = os.path.join(tables.ROOT, "experiments")
    with open(os.path.join(exp, "dit_bench_450.pkl"), "rb") as f:
        raw = pickle.load(f)
    jcfg = JDiTCfg(**dataclasses.asdict(tables.BENCH_DIT))
    jdif = JDiffusionCfg(T=1000, tgq_groups=10)
    cfg, dif = tables.BENCH_DIT, tables.DIF
    tp = params_from_numpy(raw, device=CPU)
    proto = dict(steps=40, n=128, seed=123, batch=64)
    rows = []
    for scheme in schemes:
        name = tables.qparams_name(scheme, 4)
        with open(os.path.join(exp, name + ".pkl"), "rb") as f:
            jqp = pickle.load(f)["qparams"]
        path = os.path.join(out_dir, name)
        JQuantArtifact(qparams=jqp, recipe=JQuantRecipe(bits="w4a4")
                       ).save(path)
        tqp = QuantArtifact.load(path, device=CPU).qparams
        jctx, tctx = JQuantContext(qparams=jqp), QuantContext(qparams=tqp)
        gen, _ = jeval.generate(raw, jcfg, jdif, ctx=jctx, **proto)
        s = jeval.score(gen, jcfg)
        rows.append((scheme, "jax fake-quant", s["FD"], s["sFD"], s["IS*"],
                     round(jeval.noise_mse(raw, jcfg, jdif, jctx), 6)))
        print(",".join(str(v) for v in rows[-1]), flush=True)
        gen, _ = qeval.generate(tp, cfg, dif, ctx=tctx, device=CPU, **proto)
        s = qeval.score(gen, cfg, device=CPU)
        rows.append((scheme, "port fake-quant", s["FD"], s["sFD"], s["IS*"],
                     round(qeval.noise_mse(tp, cfg, dif, tctx, device=CPU),
                           6)))
        print(",".join(str(v) for v in rows[-1]), flush=True)
    return rows


def fresh_w4a4_rows(scheme="baseline"):
    """One scheme's W4A4 calibration run afresh on the CPU by the
    reference's current code (its benchmarks' calibration set and
    knobs) and by the port, both fake-quant: JAX's run_ptq on JAX's set,
    the port's run_ptq on the same set, the port's run_ptq on its own
    set (``tables.Bench``). Prints each row beside the largest change
    of any qparams leaf from the saved ``qparams_{scheme}_w4a4_450.pkl``
    (JAX's calibration) or from JAX's fresh one (the port's)."""
    import os
    import pickle

    from repro.core import QuantContext as JQuantContext
    from repro.core.baselines import SCHEMES as JSCHEMES
    from repro.core.calib import build_dit_calibration as jbuild
    from repro.core.calib import dit_loss_fn as jloss_fn
    from repro.core.ptq import run_ptq as jrun_ptq
    from repro.models import DiTCfg as JDiTCfg
    from repro_torch.core.baselines import SCHEMES
    from repro_torch.core.calib import dit_loss_fn
    from repro_torch.core.contexts import QuantContext
    from repro_torch.core.ptq import run_ptq

    exp = os.path.join(tables.ROOT, "experiments")
    with open(os.path.join(exp, "dit_bench_450.pkl"), "rb") as f:
        raw = pickle.load(f)
    name = tables.qparams_name(scheme, 4) + ".pkl"
    with open(os.path.join(exp, name), "rb") as f:
        saved = pickle.load(f)["qparams"]
    jp = jax.tree.map(jnp.asarray, raw)
    jcfg = JDiTCfg(**dataclasses.asdict(tables.BENCH_DIT))
    jdif = JDiffusionCfg(T=1000, tgq_groups=10)
    cfg, dif = tables.BENCH_DIT, tables.DIF
    tp = params_from_numpy(raw, device=CPU)
    proto = dict(steps=40, n=128, seed=123, batch=64)
    knobs = dict(tgq_groups=10, n_alpha=8, rounds=2, max_rows_per_batch=96)
    pipe = jeval.make_pipeline(jcfg, pipe_seed=11, pipe_noise=0.3)
    jcalib = jbuild(jp, jcfg, jdif, jmake_schedule(jdif),
                    lambda n, k: pipe.sample(n, k)[0], jax.random.PRNGKey(3),
                    n_per_group=32, batch=8)
    tcalib = [({k: torch.from_numpy(np.asarray(v)) for k, v in b.items()},
               g) for b, g in jcalib]

    def leaves(qp):
        """The arrays of either package's qparams, in field order."""
        if isinstance(qp, dict):
            return [x for k in sorted(qp) for x in leaves(qp[k])]
        if isinstance(qp, (list, tuple)):
            return [x for v in qp for x in leaves(v)]
        if dataclasses.is_dataclass(qp):
            return [x for f in dataclasses.fields(qp)
                    for x in leaves(getattr(qp, f.name))]
        if isinstance(qp, torch.Tensor):
            qp = qp.cpu().numpy()
        return [np.asarray(qp, np.float64)]

    def moved(a, b):
        la, lb = leaves(a), leaves(b)
        if [x.shape for x in la] != [x.shape for x in lb]:
            return "structure differs"
        return max(float(np.abs(x - y).max()) if x.size else 0.0
                   for x, y in zip(la, lb))

    def trow(ctx):
        gen, _ = qeval.generate(tp, cfg, dif, ctx=ctx, device=CPU, **proto)
        s = qeval.score(gen, cfg, device=CPU)
        return s["FD"], s["sFD"], s["IS*"], round(qeval.noise_mse(
            tp, cfg, dif, ctx, device=CPU), 6)

    jqp, _ = jrun_ptq(jloss_fn(jp, jcfg), jcalib,
                      JSCHEMES[scheme](4, 4, **knobs))
    gen, _ = jeval.generate(jp, jcfg, jdif, ctx=JQuantContext(qparams=jqp),
                            **proto)
    s = jeval.score(gen, jcfg)
    print(f"{scheme},jax run_ptq on jax's set,{s['FD']},{s['sFD']},"
          f"{s['IS*']},{round(jeval.noise_mse(jp, jcfg, jdif, JQuantContext(qparams=jqp)), 6)},"
          f"max leaf change from the saved pkl {moved(jqp, saved)}",
          flush=True)
    for label, calib in (("port run_ptq on jax's set", tcalib),
                         ("port run_ptq on its own set",
                          tables.Bench(tables.Protocol(), CPU).calib)):
        tqp, _ = run_ptq(dit_loss_fn(tp, cfg), calib,
                         SCHEMES[scheme](4, 4, **knobs), device=CPU)
        row = trow(QuantContext(qparams=tqp))
        print(f"{scheme},{label}," + ",".join(str(v) for v in row)
              + f",max leaf change from jax's fresh {moved(tqp, jqp)}",
              flush=True)


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["fresh"]:
        fresh_w4a4_rows()
        sys.exit()

    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_eval.py
    #   [w4a4 OUT_DIR | fresh]
    if sys.argv[1:2] == ["w4a4"]:
        print("scheme,source,FD,sFD,IS*,noiseMSE")
        reference_w4a4_rows(sys.argv[2])
        sys.exit()
    js, ts, dmax, same = trained_fp_scores()
    print(f"trained checkpoint FP, 128 x 40 steps: JAX {js}; port {ts}; "
          f"max |port - jax| sample {dmax:.3g}; labels equal {same}")
