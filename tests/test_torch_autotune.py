"""The port's recipe auto-search (``repro_torch.autotune`` and
``python -m repro_torch.launch.autotune``) held against ``repro.autotune``.

1. Pure parity on the same inputs: ``expand`` (keys, labels, ``to_dict``),
   the space and eval-protocol hashes, the validation errors, the
   allocator, the stage-1 gate, the Pareto frontier (hypothesis-fuzzed)
   and the throughput expressions — a table holding the reference's
   modelled step times gives its floats bit for bit.
2. Driver bookkeeping: both drivers run one sweep with the same
   deterministic stubs for ``quantize``, ``QuantArtifact.load``,
   ``stage1`` and ``stage2``; the ledgers, ``BENCH_autotune.json`` and
   ``report.md`` agree apart from the port's throughput row and key, the
   word "measured" and the "Measured on" section.
3. The port's own sweep on the CPU (``experiments/dit_tiny_200.pkl``, the
   reference test's space and protocol): kill, resume, pure cache hit,
   byte-identical outputs, a truncated tail, changed inputs failing fast,
   the mixed allocation; the throughput measured once (on the CPU, at the
   smoke config) and replayed by every resume; every frontier artifact
   loads in both packages.
4. ``measure_step_s`` on the CPU, ``serve_n_dev`` other than 1, and the
   launcher's ``main`` (kill, full run, ``--assert-resumed``; ``--arch
   tiny --train-steps 3`` trains and caches a checkpoint the reference
   loads).

Every comparison is exact. The file runs on one torch and one BLAS
thread (~10 s serial).
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import itertools
import json
import os
import pickle
import random
import shutil

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from benchmarks import serve_throughput as jst
from repro import autotune as jat
from repro.autotune import driver as jdriver
from repro.launch import autotune as jlaunch
from repro.diffusion import DiffusionCfg as JDiffusionCfg
from repro.models import DiTCfg as JDiTCfg
from repro.quant import QuantArtifact as JQuantArtifact
from repro.quant import QuantRecipe as JQuantRecipe
from repro_torch import autotune as tat
from repro_torch.autotune import evaluate as tevaluate
from repro_torch.autotune import report as treport
from repro_torch.autotune.throughput import measure_step_s
from repro_torch.configs import dit_xl_2
from repro_torch.diffusion.ddpm import DiffusionCfg
from repro_torch.launch import autotune as launcher
from repro_torch.launch.tables import ROOT
from repro_torch.models.dit import params_from_numpy
from repro_torch.quant.recipe import QuantRecipe

tdriver = importlib.import_module("repro_torch.autotune.driver")
CPU = "cpu"
MAXMIN = dict(maximize=("req_per_s",), minimize=("FD",))
PATHS = ("int8", "int8_composed", "int4")
# the reference's modelled seconds per CFG-paired step of DiT-XL/2 at
# one request a device: a table that must reproduce its floats
MODELED = {p: jst.modeled_dit_step(jst.XL2, 1, p)["time_s"] for p in PATHS}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny shapes run as fast on one torch intra-op thread and one
    BLAS thread, which spares the other test workers' cores."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# 1. pure parity
# ---------------------------------------------------------------------------
SPACES = [
    {},
    {"bits": ("w8a8", "w8a8", "w4a4")},
    {"bits": ("w4a4", "w8a8"), "tgq_groups": (2, 4), "bit_budgets": (6.0,)},
    {"bits": ("w8a8", "w6a6", "w4a4"), "tgq_groups": (None, 5),
     "bit_budgets": (5.0, 6.0, 7.5), "attn_impl": "composed"},
    {"bits": ("w8a8", "w4a4"), "methods": ("range", "ho"),
     "use_mrq": (True, False), "use_tgq": (False, True),
     "tgq_groups": (None, 2), "bit_budgets": (6.0,), "ho_rounds": 1,
     "ho_n_alpha": 4, "seed": 3, "n_per_group": 2, "calib_batch": 1},
    {"bits": ("w6a6",), "methods": ("ho",), "use_mrq": (False,)},
]


@pytest.mark.parametrize("kw", SPACES)
def test_expand_and_space_hash_match_jax(kw):
    tsp, jsp = tat.SearchSpace(**kw), jat.SearchSpace(**kw)
    assert tsp.to_dict() == jsp.to_dict()
    assert tsp.content_hash() == jsp.content_hash()
    tt, jt = tat.expand(tsp), jat.expand(jsp)
    assert [t.key() for t in tt] == [t.key() for t in jt]
    assert [t.label for t in tt] == [t.label for t in jt]
    assert [t.to_dict() for t in tt] == [t.to_dict() for t in jt]


@pytest.mark.parametrize("kw", [
    {}, {"steps": 3, "n_gen": 8, "gen_batch": 8, "n_real": 32, "n_mse": 8,
         "keep_at_least": 3},
    {"pipe_noise": 0.25, "prune_factor": 7.5, "serve_b_local": 4,
     "serve_steps": 50}])
def test_eval_config_hash_matches_jax(kw):
    t, j = tat.EvalConfig(**kw), jat.EvalConfig(serve_n_dev=1, **kw)
    assert t.to_dict() == j.to_dict()
    assert t.content_hash() == j.content_hash()


def test_serve_n_dev_other_than_one_raises():
    assert tat.EvalConfig().serve_n_dev == 1
    with pytest.raises(ValueError, match="queue 1, item 9"):
        tat.EvalConfig(serve_n_dev=4)


BAD_SPACES = [
    {"bits": ("w3a3",)}, {"methods": ("minmax",)},
    {"attn_impl": "paged"}, {"bits": ()},
    {"bits": ("w8a8",), "bit_budgets": (6.0,)},
    {"bits": ("w8a8", "w4a4"), "bit_budgets": (9.0,)},
    {"bits": ("w8a8", "w4a4"), "methods": ("ho",), "use_mrq": (False,),
     "bit_budgets": (6.0,)},
]


@pytest.mark.parametrize("kw", BAD_SPACES)
def test_validation_errors_match_jax(kw):
    def err(mod):
        with pytest.raises(ValueError) as e:
            mod.expand(mod.SearchSpace(**kw))
        return str(e.value)
    assert err(tat) == err(jat)


@pytest.mark.parametrize("seed", range(4))
def test_allocator_and_gate_match_jax(seed):
    rng = np.random.default_rng(seed)
    G = int(rng.integers(1, 12))
    levels = ["w4a4", "w8a8"] + (["w6a6"] if seed % 2 else [])
    sens = {b: [float(v) for v in rng.uniform(0, 1, G)] for b in levels}
    if seed == 3:                                    # ties everywhere
        sens = {b: [0.5] * G for b in levels}
    for budget in (4.0, 4.5, 5.0, 6.0, 6.9, 8.0):
        ta, ja = tat.allocate_bits(sens, budget), jat.allocate_bits(
            sens, budget)
        assert ta == ja
        assert tat.mean_bits(ta) == jat.mean_bits(ja)
    keys = [f"k{i}" for i in range(8)]
    mse = {k: float(v) for k, v in zip(keys, rng.choice(
        [1e-4, 2e-3, 5e-3, 0.05, 0.3], 8))}
    req = {k: float(v) for k, v in zip(keys, rng.choice([1.0, 2.0, 3.0],
                                                        8))}
    for pf, keep in itertools.product((1.0, 10.0, 50.0), (0, 1, 3)):
        t = tat.select_survivors(mse, req, tat.EvalConfig(
            prune_factor=pf, keep_at_least=keep))
        j = jat.select_survivors(mse, req, jat.EvalConfig(
            prune_factor=pf, keep_at_least=keep))
        assert t == j


def test_allocator_errors_match_jax():
    for sens in ({"w8a8": [1.0]}, {"w8a8": [1.0, 2.0], "w4a4": [1.0]}):
        msgs = []
        for mod in (tat, jat):
            with pytest.raises(ValueError) as e:
                mod.allocate_bits(sens, 6.0)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def _pts(pairs):
    return [{"key": f"p{i}", "req_per_s": r, "FD": f}
            for i, (r, f) in enumerate(pairs)]


@settings(max_examples=60, deadline=None)
@given(pairs=st.lists(st.tuples(st.integers(1, 12), st.integers(1, 12)),
                      min_size=1, max_size=24),
       seed=st.integers(0, 2 ** 16))
def test_frontier_matches_jax_fuzz(pairs, seed):
    """The port's frontier equals JAX's on the same points, and keeps the
    reference's properties: no frontier point dominated, every excluded
    point dominated or a duplicate, a strict trade-off led by the fastest
    point, and permutation stability (integer grids force ties)."""
    pts = _pts([(float(r), float(f)) for r, f in pairs])
    front = tat.pareto_frontier(pts)
    assert front == jat.pareto_frontier(pts)
    keys = {p["key"] for p in front}
    for p in front:
        assert not any(tat.dominates(q, p, **MAXMIN) for q in pts)
    for p in pts:
        if p["key"] not in keys:
            assert any(tat.dominates(q, p, **MAXMIN) for q in pts) or any(
                q["req_per_s"] == p["req_per_s"] and q["FD"] == p["FD"]
                for q in front)
    assert tat.is_strict_tradeoff(front) == jat.is_strict_tradeoff(front)
    assert tat.is_strict_tradeoff(front)
    assert front[0]["req_per_s"] == max(p["req_per_s"] for p in pts)
    shuffled = pts[:]
    random.Random(seed).shuffle(shuffled)
    assert tat.pareto_frontier(shuffled) == front


@pytest.mark.parametrize("attn_impl", ["flash", "composed"])
def test_throughput_of_a_modeled_table_equals_jax(attn_impl):
    """``uniform_throughput`` / ``mixed_throughput`` on a table of the
    reference's modelled step times give the reference's floats."""
    for kw in ({}, {"serve_b_local": 4, "serve_steps": 50}):
        tcfg, jcfg = tat.EvalConfig(**kw), jat.EvalConfig(serve_n_dev=1,
                                                          **kw)
        table = {p: jst.modeled_dit_step(jst.XL2, tcfg.serve_b_local,
                                         p)["time_s"] for p in PATHS}
        for bits in ("w8a8", "w6a6", "w4a4"):
            r = QuantRecipe(bits=bits, attn_impl=attn_impl)
            jr = JQuantRecipe(bits=bits, attn_impl=attn_impl)
            assert tat.recipe_path(r) == jst.recipe_model_path(jr)
            assert tat.uniform_throughput(r, tcfg, table) == \
                jat.uniform_throughput(jr, jcfg)
        for T, G in ((1000, 10), (40, 4)):
            alloc = ["w4a4", "w8a8", "w6a6"] * G
            t = tat.mixed_throughput(alloc[:G], attn_impl,
                                     DiffusionCfg(T=T, tgq_groups=G), tcfg,
                                     table)
            j = jat.mixed_throughput(alloc[:G], attn_impl,
                                     JDiffusionCfg(T=T, tgq_groups=G), jcfg)
            assert t == j


# ---------------------------------------------------------------------------
# 2. driver bookkeeping: both drivers, the same stubs
# ---------------------------------------------------------------------------
class StubCtx:
    def __init__(self, key, wbits):
        self.key, self.wbits = key, wbits


class StubArtifact:
    """Stands in for ``QuantArtifact``: saves and loads its recipe's key
    and weight bits."""

    def __init__(self, key, wbits):
        self.key, self.wbits = key, wbits

    def save(self, path):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "stub.json"), "w") as f:
            json.dump([self.key, self.wbits], f)
        return path

    @classmethod
    def load(cls, path, **_):
        with open(os.path.join(path, "stub.json")) as f:
            return cls(*json.load(f))

    def context(self, kernel=None):
        return StubCtx(self.key, self.wbits)


def _stub_quantize(params, model_cfg, dif_cfg, recipe, **_):
    return StubArtifact(recipe.content_hash(), recipe.wbits)


def _stub_rng(ctx):
    ctxs = ctx if isinstance(ctx, list) else [ctx]
    seed = hashlib.sha256("|".join(c.key for c in ctxs).encode()).digest()
    return np.random.default_rng(int.from_bytes(seed[:4], "little")), ctxs


def _stub_stage1(params, model_cfg, dif_cfg, ctx, ecfg, **_):
    """Noise MSE falling with each group's weight bits, from an RNG
    seeded by the trial's keys."""
    rng, ctxs = _stub_rng(ctx)
    by = [float(u * 10.0 ** (-ctxs[g % len(ctxs)].wbits / 2))
          for g, u in enumerate(rng.uniform(0.5, 1.5, dif_cfg.tgq_groups))]
    return {"noise_mse": float(np.mean(by)), "noise_mse_by_group": by}


def _stub_stage2(params, model_cfg, dif_cfg, ctx, ecfg, **_):
    rng, ctxs = _stub_rng(ctx)
    bits = float(np.mean([c.wbits for c in ctxs]))
    u = rng.uniform(1.0, 1.2, 3)
    return {"FD": round(float(u[0] * 10 ** (-bits / 4)), 3),
            "sFD": round(float(u[1] * 10 ** (1 - bits / 4)), 3),
            "IS*": round(float(u[2] * bits), 3)}


STUB_SPACE = dict(bits=("w8a8", "w6a6", "w4a4"), tgq_groups=(None, 5),
                  bit_budgets=(5.0, 6.0))
STUB_EVAL = dict(prune_factor=5.0, keep_at_least=1)
TINY = dict(img_size=8, in_ch=4, patch=2, d_model=64, n_layers=2,
            n_heads=4, n_classes=8)


@pytest.fixture(scope="module")
def stub_sweeps(tmp_path_factory):
    """One stubbed sweep through each driver: (JAX's out dir, the
    port's)."""
    jdir = str(tmp_path_factory.mktemp("jax_sweep"))
    tdir = str(tmp_path_factory.mktemp("port_sweep"))
    quiet = lambda *_: None
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jdriver, tdriver):
            mp.setattr(mod, "quantize", _stub_quantize)
            mp.setattr(mod, "QuantArtifact", StubArtifact)
            mp.setattr(mod, "stage1", _stub_stage1)
            mp.setattr(mod, "stage2", _stub_stage2)
        jres = jdriver.run(None, JDiTCfg(**TINY), JDiffusionCfg(),
                           jat.SearchSpace(**STUB_SPACE),
                           jat.EvalConfig(serve_n_dev=1, **STUB_EVAL), jdir,
                           log=quiet)
        tres = tdriver.run(None, launcher.tiny_dit()[0], DiffusionCfg(),
                           tat.SearchSpace(**STUB_SPACE),
                           tat.EvalConfig(**STUB_EVAL), tdir, log=quiet,
                           step_s=dict(MODELED), device=CPU)
    return jdir, tdir, jres, tres


def _rows(out_dir):
    return [{k: v for k, v in r.items() if k != "wall_s"}
            for r in tat.read_ledger(out_dir)]


def test_stub_ledgers_equal_jax(stub_sweeps):
    jdir, tdir, jres, tres = stub_sweeps
    trows = _rows(tdir)
    tput = [r for r in trows if r["kind"] == "throughput"]
    assert tput == [{"kind": "throughput", "source": "supplied",
                     "step_s": {p: MODELED[p] for p in ("int4", "int8")}}]
    assert [r for r in trows if r["kind"] != "throughput"] == _rows(jdir)
    strip = lambda recs: [{k: v for k, v in r.items() if k != "wall_s"}
                          for r in recs]
    assert strip(tres.records) == strip(jres.records)
    assert tres.frontier == jres.frontier
    assert tres.pruned == jres.pruned > 0
    assert not tres.measured and tres.throughput == tput[0]


def test_stub_outputs_equal_jax(stub_sweeps):
    jdir, tdir, _, tres = stub_sweeps
    with open(os.path.join(tdir, "BENCH_autotune.json")) as f:
        doc = json.load(f)
    assert doc.pop("throughput") == tres.throughput
    with open(os.path.join(jdir, "BENCH_autotune.json")) as f:
        assert json.dumps(doc, indent=1, sort_keys=True) == f.read()
    with open(os.path.join(jdir, "report.md")) as f:
        jlines = f.read().splitlines()
    with open(os.path.join(tdir, "report.md")) as f:
        tlines = f.read().splitlines()
    n = len(jlines)
    assert tlines[:n] == [ln.replace("as modeled req/s", "as measured req/s")
                          for ln in jlines]
    assert tlines[n:n + 4] == ["", "## Measured on", "",
                               "Seconds per step supplied by the caller, "
                               "not measured."]
    assert "measured req/s" in "\n".join(tlines[:n])


@pytest.mark.parametrize("strict", [True, False])
def test_render_report_matches_jax(stub_sweeps, strict):
    """The report of one doc, without its mixed trials and with either
    trade-off verdict, against JAX's render of the same doc."""
    _, tdir, _, _ = stub_sweeps
    with open(os.path.join(tdir, "BENCH_autotune.json")) as f:
        doc = json.load(f)
    doc["strict_tradeoff"] = strict
    doc["trials"] = [r for r in doc["trials"]
                     if r["trial"]["kind"] == "uniform"]
    jlines = jat.report.render_report(doc).splitlines()
    tlines = treport.render_report(doc).splitlines()
    assert tlines[:len(jlines)] == [
        ln.replace("as modeled req/s", "as measured req/s") for ln in jlines]
    assert tlines[len(jlines) + 1] == "## Measured on"


# ---------------------------------------------------------------------------
# 3. the port's own sweep on the CPU
# ---------------------------------------------------------------------------
SPACE = tat.SearchSpace(bits=("w8a8", "w4a4"), tgq_groups=(None,),
                        bit_budgets=(6.0,), n_per_group=1, calib_batch=1)
ECFG = tat.EvalConfig(steps=3, n_gen=8, gen_batch=8, n_real=32, n_mse=8,
                      keep_at_least=3)
DIF = DiffusionCfg(T=40, tgq_groups=4)
N_TRIALS = 3                                        # 2 uniform + 1 mixed


def _tiny_params():
    with open(os.path.join(ROOT, "experiments", "dit_tiny_200.pkl"),
              "rb") as f:
        return params_from_numpy(pickle.load(f), device=CPU)


def _refuse(*_, **__):
    raise AssertionError("a resume measured the throughput")


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """One killed-then-resumed-then-replayed sweep: the full run measures
    the throughput (on the CPU, at the smoke config, one run), the kill
    and the replay may not."""
    cfg, params = launcher.tiny_dit()[0], _tiny_params()
    out = str(tmp_path_factory.mktemp("autotune"))
    calls = []

    def measure(paths, ecfg, **kw):
        calls.append((list(paths), kw))
        return measure_step_s(paths, ecfg, **kw)
    kw = dict(log=lambda *_: None, device=CPU,
              measure_kw={"serve_cfg": dit_xl_2.smoke(), "runs": 1})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdriver, "measure_step_s", _refuse)
        killed = tat.run_autotune(params, cfg, DIF, SPACE, ECFG, out,
                                  max_new_stage1=1, **kw)
        mp.setattr(tdriver, "measure_step_s", measure)
        full = tat.run_autotune(params, cfg, DIF, SPACE, ECFG, out, **kw)
        outputs = {n: open(os.path.join(out, n), "rb").read()
                   for n in ("BENCH_autotune.json", "report.md")}
        mp.setattr(tdriver, "measure_step_s", _refuse)
        resumed = tat.run_autotune(params, cfg, DIF, SPACE, ECFG, out, **kw)
    return cfg, params, out, killed, full, resumed, outputs, calls


def test_driver_kill_then_resume_counts(sweep):
    *_, killed, full, resumed, _, calls = sweep
    assert killed.stopped_early and killed.recomputed == 1
    assert full.stage1_hits == 1
    assert full.recomputed == N_TRIALS - 1
    assert not full.stopped_early and len(full.records) == N_TRIALS
    assert full.measured and [c[0] for c in calls] == [["int4", "int8"]]


def test_driver_full_resume_is_pure_cache_hit(sweep):
    *_, full, resumed, _, calls = sweep
    assert resumed.recomputed == 0 and resumed.cache_hits == N_TRIALS
    assert resumed.frontier == full.frontier
    assert resumed.records == full.records
    assert not resumed.measured and len(calls) == 1
    assert resumed.throughput == full.throughput


def test_resume_replays_the_measured_row(sweep):
    _, _, out, *_ = sweep
    rows = [r for r in tat.read_ledger(out) if r["kind"] == "throughput"]
    assert len(rows) == 1
    row = rows[0]
    assert row["source"] == "measured" and row["device"] == CPU
    assert row["card"] == "cpu" and row["runs"] == 1
    assert row["serve"]["cfg"] == dataclasses.asdict(dit_xl_2.smoke())
    assert row["serve"]["steps"] == ECFG.serve_steps
    assert set(row["step_s"]) == {"int4", "int8"}
    assert all(s > 0 for s in row["step_s"].values())
    assert row["launches"] == {"int4": {}, "int8": {}}    # plain versions


def test_driver_frontier_shape_and_artifacts(sweep):
    """Every frontier artifact loads in the port and in JAX, and names
    the recipe that made it."""
    _, _, out, _, full, *_ = sweep
    assert full.frontier and tat.is_strict_tradeoff(full.frontier)
    by_key = {r["key"]: r for r in full.records}
    for p in full.frontier:
        rec = by_key[p["key"]]
        art = tat.load_trial_artifact(out, rec, device=CPU)
        if p["kind"] == "uniform":
            paths = [rec["artifact"]]
            assert art.meta["recipe_hash"] == p["key"]
        else:
            paths = list(art["components"].values())
            assert set(art["loaded_components"]) == {"w8a8", "w4a4"}
            assert len(art["allocation"]) == DIF.tgq_groups
        for rel in paths:
            jart = JQuantArtifact.load(os.path.join(out, rel))
            assert jart.recipe.content_hash() == \
                jart.meta["recipe_hash"] == os.path.basename(rel)


def test_driver_outputs_deterministic_across_resume(sweep):
    _, _, out, *_, resumed, outputs, _ = sweep
    for name, data in outputs.items():
        assert open(os.path.join(out, name), "rb").read() == data
    with open(os.path.join(out, "BENCH_autotune.json")) as f:
        doc = json.load(f)
    assert doc["frontier"] == resumed.frontier and doc["strict_tradeoff"]
    assert doc["throughput"] == resumed.throughput
    report = outputs["report.md"].decode()
    assert "## Measured on" in report and "`cpu` (cpu)" in report
    for p in resumed.frontier:
        assert p["label"] in report


def test_driver_tolerates_truncated_ledger_tail(sweep, tmp_path):
    _, _, out, *_ = sweep
    copy = str(tmp_path / "sweep")
    shutil.copytree(out, copy)
    n_rows = len(tat.read_ledger(copy))
    with open(os.path.join(copy, "ledger.jsonl"), "a") as f:
        f.write('{"kind": "final", "key": "dead-beef", "trunca')
    assert len(tat.read_ledger(copy)) == n_rows


def test_driver_resume_under_changed_inputs_fails_fast(sweep):
    cfg, params, out, *_ = sweep
    run = lambda space, ecfg, **kw: tat.run_autotune(
        params, cfg, DIF, space, ecfg, out, log=lambda *_: None,
        device=CPU, **kw)
    with pytest.raises(ValueError, match="different space"):
        run(tat.SearchSpace(bits=("w8a8",), n_per_group=1, calib_batch=1),
            ECFG)
    with pytest.raises(ValueError, match="different eval"):
        run(SPACE, dataclasses.replace(ECFG, steps=5))
    with pytest.raises(ValueError, match="differs from the seconds per"):
        run(SPACE, ECFG, step_s={"int8": 1.0, "int4": 1.0})


def test_mixed_trial_allocation_recorded(sweep):
    *_, full, _, _, _ = sweep
    mixed = [r for r in full.records if r["trial"]["kind"] == "mixed"]
    assert len(mixed) == 1
    alloc = mixed[0]["allocation"]
    assert len(alloc) == DIF.tgq_groups
    assert tat.mean_bits(alloc) <= 6.0 + 1e-9
    assert set(alloc) <= {"w8a8", "w4a4"}
    assert mixed[0]["metrics"]["path"] == "+".join(sorted(
        tat.recipe_path(QuantRecipe(bits=b)) for b in set(alloc)))


# ---------------------------------------------------------------------------
# 4. the measurement and the launcher
# ---------------------------------------------------------------------------
def test_measure_step_s_on_the_cpu():
    """The tiny config, 1 request of 2 steps, every path (the composed
    one on the w8a8 calibration's context)."""
    row = measure_step_s(PATHS, tat.EvalConfig(serve_steps=2),
                         serve_cfg=dit_xl_2.smoke(), device=CPU, runs=2)
    assert set(row["step_s"]) == set(PATHS) and row["runs"] == 2
    for p in PATHS:
        assert row["step_s"][p] > 0 and len(row["runs_s"][p]) == 2
        assert row["spread_s"][p] >= 0 and row["launches"][p] == {}
    assert row["card"] == "cpu" and row["serve"]["b_local"] == 1


def test_launcher_kill_full_and_resume(tmp_path, capsys):
    out = str(tmp_path / "at")
    argv = ["--arch", "tiny", "--device", CPU, "--out", out, "--bits",
            "w8a8,w4a4", "--budgets", "6", "--steps", "2", "--n-gen", "4",
            "--gen-batch", "4", "--n-real", "16", "--n-mse", "10"]
    seen = []

    def measure(paths, ecfg, **kw):
        seen.append(kw["serve_cfg"])
        return {"card": "cpu", "device": CPU, "serve": {
            "cfg": dataclasses.asdict(kw["serve_cfg"]), "b_local": 1,
            "steps": ecfg.serve_steps, "cfg_scale": 1.5}, "runs": 3,
            "step_s": {"int8": 0.02, "int4": 0.01},
            "spread_s": {"int8": 0.0, "int4": 0.0}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdriver, "measure_step_s", _refuse)
        launcher.main(argv + ["--max-new-stage1", "1"])
        assert "stopped early: 1 new trials" in capsys.readouterr().out
        mp.setattr(tdriver, "measure_step_s", measure)
        launcher.main(argv)
        printed = capsys.readouterr().out
        assert "throughput measured this run on cpu" in printed
        assert seen == [dit_xl_2.smoke()]
        mp.setattr(tdriver, "measure_step_s", _refuse)
        launcher.main(argv + ["--assert-resumed"])
    printed = capsys.readouterr().out
    assert "resume asserts passed (3 cache hits, 0 recomputed)" in printed
    assert "replayed from the ledger" in printed


def test_launcher_trains_and_caches_the_tiny_dit(tmp_path, monkeypatch,
                                                 capsys):
    """``--arch tiny --train-steps 3`` trains the tiny DiT with the
    reference's recipe and caches ``dit_tiny_3.pkl`` under
    ``REPRO_EXP_DIR``, which the reference's ``tiny_dit`` loads; a second
    run loads it and trains nothing."""
    monkeypatch.setenv("REPRO_EXP_DIR", str(tmp_path / "exp"))
    argv = ["--arch", "tiny", "--train-steps", "3", "--device", CPU,
            "--out", str(tmp_path / "at"), "--max-new-stage1", "0"]
    launcher.main(argv)
    assert "[tiny-train] step 2 loss" in capsys.readouterr().out
    path = tmp_path / "exp" / "dit_tiny_3.pkl"
    with open(path, "rb") as f:
        cached = pickle.load(f)
    jcfg, _, jparams = jlaunch.tiny_dit(3, str(tmp_path / "exp"))
    assert jcfg == JDiTCfg(**dataclasses.asdict(launcher.tiny_dit()[0]))
    for a, b in zip(jax.tree.leaves(cached), jax.tree.leaves(jparams)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    mtime = os.path.getmtime(path)
    launcher.main(argv)
    assert "[tiny-train]" not in capsys.readouterr().out
    assert os.path.getmtime(path) == mtime
