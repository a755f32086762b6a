"""The resumable sweep driver: expand -> calibrate -> measure -> gate ->
score -> Pareto frontier, with every completed unit of work durable on
disk — port of ``repro/autotune/driver.py``.

Layout under ``out_dir``::

    ledger.jsonl            append-only trial ledger (the resume state)
    artifacts/<key>/        one saved QuantArtifact per uniform trial,
                            or ``mixed.json`` for a mixed trial
    BENCH_autotune.json     machine-readable sweep result
    report.md               the human-readable report

The ledger is JSONL with four row kinds. A ``header`` row pins the
space/eval-protocol content hashes plus the model/diffusion configs — a
resume under ANY changed input fails fast instead of silently mixing
incomparable scores. A ``stage1`` row marks one trial calibrated
(artifact saved) and stage-1 scored; a ``final`` row marks it fully
resolved (stage-2 scored or pruned). A ``throughput`` row (the port's
own) holds the seconds per step of every serving path the trials need,
measured on the card once per sweep, before the gate, with the card's
name and power limit and each run. Trial rows are keyed by the trial's
CONTENT hash (``QuantRecipe.content_hash()``; mixed trials hash budget +
component hashes), not by grid position — reordering or widening the
space never invalidates completed work that still appears in it.

Resume semantics: a killed sweep restarts by re-expanding the space and
replaying the ledger. Trials with a ``final`` row are full cache hits
(no quantize, no sampling, no scoring); trials with only a ``stage1``
row skip calibration and reload their artifact from disk for stage 2; a
half-written trailing line (the kill landed mid-append) is ignored. A
resumed sweep replays the ``throughput`` row instead of measuring again:
a measurement moves with the card's noise, and the gate (whose fast
endpoint always survives) and the frontier must not. Because the gate
and the bit allocator are deterministic pure functions of ledger
contents, the resumed run reaches the identical frontier —
``tests/test_torch_autotune.py`` holds this, and ``chip_smoke.py`` on
the card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional

from repro_torch.autotune import report as report_mod
from repro_torch.autotune.evaluate import EvalConfig, allocate_bits, \
    mixed_throughput, select_survivors, sensitivity_by_bits, stage1, \
    stage2, uniform_throughput
from repro_torch.autotune.pareto import is_strict_tradeoff, pareto_frontier
from repro_torch.autotune.space import SearchSpace, Trial, expand
from repro_torch.autotune.throughput import measure_step_s, recipe_path
from repro_torch.device import resolve_device
from repro_torch.quant.api import quantize
from repro_torch.quant.artifact import QuantArtifact

LEDGER = "ledger.jsonl"
ARTIFACTS = "artifacts"


@dataclasses.dataclass
class AutotuneResult:
    records: List[dict]          # one final row per trial, ledger order
    frontier: List[dict]         # Pareto-optimal points, fastest first
    strict_tradeoff: bool        # quality strictly improves as req/s falls
    cache_hits: int              # trials resolved entirely from the ledger
    stage1_hits: int             # trials whose stage-1 came from the ledger
    recomputed: int              # trials that ran quantize+stage1 this run
    pruned: int
    stopped_early: bool          # max_new_stage1 kill-switch tripped
    out_dir: str
    throughput: Optional[dict] = None   # the ledger's throughput row
    measured: bool = False       # this run measured it (a resume replays)


# ---------------------------------------------------------------------------
# ledger I/O
# ---------------------------------------------------------------------------
def _ledger_path(out_dir: str) -> str:
    return os.path.join(out_dir, LEDGER)


def read_ledger(out_dir: str) -> List[dict]:
    """Parse the ledger, tolerating a truncated trailing line (a kill
    mid-append leaves one; everything before it is intact because rows
    are appended with a flush per row)."""
    path = _ledger_path(out_dir)
    if not os.path.exists(path):
        return []
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                break                                  # truncated tail
    return rows


def _append(out_dir: str, row: dict) -> None:
    with open(_ledger_path(out_dir), "a") as f:
        f.write(json.dumps(row, sort_keys=True) + "\n")
        f.flush()


def _header(space: SearchSpace, ecfg: EvalConfig, model_cfg,
            dif_cfg) -> dict:
    return {"kind": "header", "version": 1,
            "space_hash": space.content_hash(),
            "eval_hash": ecfg.content_hash(),
            "space": space.to_dict(), "eval": ecfg.to_dict(),
            "model": {"class": type(model_cfg).__name__,
                      "cfg": dataclasses.asdict(model_cfg)},
            "dif": dataclasses.asdict(dif_cfg)}


def _check_header(existing: dict, fresh: dict, out_dir: str) -> None:
    for field in ("space_hash", "eval_hash", "model", "dif"):
        if existing.get(field) != fresh[field]:
            raise ValueError(
                f"ledger at {out_dir} was written under a different "
                f"{field.replace('_hash', '')} "
                f"({existing.get(field)!r} != {fresh[field]!r}); scores "
                "would not be comparable — use a fresh --out dir")


# ---------------------------------------------------------------------------
# per-trial helpers
# ---------------------------------------------------------------------------
def _effective_dif(dif_cfg, trial: Trial):
    recipe = trial.recipe if trial.kind == "uniform" \
        else trial.components[0]
    if recipe.tgq_groups is not None \
            and recipe.tgq_groups != dif_cfg.tgq_groups:
        return dataclasses.replace(dif_cfg, tgq_groups=recipe.tgq_groups)
    return dif_cfg


def _artifact_dir(out_dir: str, key: str) -> str:
    return os.path.join(out_dir, ARTIFACTS, key)


def load_trial_artifact(out_dir: str, record: dict, device=None):
    """The saved artifact behind one ledger record, on ``device``
    (default ``"cuda"``): a ``QuantArtifact`` for uniform trials; for
    mixed trials the composite doc (allocation + per-bits component
    artifact paths) with every component loaded."""
    path = os.path.join(out_dir, record["artifact"])
    if record["trial"]["kind"] == "uniform":
        return QuantArtifact.load(path, device=device)
    with open(os.path.join(path, "mixed.json")) as f:
        doc = json.load(f)
    doc["loaded_components"] = {
        b: QuantArtifact.load(os.path.join(out_dir, rel), device=device)
        for b, rel in doc["components"].items()}
    return doc


def _paths(trials: List[Trial]) -> List[str]:
    """The serving paths a sweep's trials charge their steps to (a mixed
    trial's components are uniform trials of the same sweep)."""
    return sorted({recipe_path(r) for t in trials
                   for r in ((t.recipe,) if t.kind == "uniform"
                             else t.components)})


def _step_table(step_s: Dict[str, float], paths: List[str],
                what: str) -> Dict[str, float]:
    missing = [p for p in paths if p not in step_s]
    if missing:
        raise ValueError(f"{what} has no seconds per step for {missing}")
    return {p: float(step_s[p]) for p in paths}


def _throughput(rows: List[dict], trials: List[Trial], ecfg: EvalConfig,
                out_dir: str, step_s: Optional[Dict[str, float]], device,
                measure_kw: Optional[dict], log):
    """(the sweep's throughput row, whether this run measured it). The
    ledger's row is replayed when there is one; else ``step_s`` (a
    caller's table) is recorded, or the paths are measured on the card."""
    paths = _paths(trials)
    row = next((r for r in rows if r.get("kind") == "throughput"), None)
    if row is not None:
        table = _step_table(row["step_s"], paths, "the ledger's row")
        if step_s is not None and \
                _step_table(step_s, paths, "step_s") != table:
            raise ValueError(
                f"step_s {step_s} differs from the seconds per step in the "
                f"ledger at {out_dir} ({table}); scores would not be "
                "comparable — use a fresh --out dir")
        return row, False
    if step_s is not None:
        row = {"kind": "throughput", "source": "supplied",
               "step_s": _step_table(step_s, paths, "step_s")}
    else:
        log(f"[autotune] measuring {paths} on {device}")
        row = {"kind": "throughput", "source": "measured",
               **measure_step_s(paths, ecfg, device=device,
                                **(measure_kw or {}))}
    # as a resume reads it back, so outputs are byte-identical across one
    row = json.loads(json.dumps(row, sort_keys=True))
    _append(out_dir, row)
    return row, step_s is None


class _TrialRunner:
    """Phase logic for one sweep, holding in-memory artifacts so a trial
    calibrated this run is not re-read from disk for stage 2."""

    def __init__(self, params, model_cfg, dif_cfg, space, ecfg, out_dir,
                 provenance, log, device):
        self.params, self.model_cfg, self.dif_cfg = params, model_cfg, dif_cfg
        self.space, self.ecfg, self.out_dir = space, ecfg, out_dir
        self.provenance, self.log, self.device = provenance, log, device
        self.artifacts: Dict[str, QuantArtifact] = {}   # trial key -> loaded
        self.step_s: Dict[str, float] = {}  # path -> s/step, before phase B

    def _artifact_for(self, trial: Trial, s1_row: dict) -> QuantArtifact:
        key = trial.key()
        if key not in self.artifacts:
            self.artifacts[key] = QuantArtifact.load(
                os.path.join(self.out_dir, s1_row["artifact"]),
                device=self.device)
        return self.artifacts[key]

    def _component_rows(self, trial: Trial, s1: Dict[str, dict]):
        rows = {}
        for comp in trial.components:
            row = s1.get(comp.content_hash())
            if row is None:                            # pragma: no cover
                raise RuntimeError(
                    f"mixed trial {trial.label} ordered before its "
                    f"component {comp.bits} — expand() broke its ordering "
                    "contract")
            rows[comp.bits] = row
        return rows

    def _mixed_ctx(self, trial: Trial, allocation: List[str],
                   s1: Dict[str, dict]):
        ctx_of_bits = {}
        for comp in trial.components:
            if comp.bits in set(allocation):
                comp_trial = Trial(kind="uniform", label="", recipe=comp)
                art = self._artifact_for(comp_trial, s1[comp.content_hash()])
                ctx_of_bits[comp.bits] = art.context(kernel=False)
        return [ctx_of_bits[b] for b in allocation]

    # -- phase A: calibrate + stage 1 ---------------------------------------
    def ensure_stage1(self, trial: Trial, s1: Dict[str, dict]) -> dict:
        key, t0 = trial.key(), time.time()
        dif = _effective_dif(self.dif_cfg, trial)
        rel = os.path.join(ARTIFACTS, key)
        row = {"kind": "stage1", "key": key, "label": trial.label,
               "trial": trial.to_dict(), "artifact": rel}
        if trial.kind == "uniform":
            art = quantize(self.params, self.model_cfg, self.dif_cfg,
                           trial.recipe, provenance=self.provenance)
            art.save(_artifact_dir(self.out_dir, key))
            self.artifacts[key] = art
            row.update(stage1(self.params, self.model_cfg, dif,
                              art.context(kernel=False), self.ecfg,
                              device=self.device))
        else:
            comp_rows = self._component_rows(trial, s1)
            sens = sensitivity_by_bits(comp_rows)
            allocation = allocate_bits(sens, trial.budget)
            row["allocation"] = allocation
            ctx = self._mixed_ctx(trial, allocation, s1)
            row.update(stage1(self.params, self.model_cfg, dif, ctx,
                              self.ecfg, device=self.device))
            os.makedirs(_artifact_dir(self.out_dir, key), exist_ok=True)
            doc = {"kind": "mixed", "budget": trial.budget,
                   "allocation": allocation,
                   "components": {c.bits: os.path.join(
                       ARTIFACTS, c.content_hash())
                       for c in trial.components},
                   "component_hashes": {c.bits: c.content_hash()
                                        for c in trial.components}}
            with open(os.path.join(_artifact_dir(self.out_dir, key),
                                   "mixed.json"), "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
        row["wall_s"] = round(time.time() - t0, 3)
        _append(self.out_dir, row)
        return row

    # -- throughput (from the sweep's table of seconds per step) -----------
    def throughput(self, trial: Trial, s1_row: dict) -> Dict[str, float]:
        if trial.kind == "uniform":
            return uniform_throughput(trial.recipe, self.ecfg, self.step_s)
        return mixed_throughput(
            s1_row["allocation"], trial.components[0].attn_impl,
            _effective_dif(self.dif_cfg, trial), self.ecfg, self.step_s)

    # -- phase C: stage 2 ---------------------------------------------------
    def finalize(self, trial: Trial, s1_row: dict, survived: bool,
                 s1: Dict[str, dict]) -> dict:
        key, t0 = trial.key(), time.time()
        dif = _effective_dif(self.dif_cfg, trial)
        metrics = {"noise_mse": s1_row["noise_mse"],
                   "noise_mse_by_group": s1_row["noise_mse_by_group"]}
        metrics.update(self.throughput(trial, s1_row))
        if survived:
            if trial.kind == "uniform":
                ctx = self._artifact_for(trial, s1_row).context(kernel=False)
            else:
                ctx = self._mixed_ctx(trial, s1_row["allocation"], s1)
            metrics.update(stage2(self.params, self.model_cfg, dif, ctx,
                                  self.ecfg, device=self.device))
        row = {"kind": "final", "key": key, "label": trial.label,
               "trial": trial.to_dict(), "artifact": s1_row["artifact"],
               "status": "ok" if survived else "pruned",
               "metrics": metrics}
        if "allocation" in s1_row:
            row["allocation"] = s1_row["allocation"]
        row["wall_s"] = round(time.time() - t0, 3)
        _append(self.out_dir, row)
        return row


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------
def run(params, model_cfg, dif_cfg, space: SearchSpace, ecfg: EvalConfig,
        out_dir: str, *, provenance: Optional[dict] = None,
        log: Callable[[str], None] = print,
        max_new_stage1: Optional[int] = None,
        step_s: Optional[Dict[str, float]] = None, device=None,
        measure_kw: Optional[dict] = None) -> AutotuneResult:
    """Run (or resume) one sweep on ``device`` (default ``"cuda"``; the
    params live there). ``max_new_stage1`` stops the run after that many
    NEWLY-computed stage-1 trials — the test hook simulating a killed
    sweep without killing the process (no outputs are written for such a
    partial run).

    Throughput: the ledger's ``throughput`` row when it has one; else
    ``step_s`` ({path: seconds per CFG-paired step}, recorded as
    supplied); else ``throughput.measure_step_s`` on ``device`` with
    ``measure_kw`` (``serve_cfg``, ``params``, ``artifacts``, ``runs``)."""
    dev = resolve_device(device)
    os.makedirs(os.path.join(out_dir, ARTIFACTS), exist_ok=True)
    trials = expand(space)
    fresh_header = _header(space, ecfg, model_cfg, dif_cfg)
    rows = read_ledger(out_dir)
    if rows:
        if rows[0].get("kind") != "header":            # pragma: no cover
            raise ValueError(f"ledger at {out_dir} has no header row")
        _check_header(rows[0], fresh_header, out_dir)
    else:
        _append(out_dir, fresh_header)

    s1 = {r["key"]: r for r in rows if r.get("kind") == "stage1"}
    finals = {r["key"]: r for r in rows if r.get("kind") == "final"}
    runner = _TrialRunner(params, model_cfg, dif_cfg, space, ecfg,
                          out_dir, provenance, log, dev)

    # -- phase A: every trial calibrated + stage-1 scored -------------------
    new_s1 = 0
    stage1_hits = 0
    for trial in trials:
        key = trial.key()
        if key in s1:
            stage1_hits += 1
            continue
        if max_new_stage1 is not None and new_s1 >= max_new_stage1:
            log(f"[autotune] stopping early after {new_s1} new stage-1 "
                "trials (max_new_stage1)")
            return AutotuneResult(
                records=[], frontier=[], strict_tradeoff=False,
                cache_hits=len(finals), stage1_hits=stage1_hits,
                recomputed=new_s1, pruned=0, stopped_early=True,
                out_dir=out_dir)
        log(f"[autotune] stage1 {trial.label} ({key})")
        s1[key] = runner.ensure_stage1(trial, s1)
        new_s1 += 1

    # -- the throughput table: measured once a sweep, then replayed ---------
    tput, measured = _throughput(rows, trials, ecfg, out_dir, step_s, dev,
                                 measure_kw, log)
    runner.step_s = tput["step_s"]

    # -- phase B: the deterministic gate ------------------------------------
    mse = {t.key(): s1[t.key()]["noise_mse"] for t in trials}
    req = {t.key(): runner.throughput(t, s1[t.key()])["req_per_s"]
           for t in trials}
    survivors = set(select_survivors(mse, req, ecfg))

    # -- phase C: stage 2 for survivors, final rows for everyone ------------
    records, cache_hits = [], 0
    for trial in trials:
        key = trial.key()
        if key in finals:
            cache_hits += 1
            records.append(finals[key])
            continue
        verdict = "stage2" if key in survivors else "pruned"
        log(f"[autotune] {verdict} {trial.label} ({key})")
        records.append(runner.finalize(trial, s1[key], key in survivors,
                                       s1))

    # -- frontier + outputs --------------------------------------------------
    points = [_point(r) for r in records if r["status"] == "ok"]
    frontier = pareto_frontier(points)
    result = AutotuneResult(
        records=records, frontier=frontier,
        strict_tradeoff=is_strict_tradeoff(frontier),
        cache_hits=cache_hits, stage1_hits=stage1_hits,
        recomputed=new_s1,
        pruned=sum(1 for r in records if r["status"] == "pruned"),
        stopped_early=False, out_dir=out_dir, throughput=tput,
        measured=measured)
    write_outputs(result, fresh_header)
    return result


def _point(record: dict) -> dict:
    m = record["metrics"]
    p = {"key": record["key"], "label": record["label"],
         "kind": record["trial"]["kind"], "artifact": record["artifact"],
         "req_per_s": m["req_per_s"], "ms_per_step": m["ms_per_step"],
         "path": m.get("path"), "noise_mse": m["noise_mse"],
         "FD": m["FD"], "sFD": m["sFD"], "IS*": m["IS*"]}
    if record["trial"]["kind"] == "uniform":
        p["bits"] = record["trial"]["recipe"]["bits"]
    else:
        p["allocation"] = record["allocation"]
        p["mean_bits"] = m.get("mean_bits")
    return p


def write_outputs(result: AutotuneResult, header: dict) -> None:
    """BENCH_autotune.json + report.md. Deterministic given the ledger
    (wall-clock fields of trials stay in the ledger only; the throughput
    row is replayed as written), so a fully-cache-hit resume rewrites
    byte-identical outputs. The doc is the reference's with one more key,
    ``throughput``: the ledger's throughput row."""
    doc = {
        "meta": {k: header[k] for k in ("space", "eval", "model", "dif",
                                        "space_hash", "eval_hash")},
        "n_trials": len(result.records),
        "n_pruned": result.pruned,
        "strict_tradeoff": result.strict_tradeoff,
        "trials": [{k: v for k, v in r.items() if k != "wall_s"}
                   for r in result.records],
        "frontier": result.frontier,
        "throughput": result.throughput,
    }
    with open(os.path.join(result.out_dir, "BENCH_autotune.json"),
              "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    with open(os.path.join(result.out_dir, "report.md"), "w") as f:
        f.write(report_mod.render_report(doc))
