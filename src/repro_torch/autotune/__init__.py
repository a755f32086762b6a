"""repro_torch.autotune — resumable recipe auto-search over the
quantization artifact API, emitting the quality-vs-throughput Pareto
frontier; port of ``repro.autotune``.

    from repro_torch.autotune import SearchSpace, EvalConfig, run_autotune

    space = SearchSpace(bits=("w8a8", "w6a6", "w4a4"), bit_budgets=(6.0,))
    result = run_autotune(params, model_cfg, dif_cfg, space, EvalConfig(),
                          "experiments/autotune")
    for p in result.frontier:
        print(p["label"], p["req_per_s"], p["FD"], p["artifact"])

Pieces: ``space`` expands the declarative axes into content-hash-keyed
trials; ``evaluate`` is the two-stage scorer (cheap noise-MSE gate, then
FD/sFD/IS-proxy for survivors), the AdaTSQ-style per-timestep-group bit
allocator and the throughput of a trial from a table of seconds per
step; ``throughput`` measures that table on the card (DiT-XL/2 served
through the kernels); ``driver`` runs the sweep against an append-only
JSONL ledger so a killed sweep resumes with completed trials (and the
measurement) as cache hits; ``pareto`` computes the frontier; ``report``
renders it. CLI: ``python -m repro_torch.launch.autotune``.
"""
from repro_torch.autotune.driver import AutotuneResult, \
    load_trial_artifact, read_ledger, run as run_autotune
from repro_torch.autotune.evaluate import EvalConfig, allocate_bits, \
    mean_bits, mixed_throughput, select_survivors, sensitivity_by_bits, \
    uniform_throughput
from repro_torch.autotune.pareto import dominates, is_strict_tradeoff, \
    pareto_frontier
from repro_torch.autotune.space import SearchSpace, Trial, expand
from repro_torch.autotune.throughput import measure_step_s, recipe_path

__all__ = [
    "AutotuneResult", "EvalConfig", "SearchSpace", "Trial",
    "allocate_bits", "dominates", "expand", "is_strict_tradeoff",
    "load_trial_artifact", "mean_bits", "measure_step_s",
    "mixed_throughput", "pareto_frontier", "read_ledger", "recipe_path",
    "run_autotune", "select_survivors", "sensitivity_by_bits",
    "uniform_throughput",
]
