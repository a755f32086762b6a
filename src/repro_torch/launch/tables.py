"""The paper's quality tables on the port: Tables I, II (W8A8 / W6A6
schemes at 40 and 20 steps), III (the W6A6 ablation), III-b (the W4A4
ablation served through the packed-int4 kernels) and IV (calibration
cost) — the port's counterpart of ``benchmarks/common.py`` and
``benchmarks/table{1,2,3,3b,4}_*.py``.

    python -m repro_torch.launch.tables [--tables 1,2,3,3b,4] [--out PATH]
                                        [--smoke] [--device cpu]
                                        [--qparams DIR]

The model is the trained 6-layer checkpoint
``experiments/dit_bench_450.pkl`` (``--smoke``: the tiny
``experiments/dit_tiny_200.pkl`` with few steps and samples, the same
code); it is never trained here, and a missing checkpoint exits with a
message. Each (scheme, bits) is calibrated once per process with
``core.ptq.run_ptq`` on the pipeline's latents (Tables I and II share
them; nothing is cached on disk). Tables I–III sample through the
fake-quant ``QuantContext(qparams=qp)``; III-b converts each scheme with
``convert_for_kernels`` and samples through ``QuantContext(kernel=True)``,
counting the ops that lowered onto kernels (``n_packed``). Rows are
printed as CSV and written with the protocol, the card and the seconds
to ``--out`` (default ``chiprun_out/tables.json``).

``--qparams DIR`` serves saved calibrations instead, as the reference's
benchmarks load ``experiments/qparams_{scheme}_w{bits}a{bits}_450.pkl``
where present: a (scheme, bits) whose artifact ``DIR/qparams_...``
(``qparams_name``; the reference's format, which
``tests/test_torch_eval.py w4a4 DIR`` writes from those pickles) exists
is loaded, not calibrated.

The calibration draws come from a ``torch.Generator``, so the calibration
sets (and the rows) are not the reference's number for number: compare
orderings.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import subprocess
import time
from typing import Dict, List, Optional

import torch

from repro_torch.core.baselines import SCHEMES
from repro_torch.core.calib import build_dit_calibration, dit_loss_fn
from repro_torch.core.contexts import QuantContext
from repro_torch.core.ptq import run_ptq
from repro_torch.device import resolve_device
from repro_torch.diffusion import rng
from repro_torch.diffusion.ddpm import DiffusionCfg, make_schedule
from repro_torch.kernels.ops import convert_for_kernels
from repro_torch.models.dit import DiTCfg, params_from_numpy
from repro_torch.quant import eval as qeval
from repro_torch.quant.api import to_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
# the reference's benchmark model: 64 tokens, so post-softmax probs (~1/64)
# sit below the W6A6 uniform step, and 6 layers so errors compound
BENCH_DIT = DiTCfg(img_size=16, in_ch=4, patch=2, d_model=160, n_layers=6,
                   n_heads=4, n_classes=8)
SMOKE_DIT = DiTCfg(img_size=8, in_ch=4, patch=2, d_model=64, n_layers=2,
                   n_heads=4, n_classes=8)
DIF = DiffusionCfg(T=1000, tgq_groups=10)
QUALITY = ["q_diffusion", "ptqd", "ptq4dit", "tq_dit"]
ABLATION = ["baseline", "+HO", "+HO+MRQ", "tq_dit"]
PACK_KEYS = ("int4", "int4_mrq", "int8", "int8_mrq", "int8_qk", "int8_pv")
TABLES = ("1", "2", "3", "3b", "4")


@dataclasses.dataclass(frozen=True)
class Protocol:
    """The evaluation protocol (the reference's constants by default)."""
    cfg: DiTCfg = BENCH_DIT
    dif: DiffusionCfg = DIF
    ckpt: str = "dit_bench_450.pkl"
    steps_long: int = 40             # Tables I, III, III-b
    steps_short: int = 20            # Table II
    n_gen: int = 128
    gen_batch: int = 64
    n_real: int = 1024
    gen_seed: int = 123
    data_seed: int = 999
    net_seed: int = 1234
    pipe_seed: int = 11
    pipe_noise: float = 0.3
    mse_n: int = 128
    mse_seed: int = 55
    calib_per_group: int = 32
    calib_batch: int = 8
    calib_seed: int = 3
    big_per_group: int = 64          # Table IV's PTQ4DiT-like capture
    big_seed: int = 31
    # PTQConfig knobs; its tgq_groups is dif's
    ptq: tuple = (("n_alpha", 8), ("rounds", 2), ("max_rows_per_batch", 96))


# two TGQ groups: a calibration batch a group, so the CPU tests stay cheap
SMOKE = Protocol(cfg=SMOKE_DIT, dif=DiffusionCfg(T=1000, tgq_groups=2),
                 ckpt="dit_tiny_200.pkl", steps_long=4, steps_short=2,
                 n_gen=8, gen_batch=4, n_real=64, mse_n=4,
                 calib_per_group=1, calib_batch=1, big_per_group=2,
                 ptq=(("n_alpha", 4), ("rounds", 1),
                      ("max_rows_per_batch", 16)))


def qparams_name(scheme: str, bits: int) -> str:
    """The reference's name for a saved calibration of the trained
    checkpoint (its benchmarks' cache, less the ``.pkl``)."""
    return f"qparams_{scheme.replace('+', 'p')}_w{bits}a{bits}_450"


class Bench:
    """The loaded checkpoint, its calibration set and the calibrations of
    this process, memoised by (scheme, bits); with ``qparams_dir``, the
    saved artifacts found there stand in for calibrations."""

    def __init__(self, proto: Protocol, device,
                 qparams_dir: Optional[str] = None):
        path = os.path.join(ROOT, "experiments", proto.ckpt)
        if not os.path.exists(path):
            raise SystemExit(f"{path} is missing: the tables need the "
                             "trained checkpoint (training is not ported)")
        self.proto, self.dev = proto, resolve_device(device)
        with open(path, "rb") as f:
            self.params = params_from_numpy(pickle.load(f), device=self.dev)
        self.sched = make_schedule(proto.dif)
        self.calib = self.calibration_set(proto.calib_per_group,
                                          proto.calib_batch,
                                          proto.calib_seed)
        self.memo: Dict[tuple, tuple] = {}
        self.weights: Optional[dict] = None
        self.qparams_dir = qparams_dir

    def calibration_set(self, n_per_group: int, batch: int, seed: int):
        """``build_dit_calibration`` on the pipeline's latents: each x0
        batch from the next key of a threefry chain seeded ``seed``,
        timesteps, labels and noise from a generator seeded ``seed``."""
        pipe = qeval.make_pipeline(self.proto.cfg,
                                   pipe_seed=self.proto.pipe_seed,
                                   pipe_noise=self.proto.pipe_noise)
        chain = [rng.PRNGKey(seed, device=self.dev)]

        def x0_source(n, _generator):
            chain[0], k = rng.split(chain[0])
            return pipe.x0_source(n, k)
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        return build_dit_calibration(
            self.proto.cfg, self.proto.dif, self.sched, x0_source, gen,
            n_per_group=n_per_group, batch=batch, device=self.dev)

    def calibrate(self, scheme: str, bits: int, calib=None, **overrides):
        """(qparams on the device, report): memoised per (scheme, bits)
        unless ``calib`` or ``overrides`` are given (Table IV)."""
        key = (scheme, bits)
        fresh = calib is not None or overrides
        saved = (None if self.qparams_dir is None else os.path.join(
            self.qparams_dir, qparams_name(scheme, bits)))
        if not fresh and key not in self.memo and saved and \
                os.path.isdir(saved):
            from repro_torch.quant.artifact import QuantArtifact
            from repro_torch.serving.quickcal import capture
            if self.weights is None:
                self.weights = capture(self.params, self.proto.cfg,
                                       self.calib[:1])[2]
            print(f"[tables] {scheme} W{bits}A{bits}: serving {saved}",
                  flush=True)
            self.memo[key] = (QuantArtifact.load(saved, device=self.dev
                                                 ).qparams, {})
        if fresh or key not in self.memo:
            kw = dict(self.proto.ptq, tgq_groups=self.proto.dif.tgq_groups)
            kw.update(overrides)
            qp, rep = run_ptq(dit_loss_fn(self.params, self.proto.cfg),
                              calib or self.calib,
                              SCHEMES[scheme](bits, bits, **kw),
                              device=self.dev)
            weights = rep.pop("weights")
            if self.weights is None:
                self.weights = weights
            if fresh:
                return qp, rep
            self.memo[key] = (qp, rep)
        return self.memo[key]

    def row(self, ctx, steps: int) -> tuple:
        """(FD, sFD, IS*, noise MSE) of ``ctx`` (None: FP, MSE 0)."""
        p = self.proto
        gen, _ = qeval.generate(
            self.params, p.cfg, p.dif, ctx=ctx, steps=steps, n=p.n_gen,
            seed=p.gen_seed, batch=p.gen_batch, sched=self.sched,
            device=self.dev)
        s = qeval.score(gen, p.cfg, n_real=p.n_real, data_seed=p.data_seed,
                        net_seed=p.net_seed, pipe_seed=p.pipe_seed,
                        pipe_noise=p.pipe_noise, device=self.dev)
        mse = 0.0 if ctx is None else round(qeval.noise_mse(
            self.params, p.cfg, p.dif, ctx, n=p.mse_n, seed=p.mse_seed,
            pipe_seed=p.pipe_seed, pipe_noise=p.pipe_noise,
            device=self.dev), 6)
        return s["FD"], s["sFD"], s["IS*"], mse


def table1(b: Bench, steps: int, name: str, bits_list=(8, 6)) -> List[tuple]:
    rows = [("bits", "method", "FD", "sFD", "IS*", "noiseMSE"),
            ("32/32", "FP") + b.row(None, steps)]
    for bits in bits_list:
        for scheme in QUALITY:
            qp, _ = b.calibrate(scheme, bits)
            rows.append((f"{bits}/{bits}", scheme)
                        + b.row(QuantContext(qparams=qp), steps))
            print(f"[{name}] W{bits}A{bits} {scheme}: {rows[-1][2:]}",
                  flush=True)
    return rows


def table3(b: Bench) -> List[tuple]:
    steps = b.proto.steps_long
    rows = [("method", "FD", "sFD", "IS*", "noiseMSE"),
            ("FP",) + b.row(None, steps)]
    for scheme in ABLATION:
        qp, _ = b.calibrate(scheme, 6)
        rows.append((scheme,) + b.row(QuantContext(qparams=qp), steps))
        print(f"[table3] {scheme}: {rows[-1][1:]}", flush=True)
    return rows


def table3b(b: Bench) -> List[tuple]:
    """The W4A4 ablation through the packed-int4 kernels."""
    steps = b.proto.steps_long
    rows = [("method", "FD", "sFD", "IS*", "noiseMSE", "n_packed"),
            ("FP",) + b.row(None, steps) + (0,)]
    for scheme in ABLATION:
        qp, _ = b.calibrate(scheme, 4)
        qp = to_device(convert_for_kernels(to_device(qp, "cpu"),
                                            b.weights), b.dev)
        n_packed = sum(1 for v in qp.values()
                       if any(k in v for k in PACK_KEYS))
        ctx = QuantContext(qparams=qp, kernel=n_packed > 0)
        rows.append((scheme,) + b.row(ctx, steps) + (n_packed,))
        print(f"[table3b] W4A4 {scheme}: {rows[-1][1:]} (kernel path, "
              f"{n_packed} packed ops)", flush=True)
    return rows


def table4(b: Bench) -> List[tuple]:
    """Calibration cost: PTQ4DiT-like (salience balancing, a larger
    capture) against TQ-DiT, both W8A8, timed afresh."""
    p = b.proto
    rows = [("method", "wall_s", "capture_s", "search_s", "calib_MB",
             "n_batches")]
    big = b.calibration_set(p.big_per_group, p.calib_batch, p.big_seed)
    reps = {}
    for label, scheme, calib, over in (
            ("ptq4dit-like", "ptq4dit", big,
             {"max_rows_per_batch": 512, "rounds": 3}),
            ("tq_dit", "tq_dit", b.calib, {"rounds": 3})):
        _, rep = b.calibrate(scheme, 8, calib=calib, **over)
        reps[scheme] = rep
        rows.append((label, round(rep["wall_s"], 1),
                     round(rep["capture_s"], 1), round(rep["search_s"], 1),
                     round(rep["calib_bytes"] / 2 ** 20, 1),
                     rep["n_batches"]))
    red_t = 100 * (1 - reps["tq_dit"]["wall_s"] / reps["ptq4dit"]["wall_s"])
    red_m = 100 * (1 - reps["tq_dit"]["calib_bytes"]
                   / reps["ptq4dit"]["calib_bytes"])
    rows.append(("reduction_%", round(red_t, 1), "", "", round(red_m, 1), ""))
    return rows


def card_name(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tables", default=",".join(TABLES),
                    help="comma-separated subset of 1,2,3,3b,4")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "tables.json"))
    ap.add_argument("--smoke", action="store_true",
                    help="the tiny checkpoint, few steps and samples")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "versions)")
    ap.add_argument("--qparams", default=None, metavar="DIR",
                    help="serve the saved calibrations in DIR (artifacts "
                         "named by qparams_name) instead of calibrating")
    args = ap.parse_args(argv)
    want = args.tables.split(",")
    bad = [t for t in want if t not in TABLES]
    if bad:
        ap.error(f"unknown tables {bad}; choose from {TABLES}")
    proto = SMOKE if args.smoke else Protocol()
    t0 = time.perf_counter()
    b = Bench(proto, args.device, args.qparams)
    card = card_name(b.dev)
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    run = {"1": lambda: table1(b, proto.steps_long, "table1"),
           "2": lambda: table1(b, proto.steps_short, "table2"),
           "3": lambda: table3(b), "3b": lambda: table3b(b),
           "4": lambda: table4(b)}
    out = {"card": card, "device": str(b.dev), "smoke": args.smoke,
           "qparams": args.qparams,
           "protocol": dataclasses.asdict(proto),
           "tables": {}, "seconds": {}}
    for t in TABLES:
        if t not in want:
            continue
        t1 = time.perf_counter()
        rows = run[t]()
        name = f"table{t}"
        out["tables"][name] = [list(r) for r in rows]
        out["seconds"][name] = time.perf_counter() - t1
        print(f"[{name}] {out['seconds'][name]:.1f} s", flush=True)
        for r in rows:
            print(",".join(str(x) for x in r), flush=True)
    out["seconds"]["total"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out} ({out['seconds']['total']:.1f} s)", flush=True)
    return out


if __name__ == "__main__":
    main()
