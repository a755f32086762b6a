"""The codes that the prologue pass's layernorm statistics move, on the
trained checkpoint.

    python src/repro_torch/launch/stats_flips.py [--widths w8a8,w6a6,w4a4]

The prologue pass (``csrc/prologue.cuh``) sums each norm-modulated row's
mean and variance in its own order and takes rsig as a correctly rounded
1 / sqrt; before it, the wrappers computed them in torch (mean, biased
variance, ``torch.rsqrt``: ``torch_stats`` below), and the kernels agreed
bit for bit with those. This script serves the trained 6-layer
checkpoint (``experiments/dit_bench_450.pkl``: d 160, 8 requests x 50
steps, CFG off, ``chip_smoke.py``'s phase 3) on the card, fp and then each
width three ways, and prints each drift ``mean|fp - q| / mean|fp|``:

1. through the kernels (the pass computes the statistics);
2. through the plain versions with ``torch_stats``: what the kernels
   computed before the pass took the statistics over;
3. through the plain versions as they are (the pass's order).

During serve 1, every norm-modulated linear call also quantizes its rows
with ``torch_stats``. The script counts the activation codes that differ
from the kernel's, their largest difference, and how many lie on a
rounding boundary: the two quotients x'/s straddle k + 1/2 and differ by
less than 1e-3 (a statistic one ulp off moves a quotient by about 1e-5).
The last line is a JSON object of the counts and drifts.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys


def torch_stats(x, eps: float = 1e-6):
    """The statistics the wrappers computed in torch before the pass did."""
    import torch
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return mu, torch.rsqrt(var + eps)


class FlipCounter:
    """Wraps the ops module's fused linears: on each call with norm_mod,
    the kernel's codes (``prologue.codes``) against the codes from
    ``torch_stats`` (plain formulas, laid out alike)."""

    def __init__(self, ops, names):
        self.ops, self.names, self.saved = ops, names, {}
        self.n_codes = self.n_diff = self.n_boundary = self.max_diff = 0
        self.max_move = 0.0

    def __enter__(self):
        for name in self.names:
            self.saved[name] = fn = getattr(self.ops, name)
            setattr(self.ops, name, self._wrap(fn, name.startswith("int4")))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)

    def _wrap(self, fn, int4):
        def run(x, w, sx, zx, *args, **kw):
            if kw.get("nm") is not None:
                self.count(x, sx, zx, args, kw, int4)
            return fn(x, w, sx, zx, *args, **kw)
        return run

    def count(self, x, sx, zx, args, kw, int4):
        import torch

        from repro_torch.kernels import prologue as P
        from repro_torch.kernels import ref
        g = kw["gv"] if "gv" in kw else kw["g"]
        bits = 4 if int4 else kw.get("bits", 8)
        width = {}
        if int4:
            gk = kw["group_k"]
            width = {"gk": gk, "gkp": -128 * (-gk // 128)}
        half = 2 ** (bits - 1)
        bv, nm, ps = kw["bv"], kw["nm"], kw.get("ps")
        new = P.codes(x, sx, zx, g, bits=bits, ps=ps, nm=nm, bv=bv,
                      **width)[0]
        sa, sb = ((sx[g.long()], zx[g.long()]) if torch.is_tensor(g)
                  else (sx[g][0], zx[g][0]))
        quot = {}
        for key, stats in (("new", ref.layernorm_stats),
                           ("old", torch_stats)):
            mu, rsig = stats(x)
            sh, sc = (t.float()[bv.long()] for t in nm)
            xf = ((x.float() - mu) * rsig) * (1.0 + sc) + sh
            if ps is not None:
                xf = xf / ps.float()[None, :]
            quot[key] = xf / sa
        old = torch.clamp(torch.round(quot["old"]) + sb - half, -half,
                          half - 1).to(torch.int8)
        # the kernel's codes back at their x columns (prologue.chunk_map)
        M, K = x.shape
        _, gk_, gkp_, Kq = P._width(K, bits, width.get("gk"),
                                    width.get("gkp"))
        src = torch.full((Kq,), -1, dtype=torch.long)
        for j, (k0, n) in enumerate(P.chunk_map(K, Kq, gk_, gkp_)):
            if n > 0:
                src[16 * j:16 * j + n] = torch.arange(k0, k0 + n)
        real = src >= 0
        new_x = torch.empty_like(old)
        new_x[:, src[real].to(x.device)] = new[:, real.to(x.device)]
        diff = (new_x.int() - old.int()).abs()
        moved = diff > 0
        self.n_codes += x.numel()
        self.n_diff += int(moved.sum())
        self.max_diff = max(self.max_diff, int(diff.max()))
        if moved.any():
            a = quot["new"][moved].double()
            b = quot["old"][moved].double()
            lo, hi = torch.minimum(a, b), torch.maximum(a, b)
            edge = torch.floor(hi - 0.5) + 0.5        # the k + 1/2 below hi
            on_edge = (edge >= lo) & (hi - lo < 1e-3) & (diff[moved] == 1)
            self.n_boundary += int(on_edge.sum())
            self.max_move = max(self.max_move, float((hi - lo).max()))


LINEARS = ("int8_matmul_fq", "int8_matmul_fq_vec", "int4_matmul_fq",
           "int4_matmul_fq_vec")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="w8a8,w6a6,w4a4")
    args = ap.parse_args(argv)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "..", "..")
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.diffusion.ddpm import DiffusionCfg, make_schedule
    from repro_torch.kernels import ops, ref
    from repro_torch.models.dit import DiTCfg, params_from_numpy
    from repro_torch.quant.api import quantize
    from repro_torch.quant.recipe import QuantRecipe
    from repro_torch.serving.batching import GenRequest
    from repro_torch.serving.engine import ServeEngine
    if not torch.cuda.is_available():
        raise SystemExit("stats_flips: needs a CUDA card")
    cfg = DiTCfg(img_size=16, in_ch=4, patch=2, d_model=160, n_layers=6,
                 n_heads=4, n_classes=8)
    dif = DiffusionCfg(T=1000, tgq_groups=10)
    with open(os.path.join(root, "experiments", "dit_bench_450.pkl"),
              "rb") as f:
        params = params_from_numpy(pickle.load(f), device="cuda")
    sched = make_schedule(dif)
    reqs = [GenRequest(request_id=i, label=i % 8, steps=50, seed=100 + i)
            for i in range(8)]

    def serve(ctx):
        eng = ServeEngine(params, cfg, dif, sched, ctx=ctx, microbatch=4,
                          step_buckets=(50,), device="cuda")
        res = eng.serve(reqs)
        return np.stack([res[i].sample for i in range(8)])
    fp = serve(None)
    drift = lambda q: float(np.abs(fp - q).mean() / np.abs(fp).mean())
    out = {}
    for bits in args.widths.split(","):
        ctx = quantize(params, cfg, dif, QuantRecipe(bits=bits),
                       sched=sched).context()
        with FlipCounter(ops, LINEARS) as fc:
            d_kernel = drift(serve(ctx))
        new_stats = ref.layernorm_stats
        ref.layernorm_stats = torch_stats
        try:
            with kernels.plain_on_cuda():
                d_old = drift(serve(ctx))
        finally:
            ref.layernorm_stats = new_stats
        with kernels.plain_on_cuda():
            d_plain = drift(serve(ctx))
        out[bits] = dict(drift_kernels=d_kernel, drift_plain_torch_stats=d_old,
                         drift_plain=d_plain, codes=fc.n_codes,
                         differ=fc.n_diff, on_boundary=fc.n_boundary,
                         max_code_diff=fc.max_diff,
                         max_quotient_move=fc.max_move)
        print(f"{bits}: drift kernels {d_kernel:.6f}, plain with torch "
              f"statistics {d_old:.6f}, plain {d_plain:.6f}; "
              f"{fc.n_diff} of {fc.n_codes} norm-modulated codes differ "
              f"from the torch statistics' ({fc.n_boundary} on a .5 "
              f"boundary, largest code difference {fc.max_diff}, largest "
              f"quotient move {fc.max_move:.3g})", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), **out}))


if __name__ == "__main__":
    main()
