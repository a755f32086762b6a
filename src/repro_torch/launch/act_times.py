"""Device time of B13 (``kernels.act_mrq``) at the DiT-XL/2 shapes.

    python src/repro_torch/launch/act_times.py [--src DIR] [--reps 30] \
        [--label NAME] [--ablate]

Cases: GELU on fc1's output (2048, 4608) and SiLU on the adaLN input
(8, 1152) (randn * 3, steps 0.17 / half and 6 / half as device tensors),
f32 and bf16 in and out, bits 8 and 6. Each is timed two ways:

- warm: the same input every call (the bf16 GELU input, 18.9 MB, stays
  in the 50 MB L2 between calls);
- cold: inputs rotated over copies, and the outputs kept in a ring as
  long, so that at least 128 MB pass between two uses of a buffer and
  none is in L2 when its call comes.

For each it prints:

- device ms per call: ``act_mrq_kernel``'s durations by
  ``torch.profiler`` over ``--reps`` calls (attn_times' ``device_ms``);
  warm, also the wrapper ms (CUDA events, the host's enqueue included);
- bound ms: the larger of the bytes (x read once, out written once, the
  two steps) at 3.35 TB/s and 15 fp32 operations an element (the GELU's
  5 multiplies, 2 adds and tanh; compare, divide, round, two clips,
  multiply) at 67 TFLOP/s: H100 SXM;
- library ms: ``F.gelu(approximate="tanh")`` / ``F.silu`` on the same x
  (another function: no quantize), device time, warm and cold alike;
- the output's sha256 with every zero made +0, so that a parent and a
  change whose zeros differ in sign alone compare equal, and the count of
  zeros off JAX's sign rule (sign bit set exactly where h < 0, h the
  plain activation on the card): 0 for a tree that follows it; for a
  parent, the zeros a change that follows it turns in sign.

``--ablate`` times throwaway builds of the tree's ``csrc/act_mrq.cu``
with one part switched off (``ABLATIONS``: no loads, no tanhf, no
quotient, no stores; "parent:" entries fit the kernel of commit
3adf05d, run with ``--src`` on that tree) or changed (``VARIANTS``: 8
elements a thread, a one-shot grid of a tile a warp, each thread on 16
contiguous elements instead of the warp on consecutive groups), on
the GELU bf16 bits 8 case, warm and cold, in two rounds (in order, then
in reverse) beside the tree's own build. Builds and skips follow
attn_times' ``_patched`` and ``_install``; an ablated build's outputs
are wrong by construction: only its times are read.

``--src`` puts DIR first on the import path, so one script times another
tree's kernel through the same entry point; run parent, change, change,
parent in one call on one card to compare them. The last line is a JSON
object of the rows.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

GELU_MRQ_FP32_PER_ELEM = 15
COLD_BYTES = 128e6           # between two uses of a buffer: beyond the L2
CASES = [("gelu", (2048, 4608)), ("silu", (8, 1152))]

# (name, [(text in the source, replacement)]): each switches one part of
# the kernel off ("parent:": the kernel of commit 3adf05d) while keeping
# the rest alive
LOAD = "          load_group<G>(x + w0 + (g * 32 + lane) * G, v + g * G);"
STORE = "          store_group<G>(out + w0 + (g * 32 + lane) * G, v + g * G);"
ABLATIONS = [
    ("no loads", [(LOAD,
      "          for (int e = 0; e < G; ++e) v[g * G + e] = (float)((int)(w0 "
      "+ g * 32 + lane + e) & 255) * 0.03125f - 4.f;")]),
    ("no tanhf", [("tanhf(u)", "u")]),
    ("no quotient", [(
        "div_rn(a, s, y, __fmul_rn(a, y))", "__fmul_rn(a, y)")]),
    ("no stores (the values summed, one store if the sum is 1234.5)", [
        ("        float v[VEC];", "        float v[VEC], sink = 0.f;"),
        (STORE, "          for (int e = 0; e < G; ++e) sink = __fadd_rn(sink, "
                "v[g * G + e]);"),
        ("        continue;", "        if (sink == 1234.5f) st(out + w0, sink);\n"
                            "        continue;")]),
    ("parent: no loads", [(
        "    load8(x + i0, v);",
        "    for (int j = 0; j < VEC; ++j) v[j] = (float)((int)(i0 + j) & 255)"
        " * 0.03125f - 4.f;")]),
    ("parent: no quotient", [
        ("fmax_nan(rintf(__fdiv_rn(h, sn))", "fmax_nan(rintf(__fmul_rn(h, sn))"),
        ("fmax_nan(rintf(__fdiv_rn(h, sp))",
         "fmax_nan(rintf(__fmul_rn(h, sp))")]),
    ("parent: no stores (the values summed, one store if the sum is "
     "1234.5)", [(
        "    store8(out + i0, v);",
        "    float sink = 0.f;\n"
        "    for (int j = 0; j < VEC; ++j) sink = __fadd_rn(sink, v[j]);\n"
        "    if (sink == 1234.5f) st(out + i0, sink);")]),
]
# (name, [(text, replacement)]): a design the kernel could have had
VARIANTS = [
    ("8 elements a thread", [(
        "constexpr int VEC = 16;", "constexpr int VEC = 8;")]),
    ("one-shot grid (a tile a warp)", [(
        "  const long blocks = tiles < resident ? tiles : resident;",
        "  const long blocks = tiles;")]),
    ("8 elements a thread, one-shot grid", [
        ("constexpr int VEC = 16;", "constexpr int VEC = 8;"),
        ("  const long blocks = tiles < resident ? tiles : resident;",
         "  const long blocks = tiles;")]),
    ("streaming loads and stores (evict first)", [
        ("    const uint4 a = *reinterpret_cast<const uint4*>(p);",
         "    const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));"),
        ("    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);",
         "    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], "
         "w[3]));")]),
    ("rint by the 1.5 x 2^23 add instead of rintf (FRND)", [(
        "  const float q = rintf(div_rn(a, s, y, __fmul_rn(a, y)));",
        "  const float q = __fsub_rn(__fadd_rn(div_rn(a, s, y, __fmul_rn(a, y)), "
        "FMAGIC), FMAGIC);")]),
    ("GELU's 0.5 * (1 + t) as two steps", [(
        "__fmaf_rn(0.5f, tanhf(u), 0.5f)",
        "__fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(u)))")]),
    ("16 contiguous elements a thread", [
        (LOAD, LOAD.replace("(g * 32 + lane) * G", "(lane * (VEC / G) + g) * G")),
        (STORE, STORE.replace("(g * 32 + lane) * G",
                              "(lane * (VEC / G) + g) * G"))]),
]


def digest(out):
    """sha256 of ``out``'s bytes with every zero made +0."""
    import torch
    o = torch.where(out == 0, torch.zeros_like(out), out)
    return hashlib.sha256(o.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def off_rule(out, x, kind):
    """Zeros of ``out`` whose sign bit is not (h < 0), h = the plain
    activation of x on the card."""
    import torch
    from repro_torch.kernels import ref
    h = (ref.gelu_tanh_ref if kind == "gelu" else ref.silu_ref)(x.float())
    z = out == 0
    return int((torch.signbit(out.float())[z] != (h < 0)[z]).sum())


def make_case(kind, shape, dt, out_dt, bits, gen):
    """(run warm, run cold, library warm, library cold, x, bytes a call)."""
    import math

    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    dev = torch.device("cuda")
    half = 2 ** (bits - 1)
    x = (torch.randn(shape, device=dev, generator=gen) * 3).to(dt)
    sn = torch.tensor(0.17 / half, device=dev)
    sp = torch.tensor(6.0 / half, device=dev)
    nbytes = x.numel() * (x.element_size() + torch.empty(
        (), dtype=out_dt).element_size()) + 8
    n = max(2, math.ceil(COLD_BYTES / nbytes))
    xs = [x.clone() for _ in range(n)]
    ring, at = [None] * n, [0]
    lib = ((lambda v: F.gelu(v, approximate="tanh")) if kind == "gelu"
           else F.silu)

    def call(v):
        return kernels.act_mrq(v, sn, sp, bits=bits, kind=kind,
                               out_dtype=out_dt)

    def cold(fn):
        def run():
            i = at[0] = (at[0] + 1) % n
            ring[i] = fn(xs[i])
        return run
    return (lambda: call(x), cold(call), lambda: lib(x), cold(lib), x,
            nbytes)


def time_row(name, kind, shape, dt, out_dt, bits, gen, reps, log=print):
    import torch
    from repro_torch.launch.attn_times import bound, device_ms, wrapper_ms
    warm, cold, lib_warm, lib_cold, x, nbytes = make_case(
        kind, shape, dt, out_dt, bits, gen)
    out = warm()
    torch.cuda.synchronize()
    kern = lambda run: sum(t for k, t in device_ms(run, reps)[0].items()
                           if k.startswith("act_mrq_kernel"))
    bms, by = bound(nbytes, 0, GELU_MRQ_FP32_PER_ELEM * x.numel())
    row = {"case": name, "warm_ms": kern(warm), "cold_ms": kern(cold),
           "wrapper_ms": wrapper_ms(warm, reps), "bound_ms": bms,
           "bound_by": by,
           "library_warm_ms": sum(device_ms(lib_warm, reps)[0].values()),
           "library_cold_ms": sum(device_ms(lib_cold, reps)[0].values()),
           "sha256": digest(out), "off_rule_zeros": off_rule(out, x, kind),
           "negative_zeros": int((torch.signbit(out.float())
                                  & (out == 0)).sum())}
    log(f"  {name:<34} warm {row['warm_ms']:.4f} ms, cold "
        f"{row['cold_ms']:.4f} ms (wrapper {row['wrapper_ms']:.4f}); bound "
        f"{bms:.4f} ms ({by}); F.{kind} warm {row['library_warm_ms']:.4f}, "
        f"cold {row['library_cold_ms']:.4f} ms; out sha256 (zeros +0) "
        f"{row['sha256'][:16]}, zeros off the sign rule "
        f"{row['off_rule_zeros']}, -0 {row['negative_zeros']}")
    return row


def time_cases(reps, log=print):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for kind, shape in CASES:
        for dt in (torch.bfloat16, torch.float32):
            for out_dt in (torch.bfloat16, torch.float32):
                for bits in (8, 6):
                    name = (f"{kind} {shape} {str(dt)[6:]}->"
                            f"{str(out_dt)[6:]} bits {bits}")
                    rows.append(time_row(name, kind, shape, dt, out_dt,
                                         bits, gen, reps, log))
    return rows


def ablate(reps, log=print):
    """Each entry of ``ABLATIONS`` and ``VARIANTS`` whose text the tree's
    source holds, built, then timed on GELU bf16 -> bf16 bits 8 beside the
    tree's own build, in two rounds: in order, then in reverse (the card's
    pace drifts by a few per cent over a run)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.attn_times import _install, _patched, _use
    saved = build.lib("act_mrq")
    builds = [("unpatched", None)]
    for i, (name, patches) in enumerate(ABLATIONS + VARIANTS):
        files = _patched("act_mrq", patches)
        if files is None or any(
                text != (build.CSRC / f).read_text()
                for f, text in files.items() if f != "act_mrq.cu"):
            log(f"  ablation '{name}': the source does not hold its text "
                "once; skipped")
            continue
        _install(files["act_mrq.cu"], f"act_ablate{i}", "act_mrq")
        builds.append((name, build.BUILD_DIR / "variants"
                       / f"libact_ablate{i}.so"))
    build._LIBS["act_mrq"] = saved
    rows = []
    for rnd, order in enumerate((builds, builds[::-1])):
        for name, so in order:
            try:
                if so is not None:
                    _use(so, "act_mrq")
                gen = torch.Generator(device="cuda").manual_seed(0)
                row = time_row(f"{name}"[:34], "gelu", (2048, 4608),
                               torch.bfloat16, torch.bfloat16, 8, gen, reps,
                               log)
            finally:
                build._LIBS["act_mrq"] = saved
            row.update(ablation=name, round=rnd)
            rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None,
                    help="import repro_torch from this directory")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--label", default="")
    ap.add_argument("--ablate", action="store_true",
                    help="also time builds with one part off or changed")
    args = ap.parse_args(argv)
    src = args.src or os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "..")
    sys.path.insert(0, os.path.abspath(src))
    import torch
    import repro_torch
    if not torch.cuda.is_available():
        raise SystemExit("act_times: needs a CUDA card")
    print(f"{args.label}: repro_torch from "
          f"{os.path.dirname(repro_torch.__file__)} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    rows = time_cases(args.reps)
    if args.ablate:
        rows += ablate(args.reps)
    print(json.dumps({"label": args.label, "rows": rows}))


if __name__ == "__main__":
    main()
