"""The port's CUDA kernels against their plain versions on the card, at
small ragged shapes that the serving path never produces (M, N, K and the
kv length off every tile edge, N not a multiple of 4, head dims 40 and
128). Marked ``cuda``: each test skips where no GPU is present; run on the
card with ``python -m pytest -m cuda --noconftest tests/test_torch_cuda.py``
(``tests/conftest.py`` imports JAX, which the GPU host lacks).

Tolerances (``repro_torch.kernels.ref.TOLERANCES``): every kernel
bit-exact against its plain version — B1/B2, B4/B5 (also at K = 16 and at
K groups of 40 rows, which straddle the kernel's 64-deep k tile) and B3
(the plain version sums each tile's rows in the kernel's order) — and
B3b (packed kv) equal to unpacked B3 at 4 bits, bit for bit.

The continuous-batching engine equals the sync engine bit for bit on the
card too (tiny DiT, fp and w8a8 kernel context, mixed step buckets).

The per-row-group kernels B6a, B6b, B7a, B7b and B8 are held three ways,
each bit for bit (``vec_vs_plain``, ``vec_vs_scalar_kernel``): against
their plain versions with a mixed group vector; with a constant vector
against the scalar kernel at that group; and with a mixed vector against
the scalar kernel run group by group over each group's rows. A group
entry outside [0, G) reads the nearest group (the kernels clamp it).

The composed attention chain: B9a, B10a and B9b bit-exact against their
plain versions (``B9_vs_plain``, ``B10_vs_plain``; f32 and bf16 in and
out, ragged M and S, 1-row q, head dims 1 to 128, GQA), their
per-row-group siblings B9c, B10b and B9d held the same three ways (GQA
included: no kv copy), the qkv-view seam equal to contiguous rows and to
the plain versions, the serving shape bit for bit in three launches, the
codes made in shared memory equal to the former code pass's IEEE divide
on every edge (2^16 saturation, +-inf; NaN codes to 0, the reference's),
B10a/B10b over row lengths 1 to 1024 (the register instantiations and the
general one) at bits 8, 6 and 4, both matmuls on wgmma,
``ops.int8_attention`` on the card equal to its plain composition and
within ``flash_vs_composed_atol`` of flash, and a refused launch or
failed build raising ``KernelError``.

NaN and +-inf inputs reach every kernel that codes or quantizes them
(the prologue pass, flash's seam, the composed chain, B10, B12, B13): each
equals its plain version there too.

The public kernel API: B11 ``int8_matmul`` over the reference's matmul
shape sweep, B12 ``softmax_mrq`` over its row lengths and B13 ``act_mrq``
over its activation shapes (and a misaligned view), f32 and bf16 in and
out, bits 8 and 6, each bit-exact against its plain version
(``B11_vs_plain``, ``B12_vs_plain``, ``B13_vs_plain``); masked B3, B3b and
B8 (causal, random with fully masked rows, a padding mask on ragged Skv,
GQA) bit-exact against theirs (``B3_mask_vs_plain``), and an all-True
mask equal to the unmasked call.

The int8 GEMM (``csrc/int8_fused.cu::gemm_kernel``, TMA + ``wgmma``,
behind B1, B2, B6a, B6b and B11): bit for bit against the plain versions
at ragged M, N and K (K below one k tile), at M = 8 and on the split-K
path, f32 and bf16 out, with and without bias and gate + residual;
B6a/B6b with G = 10 and 20 groups and out-of-range entries clamped; one
launch per call; and its SASS holds wgmma and TMA loads and no mma.sync.

The prologue pass (``csrc/prologue.cuh``, before every fused linear's
GEMM): alone (``kernels/prologue.py::codes``) bit for bit against its
plain version at M in {8, 36, 2048} and K in {16, 70, 1152, 4608}, bits 8,
6 and 4 (the int4 family's K groups), affine and MRQ, f32 and bf16 x, the
adaLN shift and scale as bf16 or f32 strided chunk views, ps, scalar and
out-of-range per-row groups, +-inf; its shared quotient equal to torch's
division; and a traced full-width forward with no torch layernorm
statistics (no MeanOps, no pow kernel) at every width.
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import int4_packed as F4
from repro_torch.kernels import int8_bmm as IB
from repro_torch.kernels import int8_fused as F8
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    TOLERANCES, flash_vs_composed_atol, gelu_tanh_ref, pack_int4, silu_ref,
)

FA = importlib.import_module("repro_torch.kernels.flash_attn_mrq")
SM = importlib.import_module("repro_torch.kernels.softmax_mrq")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("mrq", [False, True])
@pytest.mark.parametrize("M,K,N", [(37, 70, 45), (130, 200, 131)])
def test_linear_kernel_matches_plain_ragged(dev, mrq, M, K, N):
    g = torch.Generator(device=dev).manual_seed(M + N)
    B, half = 1, 128
    x = torch.randn(M, K, device=dev, generator=g)
    wq = torch.randint(-127, 128, (K, N), device=dev, generator=g,
                       dtype=torch.int8)
    s = torch.full((2, 1), 0.05, device=dev)
    scale = torch.rand(2, N, device=dev, generator=g) * 1e-3
    bv = torch.zeros(M, dtype=torch.int32, device=dev)
    kw = {"nm": (torch.randn(B, K, device=dev, generator=g) * 0.1,
                 torch.randn(B, K, device=dev, generator=g) * 0.1),
          "gr": (torch.randn(B, N, device=dev, generator=g),
                 torch.randn(M, N, device=dev, generator=g)), "bv": bv}
    if mrq:
        run = lambda: F8.int8_matmul_mrq_fq(x, wq, s, s * 2, scale, scale,
                                            None, 1, **kw)
    else:
        corr = torch.randint(-999, 999, (2, N), device=dev, generator=g,
                             dtype=torch.int32)
        run = lambda: F8.int8_matmul_fq(x, wq, s, s * 0 + half, scale, corr,
                                        None, 1, **kw)
    out = run()
    with kernels.plain_on_cuda():
        ref = run()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("S,D", [(77, 40), (300, 128)])
def test_flash_kernel_matches_plain_ragged(dev, S, D):
    g = torch.Generator(device=dev).manual_seed(S)
    q, k, v = (torch.randn(3, S, D, device=dev, generator=g) for _ in range(3))
    s = torch.full((1, 1), 3.0 / 127, device=dev)
    s1 = torch.full((1, 1), 8.0 / S / 128, device=dev)
    args = (q, k, v, s, s, s * s * D ** -0.5, s1, s, s1 * s, s / 128)
    out = FA.flash_attn_mrq(*args)
    with kernels.plain_on_cuda():
        ref = FA.flash_attn_mrq(*args)
    assert (out - ref).abs().max() <= TOLERANCES["B3_vs_plain"][0]


@pytest.mark.parametrize("mrq", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,group_k", [(37, 16, 45, 16),
                                           (130, 100, 131, 40),
                                           (64, 300, 72, 256)])
def test_int4_kernel_matches_plain_ragged(dev, mrq, dt, M, K, N, group_k):
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    B, G = 2, 3
    nk = -(-K // group_k)
    x = torch.randn(M, K, device=dev, generator=g).to(dt)
    codes = torch.randint(-7, 8, (nk * group_k, N), device=dev, generator=g)
    codes[K:] = 0
    wp = pack_int4(codes)
    s = 0.05 + 0.01 * torch.rand(G, 1, device=dev, generator=g)
    scale = torch.rand(G, nk, N, device=dev, generator=g) * 1e-2
    bv = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(
        -(-M // B))[:M].contiguous()
    kw = {"nm": (torch.randn(B, K, device=dev, generator=g) * 0.1,
                 torch.randn(B, K, device=dev, generator=g) * 0.1),
          "gr": (torch.randn(B, N, device=dev, generator=g),
                 torch.randn(M, N, device=dev, generator=g).to(dt)), "bv": bv}
    bias = torch.randn(N, device=dev, generator=g)
    for fused in ({}, kw):
        if mrq:
            run = lambda: F4.int4_matmul_mrq_fq(
                x, wp, s, s * 8, scale, scale * 2, bias, 2, group_k=group_k,
                out_dtype=dt, **fused)
        else:
            corr = torch.randint(-99, 99, (G, nk, N), device=dev, generator=g,
                                 dtype=torch.int32)
            run = lambda: F4.int4_matmul_fq(
                x, wp, s, torch.round(2.0 / s), scale, corr, bias, 2,
                group_k=group_k, out_dtype=dt, **fused)
        out = run()
        with kernels.plain_on_cuda():
            ref = run()
        assert torch.equal(out, ref), (fused.keys(), (out - ref).abs().max())


@pytest.mark.parametrize("S,D", [(77, 40), (300, 72)])
def test_flash_packed_kv_equals_unpacked_4bit(dev, S, D):
    g = torch.Generator(device=dev).manual_seed(S + 4)
    q, k, v = (torch.randn(4, S, D, device=dev, generator=g)
               for _ in range(3))
    s = torch.full((1, 1), 3.0 / 7, device=dev)
    s1 = torch.full((1, 1), 8.0 / S / 8, device=dev)
    args = (q, k[:2].contiguous(), v[:2].contiguous(), s, s,
            s * s * D ** -0.5, s1, s, s1 * s, s / 8)
    before = dict(kernels.LAUNCHES)
    out = FA.flash_attn_mrq(*args, bits=4, packed_kv=True)
    unpacked = FA.flash_attn_mrq(*args, bits=4)
    assert kernels.LAUNCHES["flash_attn_mrq_packed_kv"] == \
        before["flash_attn_mrq_packed_kv"] + 1
    assert torch.equal(out, unpacked)
    with kernels.plain_on_cuda():
        ref = FA.flash_attn_mrq(*args, bits=4, packed_kv=True)
    assert (out - ref).abs().max() <= TOLERANCES["B3_vs_plain"][0]


# ---------------------------------------------------------------------------
# per-row-group kernels (B6a, B6b, B7a, B7b, B8)
# ---------------------------------------------------------------------------
def _vec_linear_case(dev, kind, M, K, N, dt, seed):
    """(scalar wrapper, vec wrapper, positional args without the group,
    fusion kwargs, G): a fused linear of ``kind`` with G = 3 groups."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, G = 2, 3
    int4 = kind.startswith("int4")
    group_k = 40 if int4 else None
    nk = -(-K // group_k) if int4 else 1
    x = torch.randn(M, K, device=dev, generator=g).to(dt)
    s = 0.05 + 0.02 * torch.rand(G, 1, device=dev, generator=g)
    bv = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(
        -(-M // B))[:M].contiguous()
    kw = {"nm": (torch.randn(B, K, device=dev, generator=g) * 0.1,
                 torch.randn(B, K, device=dev, generator=g) * 0.1),
          "gr": (torch.randn(B, N, device=dev, generator=g),
                 torch.randn(M, N, device=dev, generator=g).to(dt)),
          "bv": bv, "out_dtype": dt}
    bias = torch.randn(N, device=dev, generator=g)
    mrq = kind.endswith("mrq")
    if int4:
        codes = torch.randint(-7, 8, (nk * group_k, N), device=dev,
                              generator=g)
        codes[K:] = 0
        w = pack_int4(codes)
        scale = torch.rand(G, nk, N, device=dev, generator=g) * 1e-2
        corr = torch.randint(-99, 99, (G, nk, N), device=dev, generator=g,
                             dtype=torch.int32)
        kw["group_k"] = group_k
        fns = ((F4.int4_matmul_mrq_fq, F4.int4_matmul_mrq_fq_vec) if mrq
               else (F4.int4_matmul_fq, F4.int4_matmul_fq_vec))
        args = ((x, w, s, s * 8, scale, scale * 2, bias) if mrq else
                (x, w, s, torch.round(2.0 / s), scale, corr, bias))
    else:
        w = torch.randint(-127, 128, (K, N), device=dev, generator=g,
                          dtype=torch.int8)
        scale = torch.rand(G, N, device=dev, generator=g) * 1e-3
        corr = torch.randint(-999, 999, (G, N), device=dev, generator=g,
                             dtype=torch.int32)
        fns = ((F8.int8_matmul_mrq_fq, F8.int8_matmul_mrq_fq_vec) if mrq
               else (F8.int8_matmul_fq, F8.int8_matmul_fq_vec))
        args = ((x, w, s, s * 2, scale, scale, bias) if mrq else
                (x, w, s, torch.round(8.0 / s), scale, corr, bias))
    return fns, args, kw, G


def _subset(args, kw, idx):
    """The linear's operands restricted to rows ``idx`` (x, the residual
    and the row -> batch map)."""
    sub_kw = dict(kw)
    sub_kw["bv"] = kw["bv"][idx].contiguous()
    sub_kw["gr"] = (kw["gr"][0], kw["gr"][1][idx].contiguous())
    return (args[0][idx].contiguous(),) + args[1:], sub_kw


@pytest.mark.parametrize("kind", ["int8", "int8_mrq", "int4", "int4_mrq"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(37, 70, 45), (130, 200, 131)])
def test_vec_linear_kernels_three_ways(dev, kind, dt, M, K, N):
    (scalar, vec), args, kw, G = _vec_linear_case(dev, kind, M, K, N, dt,
                                                  M + K + N)
    gv = torch.randint(0, G, (M,), device=dev, dtype=torch.int32,
                       generator=torch.Generator(device=dev).manual_seed(M))
    for fused in ({k: v for k, v in kw.items() if k in
                   ("out_dtype", "group_k")}, kw):
        before = dict(kernels.LAUNCHES)
        out = vec(*args, gv, **fused)
        name = vec.__name__
        assert kernels.LAUNCHES[name] == before[name] + 1
        with kernels.plain_on_cuda():
            ref = vec(*args, gv, **fused)
        assert torch.equal(out, ref), (kind, (out - ref).abs().max())
        const = vec(*args, torch.full_like(gv, 2), **fused)
        assert torch.equal(const, scalar(*args, 2, **fused)), kind
        split = torch.empty_like(out)
        for grp in range(G):
            idx = (gv == grp).nonzero()[:, 0]
            sub_args, sub_kw = (_subset(args, fused, idx) if "bv" in fused
                                else ((args[0][idx].contiguous(),)
                                      + args[1:], fused))
            split[idx] = scalar(*sub_args, grp, **sub_kw)
        assert torch.equal(out, split), kind


@pytest.mark.parametrize("bits,packed_kv", [(8, False), (4, False),
                                            (4, True)])
@pytest.mark.parametrize("S,D", [(77, 40), (300, 72)])
def test_vec_flash_kernel_three_ways(dev, bits, packed_kv, S, D):
    g = torch.Generator(device=dev).manual_seed(S + D + bits)
    BH, G, half = 6, 3, 2 ** (bits - 1)
    q, k, v = (torch.randn(BH, S, D, device=dev, generator=g) * 1.5
               for _ in range(3))
    rate = 1.0 + 0.1 * torch.rand(G, 1, device=dev, generator=g)
    s = rate * (3.0 / (half - 1))
    s1 = rate * (8.0 / S / half)
    args = (q, k, v, s, s * 1.05, s * s * 1.05 * D ** -0.5, s1, s, s1 * s,
            s / half)
    kw = dict(bits=bits, packed_kv=packed_kv)
    g_qk = torch.tensor([0, 2, 1, 1, 0, 2], dtype=torch.int32, device=dev)
    g_pv = torch.tensor([1, 1, 0, 2, 2, 0], dtype=torch.int32, device=dev)
    name = "flash_attn_mrq_vec" + ("_packed_kv" if packed_kv else "")
    before = kernels.LAUNCHES[name]
    out = FA.flash_attn_mrq_vec(*args, g_qk, g_pv, **kw)
    assert kernels.LAUNCHES[name] == before + 1
    with kernels.plain_on_cuda():
        ref = FA.flash_attn_mrq_vec(*args, g_qk, g_pv, **kw)
    assert (out - ref).abs().max() <= TOLERANCES["vec_vs_plain"][0]
    const = FA.flash_attn_mrq_vec(*args, torch.full_like(g_qk, 2),
                                  torch.full_like(g_pv, 1), **kw)
    assert torch.equal(const, FA.flash_attn_mrq(*args, 2, 1, **kw))
    for b in range(BH):        # each row through the scalar kernel
        one = tuple(t[b:b + 1].contiguous() for t in (q, k, v)) + args[3:]
        assert torch.equal(out[b:b + 1], FA.flash_attn_mrq(
            *one, int(g_qk[b]), int(g_pv[b]), **kw)), b


@pytest.mark.parametrize("kind", ["int8", "int8_mrq", "int4", "int4_mrq",
                                  "flash", "flash_packed_kv"])
def test_vec_kernels_clamp_out_of_range_groups(dev, kind):
    """Group entries outside [0, G) read the nearest group: each kernel
    clamps the index on the device, so no read leaves the stacks, and the
    output equals the clamped vector's and the plain version's."""
    if kind.startswith("flash"):
        g = torch.Generator(device=dev).manual_seed(9)
        q, k, v = (torch.randn(6, 77, 40, device=dev, generator=g)
                   for _ in range(3))
        s = 0.03 + 0.01 * torch.rand(3, 1, device=dev, generator=g)
        args = (q, k, v, s, s, s * s * 40 ** -0.5, s * 0.01, s,
                s * s * 0.01, s / 8)
        kw = dict(bits=4, packed_kv=kind.endswith("packed_kv"))
        wild = torch.tensor([-1, 3, 0, 2 ** 30, -2 ** 30, 1],
                            dtype=torch.int32, device=dev)
        groups = (wild, wild.flip(0))
        tame = tuple(t.clamp(0, 2) for t in groups)
        out = FA.flash_attn_mrq_vec(*args, *groups, **kw)
        assert torch.equal(out, FA.flash_attn_mrq_vec(*args, *tame, **kw))
        with kernels.plain_on_cuda():
            ref = FA.flash_attn_mrq_vec(*args, *groups, **kw)
        assert (out - ref).abs().max() <= TOLERANCES["vec_vs_plain"][0]
        return
    (_, vec), args, kw, G = _vec_linear_case(dev, kind, 37, 70, 45,
                                             torch.float32, 3)
    wild = torch.tensor([-5, G, 1, 2 ** 30, -2 ** 30], dtype=torch.int32,
                        device=dev).repeat(8)[:37].contiguous()
    out = vec(*args, wild, **kw)
    assert torch.equal(out, vec(*args, wild.clamp(0, G - 1), **kw))
    with kernels.plain_on_cuda():
        assert torch.equal(out, vec(*args, wild, **kw))


def test_vec_flash_gqa_codes_kv_per_q_row(dev):
    """rep = 2: each q row's k and v codes take that row's groups (the
    kernel codes the kv rows each q row reads with its groups), as the
    plain version does."""
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(4, 70, 40, device=dev, generator=g)
    k, v = (torch.randn(2, 70, 40, device=dev, generator=g) for _ in "kv")
    s = torch.tensor([[0.02], [0.03]], device=dev)
    args = (q, k, v, s, s, s * s * 40 ** -0.5, s * 0.01, s, s * s * 0.01,
            s / 128)
    gq = torch.tensor([0, 1, 1, 0], dtype=torch.int32, device=dev)
    out = FA.flash_attn_mrq_vec(*args, gq, 1 - gq)
    with kernels.plain_on_cuda():
        ref = FA.flash_attn_mrq_vec(*args, gq, 1 - gq)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("quantize", ["none", "w8a8", "w4a4"])
def test_async_engine_matches_sync_on_the_card(dev, quantize):
    """The slot pool's per-slot schedule gathers and the sync sampler's
    host scalars must round alike on CUDA (whose division by a host
    scalar multiplies by its reciprocal): samples bit for bit."""
    from repro_torch.diffusion.ddpm import DiffusionCfg
    from repro_torch.launch.serve import build
    from repro_torch.serving.batching import GenRequest
    from repro_torch.serving.engine import AsyncServeEngine, ServeEngine
    cfg, params, art, _, _, _ = build("dit-xl-2", True, quantize, 0, 1, 2,
                                      4, 1.5, device="cuda")
    dif = DiffusionCfg(T=1000)
    ctx = art.context() if art is not None else None
    reqs = [GenRequest(request_id=i, label=i % 8, steps=(4, 6)[i % 2],
                       cfg_scale=1.5, seed=40 + i) for i in range(5)]
    kw = dict(ctx=ctx, microbatch=2, step_buckets=(4, 6), device="cuda")
    ref = ServeEngine(params, cfg, dif, **kw).serve(reqs)
    before = dict(kernels.LAUNCHES)
    out = AsyncServeEngine(params, cfg, dif, chunk=3, **kw).serve(reqs)
    for rid, o in out.items():
        assert o.status == "OK"
        assert np.array_equal(o.sample, ref[rid].sample), rid
    if quantize != "none":
        assert kernels.LAUNCHES["flash_attn_mrq_vec" + (
            "_packed_kv" if quantize == "w4a4" else "")] > before[
            "flash_attn_mrq_vec" + ("_packed_kv" if quantize == "w4a4"
                                    else "")]


# ---------------------------------------------------------------------------
# composed attention: B9a, B10a, B9b and the per-row-group B9c, B10b, B9d
# ---------------------------------------------------------------------------
def _composed_case(dev, B, M, S, D, bits, G, seed, rep=1):
    """q (B*rep, M, D), k and v (B, S, D), the qk params (s_q, s_k,
    scale), s1 and the pv params (s_v, scale1, scale2), G groups."""
    g = torch.Generator(device=dev).manual_seed(seed)
    half = 2 ** (bits - 1)
    q = torch.randn(B * rep, M, D, device=dev, generator=g) * 1.5
    k, v = (torch.randn(B, S, D, device=dev, generator=g) * 1.5
            for _ in "kv")
    rate = 1.0 + 0.1 * torch.rand(G, 1, device=dev, generator=g)
    s_q = rate * (6.0 / (half - 1))
    s1 = torch.clamp(rate * (8.0 / S / half), 1.0 / (half * half * 8),
                     1.0 / half)
    s_v = rate * (4.0 / (half - 1))
    qk = (s_q, s_q * 1.05, s_q * s_q * 1.05 * D ** -0.5)
    return q, k, v, qk, s1, (s_v, s1 * s_v, s_v / half)


def _plain(fn):
    with kernels.plain_on_cuda():
        return fn()


def _same(a, b):
    """Equal dtype, shape and values, a NaN equal to a NaN."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def _non_finite_rows(x):
    """A copy of (..., C) ``x`` whose first rows hold a NaN, a +inf, a
    -inf among finite scores, only -inf, and both infinities (as many of
    these as there are rows)."""
    x = x.clone()
    r = x.reshape(-1, x.shape[-1])
    C, n = r.shape[-1], r.shape[0]
    fills = [lambda row: row.__setitem__(C // 2, float("nan")),
             lambda row: row.__setitem__(C - 1, float("inf")),
             lambda row: row.__setitem__(0, -float("inf")),
             lambda row: row.fill_(-float("inf")),
             lambda row: (row.__setitem__(0, float("inf")),
                          row.__setitem__(C - 1, -float("inf")))]
    for i, fill in enumerate(fills[:n]):
        fill(r[i])
    return x


@pytest.mark.parametrize("bits", [8, 6, 4])
@pytest.mark.parametrize("B,M,S,D,rep", [(3, 77, 77, 40, 1),
                                         (2, 300, 300, 72, 2),
                                         (4, 1, 130, 17, 1),
                                         # head dims 1 .. 128 (every
                                         # instantiation), M != S off the
                                         # 64-row, 128-row and kv tiles
                                         (2, 130, 77, 1, 1),
                                         (2, 65, 300, 8, 3),
                                         (1, 200, 129, 65, 1),
                                         (2, 256, 256, 80, 1),
                                         (1, 100, 140, 96, 2),
                                         (2, 70, 260, 128, 1)])
def test_composed_kernels_match_plain_ragged(dev, bits, B, M, S, D, rep):
    q, k, v, qk, s1, pv = _composed_case(dev, B, M, S, D, bits, 3,
                                         M + S + D + bits, rep)
    q[0, M // 2, D - 1] = float("nan")        # each codes as the reference
    k[-1, S - 1, 0] = float("inf")
    v[0, 0, D // 2] = -float("inf")
    v[-1, S // 2, 0] = float("nan")
    for dt in (torch.float32, torch.bfloat16):
        qd, kd, vd = (t.to(dt) for t in (q, k, v))
        before = dict(kernels.LAUNCHES)
        qk_bf16 = lambda: IB.int8_bmm_qk(qd, kd, *qk, 1, bits=bits,
                                         out_dtype=torch.bfloat16)
        assert torch.equal(qk_bf16(), _plain(qk_bf16)), (dt, "B9a bf16")
        qk_run = lambda: IB.int8_bmm_qk(qd, kd, *qk, 1, bits=bits)
        scores = qk_run()
        assert torch.equal(scores, _plain(qk_run)), (dt, "B9a")
        for sc in (scores, scores.to(torch.bfloat16),
                   _non_finite_rows(scores)):
            sm_run = lambda: SM.softmax_mrq_codes(sc, s1, 1, bits=bits)
            codes = sm_run()
            assert torch.equal(codes, _plain(sm_run)), (dt, sc.dtype, "B10a")
        codes = SM.softmax_mrq_codes(scores, s1, 1, bits=bits)
        pv_run = lambda: IB.int8_bmm_pv(codes, vd, *pv, 1, bits=bits,
                                        out_dtype=dt)
        out = pv_run()
        assert torch.equal(out, _plain(pv_run)), (dt, "B9b")
        assert out.shape == (B * rep, M, D) and torch.isfinite(out).all()
        after = {n: kernels.LAUNCHES[n] - before[n] for n in before}
        assert {n: c for n, c in after.items() if c} == {
            "int8_bmm_qk": 2, "softmax_mrq_codes": 4, "int8_bmm_pv": 1}
    assert (TOLERANCES["B9_vs_plain"][0], TOLERANCES["B10_vs_plain"][0]) \
        == (0.0, 0.0)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("S,D,rep", [(77, 40, 1), (300, 72, 2),
                                     (130, 8, 3), (256, 96, 2),
                                     (65, 128, 1)])
def test_composed_vec_kernels_three_ways(dev, bits, S, D, rep):
    """B9c, B10b (compact per-batch-row vector and one group per row) and
    B9d against their plain versions, against the scalar kernels with a
    constant vector, and batch row by batch row; under GQA (rep > 1) each
    q row codes its kv rows with its own group (no kv copy)."""
    BH, G = 6, 3
    q, k, v, qk, s1, pv = _composed_case(dev, BH // rep, S, S, D, bits, G,
                                         S + D + bits, rep)
    q = q.to(torch.bfloat16)
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    gv = torch.tensor([0, 2, 1, 1, 0, 2], dtype=torch.int32, device=dev)
    const = torch.full_like(gv, 2)
    before = dict(kernels.LAUNCHES)
    scores = IB.int8_bmm_qk_vec(q, k, *qk, gv, bits=bits)
    assert torch.equal(scores, _plain(
        lambda: IB.int8_bmm_qk_vec(q, k, *qk, gv, bits=bits)))
    assert torch.equal(IB.int8_bmm_qk_vec(q, k, *qk, const, bits=bits),
                       IB.int8_bmm_qk(q, k, *qk, 2, bits=bits))
    codes = SM.softmax_mrq_codes_vec(scores, s1, gv, bits=bits)
    rows = gv[:, None].expand(BH, S).contiguous()
    assert torch.equal(codes, SM.softmax_mrq_codes_vec(scores, s1, rows,
                                                       bits=bits))
    assert torch.equal(codes, _plain(
        lambda: SM.softmax_mrq_codes_vec(scores, s1, gv, bits=bits)))
    assert torch.equal(SM.softmax_mrq_codes_vec(scores, s1, const,
                                                bits=bits),
                       SM.softmax_mrq_codes(scores, s1, 2, bits=bits))
    out = IB.int8_bmm_pv_vec(codes, v, *pv, gv, bits=bits,
                             out_dtype=torch.bfloat16)
    assert torch.equal(out, _plain(lambda: IB.int8_bmm_pv_vec(
        codes, v, *pv, gv, bits=bits, out_dtype=torch.bfloat16)))
    assert torch.equal(
        IB.int8_bmm_pv_vec(codes, v, *pv, const, bits=bits),
        IB.int8_bmm_pv(codes, v, *pv, 2, bits=bits))
    for b in range(BH):        # each batch row through the scalar kernels
        h, kv = int(gv[b]), slice(b // rep, b // rep + 1)
        one = q[b:b + 1].contiguous()
        assert torch.equal(scores[b:b + 1], IB.int8_bmm_qk(
            one, k[kv].contiguous(), *qk, h, bits=bits)), b
        assert torch.equal(codes[b:b + 1], SM.softmax_mrq_codes(
            scores[b:b + 1].contiguous(), s1, h, bits=bits)), b
        assert torch.equal(out[b:b + 1], IB.int8_bmm_pv(
            codes[b:b + 1].contiguous(), v[kv].contiguous(), *pv, h,
            bits=bits, out_dtype=torch.bfloat16)), b
    for name in ("int8_bmm_qk_vec", "softmax_mrq_codes_vec",
                 "int8_bmm_pv_vec"):
        assert kernels.LAUNCHES[name] > before[name], name


def test_composed_vec_kernels_clamp_out_of_range_groups(dev):
    q, k, v, qk, s1, pv = _composed_case(dev, 6, 77, 77, 40, 8, 3, 21)
    wild = torch.tensor([-1, 3, 0, 2 ** 30, -2 ** 30, 1], dtype=torch.int32,
                        device=dev)
    tame = wild.clamp(0, 2)
    scores = IB.int8_bmm_qk(q, k, *qk, 0)
    codes = SM.softmax_mrq_codes(scores, s1, 0)
    for run in (lambda g: IB.int8_bmm_qk_vec(q, k, *qk, g),
                lambda g: SM.softmax_mrq_codes_vec(scores, s1, g),
                lambda g: IB.int8_bmm_pv_vec(codes, v, *pv, g)):
        out = run(wild)
        assert torch.equal(out, run(tame))
        assert torch.equal(out, _plain(lambda: run(wild)))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("vec", [False, True], ids=["scalar", "vec"])
def test_int8_attention_on_the_card(dev, bits, vec):
    """``ops.int8_attention`` (GQA, ragged S) through the kernels equals
    its plain composition, with and without a causal mask, and is within
    the reference's ``flash_vs_composed_atol`` of flash."""
    B, S, Hk, Gq, D, G = 2, 200, 2, 2, 40, 3
    q, k, v, qk, s1, pv = _composed_case(dev, B * Hk, Gq * S, S, D, bits, G,
                                         bits + vec)
    q = q.reshape(B, Hk, Gq, S, D).permute(0, 3, 1, 2, 4).to(torch.bfloat16)
    k, v = (t.reshape(B, Hk, S, D).permute(0, 2, 1, 3).to(torch.bfloat16)
            for t in (k, v))
    packs = ({"s_q": qk[0], "s_k": qk[1], "scale": qk[0] * qk[1],
              "groups": G, "bits": bits},
             {"s1": s1, "s_v": pv[0], "scale1": pv[1], "scale2": pv[2],
              "groups": G, "bits": bits})
    tg = torch.tensor([2, 0], dtype=torch.int32, device=dev) if vec else 1
    kw = dict(scale=D ** -0.5, tgroup=tg)
    for mask in (None, torch.ones(S, S, dtype=torch.bool,
                                  device=dev).tril()):
        run = lambda: ops.int8_attention(q, k, v, *packs, mask=mask, **kw)
        out = run()
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        assert torch.equal(out, _plain(run))
    out = ops.int8_attention(q, k, v, *packs, **kw)
    flash = ops.flash_attention(q, k, v, *packs, **kw)
    atol = max(flash_vs_composed_atol(packs[1], g, S, bits)
               for g in ((2, 0) if vec else (1,)))
    assert float((out.float() - flash.float()).abs().max()) <= atol


def test_composed_refused_launch_and_failed_build_raise(dev, monkeypatch,
                                                        tmp_path):
    """A launch the launcher refuses returns a CUDA error that
    ``build.check`` raises as ``KernelError``; a build that fails raises
    ``KernelError`` from the wrapper. Nothing falls back."""
    from repro_torch.kernels import build
    for name, fn, args in (
            ("int8_bmm", "int8_bmm_qk_launch",
             [0] * 7 + [None, 0, 1, 1, 1, 1, 1, 1.0, 128, 0, 0, 0, 1, 0]),
            ("int8_bmm", "int8_bmm_pv_launch",
             [0] * 7 + [None, 0, 1, 1, 1, 1, 1, 128, 0, 0, 0, 1, 0]),
            ("softmax_mrq", "softmax_mrq_codes_launch",
             [0] * 4 + [0, 1, 1, 128, 0, 0, 1, 0])):
        err = getattr(build.lib(name), fn)(*args)
        with pytest.raises(build.KernelError, match="CUDA error"):
            build.check(err, name, fn)
    q, k, v, qk, s1, pv = _composed_case(dev, 2, 8, 8, 16, 8, 1, 3)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "NVCC_FLAGS",
                        build.NVCC_FLAGS + ["--no-such-nvcc-flag"])
    before = dict(kernels.LAUNCHES)
    with pytest.raises(build.KernelError, match="nvcc failed"):
        IB.int8_bmm_qk(q, k, *qk, 0)
    with pytest.raises(build.KernelError, match="nvcc failed"):
        SM.softmax_mrq_codes(q, s1, 0)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("quantize", ["w8a8", "w4a4"])
def test_async_composed_engine_matches_sync_on_the_card(dev, quantize):
    """The slot pool on the composed chain (B9c -> B10b -> B9d) equals the
    sync engine on the composed context (B9a -> B10a -> B9b), bit for
    bit."""
    from repro_torch.diffusion.ddpm import DiffusionCfg
    from repro_torch.launch.serve import build
    from repro_torch.serving.batching import GenRequest
    from repro_torch.serving.engine import AsyncServeEngine, ServeEngine
    cfg, params, art, _, _, _ = build("dit-xl-2", True, quantize, 0, 1, 2,
                                      4, 1.5, device="cuda",
                                      attn_impl="composed")
    dif = DiffusionCfg(T=1000)
    reqs = [GenRequest(request_id=i, label=i % 8, steps=(4, 6)[i % 2],
                       cfg_scale=1.5, seed=40 + i) for i in range(5)]
    kw = dict(ctx=art.context(), microbatch=2, step_buckets=(4, 6),
              device="cuda")
    assert kw["ctx"].attn_impl == "composed"
    before = dict(kernels.LAUNCHES)
    ref = ServeEngine(params, cfg, dif, **kw).serve(reqs)
    mid = dict(kernels.LAUNCHES)
    out = AsyncServeEngine(params, cfg, dif, chunk=3, **kw).serve(reqs)
    for rid, o in out.items():
        assert o.status == "OK"
        assert np.array_equal(o.sample, ref[rid].sample), rid
    for name in ("int8_bmm_qk", "softmax_mrq_codes", "int8_bmm_pv"):
        assert mid[name] > before[name]
        assert kernels.LAUNCHES[name + "_vec"] > mid[name + "_vec"]
        assert kernels.LAUNCHES[name] == mid[name]


@pytest.mark.parametrize("vec", [False, True], ids=["scalar", "vec"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("S,H,Gq,D", [(77, 3, 1, 8), (256, 2, 1, 72),
                                      (130, 2, 3, 40), (300, 1, 2, 128)])
def test_composed_seam_on_qkv_views_matches_rows(dev, S, H, Gq, D, bits, vec):
    """The composed chain on strided q, k, v views of one projection
    output (GQA: Gq q heads per kv head) equals the chain on their
    contiguous row copies and its plain version, bit for bit: the scores,
    and the output in (B, S, H, Gq, hd) order, one launch each."""
    gen = torch.Generator(device=dev).manual_seed(S + D + bits)
    B, G = 2, 4
    qkv = (torch.randn(B, S, H * (Gq + 2), D, device=dev, generator=gen)
           * 1.5).to(torch.bfloat16)
    q = qkv[:, :, :H * Gq].reshape(B, S, H, Gq, D)
    k, v = qkv[:, :, H * Gq:H * (Gq + 1)], qkv[:, :, H * (Gq + 1):]
    qk, pv = _qkv_packs(dev, bits, G, S, gen)
    gv = (torch.tensor([3, 1], dtype=torch.int32, device=dev)
          .repeat_interleave(H * Gq) if vec else 2)
    qk_fn, pv_fn = ((IB.int8_bmm_qk_vec, IB.int8_bmm_pv_vec) if vec
                    else (IB.int8_bmm_qk, IB.int8_bmm_pv))
    qka = (qk["s_q"], qk["s_k"], qk["scale"])
    pva = (pv["s_v"], pv["scale1"], pv["scale2"])
    before = dict(kernels.LAUNCHES)
    scores = qk_fn(q, k, *qka, gv, bits=bits, alpha=D ** -0.5)
    codes = SM.softmax_mrq_codes_vec(scores, pv["s1"], gv, bits=bits) \
        if vec else SM.softmax_mrq_codes(scores, pv["s1"], gv, bits=bits)
    out = pv_fn(codes, v, *pva, gv, bits=bits, out_dtype=torch.bfloat16)
    sfx = "_vec" if vec else ""
    assert {n: c - before[n] for n, c in kernels.LAUNCHES.items()
            if c != before[n]} == {"int8_bmm_qk" + sfx: 1,
                                   "softmax_mrq_codes" + sfx: 1,
                                   "int8_bmm_pv" + sfx: 1}
    assert out.is_contiguous() and tuple(out.shape) == (B, S, H, Gq, D)
    qr, kr, vr = (t.contiguous() for t in FA.flatten_heads(q, k, v))
    rows = qk_fn(qr, kr, *qka, gv, bits=bits, alpha=D ** -0.5)
    assert torch.equal(scores, rows)
    assert torch.equal(scores, _plain(lambda: qk_fn(
        q, k, *qka, gv, bits=bits, alpha=D ** -0.5)))
    out_rows = pv_fn(codes, vr, *pva, gv, bits=bits,
                     out_dtype=torch.bfloat16)
    assert torch.equal(out, out_rows.reshape(B, H, Gq, S, D)
                       .permute(0, 3, 1, 2, 4))
    assert torch.equal(out, _plain(lambda: pv_fn(
        codes, v, *pva, gv, bits=bits, out_dtype=torch.bfloat16)))


@pytest.mark.parametrize("vec", [False, True], ids=["scalar", "vec"])
@pytest.mark.parametrize("bits", [8, 6, 4])
def test_composed_serving_shape_bit_exact(dev, bits, vec):
    """``ops.int8_attention`` on the (8, 256, 3, 16, 72) bf16 qkv views,
    G = 10: B9a/B9c and B9b/B9d each equal their plain versions bit for
    bit (``B9_vs_plain``, ``vec_vs_plain``: 0.0), the whole call equals
    its plain composition, and an unmasked call is three launches."""
    gen = torch.Generator(device=dev).manual_seed(bits + 10 * vec)
    q, k, v = _qkv_views(dev, 8, 256, 16, 72, torch.bfloat16, gen)
    qk, pv = _qkv_packs(dev, bits, 10, 256, gen)
    tg = (torch.tensor([3, 7, 0, 9, 3, 7, 0, 9], dtype=torch.int32,
                       device=dev) if vec else 4)
    run = lambda: ops.int8_attention(q, k, v, qk, pv, scale=72 ** -0.5,
                                     tgroup=tg)
    before = sum(kernels.LAUNCHES.values())
    out = run()
    assert sum(kernels.LAUNCHES.values()) == before + 3
    assert torch.equal(out, _plain(run))
    gv = ops._groups(qk, tg, 128) if vec else 4
    qk_fn, pv_fn = ((IB.int8_bmm_qk_vec, IB.int8_bmm_pv_vec) if vec
                    else (IB.int8_bmm_qk, IB.int8_bmm_pv))
    qka = (q, k, qk["s_q"], qk["s_k"], qk["scale"], gv)
    scores = qk_fn(*qka, bits=bits, alpha=72 ** -0.5)
    assert torch.equal(scores, _plain(lambda: qk_fn(
        *qka, bits=bits, alpha=72 ** -0.5)))
    codes = SM.softmax_mrq_codes(scores, pv["s1"], 4, bits=bits)
    pva = (codes, v, pv["s_v"], pv["scale1"], pv["scale2"], gv)
    o = pv_fn(*pva, bits=bits, out_dtype=torch.bfloat16)
    assert torch.equal(o, _plain(lambda: pv_fn(*pva, bits=bits,
                                               out_dtype=torch.bfloat16)))
    assert TOLERANCES["B9_vs_plain"][0] == TOLERANCES["vec_vs_plain"][0] \
        == 0.0


def _old_codes(x, s, hi):
    """The composed chain's former code pass (``codes_kernel``):
    fminf(fmaxf(rintf(__fdiv_rn(x, s)), -hi), hi), on the card (torch's
    f32 division is the IEEE one), except that a NaN codes to 0 as in the
    reference (``sym_quantize_int8_ref``), where fmax/fmin read -hi."""
    q = torch.round(x.float() / torch.full_like(x, s, dtype=torch.float32))
    q = torch.fmin(torch.fmax(q, torch.full_like(q, -hi)),
                   torch.full_like(q, hi))
    return torch.where(torch.isnan(x.float()), torch.zeros_like(q), q)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
def test_composed_codes_equal_the_old_code_pass(dev, bits, dt):
    """The codes B9a and B9b make in shared memory (``attn.cuh::sym_code``:
    a * (1/s) and two FMA corrections) against the former pass's IEEE
    divide and rint on every edge: quotients at and around 2^16, half-way
    points, +-inf and NaN of both signs (code 0, the reference's), and
    every bf16 value in range.
    One-hot partners expose the codes: scores = q8 * k8 with k8 the
    identity, out = c . v8 with c the identity, both at scale 1."""
    half = 2 ** (bits - 1)
    hi, D, s = half - 1, 32, 0.0123
    edge = torch.tensor([65536 * s, -65536 * s, 65535.5 * s, -65535.5 * s,
                         65537 * s, 131072 * s, float("inf"), float("-inf"),
                         float("nan"), -float("nan"), (hi + 0.5) * s,
                         -(hi + 0.5) * s, 0.5 * s, 1.5 * s, 2.5 * s, -2.5 * s,
                         0.0, -0.0, 1e-30, -1e-30], device=dev)
    allbf = torch.arange(-32768, 32768, dtype=torch.int32, device=dev) \
        .to(torch.int16).view(torch.bfloat16).float()
    allbf = allbf[(allbf.abs() < 4 * half * s) | ~torch.isfinite(allbf)]
    x = torch.cat([edge, allbf])
    x = torch.nn.functional.pad(x, (0, -x.numel() % D)).reshape(-1, D).to(dt)
    M = x.shape[0]
    one = lambda n, step: (torch.eye(n, D, device=dev) * step).to(dt)
    steps = torch.tensor([[s]], device=dev)
    unit = torch.ones(1, 1, device=dev)
    want = _old_codes(x, s, hi)
    # q coded: k the identity at its own step (k8 = 1 on the diagonal)
    sc = IB.int8_bmm_qk(x[None], one(D, 0.5)[None], steps, unit * 0.5,
                        unit, 0, bits=bits)[0]
    assert torch.equal(sc, want), "q codes"
    # k coded: q the identity
    sc = IB.int8_bmm_qk(one(D, 0.5)[None], x[None], unit * 0.5, steps,
                        unit, 0, bits=bits)[0]
    assert torch.equal(sc.t(), want), "k codes"
    # v coded: the codes the identity, region 1 at scale 1
    codes = torch.eye(M, dtype=torch.int8, device=dev)[None]
    out = IB.int8_bmm_pv(codes, x[None], steps, unit, unit, 0, bits=bits)[0]
    assert torch.equal(out, want), "v codes"


def test_composed_kernels_are_wgmma(dev):
    """Both composed matmuls multiply with wgmma (SASS IGMMA) and hold no
    mma.sync (IMMA, HMMA); the library holds no other kernel (no code
    pre-pass)."""
    from repro_torch.kernels import build
    for kern in ("qk_kernel", "pv_kernel"):
        counts = build.sass_counts("int8_bmm", kern)
        assert counts["IGMMA"] > 0, (kern, counts)
        assert counts["IMMA"] == 0 and counts["HMMA"] == 0, (kern, counts)
    assert not build.sass_counts("int8_bmm", "codes_kernel")


# -- the public kernel API: B11, B12, B13 and flash's boolean mask ----------
MM_SHAPES = [(8, 16, 8), (64, 96, 80), (128, 256, 128), (7, 13, 5),
             (130, 257, 129), (256, 512, 384),
             # the GEMM's split-K path, and one full wave at N = 1152
             (7, 16, 32), (8, 1152, 1152), (130, 4608, 131),
             (2048, 1152, 1152)]


@pytest.mark.parametrize("M,K,N", MM_SHAPES)
def test_int8_matmul_kernel_matches_plain(dev, M, K, N):
    """B11 bit for bit against its plain version over the reference's
    shape sweep, with and without bias, f32 and bf16 out; one launch per
    call."""
    g = torch.Generator(device=dev).manual_seed(M * K + N)
    xq = torch.randint(-128, 128, (M, K), device=dev, generator=g,
                       dtype=torch.int8)
    wq = torch.randint(-128, 128, (K, N), device=dev, generator=g,
                       dtype=torch.int8)
    scale = torch.rand(N, device=dev, generator=g) * 0.01 + 1e-4
    corr = 3 * wq.to(torch.int32).sum(0, dtype=torch.int32)
    bias = torch.randn(N, device=dev, generator=g)
    for b in (bias, None):
        for dt in (torch.float32, torch.bfloat16):
            run = lambda: kernels.int8_matmul(xq, wq, scale, corr, b,
                                              out_dtype=dt)
            before = kernels.LAUNCHES["int8_matmul"]
            out = run()
            assert kernels.LAUNCHES["int8_matmul"] == before + 1
            assert out.dtype == dt and out.shape == (M, N)
            assert torch.equal(out, _plain(run)), (b is None, dt)
    assert TOLERANCES["B11_vs_plain"][0] == 0.0


@pytest.mark.parametrize("bits", [8, 6])
@pytest.mark.parametrize("shape", [(4, 16), (2, 3, 64), (2, 4, 8, 32),
                                   (5, 100), (64, 256), (3, 1000)])
def test_softmax_mrq_kernel_matches_plain(dev, shape, bits):
    """B12 bit for bit against its plain version (the reference's row
    lengths 16, 64, 32, 100 and longer ones), f32 and bf16 scores and out,
    two steps, rows with a NaN or +-inf (a NaN row sum: NaN out, as the
    plain version); one launch per call."""
    g = torch.Generator(device=dev).manual_seed(sum(shape) + bits)
    half = 2 ** (bits - 1)
    s = _non_finite_rows(torch.randn(shape, device=dev, generator=g) * 4)
    for s1 in (0.25 / half, 8.0 / shape[-1] / half):
        for dt in (torch.float32, torch.bfloat16):
            for out_dt in (torch.float32, torch.bfloat16):
                run = lambda: kernels.softmax_mrq(s.to(dt), s1, bits=bits,
                                                  out_dtype=out_dt)
                before = kernels.LAUNCHES["softmax_mrq"]
                out = run()
                assert kernels.LAUNCHES["softmax_mrq"] == before + 1
                assert out.dtype == out_dt and out.shape == s.shape
                assert _same(out, _plain(run)), (s1, dt, out_dt)
                assert bool(torch.isnan(out.reshape(-1, shape[-1])[0]).all())
    assert TOLERANCES["B12_vs_plain"][0] == 0.0


@pytest.mark.parametrize("bits", [8, 6, 4])
@pytest.mark.parametrize("C", [1, 31, 32, 33, 255, 256, 257, 1024])
def test_softmax_codes_kernel_sweep_matches_plain(dev, C, bits):
    """B10a and B10b (the register instantiations at C = 32, 256 and 1024,
    the general one at the other row lengths) bit for bit against their
    plain versions: f32 and bf16 scores, a scalar group and per-slot
    groups (one per batch*head row, entries outside [0, G) clamped), and
    rows with a NaN or +-inf, whose codes are all 0."""
    G, BH, Sq = 5, 6, 37
    half = 2 ** (bits - 1)
    gen = torch.Generator(device=dev).manual_seed(C + bits)
    scores = _non_finite_rows(
        torch.randn(BH, Sq, C, device=dev, generator=gen) * 4)
    rate = 1.0 + 0.1 * torch.rand(G, 1, device=dev, generator=gen)
    s1 = torch.clamp(rate * (8.0 / C / half), 1.0 / (half * half * 8),
                     1.0 / half)
    gv = torch.tensor([0, 4, 2, -1, 7, 3], dtype=torch.int32, device=dev)
    before = dict(kernels.LAUNCHES)
    for dt in (torch.float32, torch.bfloat16):
        sc = scores.to(dt)
        for run in (lambda: SM.softmax_mrq_codes(sc, s1, 3, bits=bits),
                    lambda: SM.softmax_mrq_codes_vec(sc, s1, gv, bits=bits)):
            codes = run()
            assert codes.dtype == torch.int8 and codes.shape == sc.shape
            assert torch.equal(codes, _plain(run)), dt
            rows = codes.reshape(-1, C)
            assert not rows[[0, 1, 3, 4]].any(), dt
            if C >= 32:
                assert bool((rows > 0).any() and (rows < 0).any()), dt
    assert {n: c - before[n] for n, c in kernels.LAUNCHES.items()
            if c != before[n]} == {"softmax_mrq_codes": 2,
                                   "softmax_mrq_codes_vec": 2}
    assert TOLERANCES["B10_vs_plain"][0] == 0.0


def _same_bits(a, b):
    """Equal dtype, shape and bits, signed zeros included, a NaN equal to a
    NaN (not by payload)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = torch.isnan(a)
    iv = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.view(iv)[~nan], b.view(iv)[~nan]))


@pytest.mark.parametrize("kind", ["gelu", "silu"])
@pytest.mark.parametrize("bits", [8, 6])
@pytest.mark.parametrize("shape", [(16, 100), (3, 5, 130), (64, 512),
                                   (2048, 1024), (7,)])
def test_act_mrq_kernel_matches_plain(dev, kind, bits, shape):
    """B13 bit for bit (signed zeros included) against its plain version
    over the reference's shape sweep (and a 7-element tail), f32 and bf16
    in and out, and on a view that starts off the 16-byte boundary (the
    unvectorised path); NaN, +inf and -inf among the inputs (NaN, +(h-1)
    s_pos and NaN out: the activation makes -inf * 0)."""
    g = torch.Generator(device=dev).manual_seed(bits + shape[-1])
    half = 2 ** (bits - 1)
    x = torch.randn(shape, device=dev, generator=g) * 3
    x.view(-1)[1:4] = torch.tensor([float("nan"), float("inf"),
                                    -float("inf")], device=dev)
    sn, sp = 0.17 / half, torch.tensor(6.0 / half, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        for out_dt in (torch.float32, torch.bfloat16):
            run = lambda: kernels.act_mrq(x.to(dt), sn, sp, bits=bits,
                                          kind=kind, out_dtype=out_dt)
            before = kernels.LAUNCHES["act_mrq"]
            out = run()
            assert kernels.LAUNCHES["act_mrq"] == before + 1
            assert out.dtype == out_dt and out.shape == x.shape
            assert _same_bits(out, _plain(run)), (dt, out_dt)
            assert bool(torch.isnan(out.reshape(-1)[1]))
    flat = x.reshape(-1)
    if flat.numel() > 8:
        off = flat[1:]                     # 4 bytes past the allocation
        run = lambda: kernels.act_mrq(off, 0.005, 0.03, bits=bits, kind=kind)
        assert _same_bits(run(), _plain(run))
    assert TOLERANCES["B13_vs_plain"][0] == 0.0


# steps outside the fast quotient's range [2^-100, 2^100]: the general path
ODD_STEPS = (0.0, -0.01, 3 * 2.0 ** -129, 2.0 ** -110, 2.0 ** 110,
             float("inf"), float("nan"))


@pytest.mark.parametrize("bits", [8, 6, 4])
@pytest.mark.parametrize("kind", ["gelu", "silu"])
def test_act_mrq_kernel_every_bf16_pattern(dev, kind, bits):
    """B13 bit for bit (signed zeros included, NaN as NaN) against its
    plain version on all 65,536 bf16 patterns, f32 and bf16 out: at the
    steps (0.17 / half, 6 / half) and (0.005, 0.03), which take the fast
    quotient, and with each step of ``ODD_STEPS`` as s_neg and as s_pos,
    which take the IEEE divide; with positive steps -0 exactly where
    h < 0."""
    half = 2 ** (bits - 1)
    x = (torch.arange(1 << 16, dtype=torch.int32, device=dev) << 16).view(
        torch.float32).to(torch.bfloat16)
    pairs = [(0.17 / half, 6.0 / half), (0.005, 0.03)]
    pairs += [p for s in ODD_STEPS for p in ((s, 0.03), (0.005, s))]
    h = (gelu_tanh_ref if kind == "gelu" else silu_ref)(x.float())
    for sn, sp in pairs:
        steps = (torch.tensor(sn, device=dev), torch.tensor(sp, device=dev))
        for out_dt in (torch.float32, torch.bfloat16):
            run = lambda: kernels.act_mrq(x, *steps, bits=bits, kind=kind,
                                          out_dtype=out_dt)
            out = run()
            assert _same_bits(out, _plain(run)), (sn, sp, out_dt)
            if sn > 0 and sp > 0:
                zero = out == 0
                assert torch.equal(torch.signbit(out.float())[zero],
                                   (h < 0)[zero]), (sn, sp, out_dt)


def test_act_mrq_kernel_rounds_every_tie(dev):
    """f32 ties of the fast quotient through GELU's identity range: for
    x >= 8, h = x exactly (checked on the plain version), so at s_pos =
    1/8 and bits 8 the inputs (k + 0.5) / 8, k = 64..127, put h / s_pos
    on every half-integer from 64.5 to 127.5 (clipped at 127), beside
    them +-1 and +-2 ulps: each output bit for bit the plain version's,
    the ties rounded to even."""
    k = torch.arange(64, 128, device=dev, dtype=torch.float32)
    t = ((k + 0.5) / 8).view(torch.int32)
    x = torch.stack([(t + d).view(torch.float32) for d in (-2, -1, 0, 1, 2)])
    assert torch.equal(gelu_tanh_ref(x), x)
    run = lambda: kernels.act_mrq(x, 0.17 / 128, 0.125, bits=8)
    out = run()
    assert _same_bits(out, _plain(run))
    codes = out[2] * 8
    assert torch.equal(codes, torch.clamp(torch.round(k + 0.5), max=127))
    assert bool((codes[:-1] % 2 == 0).all())


def _mask_case(dev, kind, B, M, N, gen):
    """(B, M, N) boolean: causal; random with every fourth row fully
    masked; or padding (the last N // 4 keys left out)."""
    if kind == "causal":
        return torch.ones(M, N, dtype=torch.bool, device=dev).tril()
    if kind == "random":
        m = torch.rand(B, M, N, device=dev, generator=gen) < 0.5
        m[:, ::4] = False
        return m
    return (torch.arange(N, device=dev) < N - N // 4).expand(B, M, N)


@pytest.mark.parametrize("kind", ["causal", "random", "padding"])
@pytest.mark.parametrize("bits,packed_kv", [(8, False), (4, True)])
@pytest.mark.parametrize("S,Skv,D,rep", [(77, 77, 40, 1), (64, 300, 72, 2),
                                         (5, 13, 16, 1)])
def test_masked_flash_kernels_match_plain(dev, kind, bits, packed_kv, S, Skv,
                                          D, rep):
    """Masked B3 (B3b with packed kv) and B8 bit for bit against their
    plain versions: causal, random with fully masked rows, a padding mask
    on ragged Skv, GQA (rep 2); an all-True mask equals the unmasked call
    bit for bit."""
    g = torch.Generator(device=dev).manual_seed(S + Skv + D + bits)
    B, G, half = 3 * rep, 3, 2 ** (bits - 1)
    q = torch.randn(B, S, D, device=dev, generator=g) * 1.5
    k, v = (torch.randn(B // rep, Skv, D, device=dev, generator=g) * 1.5
            for _ in "kv")
    rate = 1.0 + 0.1 * torch.rand(G, 1, device=dev, generator=g)
    s = rate * (3.0 / (half - 1))
    s1 = rate * (8.0 / Skv / half)
    args = (q, k, v, s, s * 1.05, s * s * 1.05 * D ** -0.5, s1, s, s1 * s,
            s / half)
    mask = _mask_case(dev, kind, B, S, Skv, g)
    kw = dict(bits=bits, packed_kv=packed_kv)
    gv = torch.tensor([0, 2, 1, 1, 0, 2][:B], dtype=torch.int32, device=dev)
    sfx = "_packed_kv" if packed_kv else ""
    for name, run in (
            ("flash_attn_mrq" + sfx,
             lambda m: FA.flash_attn_mrq(*args, 2, 1, mask=m, **kw)),
            ("flash_attn_mrq_vec" + sfx,
             lambda m: FA.flash_attn_mrq_vec(*args, gv, gv, mask=m, **kw))):
        before = kernels.LAUNCHES[name]
        out = run(mask)
        assert kernels.LAUNCHES[name] == before + 1
        assert torch.isfinite(out).all() and out.shape == (B, S, D)
        ref = _plain(lambda: run(mask))
        assert (out - ref).abs().max() <= TOLERANCES["B3_mask_vs_plain"][0]
        ones = torch.ones(B, S, Skv, dtype=torch.bool, device=dev)
        assert torch.equal(run(ones), run(None)), name


# -- the wgmma/TMA int8 GEMM (gemm_kernel: B1, B2, B6a, B6b, B11) -----------
GEMM_SHAPES = ([(M, K, N) for M in (7, 77, 130)
                for K, N in ((16, 32), (129, 131), (4608, 131))]
               + [(8, 1152, 1152), (8, 1152, 6912), (2048, 1152, 1152)])


def _gemm_case(dev, M, K, N, mrq, G, seed):
    """(wrapper, vec wrapper, positional args without bias and group,
    bias, gate + residual, row -> batch map) of a fused int8 linear."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = 2
    x = torch.randn(M, K, device=dev, generator=g)
    wq = torch.randint(-127, 128, (K, N), device=dev, generator=g,
                       dtype=torch.int8)
    s = 0.03 + 0.02 * torch.rand(G, 1, device=dev, generator=g)
    scale = torch.rand(G, N, device=dev, generator=g) * 1e-3
    bias = torch.randn(N, device=dev, generator=g)
    bv = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(
        -(-M // B))[:M].contiguous()
    gr = (torch.randn(B, N, device=dev, generator=g),
          torch.randn(M, N, device=dev, generator=g))
    if mrq:
        x = torch.nn.functional.gelu(x * 2, approximate="tanh")
        return (F8.int8_matmul_mrq_fq, F8.int8_matmul_mrq_fq_vec,
                (x, wq, s * 0.1, s * 2, scale, scale * 0.5), bias, gr, bv)
    corr = torch.randint(-999, 999, (G, N), device=dev, generator=g,
                         dtype=torch.int32)
    return (F8.int8_matmul_fq, F8.int8_matmul_fq_vec,
            (x, wq, s, torch.round(4.0 / s), scale, corr), bias, gr, bv)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mrq", [False, True])
@pytest.mark.parametrize("M,K,N", GEMM_SHAPES)
def test_int8_gemm_matches_plain(dev, M, K, N, mrq, dt):
    """B1 and B2 bit for bit against their plain versions, with and
    without bias and gate + residual, one launch per call: ragged M, N
    and K (K = 16 is below one 128-deep k tile), M = 8 (a weight stream)
    and the split-K path (every M = 8 shape, N = 1152 included, and
    K = 4608 at N = 131)."""
    fn, _, args, bias, gr, bv = _gemm_case(dev, M, K, N, mrq, 2, M + K + N)
    args = (args[0].to(dt),) + args[1:]
    gr = (gr[0], gr[1].to(dt))
    Kp = -16 * (-K // 16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if M == 8 or K == 4608:
        assert F8.split_k(M, N, Kp, sms) > 1
    name = fn.__name__
    for b in (None, bias):
        for fused in ({}, {"gr": gr, "bv": bv}):
            run = lambda: fn(*args, b, 1, out_dtype=dt, **fused)
            before = kernels.LAUNCHES[name]
            out = run()
            assert kernels.LAUNCHES[name] == before + 1
            assert out.dtype == dt and out.shape == (M, N)
            assert torch.equal(out, _plain(run)), (b is None, bool(fused))


@pytest.mark.parametrize("G", [10, 20])
@pytest.mark.parametrize("mrq", [False, True])
@pytest.mark.parametrize("M,K,N", [(130, 129, 131), (8, 1152, 1152),
                                   (2048, 1152, 1152)])
def test_int8_gemm_vec_clamps_and_matches_plain(dev, M, K, N, mrq, G):
    """B6a and B6b with G groups (10: every group's column rows staged in
    shared memory; 20: groups past the 16th read from device memory) and
    group entries outside [0, G): equal to the clamped vector's output
    and to the plain version's, one launch per call."""
    _, vec, args, bias, gr, bv = _gemm_case(dev, M, K, N, mrq, G, M + G)
    args = (args[0].to(torch.bfloat16),) + args[1:]
    gr = (gr[0], gr[1].to(torch.bfloat16))
    gv = torch.randint(-3, G + 3, (M,), dtype=torch.int32, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(G))
    run = lambda v: vec(*args, bias, v, gr=gr, bv=bv,
                        out_dtype=torch.bfloat16)
    name = vec.__name__
    before = kernels.LAUNCHES[name]
    out = run(gv)
    assert kernels.LAUNCHES[name] == before + 1
    assert torch.equal(out, run(gv.clamp(0, G - 1)))
    assert torch.equal(out, _plain(lambda: run(gv)))


def test_int8_gemm_is_wgmma_and_tma(dev):
    """The built GEMM multiplies with wgmma (SASS IGMMA) on tiles that TMA
    loads (UTMALDG), and holds no mma.sync (IMMA, HMMA)."""
    from repro_torch.kernels import build
    counts = build.sass_counts("int8_fused", "gemm_kernel")
    assert counts["IGMMA"] > 0 and counts["UTMALDG"] > 0, counts
    assert counts["IMMA"] == 0 and counts["HMMA"] == 0, counts


# -- the wgmma int4 GEMM (gemm4_kernel: B4, B5, B7a, B7b) -------------------
# (M, K, N, group_k): ragged M on the 128-row (MRQ: 64) and 8-row tiles, N
# off the 128-channel tile, a ragged last K group (K 300 and 600 at 256),
# x_proj's K = group_k = 16, the M = 8 weight streams
GEMM4_SHAPES = ([(M, K, N, gk) for M in (7, 77, 130)
                 for K, N, gk in ((16, 32, 16), (300, 131, 256),
                                  (600, 32, 256))]
                + [(8, 1152, 1152, 256), (8, 256, 131, 256),
                   (2048, 1152, 1152, 256)])


def _gemm4_case(dev, M, K, N, group_k, mrq, G, seed):
    """(wrapper, vec wrapper, positional args without bias and group, bias,
    fusion kwargs by name) of a packed-int4 fused linear with G groups."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = 2
    nk = -(-K // group_k)
    x = torch.randn(M, K, device=dev, generator=g)
    codes = torch.randint(-8, 8, (nk * group_k, N), device=dev, generator=g)
    codes[K:] = 0
    wp = pack_int4(codes)
    s = 0.05 + 0.02 * torch.rand(G, 1, device=dev, generator=g)
    scale = torch.rand(G, nk, N, device=dev, generator=g) * 1e-2
    bias = torch.randn(N, device=dev, generator=g)
    bv = torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(
        -(-M // B))[:M].contiguous()
    fusions = {
        "nm": {"nm": (torch.randn(B, K, device=dev, generator=g) * 0.1,
                      torch.randn(B, K, device=dev, generator=g) * 0.1),
               "bv": bv},
        "gr": {"gr": (torch.randn(B, N, device=dev, generator=g),
                      torch.randn(M, N, device=dev, generator=g)), "bv": bv},
        "ps": {"ps": 0.5 + torch.rand(K, device=dev, generator=g)}}
    if mrq:
        x = torch.nn.functional.gelu(x * 2, approximate="tanh")
        return (F4.int4_matmul_mrq_fq, F4.int4_matmul_mrq_fq_vec,
                (x, wp, s * 0.1, s * 2, scale, scale * 0.5), bias, fusions)
    corr = torch.randint(-999, 999, (G, nk, N), device=dev, generator=g,
                         dtype=torch.int32)
    return (F4.int4_matmul_fq, F4.int4_matmul_fq_vec,
            (x, wp, s, torch.round(2.0 / s), scale, corr), bias, fusions)


def _with_dtype(args, fused, dt):
    args = (args[0].to(dt),) + args[1:]
    if "gr" in fused:
        fused = dict(fused, gr=(fused["gr"][0], fused["gr"][1].to(dt)))
    return args, fused


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mrq", [False, True])
@pytest.mark.parametrize("M,K,N,group_k", GEMM4_SHAPES)
def test_int4_gemm_matches_plain(dev, M, K, N, group_k, mrq, dt):
    """B4 and B5 bit for bit against their plain versions, f32 and bf16
    in and out, with and without bias and each fusion (norm_mod prologue,
    gate + residual epilogue, prescale), one launch per call."""
    fn, _, args, bias, fusions = _gemm4_case(dev, M, K, N, group_k, mrq, 3,
                                             M + K + N)
    name = fn.__name__
    for b in (None, bias):
        for fname, fused in [("none", {})] + list(fusions.items()):
            a, fz = _with_dtype(args, fused, dt)
            run = lambda: fn(*a, b, 2, group_k=group_k, out_dtype=dt, **fz)
            before = kernels.LAUNCHES[name]
            out = run()
            assert kernels.LAUNCHES[name] == before + 1
            assert out.dtype == dt and out.shape == (M, N)
            ref = _plain(run)
            assert torch.equal(out, ref), (b is None, fname,
                                           (out.float() - ref.float()).abs().max())


@pytest.mark.parametrize("G", [10, 20])
@pytest.mark.parametrize("mrq", [False, True])
@pytest.mark.parametrize("M,K,N", [(130, 300, 131), (8, 1152, 1152),
                                   (7, 600, 32)])
def test_int4_gemm_vec_clamps_and_matches_plain(dev, M, K, N, mrq, G):
    """B7a and B7b with G groups, mixed per row (each accumulator reads
    its row's group) and entries outside [0, G): equal to the clamped
    vector's output and to the plain version's, one launch per call."""
    _, vec, args, bias, fusions = _gemm4_case(dev, M, K, N, 256, mrq, G,
                                              M + G)
    a, fz = _with_dtype(args, fusions["gr"], torch.bfloat16)
    gv = torch.randint(-3, G + 3, (M,), dtype=torch.int32, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(G))
    run = lambda v: vec(*a, bias, v, group_k=256, out_dtype=torch.bfloat16,
                        **fz)
    name = vec.__name__
    before = kernels.LAUNCHES[name]
    out = run(gv)
    assert kernels.LAUNCHES[name] == before + 1
    assert torch.equal(out, run(gv.clamp(0, G - 1)))
    assert torch.equal(out, _plain(lambda: run(gv)))


@pytest.mark.parametrize("mrq", [False, True])
@pytest.mark.parametrize("M,block", [(2048, 256), (77, 3), (8, 1)])
def test_int4_gemm_vec_equals_scalar_by_group(dev, M, block, mrq):
    """B7a/B7b against B4/B5: groups in blocks of ``block`` rows (256: every
    tile shares one group, the serving layout; 3 and 1: tiles of mixed
    groups) equal the scalar kernel run group by group over each group's
    rows, and a constant vector equals the scalar kernel at that group."""
    fn, vec, args, bias, fusions = _gemm4_case(dev, M, 1152, 1152, 256, mrq,
                                               10, M + block)
    a, fz = _with_dtype(args, fusions["nm"], torch.bfloat16)
    kw = dict(group_k=256, out_dtype=torch.bfloat16, **fz)
    slots = torch.tensor([3, 7, 0, 9, 3, 7, 0, 9], dtype=torch.int32,
                         device=dev)
    gv = slots.repeat_interleave(block).repeat(-(-M // (8 * block)))[:M]
    gv = gv.contiguous()
    out = vec(*a, bias, gv, **kw)
    assert torch.equal(out, _plain(lambda: vec(*a, bias, gv, **kw)))
    assert torch.equal(vec(*a, bias, torch.full_like(gv, 7), **kw),
                       fn(*a, bias, 7, **kw))
    for grp in sorted(set(gv.tolist())):
        rows = gv == grp
        assert torch.equal(out[rows], fn(*a, bias, grp, **kw)[rows]), grp


def test_int4_gemm_is_wgmma_and_tma(dev):
    """The built int4 GEMM multiplies with wgmma (SASS IGMMA) on code tiles
    that TMA loads (UTMALDG), and holds no mma.sync (IMMA, HMMA)."""
    from repro_torch.kernels import build
    counts = build.sass_counts("int4_packed", "gemm4_kernel")
    assert counts["IGMMA"] > 0 and counts["UTMALDG"] > 0, counts
    assert counts["IMMA"] == 0 and counts["HMMA"] == 0, counts


# -- the one-launch flash kernel (flash_kernel: B3, B3b, B8) -----------------
def _qkv_packs(dev, bits, G, S, gen):
    """A (G,)-group qk and pv pack pair of the serving path's form."""
    half = 2 ** (bits - 1)
    rate = 1.0 + 0.1 * torch.rand(G, 1, device=dev, generator=gen)
    s_q = rate * (6.0 / (half - 1))
    s1 = torch.clamp(8.0 * (1.0 / S) / half * rate, 1.0 / (half * half * 8),
                     1.0 / half)
    s_v = rate * (4.0 / (half - 1))
    qk = {"s_q": s_q, "s_k": s_q * 1.05, "scale": s_q * s_q * 1.05,
          "bits": bits, "groups": G}
    pv = {"s1": s1, "s_v": s_v, "scale1": s1 * s_v,
          "scale2": s_v * (1.0 / half), "bits": bits, "groups": G}
    return qk, pv


def _qkv_views(dev, B, S, H, hd, dt, gen):
    """q, k, v as the DiT block views one (B, S, 3, H, hd) qkv output."""
    qkv = (torch.randn(B, S, 3, H, hd, device=dev, generator=gen)
           * 1.5).to(dt)
    return qkv[:, :, 0].reshape(B, S, H, 1, hd), qkv[:, :, 1], qkv[:, :, 2]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 6, 4])
@pytest.mark.parametrize("S", [77, 256, 300])
@pytest.mark.parametrize("D", [8, 40, 72, 128])
def test_flash_seam_on_qkv_views_matches_plain(dev, D, S, bits, dt):
    """``ops.flash_attention`` on the strided q, k, v views of a qkv
    projection output (the serving seam; bits 4 runs B3b): one launch,
    output in (B, S, H, 1, hd) order, bit for bit the plain version's,
    with a NaN and +-inf among q, k and v (each codes as the reference:
    NaN to 0, +-inf to +-(h-1))."""
    gen = torch.Generator(device=dev).manual_seed(D + S + bits)
    q, k, v = _qkv_views(dev, 2, S, 3, D, dt, gen)
    q[0, S // 2, 1, 0, D - 1] = float("nan")
    k[1, 0, 2, 0] = float("inf")
    k[0, S - 1, 0, D // 2] = float("nan")
    v[1, S // 3, 0, 0] = -float("inf")
    v[0, 1, 1, D - 1] = float("nan")
    qk, pv = _qkv_packs(dev, bits, 4, S, gen)
    name = "flash_attn_mrq" + ("_packed_kv" if bits == 4 else "")
    run = lambda: ops.flash_attention(q, k, v, qk, pv, scale=D ** -0.5,
                                      tgroup=2)
    before = kernels.LAUNCHES[name]
    out = run()
    assert kernels.LAUNCHES[name] == before + 1
    assert out.is_contiguous() and tuple(out.shape) == (2, S, 3, 1, D)
    with kernels.plain_on_cuda():
        ref = run()
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max() <= \
        TOLERANCES["B3_vs_plain"][0]


@pytest.mark.parametrize("out_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,packed_kv", [(8, False), (6, False),
                                            (4, False), (4, True)])
@pytest.mark.parametrize("M,N,D", [(77, 300, 72), (300, 40, 40)])
def test_flash_gqa_rep2_m_ne_n_matches_plain(dev, M, N, D, bits, packed_kv,
                                             out_dt):
    """The public (B, M, D) entry point at M != N and rep = 2 (q rows 2j,
    2j + 1 read kv row j), bf16 in, f32 or bf16 out; B3b equals unpacked
    B3 at bits 4."""
    gen = torch.Generator(device=dev).manual_seed(M + N + bits)
    half = 2 ** (bits - 1)
    q = torch.randn(4, M, D, device=dev, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(2, N, D, device=dev, generator=gen)
            .to(torch.bfloat16) for _ in "kv")
    s = torch.tensor([[0.03], [0.025]], device=dev) * 8 / half
    s1 = torch.clamp(s * 0.3, 1.0 / (half * half * 8), 1.0 / half)
    args = (q, k, v, s, s, s * s * D ** -0.5, s1, s, s1 * s, s / half, 1, 0)
    kw = dict(bits=bits, packed_kv=packed_kv, out_dtype=out_dt)
    out = FA.flash_attn_mrq(*args, **kw)
    with kernels.plain_on_cuda():
        ref = FA.flash_attn_mrq(*args, **kw)
    assert (out.float() - ref.float()).abs().max() <= \
        TOLERANCES["B3_vs_plain"][0]
    if packed_kv:
        assert torch.equal(out, FA.flash_attn_mrq(*args, bits=4,
                                                  out_dtype=out_dt))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("S,D", [(77, 40), (256, 72)])
def test_flash_seam_vec_equals_scalar_by_slot(dev, S, D, bits):
    """B8 on the seam: a per-slot tgroup (mixed groups) equals the plain
    version and, slot by slot, the scalar kernel at that slot's group."""
    gen = torch.Generator(device=dev).manual_seed(S * bits + D)
    B, H = 4, 3
    q, k, v = _qkv_views(dev, B, S, H, D, torch.bfloat16, gen)
    qk, pv = _qkv_packs(dev, bits, 5, S, gen)
    slots = torch.tensor([3, 0, 4, 3], dtype=torch.int32, device=dev)
    run = lambda tg: ops.flash_attention(q, k, v, qk, pv, scale=D ** -0.5,
                                         tgroup=tg)
    name = "flash_attn_mrq_vec" + ("_packed_kv" if bits == 4 else "")
    before = kernels.LAUNCHES[name]
    out = run(slots)
    assert kernels.LAUNCHES[name] == before + 1
    with kernels.plain_on_cuda():
        assert (out.float() - run(slots).float()).abs().max() <= \
            TOLERANCES["vec_vs_plain"][0]
    for b, grp in enumerate(slots.tolist()):
        assert torch.equal(out[b], run(grp)[b]), b


@pytest.mark.parametrize("kind", ["causal", "random", "padding"])
@pytest.mark.parametrize("vec", [False, True], ids=["scalar", "vec"])
def test_flash_seam_masked_matches_plain(dev, kind, vec):
    """``ops.flash_attention(mask=...)`` on the qkv views: a causal mask,
    a random one with fully masked rows, a padding mask on ragged kv."""
    gen = torch.Generator(device=dev).manual_seed(3)
    B, S, H, D = 2, 77, 2, 40
    q, k, v = _qkv_views(dev, B, S, H, D, torch.float32, gen)
    qk, pv = _qkv_packs(dev, 8, 3, S, gen)
    if kind == "causal":
        mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    elif kind == "random":
        mask = torch.rand(B, H, 1, S, S, device=dev, generator=gen) < 0.6
        mask[:, :, :, :5] = False              # fully masked rows
    else:
        mask = (torch.arange(S, device=dev) < 60)[None, None, None, None]
    tg = torch.tensor([2, 0], dtype=torch.int32, device=dev) if vec else 1
    run = lambda: ops.flash_attention(q, k, v, qk, pv, mask=mask,
                                      scale=D ** -0.5, tgroup=tg)
    out = run()
    with kernels.plain_on_cuda():
        ref = run()
    assert (out - ref).abs().max() <= TOLERANCES["B3_mask_vs_plain"][0]


def test_flash_forward_launches_one_kernel_per_attention(dev):
    """Under the profiler: one ``ops.flash_attention`` call on the qkv
    views is one kernel (``flash_kernel``: no ``codes_kernel``, no copy of
    the heads in or out), and a quantized DiT forward launches no
    ``codes_kernel`` and one flash kernel per block (the wrappers' counts;
    the profiler may drop an event, so it is held to at most one a
    block)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import build
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = _qkv_views(dev, 2, 256, 4, 72, torch.bfloat16, gen)
    qk, pv = _qkv_packs(dev, 8, 3, 256, gen)
    run = lambda: ops.flash_attention(q, k, v, qk, pv, scale=72 ** -0.5,
                                      tgroup=1)
    run()
    torch.cuda.synchronize()

    def kernels_of(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    before = kernels.LAUNCHES["flash_attn_mrq"]
    names = kernels_of(run)
    assert kernels.LAUNCHES["flash_attn_mrq"] == before + 1
    assert len(names) <= 1 and all("flash_kernel" in n for n in names), names
    cfg, _, _, engine, sq, _ = build("dit-xl-2", True, "w8a8", 0, 2, 2, 2,
                                     1.5, device="cuda")
    from repro_torch.serving.batching import coalesce
    mb = coalesce(sq.pending, 2, (2,))[0]
    engine.run_microbatch(mb)
    torch.cuda.synchronize()
    before = kernels.LAUNCHES["flash_attn_mrq"]
    names = kernels_of(lambda: engine.run_microbatch(mb))
    launched = kernels.LAUNCHES["flash_attn_mrq"] - before
    assert launched and launched % cfg.n_layers == 0, launched
    assert not any("codes_kernel" in n for n in names), names
    assert 0 < sum("flash_kernel" in n for n in names) <= launched


def test_flash_quotient_equals_the_ieee_divide(dev):
    """The kernel's correctly rounded quotient (``div_rn``: a * (1/b) and
    two FMA corrections) against torch's IEEE division on the card: every
    finite bf16 numerator over the quantizer's steps, and random
    probabilities over row denominators and over s1."""
    a = torch.arange(-32768, 32768, dtype=torch.int32, device=dev)
    a = (a.to(torch.int16).view(torch.bfloat16)).float()
    a = a[torch.isfinite(a)]
    for s in (0.0123, 0.047244094, 1.0 / 127, 0.5, 3.3):
        b = torch.full_like(a, s)
        q = (a / b).abs()      # the range the kernel reads codes from
        ok = (q < 65536) & ((q > 2.0 ** -100) | (a == 0))
        got = FA.div_probe(a[ok], b[ok])
        bad = int((got != a[ok] / b[ok]).sum())
        assert bad == 0, (s, bad)
    gen = torch.Generator(device=dev).manual_seed(0)
    e = torch.rand(1 << 22, device=dev, generator=gen)
    for lo, hi in ((1.0, 300.0), (1e-5, 1.0 / 8)):
        b = lo + (hi - lo) * torch.rand(1 << 22, device=dev, generator=gen)
        assert torch.equal(FA.div_probe(e, b), e / b), (lo, hi)


def test_flash_kernel_is_wgmma(dev):
    """The built flash kernel multiplies with wgmma (SASS IGMMA) and holds
    no mma.sync (IMMA, HMMA)."""
    from repro_torch.kernels import build
    counts = build.sass_counts("flash_attn_mrq", "flash_kernel")
    assert counts["IGMMA"] > 0, counts
    assert counts["IMMA"] == 0 and counts["HMMA"] == 0, counts


# -- the prologue pass (csrc/prologue.cuh) -----------------------------------
PRO = importlib.import_module("repro_torch.kernels.prologue")
PRO_GROUP_K = {16: (16,), 70: (16, 40), 1152: (256, 16), 4608: (256,)}


def _prologue_inputs(dev, M, K, bits, mrq, gen):
    """x (f32) with a post-GELU-like sign split for MRQ; G = 10 step
    stacks; the adaLN output (B, 6K) whose first two chunks are shift
    and scale; ps; a per-row group vector with entries outside [0, 10)."""
    half, G, B = 2 ** (bits - 1), 10, 4
    x = torch.randn(M, K, device=dev, generator=gen) * 2
    if mrq:
        x = torch.nn.functional.gelu(x, approximate="tanh")
    rate = 1.0 + 0.1 * torch.rand(G, 1, device=dev, generator=gen)
    if mrq:
        s_a, s_b = rate * (0.2 / half), rate * (6.0 / half)
    else:
        s_a = rate * (8.0 / (2 * half - 1))
        s_b = torch.round(4.0 / s_a)
    ada = torch.randn(B, 6 * K, device=dev, generator=gen) * 0.1
    ps = 0.75 + 0.5 * torch.rand(K, device=dev, generator=gen)
    gv = torch.randint(-2, G + 2, (M,), device=dev, generator=gen,
                       dtype=torch.int32)
    bv = torch.arange(B, dtype=torch.int32, device=dev) \
        .repeat_interleave(M // B if M >= B else 1)[:M].contiguous()
    return x, s_a, s_b, ada, ps, gv, bv


@pytest.mark.parametrize("bits,mrq", [(8, False), (8, True), (6, False),
                                      (6, True), (4, False), (4, True)])
@pytest.mark.parametrize("K", [16, 70, 1152, 4608])
@pytest.mark.parametrize("M", [8, 36, 2048])
def test_prologue_pass_matches_plain(dev, M, K, bits, mrq):
    """The pass alone (``prologue.codes``) against its plain version bit
    for bit (``B1_norm_mod_vs_plain``, ``B1_vs_plain``): every code plane
    over f32 and bf16 x, no norm_mod or the adaLN shift and scale as
    strided chunk views of a bf16 or f32 (B, 6K) output, ps off and on,
    a scalar group and a per-row vector with out-of-range entries, in
    the int8 family's layout (bits 8, 6) and the int4 family's (bits 4,
    K groups of 16 and 40 or 256). The x carries a NaN and +-inf (with
    norm_mod they make their rows' statistics NaN): each codes as the
    reference, NaN to 0 (affine) and (0, 0) (MRQ)."""
    gen = torch.Generator(device=dev).manual_seed(M + K + bits + mrq)
    x, s_a, s_b, ada, ps, gv, bv = _prologue_inputs(dev, M, K, bits, mrq,
                                                    gen)
    widths = ([{}] if bits > 4 else
              [{"gk": gk, "gkp": -128 * (-gk // 128)}
               for gk in PRO_GROUP_K[K]])
    n = 0
    for width in widths:
        for xdt in (torch.float32, torch.bfloat16):
            for mdt in (None, torch.bfloat16, torch.float32):
                xx = x.clone()
                xx[M // 2, K // 2] = float("nan")
                xx[0, 0], xx[-1, -1] = float("inf"), -float("inf")
                nm = None
                if mdt is not None:
                    nm = torch.chunk(ada.to(mdt), 6, dim=-1)[:2]
                xx = xx.to(xdt)
                for p in (None, ps):
                    for g in (3, gv):
                        kw = dict(mrq=mrq, bits=bits, ps=p, nm=nm, bv=bv,
                                  **width)
                        out = PRO.codes(xx, s_a, s_b, g, **kw)
                        ref = PRO.codes_plain(xx, s_a, s_b, g, **kw)
                        torch.cuda.synchronize()
                        assert out.shape == ref.shape
                        bad = int((out != ref).sum())
                        assert bad == 0, (width, xdt, mdt, p is None,
                                          torch.is_tensor(g), bad)
                        n += 1
    assert n == 24 * len(widths)


def test_prologue_quotient_equals_the_ieee_divide(dev):
    """The shared quotient (``div_rn``, csrc/common.cuh) equals torch's
    division, and the pass's rounded quotient (``rint_div``) equals
    torch.round of it below 2^16 and saturates beyond: every finite bf16
    numerator against the serving steps at 8, 6 and 4 bits (affine and
    MRQ), and 4M random f32 numerators of the same ranges."""
    a = torch.arange(-32768, 32768, dtype=torch.int32, device=dev)
    a = (a.to(torch.int16).view(torch.bfloat16)).float()
    a = a[torch.isfinite(a)]
    gen = torch.Generator(device=dev).manual_seed(0)
    steps = []
    for half in (128, 32, 8):
        for rate in (1.0, 1.0371, 1.0999):
            steps += [rate * 8.0 / (2 * half - 1), rate * 0.2 / half,
                      rate * 6.0 / half]
    rnd = torch.randn(1 << 22, device=dev, generator=gen) * 3
    for s in steps:
        for num in (a, rnd):
            b = torch.full_like(num, s)
            want = num / b
            q, r = PRO.div_probe(num, b)
            ok = (want.abs() < 65536) & ((want.abs() > 2.0 ** -100)
                                         | (num == 0))
            assert torch.equal(q[ok], want[ok]), s
            small = want.abs() < 65536
            assert torch.equal(r[small], torch.round(want[small])), s
            big = ~small
            assert bool(((r[big].abs() >= 65535) & (torch.sign(r[big])
                         == torch.sign(want[big]))).all()), s


@pytest.mark.parametrize("bits", ["w8a8", "w6a6", "w4a4"])
def test_forward_launches_no_torch_layernorm_stats(dev, bits):
    """A profiled full-width DiT-XL/2 forward (depth cut to 2 blocks) at
    each width: the layernorm statistics of the norm-modulated linears run
    inside the prologue pass, so the trace holds no torch MeanOps
    reduction and no pow kernel."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import dit_xl_2
    from repro_torch.diffusion.ddpm import DiffusionCfg, make_schedule
    from repro_torch.launch.serve import perturb_init
    from repro_torch.models.dit import dit_apply, dit_init
    from repro_torch.quant.api import quantize
    from repro_torch.quant.recipe import QuantRecipe
    cfg = dataclasses.replace(dit_xl_2.full(), n_layers=2)
    params = perturb_init(dit_init(0, cfg, device=dev), 0)
    dif = DiffusionCfg(T=1000)
    art = quantize(params, cfg, dif, QuantRecipe(bits=bits, method="range"),
                   sched=make_schedule(dif))
    ctx = art.context().with_tgroup(5)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(8, cfg.img_size, cfg.img_size, cfg.in_ch, device=dev,
                    generator=gen)
    t = torch.full((8,), 500, dtype=torch.int64, device=dev)
    y = torch.arange(8, device=dev) % cfg.n_classes
    with torch.no_grad():
        dit_apply(params, cfg, x, t, y, ctx=ctx)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = dit_apply(params, cfg, x, t, y, ctx=ctx)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert torch.isfinite(out.float()).all()
    assert any("prologue_rows_kernel" in n for n in names), names
    assert not [n for n in names if "MeanOps" in n or "pow_" in n], names


# ---------------------------------------------------------------------------
# the dense LM's shapes: B1 at M = 4 and the tied lm_head, B3 under GQA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 6])
@pytest.mark.parametrize("K,N,transposed", [(2048, 2048, False),
                                            (6144, 2048, False),
                                            (2048, 151936, True)],
                         ids=["q", "down", "lm_head"])
def test_lm_linear_m4_and_strided_head_match_plain(dev, K, N, transposed,
                                                   bits, dt):
    """B1 at a decode step's M = 4 rows, one launch, bit for bit its
    plain version; the tied lm_head's weight codes are the transposed
    view of an (N, K) tensor (``emb.T``), not a contiguous copy."""
    g = torch.Generator(device=dev).manual_seed(K + N + bits)
    half = 2 ** (bits - 1)
    x = torch.randn(4, K, device=dev, generator=g).to(dt)
    shape = (N, K) if transposed else (K, N)
    wq = torch.randint(-(half - 1), half, shape, device=dev, generator=g,
                       dtype=torch.int8)
    wq = wq.T if transposed else wq
    assert wq.is_contiguous() != transposed
    sx = torch.full((1, 1), 8.0 / (2 * half - 1), device=dev)
    zx = torch.round(4.0 / sx)
    scale = sx * (torch.rand(1, N, device=dev, generator=g) * 1e-3 + 1e-4)
    corr = (torch.round(zx).to(torch.int32) - half) * wq.to(
        torch.int32).sum(0, dtype=torch.int32)[None]
    run = lambda: F8.int8_matmul_fq(x, wq, sx, zx, scale, corr, None, 0,
                                    bits=bits, out_dtype=dt)
    before = kernels.LAUNCHES["int8_matmul_fq"]
    out = run()
    assert kernels.LAUNCHES["int8_matmul_fq"] == before + 1
    assert torch.equal(out, _plain(run))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["causal", "decode"])
def test_lm_flash_gqa_masks_match_plain_and_expanded_heads(dev, kind, dt):
    """B3 at head dim 128 with G = 2 query heads per kv head (kv heads
    that differ), under the LM's causal (B, 1, 1, S, S) mask and a decode
    row's (1, 1, 1, 1, Skv) validity mask over a ragged cache: one launch,
    bit for bit its plain version, and bit for bit the same call with
    each kv head materialised for its two query heads (G = 1), so query
    head h reads kv head h // G."""
    gen = torch.Generator(device=dev).manual_seed(128)
    B, Hk, G, hd, S = 2, 4, 2, 128, 300
    Sq = S if kind == "causal" else 1
    q = (torch.randn(B, Sq, Hk, G, hd, device=dev, generator=gen) * 1.5
         ).to(dt)
    k, v = ((torch.randn(B, S, Hk, hd, device=dev, generator=gen) * 1.5
             ).to(dt) for _ in "kv")
    if kind == "causal":
        mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()[
            None, None, None].expand(B, 1, 1, S, S)
    else:
        mask = (torch.arange(S, device=dev) <= 250)[None, None, None, None]
    qk, pv = _qkv_packs(dev, 8, 1, S, gen)
    run = lambda: ops.flash_attention(q, k, v, qk, pv, mask=mask,
                                      scale=hd ** -0.5)
    before = kernels.LAUNCHES["flash_attn_mrq"]
    out = run()
    assert kernels.LAUNCHES["flash_attn_mrq"] == before + 1
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, _plain(run))
    kx, vx = (t.repeat_interleave(G, dim=2) for t in (k, v))
    flat = ops.flash_attention(q.reshape(B, Sq, Hk * G, 1, hd), kx, vx, qk,
                               pv, mask=mask, scale=hd ** -0.5)
    assert torch.equal(out.reshape(flat.shape), flat)


# ---------------------------------------------------------------------------
# the SSM and hybrid LMs' shapes: B1 at ragged N, B3 at hd 64 with G 5 and
# hymba's meta prefix + window mask, a hymba-smoke forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [4, 300])
@pytest.mark.parametrize("K,N,transposed", [(768, 3352, False),
                                            (1600, 6482, False),
                                            (1600, 32001, True),
                                            (768, 50280, True)],
                         ids=["mamba2-in_proj", "hymba-in_proj",
                              "hymba-lm_head", "mamba2-lm_head"])
def test_ssm_linear_ragged_n_matches_plain(dev, K, N, transposed, M, dt):
    """B1 where N is not a multiple of 8 (Mamba-2's and Hymba's in_proj)
    or is odd (the tied lm_heads, their weight a transposed view): the
    GEMM's scalar store paths, one launch, bit for bit its plain
    version."""
    g = torch.Generator(device=dev).manual_seed(K + N + M)
    half = 128
    x = torch.randn(M, K, device=dev, generator=g).to(dt)
    shape = (N, K) if transposed else (K, N)
    wq = torch.randint(-(half - 1), half, shape, device=dev, generator=g,
                       dtype=torch.int8)
    wq = wq.T if transposed else wq
    sx = torch.full((1, 1), 8.0 / (2 * half - 1), device=dev)
    zx = torch.round(4.0 / sx)
    scale = sx * (torch.rand(1, N, device=dev, generator=g) * 1e-3 + 1e-4)
    corr = (torch.round(zx).to(torch.int32) - half) * wq.to(
        torch.int32).sum(0, dtype=torch.int32)[None]
    run = lambda: F8.int8_matmul_fq(x, wq, sx, zx, scale, corr, None, 0,
                                    bits=8, out_dtype=dt)
    before = kernels.LAUNCHES["int8_matmul_fq"]
    out = run()
    assert kernels.LAUNCHES["int8_matmul_fq"] == before + 1
    assert torch.equal(out, _plain(run))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_hybrid_flash_meta_window_matches_plain(dev, kind, dt):
    """B3 at head dim 64 with G = 5 query heads per kv head over a kv of
    32 meta tokens + the sequence: the meta prefix visible to every query,
    a sliding window of 100 on the causal mask (prefill, S 300), or one
    decode row over a ragged cache: one launch, bit for bit its plain
    version."""
    gen = torch.Generator(device=dev).manual_seed(64)
    B, Hk, G, hd, S, n_meta, window = 2, 5, 5, 64, 300, 32, 100
    Sq = S if kind == "prefill" else 1
    Skv = n_meta + S
    q = (torch.randn(B, Sq, Hk, G, hd, device=dev, generator=gen) * 1.5
         ).to(dt)
    k, v = ((torch.randn(B, Skv, Hk, hd, device=dev, generator=gen) * 1.5
             ).to(dt) for _ in "kv")
    kpos = torch.arange(S, device=dev)
    qpos = kpos if kind == "prefill" else torch.tensor([250], device=dev)
    live = (kpos[None, :] <= qpos[:, None]) & (
        kpos[None, :] > qpos[:, None] - window)
    mask = torch.cat([torch.ones(Sq, n_meta, dtype=torch.bool, device=dev),
                      live], dim=1)[None, None, None].expand(B, 1, 1, Sq,
                                                             Skv)
    qk, pv = _qkv_packs(dev, 8, 1, Skv, gen)
    run = lambda: ops.flash_attention(q, k, v, qk, pv, mask=mask,
                                      scale=hd ** -0.5)
    before = kernels.LAUNCHES["flash_attn_mrq"]
    out = run()
    assert kernels.LAUNCHES["flash_attn_mrq"] == before + 1
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, _plain(run))


def test_hymba_smoke_forward_matches_plain(dev):
    """W8A8 ``hymba-smoke`` calibrated and served on the card: every
    linear on B1 (the meta rows' k and v included) and every attention
    call on B3 with the meta prefix and the window in its mask; the
    logits equal the plain versions' bit for bit, and prefill + 2 decode
    steps run on the kernels."""
    from repro_torch.configs import get_smoke
    from repro_torch.core import calib
    from repro_torch.core.baselines import tq_dit
    from repro_torch.core.contexts import QuantContext
    from repro_torch.core.ptq import run_ptq
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.diffusion import rng
    from repro_torch.models import lm
    cfg = get_smoke("hymba-1.5b")
    p = lm.lm_init(rng.PRNGKey(0, device=dev), cfg, device=dev)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, batch=2, seed=5)
    batches = calib.build_lm_calibration(
        [pipe.batch_at(i, device=dev)["tokens"] for i in range(2)])
    qp, rep = run_ptq(calib.lm_loss_fn(p, cfg), batches,
                      tq_dit(8, 8, n_alpha=4, rounds=1), device=dev)
    packed = ops.convert_for_kernels(
        qp, {k: torch.as_tensor(w).to(dev) for k, w in rep["weights"].items()})
    ctx = QuantContext(qparams=packed, kernel=True)
    toks = pipe.batch_at(100, device=dev)["tokens"]
    L = cfg.n_layers
    before = dict(kernels.LAUNCHES)
    with torch.no_grad():
        out = lm.lm_apply(p, cfg, toks, ctx=ctx)[0]
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        ref = _plain(lambda: lm.lm_apply(p, cfg, toks, ctx=ctx)[0])
        gen = lm.lm_generate(p, cfg, toks, 2, ctx=ctx)
    assert launched["int8_matmul_fq"] == 11 * L + 1
    assert launched["flash_attn_mrq"] == L
    assert torch.isfinite(out).all() and torch.equal(out, ref)
    assert gen.shape == (2, 2) and int(gen.max()) < cfg.vocab
