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
"""
from __future__ import annotations

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import flash_attn_mrq as FA
from repro_torch.kernels import int4_packed as F4
from repro_torch.kernels import int8_fused as F8
from repro_torch.kernels.ref import TOLERANCES, pack_int4

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
