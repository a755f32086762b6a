"""The port's CUDA kernels against their plain versions on the card, at
small ragged shapes that the serving path never produces (M, N, K and the
kv length off every tile edge, N not a multiple of 4, head dims 40 and
128). Marked ``cuda``: each test skips where no GPU is present; run on the
card with ``python -m pytest -m cuda --noconftest tests/test_torch_cuda.py``
(``tests/conftest.py`` imports JAX, which the GPU host lacks).

Tolerances (``repro_torch.kernels.ref.TOLERANCES``): B1/B2 bit-exact; B3
ulp-level accumulator differences everywhere, at most 2% of the output
rows carrying a flipped probability code, no element off by more than two
coarse region steps.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import flash_attn_mrq as FA
from repro_torch.kernels import int8_fused as F8
from repro_torch.kernels.ref import TOLERANCES, flash_flip_stats

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
    rate, max_err = flash_flip_stats(out, ref)
    assert rate <= TOLERANCES["B3_flipped_row_rate"][0]
    assert max_err <= TOLERANCES["B3_atol_steps"][0] * float(s) * 127 / 128
