"""B13's plain version (``repro_torch.kernels.ref.act_mrq_ref``) against
JAX's ``act_mrq_ref`` on every bf16 bit pattern, on the CPU.

All 65,536 patterns (NaN of both signs, +-inf, subnormals and +-0 among
them) go through both, for GELU and SiLU, bits 8, 6 and 4, the steps
(0.17 / half, 6 / half) and (0.005, 0.03), f32 and bf16 out. The outputs
agree bit for bit, a NaN equal to a NaN, wherever the two activations
``h`` agree in sign. Both follow JAX's rule for the sign of a zero: with
positive steps, the output's sign bit is set exactly where ``h < 0``
(``jnp.clip``'s max orders -0 below +0, so ``h = -0`` gives +0).

The activations themselves differ in sign on 265 patterns for GELU and
258 for SiLU, where JAX's ``h`` is +-0 and the port's a nonzero smaller
than half a step: XLA's CPU flushes subnormal inputs and results to zero
(the 127 negative subnormal x, and 128 x whose ``h`` is subnormal), its
tanh reaches -1 at the 10 GELU inputs from -4.875 to -5.156 where
``torch.tanh`` does not, and its ``1 / (1 + exp(-x))`` at the 3 SiLU
inputs from -87.5 to -88.5 is a subnormal it flushes. There both outputs
are zeros, each with its own ``h``'s sign. A few seconds serial.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

X32 = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
SIGN = np.uint32(1 << 31)


def _bits(a):
    """(uint32 bits of ``a`` widened to f32, NaN mask)."""
    f = (a.float().numpy() if isinstance(a, torch.Tensor)
         else np.asarray(a).astype(np.float32))
    return f.view(np.uint32), np.isnan(f)


def _h(kind):
    """(JAX's h, the port's h) of every bf16 pattern, in f32."""
    xj = jnp.asarray(X32)
    jh = jax.nn.gelu(xj, approximate=True) if kind == "gelu" \
        else jax.nn.silu(xj)
    xt = torch.from_numpy(X32.copy())
    th = tref.gelu_tanh_ref(xt) if kind == "gelu" else tref.silu_ref(xt)
    return np.asarray(jh), th.numpy()


@pytest.mark.parametrize("bits", [8, 6, 4])
@pytest.mark.parametrize("kind", ["gelu", "silu"])
def test_act_mrq_plain_equals_jax_on_every_bf16_pattern(kind, bits):
    half = 2 ** (bits - 1)
    xj = jnp.asarray(X32).astype(jnp.bfloat16)
    xt = torch.from_numpy(X32.copy()).to(torch.bfloat16)
    jh, th = _h(kind)
    apart = (jh < 0) != (th < 0)
    # where the activations part: JAX's is +-0, the port's below half a
    # step of either region
    assert (jh[apart] == 0).all() and (th[apart] != 0).all()
    assert apart.sum() == {"gelu": 265, "silu": 258}[kind]
    for sn, sp in ((0.17 / half, 6.0 / half), (0.005, 0.03)):
        assert (np.abs(th[apart]) < min(sn, sp) / 2).all()
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            j, jn = _bits(jref.act_mrq_ref(xj, sn, sp, bits, kind,
                                           out_dtype=jdt))
            t, tn = _bits(tref.act_mrq_ref(xt, sn, sp, bits, kind,
                                           out_dtype=tdt))
            what = (sn, sp, str(tdt))
            np.testing.assert_array_equal(jn, tn, err_msg=str(what))
            same = ~apart & ~jn
            np.testing.assert_array_equal(j[same], t[same],
                                          err_msg=str(what))
            # JAX's sign rule, each package on its own h
            zj, zt = (j & ~SIGN) == 0, (t & ~SIGN) == 0
            assert (zj[apart] & zt[apart]).all(), what
            for b, z, h in ((j, zj, jh), (t, zt, th)):
                assert np.array_equal((b[z] & SIGN) != 0, h[z] < 0), what


@pytest.mark.parametrize("kind", ["gelu", "silu"])
def test_act_mrq_zero_signs_follow_h(kind):
    """Zeros out of explicit +0, -0, tiny positive and tiny negative h
    (the activation of a tiny x is about x / 2), and x = -20 (GELU's -0 =
    x * 0; SiLU's -4e-8): -0 exactly where h < 0, in both packages, f32
    and bf16 in and out."""
    x = np.array([0.0, -0.0, 1e-30, -1e-30, 2e-20, -2e-20, -20.0],
                 np.float32)
    want = np.array([0, 0, 0, 1, 0, 1, kind == "silu"], bool)
    for sn, sp in ((0.17 / 128, 6.0 / 128), (0.005, 0.03)):
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            j, _ = _bits(jref.act_mrq_ref(jnp.asarray(x).astype(jdt), sn,
                                          sp, 8, kind, out_dtype=jdt))
            t, _ = _bits(tref.act_mrq_ref(torch.from_numpy(x).to(tdt), sn,
                                          sp, 8, kind, out_dtype=tdt))
            assert ((j & ~SIGN) == 0).all() and ((t & ~SIGN) == 0).all()
            assert np.array_equal((j & SIGN) != 0, want), (sn, jdt)
            assert np.array_equal((t & SIGN) != 0, want), (sn, tdt)
