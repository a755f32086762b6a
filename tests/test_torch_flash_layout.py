"""The one-launch flash kernel's addressing and fragment layout, modelled
on the CPU.

``csrc/flash_attn_mrq.cu::flash_kernel`` reads q, k and v where the qkv
projection leaves them and writes its output in (B, Sq, Hk, G, hd) order,
so the serving path copies nothing around it. The kernel cannot run here;
these tests replay its arithmetic in Python and hold it against what the
plain path computes with copies:

- the launcher's 14 element strides (``flash_attn_mrq.launch_strides``)
  and the kernel's ``q_base`` / ``kv_base`` row decomposition (q row
  b = (bb * Hk + hk) * rep + gg reads kv row b / rep) address exactly the
  rows ``flatten_heads`` copies out, on the qkv view of the DiT block,
  on GQA views and on the public (B, M, D) operands (``rows_as_heads``);
  the output written at the out strides is the permute the plain path
  makes;
- the mask words (``mask_bits``) hold one bit per (q row, kv lane);
- the P.V operand permutation: each A-fragment byte that a consumer
  thread packs from its score registers sits at the kv position where the
  producer stores the same kv lane's v codes, so the wgmma's sum over
  positions is P . V;
- ``ops.flash_attention`` on those views (the plain path on the CPU)
  against the JAX package's ``flash_attn_mrq_ref`` oracle on the
  flattened rows, within ``B3_flipped_row_rate`` and ``B3_atol_steps``.

Serial time a few seconds.
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

FA = importlib.import_module("repro_torch.kernels.flash_attn_mrq")


def _q_base(s, b, rep, Hk):
    """``flash_kernel``'s q_base: q row b's offset at (batch, head, group)
    strides."""
    bk = b // rep
    return (bk // Hk) * s[0] + (bk % Hk) * s[1] + (b % rep) * s[2]


def _kv_base(s, b, rep, Hk):
    bk = b // rep
    return (bk // Hk) * s[0] + (bk % Hk) * s[1]


def _gather(flat, base, row_stride, rows, D):
    """The (rows, D) elements the kernel reads from ``flat`` for one row
    base: element (r, d) at base + r * row_stride + d."""
    idx = base + torch.arange(rows)[:, None] * row_stride + torch.arange(D)
    return flat[idx]


def _flat(t):
    """Every element of ``t``'s storage, in storage order."""
    return t.as_strided((t.untyped_storage().nbytes() // t.element_size(),),
                        (1,), 0)


def _kernel_rows(q5, k4, v4, out5):
    """The q, k, v rows the kernel reads and the flat offsets it writes,
    from the launcher's strides alone."""
    B, M, Hk, G, D = q5.shape
    N = k4.shape[1]
    st = FA.launch_strides(q5, k4, v4, out5)
    qs, ks, vs, os_ = st[0:4], st[4:7], st[7:10], st[10:14]
    Bq = B * Hk * G
    q_rows = torch.stack([_gather(_flat(q5), q5.storage_offset() + _q_base(
        qs, b, G, Hk), qs[3], M, D) for b in range(Bq)])
    k_rows, v_rows = (torch.stack([_gather(_flat(t), t.storage_offset()
                                           + _kv_base(s, b, G, Hk), s[2], N, D)
                                   for b in range(0, Bq, G)])
                      for t, s in ((k4, ks), (v4, vs)))
    out_idx = torch.stack([_q_base(os_, b, G, Hk) + torch.arange(M)[:, None]
                           * os_[3] + torch.arange(D) for b in range(Bq)])
    return q_rows, k_rows, v_rows, out_idx


HEAD_CASES = [(2, 5, 3, 1, 8), (1, 7, 2, 1, 72), (3, 4, 1, 1, 40)]


@pytest.mark.parametrize("B,S,H,G,hd", HEAD_CASES)
def test_qkv_view_strides_address_the_flattened_rows(B, S, H, G, hd):
    """The DiT block's views of one (B, S, 3, H, hd) qkv buffer."""
    qkv = torch.arange(B * S * 3 * H * hd, dtype=torch.float32).reshape(
        B, S, 3, H, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    q5 = q.reshape(B, S, H, 1, hd)
    out = torch.empty((B, S, H, 1, hd))
    q_rows, k_rows, v_rows, out_idx = _kernel_rows(q5, k, v, out)
    qf, kf, vf = FA.flatten_heads(q5, k, v)
    assert torch.equal(q_rows, qf)
    assert torch.equal(k_rows, kf)
    assert torch.equal(v_rows, vf)
    # rows-order results written at the out offsets == the plain path's
    # permute back to (B, Sq, Hk, G, hd)
    rows_out = torch.randn(B * H, S, hd)
    flat = torch.empty(out.numel())
    flat[out_idx.reshape(-1)] = rows_out.reshape(-1)
    assert torch.equal(flat.reshape(out.shape), rows_out.reshape(
        B, H, 1, S, hd).permute(0, 3, 1, 2, 4))


@pytest.mark.parametrize("B,Sq,Skv,Hk,G,hd", [(2, 3, 5, 2, 2, 8),
                                               (1, 4, 9, 3, 4, 16)])
def test_gqa_view_strides_address_the_flattened_rows(B, Sq, Skv, Hk, G, hd):
    """q of its own (B, Sq, Hk, G, hd) buffer, k and v strided views of a
    (B, Skv, 2, Hk, hd) one: q row b reads kv row b // G."""
    q5 = torch.arange(B * Sq * Hk * G * hd, dtype=torch.float32).reshape(
        B, Sq, Hk, G, hd)
    kv = torch.arange(B * Skv * 2 * Hk * hd, dtype=torch.float32).reshape(
        B, Skv, 2, Hk, hd)
    k, v = kv[:, :, 0], kv[:, :, 1]
    out = torch.empty((B, Sq, Hk, G, hd))
    q_rows, k_rows, v_rows, out_idx = _kernel_rows(q5, k, v, out)
    qf, kf, vf = FA.flatten_heads(q5, k, v)
    assert torch.equal(q_rows, qf)
    assert torch.equal(k_rows, kf)
    assert torch.equal(v_rows, vf)
    rows_out = torch.randn(B * Hk * G, Sq, hd)
    flat = torch.empty(out.numel())
    flat[out_idx.reshape(-1)] = rows_out.reshape(-1)
    assert torch.equal(flat.reshape(out.shape), rows_out.reshape(
        B, Hk, G, Sq, hd).permute(0, 3, 1, 2, 4))


@pytest.mark.parametrize("B,Bk,M,N,D", [(4, 2, 3, 5, 8), (3, 3, 6, 2, 40),
                                        (6, 1, 2, 3, 16)])
def test_public_rows_reach_the_launcher_unchanged(B, Bk, M, N, D):
    """(B, M, D) q and (Bk, N, D) k, v through ``rows_as_heads``: the
    kernel reads q row b and kv row b // rep and writes out row b."""
    q = torch.arange(B * M * D, dtype=torch.float32).reshape(B, M, D)
    k = torch.arange(Bk * N * D, dtype=torch.float32).reshape(Bk, N, D)
    v = k + 0.5
    out = torch.empty((B, M, D))
    q5, k4, v4, out5 = FA.rows_as_heads(q, k, v, out)
    q_rows, k_rows, v_rows, out_idx = _kernel_rows(q5, k4, v4, out5)
    assert torch.equal(q_rows, q)
    assert torch.equal(k_rows, k)       # one per kv row: q rows b // rep
    assert torch.equal(v_rows, v)
    assert torch.equal(out_idx, torch.arange(B * M * D).reshape(B, M, D))


@pytest.mark.parametrize("N", [1, 77, 128, 300])
def test_mask_bits_hold_one_bit_per_lane(N):
    gen = torch.Generator().manual_seed(N)
    Bq, M = 3, 5
    mask = torch.rand((Bq, M, N), generator=gen) < 0.5
    w = FA.mask_bits(mask, Bq, M, N, torch.device("cpu"))
    Np = -128 * (-N // 128)
    assert w.dtype == torch.int32 and tuple(w.shape) == (Bq, M, Np // 32)
    lanes = torch.arange(Np)
    bits = (w.to(torch.int64)[..., lanes // 32] >> (lanes % 32)) & 1
    assert torch.equal(bits[..., :N].bool(), mask)
    assert not bits[..., N:].any()


def _producer_position(lane):
    """Where the producer stores kv lane ``lane`` (0..127) of a tile in the
    transposed v code rows: unit qd covers lanes l0 + {0, 1, 8, 9} at
    positions 4 qd + {0, 1, 2, 3}."""
    for qd in range(32):
        l0 = 32 * (qd >> 3) + 16 * ((qd >> 2) & 1) + 2 * (qd & 3)
        for j in range(4):
            if l0 + (j & 1) + 8 * (j >> 1) == lane:
                return 4 * qd + j
    raise AssertionError(lane)


def test_pv_fragment_positions_match_the_producers_v_layout():
    """Every (thread, k step, register, byte) of the P.V A fragment: the
    kv lane whose code the consumer packs there (score fragment lane
    8 nt + 2 t + c of row g + 8 (j & 1)) is stored by the producer at the
    fragment's k position (wgmma's A layout: 16 (j >> 1) + 4 t + byte), so
    sum_k A[row, k] Vt[k] = sum_lane P[row, lane] V[lane]."""
    pos = [_producer_position(lane) for lane in range(128)]
    assert sorted(pos) == list(range(128))
    gen = torch.Generator().manual_seed(0)
    P = torch.randint(0, 129, (64, 128), generator=gen)
    V = torch.randint(-127, 128, (128, 80), generator=gen)
    Vt = torch.zeros(80, 128, dtype=torch.int64)
    Vt[:, pos] = V.t()                         # the producer's stores
    A = torch.full((64, 128), -1, dtype=torch.int64)
    for warp in range(4):
        for lane in range(32):
            gid, tig = lane >> 2, lane & 3
            for kc in range(4):
                for j in range(4):
                    h, nt0 = j & 1, 4 * kc + 2 * (j >> 1)
                    row = 16 * warp + gid + 8 * h
                    for i in range(4):        # the consumer's pack4 bytes
                        nt = nt0 + (i >> 1)
                        score_lane = 8 * nt + 2 * tig + (i & 1)
                        k = 32 * kc + 16 * (j >> 1) + 4 * tig + i
                        assert A[row, k] == -1
                        A[row, k] = P[row, score_lane]
    assert (A >= 0).all()
    assert torch.equal(A @ Vt.t(), P @ V)


def _packs(r, bits, G, S):
    half = 2 ** (bits - 1)
    rate = (1 + 0.1 * r.random((G, 1))).astype(np.float32)
    s_q = rate * np.float32(6.0 / (half - 1))
    s_k = s_q * np.float32(1.05)
    s1 = np.clip(rate * np.float32(8.0 / S / half), 1 / (half * half * 8),
                 1 / half).astype(np.float32)
    s_v = rate * np.float32(4.0 / (half - 1))
    qk = {"s_q": s_q, "s_k": s_k, "scale": s_q * s_k}
    pv = {"s1": s1, "s_v": s_v, "scale1": s1 * s_v,
          "scale2": np.float32(1.0 / half) * s_v}
    return qk, pv


@pytest.mark.parametrize("bits,S,H,hd", [(8, 77, 3, 72), (4, 40, 2, 16)])
def test_ops_flash_attention_on_qkv_views_matches_jax(bits, S, H, hd):
    """``ops.flash_attention`` on the DiT block's qkv views (CPU: the plain
    path) against the JAX oracle on the flattened rows."""
    r = np.random.default_rng(7 * bits + S)
    B, G, g = 2, 3, 1
    half = 2 ** (bits - 1)
    qkv = (r.standard_normal((B, S, 3, H, hd)) * 1.5).astype(np.float32)
    qk, pv = _packs(r, bits, G, S)
    scale = hd ** -0.5
    tq = {k: torch.from_numpy(v) for k, v in qk.items()}
    tp = {k: torch.from_numpy(v) for k, v in pv.items()}
    tq.update(bits=bits, groups=G)
    tp.update(bits=bits, groups=G)
    t = torch.from_numpy(qkv)
    out = ops.flash_attention(t[:, :, 0].reshape(B, S, H, 1, hd), t[:, :, 1],
                              t[:, :, 2], tq, tp, scale=scale, tgroup=g)
    assert tuple(out.shape) == (B, S, H, 1, hd)
    flat = lambda a: a.transpose(0, 2, 1, 3).reshape(B * H, S, hd)
    j = np.asarray(jref.flash_attn_mrq_ref(
        jnp.asarray(flat(qkv[:, :, 0])), jnp.asarray(flat(qkv[:, :, 1])),
        jnp.asarray(flat(qkv[:, :, 2])),
        {a: jnp.asarray(b) for a, b in qk.items()},
        {a: jnp.asarray(b) for a, b in pv.items()}, scale=scale, g_qk=g,
        g_pv=g, bits=bits))
    o = out.permute(0, 2, 3, 1, 4).reshape(B * H, S, hd)
    rate, max_err = tref.flash_flip_stats(o, torch.from_numpy(j.copy()))
    assert rate <= tref.TOLERANCES["B3_flipped_row_rate"][0], rate
    step = float(pv["s_v"][g, 0]) * (half - 1) / half
    assert max_err <= tref.TOLERANCES["B3_atol_steps"][0] * step
