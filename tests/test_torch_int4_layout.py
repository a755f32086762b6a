"""The packed-int4 GEMM's weight operand, modelled on the CPU.

``csrc/int4_packed.cu::gemm4_kernel`` feeds the nibble weights to wgmma as
its register A operand: each consumer thread reads two 16-byte words of a
stage's weight block (``kernels/int4_packed.py::_weight_layout``) and
widens each 4-byte word with two masks and two byte permutes (``widen``)
into two registers of the m64nNk32 s8 A fragment: register a0 holds
channel ``q`` at k ``4t..4t+3``, a1 channel ``q + 8`` at the same k, a2 and
a3 the same channels at k ``16+4t..19+4t`` (thread ``t`` of quad ``q`` of
its warp; the warp's 16 channels at ``16 w``), each code as 16 x code.

This test replays those reads and permutes in torch, for every thread of
both consumer warpgroups, every channel tile and k tile, and holds the
codes the fragments carry against ``ref.unpack_int4`` of the pack with
each K group zero-padded to the kernel's 128-deep k tile
(``_padded_group``): group_k 16 (x_proj), 40 (groups that straddle no
tile but leave most of it zero) and 256, a ragged last group, and N off
the 128-channel tile. No GPU needed: it keeps the layout honest where the
kernel cannot run. Serial time about 5 s.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import int4_packed as F4
from repro_torch.kernels import ref as tref


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm(x, y, sel)`` on int64 tensors of 32-bit
    values: result byte i is byte ``(sel >> 4 i) & 7`` of y:x."""
    both = (y << 32) | x
    out = torch.zeros_like(x)
    for i in range(4):
        b = (sel >> (4 * i)) & 7
        out |= ((both >> (8 * b)) & 0xFF) << (8 * i)
    return out


def _widen(w):
    """The kernel's ``widen``: a word -> (a_lo, a_hi) fragment registers."""
    lo, hi = (w << 4) & 0xF0F0F0F0, w & 0xF0F0F0F0
    return _byte_perm(lo, hi, 0x5140), _byte_perm(lo, hi, 0x7362)


def _fragment_codes(wt, N, Kq):
    """The (ceil128(N), Kq) code matrix that the kernel's A fragments hold,
    rebuilt from the weight copy ``wt`` by replaying each thread's loads
    and widening: entry (channel, code column)."""
    Np = -128 * (-N // 128)
    nkt = Kq // 128
    b = wt.to(torch.int64) & 0xFF
    # (tile, k tile, c, w, h, q, t, step, byte)
    b = b.reshape(Np // 128, nkt, 2, 4, 2, 8, 4, 4, 4)
    words = (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
             | (b[..., 3] << 24))             # (tile, kt, c, w, h, q, t, step)
    lo, hi = _widen(words)
    regs = torch.stack([lo[:, :, :, :, 0], lo[:, :, :, :, 1],
                        hi[:, :, :, :, 0], hi[:, :, :, :, 1]])
    # regs: (reg, tile, kt, c, w, q, t, step); reg = 2 * khalf + chalf
    vals = torch.stack([(regs >> (8 * j)) & 0xFF for j in range(4)])
    vals = torch.where(vals > 127, vals - 256, vals)      # s8 bytes
    assert bool((vals % 16 == 0).all()), "a widened byte is not 16 x code"
    codes = vals // 16            # (j, reg, tile, kt, c, w, q, t, step)
    seen = torch.zeros((Np, Kq), dtype=torch.int64)
    for reg in range(4):
        chalf, khalf = reg % 2, reg // 2
        for j in range(4):
            v = codes[j, reg]                     # (tile, kt, c, w, q, t, step)
            # channel = 128 tile + 64 c + 16 w + 8 chalf + q
            # column = 128 kt + 32 step + 16 khalf + 4 t + j
            v = v.permute(0, 2, 3, 4, 1, 6, 5)    # (tile, c, w, q, kt, step, t)
            ch = v.reshape(Np // 128, 2, 4, 8, nkt, 4, 4)
            rows = (torch.arange(Np // 128)[:, None, None, None] * 128
                    + torch.arange(2)[None, :, None, None] * 64
                    + torch.arange(4)[None, None, :, None] * 16
                    + 8 * chalf + torch.arange(8)[None, None, None, :])
            cols = (torch.arange(nkt)[:, None, None] * 128
                    + torch.arange(4)[None, :, None] * 32
                    + 16 * khalf + torch.arange(4)[None, None, :] * 4 + j)
            seen[rows.reshape(-1)[:, None], cols.reshape(-1)[None, :]] = \
                ch.reshape(rows.numel(), cols.numel())
    return seen


@pytest.mark.parametrize("group_k,K,N", [(16, 16, 131), (40, 100, 45),
                                         (256, 300, 200), (256, 1152, 128)])
def test_register_fragments_carry_the_packed_codes(group_k, K, N):
    gen = torch.Generator().manual_seed(group_k + K + N)
    nk = -(-K // group_k)
    codes = torch.randint(-8, 8, (nk * group_k, N), generator=gen,
                          dtype=torch.int8)
    codes[K:] = 0
    wp = tref.pack_int4(codes)
    wt = F4._weight_layout(wp, group_k)
    gkp = F4._padded_group(group_k)
    assert gkp % 128 == 0 and gkp >= group_k
    Kq, Np = nk * gkp, -128 * (-N // 128)
    assert wt.dtype == torch.int8 and wt.is_contiguous()
    assert wt.numel() == (Np // 128) * (Kq // 128) * 8192
    want = torch.zeros((Np, Kq), dtype=torch.int64)
    unpacked = tref.unpack_int4(wp).to(torch.int64)       # (nk * group_k, N)
    for kg in range(nk):
        want[:N, kg * gkp:kg * gkp + group_k] = \
            unpacked[kg * group_k:(kg + 1) * group_k].t()
    assert torch.equal(_fragment_codes(wt, N, Kq), want)


def test_widen_is_exact_for_every_nibble_pair():
    """Every byte value widens to its two nibbles' codes, 16 x code, sign
    included: the A registers need no extension step."""
    byte = torch.arange(256, dtype=torch.int64)
    word = byte | (byte << 8) | (byte << 16) | (byte << 24)
    lo4, hi4 = _widen(word)
    lo_code, hi_code = tref.nibble_split(byte.to(torch.int8))
    for reg in (lo4, hi4):
        for j, want in enumerate((lo_code, hi_code, lo_code, hi_code)):
            got = (reg >> (8 * j)) & 0xFF
            got = torch.where(got > 127, got - 256, got)
            assert torch.equal(got, 16 * want.to(torch.int64))
