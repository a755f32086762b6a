"""Plain PyTorch oracles for the serving-path kernels, and the port's
tolerance registry.

Torch ports of the kernel entries of ``repro/kernels/ref.py`` (the
byte-code and packed-int4 linears, the pre-quantized int8 matmul, flash
attention with its boolean mask, the composed int8 attention chain, the
per-row-group ``*_vec`` oracles of the continuous-batching path, and the
fused softmax and activation quant-dequant passes) and of the nibble
helpers of ``repro/kernels/int4_packed.py``. Each
``*_ref`` computes exactly what the corresponding kernel must produce, op
for op and rounding step for rounding step (``torch.round`` rounds half
to even as ``jnp.round`` does; every multiply and add is its own torch
op, so nothing contracts into an FMA). Integer products are exact:
int32 ``torch.matmul`` on the CPU, float64 on the GPU (|sum| stays far
below 2^53 at every serving shape).

The kernel modules' ``*_plain`` functions are these oracles; the
layernorm statistics of the norm-modulate prologue are summed in the
prologue pass's order (``layernorm_stats``), so a kernel and its plain
version see identical prologue values.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e9
_M_INIT = -1e30
# jax.nn.gelu's constant, np.sqrt(2 / np.pi) rounded to f32
SQRT_2_OVER_PI = float(torch.tensor(math.sqrt(2 / math.pi),
                                    dtype=torch.float32))


# ---------------------------------------------------------------------------
# tolerance registry: (bound, reason) per comparison
# ---------------------------------------------------------------------------
TOLERANCES = {
    # kernel (CUDA, card) vs its plain version (card)
    "B1_vs_plain": (0.0, "integer-exact codes and s32 sums; each prologue "
                    "and epilogue step rounds once in both (IEEE divide, "
                    "no FMA contraction: -fmad=false / __f*_rn)"),
    "B1_norm_mod_vs_plain": (0.0, "the prologue pass computes the "
                             "layernorm stats itself and the plain version "
                             "replays its order (chunk_rowsum for the sums, "
                             "IEEE divides by K, a correctly rounded sqrt "
                             "and reciprocal)"),
    "B2_vs_plain": (0.0, "as B1: disjoint sign-split codes, two exact s32 "
                    "accumulators, per-step rounding in the epilogue"),
    "B4_vs_plain": (0.0, "as B1, and each K group's s32 partial is "
                    "corrected, scaled and added into the f32 accumulator "
                    "in the plain version's order (ascending groups, one "
                    "rounding per step, no split-K)"),
    "B5_vs_plain": (0.0, "as B4 with B2's two exact region partials, "
                    "added as acc + (pn*sn + pp*sp) per group"),
    "B3_vs_plain": (0.0, "the plain version replays the kernel's "
                    "per-tile recurrence op for op, sums each tile's rows "
                    "in the kernel's order (tile_rowsum) and uses the same "
                    "exp (the card's expf through torch.exp); codes and "
                    "integer P.V sums are then identical"),
    "B3b_vs_B3": (0.0, "packed kv holds the same 4-bit codes two per "
                  "byte; the kernel widens them before the same "
                  "arithmetic, so only the storage differs"),
    "B9_vs_plain": (0.0, "B9a/B9b: SymQ codes round once per element in "
                    "both (IEEE divide, rint), the s32 products are "
                    "exact, and the epilogue rounds each step in the "
                    "plain version's order (acc*scale; acc1*scale1 + "
                    "acc2*scale2)"),
    "B10_vs_plain": (0.0, "B10a: the plain version takes the same max, the "
                     "same exp (the card's expf through torch.exp), sums "
                     "each row in the kernel's order (warp_rowsum) and "
                     "divides as IEEE (the kernel's corrected quotients, "
                     "div_rn, equal it); the codes are then identical"),
    "B3_mask_vs_plain": (0.0, "as B3: masked lanes get the same NEG_INF as "
                         "the ragged ones before the online max, in kernel "
                         "and plain version alike; a fully masked row then "
                         "gives e = exp(0) = 1 on every lane up to the "
                         "reference's padded kv length"),
    "B11_vs_plain": (0.0, "integer-exact s32 products of the caller's codes; "
                     "the epilogue (acc - corr) * scale + bias rounds each "
                     "step once in both (B1's epilogue, one group)"),
    "B12_vs_plain": (0.0, "as B10: the same max, exp (the card's expf "
                     "through torch.exp), row sum in the kernel's order "
                     "(warp_rowsum) and IEEE divides; the dequantising "
                     "multiply by s1 or s2 rounds once in both"),
    "B13_vs_plain": (0.0, "GELU spelled op by op in jax.nn.gelu's order, "
                     "SiLU as x * (1 / (1 + exp(-x))), each step rounding "
                     "once (tanhf / expf are torch.tanh / torch.exp on the "
                     "card); IEEE divide, rint, one dequantising multiply"),
    "vec_vs_plain": (0.0, "B6a/B6b/B7a/B7b/B8/B9c/B9d/B10b run their scalar "
                     "siblings' arithmetic with each row's (batch row's) "
                     "group read from the vector; the plain versions "
                     "gather the same rows"),
    "vec_vs_scalar_kernel": (0.0, "a constant vector, or each group's rows "
                             "run through the scalar kernel at that "
                             "group, computes every output element with "
                             "the same operands in the same order"),
    "B3_flipped_row_rate": (0.02, "rowsum(e) over each 128-wide kv tile is "
                            "summed by XLA (the JAX oracle) in another "
                            "order than by the port (``tile_rowsum``, the "
                            "kernel's order), and exp may differ by an ulp "
                            "between libraries: l' differs by an ulp, so "
                            "rho and every accumulator of the row differ by "
                            "ulps (not counted: below 1e-5 x max|out| in "
                            "f32, one bf16 ulp of max|out| in bf16), and now "
                            "and then a probability code on a .5 boundary "
                            "flips; at most 2% of output rows may carry a "
                            "flip"),
    "B3_atol_steps": (2.0, "a flip moves an output by at most one coarse "
                      "region step x max|v code| (s2 * s_v * (half-1)); "
                      "bound: two such steps"),
    # port's plain version (CPU) vs JAX's ref (CPU)
    "B1_B2_plain_vs_jax": (0.0, "no norm_mod: same f32 ops, same rounding "
                           "(the jnp oracles run eagerly, op by op)"),
    "B4_B5_plain_vs_jax": (0.0, "no norm_mod: the same group-ordered f32 "
                           "accumulation op for op (eager jnp oracles)"),
    "vec_plain_vs_jax": (0.0, "no norm_mod: the vec oracles gather each "
                         "row's parameters and then run the scalar "
                         "oracles' f32 ops, as the jnp vec oracles do"),
    "B1_B2_norm_mod_plain_vs_jax_flip_rate": (
        1e-3, "torch and XLA sum the layernorm mean/var in different "
        "orders and differ in rsqrt by an ulp; a code sitting on a "
        ".5 boundary flips"),
    "B11_plain_vs_jax": (0.0, "the same exact integer product and the same "
                         "f32 epilogue op for op (eager jnp oracle)"),
    "B11_plain_vs_jax_jit_ulps": (
        1.0, "under jax.jit (the Pallas entry point in interpret mode) "
        "XLA's CPU backend contracts acc * scale + bias into one FMA, "
        "while the port rounds the product first, as the eager oracle does "
        "and as the card's kernel does (-fmad=false): the two differ by at "
        "most one f32 ulp of max(|acc * scale|, |y|)"),
    "B12_flip_rate_vs_jax": (
        1e-4, "XLA sums each softmax row in another order than the port "
        "(warp_rowsum, the kernel's order) and its exp may differ by an "
        "ulp: p differs by ulps, and a p / s on a .5 boundary (or p on the "
        "region threshold) moves its output by one step; at most 1e-4 of "
        "the outputs, or one output of a smaller tensor, may differ (4 in "
        "8,387,456 seen on the CPU: python "
        "tests/test_torch_public_kernels.py)"),
    "B13_flip_rate_vs_jax": (
        1e-4, "XLA's tanh differs from torch's by an ulp in about 6 of 10 "
        "elements on the CPU, its exp in about 1 of 10 (the GELU and SiLU "
        "op order is the same: with XLA's tanh and exp the port's "
        "spelling equals jax.nn.gelu / silu bit for bit): h / s on a .5 "
        "boundary moves its output by one step of its region; at most "
        "1e-4 of the outputs, or one output of a smaller tensor, may "
        "differ (at most 31 in 4,194,304 seen on the CPU, GELU at 8 bits "
        "on f32 inputs, none on bf16 inputs: python "
        "tests/test_torch_public_kernels.py)"),
    "B9_plain_vs_jax": (0.0, "B9a/B9b: the same f32 divide, round, exact "
                        "integer products and f32 epilogue op for op "
                        "(eager jnp oracles)"),
    "B10_code_flip_rate_vs_jax": (
        1e-4, "XLA sums each softmax row in another order than the port "
        "(warp_rowsum, the kernel's order) and its exp may differ by an "
        "ulp: p differs by ulps, and a code whose p / s sits on a .5 "
        "boundary (or p on the region threshold) flips; at most 1e-4 of "
        "the codes may differ (1 in 6.6e6 seen on the CPU)"),
    "B10_flip_prob_steps": (1.0, "a flipped code moves its dequantised "
                            "probability by at most one coarse region step "
                            "s2 = 1/half (region 1's step s1 <= s2)"),
    "composed_flipped_row_rate": (
        0.01, "each output row of the composed chain sums one softmax row's "
        "codes: a row carries a flip when any of its Skv codes flipped "
        "(B10_code_flip_rate_vs_jax); at most 1% of the rows (every other "
        "row is bit-exact: the rest of the chain is B9_plain_vs_jax)"),
    "composed_atol_steps": (2.0, "a flipped code moves an output by at "
                            "most one coarse region step x max|v code| "
                            "(s2 * s_v * (half-1)); bound: two such steps"),
    # the HO search (core/search.py) vs the reference's, the same inputs
    "ho_near_tie_rel": (1e-4, "the candidates are equal bit for bit, but "
                        "each candidate's error sum(G (yhat - y)^2) is an "
                        "f32 product and reduction that torch (MKL, its "
                        "own summation order) and XLA (Eigen) round "
                        "differently, as they do the Fisher gradients: "
                        "where two candidates nearly tie, the argmin may "
                        "pick the other; such a choice must have a "
                        "float64 objective within this relative distance "
                        "of the reference's choice, and is counted"),
    # whole forwards
    "dit_forward_plain_vs_jax_rel": (2e-2, "ulp differences (gelu, "
                                     "softmax, layernorm stats) flip a few "
                                     "codes; each flip moves an output by "
                                     "one quantization step"),
    "dit_forward_kernel_vs_plain_rel": (0.0, "full-width forward on the "
                                        "card: every kernel is bit-exact "
                                        "against its plain version, and "
                                        "the glue around them is the same "
                                        "torch code"),
    # the evaluation stack (quant/eval.py) vs the reference's
    "eval_latents_atol": (5e-5, "the pipeline's noise is normal() * 0.3: "
                          "torch's CPU float32 erfinv is up to 833 ulps "
                          "off the float64 value near |u| = 0.94 and "
                          "XLA's up to 91 (2^18 draws), so a normal moves "
                          "by up to 7.5e-5 and a latent by 2.3e-5, plus "
                          "one rounding in the pattern's add"),
    "eval_sample_atol": (1e-4, "the research sampler in f32: the repo's "
                         "sampler bound (tests/test_diffusion.py); XLA "
                         "contracts the update into FMAs and the normals "
                         "differ as eval_latents_atol says"),
    "eval_sample_fake_quant_rel": (3e-5, "a whole fake-quant chain, "
                                   "relative L2 over the sample set: "
                                   "measured 3.2e-7 on the tiny DiT (W8A8 "
                                   "range artifact, 8 samples x 4 steps), "
                                   "where the fp chain lies 1.27e-3 from "
                                   "the quantized one; the bound sits 90x "
                                   "above the reading, room for codes "
                                   "flipped by an ulp before a round, and "
                                   "40x below the fp chain"),
    "eval_noise_mse_rel": (1e-3, "per-group MSE of the quantized minus "
                           "the fp forward on inputs that differ by "
                           "eval_latents_atol; a flipped code moves one "
                           "element by one quantization step"),
    "eval_score_rel": (1e-3, "FD, sFD and IS* of samples within "
                       "eval_sample_atol (and real latents within "
                       "eval_latents_atol): the features move by about "
                       "1e-5 relative and sqrtm carries it; rounded to "
                       "3 decimals as the reference's score()"),
    "normal_atol": (1e-4, "rng.normal against jax.random.normal from the "
                    "same key on the CPU: the uniforms are equal bit for "
                    "bit, but torch's float32 erfinv is up to 833 ulps off "
                    "the float64 value near |u| = 0.94 and XLA's up to "
                    "91, so a standard normal moves by up to 7.5e-5; an "
                    "initialiser's normals by that times its stddev"),
    # the training path (optim/, launch/steps.py, launch/train.py)
    "train_optim_vs_jax_rtol": (2e-6, "optim/ against repro.optim on the "
                                "same inputs, relative to a leaf's largest "
                                "value: pow (the bias corrections, "
                                "Adafactor's beta), cos (the schedule) and "
                                "the reductions (global norm, Adafactor's "
                                "means) round differently in torch and "
                                "XLA; measured 3.1e-7 over 4 steps; a "
                                "bfloat16 update may round one bf16 ulp "
                                "apart"),
    "train_loss_rel": (2e-6, "the f32 DiT loss of one batch (ddpm_loss, "
                       "the train step's): the forward's matmuls, "
                       "softmax and layernorm reduce in another order; "
                       "measured 2.8e-7 on the tiny DiT"),
    "train_grads_rel": (2e-5, "one step's gradients at the trained tiny "
                        "DiT, the largest difference over a leaf's "
                        "largest gradient: the backward's reductions "
                        "(the stacked layers' sums, the embedding's "
                        "scatter-add) in another order; measured 2.3e-6"),
    "train_loss_traj_rel": (5e-6, "5 AdamW steps from the same init and "
                            "batches: the losses track within the "
                            "gradients' and the optimizer's roundings; "
                            "measured 5.7e-7"),
    "train_param_flip_rate": (1e-3, "parameters after a few AdamW steps: "
                              "at step 1 m/sqrt(v) = g/|g|, so a gradient "
                              "of rounding size whose sign differs moves "
                              "its weight by 2 lr; the share of elements "
                              "more than 1e-6 apart is counted against "
                              "this budget (0 measured over the tiny "
                              "recipe's 3 steps: adaLN-Zero keeps most "
                              "early gradients at exactly 0)"),
    # the dense LM family (models/lm.py) vs the reference's, float32 CPU
    "lm_forward_vs_jax_rel": (1e-5, "logits (and prefill + decode against "
                              "the full forward, the cache, CE) over the "
                              "largest |logit|: RoPE's angles reach 1e3 "
                              "rad at theta 1e6 and torch's cos / sin and "
                              "XLA's differ by ulps there, and the f32 "
                              "matmuls, RMS / layer norms and softmax "
                              "reduce in another order; measured 1.9e-7 "
                              "to 2.6e-7 on the smoke configs"),
    "lm_gumbel_rtol": (1e-5, "rng.gumbel against jax.random.gumbel from "
                       "the same key: the uniforms are equal bit for bit, "
                       "the two logs round by ulps in each library"),
    "lm_kernel_plain_vs_jax_fq_rel": (2e-2, "a W8A8 LM forward through the "
                                      "kernel context's plain versions "
                                      "against JAX's fake-quant context on "
                                      "the same qparams: the forwards' "
                                      "ulps flip a few codes, each moving "
                                      "an output by one step (as "
                                      "dit_forward_plain_vs_jax_rel)"),
    "lm_greedy_near_tie_rel": (1e-4, "greedy decode at random init: where "
                               "the two packages' tokens first differ, "
                               "the two candidates' logits must lie "
                               "within this share of the largest |logit| "
                               "(forward ulps, lm_forward_vs_jax_rel, "
                               "decide the argmax only there)"),
    "lm_kernel_vs_fake_quant_ce_rel": (1e-2, "the CE of a bf16 LM at full "
                                       "width under the kernel context "
                                       "against the fake-quant context on "
                                       "the same packs: fake-quant rounds "
                                       "each dequantised operand and each "
                                       "product to bf16 where the kernels "
                                       "sum exact integers and dequantise "
                                       "in f32, and those roundings flip "
                                       "codes downstream. At random init "
                                       "the CE sits near ln(vocab) under "
                                       "every context, full precision's "
                                       "included, so this bound does not "
                                       "tell a quantized context from an "
                                       "unquantized one"),
    "lm_composed_vs_fake_quant_f32_ratio": (0.4, "the last prefill "
                                            "logits of a float32 LM at "
                                            "full width under the kernel "
                                            "context with the composed "
                                            "attention chain (exact "
                                            "softmax, as fake-quant's) "
                                            "against fake-quant on the "
                                            "packs' weights, relative L2, "
                                            "over full precision's "
                                            "distance, at 2, 8 and 28 "
                                            "layers. Per op the two agree "
                                            "to f32 ulps (8e-7 a linear, "
                                            "4e-5 to 8e-5 an attention "
                                            "call), but each ulp that "
                                            "moves a value across a code "
                                            "boundary moves it a whole "
                                            "step, and at random init the "
                                            "next quantizers carry that "
                                            "on, so the distance grows "
                                            "with depth towards "
                                            "quantization's own: measured "
                                            "0.13, 0.22 and 0.26 of full "
                                            "precision's (H100); against "
                                            "fake-quant as calibrated, "
                                            "whose weights clip to "
                                            "[-128, 127] where the packs "
                                            "clip to +-127, 0.60 to 0.66. "
                                            "In bf16 layer 0's linears "
                                            "round to bf16 on the kernels "
                                            "where fake-quant's are f32, "
                                            "and flash codes each 128-lane "
                                            "kv tile against the running "
                                            "normalisation (the "
                                            "reference's contract): "
                                            "neither is held here, flash "
                                            "is held exactly against its "
                                            "plain versions"),
    # the SSM and hybrid families (nn/ssm.py, models/lm.py's ssm_only and
    # hymba blocks) vs the reference's, on the CPU
    "ssd_init_ulps": (2, "ssd_init's dt_bias (dt = exp(u * (log(dt_max) - "
                      "log(dt_min)) + log(dt_min)), then dt + log(-expm1("
                      "-dt))) and A_log (log of 1..H) are float32 "
                      "transcendentals, each of which XLA's CPU and torch "
                      "may round an ulp apart; measured: dt_bias 1 ulp, "
                      "A_log equal"),
    "ssm_bf16_vs_jax_rel": (3e-2, "a bf16 SSD mixer or SSM / hybrid LM "
                            "(logits, prefill state, decode) against the "
                            "reference's on the same bf16 weights, over "
                            "the largest |value|: XLA's CPU keeps f32 "
                            "across a fused chain of elementwise ops (the "
                            "causal conv's taps, SiLU, the gated norm), "
                            "where torch rounds each op to bf16, and its "
                            "bf16 dots accumulate in another order; each "
                            "flip is one bf16 ulp (2^-8 relative) and the "
                            "layers carry them on; measured 7e-3 to "
                            "1.6e-2 on the smoke configs, the same to 4 "
                            "digits whichever pair of a chunk's "
                            "three-operand einsums is contracted first "
                            "(jnp.einsum picks by shape). Greedy tokens "
                            "may first differ only where the two "
                            "candidates' logits lie within this share of "
                            "the largest |logit|"),
    "eval_score_assets_rel": (1e-5, "one generated set scored against "
                              "the port's and the reference's real "
                              "latents (eval_latents_atol apart): "
                              "float64 statistics, measured 4e-9"),
}


def pack_int4(codes, axis: int = 0):
    """Signed 4-bit codes two per byte along ``axis``: rows ``2i`` and
    ``2i + 1`` go to byte ``i``'s low and high nibble; an odd length is
    padded with one zero row. int8 result, ``axis`` halved (rounded up)."""
    c = torch.movedim(torch.as_tensor(codes), axis, 0).to(torch.int32)
    if c.shape[0] % 2:
        c = torch.cat([c, torch.zeros((1,) + c.shape[1:], dtype=c.dtype,
                                      device=c.device)])
    u = c & 0xF
    byte = u[0::2] | (u[1::2] << 4)
    byte = torch.where(byte > 127, byte - 256, byte).to(torch.int8)
    return torch.movedim(byte, 0, axis)


def nibble_split(packed):
    """Packed int8 -> (low, high) sign-extended codes as int32:
    ``((b & 0xF) ^ 8) - 8``."""
    p = torch.as_tensor(packed).to(torch.int32)
    return ((p & 0xF) ^ 8) - 8, (((p >> 4) & 0xF) ^ 8) - 8


def unpack_int4(packed, k=None, axis: int = 0):
    """Inverse of ``pack_int4`` (int8 codes); ``k`` trims the padding."""
    p = torch.movedim(torch.as_tensor(packed), axis, 0)
    lo, hi = nibble_split(p)
    out = torch.stack([lo, hi], dim=1).reshape((2 * p.shape[0],)
                                               + tuple(p.shape[1:]))
    if k is not None:
        out = out[:k]
    return torch.movedim(out.to(torch.int8), 0, axis)


def flash_flip_stats(out, ref):
    """(fraction of output rows carrying a flipped probability code,
    max |out - ref|) — see ``B3_flipped_row_rate``. out/ref: (..., D)."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    ulp = 2.0 ** -8 if out.dtype == torch.bfloat16 else 1e-5
    flipped = (err > ulp * r.abs().max()).any(dim=-1)
    return float(flipped.float().mean()), float(err.max())


def imatmul(a, b):
    """Exact integer product of integer-valued tensors -> int32."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    return torch.matmul(a.double(), b.double()).round().to(torch.int32)


# ---------------------------------------------------------------------------
# fused linears
# ---------------------------------------------------------------------------
def quantize_int8_ref(x, scale, zero, bits: int = 8):
    """Signed affine codes: clip(round(x/s)+z-h, -h, h-1), h=2^{b-1}."""
    half = 2 ** (bits - 1)
    q = torch.clamp(torch.round(x / scale) + zero - half, -half, half - 1)
    return q.to(torch.int8)


def int8_matmul_ref(xq, wq, scale, corr, bias=None, out_dtype=torch.float32):
    """y = (xq @ wq - corr) * scale (+ bias)."""
    acc = imatmul(xq, wq)
    y = (acc - corr[None, :]).float() * scale[None, :]
    if bias is not None:
        y = y + bias[None, :].float()
    return y.to(out_dtype)


def int8_matmul_fq_ref(x, wq, sx, zx, scale, corr, bias=None, g=0,
                       bits: int = 8, out_dtype=torch.float32):
    xq = quantize_int8_ref(x.float(), sx[g][0], zx[g][0], bits)
    return int8_matmul_ref(xq, wq, scale[g], corr[g], bias=bias,
                           out_dtype=out_dtype)


def mrq_codes_ref(xf, s_neg, s_pos, half):
    """Disjoint sign-split codes of the MRQ-signed linear input."""
    neg = xf < 0
    zero = torch.zeros((), dtype=xf.dtype, device=xf.device)
    qn = torch.where(neg, torch.clamp(torch.round(xf / s_neg), -half, 0),
                     zero).to(torch.int8)
    qp = torch.where(neg, zero, torch.clamp(torch.round(xf / s_pos), 0,
                                            half - 1)).to(torch.int8)
    return qn, qp


def int8_matmul_mrq_fq_ref(x, wq, s_neg, s_pos, scale_neg, scale_pos,
                           bias=None, g=0, bits: int = 8,
                           out_dtype=torch.float32):
    half = 2 ** (bits - 1)
    qn, qp = mrq_codes_ref(x.float(), s_neg[g][0], s_pos[g][0], half)
    y = (imatmul(qn, wq).float() * scale_neg[g][None]
         + imatmul(qp, wq).float() * scale_pos[g][None])
    if bias is not None:
        y = y + bias[None, :].float()
    return y.to(out_dtype)


def int4_matmul_fq_ref(x, wp, sx, zx, scale, corr, bias=None, g=0,
                       group_k: int = 256, out_dtype=torch.float32):
    """4-bit affine x codes against nibble-packed weights (Kp/2, N), with
    the group-ordered f32 accumulation ``acc = acc + (partial - corr[g,
    kg]) * scale[g, kg]``, kg ascending; scale/corr (G, nk, N)."""
    M, K = x.shape
    Kp = 2 * wp.shape[0]
    xq = quantize_int8_ref(x.float(), sx[g][0], zx[g][0], bits=4)
    xq = torch.nn.functional.pad(xq, (0, Kp - K))
    w = unpack_int4(wp)
    acc = torch.zeros((M, wp.shape[1]), dtype=torch.float32, device=x.device)
    for kg in range(Kp // group_k):
        sl = slice(kg * group_k, (kg + 1) * group_k)
        partial = imatmul(xq[:, sl], w[sl])
        acc = acc + ((partial - corr[g, kg][None, :]).float()
                     * scale[g, kg][None, :])
    if bias is not None:
        acc = acc + bias[None, :].float()
    return acc.to(out_dtype)


def int4_matmul_mrq_fq_ref(x, wp, s_neg, s_pos, scale_neg, scale_pos,
                           bias=None, g=0, group_k: int = 256,
                           out_dtype=torch.float32):
    """4-bit MRQ sign-split codes against nibble-packed weights, per group
    ``acc = acc + (pn * scale_neg[g, kg] + pp * scale_pos[g, kg])``."""
    M, K = x.shape
    Kp = 2 * wp.shape[0]
    qn, qp = (torch.nn.functional.pad(c, (0, Kp - K)) for c in
              mrq_codes_ref(x.float(), s_neg[g][0], s_pos[g][0], 8))
    w = unpack_int4(wp)
    acc = torch.zeros((M, wp.shape[1]), dtype=torch.float32, device=x.device)
    for kg in range(Kp // group_k):
        sl = slice(kg * group_k, (kg + 1) * group_k)
        pn = imatmul(qn[:, sl], w[sl]).float()
        pp = imatmul(qp[:, sl], w[sl]).float()
        acc = acc + (pn * scale_neg[g, kg][None, :]
                     + pp * scale_pos[g, kg][None, :])
    if bias is not None:
        acc = acc + bias[None, :].float()
    return acc.to(out_dtype)


def chunk_rowsum(e):
    """Row sums of (..., K) in the prologue pass's order
    (``csrc/prologue.cuh``, ``prologue_rows_kernel``): the row is cut into
    chunks of 16 columns (the last zero-padded); lane t of a warp adds
    chunks t, t + 32, ... in ascending order, each chunk's columns in
    order, starting from 0; then five butterfly steps ``p[t] + p[t ^ o]``,
    o = 16, 8, 4, 2, 1, add the lanes' partials, as ``warp_rowsum``."""
    K = e.shape[-1]
    J = -(-K // 512)
    t = torch.nn.functional.pad(e, (0, 512 * J - K))
    t = t.reshape(e.shape[:-1] + (J, 32, 16))
    p = torch.zeros(e.shape[:-1] + (32,), dtype=e.dtype, device=e.device)
    for j in range(J):
        for i in range(16):
            p = p + t[..., j, :, i]
    lanes = torch.arange(32, device=e.device)
    for o in (16, 8, 4, 2, 1):
        p = p + p[..., lanes ^ o]
    return p[..., :1]


def layernorm_stats(x, eps: float = 1e-6):
    """(mu, rsig) per row of x in f32, as the prologue pass computes them:
    mean and biased variance (the mean of squared deviations) each summed
    in the pass's order (``chunk_rowsum``) and divided by K; rsig = 1 /
    sqrt(var + eps) with the root and the reciprocal each correctly
    rounded (not an rsqrt)."""
    xf = x.float()
    K = xf.shape[-1]
    # the divides and the root in f64, each rounded to f32 once: exactly
    # the correctly rounded f32 results (f64 carries more than twice f32's
    # digits). torch's own f32 sqrt on the CPU is not always correctly
    # rounded, and it may divide by a Python scalar through its reciprocal.
    mu = (chunk_rowsum(xf).double() / K).float()
    d = xf - mu
    var = (chunk_rowsum(d * d).double() / K).float()
    root = torch.sqrt((var + eps).double()).float()
    return mu, (1.0 / root.double()).float()


def fused_prologue_ref(x, nm=None, ps=None, bv=None, eps: float = 1e-6):
    """Layernorm -> adaLN modulate (per-batch rows gathered by ``bv``) ->
    channel-balance divide, as the kernels' prologue computes it."""
    x = x.float()
    if nm is not None:
        sh, sc = nm
        mu, rsig = layernorm_stats(x, eps)
        x = (x - mu) * rsig
        x = x * (1.0 + sc.float()[bv]) + sh.float()[bv]
    if ps is not None:
        x = x / ps.float()[None, :]
    return x


def fused_epilogue_ref(y, gr=None, bv=None):
    """``residual + gate[bv] * y``."""
    if gr is not None:
        gate, res = gr
        y = res.float() + gate.float()[bv] * y
    return y


def int8_matmul_fq_fused_ref(x, wq, sx, zx, scale, corr, bias=None, g=0,
                             ps=None, nm=None, gr=None, bv=None,
                             bits: int = 8, out_dtype=torch.float32):
    xf = fused_prologue_ref(x, nm=nm, ps=ps, bv=bv)
    y = int8_matmul_fq_ref(xf, wq, sx, zx, scale, corr, bias=bias, g=g,
                           bits=bits)
    return fused_epilogue_ref(y, gr=gr, bv=bv).to(out_dtype)


def int8_matmul_mrq_fq_fused_ref(x, wq, s_neg, s_pos, scale_neg, scale_pos,
                                 bias=None, g=0, ps=None, nm=None, gr=None,
                                 bv=None, bits: int = 8,
                                 out_dtype=torch.float32):
    xf = fused_prologue_ref(x, nm=nm, ps=ps, bv=bv)
    y = int8_matmul_mrq_fq_ref(xf, wq, s_neg, s_pos, scale_neg, scale_pos,
                               bias=bias, g=g, bits=bits)
    return fused_epilogue_ref(y, gr=gr, bv=bv).to(out_dtype)


def int4_matmul_fq_fused_ref(x, wp, sx, zx, scale, corr, bias=None, g=0,
                             ps=None, nm=None, gr=None, bv=None,
                             group_k: int = 256, out_dtype=torch.float32):
    xf = fused_prologue_ref(x, nm=nm, ps=ps, bv=bv)
    y = int4_matmul_fq_ref(xf, wp, sx, zx, scale, corr, bias=bias, g=g,
                           group_k=group_k)
    return fused_epilogue_ref(y, gr=gr, bv=bv).to(out_dtype)


def int4_matmul_mrq_fq_fused_ref(x, wp, s_neg, s_pos, scale_neg, scale_pos,
                                 bias=None, g=0, ps=None, nm=None, gr=None,
                                 bv=None, group_k: int = 256,
                                 out_dtype=torch.float32):
    xf = fused_prologue_ref(x, nm=nm, ps=ps, bv=bv)
    y = int4_matmul_mrq_fq_ref(xf, wp, s_neg, s_pos, scale_neg, scale_pos,
                               bias=bias, g=g, group_k=group_k)
    return fused_epilogue_ref(y, gr=gr, bv=bv).to(out_dtype)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def sym_quantize_int8_ref(x, scale, bits: int = 8):
    """Symmetric codes over [-(h-1), h-1]."""
    hi = 2 ** (bits - 1) - 1
    return torch.clamp(torch.round(x.float() / scale), -hi, hi).to(torch.int8)


def _ceil(x, to=8):
    return max(to, -to * (-x // to))


def tile_rowsum(e):
    """Row sums of one kv tile (..., n <= 128) in the CUDA kernel's order:
    the tile is 128 lanes (masked lanes add 0); lane ``8 nt + 2 t + c`` of
    a row belongs to thread t of four, which adds its 32 lanes in order
    (nt, then c), and the four partial sums meet in two warp shuffles as
    ``(p0 + p1) + (p2 + p3)``. A float sum's value depends on its order,
    and a code on a .5 boundary flips with it."""
    e = torch.nn.functional.pad(e, (0, 128 - e.shape[-1]))
    t = e.reshape(e.shape[:-1] + (16, 4, 2)).transpose(-3, -2)
    t = t.reshape(e.shape[:-1] + (4, 32))
    p = t[..., 0]
    for i in range(1, 32):
        p = p + t[..., i]
    return ((p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3]))[..., None]


def flash_core_ref(q, k, v, sq, sk, qs, s1, sv, sc1, sc2, bits: int,
                   bn: int = 128, out_dtype=torch.float32,
                   packed_kv: bool = False, mask=None):
    """The flash kernel's per-kv-tile recurrence over (B, S, hd) operands
    with per-call scalar params (0-d f32 tensors): int8 QK^T, NEG_INF on
    ragged lanes and then on the lanes ``mask`` (a (B, M, N) boolean,
    True = attend) leaves out, BEFORE the online max, running
    max/denominator, MRQ codes against the running normalisation,
    dual-region integer P·V with the fp rescale ``rho = corr * l_prev /
    l_new``. The mask is padded with False on the ragged lanes, as the
    reference pads it: a fully masked row gets ``e = 1`` on every lane
    up to the padded length ``Np``. ``packed_kv`` (4-bit): the k and v
    codes go through the pack pre-pass (two per byte along the head dim)
    and are widened again, as the kernel streams them."""
    B, M, D = q.shape
    N = k.shape[1]
    half = 2 ** (bits - 1)
    bn_ = min(bn, _ceil(N))
    Np = -bn_ * (-N // bn_)
    s2 = 1.0 / half
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, 0, 0, Np - N))
    q8 = sym_quantize_int8_ref(q, sq, bits)
    k8 = sym_quantize_int8_ref(pad(k), sk, bits)
    v8 = sym_quantize_int8_ref(pad(v), sv, bits)
    if packed_kv:
        if bits != 4:
            raise ValueError("packed_kv streams nibbles: 4-bit codes only")
        k8, v8 = (unpack_int4(pack_int4(c, axis=-1), D, axis=-1)
                  for c in (k8, v8))
    if mask is not None:
        mask = torch.cat([mask.bool(), torch.zeros(
            (B, M, Np - N), dtype=torch.bool, device=mask.device)], dim=-1)

    dev = q.device
    m_run = torch.full((B, M, 1), _M_INIT, dtype=torch.float32, device=dev)
    l_run = torch.zeros((B, M, 1), dtype=torch.float32, device=dev)
    acc1 = torch.zeros((B, M, D), dtype=torch.float32, device=dev)
    acc2 = torch.zeros((B, M, D), dtype=torch.float32, device=dev)
    col = torch.arange(Np, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for n0 in range(0, Np, bn_):
        kt, vt = k8[:, n0:n0 + bn_], v8[:, n0:n0 + bn_]
        s = imatmul(q8, kt.transpose(1, 2)).float() * qs
        s = torch.where(col[n0:n0 + bn_][None, None, :] < N, s,
                        torch.full_like(s, NEG_INF))
        if mask is not None:
            s = torch.where(mask[:, :, n0:n0 + bn_], s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        e = torch.exp(s - m_new)
        corr = torch.exp(m_run - m_new)
        l_new = l_run * corr + tile_rowsum(e)
        p = e / l_new
        region1 = p < half * s1
        c1 = torch.where(region1, torch.clamp(torch.round(p / s1), 0,
                                              half - 1), zero)
        c2 = torch.where(region1, zero,
                         torch.clamp(torch.round(p / s2), 0, half))
        d1 = imatmul(c1, vt)
        d2 = imatmul(c2, vt)
        rho = corr * l_run / l_new
        acc1 = acc1 * rho + d1.float()
        acc2 = acc2 * rho + d2.float()
        m_run, l_run = m_new, l_new
    return (acc1 * sc1 + acc2 * sc2).to(out_dtype)


def flash_attn_mrq_ref(q, k, v, qk_pack, pv_pack, mask=None, scale=1.0,
                       g_qk=0, g_pv=0, bits: int = 8, bn: int = 128,
                       out_dtype=torch.float32):
    """Tile-faithful oracle over FLATTENED (B, S, hd) operands (kv
    materialised per q batch), mirroring ``repro.kernels.ref``."""
    return flash_core_ref(
        q, k, v, qk_pack["s_q"][g_qk][0], qk_pack["s_k"][g_qk][0],
        qk_pack["scale"][g_qk][0] * scale, pv_pack["s1"][g_pv][0],
        pv_pack["s_v"][g_pv][0], pv_pack["scale1"][g_pv][0],
        pv_pack["scale2"][g_pv][0], bits, bn=bn, out_dtype=out_dtype,
        mask=mask)


# ---------------------------------------------------------------------------
# composed int8 attention: B9a (QK^T) -> B10a (softmax -> codes) -> B9b (P.V)
# ---------------------------------------------------------------------------
def warp_rowsum(e):
    """Row sums of (..., C) in the softmax-codes kernel's order
    (``csrc/softmax_mrq.cu``): lane t of a warp adds columns t, t + 32,
    ... in ascending order from 0 (padding columns add 0), then five
    butterfly steps ``p[t] + p[t ^ o]``, o = 16, 8, 4, 2, 1, add the
    lanes' partials (float addition commutes, so every lane ends with the
    same sum)."""
    C = e.shape[-1]
    Cp = -32 * (-C // 32)
    t = torch.nn.functional.pad(e, (0, Cp - C))
    t = t.reshape(e.shape[:-1] + (Cp // 32, 32))
    p = t[..., 0, :]
    for j in range(1, Cp // 32):
        p = p + t[..., j, :]
    lanes = torch.arange(32, device=e.device)
    for o in (16, 8, 4, 2, 1):
        p = p + p[..., lanes ^ o]
    return p[..., :1]


def int8_bmm_qk_core(q, k, sq, sk, sc, bits: int, out_dtype=torch.float32):
    """``(q8 @ k8^T) * sc`` over (B, M, D) x (B, N, D); sq, sk, sc 0-d or
    (B, 1, 1) per-batch-row columns."""
    q8 = sym_quantize_int8_ref(q, sq, bits)
    k8 = sym_quantize_int8_ref(k, sk, bits)
    return (imatmul(q8, k8.transpose(-1, -2)).float() * sc).to(out_dtype)


def softmax_mrq_codes_core(scores, s1, bits: int):
    """Row softmax (last axis; the kernel's max, exp and row-sum order)
    then region-signed int8 codes against ``s1`` (0-d, or one step per
    row as a (..., 1) column)."""
    half = 2 ** (bits - 1)
    x = scores.float()
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    p = e / warp_rowsum(e)
    s2 = 1.0 / half
    q1 = torch.clamp(torch.round(p / s1), 0, half - 1)
    q2 = torch.clamp(torch.round(p / s2), 0, half)
    return torch.where(p < half * s1, q1, -q2).to(torch.int8)


def int8_bmm_pv_core(codes, v, sv, sc1, sc2, bits: int,
                     out_dtype=torch.float32):
    """``(c1 @ v8) * sc1 + (c2 @ v8) * sc2`` with ``c1 = max(c, 0)``,
    ``c2 = max(-c, 0)`` over (B, M, N) codes and (B, N, D) v."""
    c = codes.to(torch.int32)
    c1 = torch.clamp(c, min=0)
    c2 = torch.clamp(-c, min=0)
    v8 = sym_quantize_int8_ref(v, sv, bits)
    y = imatmul(c1, v8).float() * sc1 + imatmul(c2, v8).float() * sc2
    return y.to(out_dtype)


def int8_bmm_qk_ref(q, k, s_q, s_k, scale, g=0, bits: int = 8,
                    out_dtype=torch.float32):
    """Batched symmetric QK^T oracle (q and k batches equal); s_q, s_k,
    scale (G, 1), scale the combined ``s_q[g] * s_k[g] * alpha``."""
    return int8_bmm_qk_core(q, k, s_q[g][0], s_k[g][0], scale[g][0], bits,
                            out_dtype)


def softmax_mrq_codes_ref(scores, s1, g=0, bits: int = 8):
    """Row softmax then region-signed codes: c >= 0 a region-1 code (step
    s1[g]), c < 0 the negated region-2 code (step s2 = 1/half)."""
    return softmax_mrq_codes_core(scores, s1[g][0], bits)


def _scalar(s, like):
    """A step as a 0-d f32 tensor on ``like``'s device: on the card a
    divide by a host scalar runs as a reciprocal multiply, which rounds
    otherwise than the kernels' IEEE divide."""
    return torch.as_tensor(s, dtype=torch.float32, device=like.device)


def softmax_mrq_ref(scores, s1, bits: int, out_dtype=torch.float32):
    """Row softmax (last axis; the kernel's max, exp and row-sum order,
    ``warp_rowsum``) then the MRQ two-region quant-dequant (B12): ``q1 =
    clip(rint(p / s1), 0, half-1) * s1`` where ``p < half * s1``, else
    ``q2 = clip(rint(p / s2), 0, half) * s2`` with ``s2 = 1/half``; ``s1``
    a scalar."""
    half = 2 ** (bits - 1)
    x = scores.float()
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    p = e / warp_rowsum(e)
    s1 = _scalar(s1, x)
    s2 = 1.0 / half
    q1 = torch.clamp(torch.round(p / s1), 0, half - 1) * s1
    q2 = torch.clamp(torch.round(p / s2), 0, half) * s2
    return torch.where(p < half * s1, q1, q2).to(out_dtype)


def gelu_tanh_ref(x):
    """``jax.nn.gelu(x, approximate=True)`` op by op in its order, each
    step its own f32 op: ``x * (0.5 * (1 + tanh(c * (x + 0.044715 *
    (x * x * x)))))`` with ``c`` = f32 sqrt(2/pi)."""
    inner = SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def silu_ref(x):
    """``x * sigmoid(x)`` with the sigmoid spelled ``1 / (1 + exp(-x))``
    (an IEEE reciprocal)."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def act_mrq_ref(x, s_neg, s_pos, bits: int, kind: str = "gelu",
                out_dtype=torch.float32):
    """GELU (tanh) or SiLU in f32, then the MRQ signed two-region
    quant-dequant (B13): ``clip(rint(h / s_neg), -half, 0) * s_neg`` where
    ``h < 0``, else ``clip(rint(h / s_pos), 0, half-1) * s_pos``.

    Zeros take ``jnp.clip``'s signs, whose max and min order -0 below +0
    (``torch.clamp`` keeps the first operand of a tie, and on the card
    its min of -0 and +0 is the hardware's): the negative branch keeps a
    zero rint's sign and makes a positive rint +0, the positive branch
    makes every zero +0. With positive steps the output's sign bit is set
    exactly where ``h < 0``."""
    if kind not in ("gelu", "silu"):
        raise ValueError(kind)
    half = 2 ** (bits - 1)
    xf = x.float()
    h = gelu_tanh_ref(xf) if kind == "gelu" else silu_ref(xf)
    sn, sp = _scalar(s_neg, xf), _scalar(s_pos, xf)
    vn = torch.round(h / sn)
    qn = torch.where(vn > 0, 0.0, torch.clamp(vn, min=-half)) * sn
    qp = (torch.clamp(torch.round(h / sp), 0, half - 1) + 0.0) * sp
    return torch.where(h < 0, qn, qp).to(out_dtype)


def mrq_codes_decode_ref(codes, s1, g=0, bits: int = 8):
    """Region-signed prob codes back to fp probabilities."""
    half = 2 ** (bits - 1)
    c = codes.float()
    return torch.where(c >= 0, c * s1[g][0], -c * (1.0 / half))


def int8_bmm_pv_ref(codes, v, s_v, scale1, scale2, g=0, bits: int = 8,
                    out_dtype=torch.float32):
    """Batched dual-region P.V oracle (codes and v batches equal);
    scale1 = s1[g] * s_v[g], scale2 = s2 * s_v[g]."""
    return int8_bmm_pv_core(codes, v, s_v[g][0], scale1[g][0], scale2[g][0],
                            bits, out_dtype)


def int8_attention_ref(q, k, v, qk_pack, pv_pack, mask=None, scale=1.0,
                       g=0, bits: int = 8, out_dtype=torch.float32):
    """The composed chain over FLATTENED (B, S, hd) operands: symmetric
    QK^T -> mask -> softmax-to-codes -> dual-region P.V."""
    scores = int8_bmm_qk_ref(q, k, qk_pack["s_q"], qk_pack["s_k"],
                             qk_pack["scale"] * scale, g=g, bits=bits)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    codes = softmax_mrq_codes_ref(scores, pv_pack["s1"], g=g, bits=bits)
    return int8_bmm_pv_ref(codes, v, pv_pack["s_v"], pv_pack["scale1"],
                           pv_pack["scale2"], g=g, bits=bits,
                           out_dtype=out_dtype)


def flash_vs_composed_atol(pv_pack, g, n_kv: int, bits: int = 8) -> float:
    """The reference's flash-vs-composed contract (worst case): both
    paths dequantise each probability within one coarse step s2 of the
    other, and an output element sums ``n_kv`` of them against values of
    magnitude <= (half - 1) * s_v[g]:
    ``n_kv * s2 * (half - 1) * s_v[g]``."""
    half = 2 ** (bits - 1)
    s_v = float(pv_pack["s_v"][g][0])
    return n_kv * (1.0 / half) * (half - 1) * s_v


# ---------------------------------------------------------------------------
# per-row-group oracles (vector tgroup): the ``*_vec`` kernels B6a, B6b,
# B7a, B7b and B8 of the continuous-batching slot pool. Row i of a linear
# (batch row b of flash) takes the parameters of group gv[i] (g[b]),
# gathered from the full (G, ...) stacks; a constant vector is the scalar
# oracle at that group, element for element.
# ---------------------------------------------------------------------------
def _row_groups(gv, n, device):
    """gv as int64 indices, or group 0 for all n rows when None."""
    if gv is None:
        return torch.zeros((n,), dtype=torch.int64, device=device)
    return gv.long()


def int8_matmul_fq_vec_ref(x, wq, sx, zx, scale, corr, bias=None, gv=None,
                           bits: int = 8, out_dtype=torch.float32):
    gv = _row_groups(gv, x.shape[0], x.device)
    xq = quantize_int8_ref(x.float(), sx[gv], zx[gv], bits)
    y = (imatmul(xq, wq) - corr[gv]).float() * scale[gv]
    if bias is not None:
        y = y + bias[None, :].float()
    return y.to(out_dtype)


def int8_matmul_mrq_fq_vec_ref(x, wq, s_neg, s_pos, scale_neg, scale_pos,
                               bias=None, gv=None, bits: int = 8,
                               out_dtype=torch.float32):
    half = 2 ** (bits - 1)
    gv = _row_groups(gv, x.shape[0], x.device)
    qn, qp = mrq_codes_ref(x.float(), s_neg[gv], s_pos[gv], half)
    y = (imatmul(qn, wq).float() * scale_neg[gv]
         + imatmul(qp, wq).float() * scale_pos[gv])
    if bias is not None:
        y = y + bias[None, :].float()
    return y.to(out_dtype)


def int4_matmul_fq_vec_ref(x, wp, sx, zx, scale, corr, bias=None, gv=None,
                           group_k: int = 256, out_dtype=torch.float32):
    """B4's group-ordered f32 accumulation with per-row scale/corr rows
    ``scale[gv[i], kg]``."""
    M, K = x.shape
    Kp = 2 * wp.shape[0]
    gv = _row_groups(gv, M, x.device)
    xq = quantize_int8_ref(x.float(), sx[gv], zx[gv], bits=4)
    xq = torch.nn.functional.pad(xq, (0, Kp - K))
    w = unpack_int4(wp)
    scale_r, corr_r = scale[gv], corr[gv]                 # (M, nk, N)
    acc = torch.zeros((M, wp.shape[1]), dtype=torch.float32, device=x.device)
    for kg in range(Kp // group_k):
        sl = slice(kg * group_k, (kg + 1) * group_k)
        partial = imatmul(xq[:, sl], w[sl])
        acc = acc + ((partial - corr_r[:, kg]).float() * scale_r[:, kg])
    if bias is not None:
        acc = acc + bias[None, :].float()
    return acc.to(out_dtype)


def int4_matmul_mrq_fq_vec_ref(x, wp, s_neg, s_pos, scale_neg, scale_pos,
                               bias=None, gv=None, group_k: int = 256,
                               out_dtype=torch.float32):
    M, K = x.shape
    Kp = 2 * wp.shape[0]
    gv = _row_groups(gv, M, x.device)
    qn, qp = (torch.nn.functional.pad(c, (0, Kp - K)) for c in
              mrq_codes_ref(x.float(), s_neg[gv], s_pos[gv], 8))
    w = unpack_int4(wp)
    sn_r, sp_r = scale_neg[gv], scale_pos[gv]             # (M, nk, N)
    acc = torch.zeros((M, wp.shape[1]), dtype=torch.float32, device=x.device)
    for kg in range(Kp // group_k):
        sl = slice(kg * group_k, (kg + 1) * group_k)
        pn = imatmul(qn[:, sl], w[sl]).float()
        pp = imatmul(qp[:, sl], w[sl]).float()
        acc = acc + (pn * sn_r[:, kg] + pp * sp_r[:, kg])
    if bias is not None:
        acc = acc + bias[None, :].float()
    return acc.to(out_dtype)


def int8_matmul_fq_vec_fused_ref(x, wq, sx, zx, scale, corr, bias=None,
                                 gv=None, ps=None, nm=None, gr=None, bv=None,
                                 bits: int = 8, out_dtype=torch.float32):
    xf = fused_prologue_ref(x, nm=nm, ps=ps, bv=bv)
    y = int8_matmul_fq_vec_ref(xf, wq, sx, zx, scale, corr, bias=bias,
                               gv=gv, bits=bits)
    return fused_epilogue_ref(y, gr=gr, bv=bv).to(out_dtype)


def int8_matmul_mrq_fq_vec_fused_ref(x, wq, s_neg, s_pos, scale_neg,
                                     scale_pos, bias=None, gv=None, ps=None,
                                     nm=None, gr=None, bv=None,
                                     bits: int = 8, out_dtype=torch.float32):
    xf = fused_prologue_ref(x, nm=nm, ps=ps, bv=bv)
    y = int8_matmul_mrq_fq_vec_ref(xf, wq, s_neg, s_pos, scale_neg,
                                   scale_pos, bias=bias, gv=gv, bits=bits)
    return fused_epilogue_ref(y, gr=gr, bv=bv).to(out_dtype)


def int4_matmul_fq_vec_fused_ref(x, wp, sx, zx, scale, corr, bias=None,
                                 gv=None, ps=None, nm=None, gr=None, bv=None,
                                 group_k: int = 256, out_dtype=torch.float32):
    xf = fused_prologue_ref(x, nm=nm, ps=ps, bv=bv)
    y = int4_matmul_fq_vec_ref(xf, wp, sx, zx, scale, corr, bias=bias,
                               gv=gv, group_k=group_k)
    return fused_epilogue_ref(y, gr=gr, bv=bv).to(out_dtype)


def int4_matmul_mrq_fq_vec_fused_ref(x, wp, s_neg, s_pos, scale_neg,
                                     scale_pos, bias=None, gv=None, ps=None,
                                     nm=None, gr=None, bv=None,
                                     group_k: int = 256,
                                     out_dtype=torch.float32):
    xf = fused_prologue_ref(x, nm=nm, ps=ps, bv=bv)
    y = int4_matmul_mrq_fq_vec_ref(xf, wp, s_neg, s_pos, scale_neg,
                                   scale_pos, bias=bias, gv=gv,
                                   group_k=group_k)
    return fused_epilogue_ref(y, gr=gr, bv=bv).to(out_dtype)


def flash_attn_mrq_vec_ref(q, k, v, qk_pack, pv_pack, mask=None, scale=1.0,
                           g_qk=None, g_pv=None, bits: int = 8, bn: int = 128,
                           out_dtype=torch.float32, packed_kv: bool = False):
    """The flash recurrence (``flash_core_ref``) with every group-gathered
    scalar widened to a (B, 1, 1) per-batch-row column; q, k and v share
    their batch (B, S, hd)."""
    B = q.shape[0]
    g_qk, g_pv = (_row_groups(g, B, q.device) for g in (g_qk, g_pv))
    col = lambda t, g: t[g].reshape(B, 1, 1)
    return flash_core_ref(
        q, k, v, col(qk_pack["s_q"], g_qk), col(qk_pack["s_k"], g_qk),
        col(qk_pack["scale"], g_qk) * scale, col(pv_pack["s1"], g_pv),
        col(pv_pack["s_v"], g_pv), col(pv_pack["scale1"], g_pv),
        col(pv_pack["scale2"], g_pv), bits, bn=bn, out_dtype=out_dtype,
        packed_kv=packed_kv, mask=mask)


def _batch_col(t, gv):
    """Rows ``gv`` of a (G, 1) stack as a (B, 1, 1) per-batch-row column."""
    return t[gv].reshape(-1, 1, 1)


def int8_bmm_qk_vec_ref(q, k, s_q, s_k, scale, gv=None, bits: int = 8,
                        out_dtype=torch.float32):
    """B9a with batch row b at group gv[b] (q and k batches equal)."""
    gv = _row_groups(gv, q.shape[0], q.device)
    return int8_bmm_qk_core(q, k, _batch_col(s_q, gv), _batch_col(s_k, gv),
                            _batch_col(scale, gv), bits, out_dtype)


def softmax_mrq_codes_vec_ref(scores, s1, gv=None, bits: int = 8):
    """B10a with one group per row: gv has shape ``scores.shape[:-1]``."""
    if gv is None:
        gv = torch.zeros(scores.shape[:-1], dtype=torch.int64,
                         device=scores.device)
    return softmax_mrq_codes_core(scores, s1[gv.long()], bits)


def int8_bmm_pv_vec_ref(codes, v, s_v, scale1, scale2, gv=None,
                        bits: int = 8, out_dtype=torch.float32):
    """B9b with batch row b at group gv[b] (codes and v batches equal)."""
    gv = _row_groups(gv, codes.shape[0], codes.device)
    return int8_bmm_pv_core(codes, v, _batch_col(s_v, gv),
                            _batch_col(scale1, gv), _batch_col(scale2, gv),
                            bits, out_dtype)


def int8_attention_vec_ref(q, k, v, qk_pack, pv_pack, mask=None, scale=1.0,
                           gv=None, bits: int = 8, out_dtype=torch.float32):
    """The composed chain with batch row b at group gv[b] (both packs),
    over FLATTENED (B, S, hd) operands."""
    B, M, _ = q.shape
    gv = _row_groups(gv, B, q.device)
    scores = int8_bmm_qk_vec_ref(q, k, qk_pack["s_q"], qk_pack["s_k"],
                                 qk_pack["scale"] * scale, gv=gv, bits=bits)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    codes = softmax_mrq_codes_vec_ref(scores, pv_pack["s1"],
                                      gv=gv[:, None].expand(B, M), bits=bits)
    return int8_bmm_pv_vec_ref(codes, v, pv_pack["s_v"], pv_pack["scale1"],
                               pv_pack["scale2"], gv=gv, bits=bits,
                               out_dtype=out_dtype)
