"""The port's artifact reader and DiT forward held against the JAX package.

The tiny DiT of ``conftest.tiny_dit`` is carried across as numpy; a w8a8
range artifact is written by ``repro.quant.quantize`` + ``save`` and read
back by ``repro_torch.quant.artifact.QuantArtifact.load``. Tolerances:

- artifact leaves, ``fallback_ops()``, recipe and params content hashes:
  equal;
- fp forward: |port - jax| <= 1e-5 * max|jax| (same f32 math; gelu,
  softmax and the layernorm sums round differently by ulps);
- fake-quant and kernel-context (plain versions on the CPU) forwards
  against JAX's fake-quant: relative L2 <= 2e-2 (registry
  ``dit_forward_plain_vs_jax_rel``: an ulp before a round can flip a
  code, and a flip moves an output by one quantization step).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.contexts import RecordingContext
from repro.diffusion import DiffusionCfg as JDiffusionCfg
from repro.models.dit import dit_apply as jdit_apply
from repro.nn.ctx import FPContext as JFPContext
from repro.quant import QuantRecipe as JQuantRecipe, quantize as jquantize
from repro.serving import quickcal as jquickcal
from repro_torch.checkpoint import ckpt
from repro_torch.kernels.ref import TOLERANCES
from repro_torch.models.dit import DiTCfg, dit_apply, params_from_numpy
from repro_torch.nn.ctx import FPContext
from repro_torch.quant.artifact import QuantArtifact
from repro_torch.quant.recipe import QuantRecipe

REL = TOLERANCES["dit_forward_plain_vs_jax_rel"][0]


class _PinnedRecordingContext(RecordingContext):
    """The reference's recorder with its marked tensors kept alive, so a
    freed post-GELU tensor's ``id`` cannot be reused by a later linear's
    input and inherit the mark, whatever the process allocated before
    (ROADMAP queue 3)."""

    pinned: list = []            # shared by the per-layer context copies

    def act(self, name, x, kind):
        self.pinned.append(x)
        return super().act(name, x, kind)


@pytest.fixture(scope="module")
def both(tiny_dit, tmp_path_factory):
    """(jax cfg, jax params, port cfg, port params, jax artifact, port
    artifact) — the artifact saved by JAX and loaded by the port."""
    jcfg, jp = tiny_dit
    np_params = jax.tree.map(np.asarray, jp)
    tcfg = DiTCfg(**dataclasses.asdict(jcfg))
    tp = params_from_numpy(np_params, device="cpu")
    dif = JDiffusionCfg(T=1000, tgq_groups=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jquickcal, "RecordingContext", _PinnedRecordingContext)
        jart = jquantize(jp, jcfg, dif, JQuantRecipe(
            bits="w8a8", n_per_group=2, calib_batch=2))
    path = str(tmp_path_factory.mktemp("art") / "w8a8")
    jart.save(path)
    tart = QuantArtifact.load(path, device="cpu", params=tp)
    return jcfg, jp, tcfg, tp, jart, tart


def _leaves_equal(j, t, where="qparams"):
    if isinstance(j, dict):
        assert isinstance(t, dict) and sorted(j) == sorted(t), where
        for k in j:
            _leaves_equal(j[k], t[k], f"{where}/{k}")
    elif dataclasses.is_dataclass(j):
        assert type(j).__name__ == type(t).__name__, where
        for f in dataclasses.fields(j):
            _leaves_equal(getattr(j, f.name), getattr(t, f.name),
                          f"{where}.{f.name}")
    elif isinstance(j, (jax.Array, np.ndarray)):
        a, b = np.asarray(j), t.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert j == t, where


def test_artifact_loads_with_every_leaf_equal(both):
    _, jp, _, tp, jart, tart = both
    _leaves_equal(jart.qparams, tart.qparams)
    assert tart.fallback_ops() == jart.fallback_ops() == []
    assert tart.recipe.content_hash() == jart.recipe.content_hash()
    assert tart.recipe == QuantRecipe.from_dict(jart.recipe.to_dict())
    assert tart.meta["recipe_hash"] == jart.recipe.content_hash()
    assert ckpt.content_hash(tp) == tart.params_hash
    assert tart.model_cfg() == DiTCfg(**dataclasses.asdict(jart.model_cfg()))
    assert dataclasses.asdict(tart.dif_cfg()) == dataclasses.asdict(
        jart.dif_cfg())
    assert tart.packed_counts() == {"int8_matmul_fq": 13,
                                    "int8_matmul_mrq_fq": 2,
                                    "int4_matmul_fq": 0,
                                    "int4_matmul_mrq_fq": 0,
                                    "flash_attn_mrq": 2,
                                    "flash_attn_mrq_packed_kv": 0}
    bad = dict(tp, pos=tp["pos"] + 1)
    with pytest.raises(ValueError, match="content hash mismatch"):
        tart.check_params(bad)


def _inputs(cfg, seed=0, B=2):
    """B=2 matches the calibration batches, so JAX reuses its compiled ops."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, cfg.img_size, cfg.img_size, cfg.in_ch)
                          ).astype(np.float32)
    t = np.asarray([260, 990][:B], np.int32)
    y = np.asarray([3, cfg.n_classes][:B], np.int32)
    return x, t, y


def _fwd_both(both, jctx, tctx, seed=0):
    jcfg, jp, tcfg, tp, _, _ = both
    x, t, y = _inputs(jcfg, seed)
    j = np.asarray(jdit_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(y), ctx=jctx))
    with torch.no_grad():
        o = dit_apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(t).long(),
                      torch.from_numpy(y).long(), ctx=tctx).numpy()
    assert o.shape == j.shape and np.isfinite(o).all()
    return j, o


def test_fp_forward_matches_jax(both):
    j, o = _fwd_both(both, JFPContext(), FPContext())
    assert np.abs(o - j).max() <= 1e-5 * np.abs(j).max()


@pytest.mark.parametrize("kernel", [False, True], ids=["fake_quant",
                                                       "kernel_ctx"])
@pytest.mark.parametrize("tgroup", [0, 3])
def test_quant_forward_matches_jax_fake_quant(both, kernel, tgroup):
    """JAX holds its fused kernel path equal to fake-quant, so the port's
    kernel context (plain versions on the CPU) is held to JAX's
    fake-quant forward too."""
    *_, jart, tart = both
    j, o = _fwd_both(both, jart.context(kernel=False).with_tgroup(tgroup),
                     tart.context(kernel=kernel).with_tgroup(tgroup))
    rel = np.linalg.norm(o - j) / np.linalg.norm(j)
    assert rel <= REL, rel
