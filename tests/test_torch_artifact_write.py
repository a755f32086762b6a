"""Artifact writing held against the JAX package: the port's checkpoint
writer and ``QuantArtifact.save`` (read back by JAX's ``ckpt.restore`` and
``QuantArtifact.load``), the reverse round trip, torn overwrites, and the
launcher's cold start from a saved artifact in a fresh process.

Every comparison is exact: leaves by dtype, shape and bytes; recipes,
metadata, ``fallback_ops()`` and ``ckpt.content_hash`` equal; the cold
start's samples equal the calibrating process's bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core.quantizers import ChannelQ as JChannelQ
from repro.core.quantizers import SymQ as JSymQ
from repro.core.quantizers import TGQ as JTGQ
from repro.core.quantizers import UniformQ as JUniformQ
from repro.quant import QuantArtifact as JQuantArtifact
from repro.quant import QuantRecipe as JQuantRecipe
from repro_torch.checkpoint import ckpt
from repro_torch.diffusion.ddpm import DiffusionCfg
from repro_torch.models.dit import DiTCfg, params_from_numpy
from repro_torch.quant.api import quantize
from repro_torch.quant.artifact import QuantArtifact
from repro_torch.quant.recipe import QuantRecipe

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny shapes run as fast on one intra-op thread, which spares
    the cores of the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a)


def _assert_same_leaves(a, b):
    """Flat leaf lists equal by dtype, shape and bytes."""
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = _np(x), _np(y)
        assert (x.dtype, x.shape) == (y.dtype, y.shape), i
        assert x.tobytes() == y.tobytes(), i


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_ckpt_save_restores_in_jax_and_retains(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.standard_normal((5, 7)).astype(
                np.float32)),
            "blocks": {"codes": torch.arange(-6, 6, dtype=torch.int8),
                       "n": torch.tensor(3, dtype=torch.int32)},
            "none": None, "s": torch.tensor(0.25)}
    path = str(tmp_path / "ck")
    for step in (1, 2, 3):
        ckpt.save(path, step, tree, keep=2)
    assert sorted(os.listdir(path)) == ["latest", "step_00000002",
                                        "step_00000003"]
    assert ckpt.latest_step(path) == jckpt.latest_step(path) == 3
    jckpt.verify_shards(path)
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(
        tuple(a.shape), np.dtype(str(a.dtype).split(".")[-1])),
        {k: v for k, v in tree.items() if v is not None})
    got = jckpt.restore(path, like)
    _assert_same_leaves(ckpt.flatten(tree), jax.tree.leaves(got))
    _assert_same_leaves(ckpt.flatten(tree), ckpt.restore(path))
    assert ckpt.content_hash(tree) == jckpt.content_hash(got)
    with open(os.path.join(path, "step_00000003", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["treedef"] is None and manifest["n_leaves"] == 4
    # shards split at shard_bytes, in leaf order
    ckpt.save(path, 4, tree, keep=1, shard_bytes=64)
    _assert_same_leaves(ckpt.flatten(tree), jax.tree.leaves(
        jckpt.restore(path, like)))
    assert len(os.listdir(os.path.join(path, "step_00000004"))) > 3


def test_ckpt_save_async_copies_to_host_first(tmp_path):
    path = str(tmp_path / "ck")
    t = torch.ones(4, 3)
    ckpt.save_async(path, 7, {"t": t})
    t.add_(1.0)                       # after the call: not in the save
    ckpt.wait_async()
    assert ckpt.latest_step(path) == 7
    np.testing.assert_array_equal(ckpt.restore(path)[0], np.ones((4, 3)))
    ckpt.save_async(path, 8, {"t": t}, keep=1)
    ckpt.save_async(path, 9, {"t": t * 2}, keep=1)   # waits for step 8
    ckpt.wait_async()
    assert ckpt.latest_step(path) == 9
    np.testing.assert_array_equal(ckpt.restore(path)[0], 4 * np.ones((4, 3)))


def test_bf16_leaf_is_refused(tmp_path):
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.save(str(tmp_path / "ck"), 0, [torch.ones(2, dtype=torch.bfloat16)])
    art = QuantArtifact(qparams={"op": {"out_bias": torch.zeros(
        3, dtype=torch.bfloat16)}}, recipe=QuantRecipe())
    with pytest.raises(TypeError, match="/op/out_bias.*bfloat16"):
        art.save(str(tmp_path / "art"))


# ---------------------------------------------------------------------------
# artifacts the port writes, loaded by JAX
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_artifacts(tiny_dit):
    jcfg, jp = tiny_dit
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    tcfg = DiTCfg(**dataclasses.asdict(jcfg))
    dif = DiffusionCfg(T=1000, tgq_groups=2)
    arts = {bits: quantize(tp, tcfg, dif, QuantRecipe(
        bits=bits, n_per_group=1, calib_batch=1), provenance={"t": bits})
        for bits in ("w8a8", "w6a6", "w4a4")}
    arts["ho"] = quantize(tp, tcfg, dif, QuantRecipe(
        method="ho", rounds=1, n_alpha=3, n_per_group=1, calib_batch=1))
    return jp, tp, arts


@pytest.mark.parametrize("name", ["w8a8", "w6a6", "w4a4", "ho"])
def test_port_artifact_loads_in_jax(port_artifacts, tmp_path, name):
    jp, _, arts = port_artifacts
    art = arts[name]
    path = art.save(str(tmp_path / name))
    jart = JQuantArtifact.load(path, expect_recipe=JQuantRecipe.from_dict(
        art.recipe.to_dict()), params=jp)
    _assert_same_leaves(ckpt.flatten(art.qparams),
                        jax.tree.leaves(jart.qparams))
    assert jckpt.content_hash(jart.qparams) == ckpt.content_hash(
        art.qparams)
    assert jart.recipe.to_dict() == art.recipe.to_dict()
    assert jart.meta == json.loads(json.dumps(art.meta))
    assert jart.fallback_ops() == art.fallback_ops() == []
    assert jart.summary().split(":")[0] == art.summary().split(":")[0]
    # ... and in the port, onto the same leaves
    back = QuantArtifact.load(path, device=CPU)
    assert ckpt.content_hash(back.qparams) == ckpt.content_hash(art.qparams)
    assert back.packed_counts() == art.packed_counts()


def test_jax_artifact_resaved_by_port_loads_unchanged(tmp_path):
    """The reference's own HO calibration of the trained checkpoint
    (``experiments/qparams_tq_dit_w8a8_450.pkl``, per-tensor 0-d leaves
    beside TGQ-stacked ones) and a hand-made artifact of every node
    kind, saved by JAX, loaded by the port and saved again, load in JAX
    leaf for leaf, json for json."""
    with open(os.path.join(os.path.dirname(__file__), "..", "experiments",
                           "qparams_tq_dit_w8a8_450.pkl"), "rb") as f:
        pkl = pickle.load(f)
    jart = JQuantArtifact(qparams=pkl["qparams"],
                          recipe=JQuantRecipe(method="ho"),
                          meta={"calib": pkl["report"]})
    assert any(np.ndim(a) == 0 for a in jax.tree.leaves(jart.qparams))
    scalars = JQuantArtifact(qparams={"op": {
        "x": JUniformQ(scale=jnp.float32(0.5), zero=jnp.float32(3.0)),
        "w": JChannelQ(scale=jnp.ones((1, 4), jnp.float32), bits=6),
        "b": JTGQ(JSymQ(scale=jnp.arange(1, 4, dtype=jnp.float32))),
        "bits": 8, "tag": "x", "shape": (2, 3)}},
        recipe=JQuantRecipe(method="ho"), meta={"k": [1, 2]})
    for name, a in (("ho_450", jart), ("scalars", scalars)):
        src, dst = str(tmp_path / f"{name}_j"), str(tmp_path / f"{name}_t")
        a.save(src)
        QuantArtifact.load(src, device=CPU).save(dst)
        b = JQuantArtifact.load(dst)
        _assert_same_leaves(jax.tree.leaves(a.qparams),
                            jax.tree.leaves(b.qparams))
        with open(os.path.join(src, "artifact.json")) as f1, \
                open(os.path.join(dst, "artifact.json")) as f2:
            assert json.load(f1) == json.load(f2)
        assert jax.tree.structure(a.qparams) == jax.tree.structure(b.qparams)


def test_torn_overwrite_is_refused_by_both_readers(port_artifacts, tmp_path):
    """New leaf shards under the old ``artifact.json`` (an overwrite cut
    between its two writes) load in neither package."""
    _, _, arts = port_artifacts
    old, new = str(tmp_path / "old"), str(tmp_path / "new")
    arts["w8a8"].save(old)
    arts["w6a6"].save(new)
    shutil.rmtree(os.path.join(old, "step_00000000"))
    shutil.copytree(os.path.join(new, "step_00000000"),
                    os.path.join(old, "step_00000000"))
    with pytest.raises(ValueError, match="inconsistent"):
        QuantArtifact.load(old, device=CPU)
    with pytest.raises(ValueError, match="inconsistent"):
        JQuantArtifact.load(old)


# ---------------------------------------------------------------------------
# the launcher: flags and the cold start
# ---------------------------------------------------------------------------
CLI = ["--arch", "dit-xl-2", "--smoke", "--device", "cpu", "--steps", "4",
       "--requests", "3", "--quantize", "w8a8"]


def test_serve_cli_cold_start_bit_identical(tmp_path, capsys):
    """HO-calibrate and save (here), cold-start from the saved artifact
    in a fresh process: no calibration runs there, and the two dumps are
    equal bit for bit."""
    from repro_torch.launch import serve
    art, a, b = (str(tmp_path / n) for n in ("art", "a.npy", "b.npy"))
    serve.main(CLI + ["--calib", "ho", "--save-artifact", art,
                      "--dump-samples", a])
    out = capsys.readouterr().out
    assert "ho-calibrated QuantArtifact(w8a8/ho" in out
    assert f"saved artifact -> {art}" in out
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        *CLI, "--load-artifact", art, "--dump-samples", b],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "calibrations run: 0" in r.stdout
    assert "calibrated" not in r.stdout
    sa, sb = np.load(a), np.load(b)
    assert sa.shape == (3, 8, 8, 4) and np.isfinite(sa).all()
    np.testing.assert_array_equal(sa, sb)


def test_serve_cli_artifact_flag_rules(tmp_path, capsys):
    from repro_torch.launch import serve
    base = ["--arch", "dit-xl-2", "--smoke", "--device", "cpu"]
    for extra in (["--save-artifact", "d"],
                  ["--quantize", "w8a8", "--save-artifact", "d",
                   "--load-artifact", "d"]):
        with pytest.raises(SystemExit) as e:
            serve.main(base + extra)
        assert e.value.code == 2
        assert "--save-artifact requires --quantize" in capsys.readouterr().err
    # a saved W8A8 artifact served under another width exits with a message
    path = str(tmp_path / "art")
    _, _, art, _, _, info = serve.build(
        "dit-xl-2", True, "w8a8", 0, 1, 1, 4, 1.0, device=CPU,
        save_artifact=path)
    assert info["save_s"] >= 0 and os.path.exists(
        os.path.join(path, "artifact.json"))
    with pytest.raises(SystemExit, match="--quantize w4a4 but the artifact"):
        serve.main(base + ["--quantize", "w4a4", "--load-artifact", path])


def test_loaded_artifact_keeps_its_diffusion_cfg_and_warns(tmp_path):
    """The served schedule is the artifact's (here G = 4, the CLI's 10),
    and an artifact with an op that carries no pack warns on load too."""
    from repro_torch.configs import dit_xl_2
    from repro_torch.launch.serve import build, perturb_init
    from repro_torch.models.dit import dit_init
    cfg = dit_xl_2.smoke()
    p = perturb_init(dit_init(0, cfg, device=CPU), 0)
    art = quantize(p, cfg, DiffusionCfg(T=1000, tgq_groups=4),
                   QuantRecipe(n_per_group=1, calib_batch=1))
    del art.qparams["blk1/fc1"]["int8"]
    path = art.save(str(tmp_path / "art"))
    with pytest.warns(RuntimeWarning, match="1 quantized op.*blk1/fc1"):
        _, _, loaded, engine, _, info = build(
            "dit-xl-2", True, "none", 0, 1, 1, 4, 1.0, device=CPU,
            load_artifact=path)
    assert engine.dif == DiffusionCfg(T=1000, tgq_groups=4)
    assert loaded.fallback_ops() == ["blk1/fc1"] and info["load_s"] >= 0
