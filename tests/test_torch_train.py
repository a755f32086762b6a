"""The port's DiT training path held against the JAX package on the CPU.

1. ``repro_torch.optim`` against ``repro.optim``: schedules, global norm
   and clip, AdamW, Adafactor, ``apply_updates``, ``accumulate_grads``
   and the int8 gradient compression, over a tree with 1-D, 2-D and
   stacked 3-D leaves, in float32 and bfloat16, for several steps.
2. The keyed initialisers, ``rng.truncated_normal``, ``embedding_init``
   and ``dit_init_from_key`` against the reference's draws from the same
   key: uniforms and zeros bit for bit, normals within ``normal_atol``
   times the stddev.
3. ``ddpm_loss``; one step's gradients at the trained
   ``experiments/dit_tiny_200.pkl``; the port's AdamW given JAX's
   gradients; a 5-step loss trajectory from the same numpy init and
   batches; the launcher's batches against the reference's key stream;
   ``cfg.remat`` against no remat (bit for bit).
4. ``launch/train.py``: an interrupted and resumed run equals an
   uninterrupted one bit for bit; training checkpoints restore from
   either package into the other; ``ckpt.unflatten`` inverts
   ``flatten``; the refusals; autotune's tiny recipe against the
   reference's ``tiny_dit``.

The tolerances are ``repro_torch.kernels.ref.TOLERANCES["train_*"]``,
``["normal_atol"]`` and ``["eval_latents_atol"]``. The file runs on one
torch and one BLAS thread.
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.data import LatentPipeline as JLatentPipeline
from repro.diffusion import DiffusionCfg as JDiffusionCfg
from repro.diffusion import ddpm_loss as jddpm_loss
from repro.diffusion import make_schedule as jmake_schedule
from repro.launch import autotune as jlaunch_autotune
from repro.launch.steps import make_dit_train_step as jmake_step
from repro.models import DiTCfg as JDiTCfg
from repro.models import dit_apply as jdit_apply
from repro.models import dit_init as jdit_init
from repro.nn import initializers as jinit
from repro.nn.layers import embedding_init as jembedding_init
from repro import optim as jopt
from repro_torch.checkpoint import ckpt
from repro_torch.configs import dit_xl_2
from repro_torch.data.synthetic import LatentPipeline
from repro_torch.diffusion import rng
from repro_torch.diffusion.ddpm import DiffusionCfg, ddpm_loss, make_schedule
from repro_torch.kernels import ref as tref
from repro_torch.launch import autotune as tlaunch_autotune
from repro_torch.launch import train as tlaunch_train
from repro_torch.launch.steps import dit_loss_and_grads, \
    make_dit_train_step, pick_optimizer_dit
from repro_torch.launch.tables import ROOT
from repro_torch.models.dit import dit_apply, dit_init_from_key, \
    params_from_numpy
from repro_torch.nn import initializers as tinit
from repro_torch.nn.layers import embedding_init
from repro_torch import optim as topt
from repro_torch.optim.optimizers import tree_leaves, tree_map

CPU = "cpu"
TOL = tref.TOLERANCES
OPT_RTOL = TOL["train_optim_vs_jax_rtol"][0]
NORMAL_ATOL = TOL["normal_atol"][0]
SMOKE = dit_xl_2.smoke()
TINY_CFG, TINY_DIF = tlaunch_autotune.tiny_dit()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny shapes run as fast on one torch intra-op thread and one
    BLAS thread, which spares the other test workers' cores."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# helpers: trees between the packages
# ---------------------------------------------------------------------------
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def to_jax(tree):
    def one(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy(), jnp.bfloat16)
        return jnp.asarray(t.detach().numpy())
    return tree_map(one, tree)


def to_np(tree):
    """A tree of either package's arrays -> float64 / integer numpy."""
    def one(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().float() if a.is_floating_point() else a
            return a.numpy()
        a = np.asarray(a)
        return a.astype(np.float64) if a.dtype.kind == "V" or \
            a.dtype.name == "bfloat16" else a
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    return one(tree)


def jcfg_of(cfg):
    return JDiTCfg(**dataclasses.asdict(cfg))


def assert_close(got, want, rtol, atol=0.0, what=""):
    got, want = to_np(got), to_np(want)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, g.shape, w.shape)
        bound = atol + rtol * np.abs(w).max()
        err = np.abs(g - w).max() if g.size else 0.0
        assert err <= bound, (what, err, bound)


def leaf_tree(seed=0):
    """1-D, 2-D and stacked 3-D leaves, numpy float32 values."""
    r = np.random.default_rng(seed)
    shapes = {"dense": {"w": (6, 5), "b": (5,)}, "blocks": {"w": (3, 4, 7)},
              "scale": (4,)}
    return tree_map(lambda s: r.normal(size=s).astype(np.float32) * 0.5,
                    shapes)


def both(np_tree, dtype):
    """(port tree, JAX tree) of the same values in ``dtype``."""
    t = tree_map(lambda a: torch.from_numpy(a).to(TDT[dtype]), np_tree)
    return t, to_jax(t)


def normals_close(got, want, std, dtype, what):
    """Normals of stddev ``std``: within normal_atol x std elementwise;
    in bfloat16 values that close may also round one bf16 ulp apart."""
    g, w = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    ulp = 2.0 ** -7 * np.abs(w) if dtype == "bfloat16" else 0.0
    assert (np.abs(g - w) <= NORMAL_ATOL * std + ulp).all(), what


def bf16_ulp_close(got, want, dtype, rtol, what):
    """float32: within rtol of the leaf's max. bfloat16: the same, or one
    bf16 rounding apart (an f32 value within rtol may round to the
    neighbouring bf16)."""
    extra = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    got, want = to_np(got), to_np(want)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        err = np.abs(g - w)
        bound = rtol * np.abs(w).max() + extra * np.abs(w)
        assert (err <= bound + 1e-30).all(), (what, err.max())


# ---------------------------------------------------------------------------
# 1. optimizers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sched", ["cosine", "cosine_short", "constant"])
def test_schedules_match_jax(sched):
    if sched == "constant":
        t, j = topt.constant_schedule(3e-4), jopt.constant_schedule(3e-4)
    elif sched == "cosine":
        t, j = topt.cosine_schedule(2e-3, 20, 200), \
            jopt.cosine_schedule(2e-3, 20, 200)
    else:
        t, j = topt.cosine_schedule(1e-4, 0, 1, final_frac=0.2), \
            jopt.cosine_schedule(1e-4, 0, 1, final_frac=0.2)
    for step in (0, 1, 5, 19, 20, 21, 100, 199, 200, 250):
        got = t(torch.tensor(step, dtype=torch.int32))
        want = np.asarray(j(jnp.int32(step)))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), want, rtol=OPT_RTOL,
                                   atol=0, err_msg=f"step {step}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_and_clip_match_jax(dtype):
    t, j = both(leaf_tree(), dtype)
    np.testing.assert_allclose(topt.global_norm(t).numpy(),
                               np.asarray(jopt.global_norm(j)),
                               rtol=OPT_RTOL)
    for max_norm in (0.5, 1e3):
        tc, tn = topt.clip_by_global_norm(t, max_norm)
        jc, jn = jopt.clip_by_global_norm(j, max_norm)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=OPT_RTOL)
        bf16_ulp_close(tc, jc, dtype, OPT_RTOL, f"clip {max_norm}")


def run_optimizer(make_t, make_j, dtype, steps=4, grad_scale=1.0):
    """Both optimizers from their own init over ``steps`` steps of the
    same numpy gradients; every step's updates, state and parameters
    compared."""
    pt, pj = both(leaf_tree(1), dtype)
    opt_t, opt_j = make_t(), make_j()
    st, sj = opt_t.init(pt), opt_j.init(pj)
    for k in range(steps):
        g = tree_map(lambda a: a * grad_scale, leaf_tree(10 + k))
        gt, gj = both(g, dtype)
        with torch.no_grad():
            ut, st = opt_t.update(gt, st, pt)
        uj, sj = opt_j.update(gj, sj, pj)
        assert st["step"].dtype == torch.int32 and int(st["step"]) == k + 1
        for leaf in tree_leaves(ut):
            assert leaf.dtype == TDT[dtype]
        bf16_ulp_close(ut, uj, dtype, OPT_RTOL, f"updates, step {k}")
        state_t = {kk: v for kk, v in st.items() if kk != "step"}
        state_j = {kk: v for kk, v in sj.items() if kk != "step"}
        for leaf in tree_leaves(state_t):
            assert leaf.dtype == torch.float32
        assert_close(state_t, state_j, OPT_RTOL, what=f"state, step {k}")
        pt, pj = topt.apply_updates(pt, ut), jopt.apply_updates(pj, uj)
        bf16_ulp_close(pt, pj, dtype, OPT_RTOL, f"params, step {k}")
        # each package steps on from the same parameters
        pt = tree_map(lambda a: torch.from_numpy(
            np.array(a, np.float32)).to(TDT[dtype]), to_np(pj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd,clip", [(0.0, 1.0), (0.01, None), (0.1, 0.3)])
def test_adamw_matches_jax(dtype, wd, clip):
    sched = (2e-3, 2, 10)
    run_optimizer(
        lambda: topt.adamw(topt.cosine_schedule(*sched), weight_decay=wd,
                           max_grad_norm=clip),
        lambda: jopt.adamw(jopt.cosine_schedule(*sched), weight_decay=wd,
                           max_grad_norm=clip), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd,clip", [(0.0, 1.0), (0.01, None)])
def test_adafactor_matches_jax(dtype, wd, clip):
    run_optimizer(
        lambda: topt.adafactor(1e-2, weight_decay=wd, max_grad_norm=clip),
        lambda: jopt.adafactor(1e-2, weight_decay=wd, max_grad_norm=clip),
        dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adafactor_state_layout_matches_jax(dtype):
    pt, pj = both(leaf_tree(), dtype)
    st = topt.adafactor(1e-2).init(pt)
    sj = jopt.adafactor(1e-2).init(pj)
    assert [tuple(l.shape) for l in tree_leaves(st["v"])] == \
        [l.shape for l in jax.tree.leaves(sj["v"])]
    assert st["v"]["blocks"]["w"]["vc"].shape == (3, 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(dtype):
    pt, pj = both(leaf_tree(2), dtype)
    ut, uj = both(tree_map(lambda a: a * 1e-2, leaf_tree(3)), dtype)
    assert_close(topt.apply_updates(pt, ut), jopt.apply_updates(pj, uj),
                 0.0, what="apply_updates")


def test_accumulate_grads_matches_jax():
    """Four microbatches of a quadratic loss with a per-microbatch aux."""
    pt, pj = both(leaf_tree(4), "float32")
    r = np.random.default_rng(5)
    batches = {"x": r.normal(size=(4, 3)).astype(np.float32)}

    def jfn(params, mb):
        def loss(p):
            s = sum(jnp.sum(l * l) for l in jax.tree.leaves(p))
            return s * jnp.sum(mb["x"]), jnp.sum(mb["x"])
        (l, aux), g = jax.value_and_grad(loss, has_aux=True)(params)
        return (l, aux), g

    def tfn(params, mb):
        with torch.enable_grad():
            live = tree_map(lambda a: a.detach().requires_grad_(True),
                            params)
            s = sum(torch.sum(l * l) for l in tree_leaves(live))
            l = s * torch.sum(mb["x"])
            g = torch.autograd.grad(l, tree_leaves(live))
        return (l.detach(), torch.sum(mb["x"])), ckpt.unflatten(params,
                                                                list(g))
    gj, lj, auxj = jopt.accumulate_grads(jfn, pj, {"x": jnp.asarray(
        batches["x"])})
    gt, lt, auxt = topt.accumulate_grads(tfn, pt, {"x": torch.from_numpy(
        batches["x"])})
    assert_close(gt, gj, OPT_RTOL, what="grads")
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=OPT_RTOL)
    np.testing.assert_allclose(auxt.numpy(), np.asarray(auxj), rtol=OPT_RTOL)
    assert auxt.shape == (4,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_grads_int8_matches_jax(dtype):
    """Three steps of error feedback: the codes and residuals equal JAX's
    bit for bit (max, IEEE divide, round half to even, one multiply)."""
    pt, pj = both(leaf_tree(6), dtype)
    et, ej = topt.init_error_state(pt), jopt.init_error_state(pj)
    assert_close(et, ej, 0.0, what="init_error_state")
    for k in range(3):
        gt, gj = both(leaf_tree(20 + k), dtype)
        dt_, et = topt.compress_grads_int8(gt, et)
        dj, ej = jopt.compress_grads_int8(gj, ej)
        assert_close(dt_, dj, 0.0, what=f"decompressed, step {k}")
        assert_close(et, ej, 0.0, what=f"error state, step {k}")


# ---------------------------------------------------------------------------
# 2. initialisers and the keyed init
# ---------------------------------------------------------------------------
INITS = {"normal": (lambda m: m.normal(0.02), 0.02),
         "truncated_normal": (lambda m: m.truncated_normal(0.05), 0.05),
         "xavier_uniform": (lambda m: m.xavier_uniform(), 0.0),
         "lecun_normal": (lambda m: m.lecun_normal(), 96 ** -0.5),
         "zeros": (lambda m: m.zeros, 0.0), "ones": (lambda m: m.ones, 0.0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(INITS))
def test_initializers_match_jax(name, dtype):
    make, std = INITS[name]
    shape = (96, 3, 40)
    got = make(tinit)(rng.PRNGKey(7), shape, TDT[dtype])
    want = make(jinit)(jax.random.PRNGKey(7), shape, JDT[dtype])
    assert got.dtype == TDT[dtype] and tuple(got.shape) == shape
    if std == 0.0:             # uniforms and constants: bit for bit
        assert_close(got, want, 0.0, what=name)
    else:
        normals_close(got, want, std, dtype, name)


def test_truncated_normal_matches_jax():
    got = rng.truncated_normal(rng.PRNGKey(1), -2.0, 2.0, (50_000,))
    want = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(1),
                                                  -2.0, 2.0, (50_000,)))
    assert got.dtype == torch.float32
    assert float(got.min()) > -2.0 and float(got.max()) < 2.0
    assert np.abs(got.numpy() - want).max() <= NORMAL_ATOL


def test_embedding_init_matches_jax():
    got = embedding_init(rng.PRNGKey(4), 9, 64)
    want = jembedding_init(jax.random.PRNGKey(4), 9, 64)
    assert_close(got, want, 0.0, NORMAL_ATOL * 0.02, what="embedding")


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("cfg", ["smoke", "tiny_bf16"])
def test_dit_init_from_key_matches_jax(seed, cfg):
    cfg = SMOKE if cfg == "smoke" else dataclasses.replace(
        TINY_CFG, dtype="bfloat16")
    got = dit_init_from_key(rng.PRNGKey(seed), cfg, device=CPU)
    want = jdit_init(jax.random.PRNGKey(seed), jcfg_of(cfg))
    assert np.array_equal(to_np(got["pos"]), to_np(want["pos"]))
    tl, jl = tree_leaves(got), jax.tree.leaves(want)
    assert len(tl) == len(jl) == 22
    for t, j in zip(tl, jl):
        assert t.dtype == cfg.tdtype and tuple(t.shape) == j.shape
        if not np.abs(to_np(j)).max():
            assert np.array_equal(to_np(t), to_np(j))     # the zero leaves
        else:
            normals_close(t, j, 0.02, cfg.dtype, tuple(t.shape))


# ---------------------------------------------------------------------------
# 3. the loss, gradients, a trajectory and the batches
# ---------------------------------------------------------------------------
def batch_np(cfg, B, seed):
    r = np.random.default_rng(seed)
    shape = (B, cfg.img_size, cfg.img_size, cfg.in_ch)
    return {"x0": r.normal(size=shape).astype(np.float32),
            "noise": r.normal(size=shape).astype(np.float32),
            "t": r.integers(0, 1000, size=B).astype(np.int32),
            "y": r.integers(0, cfg.n_classes + 1, size=B).astype(np.int32)}


def batch_t(b):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in b.items()}


def batch_j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def trained():
    with open(os.path.join(ROOT, "experiments", "dit_tiny_200.pkl"),
              "rb") as f:
        return pickle.load(f)


def test_ddpm_loss_matches_jax(trained):
    b = batch_np(TINY_CFG, 8, 30)
    pt = params_from_numpy(trained, device=CPU)
    pj = jax.tree.map(jnp.asarray, trained)
    st, sj = make_schedule(TINY_DIF), jmake_schedule(JDiffusionCfg(T=1000))
    got = ddpm_loss(lambda x, t, y: dit_apply(pt, TINY_CFG, x, t, y), st,
                    torch.from_numpy(b["x0"]), torch.from_numpy(b["t"]).long(),
                    torch.from_numpy(b["y"]).long(), rng.PRNGKey(9))
    want = jax.jit(lambda *a: jddpm_loss(
        lambda x, t, y: jdit_apply(pj, jcfg_of(TINY_CFG), x, t, y), sj,
        *a))(jnp.asarray(b["x0"]), jnp.asarray(b["t"]), jnp.asarray(b["y"]),
             jax.random.PRNGKey(9))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL["train_loss_rel"][0])
    with pytest.raises(ValueError, match="float32"):
        ddpm_loss(None, st, torch.zeros(1, 8, 8, 4, dtype=torch.bfloat16),
                  None, None, rng.PRNGKey(0))


def jax_loss_and_grads(params, cfg, batch, sched):
    def loss_fn(p):
        from repro.diffusion import q_sample
        xt = q_sample(sched, batch["x0"], batch["t"], batch["noise"])
        eps = jdit_apply(p, jcfg_of(cfg), xt, batch["t"], batch["y"])
        return jnp.mean(jnp.square(eps - batch["noise"]))
    return jax.jit(jax.value_and_grad(loss_fn))(params)


@pytest.fixture(scope="module")
def grads_at_trained(trained):
    """One step's loss and gradients at dit_tiny_200.pkl, both packages,
    on one batch of 16."""
    b = batch_np(TINY_CFG, 16, 31)
    lj, gj = jax_loss_and_grads(jax.tree.map(jnp.asarray, trained),
                                TINY_CFG, batch_j(b),
                                jmake_schedule(JDiffusionCfg(T=1000)))
    lt, gt = dit_loss_and_grads(TINY_CFG, make_schedule(TINY_DIF),
                                params_from_numpy(trained, device=CPU),
                                batch_t(b))
    return lt, gt, lj, gj


def test_grads_at_trained_point_match_jax(grads_at_trained):
    lt, gt, lj, gj = grads_at_trained
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                               rtol=TOL["train_loss_rel"][0])
    rel = TOL["train_grads_rel"][0]
    worst = 0.0
    for t, j in zip(tree_leaves(gt), jax.tree.leaves(gj)):
        t, j = t.numpy(), np.asarray(j)
        assert t.shape == j.shape
        scale = np.abs(j).max()
        assert scale > 0           # every leaf, pos included, has gradient
        worst = max(worst, np.abs(t - j).max() / scale)
    assert worst <= rel, worst


def test_adamw_on_jax_grads_matches_jax(trained, grads_at_trained):
    """The port's AdamW fed JAX's own gradients at the trained point: the
    update differs from JAX's by the optimizer's arithmetic alone."""
    gj = grads_at_trained[3]
    gt = params_from_numpy(jax.tree.map(np.array, gj), device=CPU)
    pt = params_from_numpy(trained, device=CPU)
    pj = jax.tree.map(jnp.asarray, trained)
    opt_t = pick_optimizer_dit(TINY_CFG)[0]
    opt_j = jopt.adamw(jopt.cosine_schedule(1e-4, 1000, 400_000))
    st, sj = opt_t.init(pt), opt_j.init(pj)
    jupdate = jax.jit(opt_j.update)
    for k in range(3):
        with torch.no_grad():
            ut, st = opt_t.update(gt, st, pt)
        uj, sj = jupdate(gj, sj, pj)
        assert_close(ut, uj, OPT_RTOL, what=f"updates, step {k}")
        assert_close({"mu": st["mu"], "nu": st["nu"]},
                     {"mu": sj["mu"], "nu": sj["nu"]}, OPT_RTOL,
                     what=f"moments, step {k}")


def test_loss_trajectory_matches_jax():
    """5 steps of make_dit_train_step from the same numpy init (the smoke
    config's keyed init, its zero adaLN perturbed so every leaf learns)
    and the same numpy batches."""
    init = to_np(dit_init_from_key(rng.PRNGKey(2), SMOKE, device=CPU))
    r = np.random.default_rng(8)
    init = {k: (tree_map(lambda a: a + r.normal(size=a.shape).astype(
        np.float32) * 0.02, v) if k in ("blocks", "final", "final_ada")
        else v) for k, v in init.items()}
    opt_args = (2e-3, 2, 5)
    ot = topt.adamw(topt.cosine_schedule(*opt_args), weight_decay=0.01)
    oj = jopt.adamw(jopt.cosine_schedule(*opt_args), weight_decay=0.01)
    step_t = make_dit_train_step(SMOKE, ot, make_schedule(DiffusionCfg()))
    step_j = jax.jit(jmake_step(jcfg_of(SMOKE), oj,
                                jmake_schedule(JDiffusionCfg(T=1000))))
    pt, pj = params_from_numpy(init, device=CPU), \
        jax.tree.map(jnp.asarray, init)
    st, sj = ot.init(pt), oj.init(pj)
    lt_all, lj_all = [], []
    for k in range(5):
        b = batch_np(SMOKE, 8, 40 + k)
        lt, pt, st = step_t(pt, st, batch_t(b))
        lj, pj, sj = step_j(pj, sj, batch_j(b))
        lt_all.append(float(lt))
        lj_all.append(float(lj))
    np.testing.assert_allclose(lt_all, lj_all,
                               rtol=TOL["train_loss_traj_rel"][0])


def test_batches_follow_the_reference_key_stream():
    """Three steps of the launcher's draws: labels and timesteps bit for
    bit, latents within eval_latents_atol, noise within normal_atol."""
    pipe_t = LatentPipeline(8, 4, 8, seed=3)
    pipe_j = JLatentPipeline(8, 4, 8, seed=3)
    @jax.jit
    def jax_batch(kj):       # repro/launch/train.py's draws
        kj, k1, k2, k3 = jax.random.split(kj, 4)
        x0, y = pipe_j.sample(16, k1)
        return kj, {"x0": x0, "y": y,
                    "t": jax.random.randint(k2, (16,), 0, 1000),
                    "noise": jax.random.normal(k3, x0.shape)}
    kt, kj = rng.PRNGKey(3), jax.random.PRNGKey(3)
    for _ in range(3):
        kt, bt = tlaunch_train.batch_at(pipe_t, kt, 16)
        kj, bj = jax_batch(kj)
        assert np.array_equal(kt.numpy(), np.asarray(
            jax.random.key_data(kj)).astype(np.int64))
        for k in ("y", "t"):
            assert np.array_equal(bt[k].numpy(), np.asarray(bj[k]))
        assert np.abs(bt["x0"].numpy() - np.asarray(bj["x0"])).max() \
            <= TOL["eval_latents_atol"][0]
        assert np.abs(bt["noise"].numpy() - np.asarray(bj["noise"])).max() \
            <= NORMAL_ATOL


def test_remat_equals_no_remat_bit_for_bit(trained):
    b = batch_t(batch_np(TINY_CFG, 4, 50))
    sched = make_schedule(TINY_DIF)
    pt = params_from_numpy(trained, device=CPU)
    l0, g0 = dit_loss_and_grads(TINY_CFG, sched, pt, b)
    l1, g1 = dit_loss_and_grads(dataclasses.replace(TINY_CFG, remat=True),
                                sched, pt, b)
    assert torch.equal(l0, l1)
    for a, c in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# 4. the launcher, checkpoints across the packages, autotune's tiny recipe
# ---------------------------------------------------------------------------
TRAIN_ARGV = ["--arch", "dit-xl-2", "--smoke", "--device", CPU, "--steps",
              "6", "--batch", "4", "--ckpt_every", "3", "--log_every", "1"]


def final_leaves(path):
    return ckpt.restore(path, 6)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("uninterrupted"))
    tlaunch_train.main(TRAIN_ARGV + ["--ckpt_dir", d])
    return d


def interrupt_at_3(d):
    """The state a crash after the step-3 save leaves: steps 3 and 6
    were saved, step 6 is gone (``latest`` names a missing step)."""
    import shutil
    shutil.rmtree(os.path.join(d, "step_00000006"))
    assert ckpt.latest_step(d) == 3


def test_resumed_run_equals_uninterrupted(tmp_path, uninterrupted, capsys):
    d = str(tmp_path / "ck")
    tlaunch_train.main(TRAIN_ARGV + ["--ckpt_dir", d])
    interrupt_at_3(d)
    capsys.readouterr()
    tlaunch_train.main(TRAIN_ARGV + ["--ckpt_dir", d])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "step     3 loss" in out
    assert "step     0 loss" not in out
    for a, b in zip(final_leaves(d), final_leaves(uninterrupted)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def jax_like(seed=0):
    jp = jdit_init(jax.random.PRNGKey(seed), jcfg_of(SMOKE))
    return {"params": jp, "opt": jopt.adamw(1e-3).init(jp)}


def test_port_checkpoint_restores_in_jax(uninterrupted):
    """The port's {"params", "opt"} at step 6 restores in the reference's
    ``restore(path, like)`` leaf for leaf, bit for bit."""
    leaves = final_leaves(uninterrupted)
    restored = jckpt.restore(uninterrupted, jax_like(), step=6)
    jl = jax.tree.leaves(restored)
    assert len(jl) == len(leaves)
    for a, b in zip(jl, leaves):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), b)
    assert int(restored["opt"]["step"]) == 6


def test_jax_checkpoint_resumes_in_port_launcher(tmp_path, uninterrupted,
                                                 capsys):
    """The port's step-3 state saved by the reference's ``ckpt.save``
    (as JAX arrays); the port's launcher resumes it to the uninterrupted
    run's final state bit for bit."""
    src = str(tmp_path / "port")
    tlaunch_train.main(TRAIN_ARGV + ["--ckpt_dir", src])
    interrupt_at_3(src)
    like = jax_like()
    state3 = jckpt.restore(src, like, step=3)
    dst = str(tmp_path / "jax")
    jckpt.save(dst, 3, state3)
    capsys.readouterr()
    tlaunch_train.main(TRAIN_ARGV + ["--ckpt_dir", dst])
    assert "resumed from step 3" in capsys.readouterr().out
    for a, b in zip(final_leaves(dst), final_leaves(uninterrupted)):
        assert np.array_equal(a, b)


def test_unflatten_inverts_flatten():
    params = dit_init_from_key(rng.PRNGKey(0), SMOKE, device=CPU)
    tree = {"params": params, "opt": topt.adamw(1e-3).init(params),
            "extra": [torch.zeros(2), (torch.ones(1), None)]}
    leaves = ckpt.flatten(tree)
    back = ckpt.unflatten(tree, leaves)
    assert all(a is b for a, b in zip(ckpt.flatten(back), leaves))
    assert list(back) == list(tree) and list(back["params"]) == list(params)
    assert back["extra"][1][1] is None and isinstance(back["extra"][1], tuple)
    assert len(leaves) == len(jax.tree.leaves(jax_like())) + 2
    with pytest.raises(ValueError, match="leaf count"):
        ckpt.unflatten(tree, leaves[:-1])


def test_entry_points_default_to_cuda():
    """Without a device the keyed init, the launcher and the tiny recipe
    ask for the card, and raise where there is none."""
    if torch.cuda.is_available():
        return
    for call in (lambda: dit_init_from_key(rng.PRNGKey(0), SMOKE),
                 lambda: tlaunch_train.main(["--arch", "dit-xl-2",
                                             "--smoke", "--steps", "1"]),
                 lambda: tlaunch_autotune.train_tiny(1, None)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


@pytest.mark.parametrize("argv,match", [
    (["--arch", "qwen3-1.7b"], "item 8"),
    (["--arch", "dit-xl-2", "--grad_accum", "2"], "item 8"),
    (["--arch", "dit-xl-2", "--data_mesh", "2"], "item 9"),
    (["--arch", "dit-xl-2", "--model_mesh", "2"], "item 9"),
    (["--arch", "dit-xl-2", "--ckpt_dir", "unused"], "queue 3"),
])
def test_launcher_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        tlaunch_train.main(argv + ["--device", CPU])


def test_tiny_recipe_matches_reference(tmp_path, capsys):
    """autotune's tiny recipe for 3 steps against the reference's
    ``tiny_dit(3, dir)``: the printed losses of steps 0 and 2 (4
    decimals), and the cached params within the Adam step budget."""
    jcfg, _, jparams = jlaunch_autotune.tiny_dit(3, str(tmp_path / "j"))
    printed = [l for l in capsys.readouterr().out.splitlines()
               if "[tiny-train]" in l]
    jl = [float(l.split("loss ")[1].split()[0]) for l in printed]
    params, losses = tlaunch_autotune.train_tiny(3, torch.device(CPU))
    assert losses.shape == (3,)
    np.testing.assert_allclose(losses[[0, 2]].numpy(), jl, rtol=0,
                               atol=5e-5 + TOL["train_loss_traj_rel"][0])
    assert jcfg == jcfg_of(TINY_CFG)
    lr_max = 2e-3 * 3 / 20
    budget = TOL["train_param_flip_rate"][0]
    for t, j in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        diff = np.abs(t.numpy() - np.asarray(j))
        assert (diff > 1e-6).mean() <= budget and diff.max() <= 6 * lr_max
