"""Read side of the reference's npz-shard checkpoints — port of the parts
of ``repro/checkpoint/ckpt.py`` that ``QuantArtifact.load`` calls, plus
``content_hash``. numpy and json only.

Layout: ``<dir>/step_XXXXXXXX/{manifest.json, shard_XXXXX.npz,
_COMMITTED}`` and ``<dir>/latest``.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, List, Optional

import numpy as np
import torch


def flatten(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree.flatten`` order (dict keys sorted; list and
    tuple in order; None is an empty subtree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in flatten(v)]
    return [tree]


def _leaf_bytes(leaf):
    """(dtype name, shape, raw bytes) of one leaf, as numpy sees it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), t.view(torch.int16).numpy().tobytes()
        a = t.numpy()
    else:
        a = np.ascontiguousarray(np.asarray(leaf))
    return str(a.dtype), tuple(a.shape), a.tobytes()


def content_hash(tree: Any) -> dict:
    """Per-leaf sha256[:16] over (dtype, shape, raw bytes) in flatten
    order plus one combined digest — equal to the reference's hash of the
    same tree."""
    flat = flatten(tree)
    leaves = []
    combined = hashlib.sha256()
    for leaf in flat:
        dt, shape, raw = _leaf_bytes(leaf)
        h = hashlib.sha256()
        h.update(dt.encode())
        h.update(str(shape).encode())
        h.update(raw)
        leaves.append(h.hexdigest()[:16])
        combined.update(h.digest())
    return {"n_leaves": len(flat), "leaves": leaves,
            "digest": combined.hexdigest()[:16]}


def latest_step(path: str) -> Optional[int]:
    try:
        with open(os.path.join(path, "latest")) as f:
            name = f.read().strip()
        if os.path.exists(os.path.join(path, name, "_COMMITTED")):
            return int(name.split("_")[1])
    except (FileNotFoundError, ValueError, IndexError):
        pass
    best = None
    if os.path.isdir(path):
        for d in os.listdir(path):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(path, d, "_COMMITTED")):
                s = int(d.split("_")[1])
                best = s if best is None else max(best, s)
    return best


def _manifest(path: str, step: int) -> dict:
    with open(os.path.join(path, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def verify_shards(path: str, step: Optional[int] = None) -> None:
    """Check every shard against the manifest's sha256[:16]; raises
    ``ValueError`` (naming the shard) on corruption."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    manifest = _manifest(path, step)
    for si_name in sorted(manifest["hashes"]):
        fn = os.path.join(d, si_name)
        if not os.path.exists(fn):
            raise FileNotFoundError(
                f"checkpoint shard {fn} is missing (manifest lists it)")
        with open(fn, "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()[:16]
        if got != manifest["hashes"][si_name]:
            raise ValueError(f"checkpoint shard {fn} is corrupted: content "
                             f"hash {got} != manifest "
                             f"{manifest['hashes'][si_name]}")


def restore(path: str, step: Optional[int] = None) -> List[np.ndarray]:
    """The flat leaf list of a committed checkpoint (numpy arrays, shapes
    and dtypes checked against the manifest)."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    manifest = _manifest(path, step)
    cache, out = {}, []
    for i in range(manifest["n_leaves"]):
        si = manifest["index"][str(i)]
        if si not in cache:
            cache[si] = np.load(os.path.join(d, f"shard_{si:05d}.npz"))
        a = cache[si][f"leaf_{i}"]
        if list(a.shape) != list(manifest["shapes"][i]) \
                or str(a.dtype) != manifest["dtypes"][i]:
            raise ValueError(f"leaf {i}: stored {a.dtype}{a.shape} vs "
                             f"manifest {manifest['dtypes'][i]}"
                             f"{manifest['shapes'][i]}")
        out.append(a)
    return out
