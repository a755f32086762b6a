"""The reference's npz-shard checkpoints — port of
``repro/checkpoint/ckpt.py``: atomic saves with a manifest, the latest
pointer, keep-K retention, background saves, shard verification and
restore, plus ``content_hash``. numpy and json only.

Layout: ``<dir>/step_XXXXXXXX/{manifest.json, shard_XXXXX.npz,
_COMMITTED}`` and ``<dir>/latest``. A step is written under
``step_XXXXXXXX.tmp`` and renamed once ``_COMMITTED`` is in it, so a
crash leaves either the old step or the new one. The manifest's
``treedef`` is null: the reference's ``restore`` rebuilds a tree from the
manifest's shapes and dtypes, and the port's returns the flat leaves
(``unflatten(like, leaves)`` puts them back into a tree).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core.quantizers import ARRAY_FIELDS, TGQ

_SHARD_BYTES = 512 * 1024 * 1024


def flatten(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree.flatten`` order (dict keys sorted; list and
    tuple in order; None is an empty subtree; a quantizer container's
    array fields in declaration order, ``TGQ`` through its ``inner``, as
    the reference registers them)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in flatten(v)]
    if isinstance(tree, TGQ):
        return flatten(tree.inner)
    if dataclasses.is_dataclass(tree) and type(tree) in ARRAY_FIELDS:
        return [l for f in ARRAY_FIELDS[type(tree)]
                for l in flatten(getattr(tree, f))]
    return [tree]


def unflatten(like: Any, leaves: List[Any]) -> Any:
    """The inverse of ``flatten`` on a tree of dicts, lists and tuples:
    ``like``'s structure holding ``leaves`` in ``jax.tree.flatten``
    order (dict keys sorted; ``like``'s own key order kept)."""
    n = len(flatten(like))
    if n != len(leaves):
        raise ValueError(f"leaf count mismatch: {len(leaves)} leaves for a "
                         f"tree of {n}")
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def to_numpy(leaf) -> np.ndarray:
    """One leaf as the numpy array a shard stores. bf16 has no numpy
    dtype that ``np.load`` gives back (it loads as ``|V2``, which neither
    package's reader accepts), so a bf16 leaf raises ``TypeError``."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"cannot write a bfloat16 leaf of shape "
                            f"{tuple(leaf.shape)}: it would load back as "
                            "|V2; cast it to float32 first")
        return leaf.detach().cpu().contiguous().numpy()
    a = np.asarray(leaf)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        raise TypeError(f"cannot write a {a.dtype} leaf of shape {a.shape}")
    return a


def _leaf_bytes(leaf):
    """(dtype name, shape, raw bytes) of one leaf, as the reference's
    ``np.ascontiguousarray`` sees it (a 0-d leaf hashes as shape (1,))."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return ("bfloat16", tuple(t.shape) or (1,),
                    t.view(torch.int16).numpy().tobytes())
        leaf = t.numpy()
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


def save(path: str, step: int, tree: Any, keep: int = 3,
         shard_bytes: int = _SHARD_BYTES) -> str:
    """Synchronous atomic save of ``tree``'s leaves (``flatten`` order).
    Returns the step directory."""
    name = f"step_{step:08d}"
    final = os.path.join(path, name)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = [to_numpy(l) for l in flatten(tree)]

    shards, cur, cur_bytes, index = [], {}, 0, {}
    for i, a in enumerate(arrays):
        if cur_bytes + a.nbytes > shard_bytes and cur:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[f"leaf_{i}"] = a
        index[str(i)] = len(shards)
        cur_bytes += a.nbytes
    shards.append(cur)

    hashes = {}
    for si, sh in enumerate(shards):
        fn = os.path.join(tmp, f"shard_{si:05d}.npz")
        np.savez(fn, **sh)
        with open(fn, "rb") as f:
            hashes[f"shard_{si:05d}.npz"] = hashlib.sha256(
                f.read()).hexdigest()[:16]

    manifest = {
        "step": step,
        "n_leaves": len(arrays),
        "index": index,
        "treedef": None,
        "hashes": hashes,
        "dtypes": [str(a.dtype) for a in arrays],
        "shapes": [list(a.shape) for a in arrays],
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    with open(os.path.join(path, "latest.tmp"), "w") as f:
        f.write(name)
    os.replace(os.path.join(path, "latest.tmp"), os.path.join(path, "latest"))
    _retain(path, keep)
    return final


_ASYNC_THREAD: Optional[threading.Thread] = None


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return tree if tree is None else np.array(to_numpy(tree))  # a copy


def save_async(path: str, step: int, tree: Any, keep: int = 3) -> None:
    """Background-thread save. Waits for a save still running (one at a
    time), copies the tensors to the host now, then returns while a
    thread writes them."""
    global _ASYNC_THREAD
    wait_async()
    host = _host_tree(tree)
    _ASYNC_THREAD = threading.Thread(target=save, args=(path, step, host,
                                                        keep), daemon=True)
    _ASYNC_THREAD.start()


def wait_async() -> None:
    if _ASYNC_THREAD is not None and _ASYNC_THREAD.is_alive():
        _ASYNC_THREAD.join()


def _retain(path: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(path)
                   if d.startswith("step_") and os.path.exists(
                       os.path.join(path, d, "_COMMITTED")))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)


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
