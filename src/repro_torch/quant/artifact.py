"""`QuantArtifact` — calibrated quantization state, saved and loaded.

Port of ``repro/quant/artifact.py``. The on-disk format is the
reference's, so either package reads what the other writes::

    <path>/artifact.json        # version, recipe, meta, structure spec,
                                # the leaf shards' hashes
    <path>/step_00000000/       # array leaves (checkpoint/ckpt.py)
        manifest.json, shard_00000.npz, _COMMITTED
    <path>/latest

``save`` encodes the qparams tree into a JSON spec (quantizer containers
by class name, Python scalars inline, tensors as indexed leaves in
numpy's dtypes) and commits the leaves first, then ``artifact.json``;
``load`` refuses a json whose recorded shard hashes do not match the
committed leaves (an overwrite torn between the two writes). Loaded
leaves are torch tensors on the requested device, so a deployment
calibrates once and cold-starts from disk.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.quantizers import (
    ChannelQ, MRQSignedQ, MRQSoftmaxQ, SymQ, TGQ, UniformQ,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import LINEAR_PACKS
from repro_torch.quant.recipe import QuantRecipe

ARTIFACT_VERSION = 1
_ARTIFACT_JSON = "artifact.json"
_QUANTIZERS = {c.__name__: c for c in
               (UniformQ, SymQ, ChannelQ, MRQSoftmaxQ, MRQSignedQ, TGQ)}


def _encode(obj: Any, leaves: List[np.ndarray], where: str = "") -> dict:
    """The JSON spec of ``obj``, appending its array leaves to
    ``leaves`` (the reference's encoding, node for node)."""
    if obj is None:
        return {"k": "none"}
    if isinstance(obj, bool) or isinstance(obj, (int, float, str)) and \
            not isinstance(obj, np.generic):
        return {"k": "py", "v": obj}
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("artifact dicts must be str-keyed")
        return {"k": "dict", "items": {k: _encode(v, leaves, f"{where}/{k}")
                                       for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"k": "tuple" if isinstance(obj, tuple) else "list",
                "items": [_encode(v, leaves, f"{where}[{i}]")
                          for i, v in enumerate(obj)]}
    if type(obj).__name__ in _QUANTIZERS and dataclasses.is_dataclass(obj):
        return {"k": "q", "cls": type(obj).__name__,
                "fields": {f.name: _encode(getattr(obj, f.name), leaves,
                                           f"{where}.{f.name}")
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
        try:
            leaves.append(ckpt.to_numpy(obj))
        except TypeError as e:
            raise TypeError(f"artifact leaf {where or '/'}: {e}") from None
        return {"k": "arr", "i": len(leaves) - 1}
    raise TypeError(f"cannot serialize {type(obj).__name__} into a "
                    "QuantArtifact (supported: dict/list/tuple, scalars, "
                    f"tensors, arrays, {sorted(_QUANTIZERS)})")


def _decode(spec: dict, leaves: List[Any]) -> Any:
    k = spec["k"]
    if k == "none":
        return None
    if k == "py":
        return spec["v"]
    if k == "dict":
        return {key: _decode(s, leaves) for key, s in spec["items"].items()}
    if k in ("list", "tuple"):
        seq = [_decode(s, leaves) for s in spec["items"]]
        return tuple(seq) if k == "tuple" else seq
    if k == "q":
        cls = _QUANTIZERS[spec["cls"]]
        return cls(**{n: _decode(s, leaves)
                      for n, s in spec["fields"].items()})
    if k == "arr":
        return leaves[spec["i"]]
    raise ValueError(f"unknown artifact spec node kind {k!r}")


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A leaf as a tensor of its own shape (``np.ascontiguousarray``
    would give a 0-d leaf the shape (1,))."""
    return torch.from_numpy(np.array(a, order="C")).to(device)


@dataclasses.dataclass
class QuantArtifact:
    """qparams + recipe + provenance metadata."""
    qparams: Dict[str, dict]
    recipe: QuantRecipe
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def has_kernel_packs(self) -> bool:
        keys = [k for k, _, _ in LINEAR_PACKS] + ["int8_qk", "int8_pv"]
        return any(any(k in qp for k in keys)
                   for qp in self.qparams.values())

    def fallback_ops(self) -> List[str]:
        """Quantized matmul ops whose qparams carry NO kernel pack (they
        would take the fake-quant path under ``context(kernel=True)``)."""
        out: List[str] = []
        for name in sorted(self.qparams):
            qp = self.qparams[name]
            if name.endswith("/qk"):
                if "int8_qk" not in qp:
                    out.append(name)
            elif name.endswith("/pv"):
                if "int8_pv" not in qp:
                    out.append(name)
            elif "w" in qp and not any(k in qp for k, _, _ in LINEAR_PACKS):
                out.append(name)
        return out

    def packed_counts(self, attn_impl: Optional[str] = None
                      ) -> Dict[str, int]:
        """Ops packed per serving kernel, keyed as ``kernels.LAUNCHES``
        (one launch each per forward): a linear counts under its pack's
        kernel; an attention block under ``flash_attn_mrq`` or, at 4 bits,
        ``flash_attn_mrq_packed_kv`` — or, under ``attn_impl`` 'composed'
        (None: the recipe's), once under each of ``int8_bmm_qk``,
        ``softmax_mrq_codes`` and ``int8_bmm_pv``."""
        counts = {kern: sum(key in qp for qp in self.qparams.values())
                  for key, _, kern in LINEAR_PACKS}
        qk = [qp["int8_qk"] for qp in self.qparams.values() if "int8_qk" in qp]
        if (attn_impl or self.recipe.attn_impl) == "composed":
            for kern in ("int8_bmm_qk", "softmax_mrq_codes", "int8_bmm_pv"):
                counts[kern] = len(qk)
            return counts
        packed = sum(int(p.get("bits", 8)) == 4 for p in qk)
        counts["flash_attn_mrq"] = len(qk) - packed
        counts["flash_attn_mrq_packed_kv"] = packed
        return counts

    def context(self, kernel: Optional[bool] = None,
                attn_impl: Optional[str] = None):
        """The op context serving this artifact (kernels when packs exist
        unless ``kernel=False``)."""
        from repro_torch.core.contexts import QuantContext
        if kernel is None:
            kernel = self.has_kernel_packs
        if kernel and not self.has_kernel_packs:
            raise ValueError(
                f"artifact has no kernel packs (recipe {self.recipe.bits}/"
                f"{self.recipe.method}); serve it with kernel=False")
        return QuantContext(qparams=self.qparams, kernel=kernel,
                            attn_impl=attn_impl or self.recipe.attn_impl)

    @property
    def params_hash(self) -> Optional[dict]:
        return self.meta.get("params_hash")

    def check_params(self, params) -> None:
        """Fail fast if ``params`` is not the fp tree this artifact was
        calibrated against."""
        want = self.params_hash
        if want is None:
            return
        got = ckpt.content_hash(params)
        if got["digest"] == want["digest"]:
            return
        if got["n_leaves"] != want["n_leaves"]:
            raise ValueError(
                f"params mismatch: artifact was calibrated against a tree "
                f"with {want['n_leaves']} leaves, got {got['n_leaves']}")
        n_bad = sum(a != b for a, b in zip(got["leaves"], want["leaves"]))
        raise ValueError(
            f"params content hash mismatch: {n_bad}/{want['n_leaves']} "
            f"leaves differ (digest {got['digest']} != {want['digest']})")

    def model_cfg(self):
        m = self.meta.get("model") or {}
        if m.get("class") != "DiTCfg":
            raise ValueError(f"artifact has no DiTCfg metadata (model = "
                             f"{m.get('class')!r})")
        from repro_torch.models.dit import DiTCfg
        return DiTCfg(**m["cfg"])

    def dif_cfg(self):
        if "dif" not in self.meta:
            raise ValueError("artifact has no DiffusionCfg metadata")
        from repro_torch.diffusion.ddpm import DiffusionCfg
        return DiffusionCfg(**self.meta["dif"])

    def summary(self) -> str:
        c = self.packed_counts("flash")
        return (f"QuantArtifact({self.recipe.bits}/{self.recipe.method}: "
                f"{len(self.qparams)} ops, "
                f"{c['int8_matmul_fq'] + c['int8_matmul_mrq_fq']} int8 and "
                f"{c['int4_matmul_fq'] + c['int4_matmul_mrq_fq']} int4 "
                f"linear packs, {c['flash_attn_mrq']} int8 and "
                f"{c['flash_attn_mrq_packed_kv']} packed-kv attention "
                f"blocks, G={self.meta.get('tgq_groups')})")

    def save(self, path: str) -> str:
        """Save under ``path`` (a directory); returns ``path``. The leaf
        shards commit first, then ``artifact.json`` replaces atomically,
        recording the shards' hashes (see the module docstring)."""
        leaves: List[np.ndarray] = []
        spec = _encode(self.qparams, leaves)
        os.makedirs(path, exist_ok=True)
        step_dir = ckpt.save(path, step=0, tree=leaves, keep=1)
        with open(os.path.join(step_dir, "manifest.json")) as f:
            leaf_hashes = json.load(f)["hashes"]
        doc = {
            "version": ARTIFACT_VERSION,
            "recipe": self.recipe.to_dict(),
            "meta": self.meta,
            "n_leaves": len(leaves),
            "leaf_hashes": leaf_hashes,
            "spec": spec,
        }
        tmp = os.path.join(path, _ARTIFACT_JSON + ".tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, os.path.join(path, _ARTIFACT_JSON))
        return path

    @classmethod
    def load(cls, path: str, expect_recipe: Optional[QuantRecipe] = None,
             params=None, device=None) -> "QuantArtifact":
        """Load from ``path`` onto ``device`` (default ``"cuda"``), with
        the reference's guards: format version, recipe mismatch, json vs
        shard consistency, shard integrity, and (with ``params``) the fp
        tree's content hash."""
        dev = resolve_device(device)
        doc_path = os.path.join(path, _ARTIFACT_JSON)
        if not os.path.exists(doc_path):
            raise FileNotFoundError(f"no quantization artifact at {path} "
                                    f"(missing {_ARTIFACT_JSON})")
        with open(doc_path) as f:
            doc = json.load(f)
        if doc.get("version") != ARTIFACT_VERSION:
            raise ValueError(f"artifact version {doc.get('version')} != "
                             f"supported {ARTIFACT_VERSION}")
        recipe = QuantRecipe.from_dict(doc["recipe"])
        if expect_recipe is not None and expect_recipe != recipe:
            raise ValueError("artifact recipe mismatch: " + "; ".join(
                f"{k}: artifact={a!r} expected={b!r}"
                for k, (a, b) in recipe.diff(expect_recipe).items()))
        step = ckpt.latest_step(path)
        if step is None:
            raise FileNotFoundError(f"artifact at {path} has no committed "
                                    "leaf checkpoint")
        with open(os.path.join(path, f"step_{step:08d}",
                               "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["hashes"] != doc["leaf_hashes"]:
            raise ValueError(f"artifact at {path} is inconsistent: "
                             "artifact.json does not match the committed "
                             "leaf checkpoint — re-save the artifact")
        if manifest["n_leaves"] != doc["n_leaves"]:
            raise ValueError(f"leaf count drift at {path}")
        ckpt.verify_shards(path, step=step)
        leaves = [_to_tensor(a, dev) for a in ckpt.restore(path, step=step)]
        art = cls(qparams=_decode(doc["spec"], leaves), recipe=recipe,
                  meta=doc["meta"])
        if params is not None:
            art.check_params(params)
        return art
