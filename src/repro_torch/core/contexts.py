"""Op contexts of the PTQ engine — port of ``repro/core/contexts.py``.

- ``RecordingContext``   — one fp forward; discovers every quantizable op,
  its shapes and input provenance (post-softmax / post-GELU marks).
- ``CalibrationContext`` — fp forwards over the calibration set; stores
  (row-subsampled) operand tensors per op, tagged with the TGQ group.
- ``TapContext`` / ``ShapeContext`` — the Fisher taps of the HO search:
  a zero tensor added to every op's output, whose gradient
  (``torch.autograd.grad``) is dL/dz; and the pass that records the
  outputs' shapes to size the taps (``core/fisher.py``).
- ``QuantContext``       — applies the calibrated quantizers: fake-quant
  by default, or (``kernel=True``) the packed linears through the CUDA
  kernels B1/B2 (8 and 6 bits) and B4/B5 (4 bits), and whole attention
  blocks through B3 (B3b at 4 bits). Its ``tgroup`` is a scalar TGQ
  group, or a per-slot (B,) device tensor from the continuous-batching
  sampler: then every seam (``linear``, ``einsum``, ``act``,
  ``attention``) takes each slot's own group — the ``*_vec`` kernels
  B6a/B6b/B7a/B7b/B8 with kernels, a per-slot gather of the quantizer
  leaves without.

Provenance uses tensor identity: ``act(name, x, kind)`` marks ``id(x)`` so
the directly consuming matmul knows its operand's distribution.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.quantizers import apply_quantizer
from repro_torch.nn.ctx import OpContext, apply_gate_residual, apply_norm_mod


@dataclasses.dataclass
class OpInfo:
    name: str
    kind: str                    # 'linear' | 'einsum'
    spec: Optional[str] = None
    b_is_weight: bool = False
    a_kind: str = "plain"        # 'plain' | 'post_softmax' | 'post_gelu' | 'post_silu'
    x_shape: tuple = ()
    w_shape: tuple = ()
    out_shape: tuple = ()
    n_calls: int = 0


@dataclasses.dataclass
class RecordingContext(OpContext):
    """Discovers the op graph. Execution is full-precision.

    A mark holds its tensor as well as its ``id``: once a marked tensor
    is freed, CPython may hand its ``id`` to a later, unrelated tensor,
    which would then inherit the mark (the reference keys on the bare
    ``id`` and can label a plain linear post-GELU this way)."""
    registry: Dict[str, OpInfo] = dataclasses.field(default_factory=dict)
    acts: Dict[str, str] = dataclasses.field(default_factory=dict)
    _marks: Dict[int, tuple] = dataclasses.field(default_factory=dict)

    def _kind(self, x) -> str:
        kind, t = self._marks.get(id(x), ("plain", None))
        return kind if t is x else "plain"

    def _reg(self, name, **kw):
        if name in self.registry:
            self.registry[name].n_calls += 1
            return self.registry[name]
        info = OpInfo(name=name, **kw)
        info.n_calls = 1
        self.registry[name] = info
        return info

    def linear(self, name, x, w, b=None, norm_mod=None, gate_residual=None):
        a_kind = self._kind(x)
        x = apply_norm_mod(x, norm_mod)
        self._reg(name, kind="linear", a_kind=a_kind,
                  x_shape=tuple(x.shape), w_shape=tuple(w.shape))
        y = x @ w
        if b is not None:
            y = y + b
        self.registry[name].out_shape = tuple(y.shape)
        return apply_gate_residual(y, gate_residual)

    def einsum(self, name, spec, a, b, b_is_weight=False):
        self._reg(name, kind="einsum", spec=spec, b_is_weight=b_is_weight,
                  a_kind=self._kind(a),
                  x_shape=tuple(a.shape), w_shape=tuple(b.shape))
        y = torch.einsum(spec, a, b)
        self.registry[name].out_shape = tuple(y.shape)
        return y

    def act(self, name, x, kind):
        self._marks[id(x)] = (kind, x)
        self.acts[name] = kind
        return x


def stable_seed(name: str, base: int = 0) -> int:
    """Deterministic per-op seed (crc32, as the reference)."""
    return base + (zlib.crc32(name.encode()) & 0xFFFF)


def _host(x) -> np.ndarray:
    """Tensor -> numpy (bf16 widened to f32: the same values)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _subsample_rows(x, max_rows, seed):
    """Flatten leading dims to rows and subsample with numpy's
    ``default_rng(seed)`` — the reference's exact draw."""
    rows = _host(x)
    rows = rows.reshape(-1, rows.shape[-1])
    if rows.shape[0] > max_rows:
        rng = np.random.default_rng(seed)
        idx = rng.choice(rows.shape[0], max_rows, replace=False)
        rows = rows[idx]
    return rows


@dataclasses.dataclass
class CalibrationContext(OpContext):
    """Stores calibration tensors per op (see the module docstring).

    store[name] = list per batch: linear {'x': rows, 'tg': int};
    einsum {'a': array, 'b': array (unless b_is_weight), 'tg': int}.
    Weights are captured once in ``weights[name]`` (numpy, f32 for bf16).
    ``act_store[name]`` holds the rows of the act hooks in ``hook_acts``
    (quantized at the hook, not at a consuming matmul).
    """
    registry: Dict[str, OpInfo] = dataclasses.field(default_factory=dict)
    store: Dict[str, List[dict]] = dataclasses.field(default_factory=dict)
    act_store: Dict[str, List[np.ndarray]] = dataclasses.field(
        default_factory=dict)
    hook_acts: frozenset = frozenset()
    weights: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    max_rows_per_batch: int = 256
    max_batch_sub: int = 4
    _seen: set = dataclasses.field(default_factory=set)
    seed: int = 0

    def begin_batch(self):
        self._seen.clear()

    def _tg(self):
        return int(self.tgroup) if self.tgroup is not None else 0

    def linear(self, name, x, w, b=None, norm_mod=None, gate_residual=None):
        x = apply_norm_mod(x, norm_mod)
        if name not in self._seen:
            self._seen.add(name)
            if name not in self.weights:
                self.weights[name] = _host(w)
            rows = _subsample_rows(x, self.max_rows_per_batch,
                                   stable_seed(name, self.seed))
            self.store.setdefault(name, []).append({"x": rows,
                                                    "tg": self._tg()})
        y = x @ w
        if b is not None:
            y = y + b
        return apply_gate_residual(y, gate_residual)

    def einsum(self, name, spec, a, b, b_is_weight=False):
        if name not in self._seen:
            self._seen.add(name)
            sub = slice(0, self.max_batch_sub)
            rec = {"a": _host(a[sub]), "tg": self._tg()}
            if b_is_weight:
                if name not in self.weights:
                    self.weights[name] = _host(b)
            else:
                rec["b"] = _host(b[sub])
            self.store.setdefault(name, []).append(rec)
        return torch.einsum(spec, a, b)

    def act(self, name, x, kind):
        if name in self.hook_acts and name not in self._seen:
            self._seen.add(name)
            self.act_store.setdefault(name, []).append(_subsample_rows(
                x, self.max_rows_per_batch, stable_seed(name, self.seed)))
        return x


@dataclasses.dataclass
class TapContext(OpContext):
    """Adds ``taps[name]`` to every op output; the gradient of the loss
    with respect to a tap is dL/dz of its op. A linear is tapped on its
    pre-gate output (after the norm-modulate, the matmul and the bias,
    before ``gate_residual``): dL/dz is defined on the op's own output.
    Only call sites with the tap's recorded shape are tapped."""
    taps: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def _tap(self, name, y):
        t = self.taps.get(name)
        if t is not None and tuple(t.shape) == tuple(y.shape):
            y = y + t
        return y

    def linear(self, name, x, w, b=None, norm_mod=None, gate_residual=None):
        x = apply_norm_mod(x, norm_mod)
        y = x @ w
        if b is not None:
            y = y + b
        return apply_gate_residual(self._tap(name, y), gate_residual)

    def einsum(self, name, spec, a, b, b_is_weight=False):
        return self._tap(name, torch.einsum(spec, a, b))

    def act(self, name, x, kind):
        return x


@dataclasses.dataclass
class ShapeContext(OpContext):
    """Records each op's OUTPUT (shape, dtype), first call site first."""
    shapes: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    def linear(self, name, x, w, b=None, norm_mod=None, gate_residual=None):
        x = apply_norm_mod(x, norm_mod)
        y = x @ w
        if b is not None:
            y = y + b
        self.shapes.setdefault(name, (tuple(y.shape), y.dtype))
        return apply_gate_residual(y, gate_residual)

    def einsum(self, name, spec, a, b, b_is_weight=False):
        y = torch.einsum(spec, a, b)
        self.shapes.setdefault(name, (tuple(y.shape), y.dtype))
        return y

    def act(self, name, x, kind):
        return x


@dataclasses.dataclass
class QuantContext(OpContext):
    """Applies calibrated quantizers (fake-quant by default).

    ``kernel=True`` routes each linear that carries a pack of
    ``kernels.ops.LINEAR_PACKS`` through that pack's wrapper (``int8`` ->
    B1, ``int8_mrq`` -> B2, ``int4`` -> B4, ``int4_mrq`` -> B5) and
    attention blocks whose ``/qk`` and ``/pv`` qparams carry ``int8_qk`` /
    ``int8_pv`` packs through one flash kernel (``attn_impl`` 'flash':
    B3, B3b at 4 bits) or the composed three-kernel chain ('composed':
    B9a -> B10a -> B9b, the async ladder's middle rung); any other
    ``attn_impl`` raises ``ValueError``. A vector ``tgroup`` reaches the
    ``_vec`` siblings of those kernels. Ops without a pack take the
    fake-quant path (``QuantArtifact.fallback_ops`` lists them)."""
    qparams: Dict[str, dict] = dataclasses.field(default_factory=dict)
    kernel: bool = False
    attn_impl: str = "flash"

    def _q_in(self, qp, x):
        pre = qp.get("x_prescale")
        if pre is not None:
            x = x / pre
        return apply_quantizer(qp.get("x"), x, tgroup=self.tgroup)

    def _q_w(self, qp, w):
        pre = qp.get("x_prescale")
        if pre is not None:
            w = w * pre.reshape((-1,) + (1,) * (w.ndim - 1))
        return apply_quantizer(qp.get("w"), w, tgroup=self.tgroup)

    @staticmethod
    def _fold_out_bias(b, ob, gate_residual):
        """With the gate+residual epilogue fused, the PTQD bias correction
        lands INSIDE the gate (folded into the matmul bias). Returns
        (bias, post_add)."""
        if ob is None or gate_residual is None:
            return b, ob
        return (ob if b is None else b + ob), None

    def linear(self, name, x, w, b=None, norm_mod=None, gate_residual=None):
        qp = self.qparams.get(name)
        if qp is None:
            x = apply_norm_mod(x, norm_mod)
            y = x @ w
            y = y + b if b is not None else y
            return apply_gate_residual(y, gate_residual)
        if self.kernel:
            from repro_torch.kernels import ops as kops
            for key, fn, _ in kops.LINEAR_PACKS:
                if qp.get(key) is not None:
                    bias, ob = self._fold_out_bias(b, qp.get("out_bias"),
                                                   gate_residual)
                    y = getattr(kops, fn)(
                        x, qp[key], bias=bias, tgroup=self.tgroup,
                        norm_mod=norm_mod, gate_residual=gate_residual)
                    return y + ob if ob is not None else y
        x = apply_norm_mod(x, norm_mod)
        x = self._q_in(qp, x)
        w = self._q_w(qp, w)
        dt = torch.promote_types(x.dtype, w.dtype)
        y = x.to(dt) @ w.to(dt)
        if b is not None:
            y = y + b
        ob = qp.get("out_bias")
        y = y + ob if ob is not None else y
        return apply_gate_residual(y, gate_residual)

    def einsum(self, name, spec, a, b, b_is_weight=False):
        qp = self.qparams.get(name)
        if qp is None:
            return torch.einsum(spec, a, b)
        a = self._q_in(qp, a)
        bq = qp.get("w") if b_is_weight else qp.get("b")
        b = apply_quantizer(bq, b, tgroup=self.tgroup)
        dt = torch.promote_types(a.dtype, b.dtype)
        y = torch.einsum(spec, a.to(dt), b.to(dt))
        ob = qp.get("out_bias")
        return y + ob if ob is not None else y

    def attention(self, name, q, k, v, *, mask=None, scale=1.0):
        if self.kernel:
            qk_qp = self.qparams.get(f"{name}/qk") or {}
            pv_qp = self.qparams.get(f"{name}/pv") or {}
            if (qk_qp.get("int8_qk") is not None
                    and pv_qp.get("int8_pv") is not None):
                from repro_torch.kernels import ops as kops
                if self.attn_impl == "flash":
                    return kops.flash_attention(
                        q, k, v, qk_qp["int8_qk"], pv_qp["int8_pv"],
                        mask=mask, scale=scale, tgroup=self.tgroup)
                if self.attn_impl != "composed":
                    raise ValueError(
                        f"QuantContext.attn_impl must be 'flash' or "
                        f"'composed', got {self.attn_impl!r}")
                return kops.int8_attention(
                    q, k, v, qk_qp["int8_qk"], pv_qp["int8_pv"], mask=mask,
                    scale=scale, tgroup=self.tgroup)
        return OpContext.attention(self, name, q, k, v, mask=mask,
                                   scale=scale)

    def act(self, name, x, kind):
        qp = self.qparams.get(name)
        if qp is not None and "act" in qp:
            return apply_quantizer(qp["act"], x, tgroup=self.tgroup)
        return x
