"""Linear layers (port of ``qgemm_tpu/models/linear.py``).

``Linear`` is y = x W + b with W [in, out]. ``QuantizedLinear`` holds
weights quantized offline: int8 with per-column absmax scales (stored
K-major for kernel K1), or with ``bits=4`` int4 with per-(128-row group,
column) scales (packed K-major for kernel K4). Its forward quantizes the
activations per call and runs K1 or K4 on CUDA tensors (their plain
versions on CPU tensors). A ``Linear``'s weight and bias are trainable
parameters; a ``QuantizedLinear`` holds its codes and scales as buffers and
its bias frozen (the quantized product has no gradient).
``outlier_threshold > 0`` adds the LLM.int8()
outlier split: activation dims above the threshold (up to
``outlier_capacity`` of them) bypass the quantized product and multiply
the dequantized weight rows in bf16 (f32 on the CPU).

Tensor parallelism: ``QuantizedLinear.with_tp(mode, mesh)`` returns this
rank's layer, its codes, scales and bias sliced to its shard, whose forward
runs the explicit collectives of ``parallel/tp_ops.py``: ``"column"``
shards N (its output all-gathered, or kept [.., N/p] to feed a row layer),
``"row"`` shards K (its input is the rank's [.., K/p] slice, its f32
partial summed across ranks, the bias added after the sum). A float
``Linear.with_tp`` shards its weight and bias the same way for training
and runs the differentiable collectives of ``parallel/collectives.py``
(Megatron's f on a column layer's input, g after a row layer's product,
a gather whose backward takes the rank's block). A dimension
that does not divide the axis leaves the layer whole and replicated, as
JAX's rule does. Each container of quantized layers states Megatron's
pairing once, as ``TP_PLAN`` (attribute -> mode, gather_output): its
``with_tp`` shards by it (``shard_by_plan``), and the sharding spec and the
sharded checkpoints read each leaf's span from the layer's mode
(``tp_leaf_specs``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from qgemm_tpu_torch.ops.quantize import (QuantizedWeight, QuantizedWeight4,
                                          quantize_weights, quantize_weights_int4,
                                          quantized_matmul_prequant,
                                          quantized_matmul_prequant_outlier,
                                          quantized_matmul_prequant_w4)
from qgemm_tpu_torch.utils.prng import uniform_init


def _trainable(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t)


def _frozen(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


def check_quantize_options(outlier_threshold: float = 0.0,
                           outlier_capacity: int = 32, bits: int = 8) -> None:
    """Weights are int8 or int4: any other width raises."""
    if bits not in (4, 8):
        raise ValueError(f"quantize(bits={bits}): bits must be 8 or 4")


class Linear(nn.Module):
    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = _trainable(w)    # [in_dim, out_dim]
        self.b = _trainable(b)    # [out_dim] or None
        self.tp_mode = "none"     # "none" | "column" | "row"
        self.tp_axis = "model"
        self.gather_output = True
        self.mesh = None

    @classmethod
    def init(cls, generator: torch.Generator, in_dim: int, out_dim: int,
             bias: bool = True, dtype: torch.dtype = torch.float32) -> "Linear":
        """Kaiming-uniform ±1/sqrt(in_dim)."""
        bound = 1.0 / (in_dim ** 0.5)
        w = uniform_init(generator, (in_dim, out_dim), bound, dtype)
        b = uniform_init(generator, (out_dim,), bound, dtype) if bias else None
        return cls(w, b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_mode != "none":
            return self._tp_forward(x)
        y = torch.matmul(x, self.w.to(x.dtype))
        if self.b is not None:
            y = y + self.b
        return y

    def _tp_forward(self, x: torch.Tensor) -> torch.Tensor:
        from qgemm_tpu_torch.parallel import collectives as cl
        mesh, axis = self.mesh, self.tp_axis
        if self.tp_mode == "column":
            # the bias is whole after the gather, this rank's block without it
            y = torch.matmul(cl.copy_to_axis(x, mesh, axis), self.w.to(x.dtype))
            if self.gather_output:
                y = cl.gather_last(y, mesh, axis)
        else:
            y = cl.reduce_over_axis(torch.matmul(x, self.w.to(x.dtype)), mesh, axis)
        return y if self.b is None else y + self.b

    @property
    def leaf_specs(self) -> Dict[str, Tuple]:
        """Each leaf's sharded dimension in this layer's mode."""
        return tp_leaf_specs(self.tp_mode, self.gather_output, bits=None)

    def tp_shardable(self, mode: str, p: int) -> bool:
        """JAX's condition: N % p (column) or K % p (row)."""
        if mode not in ("column", "row"):
            raise ValueError(f"unknown tensor-parallel mode {mode!r}")
        k, n = self.w.shape
        return (n if mode == "column" else k) % p == 0

    def with_tp(self, mode: str, mesh, axis: str = "model",
                gather_output: bool = True) -> "Linear":
        """This rank's shard of the layer for training (see the module
        note): new trainable parameters holding its block of the weight
        and, in column mode without the gather, of the bias (at p = 1 they
        share the layer's storage); or the layer itself, whole, where its
        dimension does not divide the axis."""
        from qgemm_tpu_torch.parallel.mesh import axis_rank, axis_size
        if self.tp_mode != "none":
            raise ValueError(f"layer is sharded already ({self.tp_mode})")
        p, r = axis_size(mesh, axis), axis_rank(mesh, axis)
        if not self.tp_shardable(mode, p):
            return self
        col = mode == "column"
        w = _shard(self.w.detach(), 1 if col else 0, p, r)
        b = None if self.b is None else self.b.detach()
        if b is not None and col and not gather_output:
            b = _shard(b, 0, p, r)
        out = Linear(w, b)
        out.tp_mode, out.tp_axis, out.gather_output, out.mesh = mode, axis, gather_output, mesh
        return out

    def quantize(self, outlier_threshold: float = 0.0, outlier_capacity: int = 32,
                 bits: int = 8) -> "QuantizedLinear":
        """``bits=4``: W4A8 weights; ``outlier_threshold > 0``: the outlier
        split at inference. The two compose."""
        check_quantize_options(outlier_threshold, outlier_capacity, bits)
        if self.tp_mode != "none":
            raise ValueError("quantize the whole model, then shard it "
                             "(parallel.sharding.shard_quantized_model)")
        wq = quantize_weights_int4(self.w.data) if bits == 4 \
            else quantize_weights(self.w.data)
        return QuantizedLinear(wq, None if self.b is None else self.b.data,
                               outlier_threshold=outlier_threshold,
                               outlier_capacity=outlier_capacity,
                               in_features=self.w.shape[0])


def _shard(t: torch.Tensor, dim: int, p: int, r: int) -> torch.Tensor:
    """Rank r's block of p along ``dim`` (no copy when p == 1)."""
    n = t.shape[dim] // p
    return t.narrow(dim, r * n, n).contiguous()


def tp_leaf_specs(mode: str, gather_output: bool = True,
                  bits: Optional[int] = 8) -> Dict[str, Tuple]:
    """The sharded dimension of each leaf of a layer in ``mode``, by JAX's
    leaf names (a float layer's ``w`` [K, N] with ``bits=None``; a
    quantized one's ``wq/q`` [K, N] int8 or ``wq/qp`` [K/2, N] packed int4
    codes and ``wq/c`` scales; ``b``) as ``PartitionSpec`` tuples (a leaf
    not named is replicated): column shards the out dimension of the
    weight or codes, of the scales and of a bias it keeps sharded (its
    output not gathered); row the in dimension of the weight or codes and
    of a W4A8 layer's group scales [K/128, N]."""
    if mode == "none":
        return {}
    if bits is None:
        if mode == "column":
            return {"w": (None, "model"), "b": () if gather_output else ("model",)}
        return {"w": ("model", None), "b": ()}
    codes = "wq/qp" if bits == 4 else "wq/q"
    if mode == "column":
        return {codes: (None, "model"), "wq/c": (None, "model"),
                "b": () if gather_output else ("model",)}
    return {codes: ("model", None), "wq/c": ("model", None) if bits == 4 else (), "b": ()}


def shard_by_plan(module: nn.Module, mesh, axis: str = "model"):
    """The layers of ``module.TP_PLAN``, each its rank's shard in its mode,
    by attribute; None where one of them does not divide the axis (the
    container then stays whole)."""
    from qgemm_tpu_torch.parallel.mesh import axis_size
    p = axis_size(mesh, axis)
    plan = module.TP_PLAN
    if not all(getattr(module, n).tp_shardable(mode, p) for n, (mode, _) in plan.items()):
        return None
    return {n: getattr(module, n).with_tp(mode, mesh, axis, gather_output=g)
            for n, (mode, g) in plan.items()}


class QuantizedLinear(nn.Module):
    def __init__(self, wq, b: Optional[torch.Tensor] = None,
                 outlier_threshold: float = 0.0, outlier_capacity: int = 32,
                 in_features: Optional[int] = None):
        """``wq`` is a ``QuantizedWeight`` (int8) or a ``QuantizedWeight4``.
        ``in_features`` is the true K (int8: the codes' K; int4: unknown
        unless given, as K is padded to whole groups — row-parallel W4A8
        needs it)."""
        super().__init__()
        self.bits = 4 if isinstance(wq, QuantizedWeight4) else 8
        if self.bits == 4:
            self.register_buffer("qpt", wq.qpt)   # int8 [out, kp/2], packed K-major
        else:
            self.register_buffer("qt", wq.qt)     # int8 [out, in], K-major
        self.register_buffer("c", wq.c)   # f32 [1, out] or [kp/128, out]
        self.b = _frozen(b)
        self.out_features = wq.c.shape[1]
        self.in_features = (in_features if in_features is not None
                            else wq.qt.shape[1] if self.bits == 8 else 0)
        self.outlier_threshold = outlier_threshold
        self.outlier_capacity = outlier_capacity
        self.tp_mode = "none"          # "none" | "column" | "row"
        self.tp_axis = "model"
        self.gather_output = True      # column mode: all-gather the output?
        self.mesh = None

    @property
    def wq(self):
        if self.bits == 4:
            return QuantizedWeight4(qpt=self.qpt, c=self.c)
        return QuantizedWeight(qt=self.qt, c=self.c)

    @property
    def leaf_specs(self) -> Dict[str, Tuple]:
        """Each leaf's sharded dimension in this layer's mode."""
        return tp_leaf_specs(self.tp_mode, self.gather_output, self.bits)

    def tp_shardable(self, mode: str, p: int) -> bool:
        """JAX's conditions: int8 needs N % p (column) or K % p (row); W4A8
        column needs N % p, row whole scale groups per rank and the true K
        equal to the packed extent."""
        if mode not in ("column", "row"):
            raise ValueError(f"unknown tensor-parallel mode {mode!r}")
        if self.bits == 4:
            if mode == "column":
                return self.qpt.shape[0] % p == 0
            return self.c.shape[0] % p == 0 and self.in_features == 2 * self.qpt.shape[1]
        n, k = self.qt.shape
        return (n if mode == "column" else k) % p == 0

    def with_tp(self, mode: str, mesh, axis: str = "model",
                gather_output: bool = True) -> "QuantizedLinear":
        """This rank's shard of the layer (see the module note), or the
        layer itself, whole, where its dimension does not divide the axis."""
        from qgemm_tpu_torch.parallel.mesh import axis_rank, axis_size
        if self.tp_mode != "none":
            raise ValueError(f"layer is sharded already ({self.tp_mode})")
        p, r = axis_size(mesh, axis), axis_rank(mesh, axis)
        if not self.tp_shardable(mode, p):
            return self
        col = mode == "column"
        if self.bits == 4:
            wq = QuantizedWeight4(qpt=_shard(self.qpt, 0 if col else 1, p, r),
                                  c=_shard(self.c, 1 if col else 0, p, r))
        else:
            wq = QuantizedWeight(qt=_shard(self.qt, 0 if col else 1, p, r),
                                 c=_shard(self.c, 1, p, r) if col else self.c)
        b = self.b
        if b is not None:
            b = _shard(b.data, 0, p, r) if col and not gather_output else b.data
        out = QuantizedLinear(wq, b, self.outlier_threshold, self.outlier_capacity,
                              in_features=self.in_features if col else self.in_features // p)
        out.tp_mode, out.tp_axis, out.gather_output, out.mesh = mode, axis, gather_output, mesh
        out.out_features = wq.c.shape[1] if col and not gather_output else self.out_features
        return out

    def _tp_matmul(self, x2: torch.Tensor) -> torch.Tensor:
        from qgemm_tpu_torch.parallel import tp_ops
        mesh, axis = self.mesh, self.tp_axis
        col = self.tp_mode == "column"
        if self.outlier_threshold > 0:
            if col:
                return tp_ops.tp_outlier_matmul_column(
                    x2, self.wq, self.outlier_threshold, self.outlier_capacity, mesh, axis,
                    self.gather_output)
            return tp_ops.tp_outlier_matmul_row(x2, self.wq, self.outlier_threshold,
                                                self.outlier_capacity, mesh, axis)
        if self.bits == 4:
            if col:
                return tp_ops.tp_w4a8_matmul_column(x2, self.qpt.t(), self.c, mesh, axis,
                                                    self.gather_output)
            return tp_ops.tp_w4a8_matmul_row(x2, self.qpt.t(), self.c, mesh, axis)
        if col:
            return tp_ops.tp_quantized_matmul_column(x2, self.qt.t(), self.c, mesh, axis,
                                                     self.gather_output)
        return tp_ops.tp_quantized_matmul_row(x2, self.qt.t(), self.c, mesh, axis)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        if self.tp_mode != "none":
            y = self._tp_matmul(x2)
        elif self.outlier_threshold > 0:
            y = quantized_matmul_prequant_outlier(x2, self.wq, self.outlier_threshold,
                                                  self.outlier_capacity)
        elif self.bits == 4:
            y = quantized_matmul_prequant_w4(x2, self.wq)
        else:
            y = quantized_matmul_prequant(x2, self.wq)
        y = y.to(x.dtype).reshape(*shape[:-1], self.out_features)
        if self.b is not None:
            y = y + self.b
        return y
