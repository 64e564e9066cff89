"""LLM.int8()-style absmax vector-wise quantization (port of
``qgemm_tpu/ops/quantize.py`` and of the int4 packing helpers of
``qgemm_tpu/ops/pallas/w4a8_matmul.py``).

int8 pipeline: per-row absmax of activations Cx, per-column absmax of
weights Cw, scales 127/C, round half to even (``torch.round``, like
``jnp.round``; ``rounding="truncate"`` keeps the reference's truncating
cast), exact int8 products summed in int32, and out = acc * (Cx Cw) / 127^2.

W4A8: int4 weights with one scale per (128-row K group, column), int8
activations with one scale per (row, 2048-wide K slab), one exact int32
dot per group folded into f32 by the group's scale.

LLM.int8() outlier split: activation feature dims whose column absmax
exceeds a threshold (top-k at a static capacity) leave the int8 / W4A8
product and go through a small float product against the dequantized
weight rows.

On CUDA tensors the serving matmuls run kernel K1
(``ops/cuda/quantized_matmul.py``) and kernel K4
(``ops/cuda/w4a8_matmul.py``), and the dynamic matmul column-quantizes its
weight with kernel K9 (``ops/cuda/col_quantize.py``); on CPU tensors their
plain versions. The public matmuls take the JAX package's ``backend``
under the port's names (``BACKENDS``): ``"auto"`` is that rule, ``"kernel"``
(JAX's ``"pallas"``) launches the kernel and raises on a CPU tensor, and
``"plain"`` (JAX's ``"xla"``) runs the plain PyTorch composition on the
tensor's own device, launching no kernel. Any other string raises
``ValueError`` (JAX takes it as ``"xla"``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from qgemm_tpu_torch.ops.cuda import quantized_matmul as _k1
from qgemm_tpu_torch.ops.cuda import w4a8_matmul as _k4
from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize
from qgemm_tpu_torch.ops.validation import (check, check_dtype, check_float,
                                            check_matmul_2d, check_rank, pad_last)

QRANGE = 127.0
W4RANGE = 7.0
GROUP = 128     # int4 weight scale group along K
W4_SLAB = 2048  # widest K slab sharing one W4A8 activation scale
_EPS = 1e-12  # guards all-zero rows/cols (scale would be inf)
BACKENDS = ("auto", "kernel", "plain")


def _runs_kernel(x: torch.Tensor, backend: str) -> bool:
    """Whether a matmul on ``x`` launches its kernel under ``backend``
    (see the module note); raises on an unknown backend, and on
    ``"kernel"`` for a tensor off the card."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of {BACKENDS}")
    if backend == "kernel" and not x.is_cuda:
        raise RuntimeError(f"backend='kernel' launches a CUDA kernel; x is on {x.device}")
    return backend != "plain" and x.is_cuda


def absmax_scales(x: torch.Tensor, axis: int) -> torch.Tensor:
    """max|x| along ``axis`` with keepdim — the Cx / Cw statistic."""
    return torch.clamp_min(x.abs().amax(dim=axis, keepdim=True), _EPS)


def absmax_quantize(x: torch.Tensor, axis: int, rounding: str = "nearest",
                    qrange: float = QRANGE):
    """Quantize to int8 along ``axis`` (rows of activations: axis=-1;
    columns of weights: axis=0), computing in x's dtype as the JAX version
    does. Returns (q int8, c absmax float32)."""
    c = absmax_scales(x, axis)
    return quantize_with_scales(x, c, rounding, qrange), c.to(torch.float32)


def quantize_with_scales(x: torch.Tensor, c: torch.Tensor, rounding: str = "nearest",
                         qrange: float = QRANGE) -> torch.Tensor:
    """int8 codes of x on the given absmax grid ``c`` (broadcast against x):
    clip(round(x * (qrange / c)))."""
    # a true division: torch evaluates `float / tensor` as float * (1 / c),
    # which rounds differently from JAX's qrange / c. full_like keeps the
    # numerator on the device: a host scalar copied in would sync the stream
    scaled = x * (torch.full_like(c, qrange) / c)
    if rounding == "nearest":
        return torch.clamp(torch.round(scaled), -qrange, qrange).to(torch.int8)
    if rounding == "truncate":  # reference bit-parity
        return torch.trunc(scaled).to(torch.int8)
    raise ValueError(f"unknown rounding {rounding!r}")


def dequantize(acc_i32: torch.Tensor, cx: torch.Tensor, cw: torch.Tensor,
               qrange: float = QRANGE) -> torch.Tensor:
    """out = acc * (Cx outer Cw) / R^2."""
    return acc_i32.to(torch.float32) * (cx * cw) * (1.0 / (qrange * qrange))


class QuantizedWeight(NamedTuple):
    """Offline-quantized weight. Stored K-major (``qt`` [n, k], the layout
    kernel K1 reads with 16-byte vectors along K); ``q`` is the JAX
    package's [k, n] view of the same bytes."""
    qt: torch.Tensor  # int8 [n, k]
    c: torch.Tensor   # float32 [1, n] per-column absmax

    @property
    def q(self) -> torch.Tensor:
        return self.qt.t()

    @classmethod
    def from_kn(cls, q: torch.Tensor, c: torch.Tensor) -> "QuantizedWeight":
        """From JAX's [k, n] int8 codes and [1, n] scales."""
        return cls(qt=q.t().contiguous(), c=c.to(torch.float32).reshape(1, -1))


def quantize_weights(w: torch.Tensor, rounding: str = "nearest") -> QuantizedWeight:
    """w [k, n] -> per-column int8 codes and absmax (JAX ``quantize_weights``)."""
    q, c = absmax_quantize(w, axis=0, rounding=rounding)
    return QuantizedWeight.from_kn(q, c)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 [m, k] x int8 [k, n] -> exact int32. ``int8 @ int8`` in torch
    returns int8 and wraps, so the CPU sums in int32; torch has no int32
    matmul on CUDA, so there it sums in float64, exact while k * 127^2 < 2^53."""
    if xq.is_cuda:
        return torch.matmul(xq.to(torch.float64), wq.to(torch.float64)).to(torch.int32)
    return torch.matmul(xq.to(torch.int32), wq.to(torch.int32))


def quantized_matmul_plain(x: torch.Tensor, wq: QuantizedWeight,
                           rounding: str = "nearest",
                           cx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel K1: x is upcast to f32 (as the TPU
    kernel does), row-quantized, multiplied exactly and dequantized.
    x [m, k] float -> f32 [m, n]. ``cx`` f32 [m, 1]: the caller's row
    scales (the TPU kernel ``_qmm_kernel``'s input) in place of x's own."""
    xf = x.to(torch.float32)
    if cx is None:
        xq, cx = absmax_quantize(xf, axis=-1, rounding=rounding)
    else:
        xq = quantize_with_scales(xf, cx, rounding)
    return dequantize(int8_matmul(xq, wq.q), cx, wq.c)


def k_tile(k: int) -> int:
    """K rounded up to the 16 that K1 and K8 step by. The wrappers zero-pad
    x and the weight codes to it: a zero changes neither a row's absmax nor
    an int32 sum, so the product keeps its bits."""
    return -(-k // 16) * 16


def quantized_matmul_xla(x: torch.Tensor, w: torch.Tensor, rounding: str = "nearest",
                         qrange: float = QRANGE) -> torch.Tensor:
    """The composition of the pipeline's steps in plain torch (JAX's
    ``quantized_matmul_xla``, the oracle of its kernels): both operands
    quantized in their own dtype, an exact int32 product, the dequant."""
    xq, cx = absmax_quantize(x, axis=-1, rounding=rounding, qrange=qrange)
    wq, cw = absmax_quantize(w, axis=0, rounding=rounding, qrange=qrange)
    return dequantize(int8_matmul(xq, wq), cx, cw, qrange)


def quantized_matmul_prequant(x: torch.Tensor, wq: QuantizedWeight,
                              rounding: str = "nearest",
                              cx: Optional[torch.Tensor] = None,
                              backend: str = "auto") -> torch.Tensor:
    """Serving path: weights already int8, activations quantized per call.
    x [m, k] float -> f32 [m, n]. CPU tensors run the plain version; CUDA
    tensors launch K1 (x f32 or bf16) or raise. A k that is not a multiple
    of 16 is zero-padded (x and the weight codes) on that call only.

    ``cx`` f32 [m, 1] (the contract of the TPU kernel ``_qmm_kernel``):
    quantize x on these row scales instead of its own absmax — a
    row-parallel shard passes the absmax of the whole row, all-reduced
    (``parallel/tp_ops.py``). Given x's own absmax (floored at 1e-12) it
    returns the same bits as without. ``backend``: see the module note."""
    kernel = _runs_kernel(x, backend)
    check_matmul_2d(x, wq.q, "x", "wq.q")
    check_float("x", x)
    check_dtype("wq.q", wq.qt, torch.int8)
    check(tuple(wq.c.shape) == (1, wq.qt.shape[0]),
          f"wq.c: expected per-column scales (1, {wq.qt.shape[0]}), "
          f"got {tuple(wq.c.shape)}")
    check(rounding in _k1.ROUNDING, f"unknown rounding {rounding!r}")
    if cx is not None:
        check(tuple(cx.shape) == (x.shape[0], 1),
              f"cx: expected row scales ({x.shape[0]}, 1), got {tuple(cx.shape)}")
        check_dtype("cx", cx, torch.float32)
        check(cx.device == x.device, f"cx is on {cx.device}, x on {x.device}")
    if not kernel:
        return quantized_matmul_plain(x, wq, rounding, cx)
    check(x.dtype in _k1.X_DTYPES, f"x: K1 takes float32 or bfloat16, got {x.dtype}")
    kp = k_tile(x.shape[1])
    return _k1.quantized_matmul_cuda(pad_last(x, kp), pad_last(wq.qt, kp), wq.c, rounding,
                                     cx=cx)


def quantized_matmul(x: torch.Tensor, w: torch.Tensor, rounding: str = "nearest",
                     backend: str = "auto") -> torch.Tensor:
    """Dynamic quantized matmul: quantizes BOTH operands on the fly. W is
    column-quantized in f32, as the JAX Pallas path does (K9 on CUDA
    tensors), then K1 runs as on the serving path. x [m, k], w [k, n]
    float. ``backend="plain"`` runs ``quantized_matmul_xla``."""
    _runs_kernel(x, backend)
    check_matmul_2d(x, w)
    check_float("x", x)
    check_float("w", w)
    if backend == "plain":
        return quantized_matmul_xla(x, w, rounding=rounding)
    # K9 reads f32 or bf16 and upcasts in registers; other floats go to f32 here
    qt, c = col_quantize(w if w.dtype == torch.bfloat16 else w.to(torch.float32),
                         rounding=rounding)
    return quantized_matmul_prequant(x, QuantizedWeight(qt=qt, c=c), rounding=rounding,
                                     backend=backend)


# ---------------------------------------------------------------------------
# int4 weights (W4A8)
# ---------------------------------------------------------------------------

def _div(num: float, t: torch.Tensor) -> torch.Tensor:
    """``t / num`` as a true division on every device (torch's CUDA kernel
    multiplies by the reciprocal of a host scalar divisor)."""
    return t / torch.full_like(t, num)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """q int [K, N] in [-7, 7], K a multiple of GROUP -> packed int8 [K/2, N]:
    in each 128-row group the low nibbles hold the group's first 64 rows and
    the high nibbles its last 64 (JAX ``pack_int4``'s layout)."""
    k, n = q.shape
    check(k % GROUP == 0, f"K={k} is not a multiple of the group size {GROUP}")
    g = q.reshape(k // GROUP, 2, GROUP // 2, n).to(torch.int32)
    packed = (g[:, 0] & 0xF) | ((g[:, 1] & 0xF) << 4)
    return packed.reshape(k // 2, n).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: packed int8 [K/2, N] -> int8 [K, N]."""
    k2, n = packed.shape
    pi = packed.to(torch.int32)
    lo = ((pi & 0xF) ^ 8) - 8                       # sign-extended low nibble
    hi = pi >> 4                                    # arithmetic: signed high
    g = k2 // (GROUP // 2)
    return torch.cat([lo.reshape(g, GROUP // 2, n), hi.reshape(g, GROUP // 2, n)],
                     dim=1).reshape(g * GROUP, n).to(torch.int8)


class QuantizedWeight4(NamedTuple):
    """int4 group-quantized weight. The packed codes are stored K-major
    (``qpt`` [n, kp/2], each column's 64 bytes per group contiguous, the
    layout kernel K4 streams); ``qp`` is the JAX package's [kp/2, n] view of
    the same bytes. kp is K rounded up to GROUP; the pad rows are zeros."""
    qpt: torch.Tensor  # int8 [n, kp/2] packed (pack_int4 layout along K)
    c: torch.Tensor    # float32 [kp/GROUP, n] per-group column scales

    @property
    def qp(self) -> torch.Tensor:
        return self.qpt.t()

    @classmethod
    def from_kn(cls, qp: torch.Tensor, c: torch.Tensor) -> "QuantizedWeight4":
        """From JAX's [kp/2, n] packed codes and [kp/GROUP, n] scales."""
        return cls(qpt=qp.t().contiguous(), c=c.to(torch.float32).contiguous())


def quantize_weights_int4(w: torch.Tensor) -> QuantizedWeight4:
    """w [k, n] -> QuantizedWeight4 (JAX ``quantize_weights_int4``): K
    zero-padded to a GROUP multiple; each group's scale is the one of
    absmax x (1.0, 0.9, ..., 0.5) with the least squared reconstruction
    error (the first on a tie), all in float32."""
    k, n = w.shape
    kp = -(-k // GROUP) * GROUP
    wf = torch.nn.functional.pad(w.to(torch.float32), (0, 0, 0, kp - k))
    wg = wf.reshape(kp // GROUP, GROUP, n)
    cmax = torch.clamp_min(wg.abs().amax(dim=1), _EPS)            # [KG, n]

    def codes(c):
        return torch.clamp(torch.round(wg * (torch.full_like(c, W4RANGE) / c)[:, None, :]),
                           -W4RANGE, W4RANGE)

    best_c = best_mse = None
    for alpha in (1.0, 0.9, 0.8, 0.7, 0.6, 0.5):
        c = cmax * alpha
        err = codes(c) * _div(W4RANGE, c)[:, None, :] - wg
        mse = torch.sum(err * err, dim=1)
        if best_c is None:
            best_c, best_mse = c, mse
        else:
            better = mse < best_mse
            best_c = torch.where(better, c, best_c)
            best_mse = torch.where(better, mse, best_mse)
    q = codes(best_c).to(torch.int32).reshape(kp, n)
    return QuantizedWeight4(qpt=pack_int4(q).t().contiguous(), c=best_c)


def dequantize_weights_int4(wq4: QuantizedWeight4, k: Optional[int] = None,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The (lossy) weights [kp, n], or [:k] when the true K is given,
    computed in f32 and cast to ``dtype``."""
    q = unpack_int4(wq4.qp).to(torch.float32)
    kp, n = q.shape
    w = (q.reshape(kp // GROUP, GROUP, n) * _div(W4RANGE, wq4.c)[:, None, :]).reshape(kp, n)
    return (w if k is None else w[:k]).to(dtype)


def w4a8_slab(kp: int) -> int:
    """Width of the K slabs that share one activation scale per row (the
    TPU kernel's K block): all of K up to W4_SLAB, else W4_SLAB."""
    return min(W4_SLAB, kp)


def w4a8_matmul_plain(x: torch.Tensor, wq4: QuantizedWeight4) -> torch.Tensor:
    """Plain PyTorch version of kernel K4, in the TPU kernel's order: per K
    slab, x (as f32) is row-quantized to int8 on the slab's own absmax; per
    128-row group an exact int32 dot, scaled by the group's column scale and
    added in group order; then the slab's sum times cx / (127 * 7) is added
    in slab order. x [m, k] float -> f32 [m, n]."""
    k = x.shape[1]
    kp = 2 * wq4.qpt.shape[1]
    bk = w4a8_slab(kp)
    w = unpack_int4(wq4.qp)
    xf = torch.nn.functional.pad(x.to(torch.float32), (0, kp - k))
    out = None
    for s0 in range(0, kp, bk):
        xq, cx = absmax_quantize(xf[:, s0:s0 + bk], axis=-1)
        acc = None
        for g0 in range(s0, min(s0 + bk, kp), GROUP):
            part = int8_matmul(xq[:, g0 - s0:g0 - s0 + GROUP], w[g0:g0 + GROUP])
            term = part.to(torch.float32) * wq4.c[g0 // GROUP]
            acc = term if acc is None else acc + term
        term = acc * _div(QRANGE * W4RANGE, cx)
        out = term if out is None else out + term
    return out


def quantized_matmul_prequant_w4(x: torch.Tensor, wq4: QuantizedWeight4,
                                 backend: str = "auto") -> torch.Tensor:
    """x [m, k] float @ int4 weights -> f32 [m, n]. CPU tensors run the
    plain version; CUDA tensors launch K4 (x f32 or bf16) or raise.
    ``backend``: see the module note."""
    kernel = _runs_kernel(x, backend)
    check_rank("x", x, 2)
    check_float("x", x)
    check_dtype("wq4.qpt", wq4.qpt, torch.int8)
    n, kp2 = wq4.qpt.shape
    check(2 * kp2 == -(-x.shape[1] // GROUP) * GROUP,
          f"x @ wq4: x has k={x.shape[1]}, the packed weights hold "
          f"{2 * kp2} rows (k rounded up to {GROUP})")
    check(tuple(wq4.c.shape) == (2 * kp2 // GROUP, n),
          f"wq4.c: expected group scales {(2 * kp2 // GROUP, n)}, got {tuple(wq4.c.shape)}")
    if not kernel:
        return w4a8_matmul_plain(x, wq4)
    check(x.dtype in _k4.X_DTYPES, f"x: K4 takes float32 or bfloat16, got {x.dtype}")
    return _k4.w4a8_matmul_cuda(x, wq4.qpt, wq4.c, w4a8_slab(2 * kp2))


def _take_rows_w4(wq4: QuantizedWeight4, idx: torch.Tensor) -> torch.Tensor:
    """Dequantize K-rows ``idx`` [cap] of packed int4 weights -> f32 [cap, n].
    Row r lies in group r // GROUP at packed row group * 64 + r % 64, in the
    low nibble for the group's first 64 rows and the high nibble after."""
    half = GROUP // 2
    g = idx // GROUP
    r = idx % GROUP
    is_hi = r >= half
    prow = g * half + torch.where(is_hi, r - half, r)
    packed = wq4.qpt.index_select(1, prow).t().to(torch.int32)  # [cap, n]
    lo = ((packed & 0xF) ^ 8) - 8
    hi = packed >> 4
    q = torch.where(is_hi[:, None], hi, lo).to(torch.float32)
    return q * _div(W4RANGE, wq4.c.index_select(0, g))


# ---------------------------------------------------------------------------
# mixed-precision outlier decomposition (LLM.int8() §3; BASELINE config 5)
# ---------------------------------------------------------------------------

def _outlier_dot_dtype(x: torch.Tensor) -> torch.dtype:
    """The outlier product's operand type: bf16 on the GPU (as on the TPU),
    f32 on the CPU (as the JAX package runs it there)."""
    return torch.bfloat16 if x.is_cuda else torch.float32


def _outlier_split(x: torch.Tensor, threshold: float, capacity: int):
    """Select up to ``capacity`` feature dims of x whose absmax over every
    row exceeds ``threshold`` (top-k, then the threshold: static shapes, no
    host sync). Returns (x with those dims zeroed, x's values at the top-k
    dims with unselected ones zeroed [..., cap], the top-k dims [cap])."""
    k = x.shape[-1]
    col_absmax = x.abs().amax(dim=tuple(range(x.ndim - 1)))
    top_vals, top_idx = torch.topk(col_absmax, min(capacity, k))
    selected = top_vals > threshold
    mask = torch.zeros((k,), dtype=torch.bool, device=x.device).scatter(0, top_idx, selected)
    x_o = x.index_select(-1, top_idx) * selected.to(x.dtype)
    return x.masked_fill(mask, 0), x_o, top_idx


def _outlier_dot(x_o: torch.Tensor, w_rows: torch.Tensor) -> torch.Tensor:
    """x_o [m, cap] @ w_rows [cap, n] with operands rounded to the outlier
    dtype and f32 sums (products of bf16 values are exact in f32)."""
    od = _outlier_dot_dtype(x_o)
    return torch.matmul(x_o.to(od).to(torch.float32), w_rows.to(od).to(torch.float32))


def quantized_matmul_prequant_outlier(x: torch.Tensor, wq, threshold: float = 6.0,
                                      capacity: int = 32, backend: str = "auto",
                                      matmul_fn=None) -> torch.Tensor:
    """Serving-path outlier decomposition over int8 (``QuantizedWeight``) or
    int4 (``QuantizedWeight4``) weights: the outlier dims are zeroed in the
    quantized product (K1 or K4), and the matching weight rows, dequantized
    on the fly, multiply the outlier columns in the outlier dtype. Weights
    stay quantized in memory. x [m, k] float -> f32 [m, n]. ``backend``:
    the quantized product's (see the module note). ``matmul_fn(x_in, wq)``,
    when given, computes the quantized product in its place; the split and
    the outlier product stay as they are."""
    _runs_kernel(x, backend)
    x_in, x_o, top_idx = _outlier_split(x, threshold, capacity)
    if isinstance(wq, QuantizedWeight4):
        product = quantized_matmul_prequant_w4
        w_rows = _take_rows_w4(wq, top_idx)
    else:
        product = quantized_matmul_prequant
        w_rows = wq.qt.index_select(1, top_idx).t().to(torch.float32) \
            * wq.c * (1.0 / QRANGE)
    out = matmul_fn(x_in, wq) if matmul_fn is not None else product(x_in, wq, backend=backend)
    return out + _outlier_dot(x_o, w_rows)


def quantized_matmul_outlier(x: torch.Tensor, w: torch.Tensor, threshold: float = 6.0,
                             capacity: Optional[int] = None,
                             backend: str = "auto") -> torch.Tensor:
    """Dynamic outlier decomposition: out = quantized_matmul(x with outlier
    dims zeroed, w) + x[:, outliers] @ w[outliers, :] in the outlier dtype.
    ``capacity`` (default max(8, k / 128)) is the static number of outlier
    dims; exact with respect to the threshold while no more dims exceed it.
    ``backend``: the quantized product's (see the module note)."""
    k = x.shape[-1]
    if capacity is None:
        capacity = max(8, k // 128)
    x_in, x_o, top_idx = _outlier_split(x, threshold, capacity)
    return quantized_matmul(x_in, w, backend=backend) \
        + _outlier_dot(x_o, w.index_select(0, top_idx))
