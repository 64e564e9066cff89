"""Wrapper of the row-softmax kernel (``csrc/softmax.cu``), row 14 of the
TPU kernel table.

Replaces ``softmax_pallas`` / ``_softmax_kernel`` of
``qgemm_tpu/ops/pallas/softmax.py``: a softmax over the last axis, for any
leading shape and width, in f32 with the output in x's dtype. JAX calls it
where softmax is an op boundary (its model path fuses softmax into the
attention kernels), and so does the port: no model calls it. The source
note in the .cu file says what bounds it and how it is built.
"""

from __future__ import annotations

import ctypes

import torch

from qgemm_tpu_torch.ops.cuda import _build
from qgemm_tpu_torch.ops.validation import check, check_float

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VEC_BYTES = 16


def softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: in f32, m = max, e = exp(x - m),
    e / sum(e) as a true division, cast to x's dtype."""
    xf = x.to(torch.float32)
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def vector_ok(n: int, *tensors: torch.Tensor) -> bool:
    """Whether every row of these [rows, n] tensors starts on a 16-byte
    boundary, so the row kernels may use vector loads."""
    return all((n * t.element_size()) % VEC_BYTES == 0 and t.data_ptr() % VEC_BYTES == 0
               for t in tensors)


def _lib():
    fn = _build.library("softmax").qgemm_softmax
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, p]
        fn.restype = i
    return fn


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Row softmax over the last axis of x (any leading shape, f32 or bf16
    on the card), in x's dtype. CPU tensors run the plain version; CUDA
    tensors launch the kernel or raise. Counts each launch in
    ``softmax.launches``."""
    check_float("x", x)
    check(x.ndim >= 1 and x.shape[-1] > 0, f"x: expected a last axis, got {tuple(x.shape)}")
    if not x.is_cuda:
        return softmax_plain(x)
    check(x.dtype in DTYPES, f"x: the softmax kernel takes float32 or bfloat16, got {x.dtype}")
    n = x.shape[-1]
    x2 = x.reshape(-1, n).contiguous()
    out = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return out.reshape(x.shape)
    rc = _lib()(x2.data_ptr(), out.data_ptr(), DTYPES[x.dtype], x2.shape[0], n,
                int(vector_ok(n, x2, out)), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("qgemm_softmax", rc)
    softmax.launches += 1
    return out.reshape(x.shape)


softmax.launches = 0
