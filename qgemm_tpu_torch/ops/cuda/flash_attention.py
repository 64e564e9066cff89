"""Wrapper of kernel K3 (``csrc/flash_attention.cu``): blockwise attention
forward returning O and the per-row logsumexp.

Replaces ``_flash_attention_fwd_impl`` / ``_flash_kernel`` of
``qgemm_tpu/ops/pallas/flash_attention.py``. ``flash_attention_fwd`` is the
forward alone; ``flash_attention`` is differentiable (JAX's ``custom_vjp``):
a ``torch.autograd.Function`` whose forward is K3 and saves (q, k, v, O,
lse) and whose backward is kernel K7 (``flash_attention_bwd.py``). CPU
tensors run the two plain versions. The source note in the .cu file says
what bounds it and how it is built.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from qgemm_tpu_torch.ops.cuda import _build
from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import (ROUTES, WIDE_CHUNK, WIDE_SMEM,
                                                          WIDTHS, flash_attention_bwd,
                                                          kernel_widths)
from qgemm_tpu_torch.ops.validation import (check, check_aligned16, check_attention_4d,
                                            check_grid, pad_last)

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, scale: Optional[float] = None):
    """Plain PyTorch version of K3 (the TPU kernel's math without its
    blocking): products in the input dtype with f32 sums, masked entries
    p = 0 (k >= Sk; k > q when causal), P cast to V's dtype for the second
    product; ``scale`` defaults to 1/sqrt(D). Returns (O [B, H, Sq, Dv] in
    q's dtype, lse f32 [B, H, Sq])."""
    sq, sk = q.shape[2], k.shape[2]
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) \
        * (scale or 1.0 / math.sqrt(q.shape[-1]))
    if causal:
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    o = torch.matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32)) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


_MMA_KEY_TILE = 64
_MMA_WIDE_KEY_TILE = 32    # D 256: fewer keys a tile, Q's fragments read per k-chunk


def flash_fwd_plan(dtype: torch.dtype, bh: int, sq: int, sk: int, d: int,
                   dv: Optional[int] = None) -> dict:
    """K3's launch plan for ``bh`` batch*heads of ``sq`` queries over ``sk``
    keys at the kernel width ``d`` (32, 64, 128 or 256; ``dv`` None), or,
    on the wide route, q and k of width ``d`` and v of width ``dv`` (both
    multiples of 64, one past 256: ``kernel_widths``): the route ("mma",
    the bf16 tensor-core kernel; "simt", the f32 kernel; "wide", either
    dtype past 256), the query rows per block, the keys per streamed tile,
    threads per block, the grid (one dimension: query tiles x [Dv chunks
    x] batch*heads) and the dynamic shared memory in bytes. The tiled
    routes take 64 query rows per block: on the H100, 128-row blocks of the
    mma route (8 warps) were slower at S 512 and at S 2048 (PERF.md §6); at
    d 256 the mma route's key tiles hold 32 keys (the .cu note says why).
    Pure: the CPU tests check it, and the C entry refuses a plan that
    matches no compiled kernel."""
    check(dtype in _DTYPES, f"K3 takes float32 or bfloat16, got {dtype}")
    check(bh > 0, f"K3 needs batch*heads > 0, got {bh}")
    check(sq > 0 and sk > 0, f"K3 needs sq and sk > 0, got {sq}, {sk}")
    if dv is not None:
        check(d > 0 and dv > 0 and d % WIDE_CHUNK == 0 and dv % WIDE_CHUNK == 0
              and max(d, dv) > WIDTHS[-1],
              f"K3's wide route takes widths that are multiples of {WIDE_CHUNK}, one past "
              f"{WIDTHS[-1]}, got {d}, {dv}")
        chunks = -(-dv // 256)
        return {"route": "wide", "block_q": 64, "block_k": 32, "threads": 256,
                "dv_chunks": chunks, "smem": WIDE_SMEM,
                "grid": check_grid("K3", (-(-sq // 64) * chunks * bh,))}
    check(d in WIDTHS, f"K3 is compiled for widths {WIDTHS}, got {d}")
    if dtype == torch.bfloat16:
        tile = _MMA_WIDE_KEY_TILE if d > 128 else _MMA_KEY_TILE
        plan = {"route": "mma", "block_q": 64, "block_k": tile, "threads": 128,
                # Q, then two stages of K and V tiles, bf16 rows padded by 16 B
                "smem": 2 * (d + 8) * (64 + 4 * tile)}
    else:
        plan = {"route": "simt", "block_q": 64, "block_k": 32, "threads": 256,
                # Q, K and V tiles in f32 (rows padded by 16 B), scores, row stats
                "smem": 4 * ((64 + 2 * 32) * (d + 4) + 64 * 33 + 3 * 64)}
    plan["grid"] = check_grid("K3", (-(-sq // plan["block_q"]) * bh,))
    return plan


def _lib(wide: bool = False):
    lib = _build.library("flash_attention")
    fn = lib.qgemm_flash_attention_fwd_wide if wide else lib.qgemm_flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 5 + [i] * 7 + [ctypes.c_float, i, p] if wide
                       else [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p])
        fn.restype = i
    return fn


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False):
    """q [B, H, Sq, D], k [B, H, Sk, D], v [B, H, Sk, Dv] -> (O [B, H, Sq, Dv],
    lse f32 [B, H, Sq]); causal means key j attends query i iff j <= i. CPU
    tensors run the plain version; CUDA tensors launch K3 (bf16 on the
    tensor-core route, f32 on the SIMT route; D and Dv up to 256: q, k and
    v are zero-padded to the kernel's width when D or Dv is not 32, 64, 128
    or 256, or they differ; past 256 both dtypes run the wide route, q and
    k padded to a multiple of 64 and v to another) or raise."""
    check_attention_4d(q, k, v)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    check(q.dtype in _DTYPES and k.dtype == v.dtype == q.dtype,
          f"K3 takes float32 or bfloat16 q/k/v of one dtype, got "
          f"{q.dtype}/{k.dtype}/{v.dtype}")
    check(k.is_cuda and v.is_cuda and q.device == k.device == v.device,
          "flash_attention: q, k and v must lie on one CUDA device")
    dv = v.shape[3]
    dqk, dvp = kernel_widths(d, dv)
    plan = flash_fwd_plan(q.dtype, b * h, sq, sk, dqk, dvp if max(d, dv) > WIDTHS[-1] else None)
    q, k, v = pad_last(q, dqk), pad_last(k, dqk), pad_last(v, dvp)
    o = torch.empty(v.shape[:2] + (sq, dvp), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    check_aligned16("K3", q, k, v, o)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if plan["route"] == "wide":
        rc = _lib(True)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        lse.data_ptr(), _DTYPES[q.dtype], b * h, sq, sk, dqk, dvp, int(causal),
                        1.0 / math.sqrt(d), plan["smem"], stream)
        _build.check_launch("qgemm_flash_attention_fwd_wide", rc)
    else:
        rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), _DTYPES[q.dtype], b * h, sq, sk, dqk, int(causal),
                    1.0 / math.sqrt(d), ROUTES[plan["route"]], plan["smem"], stream)
        _build.check_launch("qgemm_flash_attention_fwd", rc)
    flash_attention_fwd.launches += 1
    return (o if dvp == dv else o[..., :dv].contiguous()), lse


flash_attention_fwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K3 forward saving (q, k, v, O, lse); K7 backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, g, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v, blockwise and differentiable
    (``qgemm_tpu``'s ``flash_attention``)."""
    return _FlashAttention.apply(q, k, v, causal)
