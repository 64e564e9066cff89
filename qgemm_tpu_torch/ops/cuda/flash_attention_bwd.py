"""Wrapper of kernel K7 (``csrc/flash_attention_bwd.cu``): the blockwise
(FlashAttention-2) attention backward from the forward's O and logsumexp.

Replaces ``_flash_attention_bwd_impl`` (``_flash_bwd_dq_kernel``,
``_flash_bwd_dkv_kernel``) of ``qgemm_tpu/ops/pallas/flash_attention.py``.
``ops/cuda/flash_attention.py`` wraps K3 and K7 in one
``torch.autograd.Function``. The source note in the .cu file says what
bounds it and how it is built.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from qgemm_tpu_torch.ops.cuda import _build
from qgemm_tpu_torch.ops.validation import (check, check_aligned16, check_attention_4d,
                                            check_grid, pad_last)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WIDTHS = (32, 64, 128, 256)   # K3's and K7's compiled head widths
# the C entries' route codes (K3's and K7's): the f32 SIMT kernels and the
# bf16 tensor-core (mma.sync) kernels; the wide route has entries of its own
ROUTES = {"simt": 0, "mma": 1}
WIDE_CHUNK = 64               # the wide route's widths are multiples of this
# the wide route's dynamic shared memory (csrc/flash_wide.cuh smem_bytes):
# f32 chunks of 64 x 68 and 32 x 68, the 64 x 33 score tile, a 32 x 260
# output-width tile and 3 x 64 row statistics
WIDE_SMEM = 4 * (64 * 68 + 32 * 68 + 64 * 33 + 32 * 260 + 3 * 64)


def kernel_widths(d: int, dv: int) -> tuple:
    """The widths K3 and K7 run q/k and v at for true widths ``d`` and
    ``dv``: one compiled width (32, 64, 128, 256) that holds both where
    both are at most 256, else each rounded up to a multiple of 64 (the
    wide route). Any width >= 1."""
    check(d >= 1 and dv >= 1, f"K3/K7 need head widths >= 1, got {d}, {dv}")
    if max(d, dv) <= WIDTHS[-1]:
        w = next(w for w in WIDTHS if max(d, dv) <= w)
        return w, w
    return -(-d // WIDE_CHUNK) * WIDE_CHUNK, -(-dv // WIDE_CHUNK) * WIDE_CHUNK


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                              causal: bool = False, scale: Optional[float] = None):
    """Plain PyTorch version of K7 (the TPU kernels' math without their
    blocking): P = exp(s * scale - lse) with the forward's causal mask,
    delta = rowsum(dO * O) and dP = dO V^T in f32, dS = P (dP - delta) scale;
    P is cast to dO's dtype for dV = P^T dO and dS to the input dtype for
    dQ = dS K and dK = dS^T Q, each product summed in f32. Returns
    (dQ, dK, dV) in the dtypes of q, k and v; ``scale`` defaults to 1/sqrt(D)."""
    f32 = torch.float32
    sq, sk = q.shape[2], k.shape[2]
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = (t.to(f32) for t in (q, k, v, g))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.to(f32)[..., None])
    if causal:
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        p = torch.where(mask, p, torch.zeros_like(p))
    delta = (gf * out.to(f32)).sum(dim=-1, keepdim=True)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - delta) * scale
    dv = torch.matmul(p.to(g.dtype).to(f32).transpose(-1, -2), gf)
    dsr = ds.to(q.dtype).to(f32)
    dq = torch.matmul(dsr, kf)
    dk = torch.matmul(dsr.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plan(dtype: torch.dtype, bh: int, sq: int, sk: int, d: int,
                   dv: Optional[int] = None) -> dict:
    """K7's launch plan for ``bh`` batch*heads of ``sq`` queries over ``sk``
    keys at the kernel width ``d`` (32, 64, 128 or 256; ``dv`` None), or,
    on the wide route, q/k of width ``d`` and v of width ``dv``
    (``kernel_widths``): the route ("mma" for bf16, "simt" for f32, "wide"
    for either past 256), the query rows per dQ block (``block_q``), the
    key rows per dK/dV block (``block_k``), the rows of each streamed
    tile, threads per block, the grids (one dimension: delta pre-pass; dQ;
    dK/dV, at d 256 on the mma route two dK/dV blocks per 64 keys, z 0 for
    dV and 1 for dK; on the wide route dQ, dK and dV each in 256-column
    chunks) and the kernels' dynamic shared memory in bytes. Pure: the CPU
    tests check it, and the C entry refuses a plan that matches no compiled
    kernel."""
    check(dtype in _DTYPES, f"K7 takes float32 or bfloat16, got {dtype}")
    check(bh > 0, f"K7 needs batch*heads > 0, got {bh}")
    check(sq > 0 and sk > 0, f"K7 needs sq and sk > 0, got {sq}, {sk}")
    grid_delta = check_grid("K7 delta", (-(-bh * sq * 32 // 256),))
    if dv is not None:
        check(d > 0 and dv > 0 and d % WIDE_CHUNK == 0 and dv % WIDE_CHUNK == 0
              and max(d, dv) > WIDTHS[-1],
              f"K7's wide route takes widths that are multiples of {WIDE_CHUNK}, one past "
              f"{WIDTHS[-1]}, got {d}, {dv}")
        nq, nk = -(-sq // 64), -(-sk // 64)
        return {"route": "wide", "block_q": 64, "block_k": 64, "tile": 32, "threads": 256,
                "smem_dq": WIDE_SMEM, "smem_dkv": WIDE_SMEM, "grid_delta": grid_delta,
                "grid_dq": check_grid("K7 dQ", (nq * -(-d // 256) * bh,)),
                "grid_dk": check_grid("K7 dK", (nk * -(-d // 256) * bh,)),
                "grid_dv": check_grid("K7 dV", (nk * -(-dv // 256) * bh,))}
    check(d in WIDTHS, f"K7 is compiled for widths {WIDTHS}, got {d}")
    if dtype == torch.bfloat16:
        # the resident pair and two stages of the streamed pair, bf16 rows
        # padded by 16 B; the dK/dV kernel adds two stages of lse and delta
        tile = 2 * (d + 8) * 6 * 64
        plan = {"route": "mma", "block_q": 64, "block_k": 64, "tile": 64, "threads": 128,
                "smem_dq": tile, "smem_dkv": tile + 4 * 4 * 64}
    else:
        # f32 rows padded by 16 B: the resident pair, one streamed pair of
        # 32-row tiles, the score tile(s) and the row statistics
        rows = 4 * (2 * 64 + 2 * 32) * (d + 4)
        plan = {"route": "simt", "block_q": 64, "block_k": 64, "tile": 32, "threads": 256,
                "smem_dq": rows + 4 * (64 * 33 + 2 * 64),
                "smem_dkv": rows + 4 * (2 * 64 * 33 + 2 * 32)}
    plan.update(grid_delta=grid_delta,
                grid_dq=check_grid("K7 dQ", (-(-sq // plan["block_q"]) * bh,)),
                grid_dkv=check_grid("K7 dK/dV", (-(-sk // plan["block_k"]) * bh,)
                                    + ((1, 2) if plan["route"] == "mma" and d > 128 else ())))
    return plan


def _lib(wide: bool = False):
    lib = _build.library("flash_attention_bwd")
    fn = lib.qgemm_flash_attention_bwd_wide if wide else lib.qgemm_flash_attention_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 10 + [i] * 7 + [ctypes.c_float, i, p] if wide
                       else [p] * 10 + [i] * 6 + [ctypes.c_float, i, i, i, p])
        fn.restype = i
    return fn


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                        causal: bool = False):
    """q [B, H, Sq, D], k/v [B, H, Sk, D], out and its gradient g
    [B, H, Sq, D], lse f32 [B, H, Sq] (the forward's) -> (dQ, dK, dV).
    CPU tensors run the plain version; CUDA tensors launch K7 (bf16 on the
    tensor-core route, f32 on the SIMT route; D and Dv up to 256,
    zero-padded as K3's wrapper pads them; past 256 the wide route, q/k
    padded to a multiple of 64 and v, out and g to another) or raise."""
    check_attention_4d(q, k, v)
    check(tuple(out.shape) == tuple(q.shape[:3]) + (v.shape[3],)
          and tuple(g.shape) == tuple(out.shape),
          f"flash_attention_bwd: out {tuple(out.shape)} and g {tuple(g.shape)} must "
          f"be [B, H, Sq, Dv] for q {tuple(q.shape)}, v {tuple(v.shape)}")
    check(tuple(lse.shape) == tuple(q.shape[:3]) and lse.dtype == torch.float32,
          f"flash_attention_bwd: lse must be float32 {tuple(q.shape[:3])}, got "
          f"{lse.dtype} {tuple(lse.shape)}")
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, out, lse, g, causal)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    check(q.dtype in _DTYPES and all(t.dtype == q.dtype for t in (k, v, out, g)),
          f"K7 takes float32 or bfloat16 q/k/v/out/g of one dtype, got "
          f"{q.dtype}/{k.dtype}/{v.dtype}/{out.dtype}/{g.dtype}")
    check(all(t.is_cuda and t.device == q.device for t in (k, v, out, lse, g)),
          "flash_attention_bwd: every tensor must lie on q's CUDA device")
    dv_width = v.shape[3]
    dqk, dvp = kernel_widths(d, dv_width)
    wide = max(d, dv_width) > WIDTHS[-1]
    plan = flash_bwd_plan(q.dtype, b * h, sq, sk, dqk, dvp if wide else None)
    q, k = pad_last(q, dqk), pad_last(k, dqk)
    v, out, g = (pad_last(t, dvp) for t in (v, out, g))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    check_aligned16("K7", q, k, v, out, g, dq, dk, dv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if wide:
        rc = _lib(True)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        lse.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), delta.data_ptr(), _DTYPES[q.dtype], b * h, sq, sk, dqk,
                        dvp, int(causal), 1.0 / math.sqrt(d), plan["smem_dq"], stream)
        _build.check_launch("qgemm_flash_attention_bwd_wide", rc)
    else:
        rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    delta.data_ptr(), _DTYPES[q.dtype], b * h, sq, sk, dqk, int(causal),
                    1.0 / math.sqrt(d), ROUTES[plan["route"]], plan["smem_dq"],
                    plan["smem_dkv"], stream)
        _build.check_launch("qgemm_flash_attention_bwd", rc)
    flash_attention_bwd.launches += 1
    if dqk != d:
        dq, dk = dq[..., :d].contiguous(), dk[..., :d].contiguous()
    return dq, dk, (dv if dvp == dv_width else dv[..., :dv_width].contiguous())


flash_attention_bwd.launches = 0
