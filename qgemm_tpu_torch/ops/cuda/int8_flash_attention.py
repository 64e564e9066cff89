"""Wrapper of the int8 flash-attention kernel
(``csrc/int8_flash_attention.cu``), row 12 of the TPU kernel table.

Replaces ``flash_attention_int8`` / ``_int8_flash_kernel`` of
``qgemm_tpu/ops/pallas/int8_flash_attention.py``: forward-only attention
whose two dots are int8. The pre-pass is JAX's: K less its per-channel
mean over the sequence (softmax-invariant), Q and K quantized per row on
their absmax (floored at 1e-6), V per channel, 1/127 folded into the row
scales; ``qk_only`` leaves P and V in bf16. On the card it is a kernel of
its own (``int8_flash_prepass_cuda``, two launches) that writes the codes
in the layout the main kernel reads (``Int8FlashCodes``); here in torch
ops it is ``int8_flash_prepass``. The kernel's output times V's channel
scale is the result.

P is quantized against the running row max at the end of each key tile,
so its codes depend on the tile width: the kernel's tile is
``KERNEL_KEY_TILE`` keys, JAX's ``jax_key_block(Sk)``. The plain version
runs the same blockwise algorithm at a given ``block_k`` (JAX's by
default). The launch plan is ``ops/cuda/int8_flash_plan.py``'s; the source
note in the .cu file says what bounds the kernels and how they are built.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from qgemm_tpu_torch.ops.cuda import _build
from qgemm_tpu_torch.ops.cuda import int8_flash_plan as plan
from qgemm_tpu_torch.ops.quantize import int8_matmul
from qgemm_tpu_torch.ops.validation import check, check_attention_4d

KERNEL_KEY_TILE = plan.KEY_TILE
_NEG_INF = -1e30
_EPS = 1e-6
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def jax_key_block(sk: int) -> int:
    """The TPU kernel's key block: min(1024, Sk rounded up to 128)."""
    return min(1024, -(-sk // 128) * 128)


class Int8FlashInputs(NamedTuple):
    """The pre-pass's output: q8, k8 int8 [B, H, S, D]; v8 int8 (or bf16
    with ``qk_only``) [B, H, Sk, Dv]; sq, sk f32 [B, H, S, 1] row scales
    with 1/127 folded in; vc f32 [B, H, 1, Dv] (None with ``qk_only``)."""
    q8: torch.Tensor
    k8: torch.Tensor
    v8: torch.Tensor
    sq: torch.Tensor
    sk: torch.Tensor
    vc: Optional[torch.Tensor]


def _absmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.clamp_min(x.abs().amax(dim=dim, keepdim=True), _EPS)


def _codes(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.round(x / c * 127.0).to(torch.int8)


def center_keys(k: torch.Tensor) -> torch.Tensor:
    """K in f32 less its per-channel mean over the sequence."""
    kf = k.to(torch.float32)
    return kf - kf.mean(dim=2, keepdim=True)


def quantize_centered(q: torch.Tensor, kc: torch.Tensor, v: torch.Tensor,
                      qk_only: bool = False) -> Int8FlashInputs:
    """The pre-pass after the centering, given the centered K ``kc`` (f32).
    x / 127 is a multiplication by 1/127, as XLA compiles JAX's division by
    the constant."""
    qf = q.to(torch.float32)
    sq, sk = _absmax(qf, -1), _absmax(kc, -1)
    q8, k8 = _codes(qf, sq), _codes(kc, sk)
    if qk_only:
        v8, vc = v.to(torch.bfloat16), None
    else:
        vf = v.to(torch.float32)
        vc = _absmax(vf, 2)
        v8 = _codes(vf, vc)
    return Int8FlashInputs(q8, k8, v8, sq * (1.0 / 127.0), sk * (1.0 / 127.0), vc)


def int8_flash_prepass(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       qk_only: bool = False) -> Int8FlashInputs:
    """JAX's pre-pass in torch ops (on the tensors' device)."""
    return quantize_centered(q, center_keys(k), v, qk_only)


def int8_flash_blockwise(x: Int8FlashInputs, causal: bool, qk_only: bool, scale: float,
                         block_k: int, out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's algorithm in plain torch, one key block of ``block_k``
    keys at a time; returns the kernel's output (before V's channel scale)
    in ``out_dtype``."""
    sq_len, sk_len = x.q8.shape[2], x.k8.shape[2]
    dev = x.q8.device
    qscale = x.sq * scale                                        # [B, H, Sq, 1]
    m = torch.full(x.q8.shape[:3] + (1,), _NEG_INF, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros(x.q8.shape[:3] + (x.v8.shape[3],), device=dev)
    qi = torch.arange(sq_len, device=dev)[:, None]
    for k0 in range(0, sk_len, block_k):
        k1 = min(sk_len, k0 + block_k)
        s32 = int8_matmul(x.q8, x.k8[:, :, k0:k1].transpose(-1, -2))
        s = s32.to(torch.float32) * qscale * x.sk[:, :, k0:k1].transpose(-1, -2)
        mask = torch.ones((sq_len, k1 - k0), dtype=torch.bool, device=dev)
        if causal:
            mask = torch.arange(k0, k1, device=dev)[None, :] <= qi
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        vb = x.v8[:, :, k0:k1]
        if qk_only:
            pv = torch.matmul(p.to(torch.bfloat16).to(torch.float32), vb.to(torch.float32))
            lsum = p.sum(dim=-1, keepdim=True)
        else:
            p8 = torch.round(p * 127.0).to(torch.int8)
            pv = int8_matmul(p8, vb).to(torch.float32)
            lsum = p8.to(torch.float32).sum(dim=-1, keepdim=True)
        l = l * alpha + lsum
        m = m_new
        acc = acc * alpha + pv
    o = acc / torch.clamp_min(l, _EPS)
    if not qk_only:
        o = o * (1.0 / 127.0)
    return o.to(out_dtype)


def _epilogue(o: torch.Tensor, x, dtype: torch.dtype) -> torch.Tensor:
    """V's channel scale, applied once outside the kernel (with int8 V);
    ``x`` is the pre-pass's output in either layout."""
    if x.vc is None:
        return o
    return (o.to(torch.float32) * x.vc.reshape(*o.shape[:2], 1, o.shape[3])).to(dtype)


def flash_attention_int8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               causal: bool = False, qk_only: bool = False,
                               block_k: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: the pre-pass, the blockwise algorithm at key
    blocks of ``block_k`` (default ``jax_key_block(Sk)``), the epilogue.
    q [B, H, Sq, D], k [B, H, Sk, D], v [B, H, Sk, Dv] -> [B, H, Sq, Dv]
    in q's dtype."""
    check_attention_4d(q, k, v)
    x = int8_flash_prepass(q, k, v, qk_only)
    o = int8_flash_blockwise(x, causal, qk_only, 1.0 / math.sqrt(q.shape[3]),
                             block_k or jax_key_block(k.shape[2]), q.dtype)
    return _epilogue(o, x, q.dtype)


class Int8FlashCodes(NamedTuple):
    """The pre-pass kernel's output, in the layout the main kernel reads:
    q8 [B, H, Sq, R] and k8 [B, H, Sk, R] int8 code rows (zero past d; R
    = ``int8_flash_plan.code_row(d)``, 128 up to d 128);
    v: V's codes transposed [B, H, DV, Skp] (DV the padded width, or dv
    rounded up to 128 where d or dv passes 128; Skp Sk
    rounded up to the key tile, zero past dv and Sk), each group of 32 keys
    in ``int8_flash_plan.key_of_position``'s order; with ``qk_only``, V in
    bf16 [B, H, Sk, W] in key order (the caller's v where it is bf16 with
    dv a multiple of 8, else a copy with W dv rounded up to 8, zero past
    dv); sq [B, H, Sq] and sk [B, H, Skp] (zero past Sk) f32 row scales
    with 1/127 folded in; vc f32 [B, H, dv] (None with ``qk_only``); d and
    dv, the true widths."""
    q8: torch.Tensor
    k8: torch.Tensor
    v: torch.Tensor
    sq: torch.Tensor
    sk: torch.Tensor
    vc: Optional[torch.Tensor]
    d: int
    dv: int


@functools.lru_cache(maxsize=None)
def _v_order(skp: int, device: str) -> torch.Tensor:
    return torch.from_numpy(plan.v_positions(skp)).to(device)


def vt_in_key_order(c: Int8FlashCodes) -> torch.Tensor:
    """V's transposed codes of ``c`` (int8 P) [B, H, DV, Skp] with their
    keys in order."""
    check(c.vc is not None, "vt_in_key_order takes int8 V codes, not qk_only's bf16 V")
    return c.v[..., torch.argsort(_v_order(c.v.shape[-1], str(c.v.device)))]


def inputs_from_codes(c: Int8FlashCodes) -> Int8FlashInputs:
    """The kernel's layout back in the pre-pass's (``Int8FlashInputs``)."""
    if c.vc is None:
        v8 = c.v[..., :c.dv].contiguous()
    else:
        v8 = vt_in_key_order(c)[..., :c.dv, :c.k8.shape[2]].transpose(-1, -2).contiguous()
    return Int8FlashInputs(c.q8[..., :c.d].contiguous(), c.k8[..., :c.d].contiguous(), v8,
                           c.sq[..., None], c.sk[..., :c.k8.shape[2], None],
                           None if c.vc is None else c.vc[:, :, None, :])


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "qgemm_int8_flash_prepass": [_P] * 3 + [_I] + [_P] * 8 + [_I] * 9 + [_P],
    "qgemm_int8_flash_attention": [_P] * 6 + [_I] * 11 + [ctypes.c_float, _I, _P],
}


def _lib(name: str):
    fn = getattr(_build.library("int8_flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
    return fn


def int8_flash_prepass_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            qk_only: bool = False) -> Int8FlashCodes:
    """The pre-pass kernel on CUDA q [B, H, Sq, d], k [B, H, Sk, d], v [B, H,
    Sk, dv] (one dtype, f32 or bf16): its codes and scales in the main
    kernel's layout. Two launches (per 65,535 batch*heads), the column pass
    then the row pass, each counted in ``int8_flash_prepass_cuda.launches``."""
    b, h, sq_len, d = q.shape
    sk_len, dv = k.shape[2], v.shape[3]
    check(q.dtype in _OUT_DTYPES and k.dtype == v.dtype == q.dtype,
          f"the int8 flash pre-pass takes float32 or bfloat16 q/k/v of one dtype, got "
          f"{q.dtype}/{k.dtype}/{v.dtype}")
    pre = plan.prepass_plan(b * h, sq_len, sk_len, d, dv, qk_only, q.dtype == torch.float32)
    # the row pass's 8- and 16-byte loads need aligned bases
    q, k, v = (t.contiguous() if t.contiguous().data_ptr() % 16 == 0 else t.clone()
               for t in (q, k, v))
    dev = q.device
    q8 = torch.empty((b, h, sq_len, pre["code_row"]), dtype=torch.int8, device=dev)
    k8 = torch.empty((b, h, sk_len, pre["code_row"]), dtype=torch.int8, device=dev)
    vw = pre["v_width"]
    if not qk_only:
        vt = torch.empty((b, h, vw, pre["skp"]), dtype=torch.int8, device=dev)
    else:   # the caller's bf16 v as it is, or a bf16 copy the V blocks write
        vt = torch.empty((b, h, sk_len, vw), dtype=torch.bfloat16, device=dev) if vw else v
    sqs = torch.empty((b, h, sq_len), dtype=torch.float32, device=dev)
    sks = torch.empty((b, h, pre["skp"]), dtype=torch.float32, device=dev)
    vc = None if qk_only else torch.empty((b, h, dv), dtype=torch.float32, device=dev)
    scratch = torch.empty((pre["scratch_floats"],), dtype=torch.float32, device=dev)
    ksum = scratch[:b * h * pre["nchunk"] * d]
    vmax = None if qk_only else scratch[b * h * pre["nchunk"] * d:]
    rc = _lib("qgemm_int8_flash_prepass")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _OUT_DTYPES[q.dtype], q8.data_ptr(),
        k8.data_ptr(), vt.data_ptr(), sqs.data_ptr(), sks.data_ptr(),
        None if qk_only else vc.data_ptr(), ksum.data_ptr(),
        None if qk_only else vmax.data_ptr(), b * h, sq_len, sk_len, d, dv, vw,
        pre["skp"], pre["nchunk"], int(qk_only), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("qgemm_int8_flash_prepass", rc)
    int8_flash_prepass_cuda.launches += pre["launches"]
    return Int8FlashCodes(q8, k8, vt, sqs, sks, vc, d, dv)


int8_flash_prepass_cuda.launches = 0


def int8_flash_attention_cuda(x: Int8FlashCodes, causal: bool, scale: float,
                              out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the main kernel on a pre-pass's CUDA codes
    (``Int8FlashCodes``); returns its output [B, H, Sq, dv] in
    ``out_dtype`` (before V's channel scale; V's channels in chunks of
    ``dv_pad``, a block each, in one launch). Counts each launch in
    ``int8_flash_attention_cuda.launches``."""
    b, h, sq_len, _ = x.q8.shape
    sk_len, skp = x.k8.shape[2], x.sk.shape[2]
    check(out_dtype in _OUT_DTYPES, f"the int8 flash kernel writes float32 or bfloat16, "
          f"got {out_dtype}")
    p_int8 = x.vc is not None
    main = plan.flash_plan(b * h, sq_len, sk_len, x.d, x.dv, causal, p_int8)
    out = torch.empty((b, h, sq_len, x.dv), dtype=out_dtype, device=x.q8.device)
    rc = _lib("qgemm_int8_flash_attention")(
        x.q8.data_ptr(), x.k8.data_ptr(), x.v.data_ptr(), x.sq.data_ptr(), x.sk.data_ptr(),
        out.data_ptr(), _OUT_DTYPES[out_dtype], int(p_int8), b * h, sq_len, sk_len, skp,
        main["d_pad"], main["dv_pad"], x.dv, x.v.shape[2] if p_int8 else x.v.shape[3],
        int(causal), scale, main["smem"],
        torch.cuda.current_stream(x.q8.device).cuda_stream)
    _build.check_launch("qgemm_int8_flash_attention", rc)
    int8_flash_attention_cuda.launches += 1
    return out


int8_flash_attention_cuda.launches = 0


def flash_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False, qk_only: bool = False) -> torch.Tensor:
    """q [B, H, Sq, D], k [B, H, Sk, D], v [B, H, Sk, Dv] (f32 or bf16) ->
    [B, H, Sq, Dv] in q's dtype: int8 flash attention, causal (key j
    attends query i iff j <= i) or full; ``qk_only`` quantizes only QK^T.
    CPU tensors run the plain version; CUDA tensors run the pre-pass kernel
    and launch the main kernel (D, Dv up to 1,024) or raise."""
    check_attention_4d(q, k, v)
    if not q.is_cuda:
        return flash_attention_int8_plain(q, k, v, causal, qk_only)
    check(q.dtype in _OUT_DTYPES and k.dtype == v.dtype == q.dtype,
          f"the int8 flash kernel takes float32 or bfloat16 q/k/v of one dtype, got "
          f"{q.dtype}/{k.dtype}/{v.dtype}")
    check(k.is_cuda and v.is_cuda and q.device == k.device == v.device,
          "flash_attention_int8: q, k and v must lie on one CUDA device")
    x = int8_flash_prepass_cuda(q, k, v, qk_only)
    o = int8_flash_attention_cuda(x, causal, 1.0 / math.sqrt(q.shape[3]), q.dtype)
    return _epilogue(o, x, q.dtype)
