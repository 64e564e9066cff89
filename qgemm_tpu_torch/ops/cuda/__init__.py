"""Wrappers of the hand-written CUDA kernels (``csrc/``).

Each wrapper runs its kernel on CUDA tensors (or raises) and its plain
PyTorch version on CPU tensors, and counts its kernel launches in the
``launches`` attribute of the function that launches, so a run can show
which path it took. K1's wrapper is ``ops.quantize.quantized_matmul_prequant``
(its launch is ``quantized_matmul.quantized_matmul_cuda``); K4's is
``ops.quantize.quantized_matmul_prequant_w4`` (its launch is
``w4a8_matmul.w4a8_matmul_cuda``); K2's and K3's are
``decode_attention.decode_attention`` and ``flash_attention.flash_attention_fwd``.
"""

from __future__ import annotations


def _launchers() -> dict:
    from qgemm_tpu_torch.ops.cuda import (decode_attention, flash_attention,
                                          quantized_matmul, w4a8_matmul)
    return {"quantized_matmul": quantized_matmul.quantized_matmul_cuda,
            "decode_attention": decode_attention.decode_attention,
            "flash_attention": flash_attention.flash_attention_fwd,
            "w4a8_matmul": w4a8_matmul.w4a8_matmul_cuda}


def reset_launch_counts() -> None:
    for fn in _launchers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _launchers().items()}
