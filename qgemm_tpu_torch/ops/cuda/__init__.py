"""Wrappers of the hand-written CUDA kernels (``csrc/``).

Each wrapper runs its kernel on CUDA tensors (or raises) and its plain
PyTorch version on CPU tensors, and counts its kernel launches in the
``launches`` attribute of the function that launches, so a run can show
which path it took. K1's wrapper is ``ops.quantize.quantized_matmul_prequant``
(its launch is ``quantized_matmul.quantized_matmul_cuda``); K4's is
``ops.quantize.quantized_matmul_prequant_w4`` (its launch is
``w4a8_matmul.w4a8_matmul_cuda``); K2's and K3's are
``decode_attention.decode_attention`` and ``flash_attention.flash_attention_fwd``;
K7's is ``flash_attention_bwd.flash_attention_bwd`` (K3 and K7 together are
the differentiable ``flash_attention.flash_attention``).
K5 has two wrappers, ``paged_decode_attention.paged_decode_attention`` and
``paged_decode_attention.paged_decode_attention_ragged``, each with its own
count; K6's is ``paged_context_attention.paged_context_attention``;
K8's is ``expert_matmul.grouped_quantized_matmul`` and K9's
``col_quantize.col_quantize``. The op layer's row kernels are
``softmax.softmax`` (row 14) and ``layernorm.layernorm_residual`` (row 13);
the int8 flash attention's wrapper is
``int8_flash_attention.flash_attention_int8`` (row 12; its launches are
``int8_flash_attention.int8_flash_prepass_cuda``, the pre-pass kernel, and
``int8_flash_attention.int8_flash_attention_cuda``, the main kernel).
"""

from __future__ import annotations


def _launchers() -> dict:
    from qgemm_tpu_torch.ops.cuda import (col_quantize, decode_attention, expert_matmul,
                                          flash_attention, flash_attention_bwd,
                                          int8_flash_attention, layernorm,
                                          paged_context_attention, paged_decode_attention,
                                          quantized_matmul, softmax, w4a8_matmul)
    return {"quantized_matmul": quantized_matmul.quantized_matmul_cuda,
            "quantized_matmul_given_cx": quantized_matmul.given_cx,
            "decode_attention": decode_attention.decode_attention,
            "flash_attention": flash_attention.flash_attention_fwd,
            "w4a8_matmul": w4a8_matmul.w4a8_matmul_cuda,
            "paged_decode_attention": paged_decode_attention.paged_decode_attention,
            "paged_decode_attention_ragged":
                paged_decode_attention.paged_decode_attention_ragged,
            "paged_context_attention": paged_context_attention.paged_context_attention,
            "flash_attention_bwd": flash_attention_bwd.flash_attention_bwd,
            "expert_matmul": expert_matmul.grouped_quantized_matmul,
            "col_quantize": col_quantize.col_quantize,
            "softmax": softmax.softmax,
            "layernorm": layernorm.layernorm_residual,
            "int8_flash_prepass": int8_flash_attention.int8_flash_prepass_cuda,
            "int8_flash_attention": int8_flash_attention.int8_flash_attention_cuda}


def reset_launch_counts() -> None:
    for fn in _launchers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _launchers().items()}


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` (name -> launches, as ``launch_counts`` names them) to
    the counts: a replayed CUDA graph launches its kernels without running
    their wrappers (``serving/decode_graph.py``)."""
    fns = _launchers()
    for name, n in delta.items():
        fns[name].launches += n
