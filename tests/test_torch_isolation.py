"""The port stands alone: it imports neither JAX nor the JAX package, runs on
the GPU unless told otherwise, and its kernel wrappers take the plain path
only for CPU tensors (launch counters stay at 0)."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import qgemm_tpu_torch
from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
from qgemm_tpu_torch.ops import cuda as kernels
from qgemm_tpu_torch.ops.cuda.decode_attention import decode_attention
from qgemm_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd
from qgemm_tpu_torch.ops.kv_cache import quantize_kv
from qgemm_tpu_torch.ops.quantize import (quantize_weights, quantize_weights_int4,
                                          quantized_matmul_prequant,
                                          quantized_matmul_prequant_outlier,
                                          quantized_matmul_prequant_w4)
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params
from qgemm_tpu_torch.utils.profiling import bench_ms
from qgemm_tpu_torch.utils.testing import use_test_threads

use_test_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = GPTConfig(vocab_size=97, d_model=32, n_heads=4, d_ff=64, n_layers=2,
                max_seq_len=64)


def test_port_imports_no_jax():
    mods = sorted(m.name for m in pkgutil.walk_packages(qgemm_tpu_torch.__path__,
                                                        "qgemm_tpu_torch."))
    assert "qgemm_tpu_torch.serving.engine" in mods and len(mods) >= 20
    code = ("import importlib, sys\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'qgemm_tpu' or m.startswith('qgemm_tpu.')]\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "[]"


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    for make in (lambda: GPT.init(CFG),
                 lambda: GPT.init_quantized(CFG),
                 lambda: gpt_from_jax_params({}, CFG)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    model = GPT.init(CFG, device="cpu").quantize()
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPT.init(CFG, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_ms(lambda: None)   # never a CPU time under a device metric's name


def test_wrappers_take_plain_path_on_cpu_and_count_nothing():
    kernels.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 64, generator=g)
    wq = quantize_weights(torch.randn(64, 24, generator=g))
    assert quantized_matmul_prequant(x, wq).shape == (4, 24)
    wq4 = quantize_weights_int4(torch.randn(64, 24, generator=g))
    assert quantized_matmul_prequant_w4(x, wq4).shape == (4, 24)
    for w in (wq, wq4):
        assert quantized_matmul_prequant_outlier(x * 10, w, threshold=6.0).shape == (4, 24)
    (kq, kc), (vq, vc) = quantize_kv(torch.randn(2, 2, 9, 64, generator=g)), \
        quantize_kv(torch.randn(2, 2, 9, 64, generator=g))
    out = decode_attention(torch.randn(2, 4, 1, 64, generator=g), kq, vq,
                           torch.tensor([3, 9]), kc=kc, vc=vc)
    assert out.shape == (2, 4, 1, 64)
    q = torch.randn(1, 2, 5, 64, generator=g)
    o, lse = flash_attention_fwd(q, q, q, causal=True)
    assert o.shape == q.shape and lse.shape == (1, 2, 5)
    assert kernels.launch_counts() == {"quantized_matmul": 0, "decode_attention": 0,
                                       "flash_attention": 0, "w4a8_matmul": 0}


def test_model_cpu_path_launches_no_kernel():
    kernels.reset_launch_counts()
    model = GPT.init(CFG, seed=1, device="cpu").quantize()
    assert model.generate(torch.tensor([[1, 2, 3]]), 4, quantized_cache=True).shape == (1, 4)
    assert model.forward(torch.tensor([[4, 5]])).shape == (1, 2, 97)
    assert sum(kernels.launch_counts().values()) == 0


def test_w4a8_outlier_model_cpu_path_launches_no_kernel():
    kernels.reset_launch_counts()
    model = GPT.init(CFG, seed=2, device="cpu").quantize(bits=4, outlier_threshold=6.0)
    assert model.generate(torch.tensor([[1, 2, 3]]), 4, quantized_cache=True).shape == (1, 4)
    assert sum(kernels.launch_counts().values()) == 0
