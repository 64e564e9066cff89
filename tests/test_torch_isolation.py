"""The port stands alone: it imports neither JAX nor the JAX package, runs on
the GPU unless told otherwise, and its kernel wrappers take the plain path
only for CPU tensors (launch counters stay at 0)."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import qgemm_tpu_torch
from qgemm_tpu_torch.examples import quantize_demo, serve_gpt, train_mnist
from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
from qgemm_tpu_torch.models.mlp import MLP
from qgemm_tpu_torch.models.moe import MoEFeedForward
from qgemm_tpu_torch.ops.quantize import absmax_scales
from qgemm_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from qgemm_tpu_torch.ops import cuda as kernels
from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize
from qgemm_tpu_torch.ops.cuda.decode_attention import decode_attention
from qgemm_tpu_torch.ops.cuda.expert_matmul import grouped_quantized_matmul
from qgemm_tpu_torch.ops.cuda.flash_attention import flash_attention_fwd
from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import flash_attention_bwd
from qgemm_tpu_torch.ops.cuda.int8_flash_attention import flash_attention_int8
from qgemm_tpu_torch.ops.cuda.layernorm import layernorm_residual
from qgemm_tpu_torch.ops.cuda.paged_context_attention import paged_context_attention
from qgemm_tpu_torch.ops.cuda.paged_decode_attention import paged_decode_attention
from qgemm_tpu_torch.ops.cuda.softmax import softmax
from qgemm_tpu_torch.ops.kv_cache import quantize_kv
from qgemm_tpu_torch.ops.quantize import (quantize_weights, quantize_weights_int4,
                                          quantized_matmul, quantized_matmul_prequant,
                                          quantized_matmul_prequant_outlier,
                                          quantized_matmul_prequant_w4)
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from qgemm_tpu_torch.serving.paged_cache import init_paged_cache, paged_write_step
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params, mlp_from_jax_params
from qgemm_tpu_torch.utils.profiling import bench_ms
from qgemm_tpu_torch.utils.testing import use_test_threads

use_test_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = GPTConfig(vocab_size=97, d_model=32, n_heads=4, d_ff=64, n_layers=2,
                max_seq_len=64)
MOE = GPTConfig(**{**CFG.__dict__, "n_experts": 4})


def test_port_imports_no_jax():
    mods = sorted(m.name for m in pkgutil.walk_packages(qgemm_tpu_torch.__path__,
                                                        "qgemm_tpu_torch."))
    assert "qgemm_tpu_torch.serving.engine" in mods and len(mods) >= 20
    for m in ("qgemm_tpu_torch.ops.cuda.flash_attention_bwd", "qgemm_tpu_torch.ops.cross_entropy",
              "qgemm_tpu_torch.models.optim", "qgemm_tpu_torch.utils.checkpoint",
              "qgemm_tpu_torch.examples.train_gpt_lm", "qgemm_tpu_torch.models.moe",
              "qgemm_tpu_torch.ops.cuda.expert_matmul", "qgemm_tpu_torch.ops.cuda.col_quantize",
              "qgemm_tpu_torch.ops.cuda.softmax", "qgemm_tpu_torch.ops.cuda.layernorm",
              "qgemm_tpu_torch.ops.cuda.int8_flash_attention", "qgemm_tpu_torch.ops.elemwise",
              "qgemm_tpu_torch.ops.reduction", "qgemm_tpu_torch.ops.matmul",
              "qgemm_tpu_torch.serving.seq2seq", "qgemm_tpu_torch.examples.transformer_demo",
              "qgemm_tpu_torch.serving.native", "qgemm_tpu_torch.data.mnist",
              "qgemm_tpu_torch.data.native", "qgemm_tpu_torch.models.mlp",
              "qgemm_tpu_torch.utils.config", "qgemm_tpu_torch.utils.host_build",
              "qgemm_tpu_torch.examples.train_mnist", "qgemm_tpu_torch.examples.serve_gpt",
              "qgemm_tpu_torch.examples.quantize_demo", "qgemm_tpu_torch.parallel",
              "qgemm_tpu_torch.parallel.mesh", "qgemm_tpu_torch.parallel.tp_ops",
              "qgemm_tpu_torch.parallel.sharding", "qgemm_tpu_torch.parallel.collectives",
              "qgemm_tpu_torch.parallel.expert", "qgemm_tpu_torch.parallel.ring_attention",
              "qgemm_tpu_torch.parallel.ulysses", "qgemm_tpu_torch.parallel.pipeline",
              "qgemm_tpu_torch.parallel.dryrun"):
        assert m in mods, m
    # the worker modules the tests' spawned ranks import (tests/) too
    code = ("import importlib, sys\n"
            "sys.path.insert(0, 'tests')\n"
            f"for m in {mods!r} + ['chip_smoke', 'torch_tp_workers', 'torch_parallel_workers']:\n"
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
                 lambda: gpt_from_jax_params({}, CFG),
                 lambda: MLP.init(0, [4, 3]),
                 lambda: mlp_from_jax_params({"layers/0/w": np.zeros((4, 3), np.float32)}),
                 lambda: train_mnist.main(["--epochs", "1"]),
                 lambda: quantize_demo.main([]),
                 lambda: serve_gpt.main(["--layers", "1"]),
                 lambda: GPT.init(MOE),
                 lambda: GPT.init_quantized(MOE),
                 lambda: gpt_from_jax_params({}, MOE),
                 lambda: make_mesh(),
                 lambda: initialize_distributed(world_size=1, rank=0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    model = GPT.init(CFG, device="cpu").quantize()
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPT.init(CFG, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_ms(lambda: None)   # never a CPU time under a device metric's name
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(model, paged=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_paged_cache(2, 64, 4, 2, 2)


def test_wrappers_take_plain_path_on_cpu_and_count_nothing():
    kernels.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 64, generator=g)
    wq = quantize_weights(torch.randn(64, 24, generator=g))
    assert quantized_matmul_prequant(x, wq).shape == (4, 24)
    assert quantized_matmul_prequant(x, wq, cx=absmax_scales(x, -1)).shape == (4, 24)
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
    cache = init_paged_cache(2, 64, 4, 2, 2, page_size=16, kv_bits=4, device="cpu")
    cache.page_table[0, 0], cache.page_table[1, 0] = 1, 2
    paged_write_step(cache, kq[:, :, :1].float(), vq[:, :, :1].float(), torch.tensor([3, 0]))
    q1 = torch.randn(2, 4, 1, 64, generator=g)
    assert paged_decode_attention(q1, cache, torch.tensor([4, 1])).shape == (2, 4, 1, 64)
    q2 = torch.cat([q, q])
    assert paged_context_attention(q2, cache, torch.tensor([5, 5]), 0).shape == q2.shape
    dq, dk, dv = flash_attention_bwd(q, q, q, o, lse, torch.ones_like(o), causal=True)
    assert dq.shape == dk.shape == dv.shape == q.shape
    qt, c = col_quantize(torch.randn(3, 64, 24, generator=g))
    assert qt.shape == (3, 24, 64) and c.shape == (3, 1, 24)
    assert grouped_quantized_matmul(torch.randn(3, 5, 64, generator=g), qt, c,
                                    relu=True).shape == (3, 5, 24)
    assert quantized_matmul(x, torch.randn(64, 24, generator=g)).shape == (4, 24)
    assert quantized_matmul(x[:, :3], torch.randn(3, 2, generator=g)).shape == (4, 2)
    assert softmax(x).shape == layernorm_residual(x, x, torch.ones(64)).shape == (4, 64)
    q32 = torch.randn(1, 2, 5, 32, generator=g)
    assert flash_attention_int8(q32, q32, torch.randn(1, 2, 5, 48, generator=g),
                                causal=True).shape == (1, 2, 5, 48)
    assert kernels.launch_counts() == {"quantized_matmul": 0,
                                       "quantized_matmul_given_cx": 0, "decode_attention": 0,
                                       "flash_attention": 0, "w4a8_matmul": 0,
                                       "paged_decode_attention": 0,
                                       "paged_decode_attention_ragged": 0,
                                       "paged_context_attention": 0,
                                       "flash_attention_bwd": 0, "expert_matmul": 0,
                                       "col_quantize": 0, "softmax": 0, "layernorm": 0,
                                       "int8_flash_prepass": 0,
                                       "int8_flash_attention": 0}


def test_mlp_and_examples_cpu_path_launch_no_kernel():
    """The int8 MLP, the MNIST example (training, then the int8 evaluation)
    and the dynamic GEMM demo on the CPU launch no kernel."""
    kernels.reset_launch_counts()
    model = MLP.init(0, [784, 16, 10], device="cpu")
    assert model.quantize()(torch.zeros(3, 784)).shape == (3, 10)
    res = train_mnist.main(["--epochs", "1", "--device", "cpu", "--data", ROOT])
    assert res["int8_test_acc"] > 0.5 and res["device"] == "cpu"
    assert quantize_demo.main(["-c"])["mean_error"] < 0.01
    assert sum(kernels.launch_counts().values()) == 0


def test_model_cpu_path_launches_no_kernel():
    kernels.reset_launch_counts()
    model = GPT.init(CFG, seed=1, device="cpu").quantize()
    assert model.generate(torch.tensor([[1, 2, 3]]), 4, quantized_cache=True).shape == (1, 4)
    assert model.forward(torch.tensor([[4, 5]])).shape == (1, 2, 97)
    assert sum(kernels.launch_counts().values()) == 0


def test_moe_model_cpu_path_launches_no_kernel():
    """An int8 MoE GPT on the CPU (K9 quantizes its experts, K8 runs its
    expert FFN on CUDA tensors) serves through the engine, dense and paged,
    and launches no kernel."""
    kernels.reset_launch_counts()
    model = GPT.init_quantized(MOE, seed=5, device="cpu")
    assert all(isinstance(b.ffn, MoEFeedForward) and b.ffn.is_quantized
               for b in model.blocks)
    for kw in ({}, {"paged": True, "page_size": 8}):
        eng = ContinuousBatchingEngine(model, max_slots=2, max_seq_len=48, device="cpu", **kw)
        reqs = [Request(prompt=list(range(1, 11 + 3 * i)), max_new_tokens=4) for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        assert all(r.error is None and len(r.generated) == 4 for r in reqs)
    assert sum(kernels.launch_counts().values()) == 0


def test_w4a8_outlier_model_cpu_path_launches_no_kernel():
    kernels.reset_launch_counts()
    model = GPT.init(CFG, seed=2, device="cpu").quantize(bits=4, outlier_threshold=6.0)
    assert model.generate(torch.tensor([[1, 2, 3]]), 4, quantized_cache=True).shape == (1, 4)
    assert sum(kernels.launch_counts().values()) == 0


def test_paged_engine_cpu_run_launches_no_kernel():
    """A paged CPU run through every paged path (prefix hit, chunked and
    overlapped admission, int4 pools, over-commit) launches no kernel."""
    kernels.reset_launch_counts()
    model = GPT.init(CFG, seed=3, device="cpu").quantize()
    eng = ContinuousBatchingEngine(model, max_slots=2, max_seq_len=48, paged=True,
                                   page_size=8, kv_bits=4, chunked_prefill=8,
                                   overlap_admission=True, overcommit=True, n_pages=9,
                                   device="cpu")
    system = list(range(1, 17))
    reqs = [Request(prompt=system + [20 + i] * (1 + 9 * i), max_new_tokens=12)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.error is None and len(r.generated) == 12 for r in reqs)
    assert eng.stats["prefix_hits"] > 0
    assert sum(kernels.launch_counts().values()) == 0


def test_training_step_cpu_path_launches_no_kernel():
    """A CPU training step (forward, the cross-entropy's backward, the
    attention backward, Adam) launches no kernel, MHA and GQA; the serving
    entry points keep no autograd graph."""
    from qgemm_tpu_torch.examples.train_gpt_lm import train_step
    from qgemm_tpu_torch.models.optim import Adam
    kernels.reset_launch_counts()
    for n_kv in (0, 2):
        model = GPT.init(GPTConfig(**{**CFG.__dict__, "n_kv_heads": n_kv}), seed=4,
                         device="cpu")
        params = [p for _, p in model.named_trainable()]
        opt = Adam(lr=1e-3)
        state, loss = train_step(model, params, opt, opt.init(params),
                                 torch.randint(0, 97, (2, 9)))
        assert state.t == 1 and torch.isfinite(loss)
        assert all(p.grad is not None for p in params)
        logits, _ = model.prefill(torch.tensor([[1, 2, 3]]), model.init_cache(1, 8))
        assert not logits.requires_grad
        assert not model.generate(torch.tensor([[1, 2]]), 3).requires_grad
    assert sum(kernels.launch_counts().values()) == 0
