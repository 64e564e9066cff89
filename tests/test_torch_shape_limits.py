"""The padding behind the lifted shape limits, on the CPU (the kernels run
only on the card; chip_smoke.py's ``shape_limits`` phase holds them there):

* K1 and K8 at any K: the wrappers zero-pad x and the weight codes along K
  to a multiple of 16 when it is not one. Zeros change neither a row's
  absmax nor an int32 sum, so the plain version on the padded operands
  equals it on the unpadded ones bit for bit.
* Attention at any head width up to 256 (and Dv != D for K3/K7): the
  kernels run at the padded width 32, 64, 128 or 256 with the softmax scale of
  the true width; zero columns add nothing to a score, so the padded plain
  versions sliced back equal the unpadded ones within 1e-6. Past 256 the
  decode kernels (K2, K5) run at 512 or 1024, and K3, K7 and K6 at the
  width rounded up to a multiple of 64 (q and k to one, v to another for
  K3 and K7).
"""

import math

import numpy as np
import pytest
import torch

from qgemm_tpu_torch.ops.cuda.decode_attention import decode_attention_plain
from qgemm_tpu_torch.ops.cuda.expert_matmul import grouped_quantized_matmul_plain
from qgemm_tpu_torch.ops.cuda.flash_attention import flash_attention_plain
from qgemm_tpu_torch.ops.cuda.flash_attention_bwd import flash_attention_bwd_plain, kernel_widths
from qgemm_tpu_torch.ops.cuda.paged_plan import k6_width
from qgemm_tpu_torch.ops.kv_cache import quantize_kv
from qgemm_tpu_torch.ops.quantize import (QuantizedWeight, k_tile, quantize_weights,
                                          quantized_matmul, quantized_matmul_plain)
from qgemm_tpu_torch.ops.validation import pad_last, padded_head_dim
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads

use_test_threads()


def _t(shape, seed, scale=1.0):
    return torch.from_numpy(
        (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32))


def test_padded_widths():
    assert [k_tile(k) for k in (1, 3, 16, 17, 784)] == [16, 16, 16, 32, 784]
    assert [padded_head_dim(d) for d in (1, 2, 32, 33, 64, 65, 100, 128, 129, 160, 256, 257,
                                         384, 512, 513, 576, 1024)] == \
        [32, 32, 32, 64, 64, 128, 128, 128, 256, 256, 256, 512, 512, 512, 1024, 1024, 1024]
    with pytest.raises(ValueError, match="head_dim"):
        padded_head_dim(1025)
    assert [kernel_widths(d, dv) for d, dv in ((100, 20), (130, 256), (257, 64), (576, 512),
                                                 (2000, 3))] == [
        (128, 128), (256, 256), (320, 64), (576, 512), (2048, 64)]
    assert [k6_width(d) for d in (2, 160, 256, 257, 384, 1000)] == [32, 256, 256, 320, 384,
                                                                    1024]


@pytest.mark.parametrize("k", [3, 17, 784])
@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
def test_k_padding_keeps_k1_bits(k, rounding):
    x, w = _t((5, k), seed=k), _t((k, 7), seed=k + 1, scale=0.2)
    wq = quantize_weights(w)
    want = quantized_matmul_plain(x, wq, rounding)
    kp = k_tile(k)
    padded = quantized_matmul_plain(pad_last(x, kp), QuantizedWeight(pad_last(wq.qt, kp), wq.c),
                                    rounding)
    assert torch.equal(padded, want)


def test_quantize_demo_runs_on_cpu():
    """The reference's quantize demo (examples/quantize_demo.py's default,
    3x3 @ 3x2) through the dynamic matmul: K9 + K1 on the card, where
    chip_smoke.py's shape_limits phase printed these same values."""
    x = torch.tensor([[2.0, -1.0, -1.0], [0.0, 3.0, 2.0], [-1.0, -1.0, 0.0]])
    w = torch.tensor([[-1.0, 0.0], [0.0, -2.0], [-1.0, 2.0]])
    assert_allclose(quantized_matmul(x, w), [[-0.9921259880065918, 0.0],
                                             [-2.007874011993408, -1.9842519760131836],
                                             [1.0, 2.0]])


@pytest.mark.parametrize("k", [3, 17])
def test_k_padding_keeps_k8_bits(k):
    e, c, n = 3, 4, 6
    x = _t((e, c, k), seed=k)
    wt = torch.from_numpy(np.random.default_rng(k).integers(-127, 128, (e, n, k)).astype(np.int8))
    cw = _t((e, 1, n), seed=k + 2).abs() + 0.1
    want = grouped_quantized_matmul_plain(x, wt, cw, relu=True)
    kp = k_tile(k)
    assert torch.equal(grouped_quantized_matmul_plain(pad_last(x, kp), pad_last(wt, kp), cw, relu=True),
                       want)


@pytest.mark.parametrize("d,dv", [(2, 2), (32, 32), (32, 64), (48, 48), (100, 20), (160, 160),
                                  (256, 160), (130, 256), (300, 300), (576, 512), (64, 320),
                                  (1000, 40)])
@pytest.mark.parametrize("causal", [False, True])
def test_head_padding_flash_fwd_bwd(d, dv, causal):
    q, k, v = _t((1, 2, 9, d), 1), _t((1, 2, 11, d), 2), _t((1, 2, 11, dv), 3)
    g = _t((1, 2, 9, dv), 4)
    o, lse = flash_attention_plain(q, k, v, causal)
    dqk, dvp = kernel_widths(d, dv)
    scale = 1.0 / math.sqrt(d)
    qp, kp = pad_last(q, dqk), pad_last(k, dqk)
    vp, gp = pad_last(v, dvp), pad_last(g, dvp)
    op, lsep = flash_attention_plain(qp, kp, vp, causal, scale=scale)
    assert_allclose(op[..., :dv], o)
    assert float(op[..., dv:].abs().sum()) == 0.0
    assert_allclose(lsep, lse)
    grads = flash_attention_bwd_plain(q, k, v, o, lse, g, causal)
    padded = flash_attention_bwd_plain(qp, kp, vp, op, lsep, gp, causal, scale=scale)
    for name, want, got, w in zip(("dq", "dk", "dv"), grads, padded, (d, d, dv)):
        assert_allclose(got[..., :w], want, msg=name)
        assert float(got[..., w:].abs().sum()) == 0.0, name


@pytest.mark.parametrize("d", [2, 32, 80, 160, 256, 384, 576, 1024])
def test_head_padding_decode(d):
    """K2 reads the cache at its true width and treats the columns past it
    as zeros: the same as a zero-padded cache."""
    q, kv = _t((2, 4, 1, d), 5), _t((2, 2, 7, d), 6)
    (kq, kc), (vq, vc) = quantize_kv(kv), quantize_kv(kv * 0.5)
    lengths = torch.tensor([3, 7])
    want = decode_attention_plain(q, kq, vq, lengths, kc, vc)
    dp = padded_head_dim(d)
    got = decode_attention_plain(pad_last(q, dp), pad_last(kq, dp), pad_last(vq, dp), lengths,
                                 kc, vc, scale=1.0 / math.sqrt(d))
    assert_allclose(got[..., :d], want)
