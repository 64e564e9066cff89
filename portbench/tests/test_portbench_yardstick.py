"""The yardstick's counts at GPT_6_7B's shapes equal the bounds that
chip_smoke.py froze for the same shapes (its ``gemv_bounds``,
``tile_bounds`` and ``decode_attn_bytes`` formulas, and the bounds PERF.md
quotes from them), and the mfu count is 2 x the linears' parameters per
token plus attention."""

from __future__ import annotations

import json

import pytest

from portbench import spec
from portbench.yardstick import HBM_BPS, INT8_OPS, Model

OPT = json.loads((spec.HERE / "configs" / "opt-6.7b.json").read_text())["model"]
GEMMS = [(4096, 4096), (4096, 16384), (16384, 4096), (4096, 50272)]


def chip_smoke_bound_ms(m, k, n):
    """chip_smoke.py ``tile_bounds``' K1 entry (``gemv_bounds`` with no ops)."""
    moved = m * k * 2 + k * n + n * 4 + m * n * 4
    return max(moved / HBM_BPS, 2 * m * n * k / INT8_OPS) * 1e3


@pytest.mark.parametrize("m", [1, 8, 16, 32, 128, 512])
@pytest.mark.parametrize("k,n", GEMMS)
def test_linear_bound_equals_chip_smoke(m, k, n):
    ops, s = Model._linear(m, k, n)
    assert ops == 2 * m * k * n
    assert s * 1e3 == pytest.approx(chip_smoke_bound_ms(m, k, n), rel=1e-12)


def test_bounds_quoted_in_perf_md():
    # K1 m 8 at 4096 x 16384: 0.0202 ms (bytes); m 512 at 4096^2: 0.0088 (operations)
    assert Model._linear(8, 4096, 16384)[1] * 1e3 == pytest.approx(0.0202, abs=5e-5)
    assert Model._linear(512, 4096, 4096)[1] * 1e3 == pytest.approx(0.0088, abs=5e-5)


def test_decode_attention_bytes_equal_decode_attn_bytes():
    """chip_smoke.py ``decode_attn_bytes(GPT_6_7B, 8, 1000, paged=False)``:
    one layer of 8 slots at 1,000 positions is 0.0202 ms (PERF.md, K2)."""
    m = Model(OPT)
    w = m.decode_step([1000] * 8)
    per_layer = 8 * 32 * 2 * 1000 * (128 + 4) + 2 * 8 * 32 * 128 * 2
    assert w.attn_s == pytest.approx(32 * per_layer / HBM_BPS, rel=1e-12)
    assert w.attn_s / 32 * 1e3 == pytest.approx(0.0202, abs=5e-5)


def test_mfu_count_per_token():
    m = Model(OPT)
    params = 32 * (4 * 4096 * 4096 + 2 * 4096 * 16384)
    w = m.decode_step([100])
    attn = 32 * 4 * 100 * 4096
    assert w.ops == 2 * params + 2 * 4096 * 50272 + attn
    p = m.prefill(300, 256)
    pairs = sum(i + 1 for i in range(256, 300))
    assert p.ops == 44 * 2 * params + 2 * 4096 * 50272 + 32 * 4 * pairs * 4096
    assert m.prefill(10, 0).attn_s == 0 and m.decode_step([]).ops == 0
