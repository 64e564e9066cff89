"""Launch plan of kernel K9 (qgemm_tpu_torch/ops/cuda/quant_plan.py): its
cluster slabs cover each (k, column) of a weight once and nothing past k
or n; the shared memory fits the H100 beside the kernel's static arrays;
K past one cluster's shared memory takes the two_pass route, and the route
is named; the plan's constants are the compiled ones; the plan refuses
what the C entry refuses. One more test runs the cluster route's
algorithm in numpy (each slab's column maxima, merged in rank order, then
each slab quantized on its own) against the plain version and the JAX
package's Pallas kernel (interpret mode), NaN and inf columns included.
The plan is pure Python, so these run without a card; the card holds the
kernel to the plain version through chip_smoke.py's K9 checks."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.ops.pallas.quantized_matmul import col_quantize_pallas
from qgemm_tpu_torch.ops.cuda import _build
from qgemm_tpu_torch.ops.cuda import quant_plan as qp
from qgemm_tpu_torch.ops.cuda.col_quantize import col_quantize_plain
from qgemm_tpu_torch.utils.testing import use_test_threads

use_test_threads()

CSRC = Path(qp.__file__).resolve().parents[2] / "csrc"
SMEM_LIMIT = 232448        # the shared memory one H100 block may use
KS = (1, 3, 17, 784, 2048, 4096, qp.CLUSTER_MAX_K)
DTYPES = ("float32", "bfloat16")


def slab_range(plan: dict, rank: int, k: int) -> tuple:
    """Rows [start, stop) of K that block ``rank`` of a cluster holds (the
    kernel's k0 = rank * slab_rows, rows = min(k, k0 + slab_rows) - k0):
    empty where the cluster's last slabs run past k."""
    start = rank * plan["slab_rows"]
    return (min(start, k), min(k, start + plan["slab_rows"]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", KS)
def test_cluster_slabs_cover_each_k_and_column_once(k, dtype):
    n = 200                                        # a ragged last strip in both dtypes
    p = qp.col_quantize_plan(3, k, n, dtype)
    assert p["route"] == "cluster"
    cols = p["strip_cols"]
    assert cols * (4 if dtype == "float32" else 2) == qp.STRIP_BYTES
    strips = p["grid"][0] // (p["cluster"] * 3)   # one dimension: strips' clusters, then e
    assert p["grid"] == (strips * p["cluster"] * 3,) and p["threads"] == qp.THREADS
    assert p["cluster"] in (1, 2, 4, 8) and p["slab_rows"] % qp.ROW_ALIGN == 0
    covered = np.zeros((k, n), np.int64)
    for s in range(strips):
        c0, c1 = s * cols, min(n, (s + 1) * cols)
        assert c0 < n
        for r in range(p["cluster"]):
            a, z = slab_range(p, r, k)
            assert z - a <= p["slab_rows"]
            covered[a:z, c0:c1] += 1
    assert (covered == 1).all()
    # the fewest blocks (a power of 2, at most 8) that keep a slab near 256 rows
    assert p["cluster"] == 1 or -(-k // (p["cluster"] // 2)) > qp.TARGET_ROWS


@pytest.mark.parametrize("k", [qp.CLUSTER_MAX_K + 1, 16384, 20000, 1 << 20])
def test_k_past_one_cluster_takes_the_two_pass_route(k):
    p = qp.col_quantize_plan(2, k, 96, "float32")
    assert p["route"] == "two_pass" and p["cmax_words"] == 2 * 96
    assert qp.col_quantize_plan(2, qp.CLUSTER_MAX_K, 96, "float32")["route"] == "cluster"
    assert qp.col_quantize_args(2, k, 96, "float32")[0] == qp.ROUTES.index("two_pass")


def test_shared_memory_fits_beside_the_static_arrays():
    """The slab (rows x 128 bytes) and the kernel's static arrays (the
    row groups' maxima, the slab's maxima and the scales: ``RESERVE``)
    fit one block; the cluster route's largest slab is the last that
    does."""
    static = 4 * (qp.THREADS + 2 * 64)             # red[RG][W] + part[W] + scale[W], bf16's W
    assert static <= qp.RESERVE
    for k in range(1, qp.CLUSTER_MAX_K + 1, 97):
        p = qp.col_quantize_plan(1, k, 64, "bfloat16")
        assert p["smem"] == p["slab_rows"] * qp.STRIP_BYTES
        assert p["smem"] + qp.RESERVE <= SMEM_LIMIT
    assert (qp.MAX_SLAB_ROWS + qp.ROW_ALIGN) * qp.STRIP_BYTES + qp.RESERVE > SMEM_LIMIT
    assert qp.CLUSTER_MAX_K == qp.MAX_CLUSTER * qp.MAX_SLAB_ROWS == 14336


def test_plan_constants_are_the_kernels():
    src = (CSRC / "col_quantize.cu").read_text()
    const = lambda name: int(re.search(rf"{name} = (\d+);", src).group(1))
    assert const("kStripBytes") == qp.STRIP_BYTES
    assert const("kThreads") == qp.THREADS
    assert const("kMaxCluster") == qp.MAX_CLUSTER
    assert const("kRowAlign") == qp.ROW_ALIGN
    assert const("kTargetRows") == qp.TARGET_ROWS
    assert const("kReserve") == qp.RESERVE
    assert const("kSmemLimit") == SMEM_LIMIT
    assert const("kTileK") == qp.TWO_PASS_TILE_K
    # the C entry recomputes the plan and refuses any other
    assert "route != p.route || cluster != p.cluster || slab_rows != p.slab_rows" in src
    assert "attr.id = cudaLaunchAttributeClusterDimension" in src
    assert "col_quantize" in _build.KERNELS


@pytest.mark.parametrize("kw,match", [
    (dict(dtype="float16"), "float32 or bfloat16"), (dict(e=0), "at least one weight"),
    (dict(e=-1), "at least one weight"), (dict(k=0), "positive"), (dict(n=0), "positive"),
])
def test_plan_refuses_what_the_kernel_refuses(kw, match):
    args = dict(e=8, k=2048, n=4096, dtype="bfloat16")
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        qp.col_quantize_plan(**args)


@pytest.mark.parametrize("kw", [
    dict(e=65536), dict(e=65600, k=16, n=16), dict(k=65535 * 64 + 1, n=64),
    dict(e=65600, k=20000, n=16),
])
def test_plan_takes_what_it_refused_before(kw):
    """Past 65,535 weights, or two_pass row tiles past 65,535: every grid
    one dimension within CUDA's limits."""
    args = dict(e=8, k=2048, n=4096, dtype="bfloat16")
    args.update(kw)
    p = qp.col_quantize_plan(**args)
    grids = ([p["grid"]] if p["route"] == "cluster"
             else [p["absmax_grid"], p["quant_grid"]])
    assert all(len(g) == 1 and 1 <= g[0] <= 2 ** 31 - 1 for g in grids)
    if p["route"] == "two_pass":
        nb = -(-args["n"] // qp.TWO_PASS_COLS)
        assert p["quant_grid"] == (nb * -(-args["k"] // qp.TWO_PASS_TILE_K) * args["e"],)


def test_plan_arguments_are_the_plans():
    p = qp.col_quantize_plan(8, 4096, 2048, "bfloat16")
    assert (p["cluster"], p["slab_rows"], p["smem"]) == (8, 512, 65536)
    assert qp.col_quantize_args(8, 4096, 2048, "bfloat16") == (0, 8, 512, 65536, 0)
    assert qp.col_quantize_plan(8, 2048, 4096, "bfloat16")["smem"] == 32768
    assert qp.col_quantize_plan(1, 2048, 2048, "float32")["grid"] == (64 * 8,)


def _cluster_emulation(w: np.ndarray, dtype: str, rounding: str):
    """The cluster route in numpy, f32: per strip, each rank's slab
    maxima (NaN kept), merged in rank order, clamped at 1e-12 (NaN kept),
    then every slab quantized with 127 / c; codes [n, k] (a NaN or inf
    product's code 0, as the card converts NaN) and scales [1, n]."""
    k, n = w.shape
    p = qp.col_quantize_plan(1, k, n, dtype)
    codes = np.zeros((n, k), np.int8)
    scales = np.zeros((1, n), np.float32)
    cols = p["strip_cols"]
    for c0 in range(0, n, cols):
        strip = w[:, c0:c0 + cols]
        parts = [np.abs(strip[slice(*slab_range(p, r, k))]).max(axis=0, initial=0.0)
                 for r in range(p["cluster"])]
        m = np.zeros(strip.shape[1], np.float32)
        for part in parts:
            m = np.where(np.isnan(m) | (m > part), m, part).astype(np.float32)
        c = np.where(np.isnan(m), m, np.maximum(m, np.float32(1e-12))).astype(np.float32)
        scales[0, c0:c0 + cols] = c
        with np.errstate(invalid="ignore"):     # inf * 0 in an inf column
            y = strip * (np.float32(127.0) / c)
        q = np.clip(np.rint(y), -127, 127) if rounding == "nearest" else np.trunc(y)
        codes[c0:c0 + cols] = np.where(np.isfinite(q), q, 0).astype(np.int8).T
    return codes, scales


@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
@pytest.mark.parametrize("k,n,dtype", [(3, 5, "float32"), (17, 70, "bfloat16"),
                                       (784, 96, "float32"), (2048, 130, "bfloat16")])
def test_cluster_algorithm_equals_plain_and_pallas(k, n, dtype, rounding):
    rng = np.random.default_rng(k + n)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    wf = tw.float().numpy()
    codes, scales = _cluster_emulation(wf, dtype, rounding)
    qt, c = col_quantize_plain(tw, rounding)
    np.testing.assert_array_equal(codes, qt.numpy())
    np.testing.assert_array_equal(scales.view(np.int32), c.numpy().view(np.int32))
    wq, cw = col_quantize_pallas(jnp.asarray(wf), rounding=rounding)
    np.testing.assert_array_equal(codes, np.asarray(wq).T)
    np.testing.assert_array_equal(scales, np.asarray(cw))


@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
def test_nan_and_inf_columns_keep_the_plain_scales(rounding):
    """A NaN in a column makes its scale NaN in the cluster route, as
    torch's amax does in the plain version; +-inf makes it inf. The finite
    columns' codes are the plain version's."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((784, 100)) * 0.02).astype(np.float32)
    w[5, 3], w[700, 7], w[9, 9] = np.nan, np.inf, -np.inf
    codes, scales = _cluster_emulation(w, "float32", rounding)
    qt, c = col_quantize_plain(torch.from_numpy(w), rounding)
    c = c.numpy()
    assert np.isnan(scales[0, 3]) and np.isnan(c[0, 3])
    assert scales[0, 7] == scales[0, 9] == np.inf == c[0, 7] == c[0, 9]
    finite = np.ones(100, bool)
    finite[[3, 7, 9]] = False
    np.testing.assert_array_equal(codes[finite], qt.numpy()[finite])
    np.testing.assert_array_equal(scales[0, finite], c[0, finite])
