"""Port parity for the tensor-parallel collectives (qgemm_tpu_torch/parallel/
tp_ops.py, mesh.py) and K1's route on caller-given row scales, against
qgemm_tpu/parallel/tp_ops.py on JAX's virtual CPU mesh make_mesh((1, p)).

The port runs one process per rank (gloo over a file store, spawned by
``run_world``); the same numpy inputs and JAX's int8 and int4 codes go to
both sides. Tolerances are JAX's own tests' (tests/test_parallel.py):
column 1e-5; row 1e-5 relative, 1e-4 absolute (the SUM adds the ranks'
f32 partials in another order than one product's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.ops.quantize import quantize_weights as j_quantize
from qgemm_tpu.ops.quantize import quantize_weights_int4 as j_quantize4
from qgemm_tpu.parallel.mesh import make_mesh as j_make_mesh
from qgemm_tpu.parallel.tp_ops import _local_qmm
from qgemm_tpu.parallel.tp_ops import tp_quantized_matmul_column as j_col
from qgemm_tpu.parallel.tp_ops import tp_quantized_matmul_row as j_row
from qgemm_tpu.parallel.tp_ops import tp_w4a8_matmul_column as j_w4_col
from qgemm_tpu.parallel.tp_ops import tp_w4a8_matmul_row as j_w4_row
from qgemm_tpu_torch.ops import cuda as kernels
from qgemm_tpu_torch.ops.quantize import (QuantizedWeight, absmax_scales,
                                          quantized_matmul_prequant)
from qgemm_tpu_torch.parallel import tp_ops
from qgemm_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
from qgemm_tpu_torch.utils.testing import assert_allclose, run_world, use_test_threads
from torch_tp_workers import ops_worker, results

use_test_threads()

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

RNG = np.random.default_rng(17)


def _inputs():
    f = lambda *s: RNG.normal(size=s).astype(np.float32)
    wc, wr, w4 = j_quantize(jnp.asarray(f(64, 96))), j_quantize(jnp.asarray(f(128, 48))), \
        j_quantize4(jnp.asarray(f(512, 64)))
    return dict(x=f(6, 64), x_row=f(6, 128) * np.linspace(0.2, 3.0, 128, dtype=np.float32),
                q_col=np.asarray(wc.q), c_col=np.asarray(wc.c), q_row=np.asarray(wr.q),
                c_row=np.asarray(wr.c), xw=f(5, 512), qp=np.asarray(w4.qp),
                c4=np.asarray(w4.c))


INPUTS = _inputs()


def _jax_refs(p):
    m = j_make_mesh((1, p), ("data", "model"))
    i = {k: jnp.asarray(v) for k, v in INPUTS.items()}
    return dict(column=np.asarray(j_col(i["x"], i["q_col"], i["c_col"], m)),
                column_local=np.asarray(j_col(i["x"], i["q_col"], i["c_col"], m,
                                              gather_output=False)),
                row=np.asarray(j_row(i["x_row"], i["q_row"], i["c_row"], m)),
                w4_column=np.asarray(j_w4_col(i["xw"], i["qp"], i["c4"], m)),
                w4_row=np.asarray(j_w4_row(i["xw"], i["qp"], i["c4"], m)))


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    p = request.param
    d = str(tmp_path_factory.mktemp(f"tp_ops{p}"))
    run_world(ops_worker, p, d, d, INPUTS)
    return p, results(d, "ops", p), _jax_refs(p)


TOL = dict(column=(1e-5, 1e-5), column_local=(1e-5, 1e-5), row=(1e-5, 1e-4),
           w4_column=(1e-5, 1e-5), w4_row=(1e-5, 1e-4))


@pytest.mark.parametrize("op", sorted(TOL))
def test_tp_op_matches_jax(world, op):
    p, ranks, ref = world
    rtol, atol = TOL[op]
    for r, res in enumerate(ranks):
        want = ref[op]
        if op == "column_local":   # each rank holds its block of N
            n = want.shape[1] // p
            want = want[:, r * n:(r + 1) * n]
        assert_allclose(res[op], want, rtol=rtol, atol=atol, msg=f"{op} rank {r}")


@pytest.mark.parametrize("op,kinds", [
    ("column", {"all_gather": 1}),
    ("column_local", {}),
    ("row", {"all_reduce_max": 1, "all_reduce_sum": 1}),
    ("w4_column", {"all_gather": 1}),
    ("w4_row", {"all_reduce_sum": 1})])
def test_tp_op_collectives_counted(world, op, kinds):
    """One MAX and one SUM for row int8 (JAX's pmax and psum), one SUM for
    row W4A8 (no global grid), one gather for a gathered column layer, and
    each one's payload bytes."""
    p, ranks, _ = world
    m = INPUTS["x"].shape[0]
    nbytes = {"column": m * 96 // p * 4, "row": m * 48 * 4, "w4_column": 5 * 64 // p * 4,
              "w4_row": 5 * 64 * 4}
    for res in ranks:
        c = res[op + "/counts"]
        for kind in ("all_reduce_max", "all_reduce_sum", "all_gather"):
            assert c[kind] == kinds.get(kind, 0), (op, c)
        if "all_reduce_max" in kinds:
            assert c["all_reduce_max_bytes"] == m * 4
        moved = c["all_reduce_sum_bytes"] + c["all_gather_bytes"]
        assert moved == nbytes.get(op, 0), (op, c)


def test_row_shards_quantize_on_the_global_grid(world):
    """Every rank's cx is the whole row's absmax, and the ranks' partials,
    summed by hand, are the unsharded product."""
    p, ranks, _ = world
    x = torch.from_numpy(INPUTS["x_row"])
    want_cx = absmax_scales(x, -1).numpy()
    for res in ranks:
        np.testing.assert_array_equal(res["row_cx"], want_cx)
    full = quantized_matmul_prequant(x, QuantizedWeight.from_kn(
        torch.from_numpy(INPUTS["q_row"]), torch.from_numpy(INPUTS["c_row"])))
    assert_allclose(sum(res["row_partial"] for res in ranks), full, rtol=1e-5, atol=1e-4)
    assert all(res["w4_row_pad_raises"] and res["bad_shape_raises"] for res in ranks)


def test_k1_given_cx_plain_matches_jax_qmm_kernel():
    """The plain version of K1 on caller-given row scales against JAX's
    _qmm_kernel (interpret mode), which takes cx from its caller."""
    x = RNG.normal(size=(8, 64)).astype(np.float32)
    wq = j_quantize(jnp.asarray(RNG.normal(size=(64, 32)).astype(np.float32)))
    cx = (np.abs(x).max(axis=1, keepdims=True) * 1.7).astype(np.float32)
    want = np.asarray(_local_qmm(jnp.asarray(x), wq.q, jnp.asarray(cx), wq.c))
    got = quantized_matmul_prequant(torch.from_numpy(x), QuantizedWeight.from_kn(
        torch.from_numpy(np.asarray(wq.q)), torch.from_numpy(np.asarray(wq.c))),
        cx=torch.from_numpy(cx))
    assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_given_own_absmax_equals_fused_route_bit_for_bit(dtype):
    """cx = x's own row absmax (floored at 1e-12, an all-zero row among
    them) gives the fused route's codes and output, bit for bit; the CPU
    route counts no launch."""
    kernels.reset_launch_counts()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(9, 48, generator=g).to(dtype)
    x[4] = 0
    wq = QuantizedWeight.from_kn(torch.randint(-127, 128, (48, 20), generator=g,
                                               dtype=torch.int8), torch.rand(1, 20) + 0.5)
    fused = quantized_matmul_prequant(x, wq)
    given = quantized_matmul_prequant(x, wq, cx=absmax_scales(x.float(), -1))
    assert torch.equal(fused, given)
    assert kernels.launch_counts()["quantized_matmul_given_cx"] == 0


def test_k1_given_cx_checks_its_scales():
    x = torch.randn(4, 32)
    wq = QuantizedWeight.from_kn(torch.zeros(32, 8, dtype=torch.int8), torch.ones(1, 8))
    with pytest.raises(ValueError, match="row scales"):
        quantized_matmul_prequant(x, wq, cx=torch.ones(4))
    with pytest.raises(ValueError, match="cx"):
        quantized_matmul_prequant(x, wq, cx=torch.ones(4, 1, dtype=torch.float64))


def test_mesh_entry_points_raise_without_gpu_or_group():
    """No device means CUDA: both entry points raise without a GPU; a CPU
    mesh needs a process group first."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize_distributed(world_size=1, rank=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh(device="cpu")
    assert tp_ops.collective_counts()["all_reduce_sum"] >= 0
