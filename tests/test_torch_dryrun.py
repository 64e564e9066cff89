"""The port's multi-device dryrun (qgemm_tpu_torch/parallel/dryrun.py,
``run_dryrun``, JAX's ``__graft_entry__.dryrun_multichip`` and
``qgemm_tpu/parallel/dryrun.py``) in a world of 4 over gloo: every section
runs and passes its assertions on every rank (data x model training on a
(1, 4) mesh, the TP int8 and W4A8 matmuls, the TP engines, a2a EP, GQA,
speculative decoding, the GPipe, ring, Ulysses and EP training steps, int8
EP), and the ranks agree on every replicated reading; and in a world of 1,
where the two sections that give each rank one expert under top-2 routing
(the MoE GPT under the mesh and a2a EP) need two experts and are left
out, with the page size of every paged engine it builds."""

import math

import pytest

from qgemm_tpu_torch.ops.cuda.paged_plan import k5_plan
from qgemm_tpu_torch.utils.testing import run_world, use_test_threads
from torch_parallel_workers import dryrun_pages_worker, dryrun_worker
from torch_tp_workers import results

use_test_threads()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dryrun"))
    run_world(dryrun_worker, 4, d, d)
    return results(d, "dryrun", 4)


def test_dryrun_passes_on_every_rank(ranks):
    for res in ranks:
        assert res["world"] == 4 and res["mesh"] == (1, 4) and res["moe_sections"]
        for key in ("train_loss", "pipeline_loss", "ep_loss"):
            assert math.isfinite(res[key]), key
        assert res["prefix_hits"] >= 1 and res["preemptions"] >= 1
        assert res["a2a_err"] <= 1e-3 and res["w4a8_column_err"] <= 1e-4


@pytest.mark.parametrize("key", ["train_loss", "pipeline_loss", "ep_loss", "prefix_hits",
                                 "preemptions", "tp_column_err", "tp_row_err"])
def test_ranks_agree(ranks, key):
    assert all(res[key] == ranks[0][key] for res in ranks), [res[key] for res in ranks]


def test_dryrun_world_of_one(tmp_path):
    """Every section but the two MoE ones runs at world 1, and every paged
    engine has pages the card's paged kernels take (K5's plan raises on
    others), JAX's over-commit pages of 8 among them."""
    d = str(tmp_path)
    run_world(dryrun_pages_worker, 1, d, d)
    (res,) = results(d, "dryrun", 1)
    assert len(res["page_sizes"]) == 5     # the MoE GPT's paged engine needs n >= 2
    for ps in res["page_sizes"]:
        k5_plan(8, 32, 8, 1, ps, 4, 2, 1)
    assert 8 in res["page_sizes"]
    assert res["world"] == 1 and res["mesh"] == (1, 1) and not res["moe_sections"]
    assert "a2a_err" not in res and res["prefix_hits"] >= 1 and res["preemptions"] >= 1
    assert res["tp_column_err"] == 0.0 and res["tp_row_err"] == 0.0
    assert res["w4a8_column_err"] == 0.0
    for key in ("train_loss", "pipeline_loss", "ep_loss"):
        assert math.isfinite(res[key]), key
