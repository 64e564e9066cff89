"""The port's multi-device dryrun (qgemm_tpu_torch/parallel/dryrun.py,
``run_dryrun``, JAX's ``__graft_entry__.dryrun_multichip`` and
``qgemm_tpu/parallel/dryrun.py``) in a world of 4 over gloo: every section
runs and passes its assertions on every rank (data x model training on a
(1, 4) mesh, the TP int8 and W4A8 matmuls, the TP engines, a2a EP, GQA,
speculative decoding, the GPipe, ring, Ulysses and EP training steps, int8
EP), and the ranks agree on every replicated reading."""

import math

import pytest

from qgemm_tpu_torch.utils.testing import run_world, use_test_threads
from torch_parallel_workers import dryrun_worker
from torch_tp_workers import results

use_test_threads()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dryrun"))
    run_world(dryrun_worker, 4, d, d)
    return results(d, "dryrun", 4)


def test_dryrun_passes_on_every_rank(ranks):
    for res in ranks:
        assert res["world"] == 4 and res["mesh"] == (1, 4)
        for key in ("train_loss", "pipeline_loss", "ep_loss"):
            assert math.isfinite(res[key]), key
        assert res["prefix_hits"] >= 1 and res["preemptions"] >= 1
        assert res["a2a_err"] <= 1e-3 and res["w4a8_column_err"] <= 1e-4


@pytest.mark.parametrize("key", ["train_loss", "pipeline_loss", "ep_loss", "prefix_hits",
                                 "preemptions", "tp_column_err", "tp_row_err"])
def test_ranks_agree(ranks, key):
    assert all(res[key] == ranks[0][key] for res in ranks), [res[key] for res in ranks]
