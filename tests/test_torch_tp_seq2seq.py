"""The encoder-decoder engine under a mesh (qgemm_tpu_torch/serving/
seq2seq.py, ``mesh=``) and ``Transformer.with_tp``: every rank serves the
same sources with its rank's model in worlds of 2 and 4 over gloo. Greedy
transcripts equal the port's unsharded engine's (dense float and int8
self-cache and cross K/V, paged int8 and int4, speculative, GQA), every
rank's are equal, the cross K/V are head-local, and the float-cache
engines' transcripts (dense, speculative, GQA) equal JAX's tensor-parallel
Seq2SeqEngine on make_mesh((1, p)); with an int8 cache JAX's jitted step
rounds other than op by op (test_torch_tp_engine.py).
Logprobs agree to 1e-2 (test_torch_tp_engine.py says why). Ports the
intent of tests/test_seq2seq_serving.py:177-203, :305-329.
"""

import jax
import numpy as np
import pytest

from qgemm_tpu.models.transformer import Transformer as JTransformer
from qgemm_tpu.models.transformer import TransformerConfig as JConfig
from qgemm_tpu.parallel.mesh import make_mesh as j_make_mesh
from qgemm_tpu.parallel.sharding import shard_quantized_model as j_shard
from qgemm_tpu.serving.engine import Request as JRequest
from qgemm_tpu.serving.seq2seq import Seq2SeqEngine as JEngine
from qgemm_tpu_torch.utils.testing import assert_allclose, run_world, use_test_threads
from test_torch_gpt import jax_params
from torch_tp_workers import one_rank_fault_worker, results, seq2seq_worker

use_test_threads()

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

BASE = dict(vocab_size=89, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=64)
SOURCES = [[3, 4, 5], [4, 4, 5, 9], [5, 4, 5, 9, 10], [6, 4, 5], [7, 4, 5, 9]]
N_NEW = [6, 9, 5, 7, 4]
PAGED = dict(paged=True, page_size=8)
# name -> (config overrides, engine options, draft?)
CASES = {
    "dense": ({}, {}, False),
    "int8": ({}, {"quantized_cache": True}, False),
    "paged_int8": ({}, dict(PAGED), False),
    "paged_int4": ({}, dict(PAGED, kv_bits=4), False),
    "spec": ({}, {"spec_gamma": 3}, True),
    "gqa": ({"n_kv_heads": 2}, {"quantized_cache": True}, False),
    "gqa_dense": ({"n_kv_heads": 2}, {}, False),
}
WORLD4 = ("dense", "gqa", "gqa_dense")
# the float-cache cases JAX's tensor-parallel engine serves too, per world
JAX_CASES = {2: ("dense", "gqa_dense", "spec"), 4: ("dense", "gqa_dense")}


def _jax_model(over, seed=12):
    cfg = dict(BASE, **over)
    return JTransformer.init(JConfig(**cfg), key=jax.random.PRNGKey(seed)).quantize(), cfg


def _cases(names):
    out = {}
    draft, dcfg = _jax_model({"n_layers": 1}, seed=13)
    for name in names:
        over, kw, spec = CASES[name]
        jm, cfg = _jax_model(over)
        case = (jax_params(jm), cfg, dict(kw), SOURCES, N_NEW)
        out[name] = case + ((jax_params(draft), dcfg) if spec else ())
    return out


_RUNS = {}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    def get(p):
        if p not in _RUNS:
            d = str(tmp_path_factory.mktemp(f"tp_s2s{p}"))
            run_world(seq2seq_worker, p, d, d, _cases(sorted(CASES) if p == 2 else WORLD4))
            _RUNS[p] = results(d, "seq2seq", p)
        return _RUNS[p]
    return get


@pytest.mark.parametrize("p,name", [(2, n) for n in sorted(CASES)] + [(4, n) for n in WORLD4])
def test_tp_seq2seq_matches_unsharded_engine(run, p, name):
    ranks = run(p)
    over = CASES[name][0]
    hkv = over.get("n_kv_heads") or BASE["n_heads"]
    sharded = BASE["n_heads"] % p == 0 and hkv % p == 0
    for res in ranks:
        r = res[name]
        assert r["got"] == r["want"], name
        assert all(len(g) == n for g, n in zip(r["got"], N_NEW))
        for a, b in zip(r["got_lp"], r["want_lp"]):
            assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-2, atol=1e-2)
        assert r["stats"] == r["want_stats"]
        assert r["got"] == ranks[0][name]["got"] and r["stats"] == ranks[0][name]["stats"]
        assert r["got_lp"] == ranks[0][name]["got_lp"]
        assert r["cross_heads"] == (hkv // p if sharded else hkv)


@pytest.mark.parametrize("p,name", [(p, n) for p, names in JAX_CASES.items() for n in names])
def test_tp_seq2seq_matches_jax_tp_engine(run, p, name):
    over, kw, spec = CASES[name]
    assert set(kw) <= {"spec_gamma"}, name   # the dense float cache
    mesh = j_make_mesh((1, p), ("data", "model"))
    jm, _ = _jax_model(over)
    if spec:
        draft, _ = _jax_model({"n_layers": 1}, seed=13)
        kw = dict(kw, draft_model=j_shard(draft, mesh))
    eng = JEngine(j_shard(jm, mesh), max_slots=3, max_new_tokens=24, mesh=mesh, **kw)
    reqs = [JRequest(prompt=s, max_new_tokens=n) for s, n in zip(SOURCES, N_NEW)]
    for q in reqs[:-2]:
        eng.submit(q)
    eng.step()
    for q in reqs[-2:]:
        eng.submit(q)
    eng.run_to_completion()
    assert [q.generated for q in reqs] == run(p)[0][name]["got"]


def test_admission_fault_on_one_rank_raises_on_every_rank(tmp_path):
    """An admission that fails on rank 1 only, at p = 2: both ranks raise
    (test_torch_tp_engine.py::test_fault_on_one_rank_raises_on_every_rank
    holds the GPT engine's decode, round and admission)."""
    jm, cfg = _jax_model({})
    d = str(tmp_path)
    run_world(one_rank_fault_worker, 2, d, d, "seq2seq", "admission", jax_params(jm), cfg,
              SOURCES, N_NEW, timeout=120)
    r0, r1 = results(d, "fault_seq2seq_admission", 2)
    assert r1["raised"] == "RuntimeError: planted admission fault"
    assert r0["raised"] is not None
