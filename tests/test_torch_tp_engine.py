"""The GPT engine under a mesh (qgemm_tpu_torch/serving/engine.py,
``mesh=``): every rank serves the same requests with its rank's model, in
worlds of 2 and 4 over gloo. Greedy transcripts equal the port's unsharded
engine's in every mode (dense float and int8 KV, paged int8 with prefix
caching and chunked admission, paged int4 over-committed, speculative
dense and paged, GQA, MoE with its experts sharded, the native scheduler), and
JAX's tensor-parallel engine's on make_mesh((1, p)) in every mode with a
float cache (dense, speculative dense, GQA, MoE): with the int8 cache
JAX's jitted step rounds other than op by op (test_torch_engine.py), and
its paged pools are int8 or int4. Every rank's transcripts, logprobs and stats are
equal. The int4 pools are held to the port's unsharded int4 engine: JAX's
tensor-parallel int4 path rebuilds its pools without ``kv_bits``
(ROADMAP C, reference fault 2), so it is no reference there. Ports the
intent of tests/test_gpt_serving.py:120-146, :351-369, :596-617, :783-804
and test_paged_cache.py:221-242, :549-568.

Logprobs agree to 1e-2: the SUM adds the ranks' f32 partials in another
order than one product, and a last-bit difference can flip one int8 code
where the next layer re-quantizes its activations (test_torch_gpt.py holds
quantized logits to 2e-3 for that reason), an int8 K/V row keeps such a
flip for every later step, and the MoE router's top-k sends a token at a
near tie to another expert. Transcripts and stats are held exactly.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest

from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu.parallel.mesh import make_mesh as j_make_mesh
from qgemm_tpu.parallel.sharding import shard_quantized_model as j_shard
from qgemm_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from qgemm_tpu.serving.engine import Request as JRequest
from qgemm_tpu_torch.serving import native
from qgemm_tpu_torch.utils.testing import assert_allclose, run_world, use_test_threads
from test_torch_gpt import jax_params
from torch_tp_workers import (FAULTS, RANK_FAULTS, engine_worker, faults_worker,
                             one_rank_fault_worker, results)

use_test_threads()

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(vocab_size=96, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=64)
SYSTEM = list(range(1, 17))   # a two-page shared prefix at page size 8
PROMPTS = [SYSTEM + [20 + i] * (1 + 3 * i) for i in range(4)] + [[5, 9, 2]]
N_NEW = [6, 5, 8, 4, 7]

# the over-commit scenario: two 40-token generations outgrow a 9-page pool
OVER_PROMPTS, OVER_NEW = [[3 + i, 5, 7] for i in range(5)], [40, 4, 40, 4, 4]
PAGED = dict(paged=True, page_size=8)
# name -> (config overrides, engine options, draft?)
CASES = {
    "dense": ({}, {}, False),
    "int8_kv": ({}, {"quantized_cache": True}, False),
    "paged_int8": ({}, dict(PAGED, chunked_prefill=8), False),
    "paged_int4": ({}, dict(PAGED, kv_bits=4, overcommit=True, n_pages=9), False),
    "spec_dense": ({}, {"spec_gamma": 3}, True),
    "spec_paged": ({}, dict(PAGED, spec_gamma=3), True),
    "gqa": ({"n_kv_heads": 2}, dict(PAGED), False),
    "gqa_dense": ({"n_kv_heads": 2}, {}, False),
    "moe": ({"n_experts": 4}, {}, False),
    "native": ({}, dict(PAGED, scheduler="native"), False),
}
WORLD4 = ("dense", "gqa", "gqa_dense", "paged_int4")
# the float-cache cases JAX's tensor-parallel engine serves too, per world
JAX_CASES = {2: ("dense", "gqa_dense", "moe", "spec_dense"), 4: ("dense", "gqa_dense")}


def _jax_model(over, seed=5):
    cfg = dict(BASE, **over)
    return JGPT.init(JConfig(**cfg), key=jax.random.PRNGKey(seed)).quantize(), cfg


def _cases(names):
    out = {}
    draft, dcfg = _jax_model({"n_layers": 1}, seed=6)
    for name in names:
        over, kw, spec = CASES[name]
        jm, cfg = _jax_model(over)
        prompts = (OVER_PROMPTS, OVER_NEW) if kw.get("overcommit") else (PROMPTS, N_NEW)
        case = (jax_params(jm), cfg, dict(kw)) + prompts
        out[name] = case + ((jax_params(draft), dcfg) if spec else ())
    return out


_RUNS = {}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """p -> the ranks' results of the engine cases of world p (each world
    spawned once)."""
    def get(p):
        if p not in _RUNS:
            names = sorted(CASES) if p == 2 else WORLD4
            if "native" in names:
                native.build()   # once, before the ranks load it
            d = str(tmp_path_factory.mktemp(f"tp_engine{p}"))
            run_world(engine_worker, p, d, d, _cases(names))
            _RUNS[p] = results(d, "engine", p)
        return _RUNS[p]
    return get


@pytest.fixture(scope="module", params=[2, 4])
def world(request, run):
    return request.param, run(request.param)


@pytest.mark.parametrize("p,name", [(2, n) for n in sorted(CASES)] + [(4, n) for n in WORLD4])
def test_tp_engine_matches_unsharded_engine(run, p, name):
    ranks = run(p)
    for res in ranks:
        r = res[name]
        assert r["got"] == r["want"], name
        n_new = OVER_NEW if CASES[name][1].get("overcommit") else N_NEW
        assert all(len(g) == n for g, n in zip(r["got"], n_new))
        for a, b in zip(r["got_lp"], r["want_lp"]):
            assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-2, atol=1e-2)
        want_stats = dict(r["want_stats"])
        if not r["prefix_cache"] and CASES[name][1].get("paged"):
            # prefix caching off under this mesh (JAX's rule): no hits
            want_stats.update(prefix_hits=0, prefix_cached_pages=0, prefill_tokens_skipped=0)
        assert r["stats"] == want_stats, (r["stats"], want_stats)
        # every rank served the same requests the same way
        assert r["got"] == ranks[0][name]["got"] and r["got_lp"] == ranks[0][name]["got_lp"]
        assert r["stats"] == ranks[0][name]["stats"]
        over = CASES[name][0]
        hkv = over.get("n_kv_heads") or BASE["n_heads"]
        sharded = BASE["n_heads"] % p == 0 and hkv % p == 0
        assert r["pool_heads"] == (hkv // p if sharded else hkv)


def test_tp_engine_paths_were_taken(world):
    """The paged runs hit the prefix cache, the over-committed int4 pool
    preempted, the speculative engines ran rounds; a GQA model whose KV
    heads do not divide p runs with prefix caching off (JAX's rule)."""
    p, ranks = world
    r = ranks[0]
    assert r["paged_int4"]["stats"]["preemptions"] > 0
    if p == 2:
        assert r["paged_int8"]["stats"]["prefix_hits"] > 0
        assert r["spec_dense"]["stats"]["spec_rounds"] > 0
        assert r["spec_paged"]["stats"]["spec_rounds"] > 0
        assert r["gqa"]["prefix_cache"]
    else:
        assert not r["gqa"]["prefix_cache"]


def _bench_scaling():
    spec = importlib.util.spec_from_file_location(
        "bench_scaling", os.path.join(ROOT, "scripts", "bench_scaling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_formula_is_the_scaling_models():
    """chip_smoke.py checks the card's bytes with a copy of the formula
    (the script imports no JAX); the copy is the script's."""
    import chip_smoke
    bs = _bench_scaling()
    for args in ((32, 4096, 8), (2, 32, 2), (24, 2048, 16)):
        assert chip_smoke.decode_step_allreduce_bytes(*args) == \
            bs.analytic_decode_step_allreduce_bytes(*args)


def test_tp_decode_step_collectives_match_scaling_model(world):
    """One decode step over 2 slots: 4 all-reduces a block, one gather, and
    the all-reduce payload of scripts/bench_scaling.py's formula."""
    p, ranks = world
    L, d, b = BASE["n_layers"], BASE["d_model"], 2
    for res in ranks:
        c = res["step_collectives"]
        assert c["all_reduce_max"] == c["all_reduce_sum"] == 2 * L
        assert c["all_gather"] == 1
        assert c["all_gather_bytes"] == b * BASE["vocab_size"] // p * 4
        want = _bench_scaling().analytic_decode_step_allreduce_bytes(L, d, b)
        assert c["all_reduce_max_bytes"] + c["all_reduce_sum_bytes"] == want


def _jserve(model, **kw):
    eng = JEngine(model, max_slots=2, scheduler="python", **kw)
    reqs = [JRequest(prompt=pr, max_new_tokens=n) for pr, n in zip(PROMPTS, N_NEW)]
    for q in reqs[:-2]:
        eng.submit(q)
    eng.step()
    for q in reqs[-2:]:
        eng.submit(q)
    eng.run_to_completion()
    return [q.generated for q in reqs]


@pytest.mark.parametrize("p,name", [(p, n) for p, names in JAX_CASES.items() for n in names])
def test_tp_engine_matches_jax_tp_engine(run, p, name):
    """The float-cache engines' greedy transcripts equal JAX's engine on
    its tensor-sharded model (and draft), make_mesh((1, p)). At p = 4 the
    GQA model's 2 KV heads do not divide p: the port replicates those
    blocks, JAX mixes sharded and resharded pieces (ROADMAP C); both
    compute the same function."""
    over, kw, spec = CASES[name]
    assert set(kw) <= {"spec_gamma"}, name   # the dense float cache
    mesh = j_make_mesh((1, p), ("data", "model"))
    jm, _ = _jax_model(over)
    if spec:
        draft, _ = _jax_model({"n_layers": 1}, seed=6)
        kw = dict(kw, draft_model=j_shard(draft, mesh))
    assert _jserve(j_shard(jm, mesh), mesh=mesh, **kw) == run(p)[0][name]["got"]


def test_planted_faults_are_caught(tmp_path):
    """Four faults of the tensor-parallel route, planted at p = 2 (at p = 1
    the first, second and fourth are identities): each breaks the forward
    check (1e-4 against the unsharded model), and the skipped SUM and the
    wrong KV heads also the transcripts."""
    jm, cfg = _jax_model({})
    d = str(tmp_path)
    run_world(faults_worker, 2, d, d, jax_params(jm), cfg, PROMPTS[:3], N_NEW[:3])
    res = results(d, "faults", 2)[0]
    assert res["none"]["forward"] and res["none"]["transcripts"], res["none"]
    for fault in FAULTS:
        assert not res[fault]["forward"], (fault, res[fault])
    for fault in ("skipped_sum", "kv_head_offset"):
        assert not res[fault]["transcripts"], (fault, res[fault])


@pytest.mark.parametrize("where", sorted(RANK_FAULTS))
def test_fault_on_one_rank_raises_on_every_rank(tmp_path, where):
    """A decode step, a speculative round or an admission that fails on
    rank 1 only, at p = 2: rank 1 raises its fault instead of recovering
    alone, and rank 0, whose collectives then have no partner, raises too.
    A rank that recovered alone would pair its next collectives with the
    other rank's and sum rows of other requests."""
    jm, cfg = _jax_model({})
    draft = None
    if where == "spec":
        dm, dcfg = _jax_model({"n_layers": 1}, seed=6)
        draft = (jax_params(dm), dcfg)
    d = str(tmp_path)
    run_world(one_rank_fault_worker, 2, d, d, "gpt", where, jax_params(jm), cfg, PROMPTS,
              N_NEW, draft, timeout=120)
    r0, r1 = results(d, f"fault_gpt_{where}", 2)
    assert r1["raised"] == f"RuntimeError: planted {where} fault"
    assert r0["raised"] is not None
