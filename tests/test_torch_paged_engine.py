"""Port parity for the paged serving tier (qgemm_tpu_torch/serving/engine.py
with paged=True, the paged branch of models/attention.py) against
qgemm_tpu/serving/engine.py on the CPU, with the same float32 weights in
both (carried over by the interop loader), pages of 8 positions.

Greedy transcripts are compared exactly. The JAX engine runs jitted: its
paged pools are int8 or int4, and where XLA's contracted multiply-adds
could flip a K/V code against the op-by-op computation the port follows,
these cases would show it; none does. Also here: the two reference
faults the port does not copy (ROADMAP §C, faults 1 and 5), the scenario
of the JAX suite's over-commit test, and the engine's paged bookkeeping.
"""

import jax
import numpy as np
import pytest
import torch

from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from qgemm_tpu.serving.engine import Request as JRequest
from qgemm_tpu_torch.models.gpt import GPTConfig
from qgemm_tpu_torch.ops import cuda as kernels
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params
from qgemm_tpu_torch.utils.testing import use_test_threads
from test_torch_gpt import jax_params

use_test_threads()

PS = 8
TINY = dict(vocab_size=64, d_model=64, n_heads=4, d_ff=128, n_layers=2, max_seq_len=128)


def _pair(seed, **overrides):
    sizes = {**TINY, **overrides}
    jm = JGPT.init(JConfig(**sizes), key=jax.random.PRNGKey(seed))
    return jm, gpt_from_jax_params(jax_params(jm), GPTConfig(**sizes), device="cpu")


@pytest.fixture(scope="module")
def mha():
    return _pair(0)


@pytest.fixture(scope="module")
def gqa():
    return _pair(1, n_kv_heads=2)


def _prompts(seed):
    """Four requests: three share a two-page system prompt (one of them
    longer than two chunks of 16), one does not."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, 64, 2 * PS).tolist()
    tails = (3, 29, 11)
    return ([system + rng.integers(0, 64, n).tolist() for n in tails]
            + [rng.integers(0, 64, 37).tolist()]), [6, 5, 7, 4]


def _serve(engine_cls, req_cls, model, prompts, news, max_slots=2, **kw):
    eng = engine_cls(model, max_slots=max_slots, max_seq_len=64, paged=True,
                     page_size=PS, **kw)
    reqs = [req_cls(prompt=p, max_new_tokens=n) for p, n in zip(prompts, news)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_steps=500)
    assert all(r.done and r.error is None for r in reqs), [r.error for r in reqs]
    return [list(r.generated) for r in reqs], eng


CASES = {
    "prefix": dict(),
    "chunked": dict(chunked_prefill=16),
    "int4": dict(kv_bits=4, chunked_prefill=16),
    "overlap": dict(chunked_prefill=16, overlap_admission=True),
    "overcommit": dict(overcommit=True, n_pages=9),
}


@pytest.mark.parametrize("case,model", [("prefix", "mha"), ("chunked", "mha"),
                                        ("int4", "mha"), ("overlap", "mha"),
                                        ("overcommit", "mha"), ("int4", "gqa")])
def test_paged_engine_matches_jax_engine(case, model, request):
    jm, tm = request.getfixturevalue(model)
    prompts, news = _prompts(3)
    if case == "overcommit":
        # two long generations sharing the system prompt, whose growth the
        # 8-page pool cannot hold
        prompts = [prompts[0], prompts[0][:2 * PS] + [9, 8, 7, 6, 5], prompts[3][:6],
                   prompts[0][:2 * PS + 2]]
        news = [30, 30, 4, 20]
    kw = CASES[case]
    want, je = _serve(JEngine, JRequest, jm, prompts, news, scheduler="python", **kw)
    kernels.reset_launch_counts()
    got, te = _serve(ContinuousBatchingEngine, Request, tm, prompts, news, device="cpu", **kw)
    assert sum(kernels.launch_counts().values()) == 0
    assert got == want
    st, jst = te.stats, je.stats
    assert st["tokens_generated"] == sum(news) == jst["tokens_generated"]
    assert st["pages_in_use"] == 0                             # all slots released
    assert st["prefix_hits"] > 0 and st["prefill_tokens_skipped"] > 0
    if case != "overcommit":
        for key in ("prefix_hits", "prefill_tokens_skipped", "steps"):
            assert st[key] == jst[key], key
    else:
        assert st["preemptions"] >= 1 and jst["preemptions"] >= 1
    if case == "overlap":
        assert "itl_p50_ms" in st


def _pool_invariant(eng):
    """No slot outside the active set holds pages (a slot suspended for an
    overlapped admission is active in this sense), and every page but the
    null page is free, idle in the prefix LRU or held."""
    a = eng.alloc
    held = {p for pages in a.slot_pages for p in pages}
    for slot, pages in enumerate(a.slot_pages):
        if not eng.book.active_mask()[slot]:
            assert pages == [], (slot, pages)
    assert len(a.free) + len(a.cached) + len(held) == eng.caches[0].n_pages - 1
    assert not (set(a.free) & held) and not (set(a.cached) & held)


def _overcommit_scenario(model, engine_cls, req_cls, check_each_step=False, **kw):
    """The JAX suite's over-commit test (tests/test_gpt_serving.py): six
    3-token prompts, two of them generating 40 tokens, 3 slots, a 9-page
    pool of 8-position pages."""
    eng = engine_cls(model, max_slots=3, paged=True, n_pages=9, page_size=8, **kw)
    reqs = [req_cls(prompt=[3 + i, 5, 7], max_new_tokens=n)
            for i, n in enumerate([40, 4, 4, 40, 4, 4])]
    for r in reqs:
        eng.submit(r)
    while (eng.book.num_waiting or eng.book.num_active) and eng.steps < 500:
        preempted = getattr(eng, "preemptions", 0)
        eng.step()
        if check_each_step:
            _pool_invariant(eng)
            if eng.preemptions > preempted:
                # the growth that preempted left the batch running
                assert eng.book.num_active > 0
                check_each_step = "seen"
    fin = {r.id: r for r in eng.run_to_completion(max_steps=500)}
    assert all(fin[r.id].error is None for r in reqs)
    return [tuple(fin[r.id].generated) for r in reqs], eng, check_each_step


def test_fault1_growth_skips_a_slot_preempted_in_the_same_pass():
    """Reference fault 1: the JAX engine grows slots from the ``active``
    snapshot taken before growth, so a slot that an earlier slot's growth
    preempted is grown too: its growth finds the pool dry and preempts a
    live slot (in this scenario every slot, two preemptions where one
    frees the page). The port re-checks the slot: after every step no
    inactive slot holds pages, free + cached + held pages = n_pages - 1,
    a preempting growth leaves the batch running, and one preemption
    suffices."""
    _, tm = _pair(41, **{"vocab_size": 97, "d_model": 32, "d_ff": 64, "max_seq_len": 64})
    _, eng, seen = _overcommit_scenario(tm, ContinuousBatchingEngine, Request,
                                        check_each_step=True, overcommit=True,
                                        device="cpu")
    assert seen == "seen" and eng.preemptions == 1


def test_jax_overcommit_parity_and_throughput_scenario():
    """The scenario of the JAX suite's
    test_overcommit_preemption_parity_and_throughput, with the engine's
    default scheduler (the native one's half is in
    tests/test_torch_native_scheduler.py): over-commit keeps the
    reservation-mode transcripts, which equal the JAX engine's, and needs
    fewer engine steps."""
    sizes = {"vocab_size": 97, "d_model": 32, "d_ff": 64, "max_seq_len": 64}
    jm, tm = _pair(41, **sizes)
    want, _, _ = _overcommit_scenario(jm, JEngine, JRequest, scheduler="python")
    base, eng0, _ = _overcommit_scenario(tm, ContinuousBatchingEngine, Request, device="cpu")
    over, eng1, _ = _overcommit_scenario(tm, ContinuousBatchingEngine, Request, device="cpu",
                                         overcommit=True)
    assert base == want and over == base
    st = eng1.stats
    assert "preemptions" in st and "pages_reserved" in st
    assert eng1.steps < eng0.steps


def test_fault5_int4_needs_an_even_page(mha):
    """Reference fault 5: the JAX engine accepts kv_bits=4 with an odd
    page_size; the port raises."""
    _, tm = mha
    with pytest.raises(ValueError, match="even"):
        ContinuousBatchingEngine(tm, device="cpu", paged=True, kv_bits=4, page_size=7)
    with pytest.raises(ValueError, match="kv_bits"):
        ContinuousBatchingEngine(tm, device="cpu", paged=True, kv_bits=6)


@pytest.mark.parametrize("option,value", [
    ("n_pages", 64), ("page_size", 16), ("kv_bits", 4), ("overcommit", True),
    ("overlap_admission", True), ("prefix_cache", False)])
def test_paged_options_need_paged(mha, option, value):
    _, tm = mha
    with pytest.raises(ValueError, match="paged=True"):
        ContinuousBatchingEngine(tm, device="cpu", **{option: value})


def test_prefix_pages_shared_then_cached_then_reused(mha):
    """Two concurrent requests with a two-page system prompt hold the SAME
    physical pages; once both finish the pages idle in the LRU; a later
    request resurrects them; a full page-aligned match recomputes its last
    page into a fresh page and leaves the shared ones untouched."""
    _, tm = mha
    system = list(range(1, 1 + 2 * PS))
    eng = ContinuousBatchingEngine(tm, max_slots=2, max_seq_len=64, paged=True,
                                   page_size=PS, device="cpu")
    reqs = [Request(prompt=system + [40 + i], max_new_tokens=3) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    t = eng._pt_host.copy()
    assert t[0][0] == t[1][0] and t[0][1] == t[1][1]
    assert (eng._pt_dev.numpy() == t).all()
    eng.run_to_completion()
    assert len(eng.alloc.cached) == 2 and eng.stats["prefix_cached_pages"] == 2
    holder = Request(prompt=system + [50], max_new_tokens=20)
    eng.submit(holder)
    eng.step()
    assert len(eng.alloc.cached) == 0 and eng.alloc.prefix_hits >= 3
    shared = list(eng.alloc.slot_pages[0][:2])
    kq_before = eng.caches[0].kq.clone()
    full = Request(prompt=system, max_new_tokens=3)
    eng.submit(full)
    eng.step()
    t = eng._pt_host
    assert t[1][0] == t[0][0] and t[1][1] != t[0][1]
    for p in shared:
        assert torch.equal(eng.caches[0].kq[p], kq_before[p])
    eng.run_to_completion()
    assert holder.error is None and len(holder.generated) == 20
    assert full.error is None and len(full.generated) == 3


def test_backpressure_never_fit_and_cancel_release(mha):
    """An undersized pool makes admissions wait instead of failing; a
    request larger than the whole pool finishes with an error; cancelling
    an active request frees its pages at once."""
    _, tm = mha
    eng = ContinuousBatchingEngine(tm, max_slots=3, max_seq_len=64, paged=True,
                                   page_size=PS, n_pages=7, prefix_cache=False,
                                   device="cpu")
    big = Request(prompt=[1] * 30, max_new_tokens=20)           # 7 pages > 6
    reqs = [Request(prompt=[2 + i] * 10, max_new_tokens=10) for i in range(3)]
    for r in [big] + reqs:
        eng.submit(r)
    eng.step()
    assert big.done and "pages" in big.error
    assert eng.book.num_active == 2 and eng.book.num_waiting == 1   # 3 + 3 pages
    in_use = eng.stats["pages_in_use"]
    assert eng.cancel(reqs[0].id) and reqs[0].cancelled
    assert eng.stats["pages_in_use"] == in_use - 3
    fin = eng.run_to_completion()
    assert {r.id for r in fin} == {big.id} | {r.id for r in reqs}
    assert all(len(r.generated) == 10 for r in reqs[1:])
    assert eng.stats["pages_in_use"] == 0
