"""Port parity for the engine's recovery from a decode fault
(``_recover_from_decode_fault`` of qgemm_tpu_torch/serving/engine.py, the
JAX engine's of qgemm_tpu/serving/engine.py) on the CPU: a fault in a
plain step, in a ``multi_step`` block and in a step between overlapped
admission chunks, over the dense cache and int8 and int4 pools. Every
in-flight request fails with ``.error`` set, its slot and pages go back,
the pools are rebuilt from the engine's own geometry (the JAX engine's
rebuild of int4 pools doubles their head width, reference fault 3: not
copied), the prefix cache is emptied, positions and tokens are zero, and
a later request gets the transcript a fresh engine gives it.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from qgemm_tpu.serving.engine import Request as JRequest
from qgemm_tpu_torch.models.gpt import GPTConfig
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params
from qgemm_tpu_torch.utils.testing import use_test_threads
from test_torch_gpt import SIZES, jax_params

use_test_threads()

PS = 8
KINDS = {"dense": dict(),
         "paged_int8": dict(paged=True, page_size=PS),
         "paged_int4": dict(paged=True, page_size=PS, kv_bits=4)}


@functools.lru_cache(maxsize=None)
def _pair(seed: int):
    jm = JGPT.init(JConfig(**SIZES), key=jax.random.PRNGKey(seed))
    return jm, gpt_from_jax_params(jax_params(jm), GPTConfig(**SIZES), device="cpu")


def _inject(eng, fail_at: int):
    """Make the engine's ``fail_at``-th decode step (from 1) raise."""
    calls = {"n": 0}
    real = eng._decode_body

    def flaky(mode):
        calls["n"] += 1
        if calls["n"] == fail_at:
            raise RuntimeError("injected decode fault")
        return real(mode)

    eng._decode_body = flaky
    return calls


def _alone(model, prompt, n, **kw):
    """A request served alone by a fresh engine with options ``kw``."""
    eng = ContinuousBatchingEngine(model, max_slots=2, device="cpu", **kw)
    req = Request(prompt=prompt, max_new_tokens=n)
    eng.submit(req)
    eng.run_to_completion(max_steps=100)
    assert req.error is None
    return req.generated


def _check_recovered(eng, shapes):
    assert int(eng.positions.abs().sum()) == 0 and int(eng.cur_tokens.abs().sum()) == 0
    assert eng.book.num_active == 0
    if eng.paged:
        a = eng.alloc
        assert not a.prefix_map and not a.cached and not a.page_hash
        assert all(not pages for pages in a.slot_pages)
        assert len(a.free) == eng.caches[0].n_pages - 1
        assert [tuple(t.shape) for c in eng.caches for t in (c.kq, c.kc, c.vq, c.vc)] == shapes
        assert all(c.page_table is eng._pt_dev for c in eng.caches)
    else:
        assert all(int(t.abs().sum()) == 0 for c in eng.caches for t in c)


def _shapes(eng):
    if not eng.paged:
        return None
    return [tuple(t.shape) for c in eng.caches for t in (c.kq, c.kc, c.vq, c.vc)]


@pytest.mark.parametrize("multi_step", [0, 4])
@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_fault_recovers(kind, multi_step):
    """A fault at the third decode step (with multi_step, inside the second
    block of 4): both in-flight requests fail with the error, and a later
    request is served as a fresh engine serves it, with nothing of the
    failed requests' published pages left to hit."""
    _, tm = _pair(21)
    kw = dict(KINDS[kind], multi_step=multi_step)
    eng = ContinuousBatchingEngine(tm, max_slots=2, device="cpu", **kw)
    shapes = _shapes(eng)
    system = list(range(1, 2 * PS + 1))           # two full pages: published
    doomed = [Request(prompt=system + [40, 41], max_new_tokens=12, logprobs=True),
              Request(prompt=system + [50], max_new_tokens=12)]
    for r in doomed:
        eng.submit(r)
    fail_at = 7 if multi_step else 3
    calls = _inject(eng, fail_at=fail_at)
    eng.step()
    if eng.paged:
        assert eng.alloc.prefix_map                   # the system prompt is published
    while not doomed[0].done:
        eng.step()
    assert calls["n"] == fail_at
    for r in doomed:
        assert r.done and "injected decode fault" in r.error
        assert r in eng.finished
    _check_recovered(eng, shapes)
    skipped = eng.prefill_tokens_skipped
    later = Request(prompt=system + [60, 61, 62], max_new_tokens=6)
    eng.submit(later)
    eng.run_to_completion(max_steps=100)
    assert later.error is None
    assert later.generated == _alone(tm, later.prompt, 6, **kw)
    if kind == "dense":
        iso = tm.generate(torch.tensor([later.prompt]), 6)[0].tolist()
        assert later.generated == iso
    if eng.paged:
        # nothing the failed requests published survived the rebuild
        assert eng.prefill_tokens_skipped == skipped


def test_dense_decode_fault_matches_jax_engine():
    """The JAX suite's ``test_engine_decode_fault_recovery`` on both engines:
    the doomed request's error, and the later request's transcript."""
    jm, tm = _pair(11)

    def run(engine_cls, req_cls, model, inject, **kw):
        eng = engine_cls(model, max_slots=2, **kw)
        doomed = req_cls(prompt=[1, 2, 3], max_new_tokens=8)
        eng.submit(doomed)
        inject(eng)
        eng.run_to_completion(max_steps=40)
        after = req_cls(prompt=[4, 5], max_new_tokens=4)
        eng.submit(after)
        eng.run_to_completion(max_steps=40)
        return doomed, after

    def jax_inject(eng):
        real, state = eng._decode, {"boom": True}

        def flaky(*args):
            if state["boom"]:
                state["boom"] = False
                raise RuntimeError("injected decode fault")
            return real(*args)

        eng._decode = flaky

    jd, ja = run(JEngine, JRequest, jm, jax_inject, scheduler="python")
    td, ta = run(ContinuousBatchingEngine, Request, tm, lambda e: _inject(e, 1), device="cpu")
    assert "injected decode fault" in jd.error and "injected decode fault" in td.error
    assert td.generated == jd.generated == [td.generated[0]]     # the prefill's token
    assert ta.error is None and ta.generated == ja.generated and len(ta.generated) == 4


@pytest.mark.parametrize("kind", ["paged_int8", "paged_int4"])
def test_overlapped_admission_tick_fault(kind):
    """A fault in the decode step between a long prompt's admission chunks:
    the resident request fails with the decode error, the admission in
    flight with the overlapped-admission error (the engine recovered
    before it reached the admission), and the engine serves on."""
    _, tm = _pair(22)
    kw = dict(KINDS[kind], chunked_prefill=16, overlap_admission=True)
    eng = ContinuousBatchingEngine(tm, max_slots=2, device="cpu", **kw)
    shapes = _shapes(eng)
    resident = Request(prompt=list(range(1, 2 * PS + 3)), max_new_tokens=20)
    eng.submit(resident)
    eng.step()                                         # admitted, one decode step
    long = Request(prompt=[(5 * i) % 97 for i in range(45)], max_new_tokens=4)
    eng.submit(long)
    calls = _inject(eng, fail_at=1)                    # the first tick: after chunk 1 of 3
    eng.step()
    assert calls["n"] == 1
    assert resident.done and "decode step failed" in resident.error
    assert long.done and "decode fault during overlapped admission" in long.error
    assert long.generated == []
    _check_recovered(eng, shapes)
    later = Request(prompt=list(range(30, 66)), max_new_tokens=5)
    eng.submit(later)
    eng.run_to_completion(max_steps=100)
    assert later.error is None and later.generated == _alone(tm, later.prompt, 5, **kw)
    assert np.all(eng._pt_host == 0)
