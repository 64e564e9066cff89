"""Port parity for the continuous-batching engine
(qgemm_tpu_torch/serving/engine.py) against qgemm_tpu/serving/engine.py on
the CPU, with the same int8 weights in both (carried over by the interop
loader). Greedy transcripts are compared exactly; sampled ones only for
validity (the random streams differ by design)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from qgemm_tpu.serving.engine import Request as JRequest
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from qgemm_tpu_torch.utils.testing import use_test_threads
from test_torch_gpt import model_pair

use_test_threads()

PROMPTS = [[3, 1, 4], [2, 7, 1, 8, 2, 8], [9], [5, 5, 5, 5], [6, 1, 6, 1, 6, 1, 6, 1, 6]]
N_NEW = [5, 3, 6, 4, 7]


def _run(engine_cls, req_cls, model, **kw):
    """Staggered arrivals: three requests now, the rest after two steps."""
    eng = engine_cls(model, max_slots=2, max_seq_len=32, **kw)
    reqs = [req_cls(prompt=p, max_new_tokens=n) for p, n in zip(PROMPTS, N_NEW)]
    for r in reqs[:3]:
        eng.submit(r)
    eng.step()
    eng.step()
    for r in reqs[3:]:
        eng.submit(r)
    finished = eng.run_to_completion()
    assert len(finished) == len(reqs)
    return [r.generated for r in reqs], eng


@pytest.mark.parametrize("quantized_cache", [True, False])
def test_engine_transcripts_match_jax_engine(quantized_cache):
    jm, tm = model_pair(7, quantize=True)
    want, _ = _run(JEngine, JRequest, jm, scheduler="python",
                   quantized_cache=quantized_cache)
    got, eng = _run(ContinuousBatchingEngine, Request, tm, device="cpu",
                    quantized_cache=quantized_cache)
    assert got == want
    # and each equals the model's own isolated greedy generation
    for p, n, g in zip(PROMPTS, N_NEW, got):
        iso = tm.generate(torch.tensor([p]), n, quantized_cache=quantized_cache)
        assert iso[0].tolist() == g
    st = eng.stats
    assert st["tokens_generated"] == sum(N_NEW) and st["tokens_per_s"] > 0


def test_engine_eos_and_stop_tokens_free_slot():
    _, tm = model_pair(8, quantize=True)
    first = int(tm.generate(torch.tensor([[7, 7]]), 1)[0, 0])
    eng = ContinuousBatchingEngine(tm, max_slots=1, max_seq_len=32, device="cpu")
    a = Request(prompt=[7, 7], max_new_tokens=10, eos_token=first)
    ref = tm.generate(torch.tensor([[4, 2]]), 10)[0].tolist()
    b = Request(prompt=[4, 2], max_new_tokens=10, stop_tokens=[ref[2]])
    eng.submit(a)
    eng.submit(b)
    done = eng.run_to_completion()
    assert a.generated == [first] and a.done
    assert b.generated == ref[:ref.index(ref[2]) + 1] and b.done
    assert [r.id for r in done] == [a.id, b.id]


def test_engine_cancel_and_logprobs():
    _, tm = model_pair(9, quantize=True)
    eng = ContinuousBatchingEngine(tm, max_slots=1, max_seq_len=32, device="cpu")
    a = Request(prompt=[1, 2, 3], max_new_tokens=20, logprobs=True)
    b = Request(prompt=[4, 5], max_new_tokens=5)
    eng.submit(a)
    eng.submit(b)
    eng.step()
    eng.step()
    assert eng.cancel(b.id)                        # waiting
    assert eng.cancel(a.id)                        # active: slot frees
    assert not eng.cancel(a.id)
    assert a.cancelled and b.cancelled and a.done and b.done
    assert len(a.generated) == 3 and b.generated == []
    assert len(a.token_logprobs) == 3 and all(lp <= 0 for lp in a.token_logprobs)
    logits = tm.forward(torch.tensor([[1, 2, 3]]))[0, -1]
    lp0 = torch.log_softmax(logits, -1)[a.generated[0]]
    assert abs(a.token_logprobs[0] - float(lp0)) < 1e-4
    c = Request(prompt=[6], max_new_tokens=2)
    eng.submit(c)
    eng.run_to_completion()
    assert c.done and len(c.generated) == 2


def test_engine_sampling_and_prefill_error_isolation():
    _, tm = model_pair(10, quantize=True)
    eng = ContinuousBatchingEngine(tm, max_slots=2, max_seq_len=32, device="cpu",
                                   top_k=5, seed=3)
    ok = Request(prompt=[1, 2], max_new_tokens=6, temperature=0.8, top_p=0.9)
    bad = Request(prompt=[3, 4], max_new_tokens=3)
    eng.submit(ok)
    eng.submit(bad)
    real = eng._prefill_impl

    def failing(prompt, plen, slot, *args):
        if plen == 2 and int(prompt[0, 0]) == 3:
            raise RuntimeError("injected prefill fault")
        return real(prompt, plen, slot, *args)

    eng._prefill_impl = failing
    done = eng.run_to_completion()
    assert {r.id for r in done} == {ok.id, bad.id}
    assert bad.error and "injected" in bad.error and bad.generated == []
    assert ok.error is None and len(ok.generated) == 6
    assert all(0 <= t < 97 for t in ok.generated)


@pytest.mark.parametrize("option,value", [
    ("paged", True), ("draft_model", object()), ("chunked_prefill", 16),
    ("multi_step", 4), ("mesh", object()), ("overcommit", True),
    ("overlap_admission", True), ("kv_bits", 4), ("scheduler", "native")])
def test_engine_unported_options_raise(option, value):
    _, tm = model_pair(11, quantize=True)
    with pytest.raises(NotImplementedError, match=option):
        ContinuousBatchingEngine(tm, device="cpu", **{option: value})


@pytest.mark.parametrize("option,value", [
    ("n_pages", 64), ("page_size", 128), ("prefix_cache", False), ("spec_gamma", 2)])
def test_engine_rejects_knobs_of_unported_modes(option, value):
    """The paged and speculative modes' knobs are not accepted and ignored:
    passing one is an error."""
    _, tm = model_pair(11, quantize=True)
    with pytest.raises(TypeError, match=option):
        ContinuousBatchingEngine(tm, device="cpu", **{option: value})
