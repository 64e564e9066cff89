"""Port parity for the encoder-decoder engine's speculative decoding and its
decode graphs' host logic (qgemm_tpu_torch/serving/seq2seq.py) against the
port's plain engine and the JAX engine's speculative tier
(qgemm_tpu/serving/seq2seq.py) on the CPU, the same weights on both sides.

Greedy transcripts are compared exactly (float32) and so are the
speculative counters against JAX's; logprobs to 1e-4. Sampled rounds are
held to the target's analytic distribution by a total-variation bound.
``DecodeGraphs``' CUDA calls are replaced by a stub whose capture records
nothing and whose replay runs the step eagerly, as
tests/test_torch_engine_spec.py does for the GPT engine.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.ops.sampling import warped_probs as j_warped_probs
from qgemm_tpu.serving.engine import Request as JRequest
from qgemm_tpu.serving.seq2seq import Seq2SeqEngine as JEngine
from qgemm_tpu_torch.serving.decode_graph import DecodeGraphs
from qgemm_tpu_torch.serving.engine import Request
from qgemm_tpu_torch.serving.seq2seq import Seq2SeqEngine
from qgemm_tpu_torch.utils.testing import use_test_threads
from test_torch_seq2seq import pair, port, serve, toks

use_test_threads()

GAMMA = 3


def _eos(model) -> int:
    """A token the model emits early: a mid-block EOS for two requests."""
    reqs, _ = port(model, [([5, 6, 7], 6)], max_slots=1, max_new_tokens=20)
    return reqs[0].generated[3]


def _spec(eos):
    return [([5, 6, 7], 6, eos), ([8, 9], 11), ([1] * 7, 9), ([2, 3, 4, 5], 8, eos),
            ([4] * 5, 7)]


@functools.lru_cache(maxsize=None)
def _jax_spec(draft: str, key: tuple):
    jm, tm = pair(61)
    jd = jm if draft == "self" else pair(62)[0]
    reqs, eng = serve(JEngine, JRequest, jm, _spec(_eos(tm)), max_slots=2, max_new_tokens=20,
                      draft_model=jd, spec_gamma=GAMMA, **dict(key))
    st = eng.stats
    return toks(reqs), [list(r.token_logprobs) for r in reqs], \
        (st["spec_rounds"], st["spec_acceptance"]), eng.steps


@pytest.mark.parametrize("draft,kw", [("self", {}), ("other", {}), ("self", {"multi_step": 3}),
                                      ("self", {"paged": True, "page_size": 8}),
                                      ("other", {"paged": True, "page_size": 8,
                                                 "multi_step": 3})],
                         ids=["self", "other", "self_ms3", "self_paged", "other_paged_ms3"])
def test_spec_matches_plain_and_jax(draft, kw):
    """Greedy speculative transcripts equal the plain engine's and the JAX
    speculative engine's, EOS mid-block and slot churn included; logprobs
    align (1e-4); the rounds and acceptance counters and the scheduler
    steps equal JAX's; a self-draft takes fewer steps than tokens."""
    _, tm = pair(61)
    td = tm if draft == "self" else pair(62)[1]
    spec = _spec(_eos(tm))
    plain, _ = port(tm, spec, max_slots=2, max_new_tokens=20)
    reqs, eng = port(tm, spec, max_slots=2, max_new_tokens=20, draft_model=td,
                     spec_gamma=GAMMA, **kw)
    want, want_lp, counters, steps = _jax_spec(draft, tuple(sorted(kw.items())))
    assert toks(reqs) == toks(plain) == want
    for r, lp in zip(reqs, want_lp):
        assert len(r.token_logprobs) == len(r.generated)
        assert np.allclose(r.token_logprobs, lp, rtol=0, atol=1e-4)
    st = eng.stats
    assert (st["spec_rounds"], st["spec_acceptance"]) == counters and eng.steps == steps
    if draft == "self":
        assert eng.steps < sum(len(r.generated) for r in reqs)
    if kw.get("paged"):
        assert st["pages_in_use"] == 0


def test_spec_geometry_and_int8():
    """Speculation widens the self-cache extent (and the draft's) by gamma
    + 2; the draft's cross K/V are float in its dtype; with the int8
    self-cache and cross K/V the greedy transcripts equal the plain int8
    engine's."""
    _, tm = pair(63)
    eng = Seq2SeqEngine(tm, max_slots=2, max_new_tokens=20, device="cpu", draft_model=tm,
                        spec_gamma=GAMMA, quantized_cache=True)
    assert eng.caches[0].kq.shape[2] == 21 + GAMMA + 2
    assert eng.draft_caches[0][0].shape[2] == 21 + GAMMA + 2
    assert eng.draft_enc_kvs[0][0].dtype == torch.float32 and len(eng.draft_enc_kvs[0]) == 2
    spec = _spec(None)
    plain, _ = port(tm, spec, max_slots=2, max_new_tokens=20, quantized_cache=True)
    got, _ = port(tm, spec, max_slots=2, max_new_tokens=20, quantized_cache=True,
                  draft_model=tm, spec_gamma=GAMMA)
    assert toks(got) == toks(plain)


def test_spec_mixed_sampling_and_distribution():
    """A greedy slot beside sampled ones keeps the plain engine's transcript
    and the sampled requests complete; the sampled round's first token per
    slot, over 512 rounds of 4 slots from one state, against the target's
    analytic warped distribution (JAX's model, the same weights) with a
    mismatched draft and per-slot knobs: 512 draws over 8 tokens per slot,
    expected TV about 0.05, bound 0.12 and under half the draft's."""
    _, tm = pair(63)
    eng = Seq2SeqEngine(tm, max_slots=3, max_new_tokens=20, device="cpu", draft_model=tm,
                        spec_gamma=GAMMA, seed=9)
    g = Request(prompt=[5, 6], max_new_tokens=12)
    h1 = Request(prompt=[7, 8, 9], max_new_tokens=10, temperature=0.9)
    h2 = Request(prompt=[9], max_new_tokens=8, temperature=1.2, top_p=0.9)
    for r in (g, h1, h2):
        eng.submit(r)
    eng.run_to_completion(max_steps=100)
    assert all(r.error is None for r in (g, h1, h2))
    assert len(h1.generated) == 10 and len(h2.generated) == 8
    plain, _ = port(tm, [([5, 6], 12)], max_slots=1, max_new_tokens=20)
    assert g.generated == plain[0].generated

    small = dict(vocab_size=8)
    (jt, tt), (jd, td) = pair(21, **small), pair(22, **small)
    eng = Seq2SeqEngine(tt, max_slots=4, max_new_tokens=16, device="cpu", draft_model=td,
                        spec_gamma=GAMMA, seed=9)
    temps, topks, topps = [1.0, 0.7, 1.3, 1.0], [0, 0, 3, 0], [1.0, 0.9, 1.0, 0.8]
    src = torch.tensor([[3, 4, 5]])
    for s in range(4):
        eng._prefill_impl(src, s, 0.0, 1.0, 0)
        eng._draft_admit_impl(src, s)
    eng.src_lens.fill_(3)
    eng._temps_dev.copy_(torch.tensor(temps))
    eng._topks_dev.copy_(torch.tensor(topks))
    eng._topps_dev.copy_(torch.tensor(topps))
    eng._active_dev.fill_(1)
    rounds = 512
    first = np.zeros((rounds, 4), np.int64)
    for i in range(rounds):
        eng.positions.fill_(1)
        eng.cur_tokens.fill_(4)
        eng._ring_idx.zero_()
        eng._spec_body("spec_sampled")
        first[i] = eng._spec_ring[0, :, 0].numpy()

    def dist(m, s):
        kvs = [b.cross_attn.precompute_kv(m.encode(jnp.asarray([[3, 4, 5]])))
               for b in m.dec_blocks]
        caches = m.init_cache(1, 4)
        _, caches = m.decode_logits(jnp.asarray([[1]]), 0, kvs, caches)
        lg, _ = m.decode_logits(jnp.asarray([[4]]), 1, kvs, caches)
        return np.asarray(j_warped_probs(lg, temps[s], topks[s], topps[s]))[0]

    for s in range(4):
        p = dist(jt, s)
        tv = 0.5 * np.abs(np.bincount(first[:, s], minlength=8) / rounds - p).sum()
        tv_draft = 0.5 * np.abs(dist(jd, s) - p).sum()
        assert tv < 0.12 and tv < 0.5 * tv_draft, (s, tv, tv_draft)


@pytest.mark.parametrize("paged", [False, True])
def test_spec_fault_recovers(paged):
    """A fault in the second speculative round fails both requests in
    flight; the target's and the draft's self-caches are rebuilt, the
    draft's cross K/V cleared; a later request gets a fresh engine's
    transcript."""
    _, tm = pair(21)
    kw = dict(draft_model=tm, spec_gamma=GAMMA, quantized_cache=True)
    if paged:
        kw.update(paged=True, page_size=8, kv_bits=4)
    eng = Seq2SeqEngine(tm, max_slots=2, max_new_tokens=20, device="cpu", **kw)
    doomed = [Request(prompt=[1, 2, 3, 40], max_new_tokens=12, logprobs=True),
              Request(prompt=[4, 5], max_new_tokens=12)]
    for r in doomed:
        eng.submit(r)
    calls = {"n": 0}
    real = eng._spec_body

    def flaky(mode):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected spec fault")
        return real(mode)

    eng._spec_body = flaky
    while not doomed[0].done:
        eng.step()
    assert all(r.done and "injected spec fault" in r.error for r in doomed)
    assert all(int(t.abs().sum()) == 0 for c in eng.draft_caches for t in c)
    assert all(int(t.abs().sum()) == 0 for c in eng.draft_enc_kvs for t in c)
    if paged:
        assert (eng.caches[0].kv_bits, eng.caches[0].page_size) == (4, 8)
    later = [([6, 7, 8], 9)]
    got, _ = serve(lambda m, **k: eng, Request, tm, later)
    fresh, _ = port(tm, later, max_slots=2, max_new_tokens=20, **kw)
    assert toks(got) == toks(fresh)


class _EngineStub(DecodeGraphs):
    """Capture records nothing; a replay runs the engine's step eagerly."""

    def _capture_stream(self):
        return contextlib.nullcontext()

    def _record(self, mode):
        return mode

    def _replay(self, graph):
        self._step(graph)


@pytest.mark.parametrize("kw", [dict(quantized_cache=True, multi_step=2),
                                dict(paged=True, page_size=8, multi_step=2),
                                dict(quantized_cache=True, draft_model="self", multi_step=2),
                                dict(paged=True, page_size=8, draft_model="self")],
                         ids=["dense_int8_ms2", "paged_ms2", "spec_dense_ms2", "spec_paged"])
def test_graphs_on_stubs_match_eager(kw):
    """The graph route's host logic (one graph per mode, captured at first
    use, replays for every later step or round, greedy and sampled slots
    side by side, ``multi_step`` blocks, the rings read once a dispatch)
    on the CPU: transcripts equal the eager route's."""
    _, tm = pair(74)
    kw = dict(kw)
    if kw.get("draft_model") == "self":
        kw.update(draft_model=tm, spec_gamma=GAMMA)
    spec = [([5, 6, 7], 9), ([8, 9], 11), ([1] * 7, 5)]

    def run(stub: bool):
        eng = Seq2SeqEngine(tm, max_slots=2, max_new_tokens=20, device="cpu", seed=4, **kw)
        if stub:
            eng._graphs = _EngineStub(eng._body, eng.device, eng._gen)
        reqs = [Request(prompt=p, max_new_tokens=n, temperature=0.8 if i == 1 else 0.0)
                for i, (p, n) in enumerate(spec)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion(max_steps=200)
        assert all(r.error is None for r in reqs)
        return toks(reqs), eng

    want, _ = run(False)
    got, eng = run(True)
    assert got == want
    modes = set(eng._graphs._graphs)
    assert modes <= {"greedy", "sampled", "spec_greedy", "spec_sampled"} and modes
    assert eng._graphs.captures == len(modes) and eng._graphs.replays > 0
