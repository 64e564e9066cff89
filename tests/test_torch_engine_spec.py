"""Port parity for the engine's speculative decoding (``draft_model``,
``spec_gamma``; qgemm_tpu_torch/serving/engine.py) against the port's plain
engine and against the JAX engine's speculative tier
(qgemm_tpu/serving/engine.py) on the CPU, with the same weights on both
sides (the interop loader carries the JAX models' leaves over). Mirrors the
non-tensor-parallel speculative tests of tests/test_gpt_serving.py and
tests/test_moe.py, and adds over-commit preemption, fault recovery and the
speculative graphs' host logic (``DecodeGraphs`` with the CUDA capture
replaced by a stub).

Greedy transcripts are compared exactly (float32, as JAX's tests do:
there the verify chunk and single-step decode give equal argmaxes), and so
are the acceptance counters against JAX's; logprobs to 1e-4 (float32,
summed in other orders). Sampled rounds are checked by a total-variation
bound against the target's analytic distribution.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu.ops.sampling import warped_probs as j_warped_probs
from qgemm_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from qgemm_tpu.serving.engine import Request as JRequest
from qgemm_tpu_torch.models.gpt import GPTConfig
from qgemm_tpu_torch.serving.decode_graph import DecodeGraphs
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params
from qgemm_tpu_torch.utils.testing import use_test_threads
from test_torch_gpt import SIZES, jax_params

use_test_threads()

GAMMA = 3
LP_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _pair(seed: int, quantize: bool = False, **overrides):
    sizes = {**SIZES, **overrides}
    jm = JGPT.init(JConfig(**sizes), key=jax.random.PRNGKey(seed))
    if quantize:
        jm = jm.quantize()
    return jm, gpt_from_jax_params(jax_params(jm), GPTConfig(**sizes), device="cpu")


def _serve(engine_cls, req_cls, model, spec, max_slots=2, **kw):
    """Serve ``spec`` [(prompt, max_new_tokens, eos)] to completion; ->
    (requests in submission order, engine)."""
    eng = engine_cls(model, max_slots=max_slots, **kw)
    reqs = [req_cls(prompt=p, max_new_tokens=m, eos_token=e, logprobs=True)
            for p, m, e in spec]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_steps=300)
    assert all(r.done and r.error is None for r in reqs), [r.error for r in reqs]
    return reqs, eng


def _port(model, spec, **kw):
    return _serve(ContinuousBatchingEngine, Request, model, spec, device="cpu", **kw)


def _toks(reqs):
    return [list(r.generated) for r in reqs]


def _eos(model, **kw) -> int:
    """A token the model emits early (the JAX suite's probe): a mid-block
    EOS for two of the requests."""
    reqs, _ = _port(model, [([5, 6, 7], 6, None)], max_slots=1, **kw)
    return reqs[0].generated[3]


# the JAX suite's scenarios: (model overrides, the requests after the EOS
# probe, engine options); the paged one's 125-token prompt decodes across
# a page edge inside one verify chunk
def _dense_spec(eos):
    return [([5, 6, 7], 6, eos), ([8, 9], 11, None), ([1] * 7, 3, None), ([2, 3], 9, eos),
            ([4] * 5, 7, None)]


def _paged_spec(eos):
    return [([5, 6, 7], 6, eos), ([8, 9], 11, None), ([1] * 125, 7, None), ([2, 3], 9, eos),
            ([4] * 5, 7, None)]


CASES = {"dense": (81, {}, _dense_spec, {}),
         "paged": (84, {"max_seq_len": 256}, _paged_spec, {"paged": True})}


@functools.lru_cache(maxsize=None)
def _jax_spec(kind: str, draft: str):
    seed, over, spec_fn, kw = CASES[kind]
    jm, tm = _pair(seed, **over)
    jd = jm if draft == "self" else _pair(seed + 1, **over)[0]
    spec = spec_fn(_eos(tm, **kw))
    reqs, eng = _serve(JEngine, JRequest, jm, spec, scheduler="python", draft_model=jd,
                       spec_gamma=GAMMA, **kw)
    return _toks(reqs), [list(r.token_logprobs) for r in reqs], eng.stats, eng.steps


@pytest.mark.parametrize("draft", ["self", "random"])
@pytest.mark.parametrize("kind", list(CASES))
def test_spec_matches_plain_and_jax(kind, draft):
    """Self draft and an unrelated random draft, EOS mid-block, mixed
    lengths, slot churn: transcripts equal the plain engine's and JAX's
    speculative engine's, and so do the rounds, the acceptance and the
    scheduler steps; one logprob per token, JAX's to 1e-4."""
    seed, over, spec_fn, kw = CASES[kind]
    _, tm = _pair(seed, **over)
    td = tm if draft == "self" else _pair(seed + 1, **over)[1]
    spec = spec_fn(_eos(tm, **kw))
    plain, _ = _port(tm, spec, **kw)
    got, eng = _port(tm, spec, draft_model=td, spec_gamma=GAMMA, **kw)
    want, want_lps, want_stats, want_steps = _jax_spec(kind, draft)
    assert _toks(got) == _toks(plain) == want
    st = eng.stats
    assert (st["spec_rounds"], st["spec_acceptance"], eng.steps) == \
        (want_stats["spec_rounds"], want_stats["spec_acceptance"], want_steps)
    for r, wl in zip(got, want_lps):
        assert len(r.token_logprobs) == len(r.generated)
        np.testing.assert_allclose(r.token_logprobs, wl, atol=LP_TOL, rtol=0)
    assert st["tokens_generated"] == sum(len(r.generated) for r in got)
    if draft == "self":
        assert eng.steps < st["tokens_generated"]           # blocks accepted
    if eng.paged:
        assert eng.alloc.n_free == eng.caches[0].n_pages - 1      # every page back


def test_spec_engine_geometry():
    """Every extent and reservation covers a round's gamma + 2 rows: the
    dense caches (target and draft), the paged table (one page more, the
    parking column after it) and a slot's reservation."""
    _, tm = _pair(81)
    eng = ContinuousBatchingEngine(tm, max_slots=2, max_seq_len=40, device="cpu",
                                   draft_model=tm, spec_gamma=GAMMA, quantized_cache=True)
    assert eng.spec_extra == GAMMA + 2
    assert eng.caches[0].kq.shape[2] == 40 + GAMMA + 2
    assert [tuple(t.shape) for t in eng.draft_caches[0]] == [(2, 4, 45, 8)] * 2
    assert eng.draft_caches[0][0].dtype == torch.float32
    peng = ContinuousBatchingEngine(tm, max_slots=2, max_seq_len=40, device="cpu", paged=True,
                                    page_size=16, draft_model=tm, spec_gamma=GAMMA)
    assert peng.max_seq_len == 48 and peng.alloc.pages_per_slot == 4
    assert peng._pt_host.shape == (2, 5) and peng._park_pos == 64
    assert peng.draft_caches[0][0].shape[2] == 48 + GAMMA + 2
    r = Request(prompt=[1, 2, 3], max_new_tokens=20)
    peng.submit(r)
    peng.step()
    assert peng._slot_worst[0] == 23 + GAMMA + 2 and len(peng.alloc.slot_pages[0]) == 2


def test_spec_int8_cache_matches_plain():
    _, tm = _pair(81)
    spec = [([5 + i, 6, 7], 8, None) for i in range(3)]
    plain, _ = _port(tm, spec, quantized_cache=True)
    got, _ = _port(tm, spec, quantized_cache=True, draft_model=tm, spec_gamma=GAMMA)
    assert _toks(got) == _toks(plain)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_spec_paged_prefix_cache_and_overlap(kv_bits):
    """Repeated 130-token prompts share prefix pages and verify
    speculatively; with chunked, overlapped admission the resident slots
    take plain steps between an admission's chunks. Transcripts equal the
    plain paged engine's; prefix hits fire."""
    _, tm = _pair(86, max_seq_len=384)
    shared = list((np.arange(130) % 89) + 1)
    spec = [(shared + [7 + i], 6, None) for i in range(4)]
    for kw in (dict(paged=True, kv_bits=kv_bits, page_size=32),
               dict(paged=True, kv_bits=kv_bits, page_size=32, chunked_prefill=64,
                    overlap_admission=True)):
        plain, _ = _port(tm, spec, **kw)
        got, eng = _port(tm, spec, draft_model=tm, spec_gamma=GAMMA, **kw)
        assert _toks(got) == _toks(plain), kw
        assert eng.alloc.prefix_hits > 0 and eng.spec_rounds > 0


def test_spec_round_matches_target_distribution():
    """The sampled round's first token per slot, over 512 rounds of 4 slots
    from one state, against the target's analytic warped distribution
    (JAX's model, the same weights), with a mismatched draft and per-slot
    knobs (temperature, top-k, top-p) forcing rejections; the draft's own
    distribution is far off, so the bound discriminates. 512 draws over 8
    tokens per slot: expected TV about 0.05; the bound 0.12."""
    small = dict(vocab_size=8, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=32)
    (jt, tt), (jd, td) = _pair(21, **small), _pair(22, **small)
    eng = ContinuousBatchingEngine(tt, max_slots=4, max_seq_len=16, device="cpu",
                                   draft_model=td, spec_gamma=GAMMA, seed=9)
    temps, topks, topps = [1.0, 0.7, 1.3, 1.0], [0, 0, 3, 0], [1.0, 0.9, 1.0, 0.8]
    prompt = torch.tensor([[1, 2, 3]])
    for s in range(4):
        eng._prefill_impl(prompt, 3, s, 0.0, 1.0, 0)
        eng._draft_prefill_impl(prompt, s)
    eng._temps_dev.copy_(torch.tensor(temps))
    eng._topks_dev.copy_(torch.tensor(topks))
    eng._topps_dev.copy_(torch.tensor(topps))
    eng._active_dev.fill_(1)
    rounds = 512
    first = np.zeros((rounds, 4), np.int64)
    for i in range(rounds):
        eng.positions.fill_(3)
        eng.cur_tokens.fill_(4)
        eng._ring_idx.zero_()
        eng._spec_body("spec_sampled")
        first[i] = eng._spec_ring[0, :, 0].numpy()

    def dist(m, s):
        cache = m.init_cache(1, 16)
        _, cache = m.prefill(jnp.asarray([[1, 2, 3]]), cache)
        lg, _ = m.decode_step(jnp.asarray([[4]]), 3, cache)
        return np.asarray(j_warped_probs(lg, temps[s], topks[s], topps[s]))[0]

    for s in range(4):
        p = dist(jt, s)
        emp = np.bincount(first[:, s], minlength=8) / rounds
        tv = 0.5 * np.abs(emp - p).sum()
        tv_draft = 0.5 * np.abs(dist(jd, s) - p).sum()
        assert tv < 0.12 and tv < 0.5 * tv_draft, (s, tv, tv_draft)


def test_spec_sampled_and_greedy_share_a_batch():
    """A greedy slot beside sampled ones (temperature, top-p) keeps the
    plain engine's transcript, the sampled requests complete with valid
    tokens, blocks are accepted, and a temperature of 1e-9 is greedy."""
    _, tm = _pair(90)
    eng = ContinuousBatchingEngine(tm, max_slots=3, device="cpu", draft_model=tm,
                                   spec_gamma=GAMMA, seed=11)
    g = Request(prompt=[5, 6], max_new_tokens=12)
    h1 = Request(prompt=[7, 8], max_new_tokens=10, temperature=0.9)
    h2 = Request(prompt=[9], max_new_tokens=8, temperature=1.2, top_p=0.9, top_k=20)
    tiny = Request(prompt=[3, 4], max_new_tokens=9, temperature=1e-9)
    for r in (g, h1, h2, tiny):
        eng.submit(r)
    eng.run_to_completion(max_steps=100)
    assert all(r.error is None for r in (g, h1, h2, tiny))
    assert len(h1.generated) == 10 and len(h2.generated) == 8
    assert all(0 <= t < SIZES["vocab_size"] for t in h1.generated + h2.generated)
    plain, _ = _port(tm, [([5, 6], 12, None), ([3, 4], 9, None)], max_slots=1)
    assert [g.generated, tiny.generated] == _toks(plain)
    assert eng.steps < sum(len(r.generated) for r in (g, h1, h2, tiny))


@pytest.mark.parametrize("paged", [False, True])
def test_spec_multi_step_matches_single(paged):
    """Three rounds a dispatch (positions chained through them on the
    device), EOS mid-block and slot churn: the plain engine's transcripts,
    aligned logprobs, and fewer dispatches than the single-round engine."""
    _, tm = _pair(92, max_seq_len=256)
    kw = {"paged": True} if paged else {}
    eos = _eos(tm)
    spec = [([5, 6, 7], 6, eos), ([8, 9], 11, None), ([1] * 7, 14, None), ([2, 3], 9, eos)]
    plain, _ = _port(tm, spec, **kw)
    one, one_eng = _port(tm, spec, draft_model=tm, spec_gamma=GAMMA, **kw)
    got, eng = _port(tm, spec, draft_model=tm, spec_gamma=GAMMA, multi_step=3, **kw)
    assert _toks(got) == _toks(one) == _toks(plain)
    for r, o in zip(got, one):
        np.testing.assert_allclose(r.token_logprobs, o.token_logprobs, atol=LP_TOL, rtol=0)
    assert eng.steps < sum(len(r.generated) for r in got)
    assert len(eng._itl) < len(one_eng._itl)
    assert eng.spec_device_rounds % 3 == 0


def test_spec_stop_tokens():
    """Stop tokens finish a request mid-block in every speculative mode,
    as in the plain engine."""
    _, tm = _pair(98)
    plain, _ = _port(tm, [([5, 6, 7], 8, None)], max_slots=1)
    gen = plain[0].generated
    first_at = {t: gen.index(t) for t in set(gen)}
    tok, idx = max(first_at.items(), key=lambda kv: kv[1])
    assert idx >= 2

    def run(**kw):
        eng = ContinuousBatchingEngine(tm, max_slots=2, device="cpu", **kw)
        reqs = [Request(prompt=[5, 6, 7], max_new_tokens=8, stop_tokens=[tok, 96]),
                Request(prompt=[8, 9], max_new_tokens=6)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion(max_steps=60)
        return [(tuple(r.generated), r.error) for r in reqs]

    ref = run()
    assert len(ref[0][0]) == idx + 1 and len(ref[1][0]) == 6
    assert run(draft_model=tm, spec_gamma=GAMMA) == ref
    assert run(paged=True, draft_model=tm, spec_gamma=GAMMA, multi_step=3) == ref


def test_spec_dense_chunked_prefill():
    """Long prompts admitted in dense chunks while rounds serve the rest:
    the plain engine's transcripts (the draft prefills the whole bucket)."""
    _, tm = _pair(7, max_seq_len=512)
    spec = [([1 + i] * (150 + i * 30), 6, None) for i in range(3)]
    plain, _ = _port(tm, spec)
    got, eng = _port(tm, spec, draft_model=tm, spec_gamma=GAMMA, chunked_prefill=64)
    assert _toks(got) == _toks(plain) and eng.spec_rounds > 0


def test_spec_acceptance_stats():
    """Acceptance near 1 for the self draft, near 0 for a random one."""
    _, tm = _pair(100)
    spec = [([5 + i, 6], 8, None) for i in range(3)]
    _, eng = _port(tm, spec, draft_model=tm, spec_gamma=GAMMA)
    assert eng.stats["spec_rounds"] > 0 and eng.stats["spec_acceptance"] > 0.9
    _, eng = _port(tm, spec, draft_model=_pair(101)[1], spec_gamma=GAMMA)
    assert eng.stats["spec_acceptance"] < 0.3


def test_spec_overcommit_preemption():
    """Over-commit with a draft: the pool is too small for the residents'
    growth, so decode growth preempts; every request still finishes with
    the transcript the reservation engine gives."""
    _, tm = _pair(41)
    spec = [([3 + i, 5, 7], n, None) for i, n in enumerate([40, 4, 4, 40, 4, 4])]
    kw = dict(max_slots=3, paged=True, page_size=8, draft_model=tm, spec_gamma=GAMMA)
    ref, _ = _port(tm, spec, **kw)
    got, eng = _port(tm, spec, n_pages=10, overcommit=True, **kw)
    assert eng.preemptions >= 1
    assert _toks(got) == _toks(ref)
    assert eng.alloc.n_free == eng.caches[0].n_pages - 1


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_fault_recovers(kind):
    """A fault in the second speculative round: both requests in flight
    fail with the error, the target's and the draft's caches are rebuilt
    (as a new engine holds them), and a later request gets a fresh
    engine's transcript."""
    _, tm = _pair(21)
    kw = dict(draft_model=tm, spec_gamma=GAMMA, quantized_cache=True) if kind == "dense" \
        else dict(draft_model=tm, spec_gamma=GAMMA, paged=True, page_size=8)
    eng = ContinuousBatchingEngine(tm, max_slots=2, device="cpu", **kw)
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
    old_draft = eng.draft_caches
    while not doomed[0].done:
        eng.step()
    assert calls["n"] == 2
    assert all(r.done and "injected spec fault" in r.error for r in doomed)
    assert eng.book.num_active == 0 and int(eng.positions.abs().sum()) == 0
    assert eng.draft_caches is not old_draft
    assert all(int(t.abs().sum()) == 0 for c in eng.draft_caches for t in c)
    new = ContinuousBatchingEngine(tm, max_slots=2, device="cpu", **kw)
    if eng.paged:
        assert len(eng.alloc.free) == eng.caches[0].n_pages - 1
    else:
        assert all(torch.equal(a, b) for c, n in zip(eng.caches, new.caches)
                   for a, b in zip(c, n))
    later = Request(prompt=[6, 7, 8], max_new_tokens=9)
    eng.submit(later)
    eng.run_to_completion(max_steps=100)
    fresh, _ = _port(tm, [([6, 7, 8], 9, None)], **kw)
    assert later.error is None and later.generated == fresh[0].generated


@pytest.mark.parametrize("paged", [False, True])
def test_spec_moe_target(paged):
    """An MoE target (int8 experts) speculates with itself and with an
    unrelated draft: the plain MoE engine's transcripts."""
    moe = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=128,
               n_experts=4, moe_top_k=2)
    _, tm = _pair(7, quantize=True, **moe)
    _, other = _pair(8, quantize=True, **moe)
    spec = [([1 + i, 2, 3], 6, None) for i in range(3)]
    kw = {"paged": True} if paged else {}
    plain, _ = _port(tm, spec, **kw)
    for draft in (tm, other):
        got, _ = _port(tm, spec, draft_model=draft, spec_gamma=GAMMA, **kw)
        assert _toks(got) == _toks(plain)


class _EngineStub(DecodeGraphs):
    """Capture records nothing; a replay runs the engine's step eagerly."""

    def _capture_stream(self):
        return contextlib.nullcontext()

    def _record(self, mode):
        return mode

    def _replay(self, graph):
        self._step(graph)


@pytest.mark.parametrize("kind", ["dense_int8", "paged_int8"])
def test_spec_graphs_on_stubs_match_eager(kind):
    """The graph route's logic for speculative rounds (one graph per mode,
    greedy and sampled rounds and plain steps side by side, ``multi_step``
    replays, the spec ring read once a dispatch) on the CPU: transcripts
    equal the eager route's; the sampled graphs register the generator."""
    _, tm = _pair(74)
    kw = dict(quantized_cache=True) if kind == "dense_int8" else dict(paged=True, page_size=8)
    kw.update(draft_model=tm, spec_gamma=GAMMA, multi_step=2, max_slots=2, seed=4)
    spec = [([5, 6, 7], 9, None), ([8, 9], 11, None), ([1] * 7, 5, None)]

    def run(stub: bool):
        eng = ContinuousBatchingEngine(tm, device="cpu", **kw)
        if stub:
            eng._graphs = _EngineStub(eng._body, eng.device, eng._gen)
        reqs = [Request(prompt=p, max_new_tokens=n, temperature=0.8 if i == 1 else 0.0)
                for i, (p, n, _) in enumerate(spec)]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion(max_steps=200)
        assert all(r.error is None for r in reqs)
        return _toks(reqs), eng

    want, _ = run(False)
    got, eng = run(True)
    assert got == want
    modes = set(eng._graphs._graphs)
    assert {"spec_sampled", "greedy"} <= modes or {"spec_greedy", "sampled"} <= modes or \
        "spec_sampled" in modes
    assert all(m in ("greedy", "sampled", "spec_greedy", "spec_sampled") for m in modes)
    assert eng._graphs.captures == len(modes) and eng._graphs.replays > 0
