"""Port parity for the engine's ``multi_step`` blocks and dense
``chunked_prefill`` (qgemm_tpu_torch/serving/engine.py) against
qgemm_tpu/serving/engine.py on the CPU, with the same weights in both
(carried over by the interop loader), and the host logic of the decode
graphs (serving/decode_graph.py) with the CUDA capture replaced by a stub.

Greedy transcripts are compared exactly, logprobs to 1e-4 (float32 on
both sides, summed in other orders), or 2e-3 over an int8 or int4 cache:
the JAX engine's jitted step may flip a K/V code against the op-by-op
computation the port follows, and one code moves a logit by ~1e-3 at these
widths (tests/test_torch_gpt.py). Sampled blocks are checked only for
validity (the random streams differ by design).
"""

import contextlib
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
from qgemm_tpu_torch.ops import cuda as kernels
from qgemm_tpu_torch.ops.cuda.decode_attention import decode_attention
from qgemm_tpu_torch.ops.cuda.quantized_matmul import quantized_matmul_cuda
from qgemm_tpu_torch.serving.decode_graph import DecodeGraphs, GraphCaptureError
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params
from qgemm_tpu_torch.utils.testing import use_test_threads
from test_torch_gpt import SIZES, jax_params

use_test_threads()

PS = 8
LP_TOL = {"float": 1e-4, "quantized": 2e-3}
# the cache kinds a block runs over: dense float and int8 caches, int8 and
# int4 pools of 8-position pages
KINDS = {"dense_float": dict(), "dense_int8": dict(quantized_cache=True),
         "paged_int8": dict(paged=True, page_size=PS),
         "paged_int4": dict(paged=True, page_size=PS, kv_bits=4)}


@functools.lru_cache(maxsize=None)
def _pair(seed: int, **overrides):
    sizes = {**SIZES, **overrides}
    jm = JGPT.init(JConfig(**sizes), key=jax.random.PRNGKey(seed))
    return jm, gpt_from_jax_params(jax_params(jm), GPTConfig(**sizes), device="cpu")


@functools.lru_cache(maxsize=None)
def _eos():
    """A token the model emits early (the JAX suite's probe): a mid-block
    EOS for two of the requests."""
    _, tm = _pair(71)
    eng = ContinuousBatchingEngine(tm, max_slots=1, device="cpu")
    req = Request(prompt=[5, 6, 7], max_new_tokens=6)
    eng.submit(req)
    eng.run_to_completion(max_steps=20)
    return req.generated[3]


def _spec():
    """JAX's ``test_multi_step_decode_matches_single_step`` scenario: EOS
    mid-block, mixed lengths, five requests through two slots (a waiting
    queue, so blocks and single steps alternate)."""
    eos = _eos()
    return [([5, 6, 7], 6, eos), ([8, 9], 11, None), ([1] * 7, 3, None),
            ([2, 3], 9, eos), ([4] * 5, 7, None)]


def _serve(engine_cls, req_cls, model, **kw):
    eng = engine_cls(model, max_slots=2, **kw)
    reqs = [req_cls(prompt=p, max_new_tokens=m, eos_token=e, logprobs=True)
            for p, m, e in _spec()]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_steps=300)
    assert all(r.done and r.error is None for r in reqs), [r.error for r in reqs]
    return [list(r.generated) for r in reqs], [list(r.token_logprobs) for r in reqs], eng


@functools.lru_cache(maxsize=None)
def _jax_run(kind: str):
    jm, _ = _pair(71)
    toks, lps, _ = _serve(JEngine, JRequest, jm, scheduler="python", multi_step=4,
                          **KINDS[kind])
    return toks, lps


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("kind", list(KINDS))
def test_multi_step_matches_jax_engine(kind, k):
    want, want_lps = _jax_run(kind)
    _, tm = _pair(71)
    got, got_lps, eng = _serve(ContinuousBatchingEngine, Request, tm, device="cpu",
                               multi_step=k, **KINDS[kind])
    single, _, single_eng = _serve(ContinuousBatchingEngine, Request, tm, device="cpu",
                                   **KINDS[kind])
    assert got == want == single
    # one logprob per token, aligned with the JAX engine's
    for g, lp, wl in zip(got, got_lps, want_lps):
        assert len(lp) == len(g)
        np.testing.assert_allclose(
            lp, wl, atol=LP_TOL["float" if kind == "dense_float" else "quantized"], rtol=0)
    # blocks ran: fewer dispatches (one ITL sample each after the first)
    # for as many bookkeeper steps as the single-step engine's
    assert len(eng._itl) < len(single_eng._itl) and eng.steps == single_eng.steps
    assert eng.stats["tokens_generated"] == sum(map(len, got))
    assert int(eng._ring_idx) <= k
    if eng.paged:
        assert eng.stats["pages_in_use"] == 0


@pytest.mark.parametrize("kind", ["dense_int8", "paged_int4"])
def test_multi_step_sampled_blocks_give_valid_tokens(kind):
    _, tm = _pair(72)
    eng = ContinuousBatchingEngine(tm, max_slots=3, device="cpu", multi_step=4, seed=5,
                                   top_k=20, **KINDS[kind])
    reqs = [Request(prompt=[3 + i, 4, 5], max_new_tokens=9 + i, temperature=0.9,
                    top_p=0.95, logprobs=True) for i in range(3)]
    reqs.append(Request(prompt=[1, 2], max_new_tokens=7))                 # greedy
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_steps=100)
    vocab = SIZES["vocab_size"]
    for r in reqs:
        assert r.done and r.error is None
        assert len(r.generated) == r.max_new_tokens
        assert all(0 <= t < vocab for t in r.generated)
    for r in reqs[:3]:
        assert len(r.token_logprobs) == len(r.generated)
        assert all(lp <= 0.0 for lp in r.token_logprobs)
    if kind == "dense_int8":
        # the greedy request in a mixed batch keeps its greedy transcript
        alone = tm.generate(torch.tensor([reqs[3].prompt]), reqs[3].max_new_tokens,
                            quantized_cache=True)[0].tolist()
        assert reqs[3].generated == alone


def test_multi_step_paged_block_stays_in_its_reservation():
    """A block that runs past a slot's reservation (a 14-token prompt with
    max_new_tokens 2 reserves two pages, 16 positions; its block of 4 runs
    to position 17) grows no page for its junk positions, which write the
    null page: both requests keep the transcripts they get alone."""
    _, tm = _pair(73)
    kw = dict(paged=True, page_size=PS, max_seq_len=32, prefix_cache=False)
    eng = ContinuousBatchingEngine(tm, max_slots=2, device="cpu", multi_step=4, **kw)
    short = Request(prompt=list(range(1, 15)), max_new_tokens=2)
    long = Request(prompt=[9, 8, 7], max_new_tokens=20)
    grown = []
    real = eng._grow_slot

    def spy(slot, n_tokens):
        grown.append((n_tokens, len(eng.alloc.slot_pages[slot]) * PS))
        return real(slot, n_tokens)

    eng._grow_slot = spy
    for r in (short, long):
        eng.submit(r)
    eng.run_to_completion(max_steps=100)
    decode_growth = [(n, have) for n, have in grown if have > 0]
    assert decode_growth and all(n <= have for n, have in decode_growth)
    for r in (short, long):
        ref = ContinuousBatchingEngine(tm, max_slots=1, device="cpu", **kw)
        alone = Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
        ref.submit(alone)
        ref.run_to_completion()
        assert r.generated == alone.generated
    assert eng.stats["pages_in_use"] == 0


# --------------------------------------------------------- dense chunked prefill
def _chunked_case(model_pair, prompts, **kw):
    jm, tm = model_pair

    def run(engine_cls, req_cls, model, **opts):
        eng = engine_cls(model, max_slots=2, **opts)
        reqs = [req_cls(prompt=p, max_new_tokens=4) for p in prompts]
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion(max_steps=40)
        assert all(r.error is None for r in reqs), [r.error for r in reqs]
        return [list(r.generated) for r in reqs], eng

    want, _ = run(JEngine, JRequest, jm, scheduler="python", **kw)
    offsets = []
    real = tm.prefill_chunk

    def spy(tokens, offset, caches):
        offsets.append((int(offset), tokens.shape[1]))
        return real(tokens, offset, caches)

    tm.prefill_chunk = spy
    try:
        got, eng = run(ContinuousBatchingEngine, Request, tm, device="cpu", **kw)
    finally:
        del tm.prefill_chunk
    bucketed, _ = run(ContinuousBatchingEngine, Request, tm, device="cpu")
    assert got == want == bucketed
    assert eng.stats["admissions"] == len(prompts)
    return offsets


def test_chunked_prefill_matches_jax_engine_mha():
    """JAX's ``test_chunked_prefill_matches_bucketed``: 16-token chunks."""
    offsets = _chunked_case(_pair(13), [list(range(1, 36)), list(range(40, 58)), [5, 6]],
                            chunked_prefill=16)
    # the 35-token prompt in 3 chunks, the 18-token one in 2, [5, 6] whole
    assert offsets == [(0, 16), (16, 16), (32, 16), (0, 16), (16, 16), (0, 8)]


def test_chunked_prefill_matches_jax_engine_gqa():
    """JAX's ``test_gqa_chunked_dense_prefill_matches_bucketed``: the chunks
    write the grouped (n_kv_heads) cache."""
    offsets = _chunked_case(_pair(63, n_kv_heads=2, max_seq_len=128),
                            [list(range(1, 40)), list(range(50, 68)), [5, 6, 7]],
                            chunked_prefill=16)
    assert [o for o, _ in offsets].count(32) == 1 and len(offsets) == 6


def test_chunked_prefill_overrunning_the_extent_prefills_whole():
    """A 50-token prompt in chunks of 24 pads to 72 > the 64-row extent:
    both engines fall back to the bucketed prefill (one 64-row bucket)."""
    prompt = [(7 * i) % 97 for i in range(50)]
    offsets = _chunked_case(_pair(14), [prompt, [3, 4, 5]], chunked_prefill=24)
    assert offsets == [(0, 64), (0, 8)]


# ------------------------------------------------- the decode graphs' host logic
class _CountingStub(DecodeGraphs):
    """Capture runs the step's Python once (as a CUDA capture does, the
    wrappers counting), a replay runs none of it."""

    def __init__(self, step):
        super().__init__(step, torch.device("cpu"))
        self.replayed = []

    def _capture_stream(self):
        return contextlib.nullcontext()

    def _record(self, mode):
        self._step(mode)
        return mode

    def _replay(self, graph):
        self.replayed.append(graph)


def test_graph_launch_counts_per_replay_and_recapture():
    steps = []

    def step(mode):
        steps.append(mode)
        decode_attention.launches += 2
        quantized_matmul_cuda.launches += 5

    g = _CountingStub(step)
    kernels.reset_launch_counts()
    g.run("greedy", 4)           # the warm-up step, the capture, 3 replays
    counts = kernels.launch_counts()
    assert counts["decode_attention"] == 4 * 2 and counts["quantized_matmul"] == 4 * 5
    assert (g.captures, g.replays, g.replayed) == (1, 3, ["greedy"] * 3)
    assert steps == ["greedy", "greedy"]                 # warm-up and capture
    assert g._graphs["greedy"][1] == {"decode_attention": 2, "quantized_matmul": 5}
    g.run("greedy", 1)           # a replay, no capture
    g.run("sampled", 2)          # its own graph
    assert (g.captures, g.replays) == (2, 5)
    g.reset()
    g.run("greedy", 1)           # captured again, no replay
    assert (g.captures, g.replays) == (3, 5)
    counts = kernels.launch_counts()
    assert counts["decode_attention"] == 2 * (4 + 1 + 2 + 1)
    assert sum(v for k, v in counts.items() if k not in
               ("decode_attention", "quantized_matmul")) == 0
    kernels.reset_launch_counts()


def test_graph_capture_failure_raises_and_keeps_no_graph():
    class Failing(_CountingStub):
        def _record(self, mode):
            raise RuntimeError("operation not permitted when stream is capturing")

    g = Failing(lambda mode: None)
    with pytest.raises(GraphCaptureError, match="not permitted"):
        g.run("greedy", 2)
    assert g.captures == 0 and "greedy" not in g._graphs


class _EngineStub(DecodeGraphs):
    """Capture records nothing; a replay runs the engine's step eagerly."""

    def _capture_stream(self):
        return contextlib.nullcontext()

    def _record(self, mode):
        return mode

    def _replay(self, graph):
        self._step(graph)


@pytest.mark.parametrize("kind", ["dense_int8", "paged_int8"])
def test_engine_on_stubbed_graphs_matches_eager(kind):
    """The graph route's engine logic (static inputs, the ring and its
    index, one capture per mode, re-capture only after a fault) on the CPU:
    transcripts equal the eager route's, and a page-table upload never
    re-captures."""
    _, tm = _pair(74)
    want, _, _ = _serve(ContinuousBatchingEngine, Request, tm, device="cpu", multi_step=4,
                        **KINDS[kind])
    eng = ContinuousBatchingEngine(tm, max_slots=2, device="cpu", multi_step=4,
                                   **KINDS[kind])
    eng._graphs = _EngineStub(eng._decode_body, eng.device, eng._gen)
    dispatches = []
    real = eng._decode

    def spy(active, n):
        out = real(active, n)
        dispatches.append((n, int(eng._ring_idx), out[0].shape))
        return out

    eng._decode = spy
    pt = eng._pt_dev if eng.paged else None
    reqs = [Request(prompt=p, max_new_tokens=m, eos_token=e, logprobs=True)
            for p, m, e in _spec()]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_steps=300)
    assert [list(r.generated) for r in reqs] == want
    # the ring's index counts the steps of each dispatch, from 0
    assert all(idx == n and shape == (n, 2) for n, idx, shape in dispatches)
    assert {n for n, _, _ in dispatches} == {1, 4}
    total = sum(n for n, _, _ in dispatches)
    assert (eng._graphs.captures, eng._graphs.replays) == (1, total - 1)
    st = eng.stats
    assert st["decode_graph_captures"] == 1 and st["decode_graph_replays"] == total - 1
    if eng.paged:
        assert all(c.page_table is pt for c in eng.caches)
