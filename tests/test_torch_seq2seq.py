"""Port parity for the encoder-decoder serving engine
(qgemm_tpu_torch/serving/seq2seq.py) against qgemm_tpu/serving/seq2seq.py on
the CPU, with the same weights on both sides (carried over by
transformer_from_jax_params). Mirrors the non-tensor-parallel tests of
tests/test_seq2seq_serving.py and adds the decode-fault recovery of an
int4 pool (rebuilt with its own page size, bits and head width).

Greedy transcripts are compared exactly in float32; logprobs to 1e-4
(f32 sums in other orders). With the int8 self-cache and cross K/V the JAX
engine's jitted step can round other than the same step run op by op
(XLA fuses multiply-adds) and flip an int8 code, so there logprobs are
held to 5e-3 (the transcripts of these inputs still agree exactly) and,
where a model differs only in its cache (GQA), the leading tokens to the
float engine's, as JAX's test does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.models.transformer import Transformer as JTransformer
from qgemm_tpu.models.transformer import TransformerConfig as JConfig
from qgemm_tpu.serving.engine import Request as JRequest
from qgemm_tpu.serving.seq2seq import Seq2SeqEngine as JEngine
from qgemm_tpu_torch.models.transformer import TransformerConfig
from qgemm_tpu_torch.serving.engine import Request
from qgemm_tpu_torch.serving.seq2seq import Seq2SeqEngine
from qgemm_tpu_torch.utils.interop import transformer_from_jax_params
from qgemm_tpu_torch.utils.testing import use_test_threads
from test_torch_gpt import jax_params

use_test_threads()

SIZES = dict(vocab_size=89, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=64)
LP_TOL = 1e-4
# (source, max_new_tokens): ragged sources, slot churn over 3 slots
SPEC = [([3, 4, 5], 6), ([4, 4, 5, 9], 30), ([5, 4, 5, 9, 10], 20), ([6, 4, 5], 9),
        ([7, 4, 5, 9], 12)]


@functools.lru_cache(maxsize=None)
def pair(seed: int, **overrides):
    sizes = dict(SIZES, **overrides)
    jm = JTransformer.init(JConfig(**sizes), key=jax.random.PRNGKey(seed))
    return jm, transformer_from_jax_params(jax_params(jm), TransformerConfig(**sizes),
                                           device="cpu")


def serve(engine_cls, req_cls, model, spec, max_slots=3, max_new_tokens=40, **kw):
    """Serve [(source, max_new_tokens)] (or with an eos third) to
    completion, logprobs on. -> (requests in submission order, engine)."""
    eng = engine_cls(model, max_slots=max_slots, max_new_tokens=max_new_tokens, **kw)
    reqs = [req_cls(prompt=s[0], max_new_tokens=s[1], eos_token=s[2] if len(s) > 2 else None,
                    logprobs=True) for s in spec]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion(max_steps=600)
    return reqs, eng


def port(model, spec, **kw):
    return serve(Seq2SeqEngine, Request, model, spec, device="cpu", **kw)


def toks(reqs):
    return [(list(r.generated), r.error) for r in reqs]


@functools.lru_cache(maxsize=None)
def jax_run(seed: int, key: tuple):
    """The JAX engine's transcripts and logprobs for ``SPEC`` with engine
    options ``key`` (sorted items), once per module."""
    jm, _ = pair(seed)
    reqs, _ = serve(JEngine, JRequest, jm, SPEC, **dict(key))
    return toks(reqs), [list(r.token_logprobs) for r in reqs]


def lp_close(a, b, tol):
    assert all(len(x) == len(y) and np.allclose(x, y, rtol=0, atol=tol) for x, y in zip(a, b))


@pytest.mark.parametrize("kw", [{}, {"paged": True, "page_size": 8},
                                {"paged": True, "page_size": 8, "kv_bits": 4},
                                {"multi_step": 3}, {"multi_step": 4, "paged": True}],
                         ids=["dense", "paged8", "paged_int4", "ms3", "ms4_paged"])
def test_engine_matches_jax_engine(kw):
    """Float cross K/V and self-cache (or int8/int4 pages): the JAX engine's
    transcripts exactly, logprobs to 1e-4; each equals the port's own
    ``generate`` on its source (dense), and a ``multi_step`` engine's
    transcripts the single-step engine's."""
    _, tm = pair(31)
    want, want_lp = jax_run(31, tuple(sorted(kw.items())))
    reqs, eng = port(tm, SPEC, **kw)
    assert toks(reqs) == want
    lp_close([r.token_logprobs for r in reqs], want_lp, LP_TOL)
    if not kw.get("paged"):
        for r in reqs:
            assert tm.generate(torch.tensor([r.prompt]), r.max_new_tokens)[0].tolist() \
                == r.generated
    if kw.get("multi_step"):
        single = {k: v for k, v in kw.items() if k != "multi_step"}
        assert toks(reqs) == toks(port(tm, SPEC, **single)[0])
    st = eng.stats
    assert st["tokens_generated"] == sum(n for _, n in SPEC) and st["tokens_per_s"] > 0
    if kw.get("paged"):
        assert st["pages_in_use"] == 0


def test_engine_int8_cross_and_self_cache():
    """quantized_cache=True: the cross K/V are int8 ([slots, Hkv, S, D]
    codes and [.., 1] scales); transcripts equal the JAX engine's, logprobs
    to 5e-3, and the leading tokens equal the float engine's."""
    _, tm = pair(31)
    want, want_lp = jax_run(31, (("quantized_cache", True),))
    reqs, eng = port(tm, SPEC, quantized_cache=True)
    assert eng.enc_kvs[0][0].dtype == torch.int8 and eng.enc_kvs[0][1].shape[-1] == 1
    assert toks(reqs) == want
    lp_close([r.token_logprobs for r in reqs], want_lp, 5e-3)
    flt, _ = port(tm, SPEC)
    assert all(a.generated[:3] == b.generated[:3] for a, b in zip(reqs, flt))


def test_ragged_sources_isolated_and_slot_reuse():
    """Concurrent ragged sources get their transcripts alone; more requests
    than slots recycle them; EOS frees a slot early; the decoder budget is
    validated (dense and paged alike); the source length too."""
    _, tm = pair(4)
    srcs = [[11, 12, 13], [21, 22, 23, 24, 25, 26, 27]]
    solo = [port(tm, [(s, 5)], max_slots=1)[0][0].generated for s in srcs]
    both, _ = port(tm, [(s, 5) for s in srcs], max_slots=2)
    assert [r.generated for r in both] == solo
    eos = solo[1][2]
    reqs, eng = port(tm, [([2, 3], 4), (srcs[1], 5, eos), ([4, 5, 6], 4)], max_slots=1,
                     quantized_cache=True)
    assert [len(r.generated) for r in reqs] == [4, 3, 4] and all(r.error is None for r in reqs)
    for kw in ({}, {"paged": True}):
        eng = Seq2SeqEngine(tm, max_slots=2, max_new_tokens=40, device="cpu", **kw)
        with pytest.raises(ValueError, match="exceeds decoder budget"):
            eng.submit(Request(prompt=[3, 4], max_new_tokens=41))
        with pytest.raises(ValueError, match="max_src_len"):
            eng.submit(Request(prompt=[3] * 65, max_new_tokens=4))
        eng.submit(Request(prompt=[3, 4], max_new_tokens=40))
        fin = eng.run_to_completion(max_steps=80)
        assert len(fin) == 1 and fin[0].error is None and len(fin[0].generated) == 40


def test_error_isolation_and_finish_at_admission():
    """A failing admission errors only its request; a request that
    finishes at admission (max_new_tokens 1) frees its slot, pages and
    logprobs subscription at once."""
    _, tm = pair(6)
    eng = Seq2SeqEngine(tm, max_slots=1, max_new_tokens=16, device="cpu", paged=True)
    real = eng._prefill_impl

    def flaky(src, *a):
        if int(src[0, 0]) == 3:
            raise RuntimeError("injected encode fault")
        return real(src, *a)

    eng._prefill_impl = flaky
    bad, one = Request(prompt=[3, 4], max_new_tokens=3), \
        Request(prompt=[5, 6], max_new_tokens=1, logprobs=True)
    good = Request(prompt=[1, 2], max_new_tokens=3, logprobs=True)
    for r in (bad, one, good):
        eng.submit(r)
    eng.run_to_completion(max_steps=40)
    assert "injected encode fault" in bad.error and bad.done
    assert len(one.generated) == 1 and len(one.token_logprobs) == 1 and one.error is None
    assert len(good.generated) == 3 and len(good.token_logprobs) == 3 and good.error is None
    assert eng.stats["pages_in_use"] == 0 and not eng._lp_slots


@pytest.mark.parametrize("quantized_cache", [False, True])
def test_gqa_engine(quantized_cache):
    """GQA shrinks the self-cache and the cross K/V to Hkv heads; transcripts
    equal ``generate``'s (float) or, int8, the float engine's leading
    tokens; paged with int8 cross K/V equals dense."""
    _, tm = pair(9, n_kv_heads=2)
    src = [5, 6, 7, 8]
    ref = tm.generate(torch.tensor([src]), 5)[0].tolist()
    reqs, eng = port(tm, [(src, 5), ([3, 4, 5], 6), ([10, 11], 6)], max_slots=2,
                     quantized_cache=quantized_cache)
    assert eng.enc_kvs[0][0].shape[1] == 2 and eng.caches[0][0].shape[1] == 2
    assert reqs[0].generated[:3] == ref[:3]
    if not quantized_cache:
        assert reqs[0].generated == ref
    paged, _ = port(tm, [(src, 5), ([3, 4, 5], 6), ([10, 11], 6)], max_slots=2,
                    quantized_cache=quantized_cache, paged=True, page_size=8)
    assert toks(paged) == toks(reqs)


def test_paged_backpressure_and_cancel():
    """A pool smaller than slots x budget still serves everything
    (admissions wait for pages); cancelling an active request frees its
    pages and slot at once."""
    _, tm = pair(32)
    eng = Seq2SeqEngine(tm, max_slots=3, max_new_tokens=40, device="cpu", paged=True,
                        page_size=16, n_pages=7)
    reqs = [Request(prompt=[2 + i, 3], max_new_tokens=30) for i in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert eng.book.num_active == 3 and eng.stats["pages_in_use"] == 6
    eng.run_to_completion(max_steps=1000)
    assert all(len(r.generated) == 30 and r.error is None for r in reqs)
    solo, _ = port(tm, [([2, 3], 30)], max_slots=1)
    assert reqs[0].generated == solo[0].generated
    eng = Seq2SeqEngine(tm, max_slots=2, max_new_tokens=40, device="cpu", paged=True,
                        page_size=16)
    reqs = [Request(prompt=[5 + i] * 3, max_new_tokens=30) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    used = eng.stats["pages_in_use"]
    assert used == 4 and eng.cancel(reqs[0].id) and eng.stats["pages_in_use"] == 2
    assert not eng.cancel(reqs[0].id)
    eng.run_to_completion(max_steps=300)
    assert reqs[0].cancelled and len(reqs[1].generated) == 30


@pytest.mark.parametrize("kind", ["dense_int8", "paged_int8", "paged_int4"])
def test_decode_fault_recovery(kind):
    """A fault in a decode step fails the requests in flight, rebuilds the
    caches from the engine's own geometry (an int4 pool keeps its page
    size, bits and head width: the JAX engine's rebuild doubles the width
    and takes the default page and bits), clears the cross K/V and the
    positions, and later requests get a fresh engine's transcripts."""
    _, tm = pair(13)
    kw = {"dense_int8": dict(quantized_cache=True),
          "paged_int8": dict(paged=True, page_size=8, quantized_cache=True),
          "paged_int4": dict(paged=True, page_size=16, kv_bits=4)}[kind]
    eng = Seq2SeqEngine(tm, max_slots=2, max_new_tokens=40, device="cpu", **kw)
    before = [(tuple(t.shape), t.dtype) for t in
              ((eng.caches[0].kq, eng.caches[0].kc) if eng.paged else eng.caches[0])]
    doomed = [Request(prompt=[1, 2, 3], max_new_tokens=8, logprobs=True),
              Request(prompt=[4, 5], max_new_tokens=8)]
    for r in doomed:
        eng.submit(r)
    eng.step()
    real = eng._decode_body
    eng._decode_body = lambda mode: (_ for _ in ()).throw(RuntimeError("injected decode fault"))
    eng.step()
    eng._decode_body = real
    assert all(r.done and "injected decode fault" in r.error for r in doomed)
    assert eng.book.num_active == 0 and int(eng.src_lens.abs().sum()) == 0
    assert int(eng.positions.abs().sum()) == 0 and not eng._lp_slots
    if eng.paged:
        c = eng.caches[0]
        assert (c.page_size, c.kv_bits) == (kw["page_size"], kw.get("kv_bits", 8))
        assert [(tuple(t.shape), t.dtype) for t in (c.kq, c.kc)] == before
        assert eng.stats["pages_in_use"] == 0 and c.page_table is eng._pt_dev
    else:
        assert [(tuple(t.shape), t.dtype) for t in eng.caches[0]] == before
    assert all(float(t.abs().sum()) == (t.numel() if len(layer) == 4 and i % 2 else 0)
               for layer in eng.enc_kvs for i, t in enumerate(layer))
    later = [([6, 7, 8], 9), ([9, 10], 7)]
    got, _ = serve(lambda m, **k: eng, Request, tm, later)
    fresh, _ = port(tm, later, max_slots=2, **kw)
    assert toks(got) == toks(fresh)


def test_engine_options_and_device():
    """A ``mesh`` that is not a DeviceMesh with a "model" axis raises
    ValueError (tensor parallelism: tests/test_torch_tp_seq2seq.py); paged
    options need paged=True; the default device is the GPU (raises here
    without one)."""
    _, tm = pair(1)
    with pytest.raises(ValueError, match="mesh"):
        Seq2SeqEngine(tm, device="cpu", mesh=object())
    for bad in (dict(n_pages=4), dict(page_size=16), dict(kv_bits=4)):
        with pytest.raises(ValueError, match="needs paged=True"):
            Seq2SeqEngine(tm, device="cpu", **bad)
    with pytest.raises(ValueError, match="needs draft_model"):
        Seq2SeqEngine(tm, device="cpu", spec_gamma=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Seq2SeqEngine(tm)
