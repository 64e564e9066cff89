"""Port parity for speculative decoding's pieces against the JAX package on
the CPU, on the same numpy inputs and weights (the interop loader carries
the JAX models' leaves over):

  * ``spec_leftover`` / ``spec_candidates`` (qgemm_tpu_torch/serving/
    engine.py) against JAX's ``spec_accept`` fed the same uniforms: the
    accepted counts, candidates and the extra token are equal, the leftover
    distribution (recomputed from JAX's ``warped_probs``) and the logprobs
    agree to 1e-6 (float32 on both sides);
  * the paged verify chunk (``MultiHeadAttention`` at [B] per-slot offsets
    over a ``PagedKVCache``) against JAX's: pools equal up to the rounding
    of the K/V projections (``_assert_pools_close``), outputs to rtol 1e-5
    (float32, summation order), at B 3, unaligned offsets that straddle
    page edges, int8 and int4 pools, MHA and GQA;
  * ``speculative_generate`` and ``speculative_sample``
    (qgemm_tpu_torch/serving/speculative.py), mirroring the eight tests of
    tests/test_speculative.py: greedy transcripts and round counts equal
    JAX's and ``generate``'s; sampled output within a total-variation bound
    of the target's analytic distribution (``SAMPLE_RUNS`` runs).
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu.ops.sampling import sample_logits_with_prob as j_sample_with_prob
from qgemm_tpu.ops.sampling import warped_probs as j_warped_probs
from qgemm_tpu.serving import paged_cache as jpc
from qgemm_tpu.serving import speculative as jspec
from qgemm_tpu.serving.engine import spec_accept as j_spec_accept
from qgemm_tpu_torch.models.gpt import GPTConfig
from qgemm_tpu_torch.serving.engine import spec_candidates, spec_leftover
from qgemm_tpu_torch.serving.speculative import speculative_generate, speculative_sample
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads
from test_torch_gpt import jax_params
from test_torch_paged_cache import shuffled_tables, to_port

use_test_threads()

CFG = dict(vocab_size=97, d_model=64, n_heads=4, d_ff=128, n_layers=2, max_seq_len=128)
SAMPLE_RUNS = 1024


# ------------------------------------------------------------ spec_accept
def _accept_inputs(seed: int, b: int = 4, gamma: int = 3, v: int = 16):
    """Target and draft logits that agree in part (the target is the draft
    plus noise), the draft's proposals and their probabilities drawn by
    JAX's sampler, per-slot knobs with one greedy slot."""
    rng = np.random.default_rng(seed)
    dlog = rng.standard_normal((b, gamma, v)).astype(np.float32) * 2
    tlog = np.concatenate([dlog, rng.standard_normal((b, 1, v)).astype(np.float32) * 2], 1)
    tlog = tlog + rng.standard_normal(tlog.shape).astype(np.float32) * (0.3 + 0.3 * (seed % 3))
    temps = np.array([1.0, 0.0, 0.7, 1.4], np.float32)[:b]
    topps = np.array([1.0, 1.0, 0.8, 0.95], np.float32)[:b]
    topks = np.array([0, 0, 4, 0], np.int32)[:b]
    d, qx = [], []
    for i, k in enumerate(jax.random.split(jax.random.PRNGKey(seed), gamma)):
        t, q = j_sample_with_prob(jnp.asarray(dlog[:, i]), k, jnp.asarray(temps), 0, 1.0)
        d.append(np.asarray(t))
        qx.append(np.asarray(q))
    return tlog, dlog, np.stack(d, 1), np.stack(qx, 1), temps, topps, topks


def _j_leftover(tlog, dlog, n_acc, temps, topps, topks, gamma):
    """JAX's leftover distribution at n_acc, by its own functions."""
    b = tlog.shape[0]
    p_at = j_warped_probs(jnp.asarray(tlog[np.arange(b), n_acc]), jnp.asarray(temps),
                          jnp.asarray(topks), jnp.asarray(topps))
    q_at = j_warped_probs(jnp.asarray(dlog[np.arange(b), np.minimum(n_acc, gamma - 1)]),
                          jnp.asarray(temps), 0, 1.0)
    q_at = jnp.where(jnp.asarray(n_acc < gamma)[:, None], q_at, 0.0)
    resid = jnp.maximum(p_at - q_at, 0.0)
    return np.asarray(jnp.where((jnp.sum(resid, 1) > 1e-9)[:, None], resid, p_at))


@pytest.mark.parametrize("seed", range(6))
def test_spec_accept_matches_jax_with_its_uniforms(seed):
    gamma = 3
    tlog, dlog, d, qx, temps, topps, topks = _accept_inputs(seed, gamma=gamma)
    kacc, kextra = jax.random.split(jax.random.PRNGKey(100 + seed))
    u = np.asarray(jax.random.uniform(kacc, d.shape))
    jcand, jprod, jcur, jlps = (np.asarray(a) for a in j_spec_accept(
        jnp.asarray(tlog), jnp.asarray(d), jnp.asarray(qx), jnp.asarray(dlog),
        jnp.asarray(temps), jnp.asarray(topps), jnp.asarray(topks), kacc, kextra, gamma))
    t = lambda a: torch.from_numpy(np.array(a))
    n_acc, dist = spec_leftover(t(tlog), t(d.astype(np.int64)), t(qx), t(dlog), t(temps),
                                t(topps), t(topks.astype(np.int64)), t(u), gamma)
    np.testing.assert_array_equal(n_acc.numpy(), jprod - 1)
    want_dist = _j_leftover(tlog, dlog, jprod - 1, temps, topps, topks, gamma)
    assert_allclose(dist, want_dist, rtol=0, atol=1e-6)
    # JAX's draw from the leftover is a token the leftover can give
    extra = jcand[np.arange(len(jprod)), jprod - 1]
    assert (want_dist[np.arange(len(extra)), extra] > 0).all()
    cand, produced, cur_new, lps = spec_candidates(t(tlog), t(d.astype(np.int64)), n_acc,
                                                   t(extra.astype(np.int64)))
    np.testing.assert_array_equal(cand.numpy(), jcand)
    np.testing.assert_array_equal(produced.numpy(), jprod)
    np.testing.assert_array_equal(cur_new.numpy(), jcur)
    assert_allclose(lps, jlps, rtol=0, atol=1e-6)
    # the greedy slot (temperature 0) accepts exactly while the proposal is
    # the target's argmax, then adds the target's argmax
    g = np.argmax(tlog[1], -1)
    agree = int(np.cumprod(d[1] == g[:gamma]).sum())
    assert int(n_acc[1]) == agree and int(cand[1, agree]) == g[agree]


def test_spec_accept_covers_both_outcomes():
    """The seeds above reach full acceptance and early rejection."""
    seen = set()
    for seed in range(6):
        tlog, dlog, d, qx, temps, topps, topks = _accept_inputs(seed)
        u = np.asarray(jax.random.uniform(jax.random.split(jax.random.PRNGKey(100 + seed))[0],
                                          d.shape))
        t = lambda a: torch.from_numpy(np.array(a))
        n_acc, _ = spec_leftover(t(tlog), t(d.astype(np.int64)), t(qx), t(dlog), t(temps),
                                 t(topps), t(topks.astype(np.int64)), t(u), 3)
        seen.update(n_acc.tolist())
    assert 0 in seen and 3 in seen, seen


# ------------------------------------------------------- paged verify chunk
@functools.lru_cache(maxsize=None)
def _attn_pair(seed: int, n_kv_heads: int):
    sizes = dict(vocab_size=97, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=64,
                 n_kv_heads=n_kv_heads)
    jm = JGPT.init(JConfig(**sizes), key=jax.random.PRNGKey(seed))
    tm = gpt_from_jax_params(jax_params(jm), GPTConfig(**sizes), device="cpu")
    return jm.blocks[0].attn, tm.blocks[0].attn


def _codes(pool: np.ndarray, kv_bits: int) -> np.ndarray:
    """A pool's signed codes (int4 nibbles unpacked)."""
    pool = pool.astype(np.int32)
    if kv_bits == 8:
        return pool
    lo = ((pool & 0xF) ^ 8) - 8
    return np.concatenate([lo, pool >> 4], axis=2)


def _assert_pools_close(tc, jc):
    """The port's pools hold JAX's: the K/V the two sides project differ in
    the last float32 bit now and then, so a scale may differ by an ulp and a
    code by one step, at a few of the written positions; every position the
    chunk did not write is equal byte for byte."""
    for f in ("kq", "vq"):
        got, want = (_codes(np.asarray(a), jc.kv_bits) for a in (getattr(tc, f), getattr(jc, f)))
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.02, (f, diff.max(), (diff > 0).mean())
    for f in ("kc", "vc"):
        np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("kv_bits,ps,n_kv_heads", [(8, 8, 0), (8, 16, 2), (4, 8, 0),
                                                   (4, 16, 2)])
def test_paged_verify_chunk_matches_jax(kv_bits, ps, n_kv_heads):
    """Three slots verify gamma + 1 = 5 rows at offsets that straddle a
    page edge, start on one and end mid-page, over pools already holding
    their prompts (shuffled physical pages)."""
    jattn, tattn = _attn_pair(31 + ps, n_kv_heads)
    hkv, dh, c, pps = n_kv_heads or 4, 8, 5, 4
    offsets = np.array([ps - 2, 2 * ps, ps + 3], np.int32)
    counts = [-(-(o + c) // ps) for o in offsets]
    n_pages = 1 + sum(counts) + 1
    jc = jpc.init_paged_cache(hkv, dh, n_pages, 3, pps, page_size=ps, kv_bits=kv_bits)
    jc = replace(jc, page_table=jnp.asarray(shuffled_tables(3, pps, n_pages, counts, ps)))
    rng = np.random.default_rng(kv_bits + ps)
    for s, o in enumerate(offsets):
        ext = -(-int(o) // ps) * ps
        if ext:
            kv = rng.standard_normal((2, hkv, ext, dh)).astype(np.float32)
            jc = jpc.paged_write_prompt(jc, s, jnp.asarray(kv[0]), jnp.asarray(kv[1]))
    tc = to_port(jc)
    x = rng.standard_normal((3, c, 32)).astype(np.float32)
    jout, jc2 = jattn(jnp.asarray(x), causal=True, kv_cache=jc,
                      cache_index=jnp.asarray(offsets))
    with torch.no_grad():
        tout, tc2 = tattn(torch.from_numpy(x), causal=True, kv_cache=tc,
                          cache_index=torch.from_numpy(offsets.astype(np.int64)))
    assert tc2 is tc                                   # written in place
    _assert_pools_close(tc, jc2)
    jout = np.asarray(jout)
    assert_allclose(tout, jout, rtol=1e-5, atol=1e-5 * float(np.abs(jout).max()))


# ----------------------------------------------------- the batch-1 entry points
@functools.lru_cache(maxsize=None)
def _pair(seed: int, quantize_bits: int = 0, **overrides):
    sizes = {**CFG, **overrides}
    jm = JGPT.init(JConfig(**sizes), key=jax.random.PRNGKey(seed))
    if quantize_bits:
        jm = jm.quantize(bits=quantize_bits)
    return jm, gpt_from_jax_params(jax_params(jm), GPTConfig(**sizes), device="cpu")


def _generate(tm, prompt, n):
    return tm.generate(torch.tensor(prompt), n)[0].tolist()


def _both(jt, jd, tt, td, prompt, n, **kw):
    want = jspec.speculative_generate(jt, jd, jnp.asarray(prompt), n, **kw)
    got = speculative_generate(tt, td, torch.tensor(prompt), n, **kw)
    assert got.tokens.tolist() == np.asarray(want.tokens).tolist()
    assert (got.rounds, got.drafted, got.accepted) == \
        (int(want.rounds), int(want.drafted), int(want.accepted))
    return got


def test_self_draft_exact_and_minimal_rounds():
    jm, tm = _pair(0)
    prompt, n, gamma = [[3, 1, 4, 1, 5]], 24, 4
    res = _both(jm, jm, tm, tm, prompt, n, gamma=gamma)
    assert res.tokens.tolist() == _generate(tm, prompt, n)
    body_rounds = res.rounds - 1
    assert body_rounds <= -(-(n - 1) // (gamma + 1)) + 1
    assert res.accepted == body_rounds * gamma


def test_arbitrary_draft_still_exact():
    (jt, tt), (jd, td) = _pair(1), _pair(2)
    prompt, n = [[7, 8, 9]], 16
    res = _both(jt, jd, tt, td, prompt, n, gamma=3)
    assert res.tokens.tolist() == _generate(tt, prompt, n)
    assert res.rounds >= n // 2


def test_quantization_self_speculation():
    jt, tt = _pair(3)
    jd, td = _pair(3, quantize_bits=4)
    prompt, n = [[11, 22, 33]], 16
    res = _both(jt, jd, tt, td, prompt, n, gamma=3)
    assert res.tokens.tolist() == _generate(tt, prompt, n)
    assert 0 <= res.accepted <= res.drafted


def test_eos_stops_and_pins():
    jm, tm = _pair(4)
    prompt, n = [[2, 7, 1]], 12
    ref = _generate(tm, prompt, n)
    eos = ref[3]
    res = _both(jm, jm, tm, tm, prompt, n, gamma=4, eos_token=eos)
    toks = res.tokens.tolist()
    k = ref.index(eos)
    assert toks[:k + 1] == ref[:k + 1] and all(t == eos for t in toks[k:])
    assert res.rounds <= 3


def test_speculative_with_gqa_target():
    jm, tm = _pair(6, n_heads=8, n_kv_heads=2)
    prompt = [[4, 5, 6]]
    res = _both(jm, jm, tm, tm, prompt, 10, gamma=3)
    assert res.tokens.tolist() == _generate(tm, prompt, 10)


def test_speculative_rejects_bad_calls():
    _, tm = _pair(0)
    with pytest.raises(ValueError, match="batch 1"):
        speculative_generate(tm, tm, torch.tensor([[1, 2], [3, 4]]), 4)
    with pytest.raises(ValueError, match="max_seq_len"):
        speculative_generate(tm, tm, torch.tensor([[1] * 100]), 24, gamma=4)
    with pytest.raises(ValueError, match="max_seq_len"):
        speculative_sample(tm, tm, torch.tensor([[1] * 100]), None, 24, gamma=4)


def test_speculative_sample_greedy_limit_exact():
    (jt, tt), (jd, td) = _pair(11), _pair(12)
    prompt, n = [[7, 8, 9]], 16
    ref = _generate(tt, prompt, n)
    want = jspec.speculative_sample(jt, jd, jnp.asarray(prompt), jax.random.PRNGKey(0), n,
                                    gamma=3, temperature=0.0)
    got = speculative_sample(tt, td, torch.tensor(prompt), torch.Generator().manual_seed(0),
                             n, gamma=3, temperature=0.0)
    assert got.tokens.tolist() == ref == np.asarray(want.tokens).tolist()
    assert got.rounds == int(want.rounds) and got.accepted == int(want.accepted)


SMALL = dict(vocab_size=8, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=32)


def test_speculative_sample_matches_target_distribution():
    """The joint of the first two sampled tokens against the target's
    analytic warped joint (JAX's model, the same weights), with a
    mismatched draft that rejects often; the draft's own joint is far off,
    so the bound discriminates. 1024 runs over 64 cells: the expected TV
    is about 0.11; the bound 0.2, and under half the draft's distance."""
    (jt, tt), (jd, td) = _pair(21, **SMALL), _pair(22, **SMALL)
    prompt, temp, v = [[1, 2, 3]], 1.0, 8
    g = torch.Generator().manual_seed(5)
    samples = [speculative_sample(tt, td, torch.tensor(prompt), g, 2, gamma=3,
                                  temperature=temp).tokens.tolist() for _ in range(SAMPLE_RUNS)]

    def joint(m):
        logits, cache = m.prefill(jnp.asarray(prompt), m.init_cache(1, 16))
        p0 = np.asarray(j_warped_probs(logits[:, -1, :], temp))[0]
        p1 = np.stack([np.asarray(j_warped_probs(
            m.decode_step(jnp.asarray([[t0]]), 3, cache)[0], temp))[0] for t0 in range(v)])
        return p0[:, None] * p1

    exact = joint(jt)
    emp = np.zeros((v, v))
    for t0, t1 in samples:
        emp[t0, t1] += 1.0 / SAMPLE_RUNS
    tv_spec = 0.5 * np.abs(emp - exact).sum()
    tv_draft = 0.5 * np.abs(joint(jd) - exact).sum()
    assert tv_draft > 0.25, tv_draft
    assert tv_spec < 0.2 and tv_spec < 0.5 * tv_draft, (tv_spec, tv_draft)


def test_speculative_sample_top_k_respected():
    """With top_k=2 every sampled token is one of the target's two most
    likely at its position (the leftover inherits the warp)."""
    (jt, tt), (_, td) = _pair(31, vocab_size=16, **{k: v for k, v in SMALL.items()
                                                   if k not in ("vocab_size", "max_seq_len")},
                              max_seq_len=64), \
        _pair(32, vocab_size=16, **{k: v for k, v in SMALL.items()
                                    if k not in ("vocab_size", "max_seq_len")}, max_seq_len=64)
    prompt, n = [[1, 2, 3]], 8
    for seed in range(4):
        res = speculative_sample(tt, td, torch.tensor(prompt),
                                 torch.Generator().manual_seed(seed), n, gamma=3,
                                 temperature=1.0, top_k=2)
        cache = jt.init_cache(1, 32)
        logits, cache = jt.prefill(jnp.asarray(prompt), cache)
        cur, pos = logits[0, -1, :], 3
        for t in res.tokens.tolist():
            assert t in np.argsort(-np.asarray(cur))[:2].tolist(), (t, res.tokens)
            lg, cache = jt.decode_step(jnp.asarray([[t]]), pos, cache)
            cur, pos = lg[0], pos + 1
