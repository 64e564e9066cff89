"""Port parity for the warped-sampling helpers of
qgemm_tpu_torch/ops/sampling.py (``warped_probs``, ``warped_token_probs``,
``sample_logits_with_prob``, and ``sample_logits`` sharing their sort)
against qgemm_tpu/ops/sampling.py on the CPU, on the same numpy logits.

Probabilities are compared to 1e-6 (absolute; both sides compute in
float32 through the same filter pipeline and differ only in the rounding
of a softmax or a logsumexp). Sampled tokens are compared by distribution:
the empirical distribution of ``N_DRAWS`` draws per row against JAX's
``warped_probs``, total variation under ``TV_BOUND`` (the expected TV of
4096 draws over at most 12 live tokens is about 0.02).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.ops import sampling as js
from qgemm_tpu_torch.ops import sampling as ts
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads

use_test_threads()

B, V = 4, 12
N_DRAWS = 4096
TV_BOUND = 0.06
# (temperature, top_k, top_p): greedy (0 and 1e-9), temperature only,
# top-k, top-p, both, as scalars; the last three per slot
KNOBS = [(0.0, 0, 1.0), (1e-9, 0, 1.0), (0.7, 0, 1.0), (1.3, 3, 1.0), (1.0, 0, 0.8),
         (0.9, 5, 0.9),
         ([0.0, 0.5, 1.0, 2.0], 0, 1.0),
         ([1.0, 1e-9, 0.8, 1.5], [0, 2, 4, 0], [1.0, 0.9, 0.7, 0.5]),
         ([0.6, 1.2, 0.0, 1.0], [3, 0, 0, 1], 0.85)]


def _logits(seed: int) -> np.ndarray:
    lg = np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32) * 2
    lg[1, 3] = lg[1, 7] = lg[1].max() + 0.5         # a tie at the top of a row
    return lg


def _knobs(temp, top_k, top_p):
    """The knobs for JAX (jnp arrays or Python scalars) and the port
    (tensors or the same scalars)."""
    arr = lambda x, dt: (jnp.asarray(x, dt), torch.tensor(x)) if isinstance(x, list) else (x, x)
    (jt, tt), (jk, tk), (jp, tp) = arr(temp, jnp.float32), arr(top_k, jnp.int32), \
        arr(top_p, jnp.float32)
    return (jt, jk, jp), (tt, tk, tp)


@pytest.mark.parametrize("knobs", KNOBS)
def test_warped_probs_match_jax(knobs):
    lg = _logits(0)
    (jt, jk, jp), (tt, tk, tp) = _knobs(*knobs)
    want = np.asarray(js.warped_probs(jnp.asarray(lg), jt, jk, jp))
    got = ts.warped_probs(torch.from_numpy(lg), tt, tk, tp)
    assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("knobs", KNOBS)
def test_warped_token_probs_match_jax(knobs):
    lg = _logits(1)
    (jt, jk, jp), (tt, tk, tp) = _knobs(*knobs)
    for toks in (np.argmax(lg, -1), np.array([0, 3, 7, 11]), np.argsort(-lg, -1)[:, 2]):
        want = np.asarray(js.warped_token_probs(jnp.asarray(lg), jnp.asarray(toks), jt, jk, jp))
        got = ts.warped_token_probs(torch.from_numpy(lg), torch.from_numpy(toks), tt, tk, tp)
        assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("knobs", KNOBS)
def test_sample_logits_with_prob_matches_jax(knobs):
    """The probability returned with each drawn token is JAX's for that
    token, and the tokens are distributed as JAX's warped distribution."""
    lg = _logits(2)
    (jt, jk, jp), (tt, tk, tp) = _knobs(*knobs)
    rows = torch.from_numpy(np.repeat(lg, N_DRAWS, axis=0))
    rep = lambda x: (x.repeat_interleave(N_DRAWS) if isinstance(x, torch.Tensor) else x)
    g = torch.Generator().manual_seed(3)
    toks, qx = ts.sample_logits_with_prob(rows, g, rep(tt), rep(tk), rep(tp))
    jrep = lambda x: jnp.repeat(x, N_DRAWS) if isinstance(x, jnp.ndarray) else x
    want_qx = np.asarray(js.warped_token_probs(jnp.asarray(rows.numpy()),
                                               jnp.asarray(toks.numpy()), jrep(jt), jrep(jk),
                                               jrep(jp)))
    # the greedy one-hot gives 1 to the argmax JAX picks among tied logits
    assert_allclose(qx, want_qx, rtol=0, atol=1e-6)
    want = np.asarray(js.warped_probs(jnp.asarray(lg), jt, jk, jp))
    emp = np.stack([np.bincount(t, minlength=V) for t in toks.reshape(B, N_DRAWS).numpy()])
    tv = 0.5 * np.abs(emp / N_DRAWS - want).sum(-1)
    assert tv.max() < TV_BOUND, tv
    assert (qx > 0).all()


@pytest.mark.parametrize("knobs", KNOBS[2:])
def test_sample_logits_distribution_unchanged(knobs):
    """``sample_logits`` (now on the shared ``_warped_sorted``) draws from
    JAX's warped distribution, and greedy slots take the argmax."""
    lg = _logits(4)
    (jt, jk, jp), (tt, tk, tp) = _knobs(*knobs)
    rows = torch.from_numpy(np.repeat(lg, N_DRAWS, axis=0))
    rep = lambda x: (x.repeat_interleave(N_DRAWS) if isinstance(x, torch.Tensor) else x)
    toks = ts.sample_logits(rows, torch.Generator().manual_seed(5), rep(tt), rep(tk), rep(tp))
    want = np.asarray(js.warped_probs(jnp.asarray(lg), jt, jk, jp))
    emp = np.stack([np.bincount(t, minlength=V) for t in toks.reshape(B, N_DRAWS).numpy()])
    tv = 0.5 * np.abs(emp / N_DRAWS - want).sum(-1)
    assert tv.max() < TV_BOUND, tv


def test_filters_off_only_for_literals():
    """The sort-free path is taken for Python literals that disable both
    filters, as in JAX; a tensor knob always sorts (and gives the same
    probabilities)."""
    assert ts._filters_off(0, 1.0) and ts._filters_off(0, 1)
    assert not ts._filters_off(0, 0.9) and not ts._filters_off(2, 1.0)
    assert not ts._filters_off(torch.tensor(0), 1.0)
    assert ts._filters_off(0, 1.0) == js._filters_off(0, 1.0)
    lg = torch.from_numpy(_logits(6))
    a = ts.warped_probs(lg, 0.8, 0, 1.0)
    b = ts.warped_probs(lg, 0.8, torch.zeros(B, dtype=torch.int64), torch.ones(B))
    assert_allclose(a, b, rtol=0, atol=1e-6)
