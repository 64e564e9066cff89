"""The training slice as a whole, on the CPU: the port's training step
(``GPT.forward`` under autograd, the cross-entropy's analytic gradient, Adam
in place; ``qgemm_tpu_torch/examples/train_gpt_lm.py::train_step``) against
the JAX package's jitted ``train_step`` of ``examples/train_gpt_lm.py``, on
a 2-layer float32 GPT taken from JAX weights and the same numpy batches,
MHA and GQA. Then the port's counterpart of
``test_training.py::test_gpt_adam_overfits_batch``, and a trained model
quantized and served by the CPU engine.

Tolerances: the two sides sum in different orders (f32), so step 1's
gradients agree to rtol 1e-4 with atol 1e-5 * max|g| per leaf (measured:
9e-7 * max|g|); the losses of 5 steps to rtol 1e-3 (measured: 2e-7); after
5 Adam steps at lr 5e-3 (each step moves a parameter by at most ~5e-3)
every parameter, the positional table included, to atol 5e-5 (measured:
1.4e-5, where Adam's normalisation magnifies a near-zero gradient's
rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu.models.optim import Adam as JAdam
from qgemm_tpu.ops.cross_entropy import cross_entropy_loss as j_ce
from qgemm_tpu.utils.checkpoint import _path_key
from qgemm_tpu_torch.examples.train_gpt_lm import (heldout_eval, loss_fn, train_model,
                                                   train_step)
from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
from qgemm_tpu_torch.models.optim import Adam
from qgemm_tpu_torch.ops import cuda as kernels
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params
from qgemm_tpu_torch.utils.testing import assert_allclose, use_test_threads

use_test_threads()

CFG = dict(vocab_size=32, d_model=64, n_heads=4, d_ff=128, n_layers=2, max_seq_len=24)
LR = 5e-3


def _leaves(tree):
    return {_path_key(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batches(n, seed=5, batch=4, seq=17):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], size=(batch, seq)).astype(np.int32)
            for _ in range(n)]


def _jax_train_step(cfg):
    opt = JAdam(lr=LR)

    def j_loss(m, seqs):
        logits = m.forward(seqs[:, :-1])
        return j_ce(logits.reshape(-1, cfg.vocab_size), seqs[:, 1:].reshape(-1))

    @jax.jit
    def step(m, st, seqs):
        loss, grads = jax.value_and_grad(j_loss)(m, seqs)
        m, st = opt.step(m, grads, st)
        return m, st, loss

    return opt, step, jax.jit(jax.grad(j_loss))


@pytest.mark.parametrize("n_kv_heads", [0, 2])
def test_training_steps_match_jax(n_kv_heads):
    jcfg = JConfig(**CFG, n_kv_heads=n_kv_heads)
    jm = JGPT.init(jcfg, key=jax.random.PRNGKey(1))
    model = gpt_from_jax_params(_leaves(jm), GPTConfig(**CFG, n_kv_heads=n_kv_heads),
                                device="cpu")
    named = model.named_trainable()
    assert [k for k, _ in named] == list(_leaves(jm))      # every leaf, JAX's order
    params = [p for _, p in named]
    opt = Adam(lr=LR)
    state = opt.init(params)
    jopt, jstep, jgrad = _jax_train_step(jcfg)
    jst = jopt.init(jm)
    batches = _batches(5)

    # step 1's gradients, leaf by leaf
    want = _leaves(jgrad(jm, jnp.asarray(batches[0])))
    loss_fn(model, torch.from_numpy(batches[0])).backward()
    for key, p in named:
        ref = want[key]
        assert_allclose(p.grad, ref, rtol=1e-4, atol=1e-5 * float(np.abs(ref).max()),
                        msg=key)

    losses, jlosses = [], []
    for seqs in batches:
        state, loss = train_step(model, params, opt, state, torch.from_numpy(seqs))
        jm, jst, jloss = jstep(jm, jst, jnp.asarray(seqs))
        losses.append(float(loss))
        jlosses.append(float(jloss))
    assert_allclose(np.array(losses), np.array(jlosses), rtol=1e-3, atol=0)
    got = dict(model.named_trainable())
    for key, ref in _leaves(jm).items():
        assert_allclose(got[key], ref, rtol=0, atol=5e-5, msg=key)
    # the positional table trains too, as the JAX pytree's data field does
    pos0 = np.asarray(JGPT.init(jcfg, key=jax.random.PRNGKey(1)).embed.pos)
    moved = np.abs(got["embed/pos"].detach().numpy() - pos0).max(axis=-1)
    assert (moved[:16] > 1e-3).all() and (moved[16:] == 0).all()


def test_gpt_adam_overfits_batch():
    """Memorizing one batch: the loss must collapse far below ln(V)."""
    model = GPT.init(GPTConfig(**CFG), seed=0, device="cpu")
    params = [p for _, p in model.named_trainable()]
    opt = Adam(lr=LR)
    state = opt.init(params)
    seqs = torch.from_numpy(_batches(1, seed=6)[0]).long()
    first = None
    for i in range(60):
        state, loss = train_step(model, params, opt, state, seqs)
        if i == 0:
            first = float(loss)
    assert first > 3.0                      # ~ln(32) at init
    assert float(loss) < 0.5, float(loss)   # memorized


def test_trained_model_quantized_serves_like_generate():
    """train -> quantize -> the CPU engine with the int8 cache: greedy
    transcripts equal the quantized model's own ``generate``. No kernel
    launches anywhere on the CPU path, the backward included."""
    kernels.reset_launch_counts()
    rng = np.random.default_rng(8)
    batches = [np.concatenate([h, h], axis=1)[:, :17] for h in
               (rng.integers(0, 32, size=(8, 9)) for _ in range(40))]
    model, stats = train_model(steps=40, batch=8, seq_len=16, vocab=32, lr=LR, d_model=64,
                               n_heads=4, d_ff=128, n_layers=2, device="cpu",
                               batches=batches)
    assert stats["loss_last"] < stats["loss_first"]
    assert 0.0 <= stats["heldout_acc"] <= 1.0 and np.isfinite(stats["heldout_loss"])
    qm = model.quantize()
    eng = ContinuousBatchingEngine(qm, max_slots=2, max_seq_len=17, quantized_cache=True,
                                   device="cpu")
    prompts = [list(map(int, b[0, :9])) for b in _batches(3, seed=9, seq=9)]
    reqs = [Request(prompt=p, max_new_tokens=7) for p in prompts]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    for r in reqs:
        assert r.error is None
        iso = qm.generate(torch.tensor([r.prompt]), 7, quantized_cache=True)[0].tolist()
        assert r.generated == iso
    assert sum(kernels.launch_counts().values()) == 0


def test_heldout_eval_reports_copy_accuracy():
    """A stand-in model whose logits always pick the copied token scores
    1.0 on the copied half; a real untrained model scores in [0, 1]."""
    half = (16 + 1) // 2

    class Copier:
        device = torch.device("cpu")

        def forward(self, x):
            idx = torch.arange(x.shape[1]) - half + 1
            pred = x[:, idx.clamp(min=0)]
            return torch.nn.functional.one_hot(pred, 32).float() * 10.0

    loss, acc = heldout_eval(Copier(), 16, 32, n=4)
    assert acc == 1.0 and np.isfinite(loss)
    model = GPT.init(GPTConfig(**dict(CFG, max_seq_len=17)), seed=2, device="cpu")
    loss, acc = heldout_eval(model, 16, 32, n=4)
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
