"""Multi-device dryrun (port of ``qgemm_tpu/parallel/dryrun.py``): every
parallel path of the port, run and checked on the ranks of the default
process group.

``run_dryrun`` is called on every rank (SPMD) with the group up
(``mesh.initialize_distributed``); n is the world size. It runs JAX's
sections with their assertions (and, where JAX only runs a path, a check
of its output against the unsharded one): the data x model Transformer
training step and sharded generation; the tensor-parallel int8 and W4A8
matmuls; the tensor-parallel engines (dense, paged with a prefix hit and
chunked admission, speculative paged, seq2seq paged and speculative,
over-committed, the MoE GPT with its experts sharded, dense and paged);
all-to-all expert parallelism; a GQA generate and speculative decoding;
the GPipe, ring, Ulysses and expert-parallel training steps and the int8
expert-parallel forward. Each model is drawn from a seed on every rank
alike. Returns the readings it checked. The MoE GPT's and a2a's sections
give each rank one expert under top-2 routing, so they run only at n >= 2
(``moe_sections``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from qgemm_tpu_torch.device import DeviceLike
from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
from qgemm_tpu_torch.models.moe import MoEFeedForward
from qgemm_tpu_torch.models.optim import sgd_step
from qgemm_tpu_torch.models.transformer import Transformer, TransformerConfig
from qgemm_tpu_torch.ops.cross_entropy import cross_entropy_loss
from qgemm_tpu_torch.ops.quantize import (quantize_weights, quantize_weights_int4,
                                          quantized_matmul_prequant,
                                          quantized_matmul_prequant_w4)
from qgemm_tpu_torch.parallel import tp_ops
from qgemm_tpu_torch.parallel.expert import ep_moe_forward, ep_moe_forward_a2a, shard_moe
from qgemm_tpu_torch.parallel.mesh import axis_rank, make_mesh
from qgemm_tpu_torch.parallel.pipeline import pipeline_gpt_forward
from qgemm_tpu_torch.parallel.ring_attention import ring_attention, shard_sequence
from qgemm_tpu_torch.parallel.sharding import (data_mean, shard_batch, shard_model,
                                               shard_quantized_model)
from qgemm_tpu_torch.parallel.ulysses import ulysses_attention
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from qgemm_tpu_torch.serving.seq2seq import Seq2SeqEngine
from qgemm_tpu_torch.serving.speculative import speculative_generate


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun: {what}")


def _finite(t: torch.Tensor, what: str) -> float:
    _check(bool(torch.isfinite(t).all()), f"non-finite {what}")
    return float(t.detach().float().abs().max())


def _close(got: torch.Tensor, want: torch.Tensor, tol: float, what: str) -> float:
    err = float((got.detach().float() - want.detach().float()).abs().max())
    _check(err <= tol, f"{what}: max |err| {err:.3g} > {tol}")
    return err


def _block(t: torch.Tensor, dim: int, p: int, r: int) -> torch.Tensor:
    n = t.shape[dim] // p
    return t.narrow(dim, r * n, n).contiguous()


def _randn(shape, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, device=device)


def _serve(engine, prompts, n_new, max_steps: int = 100000) -> list:
    """Submit the requests, serve them to the end; every one must finish
    without error with its token count. -> the requests."""
    reqs = [Request(prompt=list(p), max_new_tokens=n) for p, n in zip(prompts, n_new)]
    for q in reqs:
        engine.submit(q)
    fin = engine.run_to_completion(max_steps=max_steps)
    _check(len(fin) == len(reqs) and all(q.error is None for q in reqs),
           f"engine requests failed: {[q.error for q in reqs]}")
    _check(all(len(q.generated) == n for q, n in zip(reqs, n_new)),
           f"engine token counts {[len(q.generated) for q in reqs]} != {list(n_new)}")
    return reqs


def _trainable(model):
    return [p for p in model.parameters() if p.requires_grad]


def run_dryrun(device: DeviceLike = None) -> dict:
    """Every section on this rank (see the module note); ``device`` is the
    group's ("cpu" for gloo, None for this rank's card). Raises on the
    first failed check."""
    n = dist.get_world_size()
    dev = torch.device("cpu") if device is not None and torch.device(device).type == "cpu" \
        else torch.device("cuda", torch.cuda.current_device())
    data = max(1, n // 4)
    mp = n // data
    mesh = make_mesh((data, mp), ("data", "model"), device=device)
    r_model = axis_rank(mesh, "model")
    out = {"world": n, "mesh": (data, mp)}
    eng = dict(device=dev, mesh=mesh)

    # --- the sharded training step (data x model) ------------------------
    cfg = TransformerConfig(vocab_size=128, d_model=8 * mp, n_heads=mp, d_ff=16 * mp,
                            n_layers=2, max_seq_len=32)
    model = shard_model(Transformer.init(cfg, seed=0, device=dev), mesh)
    batch = shard_batch({"src": torch.zeros((2 * data, 6), dtype=torch.long, device=dev),
                         "tgt_in": torch.ones((2 * data, 5), dtype=torch.long, device=dev),
                         "tgt_out": torch.ones((2 * data, 5), dtype=torch.long, device=dev)},
                        mesh)
    logits = model(batch["src"], batch["tgt_in"])
    loss = cross_entropy_loss(logits.reshape(-1, cfg.vocab_size), batch["tgt_out"].reshape(-1))
    loss.backward()
    params = _trainable(model)
    sgd_step(params, [p.grad for p in params], 0.01)
    out["train_loss"] = float(data_mean(loss, mesh))
    _check(math.isfinite(out["train_loss"]), f"non-finite loss {out['train_loss']}")
    with torch.no_grad():   # the decode path of the sharded float model
        toks = model.generate(batch["src"], 2)
    _check(tuple(toks.shape) == (batch["src"].shape[0], 2), "sharded generate's shape")

    # --- tensor-parallel int8 matmuls ------------------------------------
    x = _randn((16, 32 * mp), 1, dev)
    wq = quantize_weights(_randn((32 * mp, 16 * mp), 2, dev))
    col = tp_ops.tp_quantized_matmul_column(x, _block(wq.q, 1, mp, r_model),
                                            _block(wq.c, 1, mp, r_model), mesh)
    out["tp_column_err"] = _close(col, quantized_matmul_prequant(x, wq), 1e-4, "column TP")
    x2 = _randn((16, 16 * mp), 3, dev)
    wq2 = quantize_weights(_randn((16 * mp, 32), 4, dev))
    row = tp_ops.tp_quantized_matmul_row(_block(x2, 1, mp, r_model),
                                         _block(wq2.q, 0, mp, r_model), wq2.c, mesh)
    out["tp_row_err"] = _close(row, quantized_matmul_prequant(x2, wq2), 1e-3, "row TP")

    # --- the int8 tensor-parallel serving path ---------------------------
    qcfg = GPTConfig(vocab_size=64, d_model=8 * mp, n_heads=mp, d_ff=16 * mp, n_layers=2,
                     max_seq_len=64)
    qgpt = GPT.init(qcfg, seed=7, device=dev).quantize()
    qgpt_sharded = shard_quantized_model(qgpt, mesh)
    _check(qgpt_sharded.blocks[0].attn.wqkv_q.tp_mode == "column", "QKV not column-sharded")
    _check(qgpt_sharded.blocks[0].ffn.down.tp_mode == "row", "FFN-down not row-sharded")
    qtoks = torch.ones((2, 6), dtype=torch.long, device=dev)
    _check(torch.equal(qgpt_sharded.generate(qtoks, 3), qgpt.generate(qtoks, 3)),
           "TP int8 generate != single-device")
    _serve(ContinuousBatchingEngine(qgpt_sharded, max_slots=2, quantized_cache=True, **eng),
           [[1, 2, 3], [4, 5]], [3, 3])

    # --- paged + prefix cache + chunked admission under TP ---------------
    pcfg = GPTConfig(vocab_size=64, d_model=8 * mp, n_heads=mp, d_ff=16 * mp, n_layers=2,
                     max_seq_len=384)
    pgpt_sharded = shard_quantized_model(GPT.init(pcfg, seed=21, device=dev).quantize(), mesh)
    peng = ContinuousBatchingEngine(pgpt_sharded, max_slots=2, paged=True,
                                    chunked_prefill=128, multi_step=3, **eng)
    _check(peng.prefix_cache, "prefix cache should stay enabled under TP")
    system = [1 + (i % 60) for i in range(160)]
    _serve(peng, [system + [t] for t in (7, 9)], [3, 3], max_steps=60)
    out["prefix_hits"] = peng.alloc.prefix_hits
    _check(peng.alloc.prefix_hits >= 1, "prefix map never fired under TP")

    # --- speculative x paged x TP ----------------------------------------
    pdraft = shard_quantized_model(GPT.init(pcfg, seed=22, device=dev).quantize(), mesh)
    _serve(ContinuousBatchingEngine(pgpt_sharded, max_slots=2, paged=True, draft_model=pdraft,
                                    spec_gamma=3, **eng),
           [[t, t + 1] for t in (11, 13)], [4, 4], max_steps=60)

    # --- the paged seq2seq engine under TP, and its speculative twin ------
    s2s_cfg = TransformerConfig(vocab_size=64, d_model=8 * mp, n_heads=mp, d_ff=16 * mp,
                                n_layers=2, max_seq_len=160)
    s2s = shard_quantized_model(Transformer.init(s2s_cfg, seed=23, device=dev).quantize(),
                                mesh)
    seng = Seq2SeqEngine(s2s, max_slots=2, max_new_tokens=140, paged=True, **eng)
    _serve(seng, [[3, 4, 5]], [130], max_steps=200)
    _check(seng.stats["pages_in_use"] == 0, "seq2seq pages leaked")
    _serve(Seq2SeqEngine(s2s, max_slots=2, max_new_tokens=24, paged=True, draft_model=s2s,
                         spec_gamma=3, **eng),
           [[t, t + 1] for t in (7, 9)], [5, 5], max_steps=60)

    # --- over-commit and preemption x paged x TP -------------------------
    # JAX's 9 pages of 8: 64 positions past the null page, where the two
    # requests need 86
    oeng = ContinuousBatchingEngine(pgpt_sharded, max_slots=2, paged=True, overcommit=True,
                                    n_pages=9, page_size=8, **eng)
    _serve(oeng, [[t, t + 1, t + 2] for t in (15, 17)], [40, 40], max_steps=400)
    out["preemptions"] = oeng.preemptions

    # The next two sections give each rank one expert under top-2 routing,
    # which needs at least two experts: at world 1 they are left out.
    ep_mesh = make_mesh((n,), ("expert",), device=device)
    r_ep = axis_rank(ep_mesh, "expert")
    g = torch.Generator(device=dev)
    out["moe_sections"] = n >= 2
    if n >= 2:
        # --- the MoE GPT under the mesh: experts sharded, dense and paged -
        mcfg = GPTConfig(vocab_size=64, d_model=8 * mp, n_heads=mp, d_ff=16 * mp, n_layers=2,
                         max_seq_len=128, n_experts=n, moe_top_k=2)
        mgpt_sharded = shard_quantized_model(GPT.init(mcfg, seed=31, device=dev).quantize(),
                                             mesh)
        ffn = mgpt_sharded.blocks[0].ffn
        _check(ffn.tp_mode == "expert" and ffn.n_local_experts == n // mp,
               f"MoE experts not sharded ({ffn.tp_mode}, {ffn.n_local_experts} of {n})")
        for kw in ({}, {"paged": True}):
            _serve(ContinuousBatchingEngine(mgpt_sharded, max_slots=2, **kw, **eng),
                   [[t, t + 1] for t in (19, 21)], [3, 3], max_steps=60)

        # --- all-to-all expert parallelism -------------------------------
        g.manual_seed(13)
        moe = MoEFeedForward.init(g, 16, 32, n_experts=n, top_k=2, capacity_factor=8.0)
        xm = _randn((8 * n, 16), 14, dev)
        a2a = ep_moe_forward_a2a(_block(xm, 0, n, r_ep), shard_moe(moe, ep_mesh), ep_mesh)
        with torch.no_grad():
            want = _block(moe(xm), 0, n, r_ep)
        out["a2a_err"] = _close(a2a, want, 1e-3, "a2a EP != single-device MoE")

    # --- W4A8 tensor parallelism -----------------------------------------
    k4 = 128 * mp                        # scale groups divide the model axis
    x4 = _randn((8, k4), 1, dev)
    wq4 = quantize_weights_int4(_randn((k4, 16 * mp), 2, dev))
    ref4 = quantized_matmul_prequant_w4(x4, wq4)
    c4 = tp_ops.tp_w4a8_matmul_column(x4, _block(wq4.qp, 1, mp, r_model),
                                      _block(wq4.c, 1, mp, r_model), mesh)
    out["w4a8_column_err"] = _close(c4, ref4, 1e-4, "w4a8 column-TP != single-chip")
    r4 = tp_ops.tp_w4a8_matmul_row(_block(x4, 1, mp, r_model), _block(wq4.qp, 0, mp, r_model),
                                   _block(wq4.c, 0, mp, r_model), mesh)
    _finite(r4, "w4a8 row-TP")

    # --- GQA generate and speculative decoding ---------------------------
    gqa_cfg = GPTConfig(vocab_size=64, d_model=16 * mp, n_heads=2 * mp, n_kv_heads=mp,
                        d_ff=16 * mp, n_layers=2, max_seq_len=32)
    gqa = GPT.init(gqa_cfg, seed=11, device=dev)
    gqa_toks = gqa.generate(torch.ones((2, 4), dtype=torch.long, device=dev), 2,
                            quantized_cache=True)
    _check(tuple(gqa_toks.shape) == (2, 2), "GQA generate's shape")
    spec = speculative_generate(qgpt, qgpt, torch.ones((1, 3), dtype=torch.long, device=dev),
                                4, gamma=2)       # self-draft: full acceptance
    _check(spec.rounds >= 1 and tuple(spec.tokens.shape) == (4,), "speculative decoding")

    # --- pipeline parallelism: a GPipe training step ---------------------
    pipe_mesh = make_mesh((n,), ("pipe",), device=device)
    gcfg = GPTConfig(vocab_size=64, d_model=16, n_heads=2, d_ff=32, n_layers=2 * n,
                     max_seq_len=16)
    gpt = GPT.init(gcfg, seed=2, device=dev)
    gtoks = torch.zeros((2 * n, 8), dtype=torch.long, device=dev)
    glogits = pipeline_gpt_forward(gpt, gtoks, mesh=pipe_mesh)
    gloss = cross_entropy_loss(glogits.reshape(-1, gcfg.vocab_size), gtoks.reshape(-1))
    gloss.backward()
    params = _trainable(gpt)
    sgd_step(params, [p.grad for p in params], 0.01)
    out["pipeline_loss"] = float(gloss)
    _check(math.isfinite(out["pipeline_loss"]), f"non-finite pipeline loss {gloss}")

    # --- sequence parallelism: causal ring attention, Ulysses ------------
    seq_mesh = make_mesh((n,), ("seq",), device=device)
    q, k, v = (_randn((2, 2, 8 * n, 8), s, dev) for s in (3, 4, 5))
    shards = [shard_sequence(t, seq_mesh).requires_grad_(True) for t in (q, k, v)]
    attn = ring_attention(*shards, mesh=seq_mesh, causal=True)
    out["ring_max"] = _finite(attn, "ring attention")
    (attn.float() ** 2).sum().backward()
    for t in shards:
        _finite(t.grad, "ring attention gradient")
    qu = shard_sequence(_randn((2, n, 8 * n, 8), 6, dev), seq_mesh)
    out["ulysses_max"] = _finite(ulysses_attention(qu, qu, qu, mesh=seq_mesh, causal=True),
                                 "ulysses attention")

    # --- expert parallelism: an MoE training step, then int8 -------------
    g.manual_seed(4)
    moe = shard_moe(MoEFeedForward.init(g, 16, 32, n_experts=2 * n, top_k=2), ep_mesh)
    xe = _randn((2, 8, 16), 5, dev)
    eloss = torch.mean(ep_moe_forward(xe, moe, ep_mesh) ** 2)
    eloss.backward()
    params = _trainable(moe)
    sgd_step(params, [p.grad for p in params], 0.01)
    out["ep_loss"] = float(eloss)
    _check(math.isfinite(out["ep_loss"]), f"non-finite EP loss {eloss}")
    with torch.no_grad():
        out["ep_int8_max"] = _finite(ep_moe_forward(xe, moe.quantize(), ep_mesh),
                                     "int8 EP output")
    return out
