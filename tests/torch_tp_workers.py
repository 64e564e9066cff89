"""The ranks' side of the tensor-parallel CPU tests (tests/test_torch_tp_*.py,
tests/test_torch_checkpoint_sharded.py).

``qgemm_tpu_torch.utils.testing.run_world`` spawns each world; the children
import this module to find their function, so it imports torch, numpy,
the port and chip_smoke.py (for its planted faults) only, never JAX. Inputs arrive as arguments (numpy arrays, JAX
models' path-keyed leaves, config dicts); each rank writes its results to
``<workdir>/<name>-<rank>.pkl``, which ``results`` reads back.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np
import torch

from chip_smoke import TP_CARDS_FAULTS, shift_kv_heads
from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
from qgemm_tpu_torch.models.transformer import TransformerConfig
from qgemm_tpu_torch.ops.quantize import (QuantizedWeight, QuantizedWeight4,
                                          quantized_matmul_prequant)
from qgemm_tpu_torch.parallel import tp_ops
from qgemm_tpu_torch.parallel.mesh import axis_rank, axis_size, make_mesh
from qgemm_tpu_torch.parallel.sharding import shard_kv_caches, shard_quantized_model
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from qgemm_tpu_torch.serving.seq2seq import Seq2SeqEngine
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params, transformer_from_jax_params


def _dump(workdir: str, name: str, rank: int, obj) -> None:
    with open(os.path.join(workdir, f"{name}-{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def results(workdir: str, name: str, world: int) -> List:
    """Every rank's result of ``name``, in rank order."""
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"{name}-{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _block(a: np.ndarray, dim: int, p: int, r: int) -> torch.Tensor:
    n = a.shape[dim] // p
    return torch.from_numpy(np.ascontiguousarray(np.take(a, range(r * n, (r + 1) * n),
                                                         axis=dim)))


# ---------------------------------------------------------------------------
# tp_ops
# ---------------------------------------------------------------------------

def ops_worker(rank: int, world: int, workdir: str, inp: Dict[str, np.ndarray]) -> None:
    """Every tp_op on this rank's shards of ``inp`` (JAX's codes and
    scales), with the collectives each one ran."""
    mesh = make_mesh(device="cpu")
    p, r = axis_size(mesh), axis_rank(mesh)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    res = {}

    def run(name, fn):
        tp_ops.reset_collective_counts()
        res[name] = _np(fn())
        res[name + "/counts"] = tp_ops.collective_counts()

    x, xr = t["x"], _block(inp["x_row"], 1, p, r)
    run("column", lambda: tp_ops.tp_quantized_matmul_column(
        x, _block(inp["q_col"], 1, p, r), _block(inp["c_col"], 1, p, r), mesh))
    run("column_local", lambda: tp_ops.tp_quantized_matmul_column(
        x, _block(inp["q_col"], 1, p, r), _block(inp["c_col"], 1, p, r), mesh,
        gather_output=False))
    run("row", lambda: tp_ops.tp_quantized_matmul_row(
        xr, _block(inp["q_row"], 0, p, r), t["c_row"], mesh))
    run("w4_column", lambda: tp_ops.tp_w4a8_matmul_column(
        t["xw"], _block(inp["qp"], 1, p, r), _block(inp["c4"], 1, p, r), mesh))
    run("w4_row", lambda: tp_ops.tp_w4a8_matmul_row(
        _block(inp["xw"], 1, p, r), _block(inp["qp"], 0, p, r), _block(inp["c4"], 0, p, r),
        mesh))
    # the row-parallel K1 route: the rank's partial on the global grid
    cx = tp_ops.global_row_scales(xr, mesh)
    res["row_partial"] = _np(quantized_matmul_prequant(
        xr, QuantizedWeight(qt=_block(inp["q_row"], 0, p, r).t().contiguous(), c=t["c_row"]),
        cx=cx))
    res["row_cx"] = _np(cx)
    with_w4_pad = np.zeros((inp["xw"].shape[0], inp["xw"].shape[1] // p - 1), np.float32)
    try:
        tp_ops.tp_w4a8_matmul_row(torch.from_numpy(with_w4_pad),
                                  _block(inp["qp"], 0, p, r), _block(inp["c4"], 0, p, r), mesh)
        res["w4_row_pad_raises"] = False
    except ValueError:
        res["w4_row_pad_raises"] = True
    try:   # a shape whose product is not the world size
        make_mesh((2, p), device="cpu")
        res["bad_shape_raises"] = False
    except ValueError:
        res["bad_shape_raises"] = True
    _dump(workdir, "ops", rank, res)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def _port_gpt(params, cfg: dict, **outliers) -> GPT:
    return gpt_from_jax_params(params, GPTConfig(**cfg), device="cpu", **outliers)


def model_worker(rank: int, world: int, workdir: str, cases: dict) -> None:
    """``cases``: name -> (JAX params, config dict, outlier options, tokens).
    Per case: the local model's logits (whole and at one decode step), the
    unsharded model's, which layers were sharded, the collectives of one
    forward, and the input of each row-parallel W4A8 layer on this rank
    (its K shard, in call order: ``w4a8_row_x``)."""
    mesh = make_mesh(device="cpu")
    res = {}
    row_w4a8 = tp_ops.tp_w4a8_matmul_row
    for name, (params, cfg, outliers, toks) in cases.items():
        full = _port_gpt(params, cfg, **outliers)
        local = shard_quantized_model(full, mesh)
        t = torch.from_numpy(toks)
        row_x = []

        def recorded(x, *args, **kw):
            row_x.append(_np(x))
            return row_w4a8(x, *args, **kw)

        tp_ops.tp_w4a8_matmul_row = recorded
        tp_ops.reset_collective_counts()
        try:
            with torch.no_grad():
                got = local(t)
        finally:
            tp_ops.tp_w4a8_matmul_row = row_w4a8
        counts = tp_ops.collective_counts()
        with torch.no_grad():
            want = full(t)
        blk = local.blocks[0]
        modes = {"q": blk.attn.wqkv_q.tp_mode, "o": blk.attn.w_o.tp_mode,
                 "up": getattr(getattr(blk.ffn, "up", None), "tp_mode", "moe"),
                 "head": local.lm_head.tp_mode, "heads": blk.attn.n_heads,
                 "kv_heads": blk.attn.kv_heads}
        res[name] = dict(got=_np(got), want=_np(want), counts=counts, modes=modes,
                         w4a8_row_x=row_x)
    _dump(workdir, "model", rank, res)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _serve(model, prompts, n_new, max_slots=2, **kw):
    """Serve to completion with two late arrivals. -> (transcripts, logprob
    lists, stats without the wall-clock entries, engine)."""
    eng = kw.pop("engine_cls", ContinuousBatchingEngine)(model, max_slots=max_slots,
                                                         device="cpu", **kw)
    reqs = [Request(prompt=p, max_new_tokens=n, logprobs=True) for p, n in zip(prompts, n_new)]
    for q in reqs[:-2]:
        eng.submit(q)
    eng.step()
    for q in reqs[-2:]:
        eng.submit(q)
    eng.run_to_completion()
    st = {k: v for k, v in eng.stats.items()
          if isinstance(v, (int, np.integer)) and "time" not in k and not k.endswith("_s")}
    return [q.generated for q in reqs], [q.token_logprobs for q in reqs], st, eng


def _decode_step_collectives(model, mesh, max_slots: int, **kw) -> dict:
    """The collectives of one decode step with every slot busy."""
    eng = ContinuousBatchingEngine(model, max_slots=max_slots, device="cpu", mesh=mesh,
                                   **kw)
    for i in range(max_slots):
        eng.submit(Request(prompt=[1 + i, 2, 3], max_new_tokens=6))
    eng.step()                       # admissions and a first decode step
    tp_ops.reset_collective_counts()
    eng.step()
    return tp_ops.collective_counts()


def engine_worker(rank: int, world: int, workdir: str, cases: dict) -> None:
    """``cases``: name -> (JAX params, config, engine options, prompts,
    n_new[, draft params, draft config]). Per case the local engine's
    transcripts, logprobs and stats beside the unsharded engine's; plus
    the collectives of one decode step."""
    mesh = make_mesh(device="cpu")
    res = {}
    for name, case in cases.items():
        params, cfg, kw, prompts, n_new = case[:5]
        kw = dict(kw)
        full = _port_gpt(params, cfg)
        local = shard_quantized_model(full, mesh)
        draft = dlocal = None
        if len(case) > 5:
            draft = _port_gpt(case[5], case[6])
            dlocal = shard_quantized_model(draft, mesh)
        got = _serve(local, prompts, n_new, mesh=mesh, draft_model=dlocal, **kw)
        want = _serve(full, prompts, n_new, draft_model=draft, **kw)
        res[name] = dict(got=got[0], got_lp=got[1], stats=got[2], want=want[0],
                         want_lp=want[1], want_stats=want[2],
                         prefix_cache=got[3].prefix_cache,
                         pool_heads=(got[3].caches[0].kq.shape[1]
                                     if kw.get("paged") else got[3].caches[0][0].shape[1]))
        if name == "dense":
            res["step_collectives"] = _decode_step_collectives(local, mesh, 2)
    _dump(workdir, "engine", rank, res)


def seq2seq_worker(rank: int, world: int, workdir: str, cases: dict) -> None:
    """``cases``: name -> (JAX params, config, engine options, sources,
    n_new[, draft params, draft config]). The local Seq2SeqEngine's
    transcripts and stats beside the unsharded engine's."""
    mesh = make_mesh(device="cpu")
    res = {}
    for name, case in cases.items():
        params, cfg, kw, srcs, n_new = case[:5]
        full = transformer_from_jax_params(params, TransformerConfig(**cfg), device="cpu")
        local = shard_quantized_model(full, mesh)
        draft = dlocal = None
        if len(case) > 5:
            draft = transformer_from_jax_params(case[5], TransformerConfig(**case[6]),
                                                device="cpu")
            dlocal = shard_quantized_model(draft, mesh)
        opts = dict(kw, engine_cls=Seq2SeqEngine, max_slots=3)
        got = _serve(local, srcs, n_new, mesh=mesh, draft_model=dlocal, max_new_tokens=24,
                     **opts)
        want = _serve(full, srcs, n_new, draft_model=draft, max_new_tokens=24, **opts)
        eng = got[3]
        res[name] = dict(got=got[0], got_lp=got[1], stats=got[2], want=want[0],
                         want_lp=want[1], want_stats=want[2],
                         cross_heads=eng.enc_kvs[0][0].shape[1])
    _dump(workdir, "seq2seq", rank, res)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def checkpoint_worker(rank: int, world: int, workdir: str, params: dict, cfg: dict) -> None:
    """Save this rank's shards; load them into a fresh local model (and
    check the bytes); try loading into a template of another topology."""
    from qgemm_tpu_torch.utils.checkpoint import (load_checkpoint_sharded,
                                                  save_checkpoint_sharded, tree_leaves)
    mesh = make_mesh(device="cpu")
    local = shard_quantized_model(_port_gpt(params, cfg), mesh)
    ckpt = os.path.join(workdir, "ckpt")
    save_checkpoint_sharded(ckpt, local)
    torch.distributed.barrier()
    fresh = shard_quantized_model(GPT.init(GPTConfig(**cfg), seed=99, device="cpu").quantize(),
                                  mesh)
    loaded = load_checkpoint_sharded(ckpt, fresh)
    want, got = tree_leaves(local), tree_leaves(loaded)
    exact = all(torch.equal(want[k], got[k]) for k in want)
    with torch.no_grad():
        same_logits = torch.equal(local(torch.tensor([[1, 2, 3]])),
                                  loaded(torch.tensor([[1, 2, 3]])))
    try:   # an unsharded template: every key has its whole span
        load_checkpoint_sharded(ckpt, _port_gpt(params, cfg))
        mismatch = ""
    except KeyError as e:
        mismatch = str(e)
    _dump(workdir, "ckpt", rank, dict(exact=exact, same_logits=same_logits,
                                      mismatch=mismatch))


# ---------------------------------------------------------------------------
# planted faults
# ---------------------------------------------------------------------------

# chip_smoke.py's planted faults (that script imports no JAX): a per-shard
# row grid, a skipped SUM and a bf16 SUM swap a tp_ops function; KV shards
# one head off are ``shift_kv_heads``
FAULTS = tuple(TP_CARDS_FAULTS)


def faults_worker(rank: int, world: int, workdir: str, params: dict, cfg: dict,
                  prompts, n_new) -> None:
    """Each planted fault in turn, then the checks: the local forward
    against the unsharded one (1e-4) and the engine's transcripts against
    the unsharded engine's. -> fault -> which checks failed."""
    mesh = make_mesh(device="cpu")
    full = _port_gpt(params, cfg)
    toks = torch.tensor([prompts[-1]])
    with torch.no_grad():
        want = full(toks)
    want_tr = _serve(full, prompts, n_new)[0]
    res = {}
    for fault in ("none",) + FAULTS:
        saved = (tp_ops.global_row_scales, tp_ops.reduce_partial)
        swap = TP_CARDS_FAULTS.get(fault)
        if swap is not None:
            setattr(tp_ops, *swap)
        try:
            local = shard_quantized_model(_port_gpt(params, cfg), mesh)
            if fault == "kv_head_offset":
                shift_kv_heads(local)
            with torch.no_grad():
                got = local(toks)
            err = float((got - want).abs().max() / want.abs().max())
            tr = _serve(local, prompts, n_new, mesh=mesh)[0]
        finally:
            tp_ops.global_row_scales, tp_ops.reduce_partial = saved
        res[fault] = dict(forward=err <= 1e-4, transcripts=tr == want_tr, err=err)
    _dump(workdir, "faults", rank, res)


def kv_cache_worker(rank: int, world: int, workdir: str, caches) -> None:
    """``shard_kv_caches`` on numpy (k, v) pairs -> this rank's heads."""
    mesh = make_mesh(device="cpu")
    local = shard_kv_caches([tuple(torch.from_numpy(a) for a in c) for c in caches], mesh)
    _dump(workdir, "kv", rank, [[t.numpy() for t in c] for c in local])


# ---------------------------------------------------------------------------
# a fault on one rank
# ---------------------------------------------------------------------------

# where -> (the engine method that fails on the last rank, the call that fails)
RANK_FAULTS = {"decode": ("_step_logits", 3), "spec": ("_verify_logits", 1),
               "admission": ("_prefill_impl", 3)}


def one_rank_fault_worker(rank: int, world: int, workdir: str, kind: str, where: str,
                          params: dict, cfg: dict, prompts, n_new, draft=None) -> None:
    """A fault planted on the last rank only (``RANK_FAULTS[where]``: that
    engine method raises at its n-th call there); every rank serves the
    requests until it raises. -> the error each rank raised (None: it
    served to the end). The last rank then leaves the group, which breaks
    the collective another rank waits in."""
    mesh = make_mesh(device="cpu")
    if kind == "gpt":
        cls, build = ContinuousBatchingEngine, lambda p, c: _port_gpt(p, c)
        opts = {}
    else:
        cls = Seq2SeqEngine
        build = lambda p, c: transformer_from_jax_params(p, TransformerConfig(**c), device="cpu")
        opts = dict(engine_cls=Seq2SeqEngine, max_new_tokens=24)
    local = shard_quantized_model(build(params, cfg), mesh)
    dlocal = None if draft is None else shard_quantized_model(build(*draft), mesh)
    if dlocal is not None:
        opts["spec_gamma"] = 3
    if rank == world - 1:
        name, at = RANK_FAULTS[where]
        orig, calls = getattr(cls, name), [0]

        def planted(self, *a, **kw):
            calls[0] += 1
            if calls[0] == at:
                raise RuntimeError(f"planted {where} fault")
            return orig(self, *a, **kw)
        setattr(cls, name, planted)
    try:
        _serve(local, prompts, n_new, mesh=mesh, draft_model=dlocal, **opts)
        raised = None
    except Exception as e:  # noqa: BLE001 — the result this test reads
        raised = f"{type(e).__name__}: {e}"
    _dump(workdir, f"fault_{kind}_{where}", rank, {"raised": raised})
