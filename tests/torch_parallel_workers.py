"""The ranks' side of the CPU tests of the rest of parallelism
(tests/test_torch_expert_parallel.py, test_torch_sharded_training.py,
test_torch_ring_attention.py, test_torch_pipeline.py, test_torch_dryrun.py).

``qgemm_tpu_torch.utils.testing.run_world`` spawns each world; the children
import this module to find their function, so it imports torch, numpy, the
port and chip_smoke.py (for its planted faults) only, never JAX. The JAX
references are computed once in the parent and arrive here as numpy
arrays; each rank writes its results to ``<workdir>/<name>-<rank>.pkl``
(``torch_tp_workers.results`` reads them back).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from chip_smoke import planted
from qgemm_tpu_torch.models.gpt import GPT, GPTConfig
from qgemm_tpu_torch.models.moe import (MoEFeedForward, QuantizedExpertWeight, _capacity,
                                        route_slots)
from qgemm_tpu_torch.models.optim import sgd_step
from qgemm_tpu_torch.models.transformer import Transformer, TransformerConfig
from qgemm_tpu_torch.ops.cross_entropy import cross_entropy_loss
from qgemm_tpu_torch.parallel import tp_ops
from qgemm_tpu_torch.parallel.collectives import ring_shift
from qgemm_tpu_torch.parallel.expert import ep_moe_forward, ep_moe_forward_a2a, shard_moe
from qgemm_tpu_torch.parallel.mesh import axis_rank, make_mesh
from qgemm_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_gpt_forward, stack_stages
from qgemm_tpu_torch.parallel.ring_attention import ring_attention, shard_sequence
from qgemm_tpu_torch.parallel.sharding import (data_mean, shard_batch, shard_model,
                                               shard_quantized_model)
from qgemm_tpu_torch.parallel.ulysses import ulysses_attention
from qgemm_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params, transformer_from_jax_params
from torch_tp_workers import _dump


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _block(a, dim: int, p: int, r: int) -> np.ndarray:
    n = a.shape[dim] // p
    return np.take(np.asarray(a), range(r * n, (r + 1) * n), axis=dim)


def _slice_like(full: np.ndarray, local: torch.Tensor, r: int) -> np.ndarray:
    """Rank r's block of ``full`` along the one dimension where ``local``
    is narrower (``full`` itself where none is)."""
    for d, (a, b) in enumerate(zip(full.shape, local.shape)):
        if a != b:
            return _block(full, d, a // b, r)
    return full


def moe_from_params(params: Dict[str, np.ndarray], top_k: int, cf: float) -> MoEFeedForward:
    """The port's MoE layer from JAX's leaves (``router_w``, ``w_up``,
    ``w_down``; or ``w_up/q``, ``w_up/c`` and ``w_down``'s when int8)."""
    if "w_up/q" in params:
        up, down = (QuantizedExpertWeight.from_kn(_t(params[f"{n}/q"]), _t(params[f"{n}/c"]))
                    for n in ("w_up", "w_down"))
    else:
        up, down = _t(params["w_up"]), _t(params["w_down"])
    return MoEFeedForward(_t(params["router_w"]), up, down, top_k=top_k, capacity_factor=cf)


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

def _drops(x: torch.Tensor, moe: MoEFeedForward) -> int:
    """The choices of these tokens dropped over capacity (a capacity from
    their own count, a2a's per-source rule)."""
    cap = _capacity(x.shape[0], moe.n_experts, moe.top_k, moe.capacity_factor)
    slot, _ = route_slots(x, moe.router_w, moe.top_k, cap)
    return int((slot == moe.n_experts * cap).sum())


def _serve(model, prompts, n_new, **kw) -> list:
    eng = ContinuousBatchingEngine(model, max_slots=2, device="cpu", **kw)
    reqs = [Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, n_new)]
    for q in reqs:
        eng.submit(q)
    eng.run_to_completion(max_steps=200)
    return [q.generated for q in reqs]


def _step_collectives(model, mesh) -> dict:
    """The collectives of one decode step of the mesh engine, both slots
    busy."""
    eng = ContinuousBatchingEngine(model, max_slots=2, device="cpu", mesh=mesh)
    for i in range(2):
        eng.submit(Request(prompt=[1 + i, 2, 3], max_new_tokens=6))
    eng.step()
    tp_ops.reset_collective_counts()
    eng.step()
    return tp_ops.collective_counts()


def ep_worker(rank: int, world: int, workdir: str, inp: dict) -> None:
    """The layer: ``ep_moe_forward`` (float, int8) on the replicated tokens
    and ``ep_moe_forward_a2a`` on this rank's (capacity 8.0 and a binding
    one) with their drops; the EP training step's gradients; the planted
    expert offset. The MoE GPT: its engines under the mesh (dense, paged)
    beside the unsharded ones, the experts each block holds and a decode
    step's collectives. At p = 2: the sharded checkpoint's round trip."""
    mesh = make_mesh((world,), ("expert",), device="cpu")
    r = axis_rank(mesh, "expert")
    res = {}
    x = _t(inp["x"])
    for kind in ("float", "int8"):
        whole = moe_from_params(inp[f"moe_{kind}"], 2, 1.25)
        local = shard_moe(whole, mesh)
        with torch.no_grad():
            res[f"dense_{kind}"] = _np(ep_moe_forward(x, local, mesh))
            res[f"dense_{kind}_whole_arg"] = _np(ep_moe_forward(x, whole, mesh))
        res[f"n_local_{kind}"] = local.n_local_experts
    for name, cf in inp["a2a_cfs"].items():
        for kind in ("float", "int8"):
            whole = moe_from_params(inp[f"moe_{kind}"], 2, cf)
            xa = _t(_block(inp["x_a2a"], 0, world, r))
            with torch.no_grad():
                res[f"a2a_{name}_{kind}"] = _np(ep_moe_forward_a2a(xa, shard_moe(whole, mesh),
                                                                    mesh))
            res[f"a2a_{name}_drops"] = _drops(xa, whole)
    # the training step: the gradients of mean(out^2) on this rank's layer
    whole = moe_from_params(inp["moe_float"], 2, 1.25)
    local = shard_moe(whole, mesh)
    tp_ops.reset_collective_counts()
    loss = torch.mean(ep_moe_forward(x, local, mesh) ** 2)
    loss.backward()
    res["train_collectives"] = tp_ops.collective_counts()
    res["loss"] = float(loss)
    res["grads"] = {n: _np(p.grad) for n, p in local.named_parameters()}
    with planted("ep_expert_offset"), torch.no_grad():
        res["fault_expert_offset"] = _np(ep_moe_forward(x, local, mesh))
    # the MoE GPT under a ("data", "model") mesh
    gmesh = make_mesh((1, world), device="cpu")
    full = gpt_from_jax_params(inp["gpt"], GPTConfig(**inp["gpt_cfg"]), device="cpu")
    sharded = shard_quantized_model(full, gmesh)
    res["gpt_local_experts"] = [blk.ffn.n_local_experts for blk in sharded.blocks]
    res["gpt_ffn_mode"] = sharded.blocks[0].ffn.tp_mode
    for name, kw in (("dense", {}), ("paged", {"paged": True, "page_size": 8})):
        res[f"engine_{name}"] = _serve(sharded, inp["prompts"], inp["n_new"], mesh=gmesh, **kw)
        res[f"engine_{name}_want"] = _serve(full, inp["prompts"], inp["n_new"], **kw)
    res["step_collectives"] = _step_collectives(sharded, gmesh)
    if world == 2:
        res["ckpt"] = _checkpoint_round_trip(workdir, sharded, lambda: shard_quantized_model(
            GPT.init(GPTConfig(**inp["gpt_cfg"]), seed=99, device="cpu").quantize(), gmesh))
    _dump(workdir, "ep", rank, res)


def _checkpoint_round_trip(workdir: str, local, fresh, name: str = "ckpt") -> dict:
    """Save this rank's shards of ``local`` under ``workdir/name``, load them
    into ``fresh()`` (a local model of another draw): exact?"""
    from qgemm_tpu_torch.utils.checkpoint import (load_checkpoint_sharded,
                                                  save_checkpoint_sharded, tree_leaves)
    path = os.path.join(workdir, name)
    save_checkpoint_sharded(path, local)
    torch.distributed.barrier()
    loaded = load_checkpoint_sharded(path, fresh())
    want, got = tree_leaves(local), tree_leaves(loaded)
    return {"exact": all(torch.equal(want[k], got[k]) for k in want), "dir": path}


# ---------------------------------------------------------------------------
# data x model training
# ---------------------------------------------------------------------------

def _train_step(model_params, cfg, batch, mesh, lr: float) -> dict:
    """One step on this rank: the local model (``shard_model``), its loss on
    its ``shard_batch`` slice, the global loss, every parameter's
    gradient, and its value after an SGD step."""
    full = transformer_from_jax_params(model_params, TransformerConfig(**cfg), device="cpu")
    local = shard_model(full, mesh)
    b = shard_batch(batch, mesh)
    loss = cross_entropy_loss(local(b["src"], b["tgt_in"]).reshape(-1, cfg["vocab_size"]),
                              b["tgt_out"].reshape(-1))
    loss.backward()
    named = [(n.replace(".", "/"), p) for n, p in local.named_parameters() if p.requires_grad]
    grads = {n: _np(p.grad) for n, p in named}
    sgd_step([p for _, p in named], [p.grad for _, p in named], lr)
    return {"loss": float(data_mean(loss, mesh)), "grads": grads,
            "updated": {n: _np(p) for n, p in named},
            "local_shapes": {n: tuple(p.shape) for n, p in named}}


def train_worker(rank: int, world: int, workdir: str, inp: dict) -> None:
    """The Transformer's training step on each mesh of ``inp["meshes"]``,
    sound, and at (2, 2) with the data-axis reduction skipped; shard_batch
    of a numpy batch; the sharded checkpoints of the float GPT and
    Transformer at (2, 2)."""
    res = {}
    batch = {k: _t(v) for k, v in inp["batch"].items()}
    for shape in inp["meshes"]:
        mesh = make_mesh(shape, device="cpu")
        out = _train_step(inp["params"], inp["cfg"], batch, mesh, inp["lr"])
        out["model_rank"] = axis_rank(mesh, "model")
        res[shape] = out
        if shape == (2, 2):
            with planted("data_grad_skipped"):
                bad = _train_step(inp["params"], inp["cfg"], batch, mesh, inp["lr"])
            res["fault_data_grad"] = bad["grads"]
            sb = shard_batch({"x": inp["sb_x"], "y": inp["sb_y"]}, mesh)
            res["shard_batch"] = {k: v.numpy() for k, v in sb.items()}
            try:
                shard_batch({"x": inp["sb_x"][:3]}, mesh)
                res["shard_batch_indivisible_raises"] = False
            except ValueError:
                res["shard_batch_indivisible_raises"] = True
            cfg = TransformerConfig(**inp["cfg"])
            tlocal = shard_model(transformer_from_jax_params(inp["params"], cfg, device="cpu"),
                                 mesh)
            res["ckpt_transformer"] = _checkpoint_round_trip(
                workdir, tlocal, lambda: shard_model(Transformer.init(cfg, seed=5, device="cpu"),
                                                     mesh), "ckpt_transformer")
            gcfg = GPTConfig(**inp["gpt_cfg"])
            glocal = shard_model(gpt_from_jax_params(inp["gpt"], gcfg, device="cpu"), mesh)
            res["ckpt_gpt"] = _checkpoint_round_trip(
                workdir, glocal, lambda: shard_model(GPT.init(gcfg, seed=5, device="cpu"), mesh),
                "ckpt_gpt")
    _dump(workdir, "train", rank, res)


# ---------------------------------------------------------------------------
# ring attention and Ulysses
# ---------------------------------------------------------------------------

def _seq_grads(fn, q, k, v, mesh, causal: bool) -> tuple:
    """fn on this rank's shards; the rank's loss sum(out^2) backward ->
    (out, dq, dk, dv) of the rank's shards."""
    shards = [shard_sequence(_t(a), mesh).requires_grad_(True) for a in (q, k, v)]
    out = fn(*shards, mesh=mesh, causal=causal)
    (out ** 2).sum().backward()
    return (_np(out),) + tuple(_np(s.grad) for s in shards)


def seq_worker(rank: int, world: int, workdir: str, inp: dict) -> None:
    """Ring attention (causal and not) and Ulysses on this rank's shards,
    forward and gradients; the indivisible cases; at p = 2 the ring's
    planted faults."""
    mesh = make_mesh((world,), ("seq",), device="cpu")
    res = {}
    for causal in (False, True):
        res[f"ring_{causal}"] = _seq_grads(ring_attention, *inp["ring"], mesh, causal)
        res[f"ulysses_{causal}"] = _seq_grads(ulysses_attention, *inp["ulysses"], mesh, causal)
    try:
        shard_sequence(torch.zeros(1, 2, inp["odd_s"], 8), mesh)
        res["indivisible_raises"] = ""
    except ValueError as e:
        res["indivisible_raises"] = str(e)
    try:
        z = torch.zeros(1, inp["odd_h"], 8, 16)
        ulysses_attention(z, z, z, mesh=mesh)
        res["odd_heads_raises"] = ""
    except ValueError as e:
        res["odd_heads_raises"] = str(e)
    # the differentiable ppermute: rank r's x goes to r + 1, and its gradient
    # comes back from there
    x = torch.full((3,), float(rank), requires_grad=True)
    (y,) = ring_shift((x,), mesh, "seq")
    (y * (10.0 + rank)).sum().backward()
    res["ring_shift"] = (_np(y), _np(x.grad))
    if world == 2:
        for fault in ("ring_future_visible", "ring_block_local_lse"):
            with planted(fault):
                res[fault] = _seq_grads(ring_attention, *inp["ring"], mesh, True)
    _dump(workdir, "seq", rank, res)


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------

def pipe_worker(rank: int, world: int, workdir: str, inp: dict) -> None:
    """``pipeline_gpt_forward`` at each microbatch count of ``inp["micro"]``;
    the gradients of sum(y^2) through ``pipeline_apply`` on this rank's
    blocks; the int8 GPT; at p = 2 the planted tick fault."""
    mesh = make_mesh((world,), ("pipe",), device="cpu")
    r = axis_rank(mesh, "pipe")
    cfg = GPTConfig(**inp["cfg"])
    model = gpt_from_jax_params(inp["params"], cfg, device="cpu")
    toks = _t(inp["tokens"])
    res = {}
    with torch.no_grad():
        for m in inp["micro"]:
            res[f"logits_{m}"] = _np(pipeline_gpt_forward(model, toks, mesh=mesh,
                                                          n_microbatches=m))
        qmodel = gpt_from_jax_params(inp["q_params"], GPTConfig(**inp["q_cfg"]), device="cpu")
        res["int8"] = _np(pipeline_gpt_forward(qmodel, _t(inp["q_tokens"]), mesh=mesh))
    stage = stack_stages(list(model.blocks), mesh)
    y = pipeline_apply(lambda blk, h: blk(h), stage, _t(inp["x"]), mesh=mesh)
    (y ** 2).sum().backward()
    per = cfg.n_layers // world
    res["grads"] = {f"blocks/{r * per + i}/{n.replace('.', '/')}": _np(p.grad)
                    for i, blk in enumerate(stage) for n, p in blk.named_parameters()}
    res["y"] = _np(y)
    if world == 2:
        with planted("pipeline_tick"), torch.no_grad():
            res["fault_tick"] = _np(pipeline_gpt_forward(model, toks, mesh=mesh,
                                                         n_microbatches=inp["micro"][0]))
    _dump(workdir, "pipe", rank, res)


# ---------------------------------------------------------------------------
# the dryrun
# ---------------------------------------------------------------------------

def dryrun_worker(rank: int, world: int, workdir: str) -> None:
    from qgemm_tpu_torch.parallel import run_dryrun
    _dump(workdir, "dryrun", rank, run_dryrun(device="cpu"))


def dryrun_pages_worker(rank: int, world: int, workdir: str) -> None:
    """``dryrun_worker`` with the page size of every paged engine the
    dryrun builds recorded under ``page_sizes``."""
    from qgemm_tpu_torch.parallel import run_dryrun
    from qgemm_tpu_torch.serving.seq2seq import Seq2SeqEngine
    sizes = []
    for cls in (ContinuousBatchingEngine, Seq2SeqEngine):
        def recording(self, *args, _init=cls.__init__, **kw):
            _init(self, *args, **kw)
            if self.paged:
                sizes.append(self._page_size)
        cls.__init__ = recording
    _dump(workdir, "dryrun", rank, dict(run_dryrun(device="cpu"), page_sizes=sizes))

