"""Continuous batching inference engine (port of
``qgemm_tpu/serving/engine.py``): dense and paged cache modes.

A fixed pool of ``max_slots`` batch slots. Every ``step()`` admits waiting
requests into free slots (one prefill each) and then runs ONE decode step
over all slots, or with ``multi_step=K`` a block of K steps when nothing
waits for a slot; inactive slots decode junk that the host discards, and
so does a slot for the rest of a block after it finishes. Finished
sequences free their slot at once.

Dense mode keeps a shared [slots, H, S, D] cache (float, or int8 with
``quantized_cache=True``); a prompt is padded to a power-of-two bucket, or
with ``chunked_prefill`` admitted in chunks of that size, each written in
place into the slot's rows of the shared cache.

Paged mode (``paged=True``) keeps one page pool per layer
(``serving/paged_cache.py``; int8, or int4 with ``kv_bits=4``) and a page
table per slot, so cache memory scales with resident tokens. An admission
reserves its request's worst case (prompt + max_new_tokens) in pages, or
with ``overcommit=True`` only what it needs now, preempting the youngest
slot (its continuation requeues at the front) when decode growth finds the
pool dry. Requests that do not fit yet wait in FIFO order; one that can
never fit finishes with an error. ``prefix_cache`` shares full prompt pages
between requests by a sha1 hash chain over their token chunks, and a hit
skips their prefill: only the suffix runs, attending the shared pages
(kernel K6). ``chunked_prefill`` admits long prompts in page-granular
chunks through the same path, and ``overlap_admission`` runs one decode
step for the resident slots between chunks, the admitting slot parked on a
never-allocated page-table column. Page and step tables live on the host
and go to the device only when an allocation changes, as one page table
shared by every layer (the step tables stay on the host: K5 does not read
them).

Ported here: ``Request``, the Python bookkeeper, greedy/sampled decoding
with per-request temperature/top-k/top-p, stop tokens, logprobs,
``cancel``, ``stats``, per-request prefill error isolation, the int8 cache,
the paged tier, dense chunked prefill, ``multi_step`` blocks, speculative
decoding, the engine-level recovery from a decode fault (every in-flight
request fails with ``.error`` set, the caches are rebuilt, the engine
serves on) and the native C++ scheduler (``scheduler="native"``, or
``"auto"`` once its library is built: ``serving/native.py``), which runs
the Python bookkeeper's state machine behind a C ABI.

Tensor parallelism (``mesh``): one process per device, each running this
engine on the same requests with its rank's model (``with_tp`` /
``parallel.sharding.shard_quantized_model``). The caches, pools, the draft
and its caches follow from the local modules and are head-local; page
tables and every host decision (admission, pages, preemption, speculation)
are the same on every rank, since the head's logits are gathered and every
rank seeds its generator alike. On CUDA the decode step's collectives are
captured into its graph (``serving/decode_graph.py``). A fault in a
dispatch or an admission raises under a mesh: only the rank that met it
would know, so no rank cancels requests or rebuilds its caches alone.

Speculation (``draft_model``, ``spec_gamma``): when nothing waits for a
slot, a dispatch runs speculative rounds instead of decode steps. In a
round the draft proposes gamma tokens per slot from its own dense cache
(in its dtype), the target verifies every slot's block in one
``prefill_chunk`` at the per-slot positions (dense: the plain composition;
paged: kernel K6), and batched Leviathan rejection sampling
(``spec_accept``) keeps a prefix and adds one token: greedy slots get the
plain engine's transcripts, sampled ones the target's warped
distribution. The draft prefills every admitted prompt into its slot;
plain steps (while requests wait, and between overlapped admission chunks)
leave holes in its cache that lower acceptance only.

On CUDA every decode dispatch (a step, a ``multi_step`` block, a step
between overlapped admission chunks, speculative rounds) replays a
captured CUDA graph of the decode step or of the round
(``serving/decode_graph.py``), the counterpart of the JAX engine's jitted
step: its inputs are device tensors updated in place, its tokens and
logprobs go to a ring that the host reads once per dispatch. The CPU runs
the same step eagerly.

The engine calls only the model's ``init_cache``, ``prefill``,
``prefill_chunk`` and ``decode_step``, so int8, W4A8 (``bits=4``) and
outlier-split models serve alike. With the outlier split a layer selects
its outlier dims over every row it is given — the prompt's bucket padding
at prefill, every slot (inactive ones too) at decode — so a request's
tokens can depend on what shares its step, as in the JAX engine.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from qgemm_tpu_torch.device import DeviceLike, resolve_device
from qgemm_tpu_torch.ops.kv_cache import QuantizedKVCache
from qgemm_tpu_torch.ops.sampling import (sample_logits, sample_logits_with_prob, token_logprob,
                                          warped_probs, warped_token_probs)
from qgemm_tpu_torch.parallel.mesh import axis_size
from qgemm_tpu_torch.serving.decode_graph import DecodeGraphs, GraphCaptureError
from qgemm_tpu_torch.serving.paged_cache import (PAGE_SIZE, PageAllocator,
                                                 build_step_tables, check_kv_bits,
                                                 check_step_tables, init_paged_cache,
                                                 paged_write_prompt)


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 32
    eos_token: Optional[int] = None
    # sampling: temperature 0 = greedy; top_p 1 = off; top_k None = the
    # engine default, 0 = off, >0 = cut
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: Optional[int] = None
    # any generated token in this set also finishes the request
    stop_tokens: Optional[List[int]] = None
    # collect ln p(token) of every generated token (raw softmax)
    logprobs: bool = False
    id: int = field(default_factory=itertools.count().__next__)
    generated: List[int] = field(default_factory=list)
    token_logprobs: List[float] = field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    error: Optional[str] = None


class _PyBookkeeper:
    """Host-side serving state machine: queue, slots, positions,
    transcripts, finish rules. The engine reads its state through
    ``active_mask``, ``positions``, ``request_in_slot``, ``num_waiting``,
    ``num_active`` and ``steps``, which ``_NativeBookkeeper`` has too."""

    def __init__(self, max_slots: int, max_seq_len: int):
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.active = np.zeros((max_slots,), bool)
        self.pos = np.zeros((max_slots,), np.int32)
        self.slot_req: Dict[int, Request] = {}
        self.waiting: List[Request] = []
        self.finished: List[Request] = []
        self.steps = 0

    def submit(self, req: Request, front: bool = False):
        if len(req.prompt) + req.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"request {req.id}: prompt {len(req.prompt)} + "
                f"{req.max_new_tokens} exceeds max_seq_len {self.max_seq_len}")
        if front:
            self.waiting.insert(0, req)
        else:
            self.waiting.append(req)

    def next_admission(self):
        if not self.waiting or self.active.all():
            return None
        slot = int(np.flatnonzero(~self.active)[0])
        req = self.waiting.pop(0)
        self.pos[slot] = len(req.prompt)
        self.active[slot] = True
        self.slot_req[slot] = req
        return slot, req

    def admitted(self, slot: int, first_token: int):
        self.slot_req[slot].generated.append(int(first_token))
        self._maybe_finish(slot)

    def record_step(self, tokens: np.ndarray):
        for slot in np.flatnonzero(self.active):
            self.pos[slot] += 1
            self.slot_req[int(slot)].generated.append(int(tokens[slot]))
            self._maybe_finish(int(slot))
        self.steps += 1

    def _maybe_finish(self, slot: int):
        req = self.slot_req.get(slot)
        if req is None:
            return
        last = req.generated[-1] if req.generated else None
        if (len(req.generated) >= req.max_new_tokens
                or (req.eos_token is not None and last == req.eos_token)
                or (req.stop_tokens and last in req.stop_tokens)
                or int(self.pos[slot]) >= self.max_seq_len - 1):
            req.done = True
            self.finished.append(req)
            self.active[slot] = False
            del self.slot_req[slot]

    def active_mask(self) -> np.ndarray:
        return self.active.copy()

    def positions(self) -> np.ndarray:
        """Every slot's position (the next one it writes); a free slot's
        is stale."""
        return self.pos.copy()

    def request_in_slot(self, slot: int) -> Optional[Request]:
        """The Request occupying ``slot``, or None when it is free."""
        return self.slot_req.get(slot)

    def record_block(self, cands: np.ndarray, produced: np.ndarray):
        """Append each active slot's own accepted block (variable length per
        slot), honoring the finish rules mid-block. One scheduler step.
        Returns the per-slot count actually appended."""
        accepted = np.zeros(self.max_slots, np.int32)
        for slot in np.flatnonzero(self.active):
            req = self.slot_req.get(int(slot))
            for i in range(int(produced[slot])):
                if req is None or req.done:
                    break
                self.pos[slot] += 1
                req.generated.append(int(cands[slot, i]))
                accepted[slot] += 1
                self._maybe_finish(int(slot))
        self.steps += 1
        return accepted

    def suspend_slot(self, slot: int):
        """Drop ``slot`` from the active set without touching its request."""
        if self.slot_req.get(slot) is None:
            raise KeyError(f"slot {slot} holds no request")
        self.active[slot] = False

    def resume_slot(self, slot: int):
        if self.slot_req.get(slot) is not None:
            self.active[slot] = True

    def preempt(self, req_id: int):
        """Free an ACTIVE request's slot and remove it (not into finished).
        -> (slot, generated tokens) or None when not active."""
        for slot, r in list(self.slot_req.items()):
            if r.id == req_id:
                self.active[slot] = False
                del self.slot_req[slot]
                return slot, list(r.generated)
        return None

    def cancel(self, req_id: int):
        """-> ("waiting", Request) | ("active", slot) | None. An active
        cancel frees the slot and moves the partial transcript to finished."""
        for i, r in enumerate(self.waiting):
            if r.id == req_id:
                return "waiting", self.waiting.pop(i)
        for slot, r in list(self.slot_req.items()):
            if r.id == req_id:
                self.active[slot] = False
                del self.slot_req[slot]
                self.finished.append(r)
                return "active", slot
        return None

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    def drain_finished(self) -> List[Request]:
        out, self.finished = self.finished, []
        return out


class _NativeBookkeeper:
    """The same state machine, run by the C++ scheduler
    (``serving/native.py``). The scheduler keeps the transcripts; a
    request's ``generated`` is filled in, and ``done`` set, when it
    finishes."""

    def __init__(self, max_slots: int, max_seq_len: int):
        from qgemm_tpu_torch.serving.native import NativeScheduler
        self._sched = NativeScheduler(max_slots, max_seq_len)
        self._by_id: Dict[int, Request] = {}

    def submit(self, req: Request, front: bool = False):
        self._sched.submit(req.id, req.prompt, req.max_new_tokens, req.eos_token,
                           front=front)
        if req.stop_tokens:
            self._sched.set_stops(req.id, req.stop_tokens)
        self._by_id[req.id] = req

    def next_admission(self):
        adm = self._sched.next_admission()
        if adm is None:
            return None
        slot, rid, _ = adm
        return slot, self._by_id[rid]

    def admitted(self, slot: int, first_token: int):
        self._sched.admitted(slot, int(first_token))

    def record_step(self, tokens: np.ndarray):
        self._sched.record_step(tokens)

    def record_block(self, cands: np.ndarray, produced: np.ndarray):
        return self._sched.record_block(cands, produced)

    def active_mask(self) -> np.ndarray:
        return self._sched.active_mask()

    def positions(self) -> np.ndarray:
        return self._sched.positions()

    def request_in_slot(self, slot: int) -> Optional[Request]:
        rid = self._sched.request_in_slot(slot)
        return None if rid is None else self._by_id.get(rid)

    def suspend_slot(self, slot: int):
        self._sched.suspend_slot(slot)

    def resume_slot(self, slot: int):
        self._sched.resume_slot(slot)

    def preempt(self, req_id: int):
        res = self._sched.preempt(req_id)
        if res is None:
            return None
        slot, gen = res
        self._by_id.pop(req_id, None)
        return slot, [int(t) for t in gen]

    def cancel(self, req_id: int):
        res = self._sched.cancel(req_id)
        if res is None:
            return None
        if res == -1:
            return "waiting", self._by_id.pop(req_id)
        return "active", res

    @property
    def num_waiting(self) -> int:
        return self._sched.num_waiting

    @property
    def num_active(self) -> int:
        return self._sched.num_active

    @property
    def steps(self) -> int:
        return self._sched.steps

    def drain_finished(self) -> List[Request]:
        out = []
        while (fin := self._sched.pop_finished()) is not None:
            rid, toks = fin
            req = self._by_id.pop(rid)
            req.generated = [int(t) for t in toks]
            req.done = True
            out.append(req)
        return out


def _position_rows(v, gamma: int):
    """A per-slot knob [B] repeated for each of a slot's ``gamma`` rows
    ([B * gamma], slot-major); a scalar stays as it is."""
    return v.repeat_interleave(gamma) if isinstance(v, torch.Tensor) and v.ndim == 1 else v


def spec_leftover(tlogits: torch.Tensor, d: torch.Tensor, qx: torch.Tensor,
                  dlogits: torch.Tensor, temps, topps, topks, u: torch.Tensor, gamma: int):
    """The deterministic half of batched Leviathan acceptance (JAX's
    ``spec_accept``, ``qgemm_tpu/serving/engine.py:281-335``, up to its one
    categorical draw). tlogits [B, gamma+1, V] the target's verify-chunk
    logits, d [B, gamma] the draft's proposals, qx [B, gamma] each one's
    probability under the draft's own warped distribution, dlogits [B,
    gamma, V] the draft's logits, per-slot knobs (scalars or [B]), u [B,
    gamma] uniforms in [0, 1). Proposal i is accepted while u * q(x) <
    p(x), the target's warped probability of it, read in sorted space.
    Returns (n_acc [B], the leftover distribution [B, V] at the first
    rejection, norm(max(0, p - q)), or p itself after full acceptance).
    Slots at temperature <= 1e-6 see one-hots: acceptance is argmax
    agreement and the leftover the target's argmax."""
    b, _, v = tlogits.shape
    px = warped_token_probs(tlogits[:, :gamma].reshape(b * gamma, v), d.reshape(-1),
                            _position_rows(temps, gamma), _position_rows(topks, gamma),
                            _position_rows(topps, gamma)).reshape(b, gamma)
    n_acc = torch.cumprod((u * qx < px).to(torch.int64), dim=1).sum(dim=1)
    at = lambda x, i: torch.gather(x, 1, i[:, None, None].expand(b, 1, v))[:, 0]
    p_at = warped_probs(at(tlogits, n_acc), temps, topks, topps)
    # the draft sampled from its unfiltered temperature distribution, so q
    # is that one; past the last proposal it is defined 0
    q_at = warped_probs(at(dlogits, n_acc.clamp_max(gamma - 1)), temps, 0, 1.0)
    q_at = torch.where((n_acc < gamma)[:, None], q_at, torch.zeros_like(q_at))
    resid = torch.clamp_min(p_at - q_at, 0.0)
    dist = torch.where((resid.sum(dim=1) > 1e-9)[:, None], resid, p_at)
    return n_acc, dist


def spec_candidates(tlogits: torch.Tensor, d: torch.Tensor, n_acc: torch.Tensor,
                    extra: torch.Tensor):
    """A round's block from its acceptance: cand [B, gamma+1] (the accepted
    proposals, then ``extra`` [B]), produced [B] = n_acc + 1, cur_new [B]
    (the block's last token) and lps [B, gamma+1] (ln p of each candidate
    under the target's unmodified softmax)."""
    idx = torch.arange(d.shape[1] + 1, device=d.device)[None, :]
    dpad = torch.cat([d, d[:, -1:]], dim=1)
    cand = torch.where(idx < n_acc[:, None], dpad, extra[:, None])
    produced = n_acc + 1
    cur_new = torch.gather(cand, 1, n_acc[:, None])[:, 0]
    lps = torch.gather(torch.log_softmax(tlogits.to(torch.float32), dim=-1), 2,
                       cand[..., None])[..., 0]
    return cand, produced, cur_new, lps


def spec_accept(tlogits: torch.Tensor, d: torch.Tensor, qx: torch.Tensor,
                dlogits: torch.Tensor, temps, topps, topks,
                generator: Optional[torch.Generator], gamma: int):
    """Batched Leviathan rejection sampling (JAX's ``spec_accept``): the
    uniforms and the extra token's draw come from ``generator``, the rest
    is ``spec_leftover`` and ``spec_candidates``. Each slot's tokens are
    distributed as sequential warped-target sampling. Returns (cand [B,
    gamma+1], produced [B], cur_new [B], lps [B, gamma+1])."""
    u = torch.rand(d.shape, generator=generator, device=d.device)
    n_acc, dist = spec_leftover(tlogits, d, qx, dlogits, temps, topps, topks, u, gamma)
    extra = torch.multinomial(dist, 1, generator=generator)[:, 0]
    return spec_candidates(tlogits, d, n_acc, extra)


def spec_accept_greedy(tlogits: torch.Tensor, d: torch.Tensor):
    """``spec_accept`` for a batch of greedy slots, drawing nothing: the
    longest prefix of proposals equal to the target's argmax, then the
    target's argmax after it (what ``spec_accept`` gives at temperature
    <= 1e-6)."""
    g = tlogits.to(torch.float32).argmax(dim=-1)                    # [B, gamma+1]
    n_acc = torch.cumprod((d == g[:, :-1]).to(torch.int64), dim=1).sum(dim=1)
    return spec_candidates(tlogits, d, n_acc, torch.gather(g, 1, n_acc[:, None])[:, 0])


def _slot_view(cache, slot: int):
    """One layer's cache restricted to ``slot``: views, so writes land in
    the shared cache."""
    sliced = [t[slot:slot + 1] for t in cache]
    return QuantizedKVCache(*sliced) if isinstance(cache, QuantizedKVCache) \
        else tuple(sliced)


class _PagedPoolOps:
    """Host-side paged-pool plumbing: page-table sync, per-slot growth and
    release, and the pools themselves. Expects ``self.alloc``
    (PageAllocator), ``self._pt_host`` [slots, pps + 1] int32,
    ``self._pt_dev`` (the device page table every layer's cache shares),
    ``self._pool_shape`` (the pools' geometry), ``self.caches``,
    ``self._page_size``, ``self.max_slots``, ``self.device``, ``self.book``,
    ``self.overcommit`` and ``self._slot_worst``."""

    def _new_pools(self, n_layers: int) -> list:
        """Zero paged pools of the engine's geometry, one for each of
        ``n_layers``, sharing the engine's device page table."""
        g = self._pool_shape
        pools = [init_paged_cache(g["n_heads"], g["head_dim"], g["n_pages"], self.max_slots,
                                  self._pt_host.shape[1], page_size=g["page_size"],
                                  kv_bits=g["kv_bits"], device=self.device)
                 for _ in range(n_layers)]
        for c in pools:
            c.page_table = self._pt_dev
        return pools

    def _sync_page_tables(self):
        """Copy the host page table into the shared device table (one copy
        for every layer, queued behind the work already on the stream) and
        rebuild (and check) the host step tables. Runs only when an
        allocation changed."""
        src = torch.from_numpy(self._pt_host)
        if self._pt_dev.is_cuda:
            src = src.pin_memory()
        self._pt_dev.copy_(src, non_blocking=True)
        b, pps = self._pt_host.shape
        ss, sp = build_step_tables([len(p) for p in self.alloc.slot_pages], pps)
        check_step_tables(ss, sp, b, pps)
        ss, sp = torch.from_numpy(ss), torch.from_numpy(sp)
        for c in self.caches:
            c.step_slot, c.step_page = ss, sp

    def _grow_slot(self, slot: int, n_tokens: int) -> bool:
        """Ensure pages for ``n_tokens``; True if the tables need a sync."""
        new = self.alloc.grow(slot, n_tokens, self._page_size)
        for j, p in new:
            self._pt_host[slot, j] = p
        return bool(new)

    def _release_slot_pages(self, slot: int):
        self.alloc.release(slot)
        self._pt_host[slot, :] = 0

    def _grow_active_slots(self, active: np.ndarray, ahead: int = 1):
        """Before a decode dispatch of ``ahead`` steps: give every active
        slot pages for its next ``ahead`` positions, but never past its
        reservation (with ``overcommit``: its worst case), since a slot
        finishes before it; a block's junk positions past it write the null
        page. With ``overcommit`` a dry pool preempts the youngest other
        slot, or the slot itself, and retries. Positions come from the
        bookkeeper, not the device. A slot that an earlier slot's growth
        preempted is skipped: the JAX engine grows from the stale ``active``
        snapshot and can hand pages to a slot it just freed. Syncs the
        tables if any slot grew."""
        dirty = False
        # a preemption in the loop frees a slot and moves no other slot
        pos = self.book.positions()
        for slot in np.flatnonzero(active):
            slot = int(slot)
            if not self.book.active_mask()[slot]:
                continue
            p = int(pos[slot])
            cap = (int(self._slot_worst[slot]) if self.overcommit
                   else len(self.alloc.slot_pages[slot]) * self._page_size)
            want = min(p + ahead, max(cap, p + 1))
            while True:
                try:
                    dirty |= self._grow_slot(slot, want)
                    break
                except RuntimeError:
                    if not self.overcommit or not self._preempt_for_pages(slot):
                        raise
                    dirty = True
                    if not self.book.active_mask()[slot]:
                        break            # the slot preempted itself
        if dirty:
            self._sync_page_tables()


class _EngineLoop(_PagedPoolOps):
    """The serving loop both engines share (``ContinuousBatchingEngine`` and
    ``serving/seq2seq.Seq2SeqEngine``): sampling, the decode and speculative
    dispatches (graph replays on CUDA, the eager step on the CPU), the
    host's replay of their outputs through the bookkeeper, ``step``,
    ``cancel``, ``stats`` and ``run_to_completion``. The step bodies
    ``_decode_body`` and ``_spec_body`` take their model calls from the
    engine's ``_step_logits``, ``_draft_logits`` and ``_verify_logits``;
    an engine provides those, its ``_admit``, ``_rebuild_caches`` (fault
    recovery) and the state they use."""

    def _init_loop(self) -> None:
        """The loop's state, for an engine that has set ``device``,
        ``max_slots``, ``multi_step``, ``spec_gamma``, ``draft`` and
        ``_gen``."""
        # the decode step's inputs and outputs: device tensors that every
        # dispatch reads and writes in place (a captured graph holds their
        # addresses)
        dev, max_slots = self.device, self.max_slots
        self.positions = torch.zeros((max_slots,), dtype=torch.int64, device=dev)
        self.cur_tokens = torch.zeros((max_slots, 1), dtype=torch.int64, device=dev)
        self._active_dev = torch.zeros((max_slots,), dtype=torch.int64, device=dev)
        self._active_host: Optional[np.ndarray] = None   # what _active_dev holds
        self._temps_dev = torch.zeros((max_slots,), dtype=torch.float32, device=dev)
        self._topps_dev = torch.ones((max_slots,), dtype=torch.float32, device=dev)
        self._topks_dev = torch.zeros((max_slots,), dtype=torch.int64, device=dev)
        # per step of a dispatch: the tokens [0] and their logprobs [1] of
        # every slot, at the step's index (float64 holds both exactly)
        self._ring = torch.zeros((max(1, self.multi_step), 2, max_slots),
                                 dtype=torch.float64, device=dev)
        self._ring_idx = torch.zeros((1,), dtype=torch.int64, device=dev)
        # per round of a speculative dispatch, every slot's candidates, how
        # many it produced, and their logprobs: [rounds, slots, 2 gamma + 3]
        self._spec_ring = (torch.zeros((max(1, self.multi_step), max_slots,
                                        2 * self.spec_gamma + 3),
                                       dtype=torch.float64, device=dev)
                           if self.draft is not None else None)
        # the temperatures also on the host: an all-greedy batch then runs
        # the argmax step without a device round trip
        self.temps = np.zeros((max_slots,), np.float32)
        # the CUDA graphs of the decode step; None runs it eagerly (the CPU,
        # or an A/B against the graphs)
        self._graphs: Optional[DecodeGraphs] = (
            DecodeGraphs(self._body, dev, self._gen, collectives=self.mesh is not None)
            if dev.type == "cuda" else None)
        self.finished: List[Request] = []
        self.tokens_generated = 0
        self.decode_steps = 0          # decode steps run on the device
        # speculation: rounds run on the device, and rounds, proposals and
        # accepted proposals of the slots still active when a round replays
        self.spec_device_rounds = 0
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self._lp_slots: Dict[int, Request] = {}
        self._admit_times: List[float] = []
        self._itl: List[float] = []
        self._last_tick_t: Optional[float] = None
        self._t_start: Optional[float] = None

    def _sample(self, logits: torch.Tensor, greedy: bool, temps, topps, topks) -> torch.Tensor:
        """Tokens [B] from logits [B, V]: the argmax for an all-greedy batch,
        else ``sample_logits`` with per-slot knobs (scalars or [B])."""
        if greedy:
            return logits.to(torch.float32).argmax(dim=-1)
        return sample_logits(logits, self._gen, temps, topks, topps)

    def _sample_first(self, last: torch.Tensor, temp: float, topp: float, topk: int):
        """The first generated token and its logprob from the last prompt
        position's logits [1, V]."""
        tok = self._sample(last, temp <= 1e-6, temp, topp, topk)
        return int(tok[0]), float(token_logprob(last, tok)[0])

    def _body(self, mode: str) -> None:
        """One step of a dispatch of ``mode``: a decode step ("greedy",
        "sampled") or a speculative round ("spec_greedy", "spec_sampled")."""
        (self._spec_body if mode.startswith("spec") else self._decode_body)(mode)

    @torch.no_grad()
    def _spec_body(self, mode: str) -> None:
        """One speculative round over every slot, on device tensors only
        (the JAX engines' ``_spec_round_impl``): the draft takes gamma + 1
        decode steps from each slot's position (``_draft_logits``; the last
        one only writes the last proposal's K/V), the target verifies [cur,
        d_1..d_gamma] in one chunk at the per-slot positions
        (``_verify_logits``), and ``spec_accept`` (``spec_accept_greedy``
        for "spec_greedy", which draws nothing) picks each slot's block. The
        block, its length and its logprobs go to the spec ring at the ring's
        index; the active slots advance by their block and feed its last
        token back.
        "spec_sampled" samples the proposals from the draft's unfiltered
        temperature distribution; the slots' filters act in the target's."""
        g = self.spec_gamma
        sampled = mode == "spec_sampled"
        tok, props, qxs, dlogits = self.cur_tokens, [], [], []
        for j in range(g + 1):
            logits = self._draft_logits(tok, self.positions + j)
            if sampled:
                nxt, qx = sample_logits_with_prob(logits, self._gen, self._temps_dev, 0, 1.0)
                qxs.append(qx)
                dlogits.append(logits)
            else:
                nxt = logits.to(torch.float32).argmax(dim=-1)
            props.append(nxt)
            tok = nxt[:, None]
        d = torch.stack(props[:g], dim=1)                             # [B, gamma]
        tlogits = self._verify_logits(torch.cat([self.cur_tokens, d], dim=1))
        if sampled:
            cand, produced, cur_new, lps = spec_accept(
                tlogits, d, torch.stack(qxs[:g], dim=1), torch.stack(dlogits[:g], dim=1),
                self._temps_dev, self._topps_dev, self._topks_dev, self._gen, g)
        else:
            cand, produced, cur_new, lps = spec_accept_greedy(tlogits, d)
        row = torch.cat([cand.to(torch.float64), produced[:, None].to(torch.float64),
                         lps.to(torch.float64)], dim=1)
        self._spec_ring.index_copy_(0, self._ring_idx, row[None])
        self._ring_idx.add_(1)
        self.positions.add_(produced * self._active_dev)
        self.cur_tokens.copy_(torch.where(self._active_dev[:, None] > 0, cur_new[:, None],
                                          self.cur_tokens))

    @torch.no_grad()
    def _decode_body(self, mode: str) -> None:
        """One decode step over every slot, on device tensors only (what a
        CUDA graph captures): the logits of ``_step_logits``, each slot's
        next token ("greedy": the argmax) and its logprob into the ring at
        the ring's index, the tokens fed back and the active slots'
        positions advanced."""
        logits = self._step_logits()
        nxt = self._sample(logits, mode == "greedy", self._temps_dev, self._topps_dev,
                           self._topks_dev)
        lps = token_logprob(logits, nxt)
        row = torch.stack((nxt.to(torch.float64), lps.to(torch.float64)))
        self._ring.index_copy_(0, self._ring_idx, row[None])
        self._ring_idx.add_(1)
        self.cur_tokens.copy_(nxt[:, None])
        self.positions.add_(self._active_dev)

    def _dispatch(self, active: np.ndarray, n: int, mode: str) -> None:
        """``n`` steps of ``mode`` (``_body``) over every slot, the
        ``active`` ones advancing: graph replays on CUDA, the eager step on
        the CPU. Their outputs fill the ring from index 0."""
        if self._active_host is None or not np.array_equal(self._active_host, active):
            src = torch.from_numpy(active.astype(np.int64))
            if self._active_dev.is_cuda:
                src = src.pin_memory()
            self._active_dev.copy_(src, non_blocking=True)
            self._active_host = active.copy()
        self._ring_idx.zero_()
        if self._graphs is not None:
            self._graphs.run(mode, n)
            return
        for _ in range(n):
            self._body(mode)

    def _greedy(self, active: np.ndarray) -> bool:
        return bool(np.all(self.temps[active] <= 1e-6))

    def _decode(self, active: np.ndarray, n: int):
        """A dispatch of ``n`` decode steps (the JAX engine's ``_decode`` for
        n == 1 and ``_decode_multi`` above). Returns the steps' tokens [n,
        slots] and logprobs [n, slots] on the host, read in one copy."""
        self._dispatch(active, n, "greedy" if self._greedy(active) else "sampled")
        self.decode_steps += n
        ring = self._ring[:n].cpu().numpy()
        return ring[:, 0].astype(np.int64), ring[:, 1].astype(np.float32)

    def _spec(self, active: np.ndarray, n: int):
        """A dispatch of ``n`` speculative rounds (the JAX engine's
        ``_spec_round`` for n == 1 and ``_spec_multi`` above); positions
        and tokens chain through the rounds on the device. Returns the
        rounds' candidates [n, slots, gamma+1], produced counts [n, slots]
        and logprobs [n, slots, gamma+1] on the host, read in one copy."""
        self._dispatch(active, n, "spec_greedy" if self._greedy(active) else "spec_sampled")
        self.spec_device_rounds += n
        ring = self._spec_ring[:n].cpu().numpy()
        g1 = self.spec_gamma + 1
        return (ring[..., :g1].astype(np.int64), ring[..., g1].astype(np.int64),
                ring[..., g1 + 1:].astype(np.float32))

    def _recover_from_decode_fault(self, e: Exception):
        """A failed decode dispatch leaves every in-flight sequence's cache
        rows unknown: fail those requests with the error, free their slots
        and pages, drop the captured graphs, which hold the old caches'
        addresses, rebuild the caches (the engine's ``_rebuild_caches``,
        the draft's too: a fault in a speculative round leaves both
        unknown) and zero the positions and tokens. The engine serves later
        submissions. A slot suspended for an overlapped admission is not
        active here: its admission errors when the fault reaches it.

        Under a mesh the fault is raised instead: it reached this rank
        only, and a rank that recovered alone would pair its next
        collectives with the other ranks' and sum rows of other requests."""
        if self.mesh is not None:
            raise e
        msg = f"decode step failed: {type(e).__name__}: {e}"
        self._lp_slots.clear()
        for slot in np.flatnonzero(self.book.active_mask()):
            req = self.book.request_in_slot(int(slot))
            self._cancel_slot(int(slot), msg)
            if req is not None:
                req.done = True
        self.finished.extend(self._drain_finished())
        if self._graphs is not None:
            self._graphs.reset()
        self.caches = self.draft_caches = None   # free the old caches first
        self._rebuild_caches()
        self.positions.zero_()
        self.cur_tokens.zero_()

    def _unadmit(self, req: Request):
        """Undo an admission: free the slot, keep any OTHER requests the
        bookkeeper finished in the meantime."""
        self.book.cancel(req.id)
        for r in self.book.drain_finished():
            if r.id != req.id:
                self.finished.append(self._finalize(r))

    def cancel(self, req_id: int) -> bool:
        """Cancel a request by id: a waiting request is dropped; an active
        one frees its slot (and pages) at once, its partial transcript
        kept. Returns False when the id is unknown or already finished."""
        res = self.book.cancel(req_id)
        if res is None:
            return False
        kind, info = res
        if kind == "waiting":
            info.done = True
            info.cancelled = True
            self.finished.append(self._finalize(info))
        else:
            self._lp_slots.pop(info, None)
            if self.paged:
                self._release_slot_pages(info)
            for r in self.book.drain_finished():
                r.done = True
                if r.id == req_id:
                    r.cancelled = True
                self.finished.append(self._finalize(r))
        return True

    def _finalize(self, r: Request) -> Request:
        """Merge a finished continuation back into the ORIGINAL Request: a
        preempted request finishes as a continuation whose transcript holds
        only its post-preemption tokens."""
        info = self._preempted.pop(r.id, None)
        if info is None:
            return r
        orig = info["req"]
        orig.generated = info["gen"] + list(r.generated)
        orig.token_logprobs = info["lps"] + list(r.token_logprobs)
        orig.done, orig.error = r.done, r.error
        orig.cancelled = r.cancelled
        return orig

    def _drain_finished(self) -> List[Request]:
        return [self._finalize(r) for r in self.book.drain_finished()]

    def _cancel_slot(self, slot: int, error_msg: str):
        """Cancel whatever request occupies ``slot`` (if any), tagging it
        with ``error_msg``, and free its pages."""
        req = self.book.request_in_slot(slot)
        if req is None:
            return
        req.error = error_msg
        self.book.cancel(req.id)
        if self.paged:
            self._release_slot_pages(slot)

    @property
    def steps(self) -> int:
        return self.book.steps

    @property
    def stats(self) -> Dict[str, float]:
        """Throughput counters, admission latency, inter-token latency (one
        sample per decode dispatch), in paged mode pool occupancy,
        prefix-cache and over-commit counters, with a draft the speculative
        rounds and the share of proposals accepted, and on CUDA the decode
        graphs' captures and replays (speculative rounds included)."""
        wall = (time.perf_counter() - self._t_start) if self._t_start else 0.0
        st = {"tokens_generated": self.tokens_generated, "steps": int(self.steps),
              "decode_steps": self.decode_steps,
              "wall_s": round(wall, 3),
              "tokens_per_s": round(self.tokens_generated / wall, 2) if wall else 0.0}
        if self._admit_times:
            at = np.asarray(self._admit_times)
            st["admit_p50_ms"] = round(float(np.percentile(at, 50)) * 1e3, 2)
            st["admit_p95_ms"] = round(float(np.percentile(at, 95)) * 1e3, 2)
            st["admissions"] = len(at)
        if self.paged:
            total = self.caches[0].n_pages - 1          # page 0 reserved
            ps = self._page_size
            act, pos = self.book.active_mask(), self.book.positions()
            st.update(
                pages_in_use=total - self.alloc.n_free, pages_total=total,
                prefix_hits=self.alloc.prefix_hits,
                prefix_cached_pages=len(self.alloc.cached),
                prefill_tokens_skipped=self.prefill_tokens_skipped,
                # pages held by slots vs pages their positions occupy: the
                # worst-case reservation strands the difference
                pages_reserved=sum(len(p) for p in self.alloc.slot_pages),
                pages_used=int(sum(-(-(int(pos[s]) + 1) // ps)
                                   for s in np.flatnonzero(act))),
                preemptions=self.preemptions)
        if self._itl:
            it = np.asarray(self._itl)
            st["itl_p50_ms"] = round(float(np.percentile(it, 50)) * 1e3, 2)
            st["itl_p95_ms"] = round(float(np.percentile(it, 95)) * 1e3, 2)
        if self.draft is not None and self.spec_drafted:
            st["spec_rounds"] = self.spec_rounds
            st["spec_acceptance"] = round(self.spec_accepted / self.spec_drafted, 4)
        if self._graphs is not None:
            st.update(decode_graph_captures=self._graphs.captures,
                      decode_graph_replays=self._graphs.replays)
        return st

    def _record_itl(self):
        """Wall-clock gap between consecutive decode steps while slots are
        resident (admission stalls included). Bounded sample ring."""
        now = time.perf_counter()
        if self._last_tick_t is not None:
            if len(self._itl) >= 4096:
                del self._itl[:2048]
            self._itl.append(now - self._last_tick_t)
        self._last_tick_t = now

    def _record_block(self, active: np.ndarray, toks: np.ndarray, lps: np.ndarray):
        """Host bookkeeping after a dispatch over the ``active`` slots: replay
        its steps' tokens and logprobs [n, slots] through the bookkeeper in
        order, which drops what a slot produced after its own finish; then
        free the slots that finished."""
        for i in range(toks.shape[0]):
            active_i = self.book.active_mask()
            if not active_i.any():
                break
            for slot, r in self._lp_slots.items():
                if active_i[slot]:
                    r.token_logprobs.append(float(lps[i, slot]))
            self.book.record_step(toks[i])
            self.tokens_generated += int(active_i.sum())
        for slot in np.flatnonzero(active & ~self.book.active_mask()):
            self._lp_slots.pop(int(slot), None)
            if self.paged:
                self._release_slot_pages(int(slot))
        self.finished.extend(self._drain_finished())
        self._record_itl()

    def step(self) -> bool:
        """Admit waiting requests, then run one decode step for all slots, or
        a block of ``multi_step`` steps when nothing waits for a slot; with
        a draft and nothing waiting, speculative rounds instead
        (``_spec_step``). A decode fault recovers at engine level
        (``_recover_from_decode_fault``)."""
        if self._t_start is None:
            self._t_start = time.perf_counter()
        self._admit()
        active = self.book.active_mask()
        if not active.any():
            return False
        if self.draft is not None and self.book.num_waiting == 0:
            return self._spec_step(active)
        n = self.multi_step if self.multi_step > 1 and self.book.num_waiting == 0 else 1
        if self.paged:
            # pool exhaustion raises here (size the pool for the resident
            # tokens, or lower max_slots) or, with overcommit, preempts
            self._grow_active_slots(active, ahead=n)
            if self.overcommit:
                active = active & self.book.active_mask()
                if not active.any():
                    return True
        try:
            toks, lps = self._decode(active, n)
        except GraphCaptureError:
            raise
        except Exception as e:  # noqa: BLE001 — engine-level recovery
            self._recover_from_decode_fault(e)
            return True
        self._record_block(active, toks, lps)
        return True

    def _spec_step(self, active: np.ndarray) -> bool:
        """One speculative dispatch (nothing waits): a round, or with
        ``multi_step`` that many rounds, each slot advancing by its own
        accepted block. Paged slots first get pages for the dispatch's
        candidate rows (within their reservation; rows past it write the
        null page). The host replays the rounds in order through the
        bookkeeper, which truncates each block at a finish and drops what a
        slot produced after it; acceptance counts what the transcripts
        kept, for the slots still active when each round replays."""
        n = self.multi_step if self.multi_step > 1 else 1
        if self.paged:
            self._grow_active_slots(active, ahead=n * self.spec_extra)
            if self.overcommit:
                active = active & self.book.active_mask()
                if not active.any():
                    return True
        try:
            cands, produced, lps = self._spec(active, n)
        except GraphCaptureError:
            raise
        except Exception as e:  # noqa: BLE001 — engine-level recovery
            self._recover_from_decode_fault(e)
            return True
        for i in range(n):
            act_i = self.book.active_mask()
            if not act_i.any():
                break
            accepted = self.book.record_block(cands[i], produced[i])
            self.tokens_generated += int(accepted.sum())
            slots = np.flatnonzero(act_i)
            self.spec_rounds += 1
            self.spec_drafted += self.spec_gamma * len(slots)
            # proposals the transcript kept: what was appended, less the
            # extra token when the block ran to it
            used = np.minimum(accepted[slots], produced[i, slots] - 1)
            self.spec_accepted += int(used.clip(min=0).sum())
            for slot, r in self._lp_slots.items():
                r.token_logprobs.extend(float(x) for x in lps[i, slot, :accepted[slot]])
        for slot in np.flatnonzero(active & ~self.book.active_mask()):
            self._lp_slots.pop(int(slot), None)
            if self.paged:
                self._release_slot_pages(int(slot))
        self.finished.extend(self._drain_finished())
        self._record_itl()
        return True

    def run_to_completion(self, max_steps: int = 100000) -> List[Request]:
        while ((self.book.num_waiting or self.book.num_active)
               and self.steps < max_steps):
            self.step()
        self.finished.extend(self._drain_finished())
        return self.finished


def check_mesh(mesh, *models):
    """The engines' ``mesh``: None, or a mesh with a ``"model"`` axis over
    which every quantized layer of the models that is sharded was sharded."""
    if mesh is None:
        return None
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if "model" not in names:
        raise ValueError(f"mesh {mesh!r}: expected a DeviceMesh with a 'model' axis "
                         "(parallel.mesh.make_mesh)")
    for m in models:
        for mod in ([] if m is None else m.modules()):
            if getattr(mod, "tp_mode", "none") != "none" and mod.mesh is not mesh:
                raise ValueError("the model was sharded over another mesh than the "
                                 "engine's")
    return mesh


class ContinuousBatchingEngine(_EngineLoop):
    def __init__(self, model, max_slots: int = 8, max_seq_len: Optional[int] = None,
                 scheduler: str = "auto", quantized_cache: bool = False,
                 top_k: int = 0, seed: int = 0, mesh=None, paged: bool = False,
                 n_pages: Optional[int] = None, chunked_prefill: Optional[int] = None,
                 prefix_cache: bool = True, multi_step: int = 0, draft_model=None,
                 spec_gamma: int = 4, overcommit: bool = False,
                 page_size: Optional[int] = None,
                 overlap_admission: bool = False, kv_bits: int = 8,
                 device: DeviceLike = None):
        """Options as in the JAX engine. ``mesh``: tensor-parallel serving —
        the mesh the model was sharded over, ``model`` (and ``draft_model``)
        this rank's model of it (see the module note). ``scheduler``
        "python" runs the Python bookkeeper, "native" the C++ scheduler (``serving/native.py``, its
        library built at first use, or raises), "auto" the native one when
        its library is built already and the Python one otherwise;
        ``self.scheduler`` records the choice. The two give the same
        transcripts. ``device`` is where the engine runs (default: the
        GPU — raises without one); the model (and the draft) must be there.

        ``draft_model`` turns on speculation with ``spec_gamma`` proposals
        a round: every cache extent and page reservation grows by
        ``spec_gamma + 2`` positions, the paged table by as many pages.
        ``spec_gamma`` raises a ``ValueError`` without ``draft_model``.

        ``multi_step=K`` (K > 1) runs a block of K decode steps per dispatch
        whenever nothing waits for a slot (on CUDA: K replays of the decode
        graph, one read of their tokens); a slot that finishes inside a
        block decodes junk into its own rows for the rest of it, which the
        host discards. Greedy transcripts equal the single-step engine's.
        ``chunked_prefill`` admits a prompt longer than that many tokens in
        chunks of that size (the last padded) through ``prefill_chunk``, or
        whole where the padded chunks would overrun the cache extent.

        Paged mode (``paged=True``): ``n_pages`` sizes the pool (default:
        every slot's full table, plus the null page), ``page_size`` (default
        128; on the GPU a multiple of 8 from 8 to 256) the pages,
        ``kv_bits`` 8 or 4 the pools (int4 needs an even page).
        ``prefix_cache`` (default on) shares full prompt pages between
        requests; ``overcommit`` reserves pages needed now instead of the
        worst case and preempts on exhaustion; ``chunked_prefill`` (rounded
        up to whole pages) admits long prompts chunk by chunk, and
        ``overlap_admission`` runs a decode step between those chunks. The
        options of paged mode, ``prefix_cache=False`` among them, raise a
        ``ValueError`` without ``paged=True``; ``quantized_cache`` has no
        effect there (pools are always quantized)."""
        self.mesh = check_mesh(mesh, model, draft_model)
        if scheduler not in ("auto", "python", "native"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        if not paged:
            for name, value, used in (("n_pages", n_pages, n_pages is not None),
                                      ("page_size", page_size, page_size is not None),
                                      ("kv_bits", kv_bits, kv_bits != 8),
                                      ("overcommit", overcommit, overcommit),
                                      ("overlap_admission", overlap_admission,
                                       overlap_admission),
                                      ("prefix_cache", prefix_cache, not prefix_cache)):
                if used:
                    raise ValueError(f"ContinuousBatchingEngine({name}={value!r}) "
                                     "needs paged=True")
        if draft_model is None and spec_gamma != 4:
            raise ValueError(f"ContinuousBatchingEngine(spec_gamma={spec_gamma!r}) needs "
                             "draft_model")
        if draft_model is not None and not callable(getattr(draft_model, "decode_step", None)):
            raise TypeError(f"ContinuousBatchingEngine(draft_model={draft_model!r}): not a "
                            "model (no decode_step)")
        self.device = resolve_device(device)
        for name, m in (("model", model), ("draft_model", draft_model)):
            if m is not None and m.device != self.device:
                raise ValueError(f"{name} is on {m.device}, engine on {self.device}")
        self.model = model
        self.draft = draft_model
        self.spec_gamma = int(spec_gamma)
        if draft_model is not None and self.spec_gamma < 1:
            raise ValueError(f"spec_gamma must be >= 1, got {spec_gamma}")
        # a speculative round writes candidate K/V up to gamma + 1 positions
        # past a slot's current one: every cache extent and reservation
        # covers them
        self.spec_extra = self.spec_gamma + 2 if draft_model is not None else 0
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len or model.cfg.max_seq_len
        self.quantized_cache = quantized_cache
        self.top_k = top_k
        if scheduler == "auto":
            from qgemm_tpu_torch.serving import native
            scheduler = "native" if native.available() else "python"
        self.scheduler = scheduler
        self.multi_step = int(multi_step)
        self.chunked_prefill = chunked_prefill
        self.book = (_NativeBookkeeper if scheduler == "native"
                     else _PyBookkeeper)(max_slots, self.max_seq_len)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)

        self.paged = paged
        self.overcommit = overcommit
        self.overlap_admission = overlap_admission
        self.prefix_cache = prefix_cache and paged
        if self.prefix_cache and mesh is not None:
            # JAX's rule: its suffix prefill runs under shard_map on
            # head-sharded pools, which needs both head counts to divide
            # the model axis; otherwise prefix caching is off from the start
            cfg, p = model.cfg, axis_size(mesh, "model")
            heads = (cfg.n_heads, cfg.n_kv_heads or cfg.n_heads)
            if any(h % p for h in heads):
                warnings.warn(f"prefix_cache disabled: head counts {heads} must divide the "
                              f"model axis ({p}) for the tensor-parallel suffix prefill",
                              stacklevel=2)
                self.prefix_cache = False
        self.preemptions = 0
        # preempted requests: id -> {"req": the original Request, "gen" and
        # "lps": what it produced before its (latest) preemption}
        self._preempted: Dict[int, dict] = {}
        self._admit_seq: Dict[int, int] = {}   # slot -> admission counter
        self._admit_counter = 0
        self._slot_worst = np.zeros((max_slots,), np.int64)
        self.prefill_tokens_skipped = 0
        self._paged_chunk: Optional[int] = None
        if paged:
            ps = page_size or PAGE_SIZE
            check_kv_bits(kv_bits, ps)
            cfg = model.cfg
            pps = -(-self.max_seq_len // ps)
            self.max_seq_len = pps * ps
            # speculation: the verify chunk writes up to spec_extra rows past
            # a slot's last position; the widened table keeps them in the
            # slot's own pages
            pps += -(-self.spec_extra // ps)
            # the pools' geometry, kept to rebuild them after a decode fault
            self._pool_shape = dict(n_heads=model.kv_heads,
                                    head_dim=cfg.d_model // cfg.n_heads,
                                    n_pages=n_pages or (1 + max_slots * pps),
                                    page_size=ps, kv_bits=kv_bits)
            # +1 PARKING column, never allocated (always the null page): an
            # admitting slot parked there during overlapped admission writes
            # its junk decode rows to page 0, not into its prompt pages
            self._pt_host = np.zeros((max_slots, pps + 1), np.int32)
            self._pt_dev = torch.zeros((max_slots, pps + 1), dtype=torch.int32,
                                       device=self.device)
            self.caches = self._new_pools(len(model.blocks))
            self.alloc = PageAllocator(self._pool_shape["n_pages"], max_slots, pps)
            self._page_size = ps
            self._park_pos = pps * ps
            if chunked_prefill:
                self._paged_chunk = -(-chunked_prefill // ps) * ps
        else:
            self.caches = model.init_cache(max_slots, self.max_seq_len + self.spec_extra,
                                           quantized=quantized_cache)
        # the draft's cache: dense, in its own dtype, in both modes
        self.draft_caches = self._new_draft_caches()
        self._init_loop()

    def _new_draft_caches(self) -> Optional[list]:
        if self.draft is None:
            return None
        return self.draft.init_cache(self.max_slots, self.max_seq_len + self.spec_extra)

    # --------------------------------------------------------------- device
    @torch.no_grad()
    def _prefill_impl(self, prompt: torch.Tensor, plen_true: int, slot: int,
                      temp: float, topp: float, topk: int):
        """Prefill one slot in place: the bucket-padded prompt [1, bucket]
        runs against the slot's own view of the shared cache (positions
        from 0). Junk K/V past the true length is never attended: decode
        masks by per-slot position."""
        views = [_slot_view(c, slot) for c in self.caches]
        logits, _ = self.model.prefill(prompt, views)
        return self._sample_first(logits[0, plen_true - 1][None], temp, topp, topk)

    @torch.no_grad()
    def _admit_chunked(self, req: Request, slot: int, plen: int, prompt: torch.Tensor,
                       eff_topk: int):
        """Admit a long prompt into the dense cache in chunks of
        ``chunked_prefill`` tokens (the last padded), each through
        ``prefill_chunk`` at its offset against the slot's views of the
        shared cache, so every chunk writes its rows in place and attends
        the rows before it. The first token comes from the last chunk's
        logits. Where the padded chunks would overrun the cache extent, the
        bucket-padded ``prompt`` is prefilled whole."""
        chunk = self.chunked_prefill
        n_chunks = -(-plen // chunk)
        if n_chunks * chunk > self.caches[0][0].shape[2]:
            return self._prefill_impl(prompt, plen, slot, req.temperature, req.top_p,
                                      eff_topk)
        toks = torch.as_tensor(np.pad(np.asarray(req.prompt, np.int64),
                                      (0, n_chunks * chunk - plen))[None, :],
                               device=self.device)
        views = [_slot_view(c, slot) for c in self.caches]
        for c in range(n_chunks):
            logits, _ = self.model.prefill_chunk(toks[:, c * chunk:(c + 1) * chunk],
                                                 c * chunk, views)
        idx = (plen - 1) - (n_chunks - 1) * chunk
        return self._sample_first(logits[0, idx][None], req.temperature, req.top_p, eff_topk)

    @torch.no_grad()
    def _prefill_paged_impl(self, prompt: torch.Tensor, plen_true: int, slot: int,
                            temp: float, topp: float, topk: int):
        """Paged prefill: the bucket-padded prompt runs through the model with
        a throwaway dense float cache (batch 1, so the full-prompt prefill
        path), then its K/V go into the slot's pages. Logical pages past the
        allocation point at the null page, which is never read."""
        tmp = self.model.init_cache(1, prompt.shape[1])
        logits, tmp = self.model.prefill(prompt, tmp)
        for pc, (k, v) in zip(self.caches, tmp):
            paged_write_prompt(pc, slot, k[0], v[0])
        return self._sample_first(logits[0, plen_true - 1][None], temp, topp, topk)

    @torch.no_grad()
    def _prefill_paged_suffix_impl(self, suffix: torch.Tensor, slot: int,
                                   skip_pages: int) -> torch.Tensor:
        """One page-aligned chunk of a prompt from logical page
        ``skip_pages`` on: each layer writes the chunk's K/V into the slot's
        pages and attends everything up to its own positions (kernel K6),
        the prefix-cache pages before it included. The per-slot views share
        the engine's pools, so the writes land in its cache. Returns the
        chunk's logits [1, C, V]."""
        views = [dataclasses.replace(c, page_table=c.page_table[slot:slot + 1],
                                     step_slot=None, step_page=None)
                 for c in self.caches]
        logits, _ = self.model.prefill_chunk(suffix, skip_pages * self._page_size, views)
        return logits

    @torch.no_grad()
    def _draft_prefill_impl(self, prompt: torch.Tensor, slot: int) -> None:
        """The draft's K/V of the bucket-padded prompt [1, bucket], written
        in place into its slot's rows (it only proposes: nothing is
        sampled)."""
        self.draft.prefill(prompt, [_slot_view(c, slot) for c in self.draft_caches])

    # the model calls of the step bodies (``_EngineLoop``): the decode step,
    # a draft step and the verify chunk, each writing its K/V in place
    def _step_logits(self) -> torch.Tensor:
        return self.model.decode_step(self.cur_tokens, self.positions, self.caches)[0]

    def _draft_logits(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        return self.draft.decode_step(tok, pos, self.draft_caches)[0]

    def _verify_logits(self, seq: torch.Tensor) -> torch.Tensor:
        return self.model.prefill_chunk(seq, self.positions, self.caches)[0]

    # ---------------------------------------------------------------- admin
    def submit(self, req: Request):
        self.book.submit(req)

    def _reserve_pages(self, slot: int, req: Request, plen: int):
        """The paged half of an admission's checks, as the JAX engine makes
        them. Returns (hashes, skip_pages) once the slot holds its pages, or
        "wait" after requeueing the request at the front (backpressure: stop
        admitting), or "never" after finishing it with an error (it could
        not fit even in an empty pool)."""
        ps = self._page_size
        # speculation: a round's candidate rows run up to spec_extra past
        # the last position
        worst = min(plen + req.max_new_tokens, self.max_seq_len) + self.spec_extra
        need = self.alloc.pages_needed(worst, ps)
        if self.overcommit:
            # pages needed now (prompt + the first decode position, and a
            # round's rows); one page of headroom per active slot damps
            # admit/preempt thrash
            now_tokens = min(plen + 1 + self.spec_extra, worst)
            need_res = self.alloc.pages_needed(now_tokens, ps)
            headroom = self.book.num_active
        else:
            now_tokens, need_res, headroom = worst, need, 0
        # the hash chain over the prompt's full pages; peek only: the checks
        # below may still reject or requeue this admission
        hashes = []
        if self.prefix_cache:
            h = b""
            for j in range(plen // ps):
                chunk = np.asarray(req.prompt[j * ps:(j + 1) * ps], np.int64).tobytes()
                h = hashlib.sha1(h + chunk).digest()
                hashes.append(h)
        n_match = self.alloc.peek_prefix(hashes)
        # the last prompt token is always recomputed (its logits give the
        # first token), and a shared page is never rewritten: acquire only
        # the pages the admission will not recompute
        skip_pages = min(n_match, (plen - 1) // ps)
        pool_cap = self.caches[0].n_pages - 1                   # page 0 reserved
        if need > self.alloc.pages_per_slot or need_res > pool_cap:
            req.error = (f"request needs {need} pages > "
                         f"{min(self.alloc.pages_per_slot, pool_cap)} available per request")
            req.done = True
            self._unadmit(req)
            self.finished.append(self._finalize(req))
            return "never"
        # matched pages idle in the LRU count in n_free but acquiring them
        # consumes them
        resurrect = self.alloc.peek_prefix_cached(hashes, skip_pages)
        if need_res - skip_pages > self.alloc.n_free - resurrect - headroom:
            self._unadmit(req)
            req.done = False
            self.book.submit(req, front=True)
            return "wait"
        try:
            for j in range(skip_pages):
                self._pt_host[slot, j] = self.alloc.acquire_shared(slot, hashes[j])
            grew = self._grow_slot(slot, now_tokens)
        except RuntimeError:
            # accounting drift must never kill the batch: give back what
            # this admission took and requeue it
            self._release_slot_pages(slot)
            self._unadmit(req)
            req.done = False
            self.book.submit(req, front=True)
            return "wait"
        if grew or skip_pages:
            self._sync_page_tables()
        self._slot_worst[slot] = worst
        self._admit_counter += 1
        self._admit_seq[slot] = self._admit_counter
        return hashes, skip_pages

    def _prefill_paged(self, req: Request, slot: int, plen: int, skip_pages: int,
                       prompt: torch.Tensor, eff_topk: int):
        """Run a paged admission's prefill by the JAX engine's rules: chunk by
        chunk when the prompt (after the skipped prefix) is longer than one
        chunk and its padded chunks fit the slot's table; the suffix alone
        after a prefix-cache hit; else the whole bucket-padded prompt."""
        ps = self._page_size
        start = skip_pages * ps
        rem = plen - start
        chunk_fits = False
        if self._paged_chunk:
            n_ch = -(-rem // self._paged_chunk)
            chunk_fits = start + n_ch * self._paged_chunk <= self.alloc.pages_per_slot * ps
        if self._paged_chunk and chunk_fits and rem > self._paged_chunk:
            first = self._admit_paged_chunked(req, slot, plen, skip_pages, eff_topk)
        elif skip_pages > 0:
            sbucket = -(-rem // ps) * ps
            suffix = torch.as_tensor(np.pad(np.asarray(req.prompt[start:], np.int64),
                                            (0, sbucket - rem))[None, :], device=self.device)
            logits = self._prefill_paged_suffix_impl(suffix, slot, skip_pages)
            first = self._sample_first(logits[0, rem - 1][None], req.temperature,
                                       req.top_p, eff_topk)
        else:
            return self._prefill_paged_impl(prompt, plen, slot, req.temperature,
                                            req.top_p, eff_topk)
        self.prefill_tokens_skipped += start
        return first

    def _admit(self):
        while True:
            adm = self.book.next_admission()
            if adm is None:
                return
            slot, req = adm
            plen = len(req.prompt)
            # pow-2 prompt bucket (>= 8, or a whole number of pages), clamped
            # to the cache extent
            bucket = max(self._page_size if self.paged else 8, 1 << (plen - 1).bit_length())
            if self.paged:
                bucket = -(-bucket // self._page_size) * self._page_size
            bucket = min(bucket, self.max_seq_len)
            prompt = torch.as_tensor(
                np.pad(np.asarray(req.prompt, np.int64), (0, bucket - plen))[None, :],
                device=self.device)
            eff_topk = self.top_k if req.top_k is None else req.top_k
            hashes = []
            if self.paged:
                reserved = self._reserve_pages(slot, req, plen)
                if reserved == "wait":
                    return
                if reserved == "never":
                    continue
                hashes, skip_pages = reserved
            t_adm = time.perf_counter()
            try:
                if self.paged:
                    first_tok, first_lp = self._prefill_paged(req, slot, plen, skip_pages,
                                                              prompt, eff_topk)
                elif self.chunked_prefill and plen > self.chunked_prefill:
                    first_tok, first_lp = self._admit_chunked(req, slot, plen, prompt,
                                                              eff_topk)
                else:
                    first_tok, first_lp = self._prefill_impl(
                        prompt, plen, slot, req.temperature, req.top_p, eff_topk)
                if self.draft is not None:
                    # the draft proposes with the whole prompt in its cache
                    self._draft_prefill_impl(prompt, slot)
            except GraphCaptureError:
                raise
            except Exception as e:  # noqa: BLE001 — per-request isolation:
                # a failing prefill, or a decode fault between its chunks
                # (after the engine recovered from it), must not kill the batch;
                # under a mesh it does (``_recover_from_decode_fault``)
                if self.mesh is not None:
                    raise
                req.done = True
                self._cancel_slot(slot, f"{type(e).__name__}: {e}")
                for r in self.book.drain_finished():
                    if r.id != req.id:
                        self.finished.append(self._finalize(r))
                self.finished.append(self._finalize(req))
                continue
            for j, h in enumerate(hashes):
                # publish the prompt's full pages for later admissions (a
                # no-op for pages that were themselves acquired shared)
                self.alloc.publish(slot, j, h)
            # in place: a captured decode graph reads these tensors
            self.positions[slot] = plen
            self.cur_tokens[slot, 0] = first_tok
            self.temps[slot] = req.temperature
            self._temps_dev[slot] = req.temperature
            self._topps_dev[slot] = req.top_p
            self._topks_dev[slot] = eff_topk
            self.tokens_generated += 1
            if req.logprobs:
                req.token_logprobs.append(first_lp)
                self._lp_slots[slot] = req
            self.book.admitted(slot, first_tok)
            if not self.book.active_mask()[slot]:
                # finished at admission (stop token, or max_new_tokens == 1):
                # drop the logprobs subscription and free the pages now
                self._lp_slots.pop(slot, None)
                if self.paged:
                    self._release_slot_pages(slot)
                self.finished.extend(self._drain_finished())
            self._admit_times.append(time.perf_counter() - t_adm)

    def _admit_paged_chunked(self, req: Request, slot: int, plen: int, skip_pages: int,
                             eff_topk: int):
        """Admit a long prompt into the paged cache chunk by chunk (whole
        pages, the tail padded to the chunk size), each chunk through
        ``_prefill_paged_suffix_impl``, starting after the ``skip_pages``
        shared pages. Only the last chunk's logits are sampled. With
        ``overlap_admission`` the slot is parked (its device position on the
        parking column, suspended in the bookkeeper) and the resident slots
        take one decode step between chunks."""
        ps = self._page_size
        chunk = self._paged_chunk
        start = skip_pages * ps
        total = plen - start
        n_chunks = -(-total // chunk)
        padded = np.pad(np.asarray(req.prompt[start:], np.int64),
                        (0, n_chunks * chunk - total))
        overlap = self.overlap_admission and n_chunks > 1
        if overlap:
            self.positions[slot] = self._park_pos
            self.book.suspend_slot(slot)
        try:
            return self._run_admission_chunks(req, slot, skip_pages, eff_topk, padded,
                                              n_chunks, total, chunk, ps, overlap)
        finally:
            if overlap:
                self.book.resume_slot(slot)

    def _run_admission_chunks(self, req, slot, skip_pages, eff_topk, padded, n_chunks,
                              total, chunk, ps, overlap):
        for c in range(n_chunks):
            toks = torch.as_tensor(padded[None, c * chunk:(c + 1) * chunk],
                                   device=self.device)
            logits = self._prefill_paged_suffix_impl(toks, slot, skip_pages + (c * chunk) // ps)
            if c == n_chunks - 1:
                return self._sample_first(logits[0, total - 1 - c * chunk][None],
                                          req.temperature, req.top_p, eff_topk)
            if overlap:
                self._decode_tick()

    def _decode_tick(self):
        """One decode step over the active slots between admission chunks
        (``overlap_admission``); the admitting slot is parked and
        suspended, so it neither writes its pages nor advances. A decode
        fault here recovers at engine level and raises, so the admission in
        flight errors too (``_admit``'s per-request isolation)."""
        active = self.book.active_mask()
        if not active.any():
            return
        self._grow_active_slots(active)
        if self.overcommit:
            active = active & self.book.active_mask()
            if not active.any():
                return
        try:
            toks, lps = self._decode(active, 1)
        except GraphCaptureError:
            raise
        except Exception as e:  # noqa: BLE001 — engine-level recovery
            self._recover_from_decode_fault(e)
            raise RuntimeError(f"decode fault during overlapped admission: {e}") from e
        self._record_block(active, toks, lps)

    # ------------------------------------------------------------ over-commit
    def _preempt_for_pages(self, needy_slot: int) -> bool:
        """Over-commit pool pressure: preempt the YOUNGEST-admitted active
        slot (other than ``needy_slot`` if there is one), free its pages and
        requeue its continuation (prompt + tokens so far, max_new reduced)
        at the front. Returns False when nothing is active to preempt."""
        act = [int(s) for s in np.flatnonzero(self.book.active_mask())]
        cands = [s for s in act if s != needy_slot] or \
            ([needy_slot] if needy_slot in act else [])
        if not cands:
            return False
        victim = max(cands, key=lambda s: self._admit_seq.get(s, -1))
        req = self.book.request_in_slot(victim)
        if req is None:
            return False
        res = self.book.preempt(req.id)
        if res is None:
            return False
        _, gen = res
        prev = self._preempted.get(req.id)
        orig = prev["req"] if prev else req
        pre_gen = (prev["gen"] if prev else []) + [int(t) for t in gen]
        pre_lps = list(prev["lps"] if prev else []) + list(req.token_logprobs)
        cont = Request(prompt=list(req.prompt) + [int(t) for t in gen],
                       max_new_tokens=req.max_new_tokens - len(gen),
                       eos_token=req.eos_token, temperature=req.temperature,
                       top_p=req.top_p, top_k=req.top_k, stop_tokens=req.stop_tokens,
                       logprobs=req.logprobs)
        cont.id = req.id
        self._preempted[req.id] = {"req": orig, "gen": pre_gen, "lps": pre_lps}
        self._lp_slots.pop(victim, None)
        self._release_slot_pages(victim)
        self.book.submit(cont, front=True)
        self.preemptions += 1
        return True

    def _rebuild_caches(self) -> None:
        """Fresh caches after a decode fault (paged: the pools from the
        engine's own geometry, the prefix cache emptied, since its pages
        went with them; the draft's caches too)."""
        if self.paged:
            self.alloc.reset_prefix_cache()
            self.caches = self._new_pools(len(self.model.blocks))
            self._sync_page_tables()
        else:
            self.caches = self.model.init_cache(self.max_slots,
                                                self.max_seq_len + self.spec_extra,
                                                quantized=self.quantized_cache)
        self.draft_caches = self._new_draft_caches()
