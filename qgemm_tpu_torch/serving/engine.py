"""Continuous batching inference engine, dense-cache mode (port of
``qgemm_tpu/serving/engine.py``).

A fixed pool of ``max_slots`` batch slots, each with its own position in a
shared [slots, H, S, D] KV cache. Every ``step()`` admits waiting requests
into free slots (one prefill each, the prompt padded to a power-of-two
bucket) and then runs ONE decode step over all slots; inactive slots decode
junk that the host discards. Finished sequences free their slot at once.

Ported here: ``Request``, the Python bookkeeper, greedy/sampled decoding
with per-request temperature/top-k/top-p, stop tokens, logprobs, ``cancel``,
``stats``, per-request prefill error isolation, and the int8 cache
(``quantized_cache=True``). The paged cache, speculation, chunked prefill,
multi-step decode, tensor parallelism, over-commit, overlapped admission,
int4 KV and the native scheduler raise ``NotImplementedError``; so does
nothing else. A decode-step fault propagates to the caller (the JAX
engine's engine-level recovery is not ported yet).

The engine calls only the model's ``init_cache``, ``prefill`` and
``decode_step``, so int8, W4A8 (``bits=4``) and outlier-split models serve
alike. With the outlier split a layer selects its outlier dims over every
row it is given — the prompt's bucket padding at prefill, every slot
(inactive ones too) at decode — so a request's tokens can depend on what
shares its step, as in the JAX engine.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from qgemm_tpu_torch.device import DeviceLike, resolve_device
from qgemm_tpu_torch.ops.kv_cache import QuantizedKVCache
from qgemm_tpu_torch.ops.sampling import sample_logits, token_logprob


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
    transcripts, finish rules."""

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


def _slot_view(cache, slot: int):
    """One layer's cache restricted to ``slot``: views, so writes land in
    the shared cache."""
    sliced = [t[slot:slot + 1] for t in cache]
    return QuantizedKVCache(*sliced) if isinstance(cache, QuantizedKVCache) \
        else tuple(sliced)


class ContinuousBatchingEngine:
    def __init__(self, model, max_slots: int = 8, max_seq_len: Optional[int] = None,
                 scheduler: str = "auto", quantized_cache: bool = False,
                 top_k: int = 0, seed: int = 0, mesh=None, paged: bool = False,
                 chunked_prefill: Optional[int] = None, multi_step: int = 0,
                 draft_model=None, overcommit: bool = False,
                 overlap_admission: bool = False, kv_bits: int = 8,
                 device: DeviceLike = None):
        """Options as in the JAX engine; those of modes not ported yet raise
        ``NotImplementedError``. ``scheduler`` "auto" and "python" run the
        Python bookkeeper. ``device`` is where the engine runs (default: the
        GPU — raises without one); the model must be there. The paged and
        speculative modes' own knobs (``n_pages``, ``page_size``,
        ``prefix_cache``, ``spec_gamma``) come with those modes."""
        for name, value, used in (
                ("paged", paged, paged),
                ("draft_model", draft_model, draft_model is not None),
                ("chunked_prefill", chunked_prefill, bool(chunked_prefill)),
                ("multi_step", multi_step, multi_step > 1),
                ("mesh", mesh, mesh is not None),
                ("overcommit", overcommit, overcommit),
                ("overlap_admission", overlap_admission, overlap_admission),
                ("kv_bits", kv_bits, kv_bits != 8),
                ("scheduler", scheduler, scheduler == "native")):
            if used:
                raise NotImplementedError(
                    f"ContinuousBatchingEngine({name}={value!r}) is not ported "
                    "to qgemm_tpu_torch yet")
        if scheduler not in ("auto", "python"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on {self.device}")
        self.model = model
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len or model.cfg.max_seq_len
        self.quantized_cache = quantized_cache
        self.top_k = top_k
        self.scheduler = "python"
        self.book = _PyBookkeeper(max_slots, self.max_seq_len)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.caches = model.init_cache(max_slots, self.max_seq_len,
                                       quantized=quantized_cache)
        self.positions = torch.zeros((max_slots,), dtype=torch.int64, device=self.device)
        self.cur_tokens = torch.zeros((max_slots, 1), dtype=torch.int64,
                                      device=self.device)
        # per-slot sampling knobs live on the host: an all-greedy batch then
        # skips the sort/draw without a device round trip
        self.temps = np.zeros((max_slots,), np.float32)
        self.topps = np.ones((max_slots,), np.float32)
        self.topks = np.zeros((max_slots,), np.int64)
        self.finished: List[Request] = []
        self.tokens_generated = 0
        self._lp_slots: Dict[int, Request] = {}
        self._admit_times: List[float] = []
        self._itl: List[float] = []
        self._last_tick_t: Optional[float] = None
        self._t_start: Optional[float] = None

    # --------------------------------------------------------------- device
    def _sample(self, logits: torch.Tensor, temps, topps, topks) -> torch.Tensor:
        if np.all(temps <= 1e-6):
            return logits.to(torch.float32).argmax(dim=-1)
        dev = logits.device
        return sample_logits(logits, self._gen, torch.as_tensor(temps, device=dev),
                             torch.as_tensor(topks, device=dev),
                             torch.as_tensor(topps, device=dev))

    @torch.no_grad()
    def _prefill_impl(self, prompt: torch.Tensor, plen_true: int, slot: int,
                      temp: float, topp: float, topk: int):
        """Prefill one slot in place: the bucket-padded prompt [1, bucket]
        runs against the slot's own view of the shared cache (positions
        from 0). Junk K/V past the true length is never attended: decode
        masks by per-slot position."""
        views = [_slot_view(c, slot) for c in self.caches]
        logits, _ = self.model.prefill(prompt, views)
        last = logits[0, plen_true - 1][None]
        tok = self._sample(last, np.asarray([temp], np.float32),
                           np.asarray([topp], np.float32), np.asarray([topk], np.int64))
        return int(tok[0]), float(token_logprob(last, tok)[0])

    @torch.no_grad()
    def _decode_impl(self):
        logits, _ = self.model.decode_step(self.cur_tokens, self.positions, self.caches)
        nxt = self._sample(logits, self.temps, self.topps, self.topks)
        return nxt, token_logprob(logits, nxt)

    # ---------------------------------------------------------------- admin
    def submit(self, req: Request):
        self.book.submit(req)

    def _admit(self):
        while True:
            adm = self.book.next_admission()
            if adm is None:
                return
            slot, req = adm
            plen = len(req.prompt)
            # pow-2 prompt bucket (>= 8), clamped to the cache extent
            bucket = min(max(8, 1 << (plen - 1).bit_length()), self.max_seq_len)
            prompt = torch.as_tensor(
                np.pad(np.asarray(req.prompt, np.int64), (0, bucket - plen))[None, :],
                device=self.device)
            eff_topk = self.top_k if req.top_k is None else req.top_k
            t_adm = time.perf_counter()
            try:
                first_tok, first_lp = self._prefill_impl(
                    prompt, plen, slot, req.temperature, req.top_p, eff_topk)
            except Exception as e:  # noqa: BLE001 — per-request isolation:
                # a failing prefill must not kill the batch
                req.error = f"{type(e).__name__}: {e}"
                req.done = True
                self.book.cancel(req.id)        # frees the slot
                for r in self.book.drain_finished():
                    if r.id != req.id:
                        self.finished.append(r)
                self.finished.append(req)
                continue
            self.positions[slot] = plen
            self.cur_tokens[slot, 0] = first_tok
            self.temps[slot] = req.temperature
            self.topps[slot] = req.top_p
            self.topks[slot] = eff_topk
            self.tokens_generated += 1
            if req.logprobs:
                req.token_logprobs.append(first_lp)
                self._lp_slots[slot] = req
            self.book.admitted(slot, first_tok)
            if not self.book.active_mask()[slot]:
                # finished at admission (stop token, or max_new_tokens == 1)
                self._lp_slots.pop(slot, None)
                self.finished.extend(self.book.drain_finished())
            self._admit_times.append(time.perf_counter() - t_adm)

    def cancel(self, req_id: int) -> bool:
        """Cancel a request by id: a waiting request is dropped; an active
        one frees its slot at once (its partial transcript is kept).
        Returns False when the id is unknown or already finished."""
        res = self.book.cancel(req_id)
        if res is None:
            return False
        kind, info = res
        if kind == "waiting":
            info.done = True
            info.cancelled = True
            self.finished.append(info)
        else:
            self._lp_slots.pop(info, None)
            for r in self.book.drain_finished():
                r.done = True
                if r.id == req_id:
                    r.cancelled = True
                self.finished.append(r)
        return True

    # ----------------------------------------------------------------- run
    @property
    def steps(self) -> int:
        return self.book.steps

    @property
    def stats(self) -> Dict[str, float]:
        """Throughput counters, admission latency and inter-token latency."""
        wall = (time.perf_counter() - self._t_start) if self._t_start else 0.0
        st = {"tokens_generated": self.tokens_generated, "steps": int(self.steps),
              "wall_s": round(wall, 3),
              "tokens_per_s": round(self.tokens_generated / wall, 2) if wall else 0.0}
        if self._admit_times:
            at = np.asarray(self._admit_times)
            st["admit_p50_ms"] = round(float(np.percentile(at, 50)) * 1e3, 2)
            st["admit_p95_ms"] = round(float(np.percentile(at, 95)) * 1e3, 2)
            st["admissions"] = len(at)
        if self._itl:
            it = np.asarray(self._itl)
            st["itl_p50_ms"] = round(float(np.percentile(it, 50)) * 1e3, 2)
            st["itl_p95_ms"] = round(float(np.percentile(it, 95)) * 1e3, 2)
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

    def step(self) -> bool:
        """Admit waiting requests, then run one decode step for all slots."""
        if self._t_start is None:
            self._t_start = time.perf_counter()
        self._admit()
        active = self.book.active_mask()
        if not active.any():
            return False
        nxt, lps = self._decode_impl()
        act = torch.as_tensor(active, device=self.device)
        self.positions += act.to(torch.int64)
        self.cur_tokens = nxt[:, None]
        nxt_host = nxt.cpu().numpy()
        if self._lp_slots:
            lps_host = lps.cpu().numpy()
            for slot, r in self._lp_slots.items():
                if active[slot]:
                    r.token_logprobs.append(float(lps_host[slot]))
        self.book.record_step(nxt_host)
        self.tokens_generated += int(active.sum())
        for slot in np.flatnonzero(active & ~self.book.active_mask()):
            self._lp_slots.pop(int(slot), None)
        self.finished.extend(self.book.drain_finished())
        self._record_itl()
        return True

    def run_to_completion(self, max_steps: int = 100000) -> List[Request]:
        while ((self.book.num_waiting or self.book.num_active)
               and self.steps < max_steps):
            self.step()
        self.finished.extend(self.book.drain_finished())
        return self.finished
