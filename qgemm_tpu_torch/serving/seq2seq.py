"""Continuous batching for the encoder-decoder family (port of
``qgemm_tpu/serving/seq2seq.py``; under a ``mesh`` every rank runs it on
its model's shards, as the GPT engine does).

The GPT engine's loop (``serving/engine.py``: a fixed pool of slots, one
decode step over all of them, per-slot positions, ``multi_step`` blocks,
speculative rounds, a CUDA graph of the step on CUDA), adapted to
seq2seq:

  * a Request's ``prompt`` is the SOURCE; generation starts from BOS, so
    decoder positions start at 1 after admission (BOS at 0);
  * admission encodes the source once and writes each decoder layer's
    cross-attention K/V into the slot's rows of a shared [slots, Hkv,
    max_src_len, Dh] tensor (int8 codes and scales with
    ``quantized_cache``), then runs the BOS step against a one-position
    cache and copies its K/V into the slot's self-cache (dense rows, or
    the slot's first page). The source is encoded unpadded with no mask
    (batch 1: kernel K3 on CUDA); the JAX engine pads it to a power-of-two
    bucket and masks the padding, which gives the real rows the same
    function. The rows past the source keep what they held: every decode
    step masks the cross-attention by each slot's true source length,
    built on the device from ``src_lens``;
  * the decoder's self-cache is dense (float, or int8 with
    ``quantized_cache``: kernel K2) or paged (``paged=True``: int8 or int4
    pools, kernel K5; the verify chunk of a speculative round through
    kernel K6); the cross-attention K/V stay dense per slot, written once
    and never grown. The cross read is the plain composition in every
    mode (f32 products on the CPU, bf16 on CUDA for the int8 K/V).

On CUDA every decode dispatch replays a captured graph of the step or the
round (``serving/decode_graph.py``): the step's inputs (``positions``,
``cur_tokens``, ``src_lens``, the sampling knobs, the self-caches, the
cross K/V, the draft's, the page table and the output ring) are device
tensors that admission writes in place and never rebinds.

A fault in a decode dispatch fails every in-flight request and rebuilds
the caches from the engine's own geometry (the JAX engine rebuilds an int4
pool with the head width doubled and the default page size and bits).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from qgemm_tpu_torch.device import DeviceLike, resolve_device
from qgemm_tpu_torch.ops.kv_cache import quantize_kv
from qgemm_tpu_torch.serving.decode_graph import GraphCaptureError
from qgemm_tpu_torch.serving.engine import Request, _EngineLoop, _PyBookkeeper, check_mesh
from qgemm_tpu_torch.serving.paged_cache import (PAGE_SIZE, PageAllocator, check_kv_bits,
                                                 paged_write_step)


class _Seq2SeqBookkeeper(_PyBookkeeper):
    """Decoder-side bookkeeping: positions count DECODER tokens (BOS at 0,
    an admission starts at 1); the engine checks the source length."""

    def submit(self, req: Request, front: bool = False):
        if req.max_new_tokens + 1 > self.max_seq_len:
            raise ValueError(f"request {req.id}: max_new_tokens {req.max_new_tokens} "
                             f"exceeds decoder budget {self.max_seq_len - 1}")
        if front:
            self.waiting.insert(0, req)
        else:
            self.waiting.append(req)

    def next_admission(self):
        adm = super().next_admission()
        if adm is not None:
            self.pos[adm[0]] = 1                 # BOS occupies position 0
        return adm


class Seq2SeqEngine(_EngineLoop):
    """Continuous batching for ``models.transformer.Transformer``; the API
    of ``ContinuousBatchingEngine`` (submit, step, run_to_completion,
    cancel, stats)."""

    def __init__(self, model, max_slots: int = 8, max_src_len: Optional[int] = None,
                 max_new_tokens: Optional[int] = None, quantized_cache: bool = False,
                 top_k: int = 0, seed: int = 0, bos_token: int = 1, mesh=None,
                 paged: bool = False, n_pages: Optional[int] = None, multi_step: int = 0,
                 draft_model=None, spec_gamma: int = 4, page_size: Optional[int] = None,
                 kv_bits: int = 8, device: DeviceLike = None):
        """Options as in the JAX engine. ``max_new_tokens`` sets the decoder
        budget (default: the positional table less one). ``quantized_cache``
        makes the dense self-cache and the cross K/V int8. ``paged=True``
        pages the decoder self-cache (``n_pages``, default every slot's full
        table; ``page_size`` default 128, on the GPU a multiple of 8 from
        8 to 256; ``kv_bits`` 8 or 4, int4 needing an even page): pages
        round the decoder budget up but the requests' limit stays the
        budget. ``multi_step=K`` runs K decode steps a dispatch when nothing
        waits. ``draft_model`` (a Transformer) turns on speculation,
        ``spec_gamma`` proposals a round: the draft encodes every source
        into its own float cross K/V and keeps a dense float self-cache;
        every extent and reservation grows by ``spec_gamma + 2``.
        ``device`` is where the engine runs (default: the GPU, raising
        without one); the models must be there. ``mesh``: tensor-parallel
        serving, as the GPT engine's — ``model`` and ``draft_model`` are
        this rank's models; the self-caches and the cross K/V are
        head-local, the source lengths and page tables whole."""
        self.mesh = check_mesh(mesh, model, draft_model)
        if not paged:
            for name, value, used in (("n_pages", n_pages, n_pages is not None),
                                      ("page_size", page_size, page_size is not None),
                                      ("kv_bits", kv_bits, kv_bits != 8)):
                if used:
                    raise ValueError(f"Seq2SeqEngine({name}={value!r}) needs paged=True")
        if draft_model is None and spec_gamma != 4:
            raise ValueError(f"Seq2SeqEngine(spec_gamma={spec_gamma!r}) needs draft_model")
        self.device = resolve_device(device)
        for name, m in (("model", model), ("draft_model", draft_model)):
            if m is not None and m.device != self.device:
                raise ValueError(f"{name} is on {m.device}, engine on {self.device}")
        cfg = model.cfg
        self.model = model
        self.draft = draft_model
        self.max_slots = max_slots
        self.max_src_len = max_src_len or cfg.max_seq_len
        self.max_dec_len = (max_new_tokens or cfg.max_seq_len - 1) + 1
        self.spec_gamma = int(spec_gamma)
        if draft_model is not None and self.spec_gamma < 1:
            raise ValueError(f"spec_gamma must be >= 1, got {spec_gamma}")
        # a round's verify chunk writes up to gamma + 1 rows past a slot's
        # position: every extent and reservation covers them
        self.spec_extra = self.spec_gamma + 2 if draft_model is not None else 0
        self.quantized_cache = quantized_cache
        self.top_k = top_k
        self.bos_token = bos_token
        self.multi_step = int(multi_step)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # the bookkeeper holds requests to the decoder budget, which paging
        # must not widen: positions past it run off the positional table
        self.book = _Seq2SeqBookkeeper(max_slots, self.max_dec_len)

        self.paged = paged
        self.overcommit = False
        self.prefix_cache = False
        self.preemptions = 0
        self.prefill_tokens_skipped = 0
        self._preempted: Dict[int, dict] = {}
        dh = cfg.d_model // cfg.n_heads
        hkv = model.kv_heads
        dev = self.device
        if paged:
            ps = page_size or PAGE_SIZE
            check_kv_bits(kv_bits, ps)
            pps = -(-self.max_dec_len // ps)
            self.max_dec_len = pps * ps
            pps += -(-self.spec_extra // ps)
            # the pools' geometry, kept to rebuild them after a decode fault
            self._pool_shape = dict(n_heads=hkv, head_dim=dh,
                                    n_pages=n_pages or (1 + max_slots * pps),
                                    page_size=ps, kv_bits=kv_bits)
            self._pt_host = np.zeros((max_slots, pps), np.int32)
            self._pt_dev = torch.zeros((max_slots, pps), dtype=torch.int32, device=dev)
            self._page_size = ps
            self.alloc = PageAllocator(self._pool_shape["n_pages"], max_slots, pps)
        self.caches = (self._new_pools(len(model.dec_blocks)) if paged else
                       model.init_cache(max_slots, self.max_dec_len + self.spec_extra,
                                        quantized=quantized_cache))
        self.draft_caches = self._new_draft_caches()
        # the cross-attention K/V of every slot, written by admission
        s_src = self.max_src_len
        hkv = model.cross_kv_heads
        if quantized_cache:
            z8 = lambda: torch.zeros((max_slots, hkv, s_src, dh), dtype=torch.int8, device=dev)
            one = lambda: torch.ones((max_slots, hkv, s_src, 1), dtype=torch.float32,
                                     device=dev)
            self.enc_kvs = [(z8(), one(), z8(), one()) for _ in model.dec_blocks]
        else:
            z = lambda: torch.zeros((max_slots, hkv, s_src, dh), dtype=cfg.tdtype, device=dev)
            self.enc_kvs = [(z(), z()) for _ in model.dec_blocks]
        self.draft_enc_kvs = None
        if draft_model is not None:
            dcfg = draft_model.cfg
            zd = lambda: torch.zeros((max_slots, draft_model.cross_kv_heads, s_src,
                                      dcfg.d_model // dcfg.n_heads), dtype=dcfg.tdtype,
                                     device=dev)
            self.draft_enc_kvs = [(zd(), zd()) for _ in draft_model.dec_blocks]
        # the step's source mask compares positions with src_lens, an
        # in-place input like the loop's own (``_init_loop``)
        self.src_lens = torch.zeros((max_slots,), dtype=torch.int64, device=dev)
        self._src_pos = torch.arange(s_src, device=dev)
        self._init_loop()

    def _new_draft_caches(self) -> Optional[list]:
        if self.draft is None:
            return None
        return self.draft.init_cache(self.max_slots, self.max_dec_len + self.spec_extra)

    # --------------------------------------------------------------- device
    def _src_mask(self) -> torch.Tensor:
        """[slots, max_src_len] bool: each slot's true source positions."""
        return self._src_pos[None, :] < self.src_lens[:, None]

    @torch.no_grad()
    def _encode_and_bos(self, model, src: torch.Tensor, slot: int, enc_kvs: list,
                        quantized_tmp: bool):
        """Admission's front half for ``model`` (the target or the draft):
        encode src [1, S] (unpadded, no mask), write each layer's cross K/V
        into the slot's rows of ``enc_kvs`` in place (quantized when they
        are int8), run the BOS step against a one-position cache. Returns
        (the BOS logits [1, V], that cache)."""
        plen = src.shape[1]
        fresh = model.cross_kvs(model.encode(src))
        for (k, v), dst in zip(fresh, enc_kvs):
            parts = (*quantize_kv(k), *quantize_kv(v)) if len(dst) == 4 else (k, v)
            for d, p in zip(dst, parts):
                d[slot:slot + 1, :, :plen] = p.to(d.dtype)
        tmp = model.init_cache(1, 1, quantized=quantized_tmp)
        bos = torch.full((1, 1), self.bos_token, dtype=torch.int64, device=src.device)
        logits, tmp = model.decode_logits(bos, 0, fresh, tmp)
        return logits, tmp

    @torch.no_grad()
    def _prefill_impl(self, src: torch.Tensor, slot: int, temp: float, topp: float,
                      topk: int):
        """Admit one source into ``slot``: encode, cross K/V, the BOS step,
        its K/V into the slot's self-cache (dense: row 0 of the slot; paged:
        written through the slot's page table at position 0, as a decode
        step writes). Returns the first token and its logprob."""
        logits, tmp = self._encode_and_bos(self.model, src, slot, self.enc_kvs,
                                           self.quantized_cache and not self.paged)
        if self.paged:
            zero = torch.zeros((1,), dtype=torch.int64, device=src.device)
            for c, (k, v) in zip(self.caches, tmp):
                view = dataclasses.replace(c, page_table=c.page_table[slot:slot + 1],
                                           step_slot=None, step_page=None)
                paged_write_step(view, k, v, zero)
        else:
            for c, t in zip(self.caches, tmp):
                for dst, row in zip(c, t):
                    dst[slot:slot + 1, :, :1] = row
        return self._sample_first(logits, temp, topp, topk)

    @torch.no_grad()
    def _draft_admit_impl(self, src: torch.Tensor, slot: int) -> None:
        """The draft's admission: its own cross K/V of the source and its BOS
        K/V in its slot's self-cache rows (the BOS logits are the target's
        business)."""
        _, tmp = self._encode_and_bos(self.draft, src, slot, self.draft_enc_kvs, False)
        for c, t in zip(self.draft_caches, tmp):
            for dst, row in zip(c, t):
                dst[slot:slot + 1, :, :1] = row

    # the step bodies' model calls (``_EngineLoop``), the cross-attention
    # masked by each slot's source length
    def _step_logits(self) -> torch.Tensor:
        return self.model.decode_logits(self.cur_tokens, self.positions, self.enc_kvs,
                                        self.caches, src_mask=self._src_mask())[0]

    def _draft_logits(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        return self.draft.decode_logits(tok, pos, self.draft_enc_kvs, self.draft_caches,
                                        src_mask=self._src_mask())[0]

    def _verify_logits(self, seq: torch.Tensor) -> torch.Tensor:
        return self.model.decode_chunk(seq, self.positions, self.enc_kvs, self.caches,
                                       src_mask=self._src_mask())[0]

    # ---------------------------------------------------------------- admin
    def submit(self, req: Request):
        if len(req.prompt) > self.max_src_len:
            raise ValueError(f"request {req.id}: source length {len(req.prompt)} exceeds "
                             f"max_src_len {self.max_src_len}")
        self.book.submit(req)

    def _reserve_pages(self, slot: int, req: Request):
        """Reserve the request's worst case (BOS + max_new_tokens, and a
        round's verify rows) in pages. Returns "ok", "wait" after requeueing
        it at the front (backpressure), or "never" after finishing it with
        an error (it could not fit even in an empty pool)."""
        worst = min(1 + req.max_new_tokens, self.max_dec_len) + self.spec_extra
        need = self.alloc.pages_needed(worst, self._page_size)
        cap = min(self.alloc.pages_per_slot, self.caches[0].n_pages - 1)  # page 0 reserved
        if need > cap:
            req.error = f"request needs {need} pages > {cap} available per request"
            req.done = True
            self._unadmit(req)
            self.finished.append(req)
            return "never"
        if need > self.alloc.n_free:
            self._unadmit(req)
            req.done = False
            self.book.submit(req, front=True)
            return "wait"
        if self._grow_slot(slot, worst):
            self._sync_page_tables()
        return "ok"

    def _admit(self):
        while True:
            adm = self.book.next_admission()
            if adm is None:
                return
            slot, req = adm
            plen = len(req.prompt)
            eff_topk = self.top_k if req.top_k is None else req.top_k
            if self.paged:
                reserved = self._reserve_pages(slot, req)
                if reserved == "wait":
                    return
                if reserved == "never":
                    continue
            t_adm = time.perf_counter()
            src = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :], device=self.device)
            try:
                first_tok, first_lp = self._prefill_impl(src, slot, req.temperature,
                                                         req.top_p, eff_topk)
                if self.draft is not None:
                    self._draft_admit_impl(src, slot)
            except GraphCaptureError:
                raise
            except Exception as e:  # noqa: BLE001 — per-request isolation
                if self.mesh is not None:   # a fault of one rank ends the mesh's serving
                    raise
                req.done = True
                self._cancel_slot(slot, f"{type(e).__name__}: {e}")
                for r in self.book.drain_finished():
                    if r.id != req.id:
                        self.finished.append(r)
                self.finished.append(req)
                continue
            # in place: a captured decode graph reads these tensors
            self.src_lens[slot] = plen
            self.positions[slot] = 1
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
                # finished at admission: drop the logprobs subscription and
                # free the pages now
                self._lp_slots.pop(slot, None)
                if self.paged:
                    self._release_slot_pages(slot)
                self.finished.extend(self._drain_finished())
            self._admit_times.append(time.perf_counter() - t_adm)

    def _rebuild_caches(self) -> None:
        """Fresh caches after a decode fault: the self-caches from the
        engine's own geometry (and the draft's), the cross K/V cleared, the
        source lengths zeroed."""
        if self.paged:
            self.caches = self._new_pools(len(self.model.dec_blocks))
            self._sync_page_tables()
        else:
            self.caches = self.model.init_cache(self.max_slots,
                                                self.max_dec_len + self.spec_extra,
                                                quantized=self.quantized_cache)
        self.draft_caches = self._new_draft_caches()
        for layer in self.enc_kvs + (self.draft_enc_kvs or []):
            for i, t in enumerate(layer):
                # an int8 K/V's scales (kc, vc) back to 1, the rest to 0
                t.fill_(1.0 if len(layer) == 4 and i % 2 else 0.0)
        self.src_lens.zero_()
