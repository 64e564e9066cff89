"""ctypes bindings for the native continuous-batching scheduler (port of
``qgemm_tpu/serving/native.py``) over the port's copy of
``csrc/scheduler.cpp``.

The scheduler owns the host-side serving state — request queue, slot
free-list, per-slot positions, transcripts, finish rules — behind a C ABI;
the engine's ``_NativeBookkeeper`` only moves tensors around it. The
library is built with ``g++`` into ``build/qgemm_tpu_torch/``
(``utils/host_build.py``) the first time a ``NativeScheduler`` is made;
``available()`` says whether the library of the current source is built
and loads, and never starts a build (``scheduler="auto"`` takes the native
scheduler only then, the JAX engine's rule).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from qgemm_tpu_torch.utils import host_build

_NAME = "scheduler"
_lib = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    i32, i64, u8 = c.c_int32, c.c_int64, c.c_uint8
    i32p, i64p, u8p = c.POINTER(i32), c.POINTER(i64), c.POINTER(u8)
    lib.qg_sched_create.argtypes = [i32, i32]
    lib.qg_sched_create.restype = c.c_void_p
    lib.qg_sched_destroy.argtypes = [c.c_void_p]
    lib.qg_sched_destroy.restype = None
    for name in ("submit", "submit_front"):
        fn = getattr(lib, f"qg_sched_{name}")
        fn.argtypes = [c.c_void_p, i64, i32p, i32, i32, i32]
        fn.restype = c.c_int
    lib.qg_sched_next_admission.argtypes = [c.c_void_p, i64p, i32p]
    lib.qg_sched_next_admission.restype = i32
    lib.qg_sched_slot_prompt.argtypes = [c.c_void_p, i32, i32p, i32]
    lib.qg_sched_slot_prompt.restype = i32
    lib.qg_sched_admitted.argtypes = [c.c_void_p, i32, i32]
    lib.qg_sched_admitted.restype = c.c_int
    lib.qg_sched_record_step.argtypes = [c.c_void_p, i32p]
    lib.qg_sched_record_step.restype = i32
    lib.qg_sched_record_block.argtypes = [c.c_void_p, i32p, i32p, i32, i32p]
    lib.qg_sched_record_block.restype = i32
    lib.qg_sched_set_stops.argtypes = [c.c_void_p, i64, i32p, i32]
    lib.qg_sched_set_stops.restype = c.c_int
    lib.qg_sched_active_mask.argtypes = [c.c_void_p, u8p]
    lib.qg_sched_active_mask.restype = None
    lib.qg_sched_positions.argtypes = [c.c_void_p, i32p]
    lib.qg_sched_positions.restype = None
    for name in ("num_waiting", "num_active", "num_finished"):
        fn = getattr(lib, f"qg_sched_{name}")
        fn.argtypes = [c.c_void_p]
        fn.restype = i32
    lib.qg_sched_steps.argtypes = [c.c_void_p]
    lib.qg_sched_steps.restype = i64
    lib.qg_sched_pop_finished.argtypes = [c.c_void_p, i64p, i32p, i32]
    lib.qg_sched_pop_finished.restype = i32
    lib.qg_sched_cancel.argtypes = [c.c_void_p, i64, i32p]
    lib.qg_sched_cancel.restype = i32
    lib.qg_sched_preempt.argtypes = [c.c_void_p, i64, i32p, i32p, i32]
    lib.qg_sched_preempt.restype = i32
    lib.qg_sched_suspend_slot.argtypes = [c.c_void_p, i32]
    lib.qg_sched_suspend_slot.restype = c.c_int
    lib.qg_sched_resume_slot.argtypes = [c.c_void_p, i32]
    lib.qg_sched_resume_slot.restype = c.c_int
    lib.qg_sched_slot_request.argtypes = [c.c_void_p, i32]
    lib.qg_sched_slot_request.restype = i64
    return lib


def build() -> ctypes.CDLL:
    """Build and load the library, or raise."""
    global _lib
    if _lib is None:
        _lib = _bind(host_build.load(_NAME))
    return _lib


def available() -> bool:
    """The library of the current source is built and loads."""
    global _lib
    if _lib is None and (lib := host_build.load_built(_NAME)) is not None:
        _lib = _bind(lib)
    return _lib is not None


def _i32arr(a):
    a = np.ascontiguousarray(a, np.int32)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeScheduler:
    """Thin wrapper over the C ABI. Runs the Python bookkeeper's state
    machine (the tests hold the two to equal transcripts)."""

    def __init__(self, max_slots: int, max_seq_len: int):
        lib = build()
        h = lib.qg_sched_create(max_slots, max_seq_len)
        if not h:
            raise ValueError(f"bad scheduler dims: {max_slots} slots, "
                             f"max_seq_len {max_seq_len}")
        self._lib, self._h = lib, h
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        # the per-step reads write into buffers of their own (a copy goes out)
        self._mask = np.zeros(max_slots, np.uint8)
        self._mask_ptr = self._mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        self._pos, self._pos_ptr = _i32arr(np.zeros(max_slots, np.int32))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.qg_sched_destroy(h)
            self._h = None

    def submit(self, req_id: int, prompt, max_new_tokens: int,
               eos_token: Optional[int] = None, front: bool = False) -> None:
        arr, ptr = _i32arr(prompt)
        fn = self._lib.qg_sched_submit_front if front else self._lib.qg_sched_submit
        rc = fn(self._h, req_id, ptr, len(arr), max_new_tokens,
                -1 if eos_token is None else eos_token)
        if rc != 0:
            raise ValueError(f"request {req_id}: prompt {len(arr)} + {max_new_tokens} "
                             f"exceeds max_seq_len {self.max_seq_len}")

    def set_stops(self, req_id: int, stops) -> None:
        """Attach extra stop tokens to a WAITING request (any generated
        token in the set finishes it, besides ``eos_token``)."""
        arr, ptr = _i32arr(stops)
        if self._lib.qg_sched_set_stops(self._h, req_id, ptr, len(arr)) != 0:
            raise ValueError(f"request {req_id} not in waiting queue")

    def next_admission(self):
        """-> (slot, req_id, prompt ndarray) or None."""
        rid, plen = ctypes.c_int64(), ctypes.c_int32()
        slot = self._lib.qg_sched_next_admission(self._h, ctypes.byref(rid),
                                                 ctypes.byref(plen))
        if slot < 0:
            return None
        out, ptr = _i32arr(np.zeros(plen.value, np.int32))
        if self._lib.qg_sched_slot_prompt(self._h, slot, ptr, plen.value) != plen.value:
            raise RuntimeError(f"slot {slot}: prompt copy failed")
        return slot, rid.value, out

    def admitted(self, slot: int, first_token: int) -> None:
        if self._lib.qg_sched_admitted(self._h, slot, first_token) != 0:
            raise KeyError(f"slot {slot} holds no request")

    def record_step(self, tokens) -> int:
        """One decode step: ``tokens`` [max_slots] (inactive slots' ignored).
        Returns how many requests finished."""
        arr, ptr = _i32arr(tokens)
        if len(arr) != self.max_slots:
            raise ValueError(f"{len(arr)} tokens for {self.max_slots} slots")
        return self._lib.qg_sched_record_step(self._h, ptr)

    def record_block(self, cands, produced) -> np.ndarray:
        """A speculative round: each active slot appends its own block.
        ``cands`` [max_slots, width], ``produced`` [max_slots]. Returns the
        per-slot count appended (after the finish rules cut a block)."""
        cands = np.ascontiguousarray(cands, np.int32)
        if cands.ndim != 2 or cands.shape[0] != self.max_slots:
            raise ValueError(f"cands of shape {cands.shape} for {self.max_slots} slots")
        _, cptr = _i32arr(cands.reshape(-1))
        parr, pptr = _i32arr(produced)
        if len(parr) != self.max_slots:
            raise ValueError(f"{len(parr)} block lengths for {self.max_slots} slots")
        acc, aptr = _i32arr(np.zeros(self.max_slots, np.int32))
        self._lib.qg_sched_record_block(self._h, cptr, pptr, cands.shape[1], aptr)
        return acc

    def active_mask(self) -> np.ndarray:
        self._lib.qg_sched_active_mask(self._h, self._mask_ptr)
        return self._mask.astype(bool)

    def positions(self) -> np.ndarray:
        self._lib.qg_sched_positions(self._h, self._pos_ptr)
        return self._pos.copy()

    @property
    def num_waiting(self) -> int:
        return self._lib.qg_sched_num_waiting(self._h)

    @property
    def num_active(self) -> int:
        return self._lib.qg_sched_num_active(self._h)

    @property
    def num_finished(self) -> int:
        return self._lib.qg_sched_num_finished(self._h)

    @property
    def steps(self) -> int:
        return self._lib.qg_sched_steps(self._h)

    def pop_finished(self):
        """-> (req_id, generated ndarray) or None."""
        rid = ctypes.c_int64()
        out, ptr = _i32arr(np.zeros(self.max_seq_len, np.int32))
        n = self._lib.qg_sched_pop_finished(self._h, ctypes.byref(rid), ptr,
                                            self.max_seq_len)
        if n < 0:
            return None
        return rid.value, out[:n]

    def request_in_slot(self, slot: int) -> Optional[int]:
        """Id of the request occupying ``slot``, or None when free."""
        rid = self._lib.qg_sched_slot_request(self._h, slot)
        return None if rid < 0 else int(rid)

    def preempt(self, req_id: int):
        """Free an ACTIVE request's slot and remove it, returning its
        transcript for the engine's continuation. -> (slot, generated
        ndarray) or None when the request is not active."""
        slot = ctypes.c_int32(-1)
        out, ptr = _i32arr(np.zeros(self.max_seq_len, np.int32))
        n = self._lib.qg_sched_preempt(self._h, req_id, ctypes.byref(slot), ptr,
                                       self.max_seq_len)
        if n < 0:
            return None
        return slot.value, out[:n]

    def suspend_slot(self, slot: int) -> None:
        """Drop ``slot`` from the active set without touching its request
        (overlapped admission). Pair with ``resume_slot``."""
        if self._lib.qg_sched_suspend_slot(self._h, slot) != 0:
            raise KeyError(f"slot {slot} holds no request")

    def resume_slot(self, slot: int) -> None:
        # a slot with no occupant is tolerated: decode-fault recovery during
        # an overlapped admission may have cancelled it already
        self._lib.qg_sched_resume_slot(self._h, slot)

    def cancel(self, req_id: int):
        """-> None (unknown or finished), or the freed slot, or -1 when the
        request was still waiting. A cancelled active request's partial
        transcript shows up in ``pop_finished``."""
        slot = ctypes.c_int32(-1)
        rc = self._lib.qg_sched_cancel(self._h, req_id, ctypes.byref(slot))
        if rc == 0:
            return None
        return slot.value if rc == 2 else -1
