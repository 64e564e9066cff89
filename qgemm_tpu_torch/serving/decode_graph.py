"""The engine's decode step and speculative round as replayed CUDA graphs:
the port's counterpart of the JAX engine's jitted steps (``_decode_impl``
and ``_spec_round_impl`` in ``qgemm_tpu/serving/engine.py``, and the
``lax.scan`` of K of them for ``multi_step``: ``_decode_multi_impl``,
``_spec_multi_impl``).

The engine hands ``DecodeGraphs`` its step: a function of the mode that
runs one step of that mode's body on the current stream and reads and
writes only device tensors the engine keeps in place (tokens, positions,
the active mask, the sampling knobs, the caches, the draft's caches and
the shared page table, a ring of per-step outputs with its index). The
engine's modes are "greedy" and "sampled" (a decode step) and
"spec_greedy" and "spec_sampled" (a speculative round). One graph is
captured per mode, the first time it runs: one eager step on the capture
stream warms up (it is a real step of the dispatch: its launches reach the
card and are counted as they happen), then the capture. A mode whose name
ends in "sampled" draws random numbers: the engine's ``torch.Generator``
is registered with its graph, so that every replay draws fresh ones.
``run(mode, n)`` is then n replays, so a block of ``multi_step`` steps or
rounds costs n graph launches and the engine's one read of the ring.

A wrapper counts its kernel launches in Python, which a replay does not
run: the counts a capture adds are taken back (nothing reached the card)
and added again at every replay, so the counters count the launches that
reach the card, as on the eager route.

Under a mesh (``collectives=True``) the step's ``torch.distributed``
collectives (``parallel/tp_ops.py``) are captured into the graph, in place
on its tensors, and a replay adds the collectives its capture counted, as
it does launches. The capture then runs in CUDA's thread-local capture
mode, after a device synchronisation: the process group's watchdog thread
queries the events of earlier collectives while the capturing thread
records, which the global mode forbids.

A capture that fails raises ``GraphCaptureError``: nothing falls back to
the eager route, which stays reachable only by the engine's private
``_graphs = None`` (the CPU runs it always).
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, Optional, Tuple

import torch

from qgemm_tpu_torch.ops import cuda as kernels
from qgemm_tpu_torch.parallel import tp_ops


class GraphCaptureError(RuntimeError):
    """Capturing a decode step or a speculative round failed: a fault of the
    program, not of one step, so the engine does not recover from it."""


class DecodeGraphs:
    """One captured step per mode, replayed on the current stream.
    ``step(mode)`` runs one step; ``generator`` is the generator the modes
    named "...sampled" draw from."""

    def __init__(self, step: Callable[[str], None], device: torch.device,
                 generator: Optional[torch.Generator] = None, collectives: bool = False):
        self._step = step
        self._device = device
        self._generator = generator
        self._collectives = collectives
        self._graphs: Dict[str, Tuple[object, Dict[str, int], Dict[str, int]]] = {}
        self._stream = None
        self.captures = 0
        self.replays = 0

    def reset(self) -> None:
        """Drop every graph: the next ``run`` of a mode captures it again.
        After a change of the tensors the step reads (a fault recovery
        rebuilds the caches); never after a page-table upload, which writes
        the shared table in place."""
        self._graphs.clear()

    def run(self, mode: str, n: int) -> None:
        """``n`` decode steps of ``mode``: replays of its graph, the first of
        them the warm-up step and the capture where the mode has none yet."""
        done = 0
        if mode not in self._graphs:
            self._graphs[mode] = self._capture(mode)
            done = 1
        graph, launches, collectives = self._graphs[mode]
        for _ in range(n - done):
            self._replay(graph)
            kernels.add_launch_counts(launches)
            tp_ops.add_collective_counts(collectives)
            self.replays += 1

    def _capture(self, mode: str) -> Tuple[object, Dict[str, int], Dict[str, int]]:
        diff = lambda a, b: {k: b[k] - a[k] for k in b if b[k] != a[k]}
        with self._capture_stream():
            self._step(mode)                   # the warm-up: a real, counted step
            before = kernels.launch_counts()
            coll_before = tp_ops.collective_counts()
            try:
                graph = self._record(mode)
            except Exception as e:
                raise GraphCaptureError(f"capturing the {mode} decode step failed: "
                                        f"{type(e).__name__}: {e}") from e
            launches = diff(before, kernels.launch_counts())
            collectives = diff(coll_before, tp_ops.collective_counts())
        kernels.add_launch_counts({k: -v for k, v in launches.items()})
        tp_ops.add_collective_counts({k: -v for k, v in collectives.items()})
        self.captures += 1
        return graph, launches, collectives

    # the three calls into CUDA; the CPU tests replace them
    @contextlib.contextmanager
    def _capture_stream(self):
        """Run the warm-up and the capture on a side stream of their own,
        after the work queued on the current stream, and queue what follows
        behind them. Its merge counters (``ops/cuda/split_decode.py``) are
        allocated by the warm-up, outside the graph's pool, and no eager
        call runs on it."""
        cur = torch.cuda.current_stream(self._device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            yield
        cur.wait_stream(self._stream)

    def _record(self, mode: str):
        graph = torch.cuda.CUDAGraph()
        if mode.endswith("sampled") and self._generator is not None:
            graph.register_generator_state(self._generator)
        # Python's cyclic garbage is collected before the capture and not
        # during it: freeing the device objects of a dead cycle (what a
        # training run in the same process leaves) queued a call the
        # capture forbids and invalidated it
        gc.collect()
        mode_kw = {}
        if self._collectives:
            torch.cuda.synchronize(self._device)
            mode_kw["capture_error_mode"] = "thread_local"
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=self._stream, **mode_kw):
                self._step(mode)
        finally:
            if enabled:
                gc.enable()
        return graph

    def _replay(self, graph) -> None:
        graph.replay()
