"""One run of one cell: set-up, the measured window, the metrics, the check.

``run_cell`` makes the weights from the seed on the device, hands them to
the port (``systems/<family>.py``), warms up the cell's own shapes and
traffic, drives the traffic for ``seconds``, reads the end-to-end metrics
(``trace=False``) or the per-layer ones (``trace=True``: a profiled
sub-window inside the window), frees the program and compares a sample of
the served requests with the plain reference (``reference/<family>.py``).

The engine is driven only through ``submit`` and ``step``. A request's
first token and its finish are seen when the ``step`` call that produced
them returns: that is when a caller of the engine holds them.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import spec as specs
from portbench.trace import HostSpans, Recorder, Trace
from portbench.yardstick import Model, Work

FORBIDDEN = ("jax", "jaxlib", "flax", "qgemm_tpu")
# the traced sub-window of a --trace 1 run: from this share of the window,
# this many seconds (a longer trace holds more events than its reduction
# can take inside a run's time)
TRACE_AT = 0.4
TRACE_SECONDS = 3.0


def now() -> float:
    return time.perf_counter()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclass
class Rec:
    """One request of the run, as the harness saw it."""
    prompt: List[int]
    max_new: int
    shared: int
    sent: float                    # submitted (closed loop) or due (open loop)
    req: object = None
    submitted: float = 0.0
    first: Optional[float] = None
    finish: Optional[float] = None
    seen: int = 0                  # tokens seen after the last step
    error: Optional[str] = None


@dataclass
class Step:
    t0: float
    t1: float
    tokens: int
    work: Work
    prompt_tokens: int = 0


@dataclass
class RunRecord:
    """What the metric readers read (``metrics/<name>.py``: ``read(run)``)."""
    cell: specs.Cell
    setup_s: float
    t0: float
    t1: float
    recs: List[Rec]
    steps: List[Step]
    counters: Dict[str, float]
    admit_s: List[float]
    trace: Optional[Trace] = None
    trace_bounds: tuple = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def window_steps(self) -> List[Step]:
        return [s for s in self.steps if self.t0 < s.t1 <= self.t1]

    def traced_steps(self) -> List[Step]:
        a, b = self.trace_bounds
        return [s for s in self.steps if s.t0 >= a and s.t1 <= b]


class Driver:
    """Feeds the engine from the cell's stream and keeps the books: one
    ``Rec`` per request, one ``Step`` per ``step`` call, and the work each
    step's needed rows did (``yardstick.Model``)."""

    def __init__(self, engine, system, stream, counts: Model, skip_page: int):
        self.engine, self.system, self.stream, self.counts = engine, system, stream, counts
        self.skip_page = skip_page
        self.inflight: List[Rec] = []
        self.recs: List[Rec] = []
        self.steps: List[Step] = []
        self.host = HostSpans()
        self.record_steps = False

    def skip(self, rec: Rec) -> int:
        """Leading prompt tokens a prefix cache of ``skip_page`` pages holds:
        the shared document's whole pages, the last prompt token excluded."""
        if not self.skip_page:
            return 0
        return min(rec.shared, len(rec.prompt) - 1) // self.skip_page * self.skip_page

    def submit(self, spec, sent: float) -> Rec:
        rec = Rec(prompt=spec.prompt, max_new=spec.max_new, shared=spec.shared, sent=sent)
        rec.req = self.system.request(spec.prompt, spec.max_new)
        rec.submitted = now()
        self.engine.submit(rec.req)
        self.inflight.append(rec)
        self.recs.append(rec)
        return rec

    def step(self) -> List[Rec]:
        """One ``engine.step()``; returns the requests it finished."""
        eng = self.engine
        admits0 = len(getattr(eng, "_admit_times", ()))
        t0, ns0 = now(), time.time_ns()
        eng.step()
        t1, ns1 = now(), time.time_ns()
        work, tokens, ptoks = Work(), 0, 0
        decode_ctx: List[List[int]] = []
        done = []
        for rec in self.inflight:
            g0, g1 = rec.seen, len(rec.req.generated)
            tokens += g1 - g0
            if g1 > g0 and g0 == 0:
                rec.first = t1
                ptoks += len(rec.prompt)
                work.add(self.counts.prefill(len(rec.prompt), self.skip(rec)))
            base = max(g0, 1)
            for j in range(max(0, g1 - base)):
                while len(decode_ctx) <= j:
                    decode_ctx.append([])
                decode_ctx[j].append(len(rec.prompt) + base + j)
            rec.seen = g1
            if rec.req.done:
                rec.finish = t1
                rec.error = rec.req.error
                done.append(rec)
        for ctx in decode_ctx:
            work.add(self.counts.decode_step(ctx))
        if done:
            self.inflight = [r for r in self.inflight if not r.req.done]
        if self.record_steps:
            self.steps.append(Step(t0, t1, tokens, work, ptoks))
            adm = sum(getattr(eng, "_admit_times", [])[admits0:])
            if adm > 0:
                self.host.add(ns0, ns0 + int(adm * 1e9), "admission (prefill, host-issued)")
            self.host.add(ns0 + int(adm * 1e9), ns1, "decode dispatch and host bookkeeping")
        return done

    def idle_until(self, t: float) -> None:
        ns0 = time.time_ns()
        time.sleep(max(0.0, t - now()))
        if self.record_steps:
            self.host.add(ns0, time.time_ns(), "no request in flight (open loop)")

    def busy(self) -> bool:
        return bool(self.inflight)


def drive(drv: Driver, loop: str, until: Callable[[], bool], clients: int,
          state: dict) -> None:
    """Run the loop until ``until()``. ``state`` carries the open loop's
    schedule (``next_due``, ``next_spec``) and the closed loop's first
    round between calls, so set-up and window are one unbroken stream."""
    if loop == "closed":
        if not state.get("started"):
            for spec in drv.stream.first_round(clients):
                drv.submit(spec, now())
            state["started"] = True
        while not until():
            for _ in drv.step():
                spec, _ = drv.stream.next()
                drv.submit(spec, now())
        return
    if not state.get("started"):
        spec, gap = drv.stream.next()
        state.update(started=True, next_due=now() + gap, next_spec=spec, late=[])
    while not until():
        t = now()
        while state["next_due"] <= t:
            rec = drv.submit(state["next_spec"], state["next_due"])
            state["late"].append(rec.submitted - rec.sent)
            spec, gap = drv.stream.next()
            state["next_due"] += gap
            state["next_spec"] = spec
        if drv.busy():
            drv.step()
        else:
            drv.idle_until(state["next_due"])


def warm_lengths(dist: dict) -> List[int]:
    """Prompt lengths that meet every power-of-two bucket of ``dist``: its
    ends, and each power of two inside and the length past it."""
    lo, hi = int(dist["min"]), int(dist["max"])
    out = {lo, hi}
    p = 1
    while p < hi:
        for n in (p, p + 1):
            if lo <= n <= hi:
                out.add(n)
        p *= 2
    return sorted(out)


def run_until_idle(drv: Driver) -> None:
    while drv.busy():
        drv.step()


def sample(recs: List[Rec], seed: int, target: int, min_requests: int) -> List[Rec]:
    """The check's sample: the longest served request, then others in an
    order drawn from the seed, until ``target`` served tokens and
    ``min_requests`` requests."""
    if not recs:
        return []
    longest = max(range(len(recs)), key=lambda i: (len(recs[i].req.generated), -i))
    rest = [i for i in range(len(recs)) if i != longest]
    order = [longest] + list(np.random.default_rng([seed & ((1 << 64) - 1), 2])
                             .permutation(rest))
    out, n = [], 0
    for i in order:
        out.append(recs[int(i)])
        n += len(recs[int(i)].req.generated)
        if n >= target and len(out) >= min_requests:
            break
    return out


def run_cell(cell: specs.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, rate: Optional[float] = None,
             quantize: Optional[dict] = None, check: bool = True,
             log: Callable[[str], None] = lambda s: print(s, file=sys.stderr)) -> dict:
    """One run. ``t_start``: the process's start on ``now()``'s clock.
    ``rate`` overrides an open loop's rate (the sweep), ``quantize`` the
    cell's weight quantization (the control). Returns the result's fields
    and ``checks``, the numbers compared with their limits."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    marks = [("imports", now())]
    model_cfg = cell.config["model"]
    system = specs.family_module(cell, "systems")
    inputs = specs.family_module(cell, "inputs")
    if cuda:
        system.prebuild()
    weights = inputs.make(model_cfg, seed, device)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("build and weights", now()))
    model = system.build_model(model_cfg, weights, dict(cell.options.get("quantize", {}),
                                                       **(quantize or {})))
    del weights
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    eng_opts = cell.options["engine"]
    engine = system.build_engine(model, eng_opts, device)
    marks.append(("quantization and engine", now()))
    gen = specs.generator_module(cell)
    stream = gen.stream(cell.traffic, int(model_cfg["vocab_size"]), seed, rate=rate)
    page = int(eng_opts.get("page_size") or 128) if (
        eng_opts.get("paged") and eng_opts.get("prefix_cache", True)) else 0
    drv = Driver(engine, system, stream, Model(model_cfg), page)
    loop = cell.traffic["loop"]
    clients = int(cell.traffic.get("clients", 0))

    # set-up: the documents once, then every prompt bucket the mix reaches
    # (after a document where there is one), then the mix itself until
    # every slot has turned over
    for doc in stream.documents:
        drv.submit(gen.Spec(list(doc), 1, len(doc)), now())
    run_until_idle(drv)
    doc0 = stream.documents[0] if stream.documents else []
    rng = np.random.default_rng([seed & ((1 << 64) - 1), 3])
    for n in warm_lengths(cell.traffic["prompt"]):
        body = rng.integers(0, int(model_cfg["vocab_size"]), size=n).tolist()
        drv.submit(gen.Spec(list(doc0) + body, 2, len(doc0)), now())
        run_until_idle(drv)
    marks.append(("documents and buckets", now()))
    state: dict = {}
    slots = int(eng_opts.get("max_slots", 8))
    n_warm = len(drv.recs)
    drive(drv, loop, lambda: sum(r.finish is not None for r in drv.recs[n_warm:]) >= slots
          and (loop != "closed" or all(r.finish is not None
                                       for r in drv.recs[n_warm:n_warm + clients])),
          clients, state)
    if cuda:
        torch.cuda.synchronize()

    marks.append(("warm-up traffic", now()))
    log("setup: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b) in
                              zip([("", t_start)] + marks[:-1], marks))
        + f"; {len(drv.recs)} requests")

    # the window
    skipped0 = getattr(engine, "prefill_tokens_skipped", 0)
    admits0 = len(getattr(engine, "_admit_times", ()))
    drv.record_steps = True
    t0 = now()
    setup_s = t0 - t_start
    t_end = t0 + seconds
    rec_trace, tb = None, (0.0, 0.0)
    if trace:
        t_tr = t0 + TRACE_AT * seconds
        drive(drv, loop, lambda: now() >= t_tr, clients, state)
        rec_trace = Recorder()
        rec_trace.start()
        a = now()
        t_tr_end = a + min(TRACE_SECONDS, seconds * (1 - TRACE_AT))
        drive(drv, loop, lambda: now() >= t_tr_end, clients, state)
        rec_trace.stop()
        tb = (a, now())
    drive(drv, loop, lambda: now() >= t_end, clients, state)
    t1 = drv.steps[-1].t1 if drv.steps else now()
    if cuda:
        torch.cuda.synchronize()
    admit_s = list(getattr(engine, "_admit_times", [])[admits0:])
    counters = {"prefill_tokens_skipped": getattr(engine, "prefill_tokens_skipped", 0) - skipped0}
    mem_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded in the run's process: {bad}")
    tr = rec_trace.reduce(drv.host) if rec_trace is not None else None
    if rec_trace is not None:
        del rec_trace
    run = RunRecord(cell=cell, setup_s=setup_s, t0=t0, t1=t1, recs=drv.recs[n_warm:],
                    steps=drv.steps, counters=counters, admit_s=admit_s, trace=tr,
                    trace_bounds=tb)
    if loop == "open" and state.get("late"):
        late = np.asarray(state["late"])
        offered = drv.stream.t["rate_per_s"] if rate is None else rate
        log(f"open loop: {len(late)} sent, lateness p50 {np.median(late) * 1e3:.3f} ms, "
            f"max {late.max() * 1e3:.3f} ms, {offered} /s")

    metrics = {}
    for m in cell.metrics(trace):
        value = specs.metric_reader(cell, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    attempted = sum(1 for r in run.recs if t0 <= r.sent <= t1)
    failed = sum(1 for r in run.recs if r.error)
    result = {"metrics": metrics, "attempted": attempted, "failed": failed,
              "memory_peak_bytes": mem_peak, "run": run}
    if tr is not None:
        result["trace"] = tr

    # the check, with the program freed first
    finished = [r for r in run.recs if r.finish is not None and t0 < r.finish <= t1
                and not r.error]
    chk = cell.options["check"]
    chosen = sample(finished, seed, int(chk["served_tokens"]), int(chk["min_requests"]))
    seqs_in = [(list(r.prompt), list(r.req.generated), drv.skip(r) or len(r.prompt))
               for r in chosen]
    del drv, engine, model, stream, run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    result["checks"], result["readings"] = {}, {}
    if check:
        result["checks"], result["readings"] = compare(cell, seed, device, seqs_in, failed, log)
    return result


def compare(cell: specs.Cell, seed: int, device, seqs_in, failed: int,
            log: Callable[[str], None] = lambda s: print(s, file=sys.stderr)) -> dict:
    """The numbers compared, each with its limit (``cells/<cell>.json``
    ``check.limits``): of the gaps by which each sampled served token's
    logit lies below the reference's best, the widest (``max_logit_gap``)
    and the mean (``mean_logit_gap``), where the cell sets a limit for it;
    the sample's served tokens (at least 1) and the failed requests (0).
    Returns those checks, and both gaps as read, limited or not."""
    ref = specs.family_module(cell, "reference")
    inputs = specs.family_module(cell, "inputs")
    model_cfg = cell.config["model"]
    limits = cell.options["check"]["limits"]
    served = sum(len(s[1]) for s in seqs_in)
    read = {"max_logit_gap": None, "mean_logit_gap": None}
    if seqs_in:
        weights = inputs.make(model_cfg, seed, device)
        seqs = [ref.Sequence(prompt=p, served=g, float_end=fe) for p, g, fe in seqs_in]
        gaps = np.concatenate(ref.served_gaps(model_cfg, weights, seqs))
        del weights
        read = {"max_logit_gap": float(gaps.max()), "mean_logit_gap": float(gaps.mean())}
        log(f"check: {len(seqs)} requests, {served} served tokens, "
            f"{int((gaps > 0).sum())} off the reference's argmax, widest gap "
            f"{read['max_logit_gap']}, mean gap {read['mean_logit_gap']}")
    checks = {k: {"value": v, "limit": limits[k]} for k, v in read.items() if k in limits}
    checks["served_tokens"] = {"value": served, "limit": 1}
    checks["failed"] = {"value": failed, "limit": 0}
    return checks, read


def is_correct(checks: dict) -> bool:
    """Every gap at most its limit (a missing one fails), at least one
    served token compared, no failed request."""
    gaps_ok = all(v["value"] is not None and v["value"] <= v["limit"]
                  for k, v in checks.items() if k.endswith("_gap"))
    return (gaps_ok and checks["served_tokens"]["value"] >= checks["served_tokens"]["limit"]
            and checks["failed"]["value"] <= checks["failed"]["limit"])
