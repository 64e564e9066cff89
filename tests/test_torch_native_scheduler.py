"""Port parity for the native scheduler (qgemm_tpu_torch/serving/native.py
over the port's copy of csrc/scheduler.cpp, and the engine's
``_NativeBookkeeper``) against the Python bookkeeper and the JAX package.

The C ABI: a round trip of every entry, oversize rejection, speculative
blocks against ``_PyBookkeeper``, and one call sequence through the JAX
package's ``NativeScheduler`` (its library built from csrc/scheduler.cpp
into the test's temporary directory) and the port's. The engine: greedy
transcripts with ``scheduler="native"`` equal ``"python"``'s and the JAX
engine's, exactly, on a tiny float GPT, dense (with stop tokens and EOS),
paged with over-commit (preempting), paged with overlapped admission,
``multi_step=4``, speculative, with cancels and through a decode fault;
and the JAX suite's over-commit scenario, whose native half its own test
cannot run here.
"""

import functools
import subprocess

import jax
import numpy as np
import pytest

import qgemm_tpu.serving.native as j_native
from qgemm_tpu.models.gpt import GPT as JGPT
from qgemm_tpu.models.gpt import GPTConfig as JConfig
from qgemm_tpu.serving.engine import ContinuousBatchingEngine as JEngine
from qgemm_tpu.serving.engine import Request as JRequest
from qgemm_tpu_torch.models.gpt import GPTConfig
from qgemm_tpu_torch.serving import native
from qgemm_tpu_torch.serving.engine import (ContinuousBatchingEngine, Request,
                                            _NativeBookkeeper, _PyBookkeeper)
from qgemm_tpu_torch.utils import host_build
from qgemm_tpu_torch.utils.interop import gpt_from_jax_params
from qgemm_tpu_torch.utils.testing import use_test_threads
from test_torch_gpt import SIZES, jax_params
from test_torch_paged_engine import _overcommit_scenario
from test_torch_paged_engine import _pair as paged_pair

use_test_threads()

PS = 8


@functools.lru_cache(maxsize=None)
def _pair(seed: int):
    jm = JGPT.init(JConfig(**SIZES), key=jax.random.PRNGKey(seed))
    return jm, gpt_from_jax_params(jax_params(jm), GPTConfig(**SIZES), device="cpu")


# ------------------------------------------------------------------- C ABI
def test_abi_round_trip():
    s = native.NativeScheduler(max_slots=2, max_seq_len=16)
    assert native.available()
    s.submit(7, [1, 2, 3], 4, eos_token=9)
    s.submit(8, [4, 5], 3)
    s.set_stops(8, [6])
    s.submit(5, [2], 2, front=True)
    assert (s.num_waiting, s.num_active, s.num_finished, s.steps) == (3, 0, 0, 0)
    slot, rid, prompt = s.next_admission()
    assert (slot, rid, prompt.tolist()) == (0, 5, [2])
    slot, rid, prompt = s.next_admission()
    assert (slot, rid, prompt.tolist()) == (1, 7, [1, 2, 3])
    assert s.next_admission() is None                     # no free slot
    assert s.request_in_slot(0) == 5 and s.request_in_slot(1) == 7
    s.admitted(0, 11)
    s.admitted(1, 12)
    assert s.positions().tolist() == [1, 3]
    assert s.record_step([13, 14]) == 1                    # 5 reached max_new 2
    assert s.active_mask().tolist() == [False, True] and s.steps == 1
    assert s.request_in_slot(0) is None
    assert s.pop_finished()[1].tolist() == [11, 13]
    assert s.pop_finished() is None
    s.suspend_slot(1)
    assert s.record_step([0, 99]) == 0 and s.positions()[1] == 4   # not advanced
    s.resume_slot(1)
    slot, gen = s.preempt(7)
    assert slot == 1 and gen.tolist() == [12, 14] and s.preempt(7) is None
    s.resume_slot(1)                                        # no occupant: tolerated
    slot, rid, _ = s.next_admission()
    assert (slot, rid) == (0, 8)
    s.admitted(0, 6)                                       # a stop token
    assert s.pop_finished()[1].tolist() == [6]
    s.submit(9, [1], 5)
    assert s.cancel(9) == -1 and s.cancel(9) is None
    s.submit(10, [1], 5)
    s.next_admission()
    s.admitted(0, 3)
    assert s.cancel(10) == 0 and s.pop_finished()[1].tolist() == [3]
    with pytest.raises(KeyError):
        s.suspend_slot(1)


def test_oversize_and_bad_dims_are_refused():
    s = native.NativeScheduler(max_slots=1, max_seq_len=8)
    for front in (False, True):
        with pytest.raises(ValueError, match="exceeds max_seq_len"):
            s.submit(1, [1, 2, 3], 6, front=front)
    with pytest.raises(ValueError, match="waiting"):
        s.set_stops(1, [2])
    with pytest.raises(ValueError, match="dims"):
        native.NativeScheduler(max_slots=0, max_seq_len=8)
    with pytest.raises(ValueError):
        _NativeBookkeeper(1, 8).submit(Request(prompt=[1] * 5, max_new_tokens=4))
    with pytest.raises(ValueError):
        _PyBookkeeper(1, 8).submit(Request(prompt=[1] * 5, max_new_tokens=4))


def test_record_block_matches_python_bookkeeper():
    """Random speculative rounds (blocks of 0-5 tokens, EOS, stop tokens,
    max_new and the context limit cutting blocks) through both
    bookkeepers: equal accepted counts, positions, masks and transcripts."""
    rng = np.random.default_rng(0)
    books = [_PyBookkeeper(3, 24), _NativeBookkeeper(3, 24)]
    reqs = [[Request(prompt=list(rng.integers(0, 9, 1 + i % 5)), max_new_tokens=3 + i % 9,
                     eos_token=(7 if i % 3 == 0 else None),
                     stop_tokens=([5] if i % 4 == 1 else None), id=1000 + i)
             for i in range(12)] for _ in books]
    for book, rs in zip(books, reqs):
        for r in rs:
            book.submit(r)
    done = [[], []]
    for _ in range(60):
        for j, book in enumerate(books):
            while (adm := book.next_admission()) is not None:
                book.admitted(adm[0], 1)
        cands = rng.integers(0, 9, (3, 5))
        produced = rng.integers(0, 6, 3)
        acc = [b.record_block(cands, produced) for b in books]
        assert acc[0].tolist() == acc[1].tolist()
        assert books[0].positions().tolist() == books[1].positions().tolist()
        assert books[0].active_mask().tolist() == books[1].active_mask().tolist()
        for j, book in enumerate(books):
            done[j] += [(r.id, list(r.generated)) for r in book.drain_finished()]
    assert done[0] == done[1] and len(done[0]) == 12
    assert books[0].steps == books[1].steps == 60


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    """The JAX package's NativeScheduler on csrc/scheduler.cpp, built with
    the Makefile's flags into this test's directory."""
    lib = tmp_path / "libqgemm_sched.so"
    src = host_build.CSRC.parents[1] / "csrc" / "scheduler.cpp"
    subprocess.run([host_build.gxx_path(), *host_build.GXX_FLAGS, str(src),
                    *host_build.GXX_LDFLAGS, "-o", str(lib)], check=True)
    monkeypatch.setattr(j_native, "_LIB_PATH", str(lib))
    monkeypatch.setattr(j_native, "_lib", None)
    return j_native


def test_same_calls_through_jax_and_port_schedulers(jax_native):
    """One call sequence (admissions, steps, a speculative round, stops,
    suspend, preempt, cancel) through both packages' schedulers: every
    return value equal."""
    def drive(mod):
        s = mod.NativeScheduler(3, 32)
        out = []
        for i, (p, n, e) in enumerate([([1, 2], 5, None), ([3], 4, 6), ([4, 5, 6], 9, None),
                                       ([7], 3, None)]):
            s.submit(100 + i, p, n, eos_token=e)
        s.set_stops(103, [2])
        for step in range(12):
            while (adm := s.next_admission()) is not None:
                out.append(("adm", adm[0], adm[1], adm[2].tolist()))
                s.admitted(adm[0], 1 + step)
            if step == 3:
                out.append(("block", s.record_block(np.arange(15).reshape(3, 5) % 7,
                                                    [2, 5, 1]).tolist()))
            elif step == 5:
                slot = int(np.flatnonzero(s.active_mask())[0])
                s.suspend_slot(slot)
                out.append(("susp", slot, s.record_step([2, 3, 4])))
                s.resume_slot(slot)
            elif step == 6:
                pre = s.preempt(102)
                out.append(("pre", None if pre is None else (pre[0], pre[1].tolist())))
            elif step == 8:
                out.append(("cancel", s.cancel(101), s.cancel(12345)))
            else:
                out.append(("step", s.record_step([step % 5, 2, step % 3])))
            out.append((s.positions().tolist(), s.active_mask().tolist(), s.num_waiting,
                        s.num_active, s.num_finished, s.steps,
                        [s.request_in_slot(k) for k in range(3)]))
            while (fin := s.pop_finished()) is not None:
                out.append(("fin", fin[0], fin[1].tolist()))
        return out

    assert jax_native.available()
    assert drive(native) == drive(jax_native)


# ------------------------------------------------------------------ engine
def _eos(tm) -> int:
    eng = ContinuousBatchingEngine(tm, max_slots=1, device="cpu", scheduler="python")
    req = Request(prompt=[5, 6, 7], max_new_tokens=6)
    eng.submit(req)
    eng.run_to_completion(max_steps=20)
    return req.generated[3]


def _spec(eos):
    """Mixed lengths through two slots, EOS mid-run for two requests, a stop
    token for one."""
    return [([5, 6, 7], 6, eos, None), ([8, 9], 11, None, None), ([1] * 7, 3, None, None),
            ([2, 3], 9, eos, None), ([4] * 5, 7, None, [eos])]


# mode -> (JAX engine options or None, port engine options, max_slots)
MODES = {
    "dense": (dict(), dict(), 2),
    "paged_overcommit": (dict(paged=True, page_size=PS, overcommit=True, n_pages=9),
                         dict(paged=True, page_size=PS, overcommit=True, n_pages=9), 3),
    "paged_overlap": (None, dict(paged=True, page_size=PS, chunked_prefill=PS,
                                 overlap_admission=True), 2),
    "multi_step": (dict(multi_step=4), dict(multi_step=4), 2),
    "speculative": ("draft", dict(spec_gamma=3), 2),
}


def _serve(engine_cls, req_cls, model, spec, max_slots, cancel=False, **kw):
    eng = engine_cls(model, max_slots=max_slots, **kw)
    reqs = [req_cls(prompt=p, max_new_tokens=m, eos_token=e, stop_tokens=s, logprobs=True)
            for p, m, e, s in spec]
    for r in reqs:
        eng.submit(r)
    if cancel:
        eng.step()
        eng.step()
        assert eng.cancel(reqs[1].id) and eng.cancel(reqs[-1].id)   # active, waiting
        assert not eng.cancel(reqs[1].id)
    eng.run_to_completion(max_steps=400)
    assert all(r.done for r in reqs)
    return ([(list(r.generated), r.cancelled, r.error) for r in reqs],
            [list(r.token_logprobs) for r in reqs], eng)


@pytest.mark.parametrize("mode", list(MODES) + ["cancel"])
def test_native_engine_matches_python_and_jax(mode):
    jm, tm = _pair(31)
    spec = _spec(_eos(tm))
    if mode == "paged_overcommit":
        # the JAX suite's over-commit mix: two 40-token generations outgrow
        # the 8-page pool beside the short ones
        spec = [([3 + i, 5, 7], n, None, None) for i, n in enumerate([40, 4, 4, 40, 4, 4])]
    jkw, kw, slots = MODES.get(mode, MODES["dense"])
    kw = dict(kw)
    if jkw == "draft":
        kw["draft_model"] = tm
        jkw = dict(kw, draft_model=jm)
    cancel = mode == "cancel"
    runs = {sched: _serve(ContinuousBatchingEngine, Request, tm, spec, slots, cancel=cancel,
                          device="cpu", scheduler=sched, **kw)
            for sched in ("python", "native")}
    (py, py_lps, py_eng), (nat, nat_lps, nat_eng) = runs["python"], runs["native"]
    assert (py_eng.scheduler, nat_eng.scheduler) == ("python", "native")
    assert isinstance(nat_eng.book, _NativeBookkeeper)
    assert nat == py and nat_lps == py_lps
    for key in ("tokens_generated", "steps", "decode_steps", "preemptions", "pages_in_use",
                "prefix_hits", "prefill_tokens_skipped", "spec_rounds", "spec_acceptance"):
        assert nat_eng.stats.get(key) == py_eng.stats.get(key), key
    if mode == "paged_overcommit":
        assert nat_eng.preemptions > 0
    if cancel:
        assert nat[1][1] and 0 < len(nat[1][0]) < 11 and nat[-1][1] and nat[-1][0] == []
    if jkw is not None:
        want, _, _ = _serve(JEngine, JRequest, jm, spec, slots, cancel=cancel,
                            scheduler="python", **jkw)
        assert [t for t, _, _ in nat] == [t for t, _, _ in want]


def test_native_engine_decode_fault_recovery_matches_python():
    """A fault in the third decode step: both in-flight requests fail with
    the error and their prefill's token, the engine rebuilds, and a later
    request gets the same transcript under either bookkeeper, and JAX's."""
    jm, tm = _pair(32)

    def run(engine_cls, req_cls, model, inject, **kw):
        eng = engine_cls(model, max_slots=2, **kw)
        doomed = [req_cls(prompt=[1, 2, 3], max_new_tokens=8),
                  req_cls(prompt=[4, 5], max_new_tokens=8)]
        for r in doomed:
            eng.submit(r)
        inject(eng)
        eng.run_to_completion(max_steps=40)
        after = req_cls(prompt=[6, 7, 8], max_new_tokens=5)
        eng.submit(after)
        eng.run_to_completion(max_steps=40)
        return [(list(r.generated), r.error) for r in doomed + [after]], eng

    def inject(eng, attr):
        real, state = getattr(eng, attr), {"n": 0}

        def flaky(*args):
            state["n"] += 1
            if state["n"] == 1:
                raise RuntimeError("injected decode fault")
            return real(*args)

        setattr(eng, attr, flaky)

    got = {s: run(ContinuousBatchingEngine, Request, tm, lambda e: inject(e, "_decode_body"),
                  device="cpu", scheduler=s)[0] for s in ("python", "native")}
    want, _ = run(JEngine, JRequest, jm, lambda e: inject(e, "_decode"), scheduler="python")
    assert got["native"] == got["python"]
    assert all("injected decode fault" in err and len(toks) == 1
               for toks, err in got["native"][:2])
    assert got["native"][2] == (want[2][0], None)


def test_jax_overcommit_scenario_native_half():
    """The JAX suite's test_overcommit_preemption_parity_and_throughput with
    ``scheduler="native"`` (the half its own test cannot run without the
    JAX package's library): over-commit keeps the reservation-mode
    transcripts, which equal the JAX engine's, in fewer engine steps."""
    sizes = {"vocab_size": 97, "d_model": 32, "d_ff": 64, "max_seq_len": 64}
    jm, tm = paged_pair(41, **sizes)
    want, _, _ = _overcommit_scenario(jm, JEngine, JRequest, scheduler="python")
    base, eng0, _ = _overcommit_scenario(tm, ContinuousBatchingEngine, Request, device="cpu",
                                         scheduler="native")
    over, eng1, _ = _overcommit_scenario(tm, ContinuousBatchingEngine, Request, device="cpu",
                                         overcommit=True, scheduler="native")
    assert eng1.scheduler == "native" and over == base == want
    assert "preemptions" in eng1.stats and eng1.steps < eng0.steps


def test_auto_takes_native_once_built():
    """"auto" follows the JAX engine's rule: the native scheduler when its
    library is built (a ``NativeScheduler`` built it), else Python."""
    _, tm = _pair(31)
    native.NativeScheduler(1, 8)
    assert native.available()
    assert ContinuousBatchingEngine(tm, device="cpu").scheduler == "native"
    assert ContinuousBatchingEngine(tm, device="cpu", scheduler="python").scheduler == "python"
