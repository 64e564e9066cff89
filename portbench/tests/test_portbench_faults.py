"""A run with the timed path broken underneath comes out not correct: the
harness is driven as a run drives it (no card check, the CPU), once for
each fault a one-card serving cell can have: a token altered where it is
produced, a decode step that leaves its state (positions and KV cache)
unchanged, and
half of the batch left out of a decode step (its rows' logits taken from
the other half). The exchange between chips does not exist on one card."""

from __future__ import annotations

import pytest
import torch

from portbench import bench
from portbench.tests.conftest import run_tiny


def _altered_token(monkeypatch):
    from qgemm_tpu_torch.serving import engine as eng
    real = eng._EngineLoop._sample
    calls = [0]

    def sample(self, logits, greedy, temps, topps, topks):
        tok = real(self, logits, greedy, temps, topps, topks).clone()
        # one slot a call, in turn, gets its runner-up
        i = calls[0] % tok.shape[0]
        calls[0] += 1
        tok[i] = logits[i].to(torch.float32).topk(2).indices[1]
        return tok
    monkeypatch.setattr(eng._EngineLoop, "_sample", sample)


def _state_unchanged(monkeypatch):
    """The decode step leaves the engine's state as it found it: the
    positions restored after it and its cache rows never written."""
    from qgemm_tpu_torch.models import attention as att
    from qgemm_tpu_torch.serving import engine as eng
    real_rows, real_body = att._write_rows, eng._EngineLoop._decode_body

    def write_rows(cache, new, index):
        if new.shape[2] != 1:
            real_rows(cache, new, index)

    def body(self, mode):
        pos = self.positions.clone()
        real_body(self, mode)
        self.positions.copy_(pos)
    monkeypatch.setattr(att, "_write_rows", write_rows)
    monkeypatch.setattr(att, "paged_write_step", lambda *a, **k: None)
    monkeypatch.setattr(eng._EngineLoop, "_decode_body", body)


def _half_batch(monkeypatch):
    from qgemm_tpu_torch.serving import engine as eng
    real = eng.ContinuousBatchingEngine._step_logits

    def step_logits(self):
        logits = real(self)
        h = logits.shape[0] // 2
        return torch.cat([logits[:h], logits[:logits.shape[0] - h]])
    monkeypatch.setattr(eng.ContinuousBatchingEngine, "_step_logits", step_logits)


FAULTS = {"altered_token": _altered_token, "state_unchanged": _state_unchanged,
          "half_batch": _half_batch}


@pytest.mark.parametrize("cell", ["t.chat", "t.doc", "t.open"])
@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_path_is_not_correct(tiny, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    checks = run_tiny(tiny, cell, seed=31)["checks"]
    assert not bench.is_correct(checks), checks
