"""Serving (port of ``qgemm_tpu/serving``); the names JAX's package
exports are attributes here, imported on first use."""

from qgemm_tpu_torch import _lazy_exports

__getattr__ = _lazy_exports(__name__, {
    "ContinuousBatchingEngine": "engine", "Request": "engine",
    "Seq2SeqEngine": "seq2seq", "speculative_generate": "speculative"})
