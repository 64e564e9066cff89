"""Utilities (port of ``qgemm_tpu/utils``); the names JAX's package
exports are attributes here, imported on first use (JAX's ``key_seq`` has
no counterpart: the port draws from seeds and ``torch.Generator``s)."""

from qgemm_tpu_torch import _lazy_exports

__getattr__ = _lazy_exports(__name__, {
    "uniform_init": "prng", "allclose": "testing", "assert_allclose": "testing"})
