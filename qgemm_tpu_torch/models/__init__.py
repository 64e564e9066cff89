"""The modules (port of ``qgemm_tpu/models``); the names JAX's package
exports are attributes here, imported on first use."""

from qgemm_tpu_torch import _lazy_exports

__getattr__ = _lazy_exports(__name__, {
    "Linear": "linear", "QuantizedLinear": "linear",
    "Attention": "attention", "MultiHeadAttention": "attention",
    "MLP": "mlp", "SGD": "optim", "sgd_step": "optim"})
