"""The op layer (port of ``qgemm_tpu/ops/__init__.py``), under the JAX
package's names. Importing it builds no kernel: the CUDA kernels are built
at their first launch."""

from qgemm_tpu_torch.ops import elemwise, reduction  # noqa: F401
from qgemm_tpu_torch.ops.softmax import softmax  # noqa: F401
from qgemm_tpu_torch.ops.layernorm import layernorm, layernorm_residual  # noqa: F401
from qgemm_tpu_torch.ops.cross_entropy import cross_entropy_loss  # noqa: F401
from qgemm_tpu_torch.ops.matmul import matmul  # noqa: F401
from qgemm_tpu_torch.ops.quantize import (  # noqa: F401
    absmax_quantize,
    dequantize,
    quantized_matmul,
    quantized_matmul_outlier,
)
