"""N-layer perceptron (port of ``qgemm_tpu/models/mlp.py``).

Forward = a Linear + ReLU chain with no activation on the last layer.
``remat=True`` recomputes each hidden block in the backward pass instead of
keeping its activations (``torch.utils.checkpoint``, the counterpart of
``jax.checkpoint``). ``quantize`` gives the int8 (or W4A8) serving model,
whose every product runs kernel K1 (or K4) on the card; the float forward
is ``torch.matmul``, as JAX's is ``jnp.dot`` outside any Pallas kernel.
"""

from __future__ import annotations

import itertools
from typing import List, Sequence, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from qgemm_tpu_torch.device import DeviceLike, resolve_device
from qgemm_tpu_torch.models.linear import Linear


def _block(layer: nn.Module, h: torch.Tensor) -> torch.Tensor:
    return torch.relu(layer(h))


class MLP(nn.Module):
    def __init__(self, layers: Sequence[nn.Module], remat: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(layers)   # Linear | QuantizedLinear
        self.remat = remat

    @property
    def device(self) -> torch.device:
        first = self.layers[0]
        return next(itertools.chain(first.parameters(), first.buffers())).device

    @classmethod
    def init(cls, generator: Union[torch.Generator, int], layer_dims: List[int],
             bias: bool = True, dtype: torch.dtype = torch.float32, remat: bool = False,
             device: DeviceLike = None) -> "MLP":
        """Kaiming-uniform layers of ``layer_dims`` (e.g. [784, 16, 10], the
        MNIST oracle's topology), drawn from ``generator`` (a
        ``torch.Generator`` on ``device``, or an int seed for one) on
        ``device`` (default: the GPU — raises without one)."""
        dev = resolve_device(device)
        if isinstance(generator, int):
            seed, generator = generator, torch.Generator(device=dev)
            generator.manual_seed(seed)
        elif generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, model on {dev}")
        layers = [Linear.init(generator, din, dout, bias=bias, dtype=dtype)
                  for din, dout in zip(layer_dims[:-1], layer_dims[1:])]
        return cls(layers, remat=remat)

    def quantize(self, **qkw) -> "MLP":
        """Every layer quantized (``qkw`` as for ``Linear.quantize``)."""
        return MLP([layer.quantize(**qkw) for layer in self.layers], remat=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers[:-1]:
            x = checkpoint(_block, layer, x, use_reentrant=False) if remat else _block(layer, x)
        return self.layers[-1](x)    # logits: no activation on the last layer
