#!/usr/bin/env python
"""Write tests/fixtures/mnist_mlp_init_seed1.npz: the JAX package's initial
784-16-10 MLP (``MLP.init(jax.random.PRNGKey(1), [784, 16, 10])``, the
starting point of scripts/mnist_oracle.py's protocol) as a
``save_checkpoint`` file.

The PyTorch port draws other initial weights from the same seed, so its
MNIST run on the card (``chip_smoke.py``'s ``mnist`` phase) starts from
this file, read by ``qgemm_tpu_torch.utils.checkpoint.load_checkpoint``,
to follow the oracle's protocol from the same weights.
tests/test_torch_mlp.py holds the file equal to a fresh JAX init.

Usage: JAX_PLATFORMS=cpu python scripts/mnist_init_fixture.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from qgemm_tpu.models.mlp import MLP
from qgemm_tpu.utils.checkpoint import save_checkpoint

SEED = 1
DIMS = [784, 16, 10]
OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "fixtures",
                   "mnist_mlp_init_seed1.npz")


def main():
    jax.config.update("jax_platforms", "cpu")
    save_checkpoint(OUT, MLP.init(jax.random.PRNGKey(SEED), DIMS))
    print(os.path.abspath(OUT))


if __name__ == "__main__":
    main()
