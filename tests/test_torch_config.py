"""Port parity for the config and flag system
(qgemm_tpu_torch/utils/config.py) against qgemm_tpu/utils/config.py: the
same flags parse to equal dataclasses, with the same defaults, and ``-c``
selects the CPU."""

import argparse
import dataclasses

import pytest

from qgemm_tpu.utils import config as jc
from qgemm_tpu_torch.utils import config as tc

ARGVS = [[], ["-s", "3", "-c", "-m", "64", "-n", "32", "-k", "17"],
         ["--seed", "9", "--cpu", "--iters", "5"], ["-m", "1", "-n", "1", "-k", "1"]]


@pytest.mark.parametrize("argv", ARGVS)
def test_flags_parse_to_jax_dataclasses(argv):
    t = tc.gemm_config_from_args(tc.add_gemm_flags(argparse.ArgumentParser()).parse_args(argv))
    j = jc.gemm_config_from_args(jc.add_gemm_flags(argparse.ArgumentParser()).parse_args(argv))
    assert tc.asdict(t) == jc.asdict(j)
    assert t.device == ("cpu" if t.on_cpu else None)


def test_dataclasses_match_jax():
    for name in ("GemmConfig", "TransformerConfig"):
        t, j = getattr(tc, name), getattr(jc, name)
        assert [(f.name, f.default) for f in dataclasses.fields(t)] == \
            [(f.name, f.default) for f in dataclasses.fields(j)]
    cfg = tc.TransformerConfig(d_model=64, quantized=False)
    assert tc.asdict(cfg) == jc.asdict(jc.TransformerConfig(d_model=64, quantized=False))
