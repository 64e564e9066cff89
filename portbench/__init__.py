"""The benchmark of ``qgemm_tpu_torch``, the PyTorch and CUDA port.

One command runs one cell (``BENCHMARK.json`` ``workloads``) once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is data found by name: its configuration
(``configs/<config>.json``), its traffic (``traffic/<mix>.json``, read by
``generators/<generator>.py``), its engine options and correctness limit
(``cells/<cell>.json``) and one reader per metric (``metrics/<metric>.py``).
The model family named by a configuration has the code that builds the port's model
in ``systems/<family>.py`` and a plain reference in ``reference/<family>.py``.

Nothing here imports JAX or the JAX package ``qgemm_tpu``; the reference
imports nothing of ``qgemm_tpu_torch`` either.
"""
