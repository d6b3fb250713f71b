"""qbsbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

One run measures one cell of ``BENCHMARK.json`` (a deployment under a
traffic mix) on the CUDA card and prints one JSON line:

    python3 qbsbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything specific to one configuration, traffic mix or per-layer metric
lives in a file of its own that the harness finds by name:
``configs/<name>.json``, ``traffic/<name>.json`` and ``metrics/<name>.py``;
a configuration names its ``systems/<system>.py`` and a traffic mix its
``drivers/<driver>.py``.  Nothing here imports JAX or the JAX package.
"""
