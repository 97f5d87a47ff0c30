"""The benchmark harness of the PyTorch/CUDA port `repro_torch`.

`run.py` (one directory up) is the entry point. Everything that belongs
to one configuration, one traffic mix, one cell's limits or one
per-layer metric is a file of its own under ``configs/``, ``mixes/``,
``limits/`` and ``metrics/``, found by the name that ``BENCHMARK.json``
gives it.
"""
