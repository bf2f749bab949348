"""The benchmark of dr_tpu_torch: ``drbench/run.py``, ``BENCHMARK.json``."""
