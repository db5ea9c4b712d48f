"""The benchmark of photoverse_tpu_torch: see benchmark/run.py and
BENCHMARK.json."""
