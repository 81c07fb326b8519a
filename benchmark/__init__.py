"""The benchmark of gvom_tpu_torch (BENCHMARK.json): run one cell with benchmark/run.py."""
