"""The benchmark of lobpcg_tpu_torch: BENCHMARK.json's cells, run one at a time
by ``bench_port/run.py`` (see README.md)."""
