"""portbench: the benchmark of ``interpolation_engine_tpu_torch`` on one
NVIDIA H100.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Cells, configurations, traffic mixes and per-layer metrics are
files (``configs/``, ``traffic/``, ``metrics/``, ``bounds/``) found by the
names in ``BENCHMARK.json``; see ``README.md``.
"""
