"""pqbench: the benchmark of tpu_parquet_torch, the PyTorch/CUDA port.

``python3 pqbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line.  Configurations, traffic mixes and per-layer
metrics are found by name under ``configs/``, ``traffic/`` and
``metrics/``; a configuration's table and layout under ``tables/`` and
``writers/``.
"""
