"""The benchmark of ``convex_dim_red_tpu_torch`` on NVIDIA GPUs.

``python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  See ``port_bench/README.md``.
"""
