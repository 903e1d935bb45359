"""portbench: the benchmark of quflow_tpu_torch on one NVIDIA H100.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see README.md."""
