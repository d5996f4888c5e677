"""portbench: the benchmark of shadow_tpu_torch on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once: whole
simulations back to back, then the comparison with the plain reference
(``reference/``).
"""
