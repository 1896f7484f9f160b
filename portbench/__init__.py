"""The benchmark of pythoncrt_tpu_torch on NVIDIA GPUs.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of BENCHMARK.json: its configuration (``configs/``), its
traffic (``traffic/``), driven through its entry (``entries/``), with its
per-layer metrics read by the readers in ``metrics/`` and its frames held
to the plain reference in ``reference/``.
"""
