"""The benchmark of ``ceph_tpu_torch`` on one NVIDIA H100.

``python -m perfbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Cells, configurations, traffic mixes and per-layer metrics are
files found by name under this folder (``workloads/``, ``configs/``,
``drivers/``, ``metrics/``); ``reference/`` decides ``correct``."""
