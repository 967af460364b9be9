"""Benchmark of the PyTorch/CUDA port ``glorie_slam_tpu_torch`` on one H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; ``BENCHMARK.json`` at the root of the
repository lists the cells, configurations and metrics, and each of them
lives in files of its own here (``configs/``, ``traffic/``, ``limits/``,
``metrics/``), found by name.
"""
