"""The benchmark of ``voxelengine_tpu_torch`` on one NVIDIA H100.

``python -m voxbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once (``voxbench/harness.py``).  It
imports neither JAX nor the JAX package ``voxelengine_tpu``.
"""
