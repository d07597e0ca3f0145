"""The benchmark of ``dreamgaussian_tpu_torch``, the PyTorch/CUDA port, on
NVIDIA H100 cards: one cell run once by

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``run.py``'s docstring gives the run length, the result line, where the
build caches live (``build/`` inside the checkout) and what a run writes.
``BENCHMARK.json`` at the root names the cells, the configurations
(``configs/``), the traffic mixes (``traffic/``) and the metrics
(``metrics/``, one reader each); ``limits/`` holds each cell's limits of
the comparison with the plain reference (``reference/``). Nothing here
imports JAX, flax or the JAX package.
"""
