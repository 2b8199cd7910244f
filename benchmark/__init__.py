"""The benchmark of the PyTorch and CUDA port ``difacto_tpu_torch``
(``run.py`` is its entry point; ``BENCHMARK.json`` at the repository's
root lists its cells)."""
