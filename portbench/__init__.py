"""The benchmark of the PyTorch/CUDA port (``repro_torch``): open-loop
serving cells driven by ``portbench/run.py`` from ``BENCHMARK.json``."""
