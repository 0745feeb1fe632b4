"""Hand-written CUDA kernels (``csrc/``) for the TPU kernels of
``src/repro/kernels``, each with its plain PyTorch version (``ref``), a
wrapper that picks between them by the tensor's device, and a launch count.
``ops`` is the dispatch point that can force either one."""
