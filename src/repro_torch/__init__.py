"""SuperInfer on PyTorch and CUDA (NVIDIA Hopper).

The host layer (scheduler, block table, DuplexKV, engine core) mirrors
``src/repro`` module for module; the device layer runs the paged runner
on hand-written CUDA kernels (``kernels/csrc``) with plain PyTorch
versions beside them for CPU runs and tests. Entry points run on CUDA
unless the caller passes ``device="cpu"``.
"""
