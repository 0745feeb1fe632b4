"""Batched KV-pool row copy, the cudaMemcpyBatchAsync analogue: one launch
moves N whole block-first pool rows, ``pool[dst[i]] = pool[src[i]]``, in
place; ``src[i] < 0`` is a no-op that writes nothing.

Replaces ``kv_copy_tpu`` (``src/repro/kernels/kv_copy.py:29``) with
``csrc/kv_copy.cu``. It is bound by device-memory bytes (each row read
once and written once), and streams 16-byte vectors over a (row chunk,
descriptor) grid; rows that 16 does not divide (the int8 tier's fp32
scale rows can be 8 bytes) take 4-byte or 1-byte words. The TPU grid ran
descriptors in order; the GPU runs them in parallel, so a batch is
admitted only when its valid destinations are unique and disjoint from its
valid sources (checked here on the host descriptors). Every row movement of the paged runner obeys that: staging
gathers and scatters pair live rows with staging rows, and a CoW fork
copies a shared row to a freshly allocated one.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import kv_copy_ref

launches = 0      # kernel launches (plain-version calls are not counted)
# the work of the calls on meta tensors (the dry-run), by this kernel's
# formula (``flops_and_bytes``)
meta_cost = {"calls": 0, "flops": 0.0, "bytes": 0.0}


def flops_and_bytes(n_rows: int, row_bytes: int):
    """The least work of a launch moving ``n_rows`` rows: each read once
    and written once, no arithmetic."""
    return 0.0, float(2 * n_rows * row_bytes)


def check_descriptors(src: np.ndarray, dst: np.ndarray, rows: int) -> None:
    """Raise ``ValueError`` unless the valid descriptors can run in
    parallel: in-range rows, unique destinations, no destination that is
    also a source."""
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src/dst must be matching 1-D arrays, got "
                         f"{src.shape} and {dst.shape}")
    ok = src >= 0
    s, d = src[ok], dst[ok]
    if s.size and (s.max() >= rows or d.min() < 0 or d.max() >= rows):
        raise ValueError(f"kv_copy descriptor out of range for {rows} rows")
    if np.unique(d).size != d.size:
        raise ValueError("kv_copy destinations must be unique within a launch")
    if np.intersect1d(s, d).size:
        raise ValueError("kv_copy destinations overlap its sources: the "
                         "descriptors would race on the GPU")


def kv_copy(pool: torch.Tensor, src, dst) -> torch.Tensor:
    """pool: (rows, ...) of any dtype, contiguous; src/dst: (N,) int32 host
    arrays. Copies in place and returns ``pool``. A CPU pool takes the plain
    version; a CUDA pool launches the kernel; a meta pool (the dry-run)
    adds the kernel's work for the valid descriptors to ``meta_cost``."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    check_descriptors(src, dst, pool.shape[0])
    if pool.device.type == "cpu":
        return kv_copy_ref(pool, src, dst)
    if pool.device.type == "meta":
        flops, nbytes = flops_and_bytes(int((src >= 0).sum()),
                                        pool[0].numel() * pool.element_size())
        meta_cost["calls"] += 1
        meta_cost["flops"] += flops
        meta_cost["bytes"] += nbytes
        return pool
    return kv_copy_kernel(pool, src, dst)


def kv_copy_kernel(pool: torch.Tensor, src: np.ndarray,
                   dst: np.ndarray) -> torch.Tensor:
    """Launch ``csrc/kv_copy.cu`` on the current stream (descriptors already
    checked)."""
    global launches
    if not pool.is_cuda:
        raise ValueError(f"kv_copy kernel needs a CUDA pool, got {pool.device}")
    if not pool.is_contiguous():
        raise ValueError("kv_copy kernel needs a contiguous pool")
    row_bytes = pool[0].numel() * pool.element_size()
    n = len(src)
    if n == 0:
        return pool
    if n > 65535:
        raise ValueError(f"kv_copy takes at most 65535 descriptors, got {n}")
    # pinned, so the upload does not wait on the device
    idx = torch.from_numpy(np.concatenate([src, dst])).pin_memory().to(
        pool.device, non_blocking=True)
    fn = _build.function("kv_copy", "repro_kv_copy", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p])
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    with _build.on_device(pool.device):
        _build.check(fn(pool.data_ptr(), idx.data_ptr(),
                        idx.data_ptr() + 4 * n, n, row_bytes, stream),
                     "kv_copy")
    launches += 1
    return pool
