"""Paged decode attention over the block-first KV pool.

Replaces ``paged_attention_tpu`` (``src/repro/kernels/paged_attention.py:84``)
in both its modes with ``csrc/paged_attention.cu``: bf16/fp32, and the int8
``kv_scales`` mode whose dequant is fused into the kernel. Decode attention
is bound by device-memory bytes (each context token's K and V read once),
so the kernel reads every K/V byte once: the warps of a thread block are
the query heads of one GQA group and share each K/V tile through shared
memory, and ``(row, layer)`` of the pool (and of the scales) is addressed
by strides so no slice of either is copied. Each (kv head, sequence) is
served by a cluster of ``cluster_size(MB, P)`` CTAs that split its context
(split-K, ``ref.split_bounds``: a function of the context length alone, so
a sequence's output does not depend on its batch) and combine their
partials through distributed shared memory, in one launch; each CTA
streams its split through a ``cp.async`` ring. In the int8 mode the tile
stays int8 in shared memory too.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import cluster_size, paged_attention_ref

launches = 0        # bf16/fp32-mode kernel launches
launches_int8 = 0   # int8-mode kernel launches (plain-version calls are
#                     counted by neither)
# the work of the calls on meta tensors (the dry-run), by this kernel's
# formula (``flops_and_bytes``)
meta_cost = {"calls": 0, "flops": 0.0, "bytes": 0.0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def paged_attention(q: torch.Tensor, kv_pool: torch.Tensor,
                    block_tables: torch.Tensor, context_lens: torch.Tensor,
                    *, layer: int = -1,
                    kv_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, D); kv_pool: (NB, 2, P, Hkv, D), or (NB, L, 2, P, Hkv, D)
    with ``layer >= 0``; block_tables: (B, MB) int32; context_lens: (B,)
    int32, each >= 1 -> (B, H, D). ``kv_scales`` (fp32, the pool's shape
    without P and D) marks an int8 pool. CPU tensors take the plain
    version; CUDA tensors launch the kernel; meta tensors (the dry-run)
    give an empty output and add the kernel's work to ``meta_cost``, with
    every sequence at its block table's whole capacity (a meta tensor
    holds no lengths)."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, kv_pool, block_tables, context_lens,
                                   layer=layer, kv_scales=kv_scales)
    if q.device.type == "meta":
        B, H, D = q.shape
        MB = block_tables.shape[1]
        P, Hkv = kv_pool.shape[-3], kv_pool.shape[-2]
        flops, nbytes = flops_and_bytes(
            B, H, Hkv, D, MB, B * MB * P, itemsize=q.element_size(),
            kv_itemsize=kv_pool.element_size(), quant=kv_scales is not None)
        meta_cost["calls"] += 1
        meta_cost["flops"] += flops
        meta_cost["bytes"] += nbytes
        return torch.empty_like(q)
    return paged_attention_kernel(q, kv_pool, block_tables, context_lens,
                                  layer=layer, kv_scales=kv_scales)


def flops_and_bytes(B: int, H: int, Hkv: int, D: int, MB: int,
                    context_total: int, *, itemsize: int, kv_itemsize: int,
                    quant: bool) -> Tuple[float, float]:
    """The least work of one call over ``context_total`` context tokens in
    all: 4 operations per token, query head and head dim (q.K^T and P.V);
    q read and the output written once, the block tables and lengths, each
    context token's K and V once, and in the int8 mode the fp32 scales of
    every table entry."""
    nbytes = (2 * B * H * D * itemsize + B * MB * 4 + B * 4
              + context_total * Hkv * D * 2 * kv_itemsize
              + (B * MB * 2 * Hkv * 4 if quant else 0))
    return float(4 * context_total * H * D), float(nbytes)


def paged_attention_kernel(q: torch.Tensor, kv_pool: torch.Tensor,
                           block_tables: torch.Tensor,
                           context_lens: torch.Tensor, *,
                           layer: int = -1,
                           kv_scales: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Launch ``csrc/paged_attention.cu`` on the current stream."""
    global launches, launches_int8
    tensors = [("q", q), ("kv_pool", kv_pool),
               ("block_tables", block_tables),
               ("context_lens", context_lens)]
    if kv_scales is not None:
        tensors.append(("kv_scales", kv_scales))
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"paged_attention kernel: {name} is on "
                             f"{t.device}, not CUDA")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention kernel: {name} must be "
                             f"contiguous")
    quant = kv_scales is not None
    if q.dtype not in _DTYPES:
        raise ValueError(f"paged_attention kernel takes fp32 or bf16 q, got "
                         f"{q.dtype}")
    if quant and (kv_pool.dtype != torch.int8
                  or kv_scales.dtype != torch.float32):
        raise ValueError(f"paged_attention kernel with kv_scales takes an "
                         f"int8 pool and fp32 scales, got "
                         f"{kv_pool.dtype}/{kv_scales.dtype}")
    if not quant and kv_pool.dtype != q.dtype:
        raise ValueError(f"paged_attention kernel takes fp32 or bf16 q and "
                         f"pool of one dtype, got {q.dtype}/{kv_pool.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError("block_tables and context_lens must be int32")
    B, H, D = q.shape
    layered = layer >= 0
    if kv_pool.dim() != (6 if layered else 5):
        raise ValueError(f"pool of shape {tuple(kv_pool.shape)} does not "
                         f"match layer={layer}")
    if layered:
        NB, L, two, P, Hkv, Dp = kv_pool.shape
        if layer >= L:
            raise ValueError(f"layer {layer} out of range for {L} layers")
    else:
        NB, two, P, Hkv, Dp = kv_pool.shape
    MB = block_tables.shape[1]
    if two != 2 or Dp != D or H % Hkv or block_tables.shape[0] != B \
            or context_lens.shape != (B,):
        raise ValueError(
            f"paged_attention kernel: shapes q {tuple(q.shape)}, pool "
            f"{tuple(kv_pool.shape)}, block_tables "
            f"{tuple(block_tables.shape)}, context_lens "
            f"{tuple(context_lens.shape)} do not agree")
    if quant and tuple(kv_scales.shape) != tuple(kv_pool.shape[:-3]) + (Hkv,):
        raise ValueError(f"paged_attention kernel: scales of shape "
                         f"{tuple(kv_scales.shape)} do not match pool "
                         f"{tuple(kv_pool.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head_dim {D} not in "
                         f"{_HEAD_DIMS}")
    if P < 1 or 32 % P or H // Hkv > 32:
        raise ValueError(f"paged_attention kernel: block size {P} must "
                         f"divide 32 and group {H // Hkv} be <= 32")
    if kv_pool.data_ptr() % 16:
        raise ValueError("paged_attention kernel: the pool must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out
    s_tok = Hkv * D
    s_side = P * s_tok
    s_row = kv_pool.stride(0)
    layer_off = layer * kv_pool.stride(1) if layered else 0
    cluster = cluster_size(MB, P)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if not quant:
        fn = _build.function("paged_attention", "repro_paged_attention", [
            ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
            + [ctypes.c_longlong] * 4 + [ctypes.c_float] + [ctypes.c_int]
            + [ctypes.c_void_p])
        with _build.on_device(q.device):
            _build.check(fn(q.data_ptr(), kv_pool.data_ptr(),
                            block_tables.data_ptr(), context_lens.data_ptr(),
                            out.data_ptr(), _DTYPES[q.dtype], B, H, Hkv, D,
                            MB, P, s_row, layer_off, s_side, s_tok,
                            D ** -0.5, cluster, stream),
                         "paged_attention")
        launches += 1
        return out
    s_srow = kv_scales.stride(0)
    s_layer_off = layer * kv_scales.stride(1) if layered else 0
    fn = _build.function("paged_attention", "repro_paged_attention_q", [
        ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 6 + [ctypes.c_float] + [ctypes.c_int]
        + [ctypes.c_void_p])
    with _build.on_device(q.device):
        _build.check(fn(q.data_ptr(), kv_pool.data_ptr(),
                        kv_scales.data_ptr(), block_tables.data_ptr(),
                        context_lens.data_ptr(), out.data_ptr(),
                        _DTYPES[q.dtype], B, H, Hkv, D, MB, P, s_row,
                        layer_off, s_side, s_tok, s_srow, s_layer_off,
                        D ** -0.5, cluster, stream), "paged_attention int8")
    launches_int8 += 1
    return out
