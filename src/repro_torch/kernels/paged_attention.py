"""Paged decode attention over the block-first KV pool.

Replaces ``paged_attention_tpu`` (``src/repro/kernels/paged_attention.py:84``)
in its bf16/fp32 mode with ``csrc/paged_attention.cu``. Decode attention is
bound by device-memory bytes (each context token's K and V read once), so
the kernel reads every K/V byte once: one thread block per (kv head,
sequence) whose warps are the query heads of that GQA group, sharing each
K/V tile through shared memory, walking only the blocks the context
covers, and addressing ``(row, layer)`` of the pool by strides so no slice
of the pool is copied. The int8 ``kv_scales`` mode is not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_attention_ref

launches = 0      # kernel launches (plain-version calls are not counted)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def paged_attention(q: torch.Tensor, kv_pool: torch.Tensor,
                    block_tables: torch.Tensor, context_lens: torch.Tensor,
                    *, layer: int = -1) -> torch.Tensor:
    """q: (B, H, D); kv_pool: (NB, 2, P, Hkv, D), or (NB, L, 2, P, Hkv, D)
    with ``layer >= 0``; block_tables: (B, MB) int32; context_lens: (B,)
    int32, each >= 1 -> (B, H, D). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, kv_pool, block_tables, context_lens,
                                   layer=layer)
    return paged_attention_kernel(q, kv_pool, block_tables, context_lens,
                                  layer=layer)


def paged_attention_kernel(q: torch.Tensor, kv_pool: torch.Tensor,
                           block_tables: torch.Tensor,
                           context_lens: torch.Tensor, *,
                           layer: int = -1) -> torch.Tensor:
    """Launch ``csrc/paged_attention.cu`` on the current stream."""
    global launches
    for name, t in (("q", q), ("kv_pool", kv_pool),
                    ("block_tables", block_tables),
                    ("context_lens", context_lens)):
        if not t.is_cuda:
            raise ValueError(f"paged_attention kernel: {name} is on "
                             f"{t.device}, not CUDA")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention kernel: {name} must be "
                             f"contiguous")
    if q.dtype not in _DTYPES or kv_pool.dtype != q.dtype:
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
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head_dim {D} not in "
                         f"{_HEAD_DIMS}")
    if P > 32 or H // Hkv > 32:
        raise ValueError(f"paged_attention kernel: block size {P} and group "
                         f"{H // Hkv} must each be <= 32")
    out = torch.empty_like(q)
    if B == 0:
        return out
    s_tok = Hkv * D
    s_side = P * s_tok
    s_row = kv_pool.stride(0)
    layer_off = layer * kv_pool.stride(1) if layered else 0
    fn = _build.function("paged_attention", "repro_paged_attention", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 4 + [
        ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.check(fn(q.data_ptr(), kv_pool.data_ptr(), block_tables.data_ptr(),
                    context_lens.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
                    B, H, Hkv, D, MB, P, s_row, layer_off, s_side, s_tok,
                    D ** -0.5, stream), "paged_attention")
    launches += 1
    return out
