"""Forward flash attention (causal and/or sliding window) with native GQA
and an explicit query offset: the paged runner's prefill attention.

Replaces ``flash_attention_tpu`` (``src/repro/kernels/flash_attention.py:72``)
with ``csrc/flash_attention.cu``, and takes the call site of the jnp
``models/attention.py::flash_attention`` on the prefill path, whose queries
start at ``q_offset = start`` over a pow2-padded block context. At prefill
widths the work is bound by tensor-core FLOPs. The wrapper's C entry runs
one of two hand-written kernels by dtype: bf16 goes to the tensor cores
(``wgmma`` m64n64k16 for Q.K^T and P.V, one warpgroup per 64-query tile,
Q read from shared memory, P a register operand, Q and 64-key K/V tiles
by TMA, K/V into a two-stage ring of 128B-swizzled shared memory with an
mbarrier per stage, the online softmax in registers); fp32 stays on the CUDA cores, since the lossless
checks hold it to 1e-5, which TF32 would not. Both visit only the kv tiles
a query tile can see. ``head_dim`` is one of 16, 32, 64, 128 and 256;
any other raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

launches = 0      # kernel launches (plain-version calls are not counted)
# the work of the calls on meta tensors (the dry-run), by this kernel's
# formula (``flops_and_bytes``)
meta_cost = {"calls": 0, "flops": 0.0, "bytes": 0.0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: Optional[int] = None,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, H, D). Query row i
    sits at kv position ``q_offset + i``; ``None`` means ``Skv - Sq`` (the
    TPU kernel's alignment). CPU tensors take the plain version; CUDA
    tensors launch the kernel; meta tensors (the dry-run) give an empty
    output and add the kernel's work to ``meta_cost``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset,
                                   softmax_scale=softmax_scale)
    if q.device.type == "meta":
        B, Sq, H, D = q.shape
        off = k.shape[1] - Sq if q_offset is None else int(q_offset)
        flops, nbytes = flops_and_bytes(B, Sq, k.shape[1], H, k.shape[2], D,
                                        causal=causal, window=window,
                                        q_offset=off,
                                        itemsize=q.element_size())
        meta_cost["calls"] += 1
        meta_cost["flops"] += flops
        meta_cost["bytes"] += nbytes
        return torch.empty_like(q)
    return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset,
                                  softmax_scale=softmax_scale)


def flops_and_bytes(B: int, Sq: int, Skv: int, H: int, Hkv: int, D: int, *,
                    causal: bool, window: int, q_offset: int,
                    itemsize: int) -> Tuple[float, float]:
    """The least work of one call: 4 operations per visible (query, key)
    pair, query head and head dim (Q.K^T and P.V), and q, k, v read once
    and the output written once."""
    pos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Skv, pos + 1) if causal else np.full(Sq, Skv)
    lo = (np.maximum(0, pos - window + 1) if window > 0
          else np.zeros(Sq, np.int64))
    pairs = B * int(np.clip(hi - lo, 0, None).sum())
    nbytes = (2 * B * Sq * H * D + 2 * B * Skv * Hkv * D) * itemsize
    return float(4 * pairs * H * D), float(nbytes)


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0, q_offset: Optional[int] = None,
                           softmax_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on the current stream."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention kernel: {name} is on "
                             f"{t.device}, not CUDA")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} must be "
                             f"contiguous")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"flash_attention kernel takes fp32 or bf16 "
                             f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                             f"{v.dtype}")
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or H % Hkv:
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head_dim {D} not in "
                         f"{_HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: bf16 q, k and v must be "
                         "16-byte aligned (they are read by TMA)")
    off = Skv - Sq if q_offset is None else int(q_offset)
    scale = D ** -0.5 if softmax_scale is None else float(softmax_scale)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function("flash_attention", "repro_flash_attention", [
        ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with _build.on_device(q.device):
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), _DTYPES[q.dtype], B, Sq, Skv, H, Hkv,
                        D, off, int(causal), int(window), scale, stream),
                     "flash_attention")
    launches += 1
    return out
