"""Forward flash attention (causal and/or sliding window) with native GQA
and an explicit query offset: the paged runner's prefill attention.

Replaces ``flash_attention_tpu`` (``src/repro/kernels/flash_attention.py:72``)
with ``csrc/flash_attention.cu``, and takes the call site of the jnp
``models/attention.py::flash_attention`` on the prefill path, whose queries
start at ``q_offset = start`` over a pow2-padded block context. At prefill
widths the work is bound by tensor-core FLOPs. The wrapper's C entry runs
one of two hand-written kernels by dtype: bf16 goes to the tensor cores
(``wgmma`` m64n64k16 for Q.K^T and P.V, one warpgroup per 64-query tile,
Q and P as register operands, 64-key K/V tiles by TMA into a two-stage
ring of 128B-swizzled shared memory with an mbarrier per stage, the
online softmax in registers); fp32 stays on the CUDA cores, since the lossless checks hold
it to 1e-5, which TF32 would not. Both visit only the kv tiles a query
tile can see.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

launches = 0      # kernel launches (plain-version calls are not counted)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: Optional[int] = None,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, H, D). Query row i
    sits at kv position ``q_offset + i``; ``None`` means ``Skv - Sq`` (the
    TPU kernel's alignment). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset,
                                   softmax_scale=softmax_scale)
    return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset,
                                  softmax_scale=softmax_scale)


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
    if q.dtype == torch.bfloat16 and (k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("flash_attention kernel: bf16 k and v must be "
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
