"""Public kernel ops: the CUDA kernel for CUDA tensors, the plain PyTorch
version for CPU tensors (the twin of ``src/repro/kernels/ops.py``).

``force`` overrides: "kernel" (raises for a CPU tensor: a CUDA kernel has
no CPU mode), "ref" (the plain version on any device), None (by device).
``launch_counts`` reads the wrappers' launch counters; ``meta_costs``
reads the work their meta-tensor branches add up by each kernel's
``flops_and_bytes`` (the dry-run's kernel FLOPs).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import kv_copy as _copy
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref as ref_ops

# kernel name -> (wrapper module, its launch counter)
_COUNTERS = {"flash_attention": (_flash, "launches"),
             "kv_copy": (_copy, "launches"),
             "paged_attention": (_paged, "launches"),
             "paged_attention_int8": (_paged, "launches_int8")}


def _use_kernel(t: torch.Tensor, force: Optional[str]) -> bool:
    if force not in (None, "kernel", "ref"):
        raise ValueError(f"force must be 'kernel', 'ref' or None, got {force!r}")
    if force == "kernel" and not t.is_cuda:
        raise ValueError(f"force='kernel' needs CUDA tensors, got {t.device}")
    return force == "kernel" or (force is None and t.is_cuda)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: Optional[int] = None,
                    force: Optional[str] = None):
    if _use_kernel(q, force):
        return _flash.flash_attention_kernel(q, k, v, causal=causal,
                                             window=window, q_offset=q_offset)
    return ref_ops.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)


def paged_attention(q, kv_pool, block_tables, context_lens, *,
                    layer: int = -1, kv_scales=None,
                    force: Optional[str] = None):
    if _use_kernel(q, force):
        return _paged.paged_attention_kernel(q, kv_pool, block_tables,
                                             context_lens, layer=layer,
                                             kv_scales=kv_scales)
    return ref_ops.paged_attention_ref(q, kv_pool, block_tables, context_lens,
                                       layer=layer, kv_scales=kv_scales)


def kv_copy(pool, src, dst, *, force: Optional[str] = None):
    """In place; returns ``pool``."""
    if _use_kernel(pool, force):
        return _copy.kv_copy(pool, src, dst)
    return ref_ops.kv_copy_ref(pool, src, dst)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel (the int8 mode of paged attention
    counts apart from its bf16/fp32 mode)."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


_META = {"flash_attention": _flash, "kv_copy": _copy,
         "paged_attention": _paged}


def meta_costs() -> Dict[str, Dict[str, float]]:
    """The kernels' work on meta tensors so far (calls, FLOPs and bytes by
    each kernel's ``flops_and_bytes``), by kernel and in ``"total"``."""
    out = {name: dict(mod.meta_cost) for name, mod in _META.items()}
    out["total"] = {k: sum(c[k] for c in out.values())
                    for k in ("calls", "flops", "bytes")}
    return out


def reset_meta_costs() -> None:
    for mod in _META.values():
        mod.meta_cost.update(calls=0, flops=0.0, bytes=0.0)
