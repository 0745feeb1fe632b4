"""Blockwise int8 KV quantization for the paged pool, in plain PyTorch (the
port of ``src/repro/kernels/quant.py``, which is jnp code, not a Pallas
kernel).

Granularity is per (block row, layer, K/V side, kv head): one fp32 scale
covers the ``(P, D)`` tile of a head inside one logical block, so the int8
pool keeps the bf16 pool's shape and every row-addressed path (block-table
slots, ``kv_copy`` descriptors, staging, the host tier) works unchanged.
``scale = max(amax/127, SCALE_EPS)``; values round half to even
(``torch.round``, like ``jnp.round``) and clip to ``[-127, 127]``.

Streaming writes keep a *running* block scale: a write at in-block offset
0 resets the row's scale (scatter-min to ``SCALE_EPS``), later writes only
grow it (scatter-max), and content already stored is rescaled in place as
``round(q * old / new)`` before the new tokens land. The pool and the
scales are updated in place.
"""
from __future__ import annotations

from typing import Tuple

import torch

# floor for scales: keeps 0-amplitude (freshly zeroed) blocks from dividing
# by zero while still representing them exactly (0 / eps == 0)
SCALE_EPS = 1e-12


def kv_scale_shape(pool_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Scale-array shape for a pool shaped ``(..., P, Hkv, D)``: drop the
    token (P) and head-dim (D) axes — one scale per remaining index."""
    return tuple(pool_shape[:-3]) + (pool_shape[-2],)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., P, Hkv, D)`` float -> (int8 same shape, fp32 scales
    ``(..., Hkv)``). One scale per (leading index, kv head)."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-3, -1))
    scale = torch.clamp(amax / 127.0, min=SCALE_EPS)
    q = torch.clamp(torch.round(xf / scale[..., None, :, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_kv``: int8 ``(..., P, Hkv, D)`` + fp32 scales
    ``(..., Hkv)`` -> float values."""
    return (q.float() * scale[..., None, :, None]).to(dtype)


def quant_store_tokens(pool: torch.Tensor, scales: torch.Tensor,
                       wrow: torch.Tensor, lrow: torch.Tensor, side: int,
                       woff: torch.Tensor, vals: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter per-token K or V vectors into the int8 pool, in place,
    maintaining the running per-(block, layer, side, head) scales.

    pool: ``(NB, L, 2, P, Hkv, D)`` int8; scales: ``(NB, L, 2, Hkv)`` fp32,
    contiguous; wrow/lrow/woff: ``(T,)`` integer pool row / layer /
    in-block offset per token; side: 0 (K) or 1 (V); vals: ``(T, Hkv, D)``
    float. Returns ``(pool, scales)``, the same tensors.

    Rows hit by several tokens of one call (a prefill chunk inside one
    block, padded lanes on the trash row) are safe: the reset, the growth
    and the gathers of ``old``/``new`` are per-row quantities taken in that
    order, so duplicate lanes compute identical rescaled rows (their
    scatter writes identical values, in any order) before their distinct
    ``woff`` writes land. Offset 0 is written once per (block, layer, side)
    lifetime, so the reset there is sound.
    """
    wrow, lrow, woff = wrow.long(), lrow.long(), woff.long()
    L, hkv = scales.shape[1], scales.shape[-1]
    vf = vals.float()
    tok_scale = torch.clamp(vf.abs().amax(dim=-1) / 127.0,
                            min=SCALE_EPS)                       # (T, Hkv)
    # flat index of (row, layer, side) into scales.view(-1, Hkv)
    flat = (wrow * L + lrow) * 2 + side                          # (T,)
    sflat = scales.view(-1, hkv)
    idx = flat[:, None].expand_as(tok_scale)
    reset = torch.where(woff == 0, SCALE_EPS, float("inf"))      # (T,)
    sflat.scatter_reduce_(0, idx, reset[:, None].expand_as(tok_scale)
                          .to(sflat.dtype), reduce="amin", include_self=True)
    old = sflat[flat]                                            # (T, Hkv)
    sflat.scatter_reduce_(0, idx, tok_scale, reduce="amax",
                          include_self=True)
    new = sflat[flat]                                            # (T, Hkv)
    # rescale previously quantized content of rows whose scale grew
    row = pool[wrow, lrow, side].float()                         # (T,P,Hkv,D)
    ratio = (old / new)[:, None, :, None]
    pool[wrow, lrow, side] = torch.round(row * ratio).to(torch.int8)
    q = torch.clamp(torch.round(vf / new[:, :, None]), -127, 127)
    pool[wrow, lrow, side, woff] = q.to(torch.int8)
    return pool, scales
