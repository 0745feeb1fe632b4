"""Attention of the ``LM``: prefill (flash) and one-token decode over a
dense per-request cache.

``flash_attention`` has the reference's call (``src/repro/models/
attention.py:36``): q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) with GQA by
``Hkv``, ``q_offset`` the absolute position of q[0] relative to k[0],
``window`` a sliding window (0 = full), ``causal=False`` for an encoder's
layers and for cross-attention over its memory (Sq != Skv). On CUDA it
runs the flash kernel,
on the CPU the plain version; never a library attention. The reference's
``chunk_q``/``chunk_kv`` set the jnp version's tile sizes and have no
counterpart here: the kernel has its own tiles.

``decode_attention`` and ``update_cache`` are the reference's jnp functions
(``:113-146``), which run outside any Pallas kernel; plain PyTorch is their
counterpart. Scores and the value product accumulate in fp32, as the
reference's ``preferred_element_type`` asks.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels.flash_attention import flash_attention as _flash

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    return _flash(q, k, v, causal=causal, window=window, q_offset=q_offset,
                  softmax_scale=softmax_scale)


def _bound(b: Union[int, torch.Tensor], like: torch.Tensor):
    """A position bound as an int or a (B or 1, 1) tensor on ``like``'s
    device, ready to compare with (1, S) positions."""
    if isinstance(b, int):
        return b
    return torch.as_tensor(b, device=like.device).reshape(-1, 1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     valid_from: Union[int, torch.Tensor],
                     valid_to: Union[int, torch.Tensor], *,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention against a dense KV cache.

    q: (B, Hq, D); k_cache/v_cache: (B, S, Hkv, D); valid_from/valid_to:
    ints or (B,) — cache positions in [valid_from, valid_to) attend.
    """
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    group = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    qg = (q * scale).reshape(B, Hkv, group, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    pos = torch.arange(S, device=q.device)[None]           # (1, S)
    mask = ((pos >= _bound(valid_from, q))
            & (pos < _bound(valid_to, q)))                  # (B or 1, S)
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd",
                       (p / l).to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, Hq, D).to(q.dtype)


def update_cache(cache: torch.Tensor, new: torch.Tensor,
                 pos: int) -> torch.Tensor:
    """Write new (B, 1, Hkv, D) into cache (B, S, Hkv, D) at position
    ``pos``, IN PLACE (the reference's ``dynamic_update_slice`` returns a new
    array; an eager cache is owned by its request, and a copy per token
    would move the whole cache). ``pos`` is clamped so the write fits, as
    ``dynamic_update_slice`` clamps it. Returns ``cache``."""
    n = new.shape[1]
    pos = min(max(int(pos), 0), cache.shape[1] - n)
    cache[:, pos:pos + n] = new.to(cache.dtype)
    return cache
