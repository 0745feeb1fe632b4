"""Prefill attention: the port's ``models/attention.py::flash_attention``.

Same call as the reference (``src/repro/models/attention.py:36``): q
(B, Sq, Hq, D), k/v (B, Skv, Hkv, D) with GQA by ``Hkv``, ``q_offset`` the
absolute position of q[0] relative to k[0], ``window`` a sliding window
(0 = full). On CUDA it runs the flash kernel, on the CPU the plain version;
never a library attention. The reference's ``chunk_q``/``chunk_kv`` set the
jnp version's tile sizes and have no counterpart here: the kernel has its
own tiles.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention as _flash


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    return _flash(q, k, v, causal=causal, window=window, q_offset=q_offset,
                  softmax_scale=softmax_scale)
