"""Shared numerics of the dense decoder: RMSNorm, RoPE, SwiGLU.

Twins of ``src/repro/models/common.py:74-109`` that keep its cast points
(fp32 norm and rotation, silu in fp32 then the working dtype), which decide
where bf16 rounds.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in fp32 and scale by ``(1 + scale)``; cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """``rope_freqs`` uploaded once per device: an upload per call would
    synchronise the host with the device twice a layer."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotation. x: (..., seq, heads, head_dim); positions:
    (..., seq)."""
    freqs = _rope_freqs_on(x.shape[-1], float(theta), x.device)
    angles = positions[..., :, None].float() * freqs     # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]             # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]
