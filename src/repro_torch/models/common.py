"""Shared numerics of the dense decoder: RMSNorm, RoPE, SwiGLU; and
``ArraySpec``, a tensor's shape, dtype and logical axes.

The numerics are twins of ``src/repro/models/common.py:74-109`` that keep
its cast points (fp32 norm and rotation, silu in fp32 then the working
dtype), which decide where bf16 rounds. ``ArraySpec`` and its tree helpers
are the reference's (``:113-140``) for caches and step inputs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.optimizer.adamw import TensorSpec
from repro_torch.tree import tree_map


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


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Shape, dtype name and logical axes of a cache tensor or step input."""
    shape: Tuple[int, ...]
    dtype: str            # "int32" | "float32" | "bfloat16" | "float16"
    logical_axes: Tuple[Optional[str], ...]

    def struct(self) -> TensorSpec:
        return TensorSpec(self.shape, getattr(torch, self.dtype))


def is_array_spec(x) -> bool:
    return isinstance(x, ArraySpec)


def specs_to_structs(tree):
    return tree_map(lambda s: s.struct(), tree, is_leaf=is_array_spec)


def specs_logical_axes(tree):
    return tree_map(lambda s: (s.logical_axes, s.shape), tree,
                    is_leaf=is_array_spec)
