"""Weights of the dense decoder the paged runner executes.

The tree is ``{"layers": [per-layer dict, ...], "head": dict}``, in
execution order. A layer holds ``ln1``, ``wq (d, H, D)``, ``wk``/``wv``
``(d, Hkv, D)``, ``wo (H, D, d)``, ``ln2``, ``w_gate``/``w_up (d, f)`` and
``w_down (f, d)``; the head holds ``embed (V, d)``, ``final_norm`` and,
unless the embeddings are tied, ``lm_head (d, V)``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def param_shapes(cfg: ModelConfig):
    """(layer shapes, head shapes): name -> (shape, init) with init "normal"
    (scaled by 1/sqrt(shape[0]), the fan-in axis) or "zeros" (the norms,
    which scale by 1 + w) — the reference's rules
    (``src/repro/models/blocks.py:46-106``, ``lm.py:87-91``)."""
    d, H, Hkv, D, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    layer = {"ln1": ((d,), "zeros"), "wq": ((d, H, D), "normal"),
             "wk": ((d, Hkv, D), "normal"), "wv": ((d, Hkv, D), "normal"),
             "wo": ((H, D, d), "normal"), "ln2": ((d,), "zeros"),
             "w_gate": ((d, f), "normal"), "w_up": ((d, f), "normal"),
             "w_down": ((f, d), "normal")}
    head = {"embed": ((cfg.vocab_size, d), "normal"),
            "final_norm": ((d,), "zeros")}
    if not cfg.tie_embeddings:
        head["lm_head"] = ((d, cfg.vocab_size), "normal")
    return layer, head


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device, dtype: torch.dtype) -> Dict[str, object]:
    """Random weights drawn from ``generator`` (which must live on
    ``device``): fp32 normals scaled by 1/sqrt(fan_in), then cast to
    ``dtype``. The draws are torch's, not the JAX package's: to compare with
    the reference, bridge its weights with ``from_jax_params``."""
    layer_shapes, head_shapes = param_shapes(cfg)

    def draw(shape, init):
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(1.0 / np.sqrt(max(shape[0], 1))).to(dtype)

    layers = [{k: draw(*v) for k, v in layer_shapes.items()}
              for _ in range(cfg.num_layers)]
    head = {k: draw(*v) for k, v in head_shapes.items()}
    return {"layers": layers, "head": head}


def from_jax_params(layers: Sequence[Mapping[str, object]],
                    head: Mapping[str, object], device,
                    dtype: torch.dtype) -> Dict[str, object]:
    """The weight bridge: the reference runner's per-layer dicts in
    execution order (``PagedModelRunner._layers``) and its head dict, as
    anything ``numpy.asarray`` reads, to the port's tree on ``device``."""
    def conv(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype)

    return {"layers": [{k: conv(v) for k, v in layer.items()}
                       for layer in layers],
            "head": {k: conv(v) for k, v in head.items()}}
