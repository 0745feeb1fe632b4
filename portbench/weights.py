"""The benchmark's weights, drawn on the device from ``--seed``.

Each kind of weight is drawn for every layer at once, in the dtype it is
served in, by one ``normal_`` call on a ``torch.Generator`` that lives on
the device: a few large calls, nothing on the host. The runner and the
reference get the same tensors (each layer's weight is a view of its
stack). Shapes follow the program's weight tree (``{"layers": [...],
"head": {...}}``; ``wq (d, H, D)``, ``wk``/``wv (d, Hkv, D)``, ``wo (H, D,
d)``, ``w_gate``/``w_up (d, f)``, ``w_down (f, d)``, norms ``(d,)`` that
scale by ``1 + w``). Every projection is scaled by one over the root of
its fan-in, so activations keep unit scale through the depth; the norm
weights are drawn small and nonzero, so the check covers them.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.costs import Dims

NORM_STD = 0.1


def layer_shapes(dims: Dims) -> Dict[str, tuple]:
    """Each layer weight: (shape, fan-in; 0 for a norm)."""
    d, H, Hkv, D, f = (dims.d_model, dims.heads, dims.kv_heads,
                       dims.head_dim, dims.d_ff)
    return {"ln1": ((d,), 0), "wq": ((d, H, D), d), "wk": ((d, Hkv, D), d),
            "wv": ((d, Hkv, D), d), "wo": ((H, D, d), H * D),
            "ln2": ((d,), 0), "w_gate": ((d, f), d), "w_up": ((d, f), d),
            "w_down": ((f, d), f)}


def head_shapes(dims: Dims) -> Dict[str, tuple]:
    d, V = dims.d_model, dims.vocab
    return {"embed": ((V, d), 1), "final_norm": ((d,), 0),
            "lm_head": ((d, V), d)}


def _draw(shape, fan_in: int, gen: torch.Generator, device,
          dtype) -> torch.Tensor:
    std = NORM_STD if fan_in == 0 else 1.0 / math.sqrt(fan_in)
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        0.0, std, generator=gen)


def draw(dims: Dims, seed: int, device, dtype=torch.bfloat16
         ) -> Dict[str, object]:
    """The weight tree for ``seed``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    stacks = {k: _draw((dims.layers,) + shape, fan, gen, device, dtype)
              for k, (shape, fan) in layer_shapes(dims).items()}
    head = {k: _draw(shape, fan, gen, device, dtype)
            for k, (shape, fan) in head_shapes(dims).items()}
    layers = [{k: s[i] for k, s in stacks.items()}
              for i in range(dims.layers)]
    return {"layers": layers, "head": head}
