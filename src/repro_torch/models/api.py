"""Model inputs: the step's input shapes per (architecture, shape) cell,
demo inputs that match them, and the training microbatch knob.

The port of ``recommended_microbatches``, ``_frontend_len``,
``batch_specs`` and ``make_demo_inputs`` (``src/repro/models/api.py:21-61,
154-172``). ``make_demo_inputs`` draws from ``numpy.random.default_rng(0)``
in the reference's order, so both packages get equal inputs. The
reference's ``StepBundle``/``make_step_bundle`` (jit and dry-run tooling)
wait for the training stack and tooling (ROADMAP.md §1 items 9 and 10).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.common import dtype_of


@dataclasses.dataclass(frozen=True)
class InputSpec:
    shape: Tuple[int, ...]
    dtype: str            # "int32" | "float32" | "bfloat16"


def recommended_microbatches(cfg: ModelConfig) -> int:
    """Grad-accumulation microbatches for train_4k (baseline knob)."""
    n = cfg.param_count()
    if n >= 100e9:
        return 16
    if cfg.ssm is not None or cfg.vocab_size >= 200_000:
        return 8
    if n >= 8e9:
        return 8
    return 4


def _frontend_len(cfg: ModelConfig) -> int:
    return cfg.frontend.num_embeds if cfg.frontend.kind != "none" else 0


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, InputSpec]:
    """The step's data inputs: tokens (and labels and mask to train) whose
    length leaves room for a decoder's frontend embeddings, ``embeds`` or an
    encoder's ``src_embeds``; or a decode step's token and cache_len."""
    B, S = shape.global_batch, shape.seq_len
    F = _frontend_len(cfg)
    is_encdec = cfg.num_encoder_layers > 0
    out: Dict[str, InputSpec] = {}
    if shape.kind in ("train", "prefill"):
        tok_len = S - F if (F and not is_encdec) else S
        out["tokens"] = InputSpec((B, tok_len), "int32")
        if shape.kind == "train":
            out["labels"] = InputSpec((B, tok_len), "int32")
            out["mask"] = InputSpec((B, tok_len), "float32")
        if F and not is_encdec:
            out["embeds"] = InputSpec((B, F, cfg.frontend.embed_dim),
                                      "bfloat16")
        if is_encdec:
            out["src_embeds"] = InputSpec((B, F, cfg.frontend.embed_dim),
                                          "bfloat16")
    else:  # decode
        out["token"] = InputSpec((B,), "int32")
        out["cache_len"] = InputSpec((), "int32")
    return out


def make_demo_inputs(cfg: ModelConfig, shape: ShapeConfig,
                     device="cpu") -> Dict[str, object]:
    """Concrete inputs matching ``batch_specs`` on ``device``: token ids as
    int64 (the port's index dtype), ``cache_len`` as an int."""
    rng = np.random.default_rng(0)
    out: Dict[str, object] = {}
    for k, s in batch_specs(cfg, shape).items():
        if s.dtype == "int32":
            if k == "cache_len":
                out[k] = min(shape.seq_len - 1, 7)
            else:
                out[k] = torch.from_numpy(
                    rng.integers(0, cfg.vocab_size, s.shape)).long().to(device)
        elif k == "mask":
            out[k] = torch.ones(s.shape, dtype=dtype_of(s.dtype),
                                device=device)
        else:
            out[k] = torch.from_numpy(np.asarray(
                rng.standard_normal(s.shape), np.float32)).to(
                device=device, dtype=dtype_of(s.dtype))
    return out
