"""Model inputs and step functions per (architecture, shape) cell: the
step's input shapes, demo inputs that match them, the training microbatch
knob, and the step callable.

The port of ``recommended_microbatches``, ``_frontend_len``,
``batch_specs``, ``StepBundle``, ``make_step_bundle`` and
``make_demo_inputs`` (``src/repro/models/api.py``). ``make_demo_inputs``
draws from ``numpy.random.default_rng(0)`` in the reference's order, so
both packages get equal inputs. A ``StepBundle`` holds the step callable
and its ``static_meta``; the reference's structs, logical axes, donation
and byte groups serve its dry-run and wait for the tooling (ROADMAP.md §1
item 10c), and the batch-shard rounding of the microbatch count for a mesh
waits for tensor parallelism (item 3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.common import dtype_of
from repro_torch.models.lm import LM
from repro_torch.optimizer import adamw
from repro_torch.training import step as train_step_lib


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


@dataclasses.dataclass
class StepBundle:
    """One (arch x shape) cell's step: ``fn`` is ``train_step(state,
    batch)``, ``prefill(params, batch)`` or ``decode(params, caches,
    batch)``."""
    kind: str
    fn: Any
    static_meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


def make_step_bundle(cfg: ModelConfig, shape: ShapeConfig, *,
                     opt_cfg: Optional[adamw.AdamWConfig] = None,
                     microbatches: Optional[int] = None,
                     remat: bool = True, remat_group: int = 1,
                     accum_dtype: str = "float32") -> StepBundle:
    lm = LM(cfg, remat_group=remat_group)
    if shape.kind == "train":
        opt_cfg = opt_cfg or adamw.AdamWConfig()
        mb = microbatches or recommended_microbatches(cfg)
        fn = train_step_lib.make_train_step(lm, opt_cfg, microbatches=mb,
                                            remat=remat,
                                            accum_dtype=accum_dtype)
        return StepBundle("train", fn, {"microbatches": mb,
                                        "remat_group": remat_group,
                                        "moments_dtype":
                                            opt_cfg.moments_dtype,
                                        "accum_dtype": accum_dtype})
    capacity = shape.seq_len
    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            return lm.prefill(params, batch, capacity)
        return StepBundle("prefill", prefill_fn, {"capacity": capacity})
    return StepBundle("decode", lm.decode_step, {"capacity": capacity})


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
