"""Model inputs and step functions per (architecture, shape) cell: the
step's input specs with their logical axes, demo inputs that match them,
the training microbatch knob, and the step callable with everything the
dry-run needs to lay it over a mesh.

The port of ``recommended_microbatches``, ``_frontend_len``,
``batch_specs``, ``StepBundle``, ``make_step_bundle`` and
``make_demo_inputs`` (``src/repro/models/api.py``). ``make_demo_inputs``
draws from ``numpy.random.default_rng(0)`` in the reference's order, so
both packages get equal inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding
from repro_torch.models.common import (ArraySpec, dtype_of,
                                       specs_logical_axes, specs_to_structs)
from repro_torch.models.lm import LM
from repro_torch.optimizer import adamw
from repro_torch.training import step as train_step_lib


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


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, ArraySpec]:
    """The step's data inputs: tokens (and labels and mask to train) whose
    length leaves room for a decoder's frontend embeddings, ``embeds`` or an
    encoder's ``src_embeds``; or a decode step's token and cache_len."""
    B, S = shape.global_batch, shape.seq_len
    F = _frontend_len(cfg)
    is_encdec = cfg.num_encoder_layers > 0
    out: Dict[str, ArraySpec] = {}
    if shape.kind in ("train", "prefill"):
        tok_len = S - F if (F and not is_encdec) else S
        out["tokens"] = ArraySpec((B, tok_len), "int32", ("batch", None))
        if shape.kind == "train":
            out["labels"] = ArraySpec((B, tok_len), "int32", ("batch", None))
            out["mask"] = ArraySpec((B, tok_len), "float32", ("batch", None))
        if F and not is_encdec:
            out["embeds"] = ArraySpec((B, F, cfg.frontend.embed_dim),
                                      "bfloat16", ("batch", None, None))
        if is_encdec:
            out["src_embeds"] = ArraySpec((B, F, cfg.frontend.embed_dim),
                                          "bfloat16", ("batch", None, None))
    else:  # decode
        out["token"] = ArraySpec((B,), "int32", ("batch",))
        out["cache_len"] = ArraySpec((), "int32", ())
    return out


@dataclasses.dataclass
class StepBundle:
    """One (arch x shape) cell's step: ``fn`` is ``train_step(state,
    batch)``, ``prefill(params, batch)`` or ``decode(params, caches,
    batch)``. ``args_structs`` are its positional arguments as
    ``TensorSpec`` trees and ``args_axes`` their ``(logical axes, shape)``
    trees; ``donate`` lists the arguments the caller hands over (the decode
    step writes its caches in place; the train step's result replaces its
    state); ``byte_groups`` are the (structs, axes) subtrees of the memory
    model's groups ("weights", "opt", "cache")."""
    kind: str
    fn: Any
    args_structs: Tuple = ()
    args_axes: Tuple = ()
    out_axes: Any = None
    donate: Tuple[int, ...] = ()
    static_meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    byte_groups: Dict[str, Tuple] = dataclasses.field(default_factory=dict)


def _mesh_microbatches(mb: int, global_batch: int) -> int:
    """Under the active mesh, halve ``mb`` until each microbatch still
    splits over the batch shards."""
    return train_step_lib.mesh_microbatches(mb, global_batch,
                                            sharding.current_mesh())


def make_step_bundle(cfg: ModelConfig, shape: ShapeConfig, *,
                     opt_cfg: Optional[adamw.AdamWConfig] = None,
                     microbatches: Optional[int] = None,
                     remat: bool = True, remat_group: int = 1,
                     moments_dtype: str = "float32",
                     accum_dtype: str = "float32") -> StepBundle:
    lm = LM(cfg, remat_group=remat_group)
    bspecs = batch_specs(cfg, shape)
    batch_structs = specs_to_structs(bspecs)
    batch_axes = specs_logical_axes(bspecs)
    if shape.kind == "train":
        opt_cfg = opt_cfg or adamw.AdamWConfig(moments_dtype=moments_dtype)
        mb = _mesh_microbatches(microbatches or recommended_microbatches(cfg),
                                shape.global_batch)
        fn = train_step_lib.make_train_step(lm, opt_cfg, microbatches=mb,
                                            remat=remat,
                                            accum_dtype=accum_dtype)
        state_structs = train_step_lib.train_state_structs(lm, opt_cfg)
        state_axes = train_step_lib.train_state_logical_axes(lm, opt_cfg)
        return StepBundle(
            "train", fn, (state_structs, batch_structs),
            (state_axes, batch_axes), donate=(0,),
            static_meta={"microbatches": mb, "remat_group": remat_group,
                         "moments_dtype": opt_cfg.moments_dtype,
                         "accum_dtype": accum_dtype},
            byte_groups={
                "weights": (state_structs.params, state_axes.params),
                "opt": (state_structs.opt, state_axes.opt)})
    param_structs = lm.param_structs()
    param_axes = lm.param_axes()
    capacity = shape.seq_len
    src_len = _frontend_len(cfg) if cfg.num_encoder_layers else 0
    cache_specs = lm.cache_specs(shape.global_batch, capacity, src_len)
    cache_structs = specs_to_structs(cache_specs)
    cache_axes = specs_logical_axes(cache_specs)
    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            return lm.prefill(params, batch, capacity)
        logits = (("batch", "vocab"), (shape.global_batch, cfg.vocab_size))
        return StepBundle("prefill", prefill_fn,
                          (param_structs, batch_structs),
                          (param_axes, batch_axes),
                          out_axes=(logits, cache_axes),
                          static_meta={"capacity": capacity},
                          byte_groups={
                              "weights": (param_structs, param_axes),
                              "cache": (cache_structs, cache_axes)})
    return StepBundle("decode", lm.decode_step,
                      (param_structs, cache_structs, batch_structs),
                      (param_axes, cache_axes, batch_axes),
                      donate=(1,), static_meta={"capacity": capacity},
                      byte_groups={"weights": (param_structs, param_axes),
                                   "cache": (cache_structs, cache_axes)})


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
