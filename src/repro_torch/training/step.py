"""The train step: microbatched grad accumulation + AdamW update.

The port of ``src/repro/training/step.py``. The reference's
``shard_like_params`` (gradient buffers laid out like the FSDP-sharded
parameters) has no counterpart on one device and is dropped; sharding waits
for tensor parallelism (ROADMAP.md §1 item 3).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.models.common import dtype_of
from repro_torch.models.lm import LM
from repro_torch.models.params import init_lm_params, param_specs
from repro_torch.optimizer import adamw
from repro_torch.tree import flatten, tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def make_train_step(lm: LM, opt_cfg: adamw.AdamWConfig, *,
                    microbatches: int = 1, remat: bool = True,
                    accum_dtype: str = "float32"):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``microbatches`` splits the batch on its leading axis into that many
    equal parts, run one after another; their gradients accumulate in
    ``accum_dtype`` ("float32" or "bfloat16") and are divided by the count,
    and the loss is the mean of theirs. The step returns new tensors and
    leaves ``state`` as it was.
    """
    acc_dt = dtype_of(accum_dtype)

    def loss_and_grads(params, batch):
        leaves, rebuild = flatten(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in leaves]
            loss = lm.train_loss(rebuild(live), batch, remat=remat)
            grads = torch.autograd.grad(loss, live)
        return loss.detach(), rebuild(list(grads))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        if microbatches == 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            n = b // microbatches
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                                   device=p.device), params)
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                mb_loss, mb_grads = loss_and_grads(params, mb)
                loss = loss + mb_loss
                grads = tree_map(lambda a, g: a + g.to(acc_dt), grads,
                                 mb_grads)
                del mb_grads
            # products with 1/n, as XLA compiles the reference's divisions
            loss = loss * (1.0 / microbatches)
            grads = tree_map(lambda g: g * (1.0 / microbatches), grads)
        new_params, new_opt, metrics = adamw.apply_update(
            params, grads, state.opt, opt_cfg)
        metrics["loss"] = loss
        return TrainState(new_params, new_opt), metrics

    return train_step


def init_train_state(lm: LM, generator: torch.Generator,
                     opt_cfg: adamw.AdamWConfig, device) -> TrainState:
    """Weights drawn from ``generator`` (on ``device``) by
    ``init_lm_params``, and zero moments."""
    params = init_lm_params(lm.cfg, generator, device)
    return TrainState(params, adamw.init_state(params, opt_cfg))


def train_state_structs(lm: LM, opt_cfg: adamw.AdamWConfig) -> TrainState:
    """``TensorSpec`` tree matching ``init_train_state``."""
    ps = param_specs(lm.cfg)
    return TrainState(ps, adamw.state_structs(ps, opt_cfg))


def train_state_logical_axes(lm: LM, opt_cfg: adamw.AdamWConfig
                             ) -> TrainState:
    """``(logical axes, shape)`` tree matching ``train_state_structs``."""
    ax = lm.param_axes()
    return TrainState(ax, adamw.state_logical_axes(ax, opt_cfg))
