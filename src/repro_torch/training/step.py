"""The train step: microbatched grad accumulation + AdamW update.

The port of ``src/repro/training/step.py``. On a mesh (``mesh=``, from
``launch.mesh.make_mesh``) the state's leaves are ``spmd.Placed`` and the
step is the reference's under ``sharding_ctx(mesh, TRAIN_RULES)``: each
gradient and fp32 accumulator lies where its parameter lies
(``shard_like_params``: an FSDP piece's gradient arrives reduce-scattered
through autograd, and a leaf replicated over an axis takes the sum of its
copies' partial gradients, held once by each copy). Every family trains
there; a batch's ``embeds`` or ``src_embeds`` split over "data" with its
tokens, as their ``batch_specs`` axes ``("batch", None, None)`` say. On a
multi-pod mesh ("pod", "data", "model") the batch splits over the pods
and data rows together, and a weight, whole across pods, sums its pods'
partial gradients with the rest of its copies'.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import (Mesh, TRAIN_RULES,
                                              batch_axes, mesh_axis_size)
from repro_torch.models.common import dtype_of
from repro_torch.models.lm import LM, check_mesh_support
from repro_torch.models.params import init_lm_params, param_specs
from repro_torch.optimizer import adamw
from repro_torch.tree import flatten, tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def mesh_microbatches(mb: int, global_batch: int,
                      mesh: Optional[Mesh]) -> int:
    """``mb`` halved until each microbatch still splits over the mesh's
    batch shards (``models/api.py``'s rule for a cell's step)."""
    if mesh is None:
        return mb
    shards = mesh_axis_size(mesh, batch_axes(mesh, TRAIN_RULES))
    while mb > 1 and (global_batch // mb) % shards != 0:
        mb //= 2
    return mb


def _pieces(fn, *xs):
    """``fn`` over a leaf's tensors: piece by piece for ``Placed``."""
    if spmd.is_placed(xs[0]):
        return xs[0].like([fn(*ps) for ps in zip(*(x.pieces for x in xs))])
    return fn(*xs)


def make_train_step(lm: LM, opt_cfg: adamw.AdamWConfig, *,
                    microbatches: int = 1, remat: bool = True,
                    accum_dtype: str = "float32",
                    mesh: Optional[Mesh] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``microbatches`` splits the batch on its leading axis into that many
    equal parts, run one after another (on a mesh too, as the reference's
    step: a microbatch that its pods and data rows do not divide is whole
    on every position, ``LM.train_loss``); their gradients accumulate in
    ``accum_dtype`` ("float32" or "bfloat16") and are divided by the count,
    and the loss is the mean of theirs. The step returns new tensors and
    leaves ``state`` as it was. With ``mesh`` the state is
    ``init_train_state(..., mesh=)``'s and the batch is whole.
    """
    acc_dt = dtype_of(accum_dtype)
    if mesh is not None:
        check_mesh_support(mesh)

    def loss_and_grads(params, batch):
        leaves, rebuild = flatten(params)
        with torch.enable_grad():
            if mesh is None:
                live = [p.detach().requires_grad_() for p in leaves]
                loss = lm.train_loss(rebuild(live), batch, remat=remat)
                grads = torch.autograd.grad(loss, live)
                return loss.detach(), rebuild(list(grads))
            live = [x.like([p.detach().requires_grad_() for p in x.pieces])
                    for x in leaves]
            loss = lm.train_loss(rebuild(live), batch, remat=remat,
                                 mesh=mesh)
            flat = [p for x in live for p in x.pieces]
            # a copy that fed nothing (a whole vocabulary's other model
            # shards) has no gradient: its share is 0
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        out, i = [], 0
        for x in live:
            gs = [g if g is not None else torch.zeros_like(p)
                  for g, p in zip(grads[i:i + len(x.pieces)], x.pieces)]
            out.append(spmd.sum_copies(x.like(gs)))   # shard_like_params
            i += len(x.pieces)
        return loss.detach(), rebuild(out)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        b = next(iter(batch.values())).shape[0]
        mbs = microbatches
        if mbs == 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            if b % mbs:
                raise ValueError(f"batch {b} does not split into "
                                 f"{mbs} microbatches")
            n = b // mbs
            first = tree_leaves(params)[0]
            loss = torch.zeros((), dtype=torch.float32, device=(
                first.mesh.devices[0] if mesh is not None else first.device))
            grads = tree_map(lambda p: _pieces(
                lambda t: torch.zeros(t.shape, dtype=acc_dt,
                                      device=t.device), p), params)
            for i in range(mbs):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                mb_loss, mb_grads = loss_and_grads(params, mb)
                loss = loss + mb_loss
                grads = tree_map(lambda a, g: _pieces(
                    lambda x, y: x + y.to(acc_dt), a, g), grads, mb_grads)
                del mb_grads
            # products with 1/n, as XLA compiles the reference's divisions
            loss = loss * (1.0 / mbs)
            grads = tree_map(lambda g: _pieces(lambda t: t * (1.0 / mbs), g),
                             grads)
        new_params, new_opt, metrics = adamw.apply_update(
            params, grads, state.opt, opt_cfg)
        metrics["loss"] = loss
        return TrainState(new_params, new_opt), metrics

    return train_step


def init_train_state(lm: LM, generator: torch.Generator,
                     opt_cfg: adamw.AdamWConfig, device, *,
                     mesh: Optional[Mesh] = None) -> TrainState:
    """Weights drawn from ``generator`` (on ``device``) by
    ``init_lm_params``, and zero moments. With ``mesh`` each weight is
    placed over it under ``TRAIN_RULES`` as soon as it is drawn, with its
    moments, so ``device`` never holds more than its pieces and one whole
    leaf; the state equals ``place_state`` of the one drawn with no
    mesh."""
    if mesh is None:
        params = init_lm_params(lm.cfg, generator, device)
        return TrainState(params, adamw.init_state(params, opt_cfg))
    moments = {}

    def place(w, axes):
        opt = adamw.init_state(w, opt_cfg)
        ax = adamw.state_logical_axes((tuple(axes), tuple(w.shape)),
                                      opt_cfg)
        p = spmd.place(w, axes, mesh, TRAIN_RULES)
        moments[id(p)] = spmd.place_tree((opt.m, opt.v), (ax.m, ax.v),
                                         mesh, TRAIN_RULES)
        return p

    params = init_lm_params(lm.cfg, generator, device, place=place)
    step = spmd.place(torch.zeros((), dtype=torch.int32, device=device), (),
                      mesh, TRAIN_RULES)
    return TrainState(params, adamw.AdamWState(
        step=step, m=tree_map(lambda p: moments[id(p)][0], params),
        v=tree_map(lambda p: moments[id(p)][1], params)))


def place_state(lm: LM, opt_cfg: adamw.AdamWConfig, state: TrainState,
                mesh: Mesh) -> TrainState:
    """A whole train state laid over ``mesh`` by its logical axes under
    ``TRAIN_RULES``."""
    return spmd.place_tree(state, train_state_logical_axes(lm, opt_cfg),
                           mesh, TRAIN_RULES)


def train_state_structs(lm: LM, opt_cfg: adamw.AdamWConfig) -> TrainState:
    """``TensorSpec`` tree matching ``init_train_state``."""
    ps = param_specs(lm.cfg)
    return TrainState(ps, adamw.state_structs(ps, opt_cfg))


def train_state_logical_axes(lm: LM, opt_cfg: adamw.AdamWConfig
                             ) -> TrainState:
    """``(logical axes, shape)`` tree matching ``train_state_structs``."""
    ax = lm.param_axes()
    return TrainState(ax, adamw.state_logical_axes(ax, opt_cfg))
