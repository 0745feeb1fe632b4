"""AdamW with optional 8-bit (blockwise-quantized) moments.

The port of ``src/repro/optimizer/adamw.py`` over the port's weight tree
(nested dicts and lists of tensors, ``models/params.py``):

  - ``moments_dtype="int8"`` stores m/v as int8 with per-block fp32 scales
    (8-bit-Adam style), a 4x memory cut on the optimizer state; v is stored
    as sqrt(v) (``sqrt_map``) to compress its dynamic range;
  - blocks are the largest power of two <= 256 dividing a tensor's last dim
    (``_block_of``), so quantization keeps every tensor's shape;
  - codes round half to even (``torch.round``, as ``jnp.round``);
  - a division by a constant is a product with its fp32 reciprocal, as XLA
    compiles the reference's (its train step always runs under ``jit``);
  - the update runs in fp32 and is cast back to the parameter's dtype; the
    step's scalars (clip, warmup, bias corrections) are fp32 tensors, as the
    reference's are.

``state_logical_axes`` gives the state's logical axes: the moments
inherit their parameters', the int8 scales drop the last axis. On a mesh
(``spmd.Placed`` leaves, ``training/step.py``) every distinct piece is
updated once, then copied to the positions that hold it; where a leaf's
last dim is split, its pieces along that dim are joined first, so the int8
blocks and their scales are those of the whole last dim (a block may
straddle two pieces) and a sharded moment stores exactly the unsharded
one's codes and scales. The gradient norm counts each distinct piece once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import is_axes_leaf
from repro_torch.tree import tree_leaves, tree_map

BLOCK = 256


def _block_of(last_dim: int) -> int:
    """Largest power-of-two block <= BLOCK dividing the last dim exactly:
    shape-preserving quantization (no reshape, no padding)."""
    return max(math.gcd(last_dim, BLOCK), 1)


def _blockwise_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (..., L) -> (int8 (..., L), fp32 scales (..., L/block)); a 0-d
    tensor is quantized as shape (1,)."""
    if x.ndim == 0:
        x = x[None]
    L = x.shape[-1]
    b = _block_of(L)
    g = x.reshape(*x.shape[:-1], L // b, b)
    # amax * fp32(1/127): XLA compiles the reference's ``/ 127.0`` into this
    # product, and the reference's train step always runs compiled
    scale = torch.clamp(g.abs().amax(dim=-1) * (1.0 / 127.0), min=1e-12)
    q = torch.clamp(torch.round(g / scale[..., None]), -127, 127)
    return q.reshape(x.shape).to(torch.int8), scale


def _blockwise_dequant(q: torch.Tensor, scale: torch.Tensor,
                       shape) -> torch.Tensor:
    L = q.shape[-1]
    b = _block_of(L)
    g = q.float().reshape(*q.shape[:-1], L // b, b)
    return (g * scale[..., None]).reshape(q.shape).reshape(shape)


class Quantized(NamedTuple):
    q: torch.Tensor
    scale: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moments_dtype: str = "float32"   # "float32" | "bfloat16" | "int8"
    warmup_steps: int = 100


class AdamWState(NamedTuple):
    step: torch.Tensor    # 0-d int32
    m: Any
    v: Any


class _Update(NamedTuple):
    p: torch.Tensor
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype (the counterpart of a ShapeDtypeStruct);
    a leaf of any tree."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _store(x: torch.Tensor, mode: str, sqrt_map: bool = False):
    if mode == "int8":
        # v spans many decades: quantize sqrt(v); x >= 0 when sqrt_map is set
        if sqrt_map:
            x = torch.sqrt(torch.clamp(x, min=0.0))
        return Quantized(*_blockwise_quant(x))
    if mode == "bfloat16":
        return x.to(torch.bfloat16)
    return x


def _load(x, shape, mode: str, sqrt_map: bool = False) -> torch.Tensor:
    if mode == "int8":
        out = _blockwise_dequant(x.q, x.scale, shape)
        return torch.square(out) if sqrt_map else out
    return x.float()


def init_state(params, cfg: AdamWConfig) -> AdamWState:
    def zeros():
        return tree_map(lambda p: _store(torch.zeros(
            p.shape, dtype=torch.float32, device=p.device),
            cfg.moments_dtype), params)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros(), v=zeros())


def state_structs(param_specs, cfg: AdamWConfig) -> AdamWState:
    """``TensorSpec`` tree matching ``init_state`` for a tree of parameters
    (anything with ``shape`` and ``dtype``)."""
    def one(p):
        shape = tuple(p.shape)
        if cfg.moments_dtype == "int8":
            shape = shape or (1,)
            L = shape[-1]
            return Quantized(TensorSpec(shape, torch.int8),
                             TensorSpec(shape[:-1] + (L // _block_of(L),),
                                        torch.float32))
        dt = (torch.bfloat16 if cfg.moments_dtype == "bfloat16"
              else torch.float32)
        return TensorSpec(shape, dt)
    return AdamWState(step=TensorSpec((), torch.int32),
                      m=tree_map(one, param_specs),
                      v=tree_map(one, param_specs))


def state_logical_axes(param_axes, cfg: AdamWConfig) -> AdamWState:
    """``(logical axes, shape)`` tree matching ``state_structs`` for a tree
    of parameter ``(logical axes, shape)`` leaves: shape-preserving int8
    moments inherit the parameter axes (their scales drop the last
    axis)."""
    def one(ax_shape):
        axes, shape = ax_shape
        if cfg.moments_dtype == "int8":
            shp = shape if shape else (1,)
            ax = axes if shape else (None,)
            L = shp[-1]
            return Quantized((ax, shp), (ax[:-1] + (None,),
                                         shp[:-1] + (L // _block_of(L),)))
        return (axes, shape)
    return AdamWState(step=((), ()),
                      m=tree_map(one, param_axes, is_leaf=is_axes_leaf),
                      v=tree_map(one, param_axes, is_leaf=is_axes_leaf))


def _square_sum(g) -> torch.Tensor:
    if not spmd.is_placed(g):
        return torch.sum(torch.square(g.float()))
    root = g.mesh.devices[0]
    return sum(torch.sum(torch.square(g.pieces[m[0]].float())).to(root)
               for m in g.holders())


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(_square_sum(g) for g in tree_leaves(grads)))


def _rows(p: "spmd.Placed"):
    """The distinct pieces of ``p`` in units of whole last-dim rows: for
    each setting of the other dims' pieces, the holders of each piece
    along the last dim, in order."""
    nd = len(p.shape)
    split = len(p.spec) == nd and spmd.pieces_per_dim(p.spec, p.mesh)[-1] > 1
    units = {}
    for members in p.holders():
        idx = spmd.piece_index(p.spec, p.mesh, members[0])
        units.setdefault(idx[:nd - 1] if split else idx, []).append(members)
    return list(units.values())


def _update_placed(upd, p, g, m_s, v_s, int8: bool):
    """``upd`` over a ``Placed`` leaf: once a unit of ``_rows``, on its
    first holder's device, then split and copied to every holder."""
    mesh = p.mesh
    new = [[None] * mesh.size for _ in range(3)]
    q_new = [[None] * mesh.size for _ in range(2)]
    for unit in _rows(p):
        reps = [members[0] for members in unit]
        dev = mesh.devices[reps[0]]

        def join(x):
            parts = [x.pieces[r].to(dev) for r in reps]
            return parts[0] if len(parts) == 1 else torch.cat(parts, -1)

        def moment(x):
            return Quantized(join(x.q), x.scale.pieces[reps[0]]) if int8 \
                else join(x)

        res = upd(join(p), join(g), moment(m_s), moment(v_s))
        sizes = [p.pieces[r].shape[-1] for r in reps]

        def split(t):
            """The unit's pieces, each owning its storage."""
            if len(reps) == 1:
                return [t]
            return [c.clone() for c in torch.split(t, sizes, -1)]

        for k, out in enumerate(res):
            codes = out.q if int8 and k else out
            for members, piece in zip(unit, split(codes)):
                for r in members:
                    new[k][r] = piece.to(mesh.devices[r])
                    if int8 and k:
                        q_new[k - 1][r] = out.scale.to(mesh.devices[r])
    pl = p.like(new[0])
    if not int8:
        return _Update(pl, m_s.like(new[1]), v_s.like(new[2]))
    return _Update(pl, Quantized(m_s.q.like(new[1]), m_s.scale.like(q_new[0])),
                   Quantized(v_s.q.like(new[2]), v_s.scale.like(q_new[1])))


@torch.no_grad()
def apply_update(params, grads, state: AdamWState, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics); the inputs are not
    modified."""
    if spmd.is_placed(state.step):
        step = state.step.like([s + 1 for s in state.step.pieces])
        stepf = step.pieces[0].float()
    else:
        step = state.step + 1
        stepf = step.float()
    gnorm = _global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.grad_clip > 0 else 1.0)
    warm = torch.clamp(stepf * (1.0 / max(cfg.warmup_steps, 1)), max=1.0)
    lr = cfg.lr * warm
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)

    scalars = {}

    def on(dev):
        """The step's scalars on ``dev`` (a mesh may span cards)."""
        if dev not in scalars:
            scalars[dev] = tuple(t.to(dev) if torch.is_tensor(t) else t
                                 for t in (clip, lr, b1c, b2c))
        return scalars[dev]

    def upd(p, g, m_s, v_s):
        clip, lr, b1c, b2c = on(p.device)
        g = g.float() * clip
        m = _load(m_s, p.shape, cfg.moments_dtype)
        v = _load(v_s, p.shape, cfg.moments_dtype, sqrt_map=True)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh, vh = m / b1c, v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        return _Update(new_p, _store(m, cfg.moments_dtype),
                       _store(v, cfg.moments_dtype, sqrt_map=True))

    def upd_leaf(p, g, m_s, v_s):
        if spmd.is_placed(p):
            return _update_placed(upd, p, g, m_s, v_s,
                                  cfg.moments_dtype == "int8")
        return upd(p, g, m_s, v_s)

    out = tree_map(upd_leaf, params, grads, state.m, state.v)
    pick = lambda i: tree_map(lambda o: o[i], out,  # noqa: E731
                              is_leaf=lambda x: isinstance(x, _Update))
    return pick(0), AdamWState(step, pick(1), pick(2)), {"grad_norm": gnorm,
                                                         "lr": lr}
