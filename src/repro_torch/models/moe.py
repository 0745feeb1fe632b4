"""Mixture-of-Experts FFN with static-capacity dispatch.

The port of the single-device branch of ``moe_ffn`` and of ``_moe_local``
(``src/repro/models/moe.py:29-80``), which the reference computes in jnp
outside any Pallas kernel; plain PyTorch (``torch.bmm`` for the expert
products) is their counterpart. Each token's router logits (fp32) pick
its top-k experts, ties to the lower expert index as ``jax.lax.top_k``
breaks them, and a softmax over those k logits weighs them. Every expert
takes at most ``cap = max(ceil(T·k/E · capacity_factor), 1)`` of the
call's T tokens, in token-major order of the flattened ``(T·k)``
assignments; the rest are dropped (scattered to a trash expert row and
never gathered). The expert FFN is SwiGLU with silu in fp32; the weighted
combine is in fp32, then cast to the input's dtype.

Note that at ``T = 1`` (a decode step) ``cap`` is 1 and the products read
every expert's weights, as the reference's do.

The expert-parallel branch (``shard_map`` over a "model" mesh axis) waits
for tensor parallelism (ROADMAP.md §1 item 7b).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import MoEConfig


class Routing(NamedTuple):
    top_idx: torch.Tensor    # (T, k) expert of each assignment
    weights: torch.Tensor    # (T, k) fp32 softmax over the k logits
    pos: torch.Tensor        # (T*k,) slot within its expert
    keep: torch.Tensor       # (T*k,) False: dropped (past capacity)
    cap: int                 # slots per expert


def route(xf: torch.Tensor, router_w: torch.Tensor,
          mcfg: MoEConfig) -> Routing:
    """The dispatch plan of ``_moe_local`` for xf (T, d)."""
    T = xf.shape[0]
    E, k = router_w.shape[1], mcfg.top_k
    logits = xf.float() @ router_w.float()                  # (T, E)
    # a stable descending sort keeps equal logits in index order
    top_vals, top_idx = torch.sort(logits, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[:, :k], top_idx[:, :k]
    weights = torch.softmax(top_vals, dim=-1)
    cap = max(int(math.ceil(T * k / E * mcfg.capacity_factor)), 1)
    # one_hot itself would read the indices back to the host to check them
    onehot = (top_idx.reshape(-1, 1) == torch.arange(
        E, device=xf.device)).long()                       # (T*k, E)
    pos = ((onehot.cumsum(dim=0) - onehot) * onehot).sum(dim=-1)
    return Routing(top_idx, weights, pos, pos < cap, cap)


def _moe_local(xf: torch.Tensor, p: dict, mcfg: MoEConfig) -> torch.Tensor:
    T, d = xf.shape
    E, k = p["w_gate"].shape[0], mcfg.top_k
    r = route(xf, p["router"], mcfg)
    safe_e = torch.where(r.keep, r.top_idx.reshape(-1), E)  # E: the trash row
    slot = r.pos.clamp(max=r.cap - 1)
    tok_of = torch.arange(T * k, device=xf.device) // k
    x_e = xf.new_zeros((E + 1, r.cap, d))
    x_e[safe_e, slot] = xf[tok_of]
    x_e = x_e[:E]
    g = torch.bmm(x_e, p["w_gate"])
    u = torch.bmm(x_e, p["w_up"])
    h = torch.nn.functional.silu(g.float()).to(xf.dtype) * u
    y_e = torch.bmm(h, p["w_down"])                         # (E, cap, d)
    y_tk = y_e[safe_e.clamp(max=E - 1), slot]               # (T*k, d)
    y_tk = torch.where(r.keep[:, None], y_tk, 0)
    y_tk = y_tk.float() * r.weights.reshape(-1)[:, None]
    return y_tk.reshape(T, k, d).sum(dim=1).to(xf.dtype)


def moe_ffn(x: torch.Tensor, params: dict, mcfg: MoEConfig, *,
            mesh=None) -> torch.Tensor:
    """x: (B, S, d). params: router (d, E), w_gate/w_up (E, d, f), w_down
    (E, f, d). The tokens of the whole call share the capacity."""
    if mesh is not None:
        raise NotImplementedError(
            "expert parallelism over a mesh is not ported yet "
            "(ROADMAP.md §1 item 7b)")
    B, S, d = x.shape
    return _moe_local(x.reshape(B * S, d), params, mcfg).reshape(B, S, d)
