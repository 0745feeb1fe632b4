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

Under a mesh (``moe_ffn(..., mesh=...)``, and the LM's mesh path through
:func:`moe_shard`) this is the reference's ``shard_map`` branch
(``src/repro/models/moe.py:77-127``): each data shard routes only its own
tokens, so the capacity counts them, not the whole batch's; each model
shard owns ``E/M`` experts from ``index·E/M``, routes with the global
router, keeps the assignments to its experts and adds its partial combine
to the others' (an all-reduce over "model"). When ``M`` does not divide
``E`` the reference takes ``ep = gcd(E, M)`` but keeps every expert on
every shard and adds nothing, while ``ep`` still divides the capacity:
``cap = ceil(T·k/(E·ep)·capacity_factor)``. The port does the same
(ROADMAP.md §3 logs it as a quirk of the reference). A serving mesh's
decode step (:func:`moe_decode_shards`, under ``DECODE_RULES``) keeps the
experts where they lie and the batch whole, so its capacity counts the
whole batch, as the reference's replicated batch does; d splits over
"data", and the router's and the expert products' partial sums over it
are all-reduced instead of gathering the weights.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed import spmd


class Routing(NamedTuple):
    top_idx: torch.Tensor    # (T, k) expert of each assignment
    weights: torch.Tensor    # (T, k) fp32 softmax over the k logits
    pos: torch.Tensor        # (T*k,) slot within its expert
    keep: torch.Tensor       # (T*k,) False: dropped (past capacity)
    cap: int                 # slots per expert


def route(xf: torch.Tensor, router_w: torch.Tensor,
          mcfg: MoEConfig, cap_experts: int = 0) -> Routing:
    """The dispatch plan of ``_moe_local`` for xf (T, d); the capacity
    divides the T·k assignments over ``cap_experts`` (the reference's
    ``e_local · ep_size``; all E experts by default)."""
    return route_logits(xf.float() @ router_w.float(), mcfg, cap_experts)


def route_logits(logits: torch.Tensor, mcfg: MoEConfig,
                 cap_experts: int = 0) -> Routing:
    """``route`` from the router's fp32 logits (T, E)."""
    T, E = logits.shape
    k = mcfg.top_k
    # a stable descending sort keeps equal logits in index order
    top_vals, top_idx = torch.sort(logits, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[:, :k], top_idx[:, :k]
    weights = torch.softmax(top_vals, dim=-1)
    cap = max(int(math.ceil(T * k / (cap_experts or E)
                            * mcfg.capacity_factor)), 1)
    # one_hot itself would read the indices back to the host to check them
    onehot = (top_idx.reshape(-1, 1) == torch.arange(
        E, device=logits.device)).long()                    # (T*k, E)
    pos = ((onehot.cumsum(dim=0) - onehot) * onehot).sum(dim=-1)
    return Routing(top_idx, weights, pos, pos < cap, cap)


def _slots(r: Routing, e_local: int, e_start: int, num_experts: int):
    """(kept, expert row, slot) of each of the T·k assignments among the
    ``e_local`` experts from ``e_start``; row ``e_local`` is the trash."""
    local = r.top_idx.reshape(-1) - e_start
    keep = r.keep
    if e_local != num_experts:
        keep = keep & (local >= 0) & (local < e_local)
    return keep, torch.where(keep, local, e_local), r.pos.clamp(max=r.cap - 1)


def _dispatch(xf: torch.Tensor, slots, e_local: int, cap: int, k: int
              ) -> torch.Tensor:
    """The (e_local, cap, d) expert inputs from xf (T, d)."""
    _, safe_e, slot = slots
    T, d = xf.shape
    tok_of = torch.arange(T * k, device=xf.device) // k
    x_e = xf.new_zeros((e_local + 1, cap, d))
    x_e[safe_e, slot] = xf[tok_of]
    return x_e[:e_local]


def _combine(y_e: torch.Tensor, slots, r: Routing, T: int) -> torch.Tensor:
    """The weighted fp32 sum (T, d) of each token's kept expert outputs
    from y_e (e_local, cap, d)."""
    keep, safe_e, slot = slots
    k = r.top_idx.shape[1]
    y_tk = y_e[safe_e.clamp(max=y_e.shape[0] - 1), slot]    # (T*k, d)
    y_tk = torch.where(keep[:, None], y_tk, 0)
    y_tk = y_tk.float() * r.weights.reshape(-1)[:, None]
    return y_tk.reshape(T, k, -1).sum(dim=1)


def _moe_local(xf: torch.Tensor, p: dict, mcfg: MoEConfig,
               e_start: int = 0, ep_size: int = 1) -> torch.Tensor:
    """The combine of xf (T, d) over the experts ``p`` holds, the
    ``e_local`` from ``e_start`` of the router's E (a partial sum when
    they are not all)."""
    T = xf.shape[0]
    E = p["w_gate"].shape[0]
    r = route(xf, p["router"], mcfg, cap_experts=E * ep_size)
    slots = _slots(r, E, e_start, p["router"].shape[1])
    x_e = _dispatch(xf, slots, E, r.cap, mcfg.top_k)
    g = torch.bmm(x_e, p["w_gate"])
    u = torch.bmm(x_e, p["w_up"])
    h = torch.nn.functional.silu(g.float()).to(xf.dtype) * u
    y_e = torch.bmm(h, p["w_down"])                         # (E, cap, d)
    return _combine(y_e, slots, r, T).to(xf.dtype)


def expert_parallelism(num_experts: int, model: int) -> int:
    """The reference's ``ep``: the "model" axis size where it divides the
    experts, else their gcd (the experts then stay whole on every
    shard)."""
    return model if num_experts % model == 0 else math.gcd(num_experts,
                                                           model)


def moe_batch_axes(mesh, batch: int) -> tuple:
    """The mesh axes the reference's ``shard_map`` splits a batch of
    ``batch`` rows over: the batch's axes ("pod", "data", those the mesh
    has), dropped from the front until their positions divide it (the
    whole batch on every position where none do). Unlike ``pspec_for``,
    which drops them all at once, a batch of 2 on a (2, 2, 2) mesh keeps
    "data" here."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    while axes and batch % math.prod(mesh.shape[a] for a in axes):
        axes = axes[1:]
    return axes


def moe_shard(xs, ps, mcfg: MoEConfig, mesh):
    """The expert-parallel branch over per-position tensors: ``xs[r]`` a
    data shard's activations (b, S, d), ``ps[r]`` the experts position
    ``r`` holds (all E, or ``E/M`` when M divides E) with the global
    router. Returns each position's output, the partial combines
    all-reduced over "model" when the experts are split."""
    M = mesh.shape.get("model", 1)
    E = ps[0]["router"].shape[1]
    ep = expert_parallelism(E, M)
    outs = []
    for r, (x, p) in enumerate(zip(xs, ps)):
        b, S, d = x.shape
        e_local = p["w_gate"].shape[0]
        e_start = mesh.axis_index(r, "model") * e_local if e_local != E \
            else 0
        outs.append(_moe_local(x.reshape(b * S, d), p, mcfg, e_start,
                               ep).reshape(b, S, d))
    if ps[0]["w_gate"].shape[0] != E:
        outs = spmd.all_reduce(outs, mesh, "model")
    return outs


def moe_decode_shards(hs, ps, mcfg: MoEConfig, mesh, split: bool):
    """One decode step's MoE FFN over the mesh, weight-stationary
    (``DECODE_RULES``): ``hs[r]`` position r's piece (T, d / D) of the
    normed tokens, split over "data" along d and whole in T; ``ps[r]`` its
    pieces of the experts it holds (``w_gate``/``w_up`` (E/M, d / D, f) on
    their d rows, ``w_down`` (E/M, f, d / D) on its d columns) and of the
    router (d / D, E). The router's fp32 logits and the ``w_gate``/``w_up``
    products are partial sums over the d pieces, all-reduced over "data";
    every position routes the whole batch (its capacity counts all T
    tokens, as the reference's replicated batch does); ``w_down`` gives
    each position its d piece of its experts' outputs, whose fp32 combine
    is all-reduced over "model" where the experts split. ``split``: d is
    split over "data" (else every piece holds all of it and nothing is
    summed over "data"). The weights are never gathered. Returns each
    position's (T, d / D) output."""
    M = mesh.shape.get("model", 1)
    E = ps[0]["router"].shape[1]
    ep = expert_parallelism(E, M)
    def over_data(parts):
        return spmd.all_reduce(parts, mesh, "data") if split else parts

    logits = over_data([h.float() @ p["router"].float()
                        for h, p in zip(hs, ps)])
    plans, gs, us = [], [], []
    for r, (h, p, z) in enumerate(zip(hs, ps, logits)):
        e_local = p["w_gate"].shape[0]
        e_start = mesh.axis_index(r, "model") * e_local if e_local != E \
            else 0
        rt = route_logits(z, mcfg, cap_experts=e_local * ep)
        slots = _slots(rt, e_local, e_start, E)
        x_e = _dispatch(h, slots, e_local, rt.cap, mcfg.top_k)
        gs.append(torch.bmm(x_e, p["w_gate"]))
        us.append(torch.bmm(x_e, p["w_up"]))
        plans.append((rt, slots))
    gs, us = over_data(gs), over_data(us)
    outs = []
    for h, p, g, u, (rt, slots) in zip(hs, ps, gs, us, plans):
        a = torch.nn.functional.silu(g.float()).to(h.dtype) * u
        outs.append(_combine(torch.bmm(a, p["w_down"]), slots, rt,
                             h.shape[0]))
    if ps[0]["w_gate"].shape[0] != E:
        outs = spmd.all_reduce(outs, mesh, "model")
    return [o.to(h.dtype) for o, h in zip(outs, hs)]


def moe_ffn(x: torch.Tensor, params: dict, mcfg: MoEConfig, *,
            mesh=None) -> torch.Tensor:
    """x: (B, S, d). params: router (d, E), w_gate/w_up (E, d, f), w_down
    (E, f, d). With no mesh the tokens of the whole call share the
    capacity. With a mesh of devices (``launch.mesh.make_mesh``; axes
    "data" and "model", and "pod" ahead of them) it is the reference's
    ``shard_map`` branch: x's rows split over ``moe_batch_axes`` (whole on
    every position when none divide), the experts over "model" as
    ``expert_parallelism`` says, and the result comes back whole on x's
    device."""
    B, S, d = x.shape
    if mesh is None:
        return _moe_local(x.reshape(B * S, d), params, mcfg).reshape(B, S,
                                                                     d)
    if mesh.devices is None:
        raise ValueError("moe_ffn over a mesh needs its devices "
                         "(launch.mesh.make_mesh)")
    M = mesh.shape.get("model", 1)
    E = params["w_gate"].shape[0]
    split = expert_parallelism(E, M) == M and M > 1
    axes = moe_batch_axes(mesh, B)
    rows = B // math.prod(mesh.shape[a] for a in axes)
    xs, ps = [], []
    for r in range(mesh.size):
        dev = mesh.devices[r]
        i = spmd.piece_index((axes,), mesh, r)[0]
        xs.append(x[i * rows:(i + 1) * rows].to(dev))
        j = mesh.axis_index(r, "model")
        experts = slice(j * E // M, (j + 1) * E // M) if split else \
            slice(0, E)
        ps.append({k: (w if k == "router" else w[experts]).to(dev)
                   for k, w in params.items()})
    outs = moe_shard(xs, ps, mcfg, mesh)
    return torch.cat([outs[r].to(x.device)
                      for r in spmd.groups(mesh, *axes)[0]], dim=0)
