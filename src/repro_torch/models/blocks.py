"""Per-layer blocks of the ``LM``: layer specs, cache layout, and the
sequence (``apply_layer_seq``) and one-token (``apply_layer_decode``)
paths.

The port of ``src/repro/models/blocks.py`` for every layer kind the
reference runs: attention (causal, or sliding-window local layers with
their ring cache and short RoPE theta, or non-causal encoder layers),
Mamba-2 SSM layers (``models/ssm.py``), cross-attention over an encoder's
memory, and a dense or MoE (``models/moe.py``) FFN. Eager PyTorch in place
of jnp; the decode path updates its caches in place. The weights' shapes
live in ``models/params.py``.

``shard_weights`` and ``apply_layer_shards`` run any of these layers over
a mesh (``distributed/spmd.py``), the counterpart of what GSPMD compiles
from the reference's sharding annotations: each position computes its
data shard's rows with its model shard's q heads (self- and
cross-attention), SSM channels and heads, ``d_ff`` columns or experts, and
the partials of ``wo``, ``cwo``, ``out_proj``, ``w_down`` and the MoE
combine are all-reduced over "model" (not where the heads, the channels,
the ``d_ff`` or the experts stay whole on every shard: there every shard
computes the whole). The SSM's output norm spans the whole ``d_in``: its
sum of squares is all-reduced over "model" before the division.

``apply_layer_shards_prefill`` and ``apply_layer_shards_decode`` run a
decoder layer of any family (an attention or SSM mixer, a cross-attention
over an encoder's memory, a dense, MoE or no FFN) over the mesh in the two
serving cells: the prefill as ``apply_layer_shards``, returning its
caches as ``spmd.Placed`` leaves (k/v, and the cross-attention's ck/cv,
with the kv heads gathered over "model" and each position's slots kept;
the SSM's conv inputs and state on each position's channels and heads);
the decode weight-stationary, on the residual stream split over "data"
along d: its softmax merged over the caches' pieces across the grid (the
cross caches read, never written), the SSM's caches stepped in place on
their pieces, the experts' router and products summed over "data" and
their combine over "model". ``_ffn_shards`` is the FFN of every mode.
On a multi-pod mesh ("pod" ahead of "data" and "model") the batch splits
over the pods and data rows together where they divide it; the weights
are whole across pods, and every sum and merge of the decode stays
inside a pod, each pod computing the same step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import spmd
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (ArraySpec, apply_rope, rms_norm,
                                      swiglu)
from repro_torch.models.moe import moe_decode_shards, moe_ffn, moe_shard


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str            # "attn" | "ssm"
    is_global: bool       # full attention vs sliding-window
    ffn: str              # "dense" | "moe" | "none"
    has_cross: bool = False
    is_causal: bool = True


def make_layer_spec(cfg: ModelConfig, i: int, *,
                    decoder: bool = True) -> LayerSpec:
    """Layer ``i``'s spec in the decoder stack, or in the encoder stack
    (every encoder layer is global, non-causal attention with a dense
    FFN)."""
    if not decoder:
        return LayerSpec("attn", True, "dense", False, is_causal=False)
    mixer = cfg.layer_kind(i)
    is_global = cfg.layer_is_global(i) if mixer == "attn" else True
    ffn = "moe" if cfg.layer_is_moe(i) else (
        "none" if cfg.family == "ssm" else "dense")
    return LayerSpec(mixer, is_global, ffn,
                     has_cross=(cfg.cross_attention
                                and cfg.num_encoder_layers > 0))


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def window_cache_size(cfg: ModelConfig, spec: LayerSpec, capacity: int) -> int:
    """>0: use a ring window cache of this size; 0: full cache.

    Single source of truth for prefill/decode layout agreement: a window
    cache is used iff the layer is local AND window <= capacity (so decode
    can always distinguish it by cache_size == window).
    """
    if spec.mixer != "attn" or spec.is_global:
        return 0
    w = cfg.attn.sliding_window
    return w if 0 < w <= capacity else 0


def _is_ring(cfg: ModelConfig, spec: LayerSpec, cache_len_dim: int) -> bool:
    """Whether a layer's cache of ``cache_len_dim`` slots is a ring of its
    window (``window_cache_size``)."""
    w = 0 if spec.is_global else cfg.attn.sliding_window
    return bool(w) and cache_len_dim == w


def layer_cache_specs(cfg: ModelConfig, spec: LayerSpec, batch: int,
                      capacity: int, src_len: int = 0,
                      dtype: str = "bfloat16") -> Dict[str, ArraySpec]:
    """One layer's decode cache as ``apply_layer_seq`` lays it out for
    ``capacity`` tokens, with the reference's logical axes
    (``src/repro/models/blocks.py::layer_cache_specs``)."""
    out: Dict[str, ArraySpec] = {}
    if spec.mixer == "attn":
        w = window_cache_size(cfg, spec, capacity)
        kv = (batch, w if w else capacity, cfg.num_kv_heads, cfg.head_dim)
        axes = ("batch", "kv_seq", "kv_heads", None)
        out["k"] = ArraySpec(kv, dtype, axes)
        out["v"] = ArraySpec(kv, dtype, axes)
    else:
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        H = d_in // s.head_dim
        W = s.conv_width
        out["conv_x"] = ArraySpec((batch, W - 1, d_in), dtype,
                                  ("batch", None, "mlp"))
        out["conv_b"] = ArraySpec((batch, W - 1, s.state_dim), dtype,
                                  ("batch", None, None))
        out["conv_c"] = ArraySpec((batch, W - 1, s.state_dim), dtype,
                                  ("batch", None, None))
        out["h"] = ArraySpec((batch, H, s.head_dim, s.state_dim), dtype,
                             ("batch", "ssm_heads", None, None))
    if spec.has_cross:
        ckv = (batch, src_len, cfg.num_kv_heads, cfg.head_dim)
        axes = ("batch", "kv_seq", "kv_heads", None)
        out["ck"] = ArraySpec(ckv, dtype, axes)
        out["cv"] = ArraySpec(ckv, dtype, axes)
    return out


def _fit_slots(x: torch.Tensor, cap: int, ring: bool, s0: int = 0,
               n: Optional[int] = None) -> torch.Tensor:
    """Slots [s0, s0 + n) (all ``cap`` by default) of a cache of ``cap``
    slots laid out from x (B, S, ...) in a new tensor: left-aligned, zero
    padded or truncated at the end; or a ring, the last min(cap, S) steps
    each at slot p % cap of its absolute position p. A ring's steps lie in
    at most two runs of slots, each copied as a slice."""
    n = cap if n is None else n
    S = x.shape[1]
    out = x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))
    if ring:
        a = S - min(cap, S)
        first = cap - a % cap            # steps before the ring wraps
        runs = ((a, a % cap, min(first, S - a)),
                (a + first, 0, max(0, S - a - first)))
    else:
        runs = ((0, 0, min(S, cap)),)
    for p0, t0, m in runs:
        lo, hi = max(t0, s0), min(t0 + m, s0 + n)
        if lo < hi:
            out[:, lo - s0:hi - s0] = x[:, p0 + lo - t0:p0 + hi - t0]
    return out


def _right_fit(x: torch.Tensor, cap: int) -> torch.Tensor:
    """Right-align the last ``cap`` steps of x (B, S, ...) into a new
    tensor of capacity cap (zero padded at the start)."""
    out = x.new_zeros((x.shape[0], cap) + tuple(x.shape[2:]))
    keep = min(cap, x.shape[1])
    out[:, cap - keep:] = x[:, x.shape[1] - keep:]
    return out


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _qkv(h, p):
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    return q, k, v


def _theta(cfg: ModelConfig, spec: LayerSpec) -> float:
    if spec.mixer == "attn" and not spec.is_global and cfg.attn.sliding_window:
        return 1e4  # local layers use short-theta rope (gemma3 style)
    return cfg.rope_theta


def _attn_seq(cfg, spec, p, x, positions, window, kv_pick=None):
    """Full-sequence attention (prefill). ``kv_pick`` (``_kv_pick``)
    chooses the kv heads the q heads read where ``p`` holds more. Returns
    out, (k, v) of every kv head ``p`` holds."""
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    q, k, v = _qkv(h, p)
    theta = _theta(cfg, spec)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    v = v.contiguous()          # the flash kernel takes contiguous q/k/v
    ks, vs = ((k, v) if kv_pick is None else
              (_pick_heads(k, kv_pick, 2), _pick_heads(v, kv_pick, 2)))
    out = attn_lib.flash_attention(q, ks, vs, causal=spec.is_causal,
                                   window=window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (k, v)


def _cross_seq(cfg, p, x, memory, kv_pick=None):
    """Attention of x over the encoder's memory: non-causal, Sq != Skv, no
    RoPE. ``kv_pick`` as ``_attn_seq``'s. Returns out, (ck, cv) of every
    kv head ``p`` holds."""
    h = rms_norm(x, p["ln_cross"], cfg.rms_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p["cwq"]).contiguous()
    ck = torch.einsum("bsd,dhk->bshk", memory, p["cwk"]).contiguous()
    cv = torch.einsum("bsd,dhk->bshk", memory, p["cwv"]).contiguous()
    ks, vs = ((ck, cv) if kv_pick is None else
              (_pick_heads(ck, kv_pick, 2), _pick_heads(cv, kv_pick, 2)))
    out = attn_lib.flash_attention(q, ks, vs, causal=False)
    return torch.einsum("bshk,hkd->bsd", out, p["cwo"]), (ck, cv)


def _ssm_proj(p, h):
    z = h @ p["w_z"]
    xr = h @ p["w_x"]
    br = h @ p["w_b"]
    cr = h @ p["w_c"]
    dtr = h @ p["w_dt"]
    return z, xr, br, cr, dtr


def _silu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x.float()).to(x.dtype)


def _ssm_scan(cfg, p, x, want_cache=False):
    """The SSM mixer of x (B, S, d) up to its gate: (y (B, S, H, P), z,
    the layer's cache or None). On a shard, its channels and heads."""
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    z, xr, br, cr, dtr = _ssm_proj(p, h)
    xc = _silu(ssm_lib.causal_conv(xr, p["conv_x"]))
    bc = _silu(ssm_lib.causal_conv(br, p["conv_b"]))
    cc = _silu(ssm_lib.causal_conv(cr, p["conv_c"]))
    res = ssm_lib.ssd_forward({"x": xc, "b": bc, "c": cc, "dt": dtr},
                              p, cfg.ssm, return_state=want_cache)
    if not want_cache:
        return res, z, None
    y, h_state = res
    W = cfg.ssm.conv_width
    return y, z, {"h": h_state, "conv_x": _right_fit(xr, W - 1),
                  "conv_b": _right_fit(br, W - 1),
                  "conv_c": _right_fit(cr, W - 1)}


def _ssm_gate(y, z):
    """y (..., H, P) as z's shape (..., d_in), gated by silu(z)."""
    y = y.reshape(z.shape)
    return y * torch.nn.functional.silu(z.float()).to(y.dtype)


def _ssm_finish(cfg, p, y, z, x_dtype):
    """Gate y (B, S, H, P) by silu(z), normalise, project out."""
    gated = rms_norm(_ssm_gate(y, z), p["norm_y"], cfg.rms_eps)
    return (gated @ p["out_proj"]).to(x_dtype)


def _conv_steps(p, cache, xr, br, cr):
    """One causal-conv step of each raw input (B, C) over its cache (B,
    W-1, C), the cache updated in place; the outputs after silu."""
    out = []
    for name, raw in (("conv_x", xr), ("conv_b", br), ("conv_c", cr)):
        o, state = ssm_lib.causal_conv_step(raw, cache[name], p[name])
        cache[name].copy_(state)
        out.append(_silu(o))
    return out


def _ssd_step(cfg, p, h_cache, xc, bc, cc, dtr):
    """One SSD step over the state cache (B, H, P, N), updated in place;
    y (B, H·P)."""
    y, h_new = ssm_lib.ssd_decode_step({"x": xc, "b": bc, "c": cc,
                                        "dt": dtr}, p, cfg.ssm, h_cache)
    h_cache.copy_(h_new)
    return y.reshape(xc.shape)


def _ffn(cfg, spec, p, x):
    """The FFN residual of x (B, S, d), or None for an SSM-only layer."""
    if spec.ffn == "none":
        return None
    h = rms_norm(x, p["ln2"], cfg.rms_eps)
    if spec.ffn == "moe":
        return moe_ffn(h, p["moe"], cfg.moe)
    return swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


def apply_layer_seq(cfg: ModelConfig, spec: LayerSpec, p: Dict,
                    x: torch.Tensor, positions: torch.Tensor, *,
                    memory: Optional[torch.Tensor] = None,
                    want_cache: bool = False, capacity: int = 0
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Prefill (or encoder) path. x: (B, S, d); positions: (B, S); memory:
    the encoder's output for a cross-attention layer. Returns (x_out,
    cache laid out for ``capacity`` tokens, or None)."""
    cache: Dict[str, torch.Tensor] = {}
    if spec.mixer == "attn":
        window = 0 if spec.is_global else cfg.attn.sliding_window
        out, (k, v) = _attn_seq(cfg, spec, p, x, positions, window)
        x = x + out
        if want_cache:
            # a window cache is a RING, slot(p) = p % W (a decode update
            # is a one-token write, not a shift); a full cache is
            # left-aligned, and decode appends at cache_len
            w = window_cache_size(cfg, spec, capacity)
            cache["k"] = _fit_slots(k, w or capacity, bool(w))
            cache["v"] = _fit_slots(v, w or capacity, bool(w))
    else:
        y, z, c = _ssm_scan(cfg, p, x, want_cache)
        if want_cache:
            cache.update(c)
        x = x + _ssm_finish(cfg, p, y, z, x.dtype)
    if spec.has_cross:
        if memory is None:
            raise ValueError("a cross-attention layer needs the encoder's "
                             "memory")
        out, (ck, cv) = _cross_seq(cfg, p, x, memory)
        x = x + out
        if want_cache:
            cache["ck"], cache["cv"] = ck, cv
    f = _ffn(cfg, spec, p, x)
    if f is not None:
        x = x + f
    return x, (cache if want_cache else None)


def apply_layer_decode(cfg: ModelConfig, spec: LayerSpec, p: Dict,
                       x: torch.Tensor, cache: Dict, cache_len: int
                       ) -> Tuple[torch.Tensor, Dict]:
    """One-token path. x: (B, d); cache_len: #valid tokens before this step.
    The cache's tensors are updated in place; returns (x_out, cache)."""
    B = x.shape[0]
    h = rms_norm(x[:, None], p["ln1"], cfg.rms_eps)          # (B, 1, d)
    if spec.mixer == "attn":
        q, k, v = _qkv(h, p)
        theta = _theta(cfg, spec)
        pos = torch.full((B, 1), int(cache_len), dtype=torch.long,
                         device=x.device)
        q = apply_rope(q, pos, theta)
        k = apply_rope(k, pos, theta)
        cap = cache["k"].shape[1]
        if _is_ring(cfg, spec, cap):
            slot = int(cache_len) % cap
            vt = min(int(cache_len) + 1, cap)
        else:
            slot = int(cache_len)
            vt = int(cache_len) + 1
        attn_lib.update_cache(cache["k"], k, slot)
        attn_lib.update_cache(cache["v"], v, slot)
        out = attn_lib.decode_attention(q[:, 0], cache["k"], cache["v"], 0,
                                        vt)
        x = x + torch.einsum("bhk,hkd->bd", out, p["wo"])
    else:
        z, xr, br, cr, dtr = (t[:, 0] for t in _ssm_proj(p, h))
        xc, bc, cc = _conv_steps(p, cache, xr, br, cr)
        y = _ssd_step(cfg, p, cache["h"], xc, bc, cc, dtr)
        x = x + _ssm_finish(cfg, p, y[:, None], z[:, None], x.dtype)[:, 0]
    if spec.has_cross:
        h = rms_norm(x[:, None], p["ln_cross"], cfg.rms_eps)
        q = torch.einsum("bsd,dhk->bshk", h, p["cwq"])
        out = attn_lib.decode_attention(q[:, 0], cache["ck"], cache["cv"], 0,
                                        cache["ck"].shape[1])
        x = x + torch.einsum("bhk,hkd->bd", out, p["cwo"])
    f = _ffn(cfg, spec, p, x[:, None])
    if f is not None:
        x = x + f[:, 0]
    return x, cache


# ---------------------------------------------------------------------------
# On a mesh
# ---------------------------------------------------------------------------

def _kv_heads_of(first: int, n: int, group: int):
    """The kv heads that q heads [first, first + n) read: a slice when
    they cover whole groups or lie in one (flash's GQA then lines them
    up), else one kv head a q head."""
    lo, hi = first // group, (first + n - 1) // group + 1
    if (first % group == 0 and n % group == 0) or hi - lo == 1:
        return slice(lo, hi)
    return [(first + t) // group for t in range(n)]


def _kv_pick(cfg: ModelConfig, mesh, r: int, n_q: int, n_kv: int):
    """Where position ``r`` holds ``n_q`` of the q heads (a split over
    "model") but all ``n_kv`` kv heads, the kv heads its q heads read
    (``_kv_heads_of``); else None."""
    if n_q == cfg.num_heads or n_kv != cfg.num_kv_heads:
        return None
    return _kv_heads_of(mesh.axis_index(r, "model") * n_q, n_q,
                        cfg.num_heads // max(cfg.num_kv_heads, 1))


def _pick_heads(t: torch.Tensor, sel, dim: int) -> torch.Tensor:
    """The heads ``sel`` (a slice or a list) of ``t`` along ``dim``, as a
    contiguous tensor."""
    if isinstance(sel, slice):
        return t[(slice(None),) * dim + (sel,)].contiguous()
    return t.index_select(dim, torch.tensor(sel, device=t.device))


# an SSM layer's leaves over its d_in channels; its heads' are w_dt,
# dt_bias, A_log and D
_SSM_CHANNELS = ("w_z", "w_x", "conv_x", "norm_y", "out_proj")


def _ssm_cut_in_heads(p: Dict) -> bool:
    """Whether an SSM layer's channels split over "model" while its heads
    stay whole (``pspec_for`` drops a split the heads do not divide): a
    shard's channels would then cut a head."""
    def split(x):
        return any("model" in (a if isinstance(a, tuple) else (a,))
                   for a in x.spec)
    return split(p["w_x"]) and not split(p["w_dt"])


def _per_position(p: Dict, n: int, leaf) -> list:
    """``n`` dicts shaped as ``p`` (nested ``moe`` dict included), the
    list ``leaf(name, Placed)`` gives a leaf at each position."""
    out = [dict() for _ in range(n)]
    for k, v in p.items():
        parts = (_per_position(v, n, leaf) if isinstance(v, dict)
                 else leaf(k, v))
        for d, t in zip(out, parts):
            d[k] = t
    return out


def shard_weights(cfg: ModelConfig, p: Dict, mesh,
                  pick_kv: bool = True) -> list:
    """Each position's weights of one layer from its ``spmd.Placed``
    leaves (nested ``moe`` dict included): the dims sharded over "data"
    (FSDP) gathered; where the q heads of self- or cross-attention split
    over "model" and their kv heads do not, the kv heads that position's
    q heads read (all of them with ``pick_kv=False``, for a prefill that
    caches every kv head); and where an SSM layer's channels split over
    "model" but its heads do not, its channel leaves gathered over "model"
    too, so every position runs the whole mixer, as GSPMD does.
    Differentiable: the gathers' gradients reduce-scatter back."""
    whole = (set(_SSM_CHANNELS) if "w_x" in p and _ssm_cut_in_heads(p)
             else set())
    ws = _per_position(p, mesh.size, lambda k, v: spmd.gathered_over(
        v, "data", *(("model",) if k in whole else ())))
    for pre in ("", "c"):
        if not pick_kv or pre + "wq" not in p:
            continue
        for r, w in enumerate(ws):
            sel = _kv_pick(cfg, mesh, r, w[pre + "wq"].shape[1],
                           w[pre + "wk"].shape[1])
            if sel is None:
                continue
            for k in (pre + "wk", pre + "wv"):
                w[k] = (w[k][:, sel] if isinstance(sel, slice) else
                        w[k].index_select(1, torch.tensor(
                            sel, device=w[k].device)))
    return ws


def _ssm_out_shards(cfg: ModelConfig, mesh, ws: list, gated: list,
                    xs: list) -> list:
    """An SSM mixer's residual from each position's gated output
    (``_ssm_gate``, its channels): where the channels split over "model",
    the output norm's fp32 sum of squares and the ``out_proj`` partials
    are all-reduced over "model" (the reference's cast points, the mean's
    sum in another order)."""
    d_in = cfg.ssm.expand * cfg.d_model
    if ws[0]["norm_y"].shape[0] == d_in:    # every shard holds the whole
        return [(rms_norm(g, w["norm_y"], cfg.rms_eps) @ w["out_proj"]
                 ).to(x.dtype) for w, g, x in zip(ws, gated, xs)]
    sq = spmd.all_reduce([g.float().square().sum(dim=-1, keepdim=True)
                          for g in gated], mesh, "model")
    outs = []
    for w, g, s in zip(ws, gated, sq):
        normed = g.float() * torch.rsqrt(s / d_in + cfg.rms_eps)
        normed = (normed * (1.0 + w["norm_y"].float())).to(g.dtype)
        outs.append(normed @ w["out_proj"])
    return [o.to(x.dtype) for o, x in zip(spmd.all_reduce(outs, mesh,
                                                          "model"), xs)]


def _ssm_shards(cfg: ModelConfig, mesh, ws: list, xs: list,
                want_cache: bool = False):
    """An SSM mixer's residual over the mesh: each position scans its
    channels and heads (``_ssm_out_shards``). With ``want_cache``, also
    each position's cache of the channels and heads it scanned."""
    scans = [_ssm_scan(cfg, w, x, want_cache) for w, x in zip(ws, xs)]
    outs = _ssm_out_shards(cfg, mesh, ws, [_ssm_gate(y, z)
                                           for y, z, _ in scans], xs)
    return (outs, [c for _, _, c in scans]) if want_cache else outs


def apply_layer_shards(cfg: ModelConfig, spec: LayerSpec, mesh,
                       ws: list, xs: list, positions: list,
                       memory: Optional[list] = None,
                       moe_axes: Tuple[str, ...] = ()) -> list:
    """One layer of any kind over the mesh: ``ws`` from ``shard_weights``,
    ``xs[r]`` position r's copy of its data shard's residual stream (b, S,
    d), ``positions[r]`` (b, S), ``memory[r]`` its copy of the encoder's
    memory for a cross-attention layer; ``moe_axes`` as ``_ffn_shards``.
    Returns the new residual streams."""
    if spec.mixer == "attn":
        window = 0 if spec.is_global else cfg.attn.sliding_window
        outs = [_attn_seq(cfg, spec, w, x, pos, window)[0]
                for w, x, pos in zip(ws, xs, positions)]
        if ws[0]["wo"].shape[0] != cfg.num_heads:
            outs = spmd.all_reduce(outs, mesh, "model")
    else:
        outs = _ssm_shards(cfg, mesh, ws, xs)
    xs = [x + o for x, o in zip(xs, outs)]
    if spec.has_cross:
        if memory is None:
            raise ValueError("a cross-attention layer needs the encoder's "
                             "memory")
        outs = [_cross_seq(cfg, w, x, m)[0]
                for w, x, m in zip(ws, xs, memory)]
        if ws[0]["cwo"].shape[0] != cfg.num_heads:
            outs = spmd.all_reduce(outs, mesh, "model")
        xs = [x + o for x, o in zip(xs, outs)]
    return _ffn_shards(cfg, spec, mesh, ws, xs, moe_axes=moe_axes)


def _moe_rows(hs: list, ps: list, mcfg, mesh, axes: Tuple[str, ...]
              ) -> list:
    """``moe_shard`` where the streams ``hs`` are whole in batch on every
    position but the experts split the rows over ``axes``
    (``moe.moe_batch_axes``): each position routes its piece's rows, and
    the outputs are gathered over ``axes`` again."""
    if not axes:
        return moe_shard(hs, ps, mcfg, mesh)
    n = hs[0].shape[0] // math.prod(mesh.shape[a] for a in axes)
    hs = [h.narrow(0, spmd.piece_index((axes,), mesh, r)[0] * n, n)
          for r, h in enumerate(hs)]
    return spmd.all_gather(moe_shard(hs, ps, mcfg, mesh), mesh, axes, dim=0)


def _ffn_shards(cfg: ModelConfig, spec: LayerSpec, mesh, ws: list,
                xs: list, decode: bool = False,
                moe_axes: Tuple[str, ...] = ()) -> list:
    """The FFN residual over the mesh, in every mode: each position's
    ``d_ff`` columns or experts, the partials all-reduced over "model".
    Training and the prefill (``ws`` from ``shard_weights``, ``xs[r]``
    its data shard's (b, S, d)) route each data shard's tokens
    (``moe_shard``); the decode (``decode``: ``ws`` each position's
    pieces, ``xs[r]`` its (B, d / D) piece, split over "data" along d)
    is weight-stationary: ``w_gate``/``w_up`` (and the router) partial
    sums over "data", ``w_down`` each position's d piece
    (``moe_decode_shards`` for the experts). ``moe_axes``: where the
    streams are whole in batch but the reference's ``shard_map`` splits
    the rows (a batch that the pods and data rows together do not divide
    and the data rows do), the axes the experts split them over."""
    if spec.ffn == "none":
        return xs
    if not decode:
        hs = [rms_norm(x, w["ln2"], cfg.rms_eps) for w, x in zip(ws, xs)]
        if spec.ffn == "moe":
            fs = _moe_rows(hs, [w["moe"] for w in ws], cfg.moe, mesh,
                           moe_axes)
        else:
            fs = [swiglu(h, w["w_gate"], w["w_up"], w["w_down"])
                  for w, h in zip(ws, hs)]
            if ws[0]["w_gate"].shape[1] != cfg.d_ff:
                fs = spmd.all_reduce(fs, mesh, "model")
        return [x + f for x, f in zip(xs, fs)]
    split = xs[0].shape[-1] != cfg.d_model
    hs = norm_pieces(cfg, mesh, xs, [w["ln2"] for w in ws])
    if spec.ffn == "moe":
        fs = moe_decode_shards(hs, [w["moe"] for w in ws], cfg.moe, mesh,
                               split)
        return [x + f for x, f in zip(xs, fs)]
    g = _contract(mesh, split, hs, ws, "w_gate", "bd,df->bf")
    u = _contract(mesh, split, hs, ws, "w_up", "bd,df->bf")
    acts = [torch.nn.functional.silu(a.float()).to(h.dtype) * b
            for a, b, h in zip(g, u, hs)]
    fs = [a @ w["w_down"] for a, w in zip(acts, ws)]
    if ws[0]["w_down"].shape[0] != cfg.d_ff:
        fs = spmd.all_reduce(fs, mesh, "model")
    return [x + f for x, f in zip(xs, fs)]


# ---------------------------------------------------------------------------
# Prefill and decode on a mesh
# ---------------------------------------------------------------------------

def _placed_cache(ts: list, aspec: ArraySpec, mesh, rules,
                  ring: bool) -> spmd.Placed:
    """A prefill's k or v over the mesh, ``ts[r]`` (b, S, kv heads, D)
    position r's data shard with the kv heads it computed, as the cache
    ``aspec`` laid out under ``rules``: where the cache keeps every kv
    head and the positions computed a share, the shares are gathered over
    "model"; each position keeps its piece's slots and heads."""
    from repro_torch.distributed.sharding import pspec_for
    shape = tuple(aspec.shape)
    spec = pspec_for(aspec.logical_axes, mesh, rules, shape)
    whole = spmd.piece_ranges(spec, shape, mesh, 0)[2][1] == shape[2]
    if whole and ts[0].shape[2] != shape[2]:
        ts = spmd.all_gather(ts, mesh, "model", dim=2)
    pieces = []
    for r, t in enumerate(ts):
        (_, nb), (s0, ns), (h0, nh), _ = spmd.piece_ranges(spec, shape,
                                                            mesh, r)
        if t.shape[0] != nb:
            raise ValueError(f"position {r} computed {t.shape[0]} rows of "
                             f"a cache piece of {nb}")
        if t.shape[2] != nh:
            t = t.narrow(2, h0, nh)
        pieces.append(_fit_slots(t, shape[1], ring, s0, ns))
    return spmd.Placed(pieces, spec, shape, mesh, aspec.logical_axes)


def _placed_state(ts: list, aspec: ArraySpec, mesh, rules) -> spmd.Placed:
    """A prefill's SSM cache over the mesh, ``ts[r]`` what position r
    computed (its data shard's rows; its channels or heads, or all of
    them), as the cache ``aspec`` laid out under ``rules``: each position
    keeps its piece, narrowed where it computed the whole of a dim."""
    from repro_torch.distributed.sharding import pspec_for
    shape = tuple(aspec.shape)
    spec = pspec_for(aspec.logical_axes, mesh, rules, shape)
    pieces = []
    for r, t in enumerate(ts):
        for d, (lo, n) in enumerate(spmd.piece_ranges(spec, shape, mesh,
                                                      r)):
            if t.shape[d] == n:
                continue
            if t.shape[d] != shape[d]:
                raise ValueError(f"position {r} computed {t.shape[d]} of "
                                 f"dim {d} of a cache piece of {n}")
            t = t.narrow(d, lo, n)
        pieces.append(t.contiguous())
    return spmd.Placed(pieces, spec, shape, mesh, aspec.logical_axes)


def _attn_shards_cached(cfg: ModelConfig, mesh, ws: list, pre: str, run
                        ) -> Tuple[list, list, list]:
    """A prefill's self- (``pre`` "") or cross-attention (``pre`` "c")
    over the mesh: ``run(r, w, pick)`` gives position r's output and the
    k/v of every kv head ``w`` holds, its q heads reading the kv heads
    ``pick`` (``_kv_pick``); the outputs all-reduced over "model" where
    the heads split. Returns (outputs, ks, vs)."""
    outs, ks, vs = [], [], []
    for r, w in enumerate(ws):
        pick = _kv_pick(cfg, mesh, r, w[pre + "wq"].shape[1],
                        w[pre + "wk"].shape[1])
        o, (k, v) = run(r, w, pick)
        outs.append(o)
        ks.append(k)
        vs.append(v)
    if ws[0][pre + "wo"].shape[0] != cfg.num_heads:
        outs = spmd.all_reduce(outs, mesh, "model")
    return outs, ks, vs


def apply_layer_shards_prefill(cfg: ModelConfig, spec: LayerSpec, mesh,
                               ws: list, xs: list, positions: list,
                               cache_specs: Dict[str, ArraySpec], rules,
                               memory: Optional[list] = None,
                               moe_axes: Tuple[str, ...] = ()
                               ) -> Tuple[list, Dict[str, spmd.Placed]]:
    """A prefill's decoder layer over the mesh (an attention or SSM mixer,
    a cross-attention over ``memory[r]``, position r's copy of the
    encoder's memory, a dense, MoE or no FFN): ``apply_layer_shards`` that
    also returns the layer's cache as ``spmd.Placed`` leaves, laid out by
    ``cache_specs`` (``layer_cache_specs``) under ``rules``
    (``PREFILL_RULES``: the batch over "pod" and "data"; ``kv_seq``, the SSM
    channels and heads over "model"). Self- and cross-attention run flash
    on each position's q heads and cache the k/v of every kv head it holds
    (``ws`` from ``shard_weights(..., pick_kv=False)``; the cross caches
    ``ck``/``cv`` over the memory's frames); an SSM layer caches the conv
    inputs and the state of the channels and heads each position scanned
    (all of them where the channels split but the heads do not,
    ``_ssm_cut_in_heads``)."""
    if spec.mixer == "attn":
        window = 0 if spec.is_global else cfg.attn.sliding_window
        outs, ks, vs = _attn_shards_cached(
            cfg, mesh, ws, "", lambda r, w, pick: _attn_seq(
                cfg, spec, w, xs[r], positions[r], window, pick))
        ring = _is_ring(cfg, spec, cache_specs["k"].shape[1])
        cache = {name: _placed_cache(t, cache_specs[name], mesh, rules, ring)
                 for name, t in (("k", ks), ("v", vs))}
    else:
        outs, cs = _ssm_shards(cfg, mesh, ws, xs, want_cache=True)
        cache = {name: _placed_state([c[name] for c in cs], aspec, mesh,
                                     rules)
                 for name, aspec in cache_specs.items()}
    xs = [x + o for x, o in zip(xs, outs)]
    if spec.has_cross:
        if memory is None:
            raise ValueError("a cross-attention layer needs the encoder's "
                             "memory")
        outs, ks, vs = _attn_shards_cached(
            cfg, mesh, ws, "c", lambda r, w, pick: _cross_seq(
                cfg, w, xs[r], memory[r], pick))
        cache.update({name: _placed_cache(t, cache_specs[name], mesh, rules,
                                          False)
                      for name, t in (("ck", ks), ("cv", vs))})
        xs = [x + o for x, o in zip(xs, outs)]
    return _ffn_shards(cfg, spec, mesh, ws, xs, moe_axes=moe_axes), cache


def norm_pieces(cfg: ModelConfig, mesh, xs: list, scales: list) -> list:
    """``rms_norm`` of a residual stream (B, d) split over "data" along d
    (``xs[r]`` position r's piece, ``scales[r]`` its copy of the whole
    scale): each position's fp32 sum of squares all-reduced over "data",
    then its piece of the scale."""
    d = cfg.d_model
    if xs[0].shape[-1] == d:
        return [rms_norm(x, s, cfg.rms_eps) for x, s in zip(xs, scales)]
    sq = spmd.all_reduce([x.float().square().sum(dim=-1, keepdim=True)
                          for x in xs], mesh, "data")
    out = []
    for r, (x, s) in enumerate(zip(xs, sq)):
        n = x.shape[-1]
        w = scales[r].narrow(0, mesh.axis_index(r, "data") * n, n)
        y = x.float() * torch.rsqrt(s / d + cfg.rms_eps)
        out.append((y * (1.0 + w.float())).to(x.dtype))
    return out


def _contract(mesh, split: bool, hs: list, ws: list, name: str,
              eq: str) -> list:
    """Each position's d piece ``hs[r]`` times its ``fsdp`` rows of the
    weight ``name``: partial sums, all-reduced over "data" where d
    splits."""
    parts = [torch.einsum(eq, h, w[name]) for h, w in zip(hs, ws)]
    return spmd.all_reduce(parts, mesh, "data") if split else parts


def _decode_attn_pieces(cfg: ModelConfig, mesh, qs: list,
                        kc: spmd.Placed, vc: spmd.Placed, valid_to: int,
                        write: Optional[Tuple[list, list, int]] = None
                        ) -> list:
    """One-token attention over a cache ``kc``/``vc`` laid out on the mesh:
    with ``write`` (ks, vs, slot), each position first writes the new
    token's k/v (``ks[r]``, every kv head) where its piece holds ``slot``
    (without, the cache is read only: the cross caches); each attends its
    piece with the q heads (``qs[r]``, all of them) that read its kv heads
    (``decode_attention_partial`` at the piece's offset); the pieces merge
    over the whole grid of a pod (``combine_decode_attention``). Where the
    piece is not the whole batch and every kv head, or another position of
    the pod holds it first, its statistics stand in a whole-size tensor at
    their place, or not at all (every piece counted once a pod). Returns
    (B, Hq, D) a position."""
    B, _, Hkv, D = kc.shape
    G = cfg.num_heads // Hkv

    def no_slot(device):
        f32 = dict(dtype=torch.float32, device=device)
        return (torch.full((B, Hkv, G, 1), attn_lib.NEG_INF, **f32),
                torch.zeros((B, Hkv, G, 1), **f32),
                torch.zeros((B, Hkv, G, D), **f32))

    # each pod holds and merges its own copy (DECODE_RULES keep the batch
    # and the caches whole across pods)
    grid = tuple(a for a in mesh.axis_names if a != "pod")
    parts = []
    for r in range(mesh.size):
        (b0, nb), (s0, ns), (h0, nh), _ = kc.ranges(r)
        kp, vp = kc.pieces[r], vc.pieces[r]
        ks, vs, slot = write or (None, None, -1)
        if s0 <= slot < s0 + ns:
            kp[:, slot - s0] = ks[r][b0:b0 + nb, h0:h0 + nh].to(kp.dtype)
            vp[:, slot - s0] = vs[r][b0:b0 + nb, h0:h0 + nh].to(vp.dtype)
        if not kc.first_holder(r, grid):
            parts.append(no_slot(kp.device))
            continue
        q = qs[r][b0:b0 + nb, h0 * G:(h0 + nh) * G]
        part = attn_lib.decode_attention_partial(q, kp, vp, s0, 0, valid_to)
        if (nb, nh) != (B, Hkv):
            full = no_slot(kp.device)
            for whole, piece in zip(full, part):
                whole[b0:b0 + nb, h0:h0 + nh] = piece
            part = full
        parts.append(part)
    outs = attn_lib.combine_decode_attention(parts, mesh, grid)
    return [o.reshape(B, cfg.num_heads, D).to(q.dtype)
            for o, q in zip(outs, qs)]


def _heads_out_shards(cfg: ModelConfig, mesh, outs: list, ws: list,
                      name: str) -> list:
    """A decode's output projection ``name`` (``wo`` or ``cwo``) of each
    position's attention output ``outs[r]`` (B, H, hd), every head: each
    position's d piece from its heads, all-reduced over "model" where the
    heads split."""
    H = cfg.num_heads
    n = ws[0][name].shape[0]
    res = [torch.einsum("bhk,hkd->bd", o.narrow(
        1, (mesh.axis_index(r, "model") * n) if n != H else 0, n), w[name])
        for r, (o, w) in enumerate(zip(outs, ws))]
    return spmd.all_reduce(res, mesh, "model") if n != H else res


def _attn_decode_shards(cfg: ModelConfig, spec: LayerSpec, mesh,
                        ws: list, xs: list, cache: Dict[str, spmd.Placed],
                        cache_len: int, split: bool) -> list:
    """An attention mixer's decode step over the mesh: q/k/v partial sums
    over "data", q and the new k/v gathered over "model" to every head,
    attention over the cache's pieces (``_decode_attn_pieces``), ``wo``
    each position's d piece from its heads, all-reduced over "model"."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    hs = norm_pieces(cfg, mesh, xs, [w["ln1"] for w in ws])
    q, k, v = (_contract(mesh, split, hs, ws, n, "bd,dhk->bhk")
               for n in ("wq", "wk", "wv"))
    theta = _theta(cfg, spec)
    B = xs[0].shape[0]
    pos = [torch.full((B, 1), int(cache_len), dtype=torch.long, device=d)
           for d in mesh.devices]
    q = [apply_rope(t[:, None], ps, theta)[:, 0] for t, ps in zip(q, pos)]
    k = [apply_rope(t[:, None], ps, theta)[:, 0] for t, ps in zip(k, pos)]
    if q[0].shape[1] != H:
        q = spmd.all_gather(q, mesh, "model", dim=1)
    if k[0].shape[1] != Hkv:
        k = spmd.all_gather(k, mesh, "model", dim=1)
        v = spmd.all_gather(v, mesh, "model", dim=1)
    cap = cache["k"].shape[1]
    if _is_ring(cfg, spec, cap):
        slot, vt = int(cache_len) % cap, min(int(cache_len) + 1, cap)
    else:
        slot, vt = int(cache_len), int(cache_len) + 1
    out = _decode_attn_pieces(cfg, mesh, q, cache["k"], cache["v"], vt,
                              (k, v, slot))
    return _heads_out_shards(cfg, mesh, out, ws, "wo")


def _cross_decode_shards(cfg: ModelConfig, mesh, ws: list, xs: list,
                         cache: Dict[str, spmd.Placed], split: bool) -> list:
    """A cross-attention's decode step over the mesh: the ``ln_cross``
    norm over the d pieces, ``cwq`` partial sums over "data", q gathered
    over "model" to every head, attention over the pieces of the cross
    caches (every source frame valid; nothing written), ``cwo`` each
    position's d piece from its heads, all-reduced over "model"."""
    hs = norm_pieces(cfg, mesh, xs, [w["ln_cross"] for w in ws])
    q = _contract(mesh, split, hs, ws, "cwq", "bd,dhk->bhk")
    if q[0].shape[1] != cfg.num_heads:
        q = spmd.all_gather(q, mesh, "model", dim=1)
    out = _decode_attn_pieces(cfg, mesh, q, cache["ck"], cache["cv"],
                              cache["ck"].shape[1])
    return _heads_out_shards(cfg, mesh, out, ws, "cwo")


def _ssm_decode_shards(cfg: ModelConfig, mesh, ws: list, xs: list,
                       cache: Dict[str, spmd.Placed], split: bool) -> list:
    """An SSM mixer's decode step over the mesh: the input projections
    partial sums over "data"; each position's channels and heads through
    its pieces of the conv caches and the state, updated in place (the
    ``conv_b``/``conv_c`` copies alike on every position); the gated
    output norm and ``out_proj`` over "model" (``_ssm_out_shards``).
    Where the channels split over "model" but the heads do not, each
    position convolves its channels, the conv outputs are gathered over
    "model", and every position steps the whole state, its copy, and
    keeps its channels of the output."""
    H = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    hs = norm_pieces(cfg, mesh, xs, [w["ln1"] for w in ws])
    z, xr, br, cr, dtr = (_contract(mesh, split, hs, ws, n, "bd,di->bi")
                          for n in ("w_z", "w_x", "w_b", "w_c", "w_dt"))
    pieces = [{k: c.pieces[r] for k, c in cache.items()}
              for r in range(mesh.size)]
    convs = [_conv_steps(w, c, *t) for w, c, t in zip(
        ws, pieces, zip(xr, br, cr))]
    cut = dtr[0].shape[-1] == H and cache["conv_x"].shape[-1] != \
        z[0].shape[-1]
    xcs = [c[0] for c in convs]
    if cut:
        xcs = spmd.all_gather(xcs, mesh, "model", dim=-1)
    gated = []
    for r, (w, c, (_, bc, cc), xc, dt, zz) in enumerate(zip(
            ws, pieces, convs, xcs, dtr, z)):
        y = _ssd_step(cfg, w, c["h"], xc, bc, cc, dt)
        if cut:
            n = zz.shape[-1]
            y = y.narrow(-1, mesh.axis_index(r, "model") * n, n)
        gated.append(_ssm_gate(y, zz))
    return _ssm_out_shards(cfg, mesh, ws, gated, xs)


def apply_layer_shards_decode(cfg: ModelConfig, spec: LayerSpec, mesh,
                              p: Dict, xs: list,
                              cache: Dict[str, spmd.Placed], cache_len: int
                              ) -> list:
    """One decode step of a decoder layer over the mesh (an attention or
    SSM mixer, a cross-attention over the cross caches, a dense, MoE or no
    FFN), weight-stationary (``DECODE_RULES``): ``p`` the layer's
    ``spmd.Placed`` weights, used as their pieces, never gathered;
    ``xs[r]`` position r's piece (B, d / D) of the residual stream, split
    over "data" along d and whole in batch; ``cache`` its caches over the
    mesh, updated in place (the cross caches only read). Each input
    projection is a position's d piece times its ``fsdp`` rows, partial
    sums all-reduced over "data"; each output projection (``wo``,
    ``cwo``, ``out_proj``, ``w_down``, the experts' combine) gives each
    position's d piece from its heads, channels, ``d_ff`` columns or
    experts, all-reduced over "model" (``_attn_decode_shards``,
    ``_cross_decode_shards``, ``_ssm_decode_shards``, ``_ffn_shards``).
    Returns the new residual pieces."""
    split = xs[0].shape[-1] != cfg.d_model
    ws = _per_position(p, mesh.size, lambda _, v: v.pieces)
    if spec.mixer == "attn":
        outs = _attn_decode_shards(cfg, spec, mesh, ws, xs, cache,
                                   cache_len, split)
    else:
        outs = _ssm_decode_shards(cfg, mesh, ws, xs, cache, split)
    xs = [x + o for x, o in zip(xs, outs)]
    if spec.has_cross:
        outs = _cross_decode_shards(cfg, mesh, ws, xs, cache, split)
        xs = [x + o for x, o in zip(xs, outs)]
    return _ffn_shards(cfg, spec, mesh, ws, xs, decode=True)
