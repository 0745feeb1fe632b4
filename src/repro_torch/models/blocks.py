"""Per-layer blocks of the dense decoder: layer specs, cache layout, and the
prefill (``apply_layer_seq``) and one-token (``apply_layer_decode``) paths.

The port of ``src/repro/models/blocks.py`` for attention layers with a
dense FFN: causal attention, local layers with a sliding window and their
ring cache, and global layers with their own RoPE theta. Eager PyTorch in
place of jnp; the decode path updates its caches in place. SSM and MoE
layers are ROADMAP.md §1 item 8 and cross-attention (encoder-decoder) is
item 7d: they raise ``NotImplementedError``. The training path (no
cache) comes with item 9. The param defs of the
reference live in ``models/params.py`` (one shape table for every
attention layer).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import apply_rope, rms_norm, swiglu


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str            # "attn" | "ssm"
    is_global: bool       # full attention vs sliding-window
    ffn: str              # "dense" | "moe" | "none"
    has_cross: bool = False
    is_causal: bool = True


def make_layer_spec(cfg: ModelConfig, i: int) -> LayerSpec:
    """Decoder layer ``i``'s spec (encoder layers come with item 7d)."""
    mixer = cfg.layer_kind(i)
    is_global = cfg.layer_is_global(i) if mixer == "attn" else True
    ffn = "moe" if cfg.layer_is_moe(i) else (
        "none" if cfg.family == "ssm" else "dense")
    return LayerSpec(mixer, is_global, ffn,
                     has_cross=(cfg.cross_attention
                                and cfg.num_encoder_layers > 0))


def check_ported(spec: LayerSpec) -> None:
    """Raise for a layer kind the port does not run yet."""
    if spec.mixer != "attn":
        raise NotImplementedError("SSM layers are not ported yet "
                                  "(ROADMAP.md §1 item 8)")
    if spec.ffn == "moe":
        raise NotImplementedError("MoE layers are not ported yet "
                                  "(ROADMAP.md §1 item 8)")
    if spec.has_cross:
        raise NotImplementedError("cross-attention (encoder-decoder) is not "
                                  "ported yet (ROADMAP.md §1 item 7d)")


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


def _left_fit(x: torch.Tensor, cap: int) -> torch.Tensor:
    """Left-align x (B, S, ...) into a new tensor of capacity cap (zero
    padded or truncated at the end)."""
    out = x.new_zeros((x.shape[0], cap) + tuple(x.shape[2:]))
    keep = min(cap, x.shape[1])
    out[:, :keep] = x[:, :keep]
    return out


def _ring_fit(x: torch.Tensor, w: int) -> torch.Tensor:
    """Scatter the last min(w, S) steps of x (B, S, ...) into ring slots
    (absolute position p lands at slot p % w)."""
    S = x.shape[1]
    keep = min(w, S)
    ring = x.new_zeros((x.shape[0], w) + tuple(x.shape[2:]))
    slots = torch.arange(S - keep, S, device=x.device) % w
    ring[:, slots] = x[:, S - keep:]
    return ring


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


def _attn_seq(cfg, spec, p, x, positions, window):
    """Full-sequence attention (prefill). Returns out, (k, v)."""
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    q, k, v = _qkv(h, p)
    theta = _theta(cfg, spec)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    v = v.contiguous()          # the flash kernel takes contiguous q/k/v
    out = attn_lib.flash_attention(q, k, v, causal=spec.is_causal,
                                   window=window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (k, v)


def apply_layer_seq(cfg: ModelConfig, spec: LayerSpec, p: Dict,
                    x: torch.Tensor, positions: torch.Tensor, *,
                    capacity: int) -> Tuple[torch.Tensor, Dict]:
    """Prefill path. x: (B, S, d); positions: (B, S). Returns (x_out,
    cache) with the cache laid out for ``capacity`` tokens."""
    check_ported(spec)
    window = 0 if spec.is_global else cfg.attn.sliding_window
    out, (k, v) = _attn_seq(cfg, spec, p, x, positions, window)
    x = x + out
    w = window_cache_size(cfg, spec, capacity)
    if w:
        # window cache: RING buffer — slot(p) = p % W (a decode update is a
        # one-token write, not a shift)
        cache = {"k": _ring_fit(k, w), "v": _ring_fit(v, w)}
    else:
        # full cache: left-aligned, decode appends at index cache_len
        cache = {"k": _left_fit(k, capacity), "v": _left_fit(v, capacity)}
    h = rms_norm(x, p["ln2"], cfg.rms_eps)
    x = x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    return x, cache


def apply_layer_decode(cfg: ModelConfig, spec: LayerSpec, p: Dict,
                       x: torch.Tensor, cache: Dict, cache_len: int
                       ) -> Tuple[torch.Tensor, Dict]:
    """One-token path. x: (B, d); cache_len: #valid tokens before this step.
    The cache's tensors are updated in place; returns (x_out, cache)."""
    check_ported(spec)
    B = x.shape[0]
    h = rms_norm(x[:, None], p["ln1"], cfg.rms_eps)          # (B, 1, d)
    q, k, v = _qkv(h, p)
    theta = _theta(cfg, spec)
    pos = torch.full((B, 1), int(cache_len), dtype=torch.long,
                     device=x.device)
    q = apply_rope(q, pos, theta)
    k = apply_rope(k, pos, theta)
    window = 0 if spec.is_global else cfg.attn.sliding_window
    cap = cache["k"].shape[1]
    if window and cap == window:  # ring-buffer window cache
        slot = int(cache_len) % cap
        vt = min(int(cache_len) + 1, cap)
    else:
        slot = int(cache_len)
        vt = int(cache_len) + 1
    attn_lib.update_cache(cache["k"], k, slot)
    attn_lib.update_cache(cache["v"], v, slot)
    out = attn_lib.decode_attention(q[:, 0], cache["k"], cache["v"], 0, vt)
    x = x + torch.einsum("bhk,hkd->bd", out, p["wo"])
    h = rms_norm(x[:, None], p["ln2"], cfg.rms_eps)
    x = x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"])[:, 0]
    return x, cache
