"""Attention of the ``LM``: prefill (flash) and one-token decode over a
dense per-request cache.

``flash_attention`` has the reference's call (``src/repro/models/
attention.py:36``): q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) with GQA by
``Hkv``, ``q_offset`` the absolute position of q[0] relative to k[0],
``window`` a sliding window (0 = full), ``causal=False`` for an encoder's
layers and for cross-attention over its memory (Sq != Skv). On CUDA it
runs the flash kernel,
on the CPU the plain version; never a library attention. The reference's
``chunk_q``/``chunk_kv`` set the jnp version's tile sizes and have no
counterpart here: the kernel has its own tiles.

With grad enabled and an input that needs it, ``flash_attention`` runs
as ``FlashAttention``, an ``autograd.Function``: its forward is the same
call (the kernel on CUDA, the plain version on the CPU), and its backward
(``flash_attention_backward``) is plain PyTorch that recomputes the
softmax per chunk of query rows. That is the counterpart of the
reference's training path, which differentiates its jnp chunked attention
with ``jax.value_and_grad``; the reference has no backward kernel.

``decode_attention`` and ``update_cache`` are the reference's jnp functions
(``:113-146``), which run outside any Pallas kernel; plain PyTorch is their
counterpart. Scores and the value product accumulate in fp32, as the
reference's ``preferred_element_type`` asks. ``decode_attention`` is the
one-piece case of ``decode_attention_partial`` (a piece of the cache's
sequence at its absolute offset) and ``combine_decode_attention``, which
merge the pieces' softmax statistics: over a list on one device, or over
a mesh's positions (``distributed/spmd.py``), where the reference's
``kv_seq`` sharding of the scores lets GSPMD distribute the softmax.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.distributed import spmd
from repro_torch.kernels.flash_attention import flash_attention as _flash

NEG_INF = -1e30
BWD_CHUNK_Q = 256     # query rows whose scores the backward holds at once


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    softmax_scale)
    return _flash(q, k, v, causal=causal, window=window, q_offset=q_offset,
                  softmax_scale=softmax_scale)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient: the forward kernel (or, on the
    CPU, the plain version), and ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, softmax_scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        softmax_scale=softmax_scale)
        return _flash(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, dout, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             q_offset: Optional[int] = 0,
                             softmax_scale: Optional[float] = None):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) for the output
    gradient ``dout`` (B, Sq, H, D). Per chunk of ``BWD_CHUNK_Q`` query rows it
    recomputes the scores over the keys those rows can see (causal bound,
    window, ``q_offset``), under the forward's mask, so it never holds the
    whole (B, H, Sq, Skv) score tensor. A row that sees no key has output 0
    and gets a zero gradient. GQA: dk and dv sum over each kv head's group
    of query heads. Accumulates in fp32 (fp64 for fp64 inputs); returns the
    inputs' dtypes."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    off = Skv - Sq if q_offset is None else int(q_offset)
    scale = D ** -0.5 if softmax_scale is None else float(softmax_scale)
    acc = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(acc).reshape(B, Sq, Hkv, G, D)
    do = dout.to(acc).reshape(B, Sq, Hkv, G, D)
    kf, vf = k.to(acc), v.to(acc)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for r0 in range(0, Sq, BWD_CHUNK_Q):
        r1 = min(Sq, r0 + BWD_CHUNK_Q)
        # the keys rows [r0, r1) can see: [lo, hi)
        hi = min(Skv, off + r1) if causal else Skv
        lo = max(0, off + r0 - window + 1) if window > 0 else 0
        if hi <= lo:
            continue
        qpos = off + torch.arange(r0, r1, device=q.device)[:, None]
        kpos = torch.arange(lo, hi, device=q.device)[None, :]
        mask = torch.ones((r1 - r0, hi - lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (kpos <= qpos)
        if window > 0:
            mask = mask & (kpos > qpos - window)
        kc, vc = kf[:, lo:hi], vf[:, lo:hi]
        qc, dc = qf[:, r0:r1], do[:, r0:r1]
        s = torch.einsum("bqkgd,bskd->bkgqs", qc, kc) * scale
        s = s.masked_fill(~mask, NEG_INF)
        # zero where masked: a row that sees no key has p = 0, not 1/n
        p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True)) * mask
        dp = torch.einsum("bqkgd,bskd->bkgqs", dc, vc)
        ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
        dq[:, r0:r1] = torch.einsum("bkgqs,bskd->bqkgd", ds, kc) * scale
        dk[:, lo:hi] += torch.einsum("bkgqs,bqkgd->bskd", ds, qc) * scale
        dv[:, lo:hi] += torch.einsum("bkgqs,bqkgd->bskd", p, dc)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _bound(b: Union[int, torch.Tensor], like: torch.Tensor):
    """A position bound as an int or a (B or 1, 1) tensor on ``like``'s
    device, ready to compare with (1, S) positions."""
    if isinstance(b, int):
        return b
    return torch.as_tensor(b, device=like.device).reshape(-1, 1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     valid_from: Union[int, torch.Tensor],
                     valid_to: Union[int, torch.Tensor], *,
                     softmax_scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention against a dense KV cache.

    q: (B, Hq, D); k_cache/v_cache: (B, S, Hkv, D); valid_from/valid_to:
    ints or (B,) — cache positions in [valid_from, valid_to) attend.
    """
    B, Hq, D = q.shape
    part = decode_attention_partial(q, k_cache, v_cache, 0, valid_from,
                                    valid_to, softmax_scale=softmax_scale)
    out = combine_decode_attention([part])[0]
    return out.reshape(B, Hq, D).to(q.dtype)


Partial = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def decode_attention_partial(q: torch.Tensor, k_piece: torch.Tensor,
                             v_piece: torch.Tensor, offset: int,
                             valid_from: Union[int, torch.Tensor],
                             valid_to: Union[int, torch.Tensor], *,
                             softmax_scale: Optional[float] = None
                             ) -> Partial:
    """One-token attention over a piece of the cache: k_piece/v_piece (B,
    S_piece, Hkv, D) hold cache positions [offset, offset + S_piece), masked
    by the absolute bounds [valid_from, valid_to). Returns, in fp32,
    (m, l, o): the max score and the sum of exp(score - m), each (B, Hkv,
    G, 1), and the piece's output o (B, Hkv, G, D), the product of its
    weights normalised by its own l (cast to the cache's dtype as the
    reference casts them) with its values. A piece with no valid slot gives
    m = NEG_INF, l = 0, o = 0."""
    B, Hq, D = q.shape
    S, Hkv = k_piece.shape[1], k_piece.shape[2]
    group = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    qg = (q * scale).reshape(B, Hkv, group, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_piece.float())
    pos = offset + torch.arange(S, device=q.device)[None]     # (1, S)
    mask = ((pos >= _bound(valid_from, q))
            & (pos < _bound(valid_to, q)))[:, None, None, :]
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    # m is NEG_INF only where no slot is valid: there the clamp makes every
    # exp 0; elsewhere it leaves m as it is
    p = torch.exp(s - m.clamp(min=NEG_INF / 2))
    l = p.sum(dim=-1, keepdim=True)
    w = (p / l.clamp(min=_TINY)).to(v_piece.dtype).float()
    o = torch.einsum("bkgs,bskd->bkgd", w, v_piece.float())
    return m, l, o


_TINY = 1e-30


def combine_decode_attention(parts: Sequence[Partial], mesh=None,
                             axes=()) -> List[torch.Tensor]:
    """The attention output (B, Hkv, G, D) in fp32 from pieces' (m, l, o):
    the global max, each piece's weight l · exp(m - max) over their sum,
    and the weighted sum of the pieces' outputs. With ``mesh``, ``parts``
    holds each position's piece and the max and sums are all-reduced over
    its group along ``axes`` (``spmd``), one result a position; without,
    they merge in list order on one device, the same result for each. One
    piece gives its own o (its weight is l / l = 1)."""
    if mesh is None and len(parts) == 1:
        return [parts[0][2]]
    if mesh is None:
        def red_max(xs):
            return [functools.reduce(torch.maximum, xs)] * len(xs)

        def red_sum(xs):
            return [functools.reduce(torch.add, xs)] * len(xs)
    else:
        def red_max(xs):
            return spmd.all_reduce_max(xs, mesh, axes)

        def red_sum(xs):
            return spmd.all_reduce(xs, mesh, axes)
    top = red_max([m for m, _, _ in parts])
    ws = [l * torch.exp(m - t) for (m, l, _), t in zip(parts, top)]
    tot = red_sum(ws)
    return red_sum([(w / t.clamp(min=_TINY)) * o
                    for w, t, (_, _, o) in zip(ws, tot, parts)])


def update_cache(cache: torch.Tensor, new: torch.Tensor,
                 pos: int) -> torch.Tensor:
    """Write new (B, 1, Hkv, D) into cache (B, S, Hkv, D) at position
    ``pos``, IN PLACE (the reference's ``dynamic_update_slice`` returns a new
    array; an eager cache is owned by its request, and a copy per token
    would move the whole cache). ``pos`` is clamped so the write fits, as
    ``dynamic_update_slice`` clamps it. Returns ``cache``."""
    n = new.shape[1]
    pos = min(max(int(pos), 0), cache.shape[1] - n)
    cache[:, pos:pos + n] = new.to(cache.dtype)
    return cache
