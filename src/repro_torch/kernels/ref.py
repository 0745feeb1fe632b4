"""Plain PyTorch versions of every kernel: the CPU path and the ground truth
the CUDA kernels are held against (``src/repro/kernels/ref.py``'s twins).

Each computes in fp32 and casts back to the input dtype, like the oracles
of the JAX package. ``paged_attention_ref`` also reads the layered pool
(``layer=``) and the int8 pool with its scales (``kv_scales=``), and
``flash_attention_ref`` takes ``q_offset`` and native GQA (k/v carry
``Hkv`` heads), so together they compute what the paged runner calls on
its main path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: Optional[int] = None,
                        kv_len: Optional[int] = None,
                        softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D), H a multiple of Hkv (query
    head h reads kv head h // (H // Hkv)). Full materialized attention in
    fp32 (fp64 for fp64 inputs) -> (B, Sq, H, D).

    Query row i sits at absolute position ``q_offset + i`` in the kv stream;
    ``q_offset=None`` aligns the queries to the kv tail (``Skv - Sq``), as
    the JAX oracle does. A row that sees no key (possible only with a
    window, or with queries past ``Skv``) returns zeros. The cast points
    are the reference jnp attention's: q * scale and the unnormalized
    probabilities are rounded to the input dtype, the rest is fp32.
    """
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    off = Skv - Sq if q_offset is None else q_offset
    scale = D ** -0.5 if softmax_scale is None else softmax_scale
    acc = torch.promote_types(q.dtype, torch.float32)   # fp64 stays fp64
    kf = k.to(acc).repeat_interleave(H // Hkv, dim=2)
    vf = v.to(acc).repeat_interleave(H // Hkv, dim=2)
    # q is scaled in its own dtype, as the reference's jnp attention does
    s = torch.einsum("bqhd,bkhd->bhqk", (q * scale).to(acc), kf)
    qpos = off + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = kpos < (Skv if kv_len is None else kv_len)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)                     # (B, H, Sq, 1)
    # P meets V in the input dtype (bf16 rounds it), as in the reference's
    # jnp attention and the kernel; the row sum l stays unrounded
    p = p.to(q.dtype).to(acc) * mask.any(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.transpose(1, 2)
    return out.to(q.dtype)


# The paged kernel's split plan; csrc/paged_attention.cu compiles the same
# two constants in (kSplitUnit, kMaxSplits) and a CPU test holds them equal.
SPLIT_UNIT = 128    # tokens: the granule of a split of the paged kernel
MAX_SPLITS = 8      # splits of one context at most: CTAs in a cluster


def split_tokens(ctx: int, unit: int = SPLIT_UNIT,
                 max_splits: int = MAX_SPLITS) -> int:
    """Tokens in each split of a context of ``ctx`` tokens: the fewest
    multiples of ``unit`` that cover it in ``max_splits`` splits."""
    return unit * max(1, -(-ctx // (unit * max_splits)))


def split_bounds(ctx: int, unit: int = SPLIT_UNIT,
                 max_splits: int = MAX_SPLITS) -> list:
    """[(lo, hi)] token bounds of the non-empty splits of one context, in
    split order. A function of ``ctx`` and the two constants only, so a
    sequence gets the same splits in whatever batch it sits."""
    tps = split_tokens(ctx, unit, max_splits)
    return [(lo, min(ctx, lo + tps)) for lo in range(0, ctx, tps)]


def cluster_size(max_blocks: int, block_size: int, unit: int = SPLIT_UNIT,
                 max_splits: int = MAX_SPLITS) -> int:
    """CTAs per (kv head, sequence) for a block table ``max_blocks`` wide:
    the power of two at or above the most splits any context of at most
    ``max_blocks * block_size`` tokens gets (at most ``max_splits``).
    Shorter contexts leave the trailing CTAs of their cluster empty."""
    n = min(max_splits, max(1, -(-max_blocks * block_size // unit)))
    return 1 << (n - 1).bit_length()


def paged_attention_ref(q: torch.Tensor, kv_pool: torch.Tensor,
                        block_tables: torch.Tensor,
                        context_lens: torch.Tensor, *,
                        layer: int = -1,
                        kv_scales: Optional[torch.Tensor] = None,
                        n_splits: int = 1,
                        split_unit: Optional[int] = None) -> torch.Tensor:
    """Decode attention over a block-first paged pool.

    q: (B, H, D); kv_pool: (NB, 2, P, Hkv, D), or the layered
    (NB, L, 2, P, Hkv, D) with ``layer >= 0``; block_tables: (B, MB) int32;
    context_lens: (B,) -> (B, H, D). ``kv_scales`` ((NB, 2, Hkv), or
    (NB, L, 2, Hkv) when layered, fp32) marks an int8 pool: each gathered
    (P, D) tile is dequantized in fp32 by its (side, kv head) scale before
    attending.

    ``n_splits > 1`` computes it as the split-K kernel splits it: each context
    is cut by ``split_bounds(ctx, split_unit, n_splits)`` (``split_unit``
    defaults to the block size), each split gives its partial (max m, sum
    l, unnormalized output), and the partials combine in split order with
    weights exp(m_s - max m), empty splits skipped. The kernel's own plan
    is ``n_splits=MAX_SPLITS, split_unit=SPLIT_UNIT``. One split (the
    default) is the single softmax.
    """
    B, H, D = q.shape
    MB = block_tables.shape[1]
    rows = block_tables.reshape(-1).long()
    kv = kv_pool[rows, layer] if layer >= 0 else kv_pool[rows]
    _, _, P, Hkv, _ = kv.shape                 # (B*MB, 2, P, Hkv, D)
    kv = kv.float()
    if kv_scales is not None:
        sc = kv_scales[rows, layer] if layer >= 0 else kv_scales[rows]
        kv = kv * sc.float()[:, :, None, :, None]    # (B*MB, 2, 1, Hkv, 1)
    k = kv[:, 0].reshape(B, MB * P, Hkv, D)
    v = kv[:, 1].reshape(B, MB * P, Hkv, D)
    qg = q.reshape(B, Hkv, H // Hkv, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) / (D ** 0.5)
    pos = torch.arange(MB * P, device=q.device)[None]
    ctx = context_lens.to(q.device).long()
    valid = (pos < ctx[:, None])[:, None, None]
    if n_splits == 1:
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgs,bskd->bkgd", p, v)
        return out.reshape(B, H, D).to(q.dtype)
    unit = P if split_unit is None else split_unit
    tps = torch.tensor([split_tokens(int(c), unit, n_splits) for c in ctx],
                       device=q.device)
    split = (pos // tps[:, None])[:, None, None]       # (B, 1, 1, MB*P)
    parts = []
    for i in range(n_splits):
        inside = valid & (split == i)
        si = torch.where(inside, s, torch.full_like(s, -float("inf")))
        m = si.amax(dim=-1)                            # -inf: empty split
        p = torch.exp(si - torch.where(torch.isinf(m), 0.0, m)[..., None])
        parts.append((m, p.sum(-1), torch.einsum("bkgs,bskd->bkgd", p, v)))
    mmax = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        w = torch.where(torch.isinf(m), 0.0, torch.exp(m - mmax))
        num = num + w[..., None] * acc
        den = den + w * l
    out = num / den.clamp(min=1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def kv_copy_ref(pool: torch.Tensor, src, dst, n_valid=None) -> torch.Tensor:
    """Batched block rotation, in place: pool[dst[i]] = pool[src[i]] for
    i < n_valid. pool: (NB, ...); src/dst: (N,) int32 (numpy or tensor).
    Entries with i >= n_valid, or src[i] < 0, are no-ops and write nothing.
    Every source row is read before any destination is written. Returns
    ``pool``."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    valid = np.arange(len(src)) < (len(src) if n_valid is None else n_valid)
    valid &= src >= 0
    if valid.any():
        s = torch.from_numpy(src[valid]).to(pool.device)
        d = torch.from_numpy(dst[valid]).to(pool.device)
        pool[d] = pool[s]
    return pool
