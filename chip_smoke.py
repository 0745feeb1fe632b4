#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device: the card's name and power limit; TF32 off for the fp32 phases;
2. build: nvcc builds the CUDA kernels from ``src/repro_torch``, one
   process per source, all at once;
3. kernel vs plain: each kernel (and the int8 mode of paged attention)
   against its plain PyTorch version on the card, at llama3-8b's
   full-width shapes, in bf16 and fp32, edge cases included (flash: a
   37-row chunk under a window, the dense path's whole-prompt prefill at
   llama3-8b's and the reduced gemma3's heads; paged: B=8 with empty
   splits), each within
   a stated tolerance; the paged kernel's output for one sequence bitwise
   equal alone and in a batch; ``quant_store_tokens`` on the card against
   the CPU;
4. timing: each kernel at main-path shapes (CUDA events, median after
   warm-up) beside its bound, its plain version and a library yardstick;
   paged attention also at the main path's decode batch (B=8, ctx 1024,
   both modes, a different layer each call so no call finds the last in
   L2);
5. serving: llama3-8b at full width (bf16 weights, random from a seeded
   generator) through ``ServingEngine(..., paged_runner=True)``, once with
   the bf16 KV pool and once with the int8 tier: (a) ample HBM, (b) HBM
   for about two requests, which forces rotation; each path's kernel
   launch counts are set to 0 just before it and read just after;
6. lossless: the same two runs with ``llama3-8b.reduced()`` in fp32 must
   emit equal token streams, in bf16 and in int8;
7. CLI: ``python -m repro_torch.launch.serve --paged-runner --kv-dtype
   int8`` as a subprocess on the card;
8. server: llama3-8b at full width behind ``AsyncServingEngine(pace=True)``
   and ``InferenceServer`` in process, with phase 5's tight HBM; 8
   concurrent streaming HTTP clients on phase 5's prompts and a ninth that
   closes its socket mid-stream. Client-side TTFT/TBT, the event loop's
   lag and the device busy share are printed; /healthz and /readyz answer
   200, every stream ends "length" with its tokens, the ninth request ends
   "aborted", requests rotated, the HBM blocks are all free after the
   drain, shutdown exits 0, and all three kernels launched during the load;
9. supervisor: ``python -m repro_torch.launch.server_main --paged-runner``
   as a subprocess: one stream read to its end, then SIGTERM and rc 0; the
   server's exit line reports its kernel launches, and flash and paged
   attention must have launched;
10. dense path: ``RealExecutor`` behind ``ServingEngine`` on phase 5's
   prompts at full width in bf16, with ample HBM and with phase 5's tight
   HBM (equal streams, flash launched; the top-1 agreement with phase 5's
   paged run is printed), then gemma3-1b.reduced() at 6 layers in fp32,
   whose local layers have a 32-token window: lossless under rotation, and
   the card's streams equal the CPU's from the same weights.

It prints a JSON line of kernel results (each with its launches per
main path), then the card's name and power limit, and last ``{"ok":
true, "device": {...}}``. It imports nothing of JAX and nothing of the
JAX package.

``python3 chip_smoke.py --timing`` runs phases 1, 2 and 4 only and prints
phase 4's times as one JSON line ``{"timing": {...}}``: the quick way to
compare two trees' kernels on one card (run each tree's copy of the
script in turn, within one machine).
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HBM_BYTES_S = 3.35e12            # H100 SXM device memory, bytes/s
PEAK_BF16_FLOPS = 989e12          # dense tensor-core rate, FLOP/s
TOL = {"bf16": 2e-2, "fp32": 1e-5}   # atol = rtol: bf16 output rounding
#                                      (the reference kernel tests' bf16
#                                      tolerance); fp32 summation order
ROW_MOVES = ("copy_launches", "d2d_rows", "d2h_rows", "h2d_rows")
INT8_REPLACES = "src/repro/kernels/paged_attention.py:84 (kv_scales)"


def log(*a):
    print(*a, flush=True)


def time_ms(torch, fn, reps=10, per=10, warmup=3):
    """Device milliseconds per call of ``fn``: CUDA events around ``per``
    back-to-back calls (so host dispatch overlaps the device), the median
    over ``reps`` such runs, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / per)
    return statistics.median(ts)


def check(name, dtype, case, got, want, tol, errs):
    err = (got.float() - want.float()).abs().max().item()
    bad = ((got.float() - want.float()).abs()
           > tol + tol * want.float().abs()).sum().item()
    log(f"check {name} {dtype} {case}: max_abs_err={err:.3e} "
        f"tol(atol=rtol)={tol:g}")
    if bad or not np.isfinite(err):
        raise AssertionError(f"{name} {dtype} {case}: {bad} elements outside "
                             f"tolerance {tol:g} (max abs err {err:.3e})")
    errs[name] = max(errs.get(name, 0.0), err)


# ---------------------------------------------------------------- phase 3

def kernel_checks(torch, ops, ref, cfg, errs, dev="cuda"):
    """Each kernel against its plain version at llama3-8b's widths (flash
    also at the reduced gemma3's, which the dense path runs)."""
    from repro_torch.configs import get_config
    gem = get_config("gemma3-1b").reduced()
    L, Hkv, D, H = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    P, NB, staging = 16, 1024, 64
    rows = NB + staging + 1
    trash = rows - 1
    for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        g = torch.Generator(device=dev).manual_seed(1)
        tol = TOL[dname]
        pool = torch.randn((rows, L, 2, P, Hkv, D), generator=g, device=dev,
                           dtype=torch.float32).to(dt)
        # kv_copy: 64 descriptors, the last 14 no-op padding; row 0 must
        # stay as it was
        src = np.full(64, -1, np.int32)
        dst = np.zeros(64, np.int32)
        src[:50] = np.arange(1, 51)
        dst[:50] = np.arange(NB, NB + 50)
        flat = pool.view(rows, -1)
        want = ref.kv_copy_ref(flat.clone(), src, dst)
        row0 = flat[0].clone()
        got = ops.kv_copy(flat, src, dst, force="kernel")
        torch.cuda.synchronize()
        check("kv_copy", dname, "64 descriptors, 14 no-op", got, want, 0.0,
              errs)
        if not torch.equal(got[0], row0):
            raise AssertionError("kv_copy: a no-op descriptor wrote row 0")
        del want
        # paged attention: B=32, ragged contexts up to 1024 tokens, the
        # last 4 lanes padded (trash row, context 1), layers 0 and L-1
        B, MB = 32, 64
        q = torch.randn((B, H, D), generator=g, device=dev).to(dt)
        bt = torch.randint(0, NB, (B, MB), generator=g, device=dev,
                           dtype=torch.int32)
        cl = torch.randint(1, MB * P + 1, (B,), generator=g, device=dev,
                           dtype=torch.int32)
        bt[-4:] = trash
        cl[-4:] = 1
        for layer in (0, L - 1):
            got = ops.paged_attention(q, pool, bt, cl, layer=layer,
                                      force="kernel")
            want = ref.paged_attention_ref(q, pool, bt, cl, layer=layer)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError("paged_attention: non-finite output")
            check("paged_attention", dname,
                  f"B={B} ragged ctx, 4 padded lanes, layer {layer}", got,
                  want, tol, errs)
        # B=8 over a 64-block table (clusters of 8 CTAs): contexts that
        # leave trailing splits empty, end on a split boundary or pass one
        q8, bt8 = q[:8].contiguous(), bt[:8].contiguous()
        cl8 = torch.tensor(EMPTY_SPLIT_CTX, device=dev, dtype=torch.int32)
        bt8[0] = trash
        got = ops.paged_attention(q8, pool, bt8, cl8, layer=L - 1,
                                  force="kernel")
        want = ref.paged_attention_ref(q8, pool, bt8, cl8, layer=L - 1)
        torch.cuda.synchronize()
        check("paged_attention", dname,
              f"B=8 ctx {EMPTY_SPLIT_CTX}: empty splits", got, want, tol,
              errs)
        batch_invariance(torch, ops, q, pool, bt, cl, L - 1, None, dname)
        del pool
        # flash attention, the paged runner's chunks: a 512-token chunk
        # over a 1024-token context at q_offset 300 (!= Skv - Sq), then a
        # 256-token window, tail-aligned, then a 37-row chunk at q_offset 700
        # over 1000 keys (not a multiple of the 64-key tile) under a
        # 128-token window; then the dense path's whole-prompt prefill
        # (Sq == Skv, q_offset 0): a ragged 731-token prompt at llama3-8b's
        # heads, and a 53-token prompt at the reduced gemma3's heads under
        # its window
        for T, Skv, off, win, heads in (
                (512, 1024, 300, 0, (H, Hkv, D)),
                (512, 1024, None, 256, (H, Hkv, D)),
                (37, 1000, 700, 128, (H, Hkv, D)),
                (731, 731, 0, 0, (H, Hkv, D)),
                (53, 53, 0, gem.attn.sliding_window,
                 (gem.num_heads, gem.num_kv_heads, gem.head_dim))):
            h, hkv, d = heads
            q = torch.randn((1, T, h, d), generator=g, device=dev).to(dt)
            k = torch.randn((1, Skv, hkv, d), generator=g, device=dev).to(dt)
            v = torch.randn((1, Skv, hkv, d), generator=g, device=dev).to(dt)
            got = ops.flash_attention(q, k, v, causal=True, window=win,
                                      q_offset=off, force="kernel")
            want = ref.flash_attention_ref(q, k, v, causal=True, window=win,
                                           q_offset=off)
            torch.cuda.synchronize()
            check("flash_attention", dname,
                  f"T={T} Skv={Skv} q_offset={off} window={win} H/Hkv/D="
                  f"{h}/{hkv}/{d}", got, want, tol, errs)
        gc.collect()
        torch.cuda.empty_cache()


EMPTY_SPLIT_CTX = [1, 40, 128, 129, 300, 1024, 700, 5]


def batch_invariance(torch, ops, q, pool, bt, cl, layer, scales, dname):
    """Lane 0's output bitwise equal alone (a table just wide enough) and
    in the whole batch (a 64-block table, other companions)."""
    P = pool.shape[-3]
    nblk = -(-int(cl[0]) // P)
    alone = ops.paged_attention(q[:1].contiguous(), pool,
                                bt[:1, :nblk].contiguous(),
                                cl[:1].contiguous(), layer=layer,
                                kv_scales=scales, force="kernel")
    full = ops.paged_attention(q, pool, bt, cl, layer=layer,
                               kv_scales=scales, force="kernel")
    torch.cuda.synchronize()
    same = torch.equal(alone[0], full[0])
    log(f"check paged_attention{'' if scales is None else '_int8'} {dname} "
        f"batch invariance: context {int(cl[0])}, alone ({nblk} blocks) vs "
        f"in a batch of {q.shape[0]} ({bt.shape[1]} blocks): bitwise equal "
        f"{same}")
    if not same:
        raise AssertionError("paged_attention: a sequence's output depends "
                             "on its batch")


def int8_pool(torch, g, lead, cfg, P, dev):
    """A random int8 pool ``lead + (2, P, Hkv, D)`` and its fp32 scales
    ``lead + (2, Hkv)`` (dequantized values of order 1)."""
    Hkv, D = cfg.num_kv_heads, cfg.head_dim
    pool = torch.randint(-127, 128, lead + (2, P, Hkv, D), generator=g,
                         device=dev, dtype=torch.int8)
    scales = torch.rand(lead + (2, Hkv), generator=g, device=dev) * 0.03 \
        + 1e-3
    return pool, scales


def int8_checks(torch, ops, ref, quant, cfg, errs, dev="cuda"):
    """The int8 mode of paged attention against its plain version at
    llama3-8b's widths: layered and flat pools, q in bf16 and fp32, padded
    lanes on the trash row with context 1, and a row whose scales are
    SCALE_EPS. Then ``quant_store_tokens`` on the card against the same
    call on the CPU."""
    L, H = cfg.num_layers, cfg.num_heads
    P, NB, staging = 16, 1024, 64
    rows = NB + staging + 1
    trash, eps_row = rows - 1, NB - 1
    B, MB = 32, 64
    g = torch.Generator(device=dev).manual_seed(4)
    for layered in (True, False):
        pool, scales = int8_pool(torch, g, (rows, L) if layered else (rows,),
                                 cfg, P, dev)
        scales[eps_row] = quant.SCALE_EPS
        bt = torch.randint(0, NB - 1, (B, MB), generator=g, device=dev,
                           dtype=torch.int32)
        cl = torch.randint(1, MB * P + 1, (B,), generator=g, device=dev,
                           dtype=torch.int32)
        bt[0, 0] = eps_row
        bt[-4:] = trash
        cl[-4:] = 1
        for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            q = torch.randn((B, H, cfg.head_dim), generator=g,
                            device=dev).to(dt)
            for layer in ((0, L - 1) if layered else (-1,)):
                got = ops.paged_attention(q, pool, bt, cl, layer=layer,
                                          kv_scales=scales, force="kernel")
                want = ref.paged_attention_ref(q, pool, bt, cl, layer=layer,
                                               kv_scales=scales)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    raise AssertionError("paged_attention int8: non-finite "
                                         "output")
                check("paged_attention_int8", dname,
                      f"{'layered' if layered else 'flat'} pool, layer "
                      f"{layer}, B={B} ragged ctx, 4 padded lanes, an EPS "
                      f"row", got, want, TOL[dname], errs)
            layer = L - 1 if layered else -1
            q8, bt8 = q[:8].contiguous(), bt[:8].contiguous()
            cl8 = torch.tensor(EMPTY_SPLIT_CTX, device=dev,
                               dtype=torch.int32)
            bt8[0] = trash
            got = ops.paged_attention(q8, pool, bt8, cl8, layer=layer,
                                      kv_scales=scales, force="kernel")
            want = ref.paged_attention_ref(q8, pool, bt8, cl8, layer=layer,
                                           kv_scales=scales)
            torch.cuda.synchronize()
            check("paged_attention_int8", dname,
                  f"{'layered' if layered else 'flat'} pool, B=8 ctx "
                  f"{EMPTY_SPLIT_CTX}: empty splits", got, want, TOL[dname],
                  errs)
            batch_invariance(torch, ops, q, pool, bt, cl, layer, scales,
                             dname)
        del pool, scales
    # quant_store_tokens, card against CPU: a 512-token prefill chunk that
    # starts mid-block (its last 12 lanes padded onto the trash row), then
    # one decode step of 32 lanes, 4 of them padded
    R = 80
    gc_ = torch.Generator().manual_seed(5)
    pool_c, scales_c = int8_pool(torch, gc_, (R, 2), cfg, P, "cpu")
    pool_g, scales_g = pool_c.to(dev), scales_c.to(dev)
    T, start = 512, 40
    tpos = start + torch.arange(T)
    wrow = 2 + tpos // P
    wrow[-12:] = R - 1
    calls = [(wrow, torch.ones(T, dtype=torch.long), tpos % P,
              torch.randn((T, cfg.num_kv_heads, cfg.head_dim),
                          generator=gc_) * 4.0)]
    drow = torch.arange(40, 40 + 32)
    doff = torch.randint(0, P, (32,), generator=gc_)
    drow[-4:], doff[-4:] = R - 1, 0
    calls.append((drow, torch.zeros(32, dtype=torch.long), doff,
                  torch.randn((32, cfg.num_kv_heads, cfg.head_dim),
                              generator=gc_) * 8.0))
    calls[-1][3][-4:] = calls[-1][3][-1]     # padded lanes write alike
    for wr, lr, wo, vals in calls:
        for side in (0, 1):
            quant.quant_store_tokens(pool_c, scales_c, wr, lr, side, wo, vals)
            quant.quant_store_tokens(pool_g, scales_g, wr.to(dev),
                                     lr.to(dev), side, wo.to(dev),
                                     vals.to(dev))
    torch.cuda.synchronize()
    diff = (pool_g.cpu().int() - pool_c.int()).abs()
    n_diff, max_diff = int((diff > 0).sum()), int(diff.max())
    s_err = ((scales_g.cpu() - scales_c).abs()
             / scales_c.abs().clamp(min=1e-30)).max().item()
    log(f"check quant_store_tokens cuda vs cpu: {n_diff} of {diff.numel()} "
        f"int8 values differ, max {max_diff} LSB; scales max rel err "
        f"{s_err:.3e} (rtol 1e-6)")
    if max_diff > 1 or s_err > 1e-6:
        raise AssertionError("quant_store_tokens: the card disagrees with "
                             "the CPU")
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4

def kernel_timing(torch, ops, ref, quant, cfg, dev="cuda"):
    """Each kernel at main-path shapes in bf16: (ms, plain_ms, bound_ms,
    bound_by, library_ms)."""
    import torch.nn.functional as F
    dt, e = torch.bfloat16, 2
    L, Hkv, D, H = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    P, NB, staging = 16, 1024, 64
    rows = NB + staging + 1
    g = torch.Generator(device=dev).manual_seed(2)
    pool = torch.randn((rows, L, 2, P, Hkv, D), generator=g, device=dev,
                       dtype=torch.float32).to(dt)
    out = {}

    def bound(nbytes, flops):
        tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    # kv_copy: one staging batch of 64 whole rows (2 MiB each)
    flat = pool.view(rows, -1)
    src = np.arange(64, dtype=np.int32)
    dst = np.arange(NB - 64, NB, dtype=np.int32)
    s_t = torch.from_numpy(src.astype(np.int64)).to(dev)
    d_t = torch.from_numpy(dst.astype(np.int64)).to(dev)
    row_bytes = flat[0].numel() * e
    out["kv_copy"] = (
        time_ms(torch, lambda: ops.kv_copy(flat, src, dst, force="kernel")),
        time_ms(torch, lambda: ref.kv_copy_ref(flat, src, dst)),
        *bound(2 * 64 * row_bytes, 0),
        time_ms(torch, lambda: flat.index_copy_(0, d_t, flat.index_select(
            0, s_t))))
    # paged attention in both modes: decode B=32 at context 1024 on one
    # layer of the pool (the shape timed since the first port), then the
    # main path's decode batch, B=8 at context 1024, a different layer each
    # call (one layer's 16.8 MB of K/V would otherwise stay in the 50 MB L2
    # between calls)
    qpool, qscales = int8_pool(torch, g, (rows, L), cfg, P, dev)
    for B, tag in ((32, ""), (8, "@B=8")):
        MB, ctx = 64, 1024
        q = torch.randn((B, H, D), generator=g, device=dev).to(dt)
        bt = torch.randint(0, NB, (B, MB), generator=g, device=dev,
                           dtype=torch.int32)
        cl = torch.full((B,), ctx, device=dev, dtype=torch.int32)
        flops = 4 * B * ctx * H * D
        small = 2 * B * H * D * e + B * MB * 4 + B * 4   # q, out, bt, cl
        for name, kv, sc, kv_bytes in (
                ("paged_attention", pool, None, e),
                ("paged_attention_int8", qpool, qscales, 1)):
            nbytes = (small + B * ctx * Hkv * D * 2 * kv_bytes
                      + (0 if sc is None else B * MB * 2 * Hkv * 4))
            layers = itertools.count()

            def layer():
                return 0 if B == 32 else next(layers) % L
            out[name + tag] = (
                time_ms(torch, lambda: ops.paged_attention(
                    q, kv, bt, cl, layer=layer(), kv_scales=sc,
                    force="kernel")),
                time_ms(torch, lambda: ref.paged_attention_ref(
                    q, kv, bt, cl, layer=layer(), kv_scales=sc)),
                *bound(nbytes, flops), None)
    # the int8 tier's K/V store (plain PyTorch, not a kernel), one side of
    # one layer: a 512-token prefill chunk (its rescale gathers the whole
    # (T, P, Hkv, D) slab) and a 32-lane decode step
    stores = {}
    for what, T in (("prefill T=512", 512), ("decode B=32", 32)):
        wrow = (2 + torch.arange(T, device=dev) // P if T > B
                else 100 + torch.arange(T, device=dev))
        woff = (torch.arange(T, device=dev) % P if T > B
                else torch.full((T,), 5, device=dev))
        lrow = torch.zeros(T, dtype=torch.long, device=dev)
        vals = torch.randn((T, Hkv, D), generator=g, device=dev)
        stores[what] = time_ms(torch, lambda: quant.quant_store_tokens(
            qpool, qscales, wrow, lrow, 0, woff, vals))
    log("time quant_store_tokens (plain torch, K of one layer): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in stores.items()))
    del pool, qpool, qscales
    # flash attention: a 512-token prefill chunk over a 1024-token context
    T, Skv, off = 512, 1024, 512
    q = torch.randn((1, T, H, D), generator=g, device=dev).to(dt)
    k = torch.randn((1, Skv, Hkv, D), generator=g, device=dev).to(dt)
    v = torch.randn((1, Skv, Hkv, D), generator=g, device=dev).to(dt)
    pairs = sum(min(Skv, off + i + 1) for i in range(T))
    nbytes = 2 * T * H * D * e + 2 * Skv * Hkv * D * e
    mask = (torch.arange(Skv, device=dev)[None, :]
            <= off + torch.arange(T, device=dev)[:, None])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out["flash_attention"] = (
        time_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True,
                                                   q_offset=off,
                                                   force="kernel")),
        time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                                       q_offset=off)),
        *bound(nbytes, 4 * pairs * H * D),
        time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)))
    for name, (ms, pms, bms, by, lms) in out.items():
        log(f"time {name}: {ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} "
            f"ms ({by}), library "
            + ("n/a" if lms is None else f"{lms:.4f} ms"))
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------- phases 5 and 6

def make_prompts(cfg, n, plen, olen, seed):
    rng = np.random.default_rng(seed)
    return [([int(x) for x in rng.integers(1, cfg.vocab_size,
                                           int(rng.integers(*plen)))],
             int(rng.integers(*olen))) for _ in range(n)]


KERNEL_FAMILIES = (("paged_decode", "paged_attention"),
                   ("flash_fwd", "flash_attention"),
                   ("kv_copy_kernel", "kv_copy"), ("Memcpy", "memcpy"),
                   ("nvjet", "matmul"), ("gemm", "matmul"),
                   ("cutlass", "matmul"))


def device_time_by_family(prof):
    """Device milliseconds of a torch.profiler trace by kernel family, read
    from the raw trace events (``prof.events()`` would first build the
    whole host event tree, which takes tens of seconds for a serving run)."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        fam = next((f for k, f in KERNEL_FAMILIES if k in name), "other")
        out[fam] = out.get(fam, 0.0) + e.duration_ns() / 1e6
    return out


def serve(torch, cfg, sv, prompts, device, seed=0, trace=False):
    """Serve ``prompts`` [(ids, max_tokens)] to completion through the
    port's ServingEngine with the paged runner; return streams, margins,
    wall seconds, counters, bytes moved each way and the kernel launches of
    this run. ``trace`` records the drain with torch.profiler and adds
    device milliseconds by kernel family."""
    from repro_torch.configs import GH200
    from repro_torch.core.types import RequestState, SamplingParams
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    before = ops.launch_counts()
    eng = ServingEngine(cfg, sv, GH200, runner_seed=seed, device=device)
    ex = eng.executor
    ex.record_margins = True
    handles = [eng.add_request(prompt_ids=ids,
                               sampling_params=SamplingParams(max_tokens=n))
               for ids, n in prompts]
    if device == "cuda":
        torch.cuda.synchronize()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        # device activity only: host events would multiply the trace
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    t0 = time.perf_counter()
    eng.drain()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    for h, (_, n) in zip(handles, prompts):
        r = h.request
        if r.state != RequestState.FINISHED or len(r.generated_ids) != n:
            raise AssertionError(f"req {r.req_id}: {r.state}, "
                                 f"{len(r.generated_ids)}/{n} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.generated_ids):
            raise AssertionError(f"req {r.req_id}: token out of vocabulary")
    margins = {h.req_id: ex.margins[h.req_id] for h in handles}
    if not all(np.isfinite(m).all() for m in margins.values()):
        raise AssertionError("non-finite logits (top-2 margin)")
    st = ex.store
    row_bytes = st.pool[0].numel() * st.pool.element_size()
    if st.quantized:
        row_bytes += st.scales[0].numel() * st.scales.element_size()
    res = dict(
        streams={h.req_id: list(h.request.generated_ids) for h in handles},
        margins=margins, wall_s=wall,
        tokens=sum(len(h.request.generated_ids) for h in handles),
        rotations=eng.stats.active_rotations + eng.stats.passive_preemptions,
        move_wall_s=st.copy_launch_wall_s + st.upload_launch_wall_s,
        prefill_wall_s=ex.prefill_launch_wall_s,
        decode_wall_s=ex.decode_launch_wall_s,
        decode_batches=ex.decode_batches, attn_launches=ex.attn_launches,
        prefill_chunks=ex.prefill_chunks_run, row_bytes=row_bytes,
        launches={k: v - before[k] for k, v in ops.launch_counts().items()},
        **{c: getattr(st, c) for c in ROW_MOVES})
    if prof is not None:
        res["device_ms"] = device_time_by_family(prof)
    if res["attn_launches"] != res["decode_batches"] * cfg.num_layers:
        raise AssertionError("attn_launches != decode_batches x layers")
    del eng, ex, st, handles
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def agreement(a, b):
    """Share of positions on which two runs emitted the same token, and the
    first divergence with both runs' top-2 margins there."""
    same = total = 0
    first = None
    for rid in sorted(a["streams"]):
        x, y = a["streams"][rid], b["streams"][rid]
        for i, (s, t) in enumerate(zip(x, y)):
            total += 1
            same += s == t
            if s != t and first is None:
                first = (rid, i, a["margins"][rid][i], b["margins"][rid][i])
    return same / max(total, 1), first


def serving_runs(torch, cfg, prompts, sv_kw, hbm_ample, device, label):
    """Runs (a) ample and (b) tight HBM; (b) holds the two largest
    requests."""
    from repro_torch.configs import ServingConfig
    P = sv_kw["block_size"]
    need = sorted((-(-(len(ids) + n) // P) for ids, n in prompts),
                  reverse=True)
    hbm_tight = need[0] + need[1]
    out = {}
    for run, hbm in (("a", hbm_ample), ("b", hbm_tight)):
        sv = ServingConfig(num_hbm_blocks=hbm, paged_runner=True, **sv_kw)
        res = serve(torch, cfg, sv, prompts, device)
        rb = res["row_bytes"]
        log(f"{label} run ({run}) hbm={hbm} blocks: wall {res['wall_s']:.3f} "
            f"s, {res['tokens']} tokens, "
            f"{res['tokens'] / res['wall_s']:.2f} tok/s, rotations "
            f"{res['rotations']}, rows d2h {res['d2h_rows']} h2d "
            f"{res['h2d_rows']} d2d {res['d2d_rows']} of {rb} bytes (bytes "
            f"d2h {res['d2h_rows'] * rb} h2d {res['h2d_rows'] * rb} d2d "
            f"{res['d2d_rows'] * rb}), copy launches "
            f"{res['copy_launches']}, host wall in row movement "
            f"{res['move_wall_s']:.3f} s, prefill dispatch "
            f"{res['prefill_wall_s']:.3f} s, decode dispatch "
            f"{res['decode_wall_s']:.3f} s, decode batches "
            f"{res['decode_batches']}, prefill chunks "
            f"{res['prefill_chunks']}, kernel launches {res['launches']}")
        out[run] = res
    b = out["b"]
    if not (b["rotations"] > 0 and b["d2h_rows"] > 0 and b["h2d_rows"] > 0
            and b["copy_launches"] > 0):
        raise AssertionError(f"{label} run (b) did not rotate: {b}")
    return out


def store_roundtrip(torch, cfg):
    """An int8 PagedKVStore on the card: rows and scale rows come back
    byte-identical after swap-out (d2h) and swap-in (h2d), and after a CoW
    fork (d2d)."""
    from repro_torch.configs import ServingConfig
    from repro_torch.core.blocktable import TransferDesc
    from repro_torch.serving.paged_runner import PagedKVStore
    sv = ServingConfig(num_hbm_blocks=16, num_dram_blocks=64, block_size=4,
                       max_model_len=64)
    st = PagedKVStore(cfg, sv, torch.float32, device="cuda", staging=4,
                      kv_dtype="int8")
    g = torch.Generator(device="cuda").manual_seed(6)
    n = 6
    rows = torch.randint(-127, 128, (n,) + st.row_shape, generator=g,
                         device="cuda", dtype=torch.int8)
    srows = torch.rand((n,) + st.scale_row_shape, generator=g, device="cuda")
    st.pool[:n], st.scales[:n] = rows, srows

    def desc(i, src, dst):
        return TransferDesc(block_id=i, req_id=0, direction="d2h",
                            src_slot=src, dst_slot=dst, nbytes=1, segments=1)

    st.run_d2h([desc(i, i, 100 + i) for i in range(n)])
    st.pool[:n] = 0
    st.scales[:n] = 0
    st.run_h2d([desc(i, 100 + i, 8 + i) for i in range(n)])
    st.run_d2d([(8, 7)])
    torch.cuda.synchronize()
    ok = (torch.equal(st.pool[8:8 + n], rows)
          and torch.equal(st.scales[8:8 + n], srows)
          and torch.equal(st.pool[7], rows[0])
          and torch.equal(st.scales[7], srows[0]))
    log(f"int8 store on the card: {n} rows and scale rows byte-identical "
        f"after d2h -> h2d and a d2d fork: {ok}")
    if not ok:
        raise AssertionError("int8 store: rows changed in movement")


def cli_run(torch):
    """``python -m repro_torch.launch.serve --paged-runner --kv-dtype int8``
    on the card, in a subprocess, as a user runs it."""
    import os
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root / "src"), os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--paged-runner",
           "--kv-dtype", "int8", "--hbm-blocks", "96", "--rps", "5",
           "--duration", "5", "--seed", "0", "--json"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"serve CLI exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    row = json.loads(proc.stdout)
    log(f"serve CLI ({' '.join(cmd[2:])}), rc 0 in {wall:.2f} s: "
        + json.dumps(row, sort_keys=True))
    if not (row.get("decode_tokens", 0) > 0 and row.get("kv_dtype") == "int8"
            and row.get("paged_runner")):
        raise AssertionError(f"serve CLI decoded nothing: {row}")


# ---------------------------------------------------------------- phase 8

def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sse_stream(port, body, out, stop_after=None, timeout=300.0):
    """POST /v1/generate and read its SSE events as they arrive, each
    stamped with the client's clock on receipt; ``stop_after`` events, then
    close the socket (a client that goes away mid-stream). Fills ``out``
    with t0 (send time), events and stamps."""
    import socket
    payload = json.dumps(body).encode()
    head = (f"POST /v1/generate HTTP/1.1\r\nHost: smoke\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n").encode()
    buf, pos, events, stamps = b"", 0, [], []
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        out["t0"] = time.perf_counter()
        s.sendall(head + payload)
        while chunk := s.recv(65536):
            now = time.perf_counter()
            buf += chunk
            while (a := buf.find(b"data: ", pos)) != -1:
                b = buf.find(b"\n\n", a)
                if b == -1:
                    break
                events.append(json.loads(buf[a + 6:b]))
                stamps.append(now)
                pos = b + 2
            if events and events[-1]["finished"]:
                break
            if stop_after is not None and len(events) >= stop_after:
                break
    out.update(events=events, stamps=stamps)


def http_get(port, path):
    import socket
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(f"GET {path} HTTP/1.1\r\nHost: smoke\r\n\r\n".encode())
        raw = b""
        while chunk := s.recv(65536):
            raw += chunk
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), body


def pct(xs, q):
    return float(np.percentile(xs, q)) if xs else float("nan")


def client_latencies(results):
    """Client-side TTFT per request (send to first token event) and TBT
    (gap between token events over the tokens the later one carries), wall
    seconds, plus the share of TBT gaps under 1 ms (events that arrived in
    one burst)."""
    ttft, tbt = [], []
    for r in results:
        tok = [(t, e["new_tokens"]) for t, e in zip(r["stamps"], r["events"])
               if e["new_tokens"] > 0]
        if not tok:
            continue
        ttft.append(tok[0][0] - r["t0"])
        tbt += [(b[0] - a[0]) / b[1] for a, b in zip(tok, tok[1:])]
    burst = sum(g < 1e-3 for g in tbt) / max(len(tbt), 1)
    return ttft, tbt, burst


def server_phase(torch, cfg, prompts):
    """The HTTP front door at full width, in process: EngineCore with the
    paged runner on the card behind AsyncServingEngine(pace=True) and
    InferenceServer, as serve_main composes them; 8 concurrent streaming
    clients on S1's prompts and a ninth that leaves mid-stream. HBM holds
    the two largest requests (phase 5's run (b)), so RotaSched rotates
    under the load and ``kv_copy`` runs from the driver thread."""
    import asyncio
    import threading
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import GH200, ServingConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.async_engine import AsyncServingEngine
    from repro_torch.serving.core import EngineCore
    from repro_torch.serving.server import InferenceServer, ServerConfig
    t_phase = time.perf_counter()
    need = sorted((-(-(len(ids) + n) // 16) for ids, n in prompts),
                  reverse=True)
    sv = ServingConfig(paged_runner=True, block_size=16, prefill_chunk=512,
                       num_hbm_blocks=need[0] + need[1])
    core = EngineCore(cfg, sv, GH200, runner_cfg=cfg, device="cuda")
    free0 = core.kv.hbm_free_blocks
    box, ready, lags = {}, threading.Event(), []

    async def serve():
        loop = asyncio.get_running_loop()
        service = AsyncServingEngine(core, pace=True)
        server = InferenceServer(service, ServerConfig(port=0, device="cuda"))
        await service.start()
        await server.start()
        box.update(loop=loop, server=server, service=service)
        ready.set()

        async def lag_probe():          # how late the loop wakes up
            while True:
                t = loop.time()
                await asyncio.sleep(0.005)
                lags.append(loop.time() - t - 0.005)
        probe = asyncio.ensure_future(lag_probe())
        try:
            box["code"] = await server.run_until_shutdown()
        finally:
            probe.cancel()

    th = threading.Thread(target=lambda: asyncio.run(serve()), daemon=True)
    th.start()
    if not ready.wait(120):
        raise AssertionError("server phase: the server did not start")
    t_setup = time.perf_counter() - t_phase
    port, loop = box["server"].port, box["loop"]
    for path in ("/healthz", "/readyz"):
        status, body = http_get(port, path)
        if status != 200:
            raise AssertionError(f"{path} answered {status}: {body!r}")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    rng = np.random.default_rng(9)
    quitter = [int(x) for x in rng.integers(1, cfg.vocab_size, 300)]
    bodies = [dict(prompt_ids=ids, max_tokens=n, ignore_eos=True,
                   slo_class="interactive" if i % 2 else "standard")
              for i, (ids, n) in enumerate(prompts)]
    results = [{} for _ in range(len(bodies) + 1)]
    threads = [threading.Thread(target=sse_stream, args=(port, b, r))
               for b, r in zip(bodies, results)]
    threads.append(threading.Thread(target=sse_stream, args=(
        port, dict(prompt_ids=quitter, max_tokens=64), results[-1], 3)))
    lags.clear()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    lag_ms = [x * 1e3 for x in lags]
    deadline = time.monotonic() + 120
    while core.has_work and time.monotonic() < deadline:
        time.sleep(0.05)
    torch.cuda.synchronize()
    t_trace = time.perf_counter()
    prof.stop()
    busy = sum(device_time_by_family(prof).values())
    t_trace = time.perf_counter() - t_trace
    launches = ops.launch_counts()
    status, body = http_get(port, "/v1/metrics")
    row = json.loads(body)
    loop.call_soon_threadsafe(box["server"].request_shutdown)
    th.join(120)
    if th.is_alive() or box.get("code") != 0:
        raise AssertionError(f"server phase: shutdown gave {box.get('code')}")
    for (ids, n), r in zip(prompts, results[:-1]):
        last = r["events"][-1] if r.get("events") else {}
        if not (last.get("finished") and last.get("finish_reason") == "length"
                and last.get("tokens_generated") == n
                and len(last.get("token_ids") or []) == n):
            raise AssertionError(f"server phase: stream ended {last}")
    rid = results[-1]["events"][0]["req_id"]
    quit_req = next(r for r in core.submitted if r.req_id == rid)
    if quit_req.finish_reason != "aborted":
        raise AssertionError(f"server phase: the client that left has its "
                             f"request {quit_req.finish_reason!r}")
    rotations = core.stats.active_rotations + core.stats.passive_preemptions
    if not rotations:
        raise AssertionError("server phase: nothing rotated")
    if core.kv.hbm_free_blocks != free0:
        raise AssertionError(f"server phase: {core.kv.hbm_free_blocks} HBM "
                             f"blocks free after the drain, {free0} before")
    idle = [k for k in ("flash_attention", "paged_attention", "kv_copy")
            if not launches[k]]
    if idle:
        raise AssertionError(f"server phase: kernels never launched {idle}")
    ttft, tbt, burst = client_latencies(results[:-1])
    st = core.executor.store
    log(f"server phase: 8 streams + 1 that left at its 3rd event, all "
        f"finished in {wall:.3f} s wall; hbm={sv.num_hbm_blocks} blocks, "
        f"rotations {rotations}, rows d2h {st.d2h_rows} h2d {st.h2d_rows}, "
        f"engine steps "
        f"{box['service'].steps}; kernel launches {launches}")
    log(f"server phase, client side (wall s): TTFT median {pct(ttft, 50):.4f} "
        f"p99 {pct(ttft, 99):.4f}; TBT median {pct(tbt, 50):.5f} p99 "
        f"{pct(tbt, 99):.5f} over {len(tbt)} gaps, {burst:.3f} of them "
        f"under 1 ms (burst delivery)")
    log(f"server phase, event-loop lag of a 5 ms sleep (ms): median "
        f"{pct(lag_ms, 50):.3f} p99 {pct(lag_ms, 99):.3f} max "
        f"{max(lag_ms, default=float('nan')):.3f} over {len(lag_ms)} wakes")
    log(f"server phase, device busy {busy:.1f} ms of {wall * 1e3:.1f} ms "
        f"wall ({busy / (wall * 1e3):.3f})")
    keys = ("n", "ttft_attainment", "tbt_attainment", "p50_ttft", "p99_ttft",
            "p50_tbt", "p99_tbt", "total_time_s", "n_aborted")
    log("server phase, /v1/metrics (engine clock: the GH200 model): "
        + json.dumps({k: row.get(k) for k in keys} | {
            "server": row.get("server")}, sort_keys=True))
    log(f"phase 8 wall: {time.perf_counter() - t_phase:.2f} s (engine, "
        f"weights and server {t_setup:.2f} s, the load {wall:.2f} s, trace "
        f"processing {t_trace:.2f} s)")
    del core, st, box
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 9

def supervisor_phase():
    """``python -m repro_torch.launch.server_main --paged-runner`` as a
    user runs it on the card: one stream read to its end, then SIGTERM and
    a clean drain. Returns the kernel launches the server child reports in
    its exit line (its whole life, which is this path alone)."""
    import os
    import signal
    import socket
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root / "src"), os.environ.get("PYTHONPATH")) if p))
    port = free_port()
    drain = 15.0
    errf = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.server_main",
         "--paged-runner", "--port", str(port), "--drain-timeout", str(drain)],
        cwd=root, env=env, stdout=subprocess.DEVNULL, stderr=errf, text=True)
    rc, out = None, {}
    try:
        deadline = time.monotonic() + 180
        while proc.poll() is None and time.monotonic() < deadline:
            try:
                socket.create_connection(("127.0.0.1", port), timeout=5).close()
                break
            except OSError:
                time.sleep(0.2)
        else:
            raise AssertionError("supervisor: the server never listened")
        t_up = time.perf_counter() - t0
        ids = [int(x) for x in np.random.default_rng(4).integers(1, 256, 40)]
        sse_stream(port, dict(prompt_ids=ids, max_tokens=16), out)
        last = out["events"][-1]
        if not (last["finished"] and last["tokens_generated"] == 16
                and len(last["token_ids"]) == 16):
            raise AssertionError(f"supervisor: stream ended {last}")
        t_sig = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(drain + 30)
        t_drain = time.perf_counter() - t_sig
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        errf.seek(0)
        err = errf.read()
        errf.close()
        if rc is None:
            log(f"supervisor's stderr: {err[-3000:]}")
    if rc != 0 or '"event": "launcher_exit", "code": 0' not in err:
        raise AssertionError(f"supervisor exited {rc}: {err[-3000:]}")
    exits = [json.loads(line) for line in err.splitlines()
             if '"event": "server_exit"' in line]
    launches = exits[-1]["kernel_launches"] if exits else {}
    log(f"supervisor: up in {t_up:.2f} s, a 16-token stream of "
        f"{len(out['events'])} events, tokens {last['token_ids']}; SIGTERM "
        f"-> rc 0 in {t_drain:.2f} s (drain timeout {drain:g} s); the "
        f"server's kernel launches {launches}")
    idle = [k for k in ("flash_attention", "paged_attention")
            if not launches.get(k)]
    if idle:
        raise AssertionError(f"supervisor: kernels never launched {idle}")
    log(f"phase 9 wall: {time.perf_counter() - t0:.2f} s")
    return launches


# --------------------------------------------------------------- phase 10

def dense_run(torch, cfg, prompts, params, sv_kw, hbm, device, label):
    """The dense per-request executor behind ServingEngine on ``device``
    with ``hbm`` blocks: its streams, rotations and wall."""
    from repro_torch.configs import GH200, ServingConfig
    from repro_torch.core.types import SamplingParams
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.executor import RealExecutor
    eng = ServingEngine(cfg, ServingConfig(num_hbm_blocks=hbm, **sv_kw),
                        GH200, real_executor=RealExecutor(
                            cfg, device=device, params=params))
    handles = [eng.add_request(
        prompt_ids=ids, sampling_params=SamplingParams(max_tokens=n))
        for ids, n in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = {h.req_id: list(h.request.generated_ids) for h in handles}
    for (_, n), s in zip(prompts, streams.values()):
        if len(s) != n or not all(0 <= t < cfg.vocab_size for t in s):
            raise AssertionError(f"{label}: a stream of {len(s)} tokens, {n} "
                                 f"asked")
    rot = eng.stats.active_rotations + eng.stats.passive_preemptions
    ntok = sum(len(s) for s in streams.values())
    log(f"{label} hbm={hbm} blocks on {device}: wall {wall:.3f} s, {ntok} "
        f"tokens, {ntok / wall:.2f} tok/s, rotations {rot}")
    del eng, handles
    gc.collect()
    torch.cuda.empty_cache()
    return dict(streams=streams, rotations=rot, wall_s=wall)


def dense_runs(torch, cfg, prompts, params, sv_kw, hbm_ample, hbm_tight,
               label):
    """The dense executor on the card: (a) ample HBM, (b) tight HBM, which
    forces rotation through swap_out/swap_in; equal streams asserted."""
    out = {run: dense_run(torch, cfg, prompts, params, sv_kw, hbm, "cuda",
                          f"{label} run ({run})")
           for run, hbm in (("a", hbm_ample), ("b", hbm_tight))}
    if out["b"]["rotations"] == 0:
        raise AssertionError(f"{label} run (b) did not rotate")
    if out["a"]["streams"] != out["b"]["streams"]:
        raise AssertionError(f"{label}: token streams differ under rotation")
    log(f"lossless: {label} token streams equal with and without rotation")
    return out


def dense_phase(torch, cfg, prompts, paged_a):
    """The dense path: llama3-8b at full width in bf16, then
    gemma3-1b.reduced() at 6 layers in fp32 (windows of 32, one global
    layer, prompts longer than the window)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.params import init_lm_params
    t0 = time.perf_counter()
    params = init_lm_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    # (b): HBM for the two largest requests, as phase 5's run (b)
    need = sorted((-(-(len(ids) + n) // 16) for ids, n in prompts),
                  reverse=True)
    ops.reset_launch_counts()
    full = dense_runs(torch, cfg, prompts, params,
                      dict(block_size=16, prefill_chunk=512), 1024,
                      need[0] + need[1], "llama3-8b dense bf16")
    launches = ops.launch_counts()
    log(f"dense path kernel launches: {launches}")
    if not launches["flash_attention"]:
        raise AssertionError("dense path: flash_attention never launched")
    same = total = 0
    for rid, s in full["a"]["streams"].items():
        for x, y in zip(s, paged_a["streams"][rid]):
            same += x == y
            total += 1
    log(f"llama3-8b bf16 dense run (a) vs paged run (a) of phase 5, same "
        f"weights (reported, not asserted): {same / max(total, 1):.4f} of "
        f"tokens agree")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    gcfg = dataclasses.replace(get_config("gemma3-1b").reduced(),
                               dtype="float32", num_layers=6)
    gprompts = make_prompts(gcfg, 5, (40, 61), (10, 17), seed=3)
    gparams = init_lm_params(gcfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda")
    # (b): 25 blocks rotate 28 times on the model's clock; at 29 the
    # scheduler livelocks on these requests (ROADMAP.md §3)
    gsv = dict(block_size=4, prefill_chunk=8, max_model_len=128,
               num_dram_blocks=512)
    glabel = "gemma3-1b-reduced 6 layers fp32 dense"
    gruns = dense_runs(torch, gcfg, gprompts, gparams, gsv, 4096, 25, glabel)
    # the same weights on the CPU (the plain flash version), run (b): the
    # card's flash kernel, window and global layer, must give its streams
    cpu_params = {part: ([{k: v.cpu() for k, v in layer.items()}
                          for layer in tree] if part == "layers"
                         else {k: v.cpu() for k, v in tree.items()})
                  for part, tree in gparams.items()}
    cpu = dense_run(torch, gcfg, gprompts, cpu_params, gsv, 25, "cpu",
                    f"{glabel} run (b)")
    if cpu["streams"] != gruns["b"]["streams"]:
        raise AssertionError(f"{glabel}: the card's streams differ from the "
                             f"CPU's")
    log(f"{glabel}: the card's streams equal the CPU's from the same "
        f"weights")
    log(f"phase 10 wall: {time.perf_counter() - t0:.2f} s")
    return launches


def main(argv) -> int:
    if argv not in ([], ["--timing"]):
        log("usage: chip_smoke.py [--timing]")
        return 2
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import ServingConfig, get_config
    from repro_torch.kernels import _build, ops, quant, ref

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(_build.SOURCES)} "
        f"kernels ({_build.nvcc_path()})")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    cfg = get_config("llama3-8b")
    if argv:                             # --timing: phase 4 alone
        print(json.dumps({"timing": kernel_timing(torch, ops, ref, quant,
                                                  cfg)}), flush=True)
        return 0

    # 3. kernel vs plain
    errs = {}
    kernel_checks(torch, ops, ref, cfg, errs)
    int8_checks(torch, ops, ref, quant, cfg, errs)

    # 4. timing
    times = kernel_timing(torch, ops, ref, quant, cfg)

    # 5. full-width serving: the bf16 path, then the int8 tier's; each
    # path's launch counts are read from its own two runs
    prompts = make_prompts(cfg, 8, (200, 1001), (32, 65), seed=0)
    paths = {"bf16": ("kv_copy", "paged_attention", "flash_attention"),
             "int8": ("kv_copy", "paged_attention_int8", "flash_attention")}
    full, launches = {}, {}
    for kvd, needed in paths.items():
        ops.reset_launch_counts()
        full[kvd] = serving_runs(
            torch, cfg, prompts,
            dict(block_size=16, prefill_chunk=512, kv_dtype=kvd), 1024,
            "cuda", f"llama3-8b {kvd} KV")
        launches[kvd] = ops.launch_counts()
        log(f"main-path kernel launches, {kvd} KV: {launches[kvd]}")
        idle = [k for k in needed if not launches[kvd][k]]
        stray = [k for k in ("paged_attention", "paged_attention_int8")
                 if k not in needed and launches[kvd][k]]
        if idle or stray:
            raise AssertionError(f"{kvd} path: kernels never launched "
                                 f"{idle}, other mode launched {stray}")
        share, first = agreement(full[kvd]["a"], full[kvd]["b"])
        log(f"llama3-8b {kvd} KV (a) vs (b): {share:.4f} of tokens agree; "
            f"first divergence (req, step, margin a, margin b): {first}")
    share, first = agreement(full["bf16"]["a"], full["int8"]["a"])
    log(f"llama3-8b run (a), int8 KV vs bf16 KV top-1 agreement (reported, "
        f"not asserted): {share:.4f}; first divergence (req, step, margin "
        f"bf16, margin int8): {first}")
    log(f"bytes per moved row: int8 {full['int8']['a']['row_bytes']} vs "
        f"bf16 {full['bf16']['a']['row_bytes']} (ratio "
        f"{full['int8']['a']['row_bytes'] / full['bf16']['a']['row_bytes']:.4f})")
    # where the time goes: run (a) of each path again under torch.profiler
    for kvd in paths:
        traced = serve(torch, cfg, ServingConfig(
            num_hbm_blocks=1024, paged_runner=True, block_size=16,
            prefill_chunk=512, kv_dtype=kvd), prompts, "cuda", trace=True)
        busy = sum(traced["device_ms"].values())
        wall_ms = traced["wall_s"] * 1e3
        log(f"llama3-8b {kvd} KV run (a) traced: wall {wall_ms:.1f} ms, "
            f"device busy {busy:.1f} ms ({busy / wall_ms:.3f} of wall), by "
            f"family " + ", ".join(
                f"{k} {v:.1f} ms" for k, v in
                sorted(traced["device_ms"].items(), key=lambda kv: -kv[1])))

    # 6. lossless: reduced llama3-8b in fp32, ample vs tight HBM
    tiny = dataclasses.replace(cfg.reduced(), dtype="float32")
    small = make_prompts(tiny, 5, (8, 16), (10, 16), seed=3)
    store_roundtrip(torch, tiny)
    for kvd in paths:
        lossless = serving_runs(torch, tiny, small,
                                dict(block_size=4, prefill_chunk=8,
                                     max_model_len=64, num_dram_blocks=512,
                                     kv_dtype=kvd),
                                4096, "cuda", f"llama3-8b-reduced fp32 {kvd}")
        if lossless["a"]["streams"] == lossless["b"]["streams"]:
            log(f"lossless: reduced fp32 {kvd} token streams equal with and "
                f"without rotation")
            continue
        share, first = agreement(lossless["a"], lossless["b"])
        if kvd == "int8" and share >= 0.99 and min(first[2:]) < 1e-4:
            # a near-tie flip; the rows themselves moved byte for byte
            # (store_roundtrip above)
            log(f"lossless: reduced fp32 int8 streams differ at a near tie "
                f"(agree {share:.4f}, first {first}); rows and scale rows "
                f"are byte-identical after swap-out and swap-in")
            continue
        raise AssertionError(f"lossless: {kvd} streams differ under rotation "
                             f"(agree {share:.4f}, first {first})")

    # 7. the port's serving CLI on the card, as a user runs it
    cli_run(torch)

    # 8. the HTTP front door at full width, in process
    launches["server"] = server_phase(torch, cfg, prompts)

    # 9. the supervised launcher as a user runs it
    launches["supervisor"] = supervisor_phase()

    # 10. the dense per-request executor: full width bf16, reduced gemma3
    launches["dense"] = dense_phase(torch, cfg, prompts, full["bf16"]["a"])

    sources = {"kv_copy": ("kv_copy.cu", "src/repro/kernels/kv_copy.py:29"),
               "paged_attention": ("paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:84"),
               "paged_attention_int8": ("paged_attention.cu", INT8_REPLACES),
               "flash_attention": ("flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:72")}
    kernels = []
    for name, (src, replaces) in sources.items():
        ms, pms, bms, by, lms = times[name]
        entry = dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}", replaces=replaces,
            launches=sum(c.get(name, 0) for c in launches.values()),
            max_abs_err=errs[name], ms=ms, plain_ms=pms, bound_ms=bms,
            bound_by=by, library_ms=lms,
            launches_by_phase={phase: c.get(name, 0) for phase, c in
                               (("5_bf16", launches["bf16"]),
                                ("5_int8", launches["int8"]),
                                ("8_server", launches["server"]),
                                ("9_supervisor", launches["supervisor"]),
                                ("10_dense", launches["dense"]))})
        if name + "@B=8" in times:     # the main path's own decode batch
            ms, pms, bms, by, lms = times[name + "@B=8"]
            entry["at_decode_batch_8"] = dict(
                ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                library_ms=lms)
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
