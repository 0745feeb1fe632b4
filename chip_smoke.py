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
   llama3-8b's and the reduced gemma3's heads, head_dim 256 at gemma3-1b's
   and paligemma-3b's heads (causal with q_offset, window 512, non-causal
   with Sq != Skv), seamless-m4t's non-causal encoder and cross-attention;
   paged: B=8 with empty splits), each within a stated tolerance; the
   paged kernel's output for one sequence bitwise equal alone and in a
   batch; ``quant_store_tokens`` on the card against the CPU; paged
   attention (both modes) and flash at a tensor-parallel shard's heads,
   llama3-8b's tp=2 (16/4/128) and tp=8 (4/1/128); flash at phase 17's
   prefill shards (llama3-8b 16/4/128 over 1016 tokens, the reduced
   gemma3-1b 2/1/16 under its 32-token window), phase 18's
   (qwen3-moe-30b-a3b 16/2/128 over 1016 tokens) and phase 19's
   (paligemma-3b 4/1/256 causal over 1016 positions, seamless-m4t's
   encoder 8/8/64 non-causal over 1024 frames and its cross-attention of
   1016 tokens over 1024 frames);
4. timing: each kernel at main-path shapes (CUDA events, median after
   warm-up) beside its bound, its plain version and a library yardstick;
   paged attention also at the main path's decode batch (B=8, ctx 1024,
   both modes, a different layer each call so no call finds the last in
   L2); flash also at head_dim 256 (gemma3-1b's heads under its window,
   paligemma-3b's over its 320-position prompt) and at the training shape
   of phase 12 (gemma3-1b's heads, 2 x 1024 tokens, causal, window 512),
   beside the plain PyTorch backward of that attention layer;
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
   paged run is printed with the first divergence and both runs' top-2
   margins there), then gemma3-1b.reduced() at 6 layers in fp32,
   whose local layers have a 32-token window: lossless under rotation, and
   the card's streams equal the CPU's from the same weights;
11. families: ``RealExecutor`` behind ``ServingEngine`` at full width in
   bf16 on qwen3-moe-30b-a3b (24 of its 48 layers of 128 experts, 30.5 GB
   of weights), mamba2-2.7b (SSM, 16 of its 64 layers: ``FAMILY_DEPTH``)
   and gemma3-1b (head_dim 256, window 512), 4 requests
   each, with ample HBM (traced: device busy share) and with 77 blocks,
   which rotates (equal streams; flash launched where there is attention);
   paligemma-3b (256 image embeddings before 64 tokens) and
   seamless-m4t-medium (an encoder over 1024 frames) through
   ``LM.prefill`` and 16 greedy ``decode_step``s, held to the
   decode-continuity check in bf16; then the reduced qwen3-moe, mamba2 and
   jamba (8 layers) in fp32, lossless under rotation and equal to the CPU;
12. training (target about 60 s): ``python -m repro_torch.launch.train``'s
   ``main`` in process on gemma3-1b at full width and depth (26 layers, d
   1152, head_dim 256, window 512, tied 262k vocabulary, bf16), batch 4 x
   1024 in 2 microbatches, int8 moments, 6 steps with a checkpoint at step
   3, then ``--resume`` from it: finite losses, resumed losses within 2e-2
   of the uninterrupted run's, flash launched once a layer forward and
   once in remat's recompute; wall per step, tokens/s, peak memory and one
   traced step's busy share by kernel family; the reference example's
   geometry (``examples/torch/train_100m.py``: width 512, 12 layers, 30
   steps), whose loss must fall; and the reduced gemma3-1b (6 layers) in
   fp32, loss and every gradient on the card against the CPU (loss within
   1e-5 relative, gradients within atol 1e-5, rtol 1e-4);
13. tooling (target 90 s): ``repro_torch.launch.audit_donation.audit`` at
   llama3-8b's full width with bf16 weights and S1 (a)'s pool (1,024 HBM
   blocks, block 16, chunk 512), bf16 and int8 KV, at tp=1 and at tp=2
   (two shards stacked on the card): every launch entry (row copy,
   upload, decode, prefill) keeps its buffers (each shard's) and writes
   them, with its peak memory growth below one (shard's) pool's bytes, and
   the out-of-place control is caught; the roofline of one S1 decode
   iteration (B=8, contexts about 1,024, bf16: ``launch/roofline.py``'s
   terms against the traced device ms and the wall ms); then as
   subprocesses ``python -m repro_torch.launch.inspect_hlo --arch
   llama3-8b --shape decode_32k --periods 1`` and, alongside it, ``python
   -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k --mesh
   both`` (bytes, FLOPs, and the collective bytes counted over 256 and 512
   meta positions), each of which must exit 0;
14. tensor parallelism (target 90 s): (a) llama3-8b at full width in
   bf16, cut to ``TP_DEPTH`` (4) of its 32 layers, at tp=1 and at tp=2
   with both shards on the card (``device=["cuda:0", "cuda:0"]``), phase
   5's prompts and seed, 1024 and 119 HBM blocks, bf16 and int8 KV: run
   (b) rotates, a shard holds and moves half the bytes, each shard's paged
   launch is counted (twice the runner's layer launches), all three
   kernels launch, and no request's first divergence from tp=1's streams
   has both top-2 margins above ``DIVERGENCE_TIE`` (the partials add in
   bf16); run (a) traced: wall,
   busy share, peak memory. Stacked shards do the same work with twice
   the launches: no number here is a TP speed-up. (b) the reduced
   llama3-8b in fp32 (8/4/16) at tp 1, 2 and 4 under rotation, the
   replicated-attention fallback (2 kv heads) at tp 4 and the int8 tier
   at tp 2: streams equal tp=1's on the card and the CPU's; the int8
   shards' scales against tp=1's. (c) (b) over two cards, only where the
   machine has them;
15. training on a mesh (target 90 s; cell S10): (a) gemma3-1b at full
   width and depth through the launcher with ``--mesh 2,2 --device
   cuda:0,cuda:0,cuda:0,cuda:0`` (four shards stacked on the card),
   phase 12's seeded weights and data, 4 x 1024 in 2 microbatches, int8
   moments, remat, 3 steps: losses within 2e-2 of phase 12's first 3,
   flash launched once a shard a layer forward and once in recompute;
   then the same step through ``make_train_step(mesh=)``: the params and
   moments each position holds equal ``dryrun.tree_bytes_per_device`` to
   the byte; wall per step, tokens/s, peak memory, one traced step's busy
   share by family, collective bytes per position and the roofline's
   compute, memory and collective terms. (b) qwen3-moe-30b-a3b at full
   width, 4 of its 48 layers, bf16 weights from a seeded generator, int8
   moments, 2 x 512: with no mesh, on (1, 2) stacked (64 experts a shard:
   losses within 2e-2 of no mesh's), then on (2, 2) (finite losses, the
   dropped assignments per data shard). (c) the reduced llama3-8b and
   qwen3-moe in fp32 on (2, 2) stacked against the same on the CPU (loss
   within 1e-5 relative, params after 2 steps within atol 1e-5, rtol
   1e-4), and a checkpoint saved on (2, 2) restored on (1, 2) and with no
   mesh to equal leaves. (d) (a) over four cards, only where the machine
   has them (``scripts/mesh_cards.py --phase 15`` runs it there). Phase 3
   also checks flash at this phase's shard heads (gemma3-1b (2, 1, 256),
   qwen3-moe (16, 2, 128)) and ``FlashAttention``'s gradient at (2, 1,
   256);
16. the SSM, hybrid, frontend and encoder-decoder families on a mesh
   (target 90 s; cell S11), four shards stacked on the card: (a)
   mamba2-2.7b at full width and ``MESH_FAMILY_DEPTH`` (8) of its 64
   layers (d_in 5120, 80 heads, 40 a model shard; phase 18 serves 16)
   through the launcher
   with no mesh and with ``--mesh 2,2 --device
   cuda:0,cuda:0,cuda:0,cuda:0``, seeded bf16 weights,
   ``SyntheticPacked`` seed 0, 4 x 1024 in 2 microbatches, int8 moments,
   remat, 2 steps: losses within 1e-3 of no mesh's, the launcher's step
   walls, the state after 2 steps against no mesh's (each parameter's sum
   of |x| and each int8 moment's dequantised norm within 0.1, parameters
   and moments apart) with the drawn state as the frozen-update control
   (it must read past 0.1 on both), bytes a position == the dry-run's, then
   one traced step through ``make_train_step(mesh=)``: busy share, peak
   memory, collective bytes by kind and the top device operations. (b)
   paligemma-3b (256 image embeddings + 768 tokens) and
   seamless-m4t-medium (1024 frames + 1024 tokens) at full width and
   depth, 2 rows, embeddings from a seeded generator, int8 moments, 2
   steps through ``make_train_step`` with no mesh and on (2, 2), in bf16
   (losses within ``FAMILY_BF16_TOL``) and in fp32 (within 1e-5
   relative), flash launched at each shard's heads (counted). (c) the
   reduced mamba2, jamba (8 layers), paligemma and seamless in fp32 on
   (2, 2), card against CPU (losses within 1e-6 relative, fp32 moments
   after 2 steps within 1e-6, params within atol 1e-5 + rtol 1e-4 but
   where the first step's gradient lies within ``ADAM_FLAT`` eps of zero:
   at most ``MAX_FLAT`` such elements apart, within 2 lr a step), and a
   checkpoint of the reduced mamba2 saved on (2, 2) restored on (1, 2).
   Phase 3 also checks flash at this phase's shard heads (paligemma (4,
   1, 256) causal, seamless (8, 8, 64) non-causal and cross-attention)
   and ``FlashAttention``'s gradient at seamless's encoder shard;
17. prefill and decode on a mesh (target 60 s; cell S12), four positions
   stacked on the card: (a) llama3-8b at full width, 8 of its 32 layers
   (``SERVE_MESH_DEPTH``), seeded bf16 weights (seed 0)
   placed on (2, 2) beside a copy with no mesh; 4 prompts of 1,016
   tokens (numpy seed 13) prefilled at capacity 4,096 under
   ``PREFILL_RULES`` (flash at each position's 16 q heads: 8 x 4
   launches, counted), the caches moved to ``DECODE_RULES`` (their
   sequence over the whole grid, four pieces of 1,024), 32 greedy decode
   steps across the piece boundary at slot 1,024, against the same with
   no mesh (``CONTINUITY_TOL``; a stream parts only where not both top-2
   margins exceed ``DIVERGENCE_TIE``); bytes a position for weights and
   caches == the dry-run's under both rule sets; the prefill's and a
   decode step's walls, one traced decode step's busy share and top
   operations, the peak memory, the collective bytes a position a step
   by kind (== ``serve_mesh_decode_bytes`` from the shapes) and the
   roofline's terms. Stacked positions do the same work from one host
   thread: no wall here is a speed-up. (b) the reduced llama3-8b and
   gemma3-1b (6 layers, rings of 32) in fp32 on (2, 2), (1, 4) and (4, 1)
   stacked on the card against the CPU (logits within 1e-5 relative). (c)
   (a) over four cards, only where the machine has them
   (``scripts/mesh_cards.py --phase 17`` runs it there);
18. prefill and decode of the MoE, SSM and hybrid families on a mesh
   (cell S13), four positions stacked on the card, each as phase 17 (a)
   (prompts, capacity, greedy steps against no mesh, bytes == the
   dry-run's, a traced decode step, collective bytes ==
   ``serve_mesh_decode_bytes``): (a) mamba2-2.7b at full width, 16 of its
   64 layers (``SERVE_SSM_DEPTH``; its conv and state caches
   on their channels and heads), in fp32 for 8 steps (logits within
   ``SERVE_FP32_TOL`` of no mesh), then in bf16 for 32, held within twice
   bf16's own gap to fp32 with no mesh (``floor_hold``: at 64 random
   layers that gap was 0.13 of the largest logit, past
   ``CONTINUITY_TOL``); (b) qwen3-moe-30b-a3b at full width
   and 12 of its 48 layers (flash at each position's 16 q heads,
   counted; each side's dropped expert assignments printed), held alike
   at the capacity factor E / top_k where no expert drops a token, then
   at the config's capacity with its logits' gap reported beside the
   drops (capacity makes the MoE discontinuous); (c) the reduced
   qwen3-moe on (2, 2) and (1, 4), mamba2 on (2, 2) and on (1, 2) with 3
   heads of 64, jamba at one 8-layer period on (2, 2) at capacity 62, in
   fp32 on the card against the CPU (1e-5 relative);
19. prefill and decode of the frontend and encoder-decoder families on a
   mesh (cell S14), each as phase 17 (a) at full width and depth: (a)
   paligemma-3b (256 image embeddings, numpy seed 13, ahead of 760
   tokens: 1,016 positions; 4 q heads and the one kv head a position),
   (b) seamless-m4t-medium (1,016 tokens over 1,024 source frames; its
   cross caches over the frames, read by every decode step), each in fp32
   for 8 steps (within ``SERVE_FP32_TOL`` of no mesh), then in bf16 for
   32 (within ``CONTINUITY_TOL``), flash launched once a position in
   every self-, encoder and cross-attention layer of the prefill
   (counted); (c) the reduced paligemma and seamless (and seamless over 6
   frames, whose cross caches keep their frames whole in the decode) in
   fp32 on (2, 2), (1, 4) and (4, 1) on the card against the CPU (1e-5
   relative);
20. the multi-pod mesh ("pod", "data", "model") = (2, 2, 2) (cell S15;
   budget 60 s), its eight positions stacked on the card: (a) gemma3-1b
   at full width and depth trains 3 steps of phase 12's data (4 x 1,024
   in one microbatch: a row a (pod, data) position, int8 moments)
   against no mesh and (2, 2): losses within 1e-3, the state after 3
   steps within 0.1 a leaf (the drawn state must fail it), bytes a
   position == the dry-run's, each position's collective bytes == the
   dry-run's count of the same step over meta positions; (b) gemma3-1b's
   prefill of 4 x 1,016 tokens and greedy decode steps across the cache's
   piece boundary as phase 17 (a), 9 in fp32 then 16 in bf16, against no
   mesh (``SERVE_FP32_TOL``, then ``CONTINUITY_TOL``), the
   prefill's and a decode step's collective bytes == the meta count,
   every position's logits (both pods') equal bit for bit; (c), run
   first, ``examples/torch/serve_small_real.py`` on the card as a
   subprocess: exit 0, "lossless ✓", while the script makes the dry-run's
   meta counts that (a) and (b) are held to; (a) and (b) run with nothing
   beside them.

It prints a JSON line of kernel results (each with its launches per
main path), then the card's name and power limit, and last ``{"ok":
true, "device": {...}}``. It imports nothing of JAX and nothing of the
JAX package.

``python3 chip_smoke.py --timing`` runs phases 1, 2 and 4 only and prints
phase 4's times as one JSON line ``{"timing": {...}}``: the quick way to
compare two trees' kernels on one card (run each tree's copy of the
script in turn, within one machine). ``--phase N`` (N in 14, 16, 17,
18, 19, 20) runs phases 1, 2 and phase N alone; ``scripts/phase_budget.py``
times the phases whose depth was cut, before and after the cut, beside
the last phase added.
"""
from __future__ import annotations

import dataclasses
import contextlib
import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

TOL = {"bf16": 2e-2, "fp32": 1e-5}   # atol = rtol: bf16 output rounding
#                                      (the reference kernel tests' bf16
#                                      tolerance); fp32 summation order
ROW_MOVES = ("copy_launches", "d2d_rows", "d2h_rows", "h2d_rows")
CONTINUITY_TOL = 0.05     # bf16: max |dlogit| <= 0.05 * max |logit|
# phase 11's run (b): with 4 requests, HBM for the two largest (109 blocks)
# rotates at most once on the model's clock (gemma3's prompts never), 77
# rotates each family 32-38 times; at 69, mamba2's requests livelock the
# scheduler, in the reference's sim mode too (ROADMAP.md §3)
FAMILY_TIGHT_HBM = 77
# a bf16 divergence between two paths whose top-2 margins both exceed this
# is not a near-tie flip
DIVERGENCE_TIE = 0.05
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


def kernel_ms(torch, fn, family, calls=20):
    """Device milliseconds per call of ``fn``'s own kernels
    (``kernel_trace``)."""
    return kernel_trace(torch, fn, family, "a call", calls)[0]


# host seconds a device trace waits after it starts and before it stops
TRACE_PAD_S = 0.01


@contextlib.contextmanager
def device_profile(torch, host=False):
    """A torch.profiler trace of CUDA activity (and host operators where
    ``host``) whose body runs between two host sleeps of TRACE_PAD_S, the
    device synchronised before the second. A trace of a millisecond or
    less now and then holds no device event at all, not even a kernel
    launched after the timed ones; padded, none came back empty
    (``scripts/trace_window.py``)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        time.sleep(TRACE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)


def kernel_trace(torch, fn, family, what, calls=20):
    """(device milliseconds per call of ``fn``'s own kernels, traces
    taken): ``family`` in KERNEL_FAMILIES, summed from a ``device_profile``
    trace. Where a call's kernel is shorter than its host dispatch,
    ``time_ms``'s back-to-back events measure the host's launch rate
    instead of the kernel. A trace without the family's kernels is logged
    (on stderr too) with the device events it did hold, and the call
    traces again, three times at most; the kernels JSON reports the traces
    each row took (``trace_attempts``)."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with device_profile(torch) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_family = device_time_by_family(prof)
        ms = by_family.get(family, 0.0) / calls
        if ms > 0:
            return ms, attempt
        names = device_event_names(prof)
        msg = (f"kernel_ms: trace {attempt} of {what} ({calls} calls) holds "
               f"no {family} kernel: {len(names)} device events, by family "
               f"{by_family}, first names {names[:4]}")
        log(msg)
        print(msg, file=sys.stderr, flush=True)
    raise AssertionError(f"no {family} kernel in three traces of {what}")


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
        # the families' shapes (phase 11): head_dim 256 at gemma3-1b's heads
        # (GQA group 4) with q_offset, under its 512-token window, and at
        # paligemma-3b's (group 8) over its whole 320-position prompt and
        # non-causal with Sq != Skv; seamless-m4t's non-causal encoder and
        # its cross-attention (16/16/64)
        for T, Skv, off, win, causal, arch in (
                (512, 1024, 300, 0, True, "gemma3-1b"),
                (512, 1024, 512, 512, True, "gemma3-1b"),
                (320, 320, 0, 0, True, "paligemma-3b"),
                (64, 320, None, 0, False, "paligemma-3b"),
                (1024, 1024, None, 0, False, "seamless-m4t-medium"),
                (64, 1024, None, 0, False, "seamless-m4t-medium")):
            fc = get_config(arch)
            h, hkv, d = fc.num_heads, fc.num_kv_heads, fc.head_dim
            q = torch.randn((1, T, h, d), generator=g, device=dev).to(dt)
            k = torch.randn((1, Skv, hkv, d), generator=g, device=dev).to(dt)
            v = torch.randn((1, Skv, hkv, d), generator=g, device=dev).to(dt)
            got = ops.flash_attention(q, k, v, causal=causal, window=win,
                                      q_offset=off, force="kernel")
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=win, q_offset=off)
            torch.cuda.synchronize()
            check("flash_attention", dname,
                  f"{arch} heads: T={T} Skv={Skv} q_offset={off} window="
                  f"{win} causal={causal} H/Hkv/D={h}/{hkv}/{d}", got, want,
                  tol, errs)
        gc.collect()
        torch.cuda.empty_cache()


EMPTY_SPLIT_CTX = [1, 40, 128, 129, 300, 1024, 700, 5]


def tp_shard_checks(torch, ops, ref, cfg, errs, dev="cuda"):
    """The kernels at one tensor-parallel shard's heads (phase 14): paged
    attention in both modes and flash against their plain versions at
    llama3-8b's tp=2 shard (16/4/128) and tp=8 shard (4/1/128), over a
    full-depth pool of that shard's heads."""
    L, D, P, NB, staging = cfg.num_layers, cfg.head_dim, 16, 1024, 64
    rows = NB + staging + 1
    trash = rows - 1
    B, MB = 32, 64
    for tp in (2, 8):
        sc = dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                                 num_kv_heads=cfg.num_kv_heads // tp)
        H, Hkv = sc.num_heads, sc.num_kv_heads
        g = torch.Generator(device=dev).manual_seed(10 + tp)
        bt = torch.randint(0, NB, (B, MB), generator=g, device=dev,
                           dtype=torch.int32)
        cl = torch.randint(1, MB * P + 1, (B,), generator=g, device=dev,
                           dtype=torch.int32)
        bt[-4:] = trash
        cl[-4:] = 1
        qpool, scales = int8_pool(torch, g, (rows, L), sc, P, dev)
        for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            tol = TOL[dname]
            what = f"tp={tp} shard H/Hkv/D={H}/{Hkv}/{D}"
            pool = torch.randn((rows, L, 2, P, Hkv, D), generator=g,
                               device=dev).to(dt)
            q = torch.randn((B, H, D), generator=g, device=dev).to(dt)
            for name, kv, kvs in (("paged_attention", pool, None),
                                  ("paged_attention_int8", qpool, scales)):
                got = ops.paged_attention(q, kv, bt, cl, layer=L - 1,
                                          kv_scales=kvs, force="kernel")
                want = ref.paged_attention_ref(q, kv, bt, cl, layer=L - 1,
                                               kv_scales=kvs)
                torch.cuda.synchronize()
                check(name, dname, f"{what}, B={B} ragged ctx, 4 padded "
                      f"lanes, layer {L - 1}", got, want, tol, errs)
            del pool
            q = torch.randn((1, 512, H, D), generator=g, device=dev).to(dt)
            k = torch.randn((1, 1024, Hkv, D), generator=g, device=dev).to(dt)
            v = torch.randn((1, 1024, Hkv, D), generator=g, device=dev).to(dt)
            got = ops.flash_attention(q, k, v, causal=True, q_offset=512,
                                      force="kernel")
            want = ref.flash_attention_ref(q, k, v, causal=True,
                                           q_offset=512)
            torch.cuda.synchronize()
            check("flash_attention", dname, f"{what}, T=512 Skv=1024 "
                  f"q_offset=512", got, want, tol, errs)
        del qpool, scales
    gc.collect()
    torch.cuda.empty_cache()


def mesh_shard_checks(torch, ops, ref, errs, dev="cuda"):
    """Flash at the mesh phases' shard heads against its plain version:
    phase 15's (2, 2) shard of gemma3-1b (2/1/256, causal, window 512) and
    (1, 2) shard of qwen3-moe-30b-a3b (16/2/128, causal), 1024 tokens a
    row; phase 16's (2, 2) shards of paligemma-3b (4/1/256, causal over
    1024) and seamless-m4t-medium (8/8/64: the non-causal encoder over 1024
    frames, the cross-attention of 1024 tokens over 1024 frames), one row;
    in bf16 and fp32; phase 17's, 18's and 19's prefill shards (two rows
    a position) likewise. And ``FlashAttention``'s gradient (the kernel
    forward, the plain backward) at gemma3-1b's and seamless's encoder
    shard heads against autograd through the plain version in fp32 (on
    the same inputs, upcast)."""
    from repro_torch.models.attention import FlashAttention
    g = torch.Generator(device=dev).manual_seed(15)
    S = 1024
    for label, H, Hkv, D, win in (("gemma3-1b (2, 2) shard", 2, 1, 256,
                                   512),
                                  ("qwen3-moe (1, 2) shard", 16, 2, 128, 0)):
        for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            q = torch.randn((2, S, H, D), generator=g, device=dev).to(dt)
            k = torch.randn((2, S, Hkv, D), generator=g, device=dev).to(dt)
            v = torch.randn((2, S, Hkv, D), generator=g, device=dev).to(dt)
            got = ops.flash_attention(q, k, v, causal=True, window=win,
                                      force="kernel")
            want = ref.flash_attention_ref(q, k, v, causal=True, window=win)
            torch.cuda.synchronize()
            check("flash_attention", dname, f"{label} H/Hkv/D={H}/{Hkv}/{D},"
                  f" B=2 T={S} causal window {win}", got, want, TOL[dname],
                  errs)
    # phase 16's shards, one row a position (2 x 1024 over (2, 2))
    for label, H, Hkv, D, Sq, causal in (
            ("paligemma-3b (2, 2) shard", 4, 1, 256, S, True),
            ("seamless-m4t-medium (2, 2) encoder shard", 8, 8, 64, S, False),
            ("seamless-m4t-medium (2, 2) cross-attention shard, Sq 1024 "
             "over 1024 frames", 8, 8, 64, S, False)):
        for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            q = torch.randn((1, Sq, H, D), generator=g, device=dev).to(dt)
            k = torch.randn((1, S, Hkv, D), generator=g, device=dev).to(dt)
            v = torch.randn((1, S, Hkv, D), generator=g, device=dev).to(dt)
            got = ops.flash_attention(q, k, v, causal=causal, force="kernel")
            want = ref.flash_attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            check("flash_attention", dname, f"{label} H/Hkv/D={H}/{Hkv}/{D},"
                  f" B=1 Sq={Sq} Skv={S} "
                  f"{'causal' if causal else 'non-causal'}",
                  got, want, TOL[dname], errs)
    # phase 19's prefill shards on (2, 2), one data row's 2 rows:
    # paligemma-3b over its 256 embeddings and 760 tokens, seamless's
    # encoder over 1024 frames and its cross-attention of 1016 tokens
    for label, H, Hkv, D, Sq, Skv, causal in (
            ("paligemma-3b (2, 2) prefill shard", 4, 1, 256, 1016, 1016,
             True),
            ("seamless-m4t-medium (2, 2) prefill encoder shard", 8, 8, 64,
             1024, 1024, False),
            ("seamless-m4t-medium (2, 2) prefill cross-attention shard", 8,
             8, 64, 1016, 1024, False)):
        for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            q = torch.randn((2, Sq, H, D), generator=g, device=dev).to(dt)
            k, v = (torch.randn((2, Skv, Hkv, D), generator=g,
                                device=dev).to(dt) for _ in range(2))
            got = ops.flash_attention(q, k, v, causal=causal, force="kernel")
            want = ref.flash_attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            check("flash_attention", dname, f"{label} H/Hkv/D={H}/{Hkv}/{D},"
                  f" B=2 Sq={Sq} Skv={Skv} "
                  f"{'causal' if causal else 'non-causal'}",
                  got, want, TOL[dname], errs)
    # phase 17's prefill shards on (2, 2), one data row's 2 prompts: the
    # full llama3-8b's 1016 tokens, the reduced gemma3-1b's 28 (window 32)
    # and phase 18's: qwen3-moe-30b-a3b's 1016 tokens at 16/2/128
    for label, H, Hkv, D, Sp, win in (
            ("llama3-8b (2, 2) prefill shard", 16, 4, 128, 1016, 0),
            ("reduced gemma3-1b (2, 2) prefill shard", 2, 1, 16, 28, 32),
            ("qwen3-moe-30b-a3b (2, 2) prefill shard", 16, 2, 128, 1016,
             0)):
        for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            q, k, v = (torch.randn((2, Sp, h, D), generator=g,
                                   device=dev).to(dt) for h in (H, Hkv, Hkv))
            got = ops.flash_attention(q, k, v, causal=True, window=win,
                                      force="kernel")
            want = ref.flash_attention_ref(q, k, v, causal=True, window=win)
            torch.cuda.synchronize()
            check("flash_attention", dname, f"{label} H/Hkv/D={H}/{Hkv}/{D},"
                  f" B=2 T={Sp} causal window {win}", got, want, TOL[dname],
                  errs)
    for label, H, Hkv, D, causal, win in (
            ("gemma3-1b's (2, 2) shard heads 2/1/256, window 512", 2, 1, 256,
             True, 512),
            ("seamless-m4t-medium's (2, 2) encoder shard heads 8/8/64, "
             "non-causal", 8, 8, 64, False, 0)):
        for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            q, k, v = (torch.randn((1, S, h, D), generator=g, device=dev).to(
                dt) for h in (H, Hkv, Hkv))
            dout = torch.randn((1, S, H, D), generator=g, device=dev).to(dt)
            grads = []
            for fn, up in ((lambda a, b, c: FlashAttention.apply(
                    a, b, c, causal, win, 0, None), dt),
                    (lambda a, b, c: ref.flash_attention_ref(
                        a, b, c, causal=causal, window=win), torch.float32)):
                live = [x.detach().to(up).requires_grad_() for x in (q, k, v)]
                grads.append(torch.autograd.grad(fn(*live), live,
                                                 dout.to(up)))
            torch.cuda.synchronize()
            for name, a, b in zip(("dq", "dk", "dv"), *grads):
                check("flash_attention", dname, f"FlashAttention gradient "
                      f"{name} at {label}, T={S}, against autograd through "
                      f"the plain version", a, b, TOL[dname], errs)
    gc.collect()
    torch.cuda.empty_cache()


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
    """Each kernel at main-path shapes in bf16: a dict of ms (CUDA events),
    kernel_ms (the kernel alone, from a trace) with its trace_attempts,
    plain_ms, bound_ms, bound_by and library_ms. The bound is each kernel's
    ``flops_and_bytes`` at these inputs over the H100's peaks."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash_k
    from repro_torch.kernels import kv_copy as kv_copy_k
    from repro_torch.kernels import paged_attention as paged_k
    from repro_torch.launch.roofline import HBM_BYTES_S, PEAK_BF16_FLOPS
    dt, e = torch.bfloat16, 2
    L, Hkv, D, H = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    P, NB, staging = 16, 1024, 64
    rows = NB + staging + 1
    g = torch.Generator(device=dev).manual_seed(2)
    pool = torch.randn((rows, L, 2, P, Hkv, D), generator=g, device=dev,
                       dtype=torch.float32).to(dt)
    out = {}

    def timed(name, family, kernel, plain, cost, library=None):
        """``cost``: the kernel's (FLOPs, bytes) at these inputs."""
        tb, tf = cost[1] / HBM_BYTES_S * 1e3, cost[0] / PEAK_BF16_FLOPS * 1e3
        ms = time_ms(torch, kernel)
        alone, attempts = kernel_trace(torch, kernel, family, name)
        out[name] = dict(ms=ms, kernel_ms=alone, trace_attempts=attempts,
                         plain_ms=time_ms(torch, plain), bound_ms=max(tb, tf),
                         bound_by="bytes" if tb >= tf else "operations",
                         library_ms=None if library is None
                         else time_ms(torch, library))

    # kv_copy: one staging batch of 64 whole rows (2 MiB each)
    flat = pool.view(rows, -1)
    src = np.arange(64, dtype=np.int32)
    dst = np.arange(NB - 64, NB, dtype=np.int32)
    s_t = torch.from_numpy(src.astype(np.int64)).to(dev)
    d_t = torch.from_numpy(dst.astype(np.int64)).to(dev)
    timed(
        "kv_copy", "kv_copy", lambda: ops.kv_copy(flat, src, dst, force="kernel"),
        lambda: ref.kv_copy_ref(flat, src, dst),
        kv_copy_k.flops_and_bytes(64, flat[0].numel() * e),
        lambda: flat.index_copy_(0, d_t, flat.index_select(0, s_t)))
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
        for name, kv, sc, kv_bytes in (
                ("paged_attention", pool, None, e),
                ("paged_attention_int8", qpool, qscales, 1)):
            cost = paged_k.flops_and_bytes(
                B, H, Hkv, D, MB, B * ctx, itemsize=e, kv_itemsize=kv_bytes,
                quant=sc is not None)
            layers = itertools.count()

            def layer():
                return 0 if B == 32 else next(layers) % L
            timed(
                name + tag, "paged_attention", lambda: ops.paged_attention(
                    q, kv, bt, cl, layer=layer(), kv_scales=sc,
                    force="kernel"),
                lambda: ref.paged_attention_ref(
                    q, kv, bt, cl, layer=layer(), kv_scales=sc),
                cost)
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
    cost = flash_k.flops_and_bytes(1, T, Skv, H, Hkv, D, causal=True,
                                   window=0, q_offset=off, itemsize=e)
    mask = (torch.arange(Skv, device=dev)[None, :]
            <= off + torch.arange(T, device=dev)[:, None])
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    timed(
        "flash_attention", "flash_attention", lambda: ops.flash_attention(
            q, k, v, causal=True, q_offset=off, force="kernel"),
        lambda: ref.flash_attention_ref(q, k, v, causal=True, q_offset=off),
        cost,
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               enable_gqa=True))
    # flash at head_dim 256: gemma3-1b's heads (4/1), a 512-token chunk at
    # q_offset 512 over 1024 keys under its 512-token window, and
    # paligemma-3b's (8/1) over its whole 320-position prompt
    for tag, arch, T, Skv, off, win in (
            ("@D=256", "gemma3-1b", 512, 1024, 512, 512),
            ("@D=256,paligemma", "paligemma-3b", 320, 320, 0, 0)):
        fc = get_config(arch)
        h, hkv, d = fc.num_heads, fc.num_kv_heads, fc.head_dim
        q = torch.randn((1, T, h, d), generator=g, device=dev).to(dt)
        k = torch.randn((1, Skv, hkv, d), generator=g, device=dev).to(dt)
        v = torch.randn((1, Skv, hkv, d), generator=g, device=dev).to(dt)
        pos = off + torch.arange(T, device=dev)[:, None]
        kpos = torch.arange(Skv, device=dev)[None, :]
        mask = (kpos <= pos) & ((kpos > pos - win) if win else True)
        cost = flash_k.flops_and_bytes(
            1, T, Skv, h, hkv, d, causal=True, window=win, q_offset=off,
            itemsize=e)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        timed(
            "flash_attention" + tag, "flash_attention", lambda: ops.flash_attention(
                q, k, v, causal=True, window=win, q_offset=off,
                force="kernel"),
            lambda: ref.flash_attention_ref(q, k, v, causal=True, window=win,
                                            q_offset=off),
            cost,
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   enable_gqa=True))
    # flash at the training shape (phase 12): gemma3-1b's heads, a
    # microbatch of 2 x 1024 tokens, causal under its 512-token window; and
    # the plain PyTorch backward of that layer (not a kernel)
    from repro_torch.models.attention import flash_attention_backward
    fc = get_config("gemma3-1b")
    h, hkv, d, win = (fc.num_heads, fc.num_kv_heads, fc.head_dim,
                      fc.attn.sliding_window)
    Bt, St = 2, 1024
    q = torch.randn((Bt, St, h, d), generator=g, device=dev).to(dt)
    k = torch.randn((Bt, St, hkv, d), generator=g, device=dev).to(dt)
    v = torch.randn((Bt, St, hkv, d), generator=g, device=dev).to(dt)
    dout = torch.randn((Bt, St, h, d), generator=g, device=dev).to(dt)
    pos = torch.arange(St, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - win)
    pairs = Bt * int(mask.sum())
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    timed(
        "flash_attention@train", "flash_attention", lambda: ops.flash_attention(
            q, k, v, causal=True, window=win, q_offset=0, force="kernel"),
        lambda: ref.flash_attention_ref(q, k, v, causal=True, window=win,
                                        q_offset=0),
        flash_k.flops_and_bytes(Bt, St, St, h, hkv, d, causal=True,
                                window=win, q_offset=0, itemsize=e),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               enable_gqa=True))
    # dq, dk, dv from q, k, v, dout: 10 operations a visible (query, key)
    # pair, head and head dim (the scores again, dP, dV, dQ and dK)
    out["flash_attention@train"]["backward_plain_ms"] = time_ms(
        torch, lambda: flash_attention_backward(
            q, k, v, dout, causal=True, window=win, q_offset=0),
        reps=5, per=2)
    out["flash_attention@train"]["backward_bound_ms"] = max(
        (3 * h + 4 * hkv) * Bt * St * d * e / HBM_BYTES_S,
        10 * pairs * h * d / PEAK_BF16_FLOPS) * 1e3
    with device_profile(torch) as prof:
        for _ in range(5):
            flash_attention_backward(q, k, v, dout, causal=True, window=win,
                                     q_offset=0)
        torch.cuda.synchronize()
    out["flash_attention@train"]["backward_plain_device_ms"] = sum(
        device_time_by_family(prof).values()) / 5
    t = out["flash_attention@train"]
    log(f"time flash backward at the training shape (plain PyTorch, not a "
        f"kernel): {t['backward_plain_ms']:.4f} ms (CUDA events), "
        f"{t['backward_plain_device_ms']:.4f} ms of device time (trace), "
        f"bound {t['backward_bound_ms']:.4f} ms")
    del q, k, v, dout, qt, kt, vt, mask
    for name, t in out.items():
        log(f"time {name}: {t['ms']:.4f} ms (kernel alone {t['kernel_ms']:.4f}"
            f" ms), plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} "
            f"ms ({t['bound_by']}), library "
            + ("n/a" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms"))
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


def device_event_names(prof):
    """The names of a torch.profiler trace's device events, in order."""
    from torch.autograd import DeviceType
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


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


def serve(torch, cfg, sv, prompts, device, seed=0, trace=False,
          params=None, keep_store=False):
    """Serve ``prompts`` [(ids, max_tokens)] to completion through the
    port's ServingEngine with the paged runner; return streams, margins,
    wall seconds, counters, bytes moved each way (and per kv shard), the
    pool's bytes, the peak device memory from before the engine is built
    (weights the caller holds included) and the kernel launches of this
    run. ``trace`` records the drain with torch.profiler and adds device
    milliseconds by kernel family. ``params`` are the runner's weights
    (else drawn from ``seed``); ``device`` may be a list, one a TP
    shard; ``keep_store`` returns the store too."""
    from repro_torch.configs import GH200
    from repro_torch.core.types import RequestState, SamplingParams
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paged_runner import PagedModelRunner
    before = ops.launch_counts()
    on_card = any(str(d).startswith("cuda") for d in (
        device if isinstance(device, list) else [device]))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if params is None:
        eng = ServingEngine(cfg, sv, GH200, runner_seed=seed, device=device)
    else:
        eng = ServingEngine(cfg, sv, GH200, executor=PagedModelRunner(
            cfg, sv, GH200, timing_cfg=cfg, params=params, device=device))
    ex = eng.executor
    ex.record_margins = True
    handles = [eng.add_request(prompt_ids=ids,
                               sampling_params=SamplingParams(max_tokens=n))
               for ids, n in prompts]
    if on_card:
        torch.cuda.synchronize()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        # device activity only: host events would multiply the trace
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    t0 = time.perf_counter()
    eng.drain()
    if on_card:
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
    row_bytes = (int(np.prod(st.row_shape)) * st.pool.element_size()
                 + (int(np.prod(st.scale_row_shape))
                    * st.scales.element_size() if st.quantized else 0))
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
        transfer=eng.kv.transfer_counters(),
        pool_shard_bytes=st.pool_shard_bytes,
        pool_global_bytes=st.pool_global_bytes,
        peak_bytes=torch.cuda.max_memory_allocated() if on_card else None,
        **{c: getattr(st, c) for c in ROW_MOVES})
    if prof is not None:
        res["device_ms"] = device_time_by_family(prof)
    if keep_store:
        res["store"] = st
    if res["attn_launches"] != res["decode_batches"] * cfg.num_layers:
        raise AssertionError("attn_launches != decode_batches x layers")
    del eng, ex, st, handles
    gc.collect()
    if on_card:
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


def serving_runs(torch, cfg, prompts, sv_kw, hbm_ample, device, label,
                 params=None, trace=()):
    """Runs (a) ample and (b) tight HBM; (b) holds the two largest
    requests. ``params`` are the weights (else drawn from seed 0); the
    runs named in ``trace`` are traced."""
    from repro_torch.configs import ServingConfig
    P = sv_kw["block_size"]
    need = sorted((-(-(len(ids) + n) // P) for ids, n in prompts),
                  reverse=True)
    hbm_tight = need[0] + need[1]
    out = {}
    for run, hbm in (("a", hbm_ample), ("b", hbm_tight)):
        sv = ServingConfig(num_hbm_blocks=hbm, paged_runner=True, **sv_kw)
        res = serve(torch, cfg, sv, prompts, device, params=params,
                    trace=run in trace)
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
            f"{res['prefill_chunks']}, kernel launches {res['launches']}, "
            f"peak memory {res['peak_bytes']} B")
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

def dense_run(torch, cfg, prompts, params, sv_kw, hbm, device, label,
              trace=False):
    """The dense per-request executor behind ServingEngine on ``device``
    with ``hbm`` blocks: its streams, rotations, wall and peak device
    memory; ``trace`` adds the device's busy milliseconds (torch.profiler
    over the drain)."""
    from repro_torch.configs import GH200, ServingConfig
    from repro_torch.core.types import SamplingParams
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.executor import RealExecutor
    ex = RealExecutor(cfg, device=device, params=params)
    ex.record_margins = True
    eng = ServingEngine(cfg, ServingConfig(num_hbm_blocks=hbm, **sv_kw),
                        GH200, real_executor=ex)
    handles = [eng.add_request(
        prompt_ids=ids, sampling_params=SamplingParams(max_tokens=n))
        for ids, n in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    t0 = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = None
    if prof is not None:
        prof.stop()
        fams = device_time_by_family(prof)
        busy = sum(fams.values())
    streams = {h.req_id: list(h.request.generated_ids) for h in handles}
    for (_, n), s in zip(prompts, streams.values()):
        if len(s) != n or not all(0 <= t < cfg.vocab_size for t in s):
            raise AssertionError(f"{label}: a stream of {len(s)} tokens, {n} "
                                 f"asked")
    rot = eng.stats.active_rotations + eng.stats.passive_preemptions
    ntok = sum(len(s) for s in streams.values())
    peak = torch.cuda.max_memory_allocated()
    log(f"{label} hbm={hbm} blocks on {device}: wall {wall:.3f} s, {ntok} "
        f"tokens, {ntok / wall:.2f} tok/s, rotations {rot}"
        + ("" if device == "cpu" else f", peak device memory {peak} B")
        + ("" if busy is None else f", device busy {busy:.1f} ms "
           f"({busy / (wall * 1e3):.3f} of wall), by family " + ", ".join(
               f"{k} {v:.1f} ms" for k, v in
               sorted(fams.items(), key=lambda kv: -kv[1]))))
    margins = {h.req_id: ex.margins[h.req_id] for h in handles}
    del eng, ex, handles
    gc.collect()
    torch.cuda.empty_cache()
    return dict(streams=streams, margins=margins, rotations=rot, wall_s=wall)


def dense_runs(torch, cfg, prompts, params, sv_kw, hbm_ample, hbm_tight,
               label, trace=False):
    """The dense executor on the card: (a) ample HBM (traced if ``trace``),
    (b) tight HBM, which forces rotation through swap_out/swap_in; equal
    streams asserted."""
    out = {run: dense_run(torch, cfg, prompts, params, sv_kw, hbm, "cuda",
                          f"{label} run ({run})", trace=trace and run == "a")
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
    share, first = agreement(full["a"], paged_a)
    log(f"llama3-8b bf16 dense run (a) vs paged run (a) of phase 5, same "
        f"weights (reported, not asserted): {share:.4f} of tokens agree; "
        f"first divergence (req, step, margin dense, margin paged): {first}")
    if first is not None and min(first[2:]) > DIVERGENCE_TIE:
        log(f"dense vs paged: the first divergence has both top-2 margins "
            f"above {DIVERGENCE_TIE}: not a near tie")
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
    card_vs_cpu(torch, gcfg, gprompts, gparams, gsv, 4096, 25, glabel)
    log(f"phase 10 wall: {time.perf_counter() - t0:.2f} s")
    return launches


def card_vs_cpu(torch, cfg, prompts, params, sv_kw, hbm_ample, hbm_tight,
                label):
    """A reduced model on the card, lossless under rotation, then its run
    (b) on the CPU from the same weights (the plain versions): the card's
    kernels and operations must give the CPU's streams."""
    from repro_torch.models.params import params_to
    runs = dense_runs(torch, cfg, prompts, params, sv_kw, hbm_ample,
                      hbm_tight, label)
    cpu = dense_run(torch, cfg, prompts, params_to(params, "cpu"), sv_kw,
                    hbm_tight, "cpu", f"{label} run (b)")
    if cpu["streams"] != runs["b"]["streams"]:
        raise AssertionError(f"{label}: the card's streams differ from the "
                             f"CPU's")
    log(f"{label}: the card's streams equal the CPU's from the same "
        f"weights")


# --------------------------------------------------------------- phase 11

def mib(n):
    return f"{n / 2**20:.1f} MiB"


def continuity(torch, lm, params, batch, steps, label):
    """Prefill, then ``steps`` greedy decode steps on the card; the first
    step's logits against the prefill of the prompt plus that token (the
    decode-continuity check of ``tests/test_models.py``), within
    CONTINUITY_TOL · max |logit|, top-1 equal in every row whose top-2
    margin is above the error."""
    F = lm.cfg.frontend.num_embeds if (lm.cfg.frontend.kind != "none" and
                                       not lm.cfg.num_encoder_layers) else 0
    n = batch["tokens"].shape[1]
    cap = n + F + steps + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = lm.prefill(params, batch, cap)
    tok = logits.float().argmax(-1)
    first = None
    for i in range(steps):
        logits, caches = lm.decode_step(params, caches, {
            "token": tok, "cache_len": n + F + i})
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{label}: non-finite logits at step {i}")
        if first is None:
            first = (tok, logits.float())
        tok = logits.float().argmax(-1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del caches
    want, _ = lm.prefill(params, dict(batch, tokens=torch.cat(
        [batch["tokens"], first[0][:, None]], 1)), cap)
    want = want.float()
    err = (first[1] - want).abs().max().item()
    scale = want.abs().max().item()
    top2 = want.topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    same = (first[1].argmax(-1) == want.argmax(-1)).tolist()
    log(f"{label}: prefill + {steps} decode steps {wall:.3f} s; continuity "
        f"max |dlogit| {err:.4e} of max |logit| {scale:.4e} ({err / scale:.4f}"
        f", tolerance {CONTINUITY_TOL}); top-1 equal {same}, top-2 margins "
        f"{[round(m, 5) for m in margins]}")
    if not np.isfinite(err) or err > CONTINUITY_TOL * scale:
        raise AssertionError(f"{label}: continuity error {err:.4e} over "
                             f"{CONTINUITY_TOL} x {scale:.4e}")
    for ok, m in zip(same, margins):
        if not ok and m > err:
            raise AssertionError(f"{label}: top-1 differs at a margin {m} "
                                 f"above the error {err}")



# phase 11's depth cuts, so the script stays within its time (widths are
# never cut; phase 16 trains mamba2-2.7b at its full depth)
FAMILY_DEPTH = {"qwen3-moe-30b-a3b": 24, "mamba2-2.7b": 16}


def families_phase(torch):
    """Every model family of the repo on the card at full width through
    the port's LM: qwen3-moe-30b-a3b (MoE, 24 of its 48 layers) and
    mamba2-2.7b (SSM, 16 of 64: ``FAMILY_DEPTH``)
    and gemma3-1b (head_dim 256, window 512) served by RealExecutor behind
    ServingEngine, with ample and tight HBM; paligemma-3b (256 image
    embeddings) and seamless-m4t-medium (an encoder over 1024 frames)
    through LM.prefill/decode_step; then the reduced qwen3-moe, mamba2 and
    jamba (8 layers) in fp32 on the card against the CPU."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import make_demo_inputs
    from repro_torch.models.lm import LM
    from repro_torch.models.params import init_lm_params
    t_phase = time.perf_counter()
    sv_kw = dict(block_size=16, prefill_chunk=512)
    for arch, plen in (("qwen3-moe-30b-a3b", (200, 1001)),
                       ("mamba2-2.7b", (200, 1001)),
                       ("gemma3-1b", (600, 1001))):
        cfg = get_config(arch)
        if arch in FAMILY_DEPTH:
            cfg = dataclasses.replace(cfg, num_layers=FAMILY_DEPTH[arch])
            log(f"{arch}: {FAMILY_DEPTH[arch]} of its "
                f"{get_config(arch).num_layers} layers (FAMILY_DEPTH)")
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{arch}: device memory allocated before its weights "
            f"{mib(torch.cuda.memory_allocated())}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = init_lm_params(cfg, torch.Generator(device="cuda")
                                .manual_seed(0), "cuda")
        torch.cuda.synchronize()
        log(f"{arch}: {cfg.param_count() / 1e9:.3f} B parameters drawn in "
            f"bf16 in {time.perf_counter() - t0:.2f} s, "
            f"{mib(torch.cuda.memory_allocated())} allocated")
        prompts = make_prompts(cfg, 4, plen, (16, 33), seed=0)
        before = ops.launch_counts()["flash_attention"]
        dense_runs(torch, cfg, prompts, params, sv_kw, 1024,
                   FAMILY_TIGHT_HBM, f"{arch} full width bf16", trace=True)
        flash = ops.launch_counts()["flash_attention"] - before
        log(f"{arch}: flash launches {flash} (head_dim {cfg.head_dim})")
        if (flash > 0) != (cfg.num_attn_layers > 0):
            raise AssertionError(f"{arch}: flash launched {flash} times")
        del params
    for arch, seq in (("paligemma-3b", 320), ("seamless-m4t-medium", 64)):
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        params = init_lm_params(cfg, torch.Generator(device="cuda")
                                .manual_seed(0), "cuda")
        batch = make_demo_inputs(cfg, ShapeConfig("p", seq, 2, "prefill"),
                                 device="cuda")
        shapes = {k: tuple(v.shape) for k, v in batch.items()}
        before = ops.launch_counts()["flash_attention"]
        torch.cuda.reset_peak_memory_stats()
        continuity(torch, LM(cfg), params, batch, 16,
                   f"{arch} full width bf16 {shapes}")
        flash = ops.launch_counts()["flash_attention"] - before
        log(f"{arch}: flash launches {flash} (head_dim {cfg.head_dim}), "
            f"peak device memory {torch.cuda.max_memory_allocated()} B")
        if not flash:
            raise AssertionError(f"{arch}: flash never launched")
        del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    for arch, layers in (("qwen3-moe-30b-a3b", 4), ("mamba2-2.7b", 4),
                         ("jamba-1.5-large-398b", 8)):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32", num_layers=layers)
        prompts = make_prompts(cfg, 5, (40, 61), (10, 17), seed=3)
        params = init_lm_params(cfg, torch.Generator(device="cuda")
                                .manual_seed(0), "cuda")
        card_vs_cpu(torch, cfg, prompts, params,
                    dict(block_size=4, prefill_chunk=8, max_model_len=128,
                         num_dram_blocks=512), 4096, 25,
                    f"{arch}-reduced {layers} layers fp32 dense")
    log(f"phase 11 wall: {time.perf_counter() - t_phase:.2f} s")


# --------------------------------------------------------------- phase 12

RESUME_TOL = 2e-2     # resumed bf16 losses: the embedding's backward sums
#                       with atomics on the card, so not bit for bit


def train_phase(torch):
    """Training: (a) gemma3-1b at full width and depth through the port's
    launcher, six steps with int8 moments and a checkpoint at step 3, then
    a resume from it; wall per step, peak memory and one traced step; (b)
    the reference example's geometry (``examples/torch/train_100m.py``),
    whose loss must fall; (c) the reduced gemma3-1b in fp32: loss and every
    gradient on the card (the flash kernel forward) against the CPU's.
    Returns the kernel launches of (a) and its resume, and (a)'s losses
    and ``checkpoint_measures`` of its state at step 3."""
    import importlib.util
    import shutil
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.api import make_demo_inputs
    from repro_torch.models.lm import LM
    from repro_torch.models.params import init_lm_params, params_to
    from repro_torch.optimizer.adamw import AdamWConfig, apply_update
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.training import step as steplib
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("gemma3-1b")
    B, S, MB, steps = 4, 1024, 2, 6
    # (a) through the launcher, as a user runs it
    with tempfile.TemporaryDirectory() as ck:
        args = ["--arch", "gemma3-1b", "--steps", str(steps), "--batch",
                str(B), "--seq", str(S), "--microbatches", str(MB),
                "--moments-dtype", "int8", "--ckpt-dir", ck, "--ckpt-every",
                "3", "--log-every", "1"]
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        losses = train_main(args)
        wall = time.perf_counter() - t0
        flash = ops.launch_counts()["flash_attention"]
        peak = torch.cuda.max_memory_allocated()
        sums3 = checkpoint_measures(torch, Path(ck) / "step_00000003",
                                    "cuda")
        shutil.rmtree(Path(ck) / f"step_{steps:08d}")
        t0 = time.perf_counter()
        resumed = train_main(args + ["--resume"])
        wall_resume = time.perf_counter() - t0
        launches = ops.launch_counts()
    if not all(np.isfinite(x) for x in losses + resumed):
        raise AssertionError(f"train: non-finite losses {losses} {resumed}")
    fwd = steps * MB * cfg.num_attn_layers
    log(f"train gemma3-1b full width ({cfg.num_layers} layers, d "
        f"{cfg.d_model}, head_dim {cfg.head_dim}, window "
        f"{cfg.attn.sliding_window}, vocab {cfg.vocab_size}, bf16), batch "
        f"{B} x {S}, {MB} microbatches, int8 moments: losses {losses}; "
        f"{wall:.2f} s for {steps} steps with two checkpoints (weights drawn "
        f"at start); peak device memory {peak} B; flash launches {flash}: "
        f"forward {fwd} (steps x microbatches x {cfg.num_attn_layers} "
        f"attention layers) + remat recompute {flash - fwd}")
    if flash != 2 * fwd:
        raise AssertionError(f"train: flash launched {flash} times, expected "
                             f"{fwd} forward + {fwd} recompute")
    gap = max(abs(a - b) for a, b in zip(resumed, losses[3:]))
    log(f"train resume from step 3: losses {resumed} ({wall_resume:.2f} s), "
        f"max |gap| to the uninterrupted run {gap:.3e} (tolerance "
        f"{RESUME_TOL})")
    if len(resumed) != steps - 3 or gap > RESUME_TOL:
        raise AssertionError(f"train: resume gap {gap} over {RESUME_TOL}")
    gc.collect()
    torch.cuda.empty_cache()

    # where the time goes: the same step through make_train_step, timed
    # after a warm-up step, then one step traced
    from repro_torch.data.pipeline import SyntheticPacked
    lm = LM(cfg)
    opt = AdamWConfig(moments_dtype="int8")
    step_fn = steplib.make_train_step(lm, opt, microbatches=MB)
    state = steplib.init_train_state(
        lm, torch.Generator(device="cuda").manual_seed(0), opt, "cuda")
    data = SyntheticPacked(cfg.vocab_size, S, B)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in
                next(data).items()} for _ in range(5)]
    state, _ = step_fn(state, batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[1:4]:
        state, m = step_fn(state, b)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 3
    with device_profile(torch) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[4])
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    fams = device_time_by_family(prof)
    busy = sum(fams.values())
    from torch.autograd import DeviceType
    n_dev = sum(e.device_type() == DeviceType.CUDA
                for e in prof.profiler.kineto_results.events())
    # the same step again with host events, for device time by operator
    with device_profile(torch, host=True) as prof_ops:
        state, m = step_fn(state, batches[4])
        torch.cuda.synchronize()
    by_op = {e.key: (e.self_device_time_total / 1e3,
                     e.device_time_total / 1e3, e.count)
             for e in prof_ops.key_averages()}
    top = sorted(((k, v) for k, v in by_op.items()
                  if k.startswith("aten::")), key=lambda kv: -kv[1][0])[:8]
    bwd = by_op.get("FlashAttentionBackward", (0.0, 0.0, 0))
    log("train step, device ms by aten operator (self, top 8): " + ", ".join(
        f"{k} {v[0]:.1f} in {v[2]} calls" for k, v in top)
        + f"; the flash backward {bwd[1]:.1f} ms in {bwd[2]} calls")
    grads = tree_map(torch.zeros_like, state.params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    apply_update(state.params, grads, state.opt, opt)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    log(f"train step (gemma3-1b full width, {B} x {S} tokens): wall "
        f"{step_s * 1e3:.1f} ms a step (mean of 3 after a warm-up), "
        f"{B * S / step_s:.1f} tokens/s; traced step wall "
        f"{traced_s * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({busy / (traced_s * 1e3):.3f} of wall) in {n_dev} device "
        f"operations, by family " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in
            sorted(fams.items(), key=lambda kv: -kv[1]))
        + f"; the int8 AdamW update alone {opt_s * 1e3:.1f} ms of wall")
    del state, batches, m, prof, prof_ops, grads
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the reference example's geometry, through the port's example
    spec = importlib.util.spec_from_file_location(
        "train_100m", Path(__file__).resolve().parent / "examples" / "torch"
        / "train_100m.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        ex_losses = example.main(["--steps", "30", "--ckpt-dir", ck])
    tail = statistics.mean(ex_losses[-5:])
    log(f"train example geometry (gemma3-1b at width 512, 12 layers, batch "
        f"4 x 256, 2 microbatches, int8 moments, 30 steps): first loss "
        f"{ex_losses[0]:.4f}, mean of the last 5 {tail:.4f}, "
        f"{time.perf_counter() - t0:.2f} s")
    if not tail < ex_losses[0]:
        raise AssertionError("train example: the loss did not fall")
    gc.collect()
    torch.cuda.empty_cache()

    # (c) fp32 on the card against the CPU (TF32 is off since phase 1)
    rcfg = dataclasses.replace(cfg.reduced(), dtype="float32", num_layers=6)
    cpu_params = init_lm_params(rcfg, torch.Generator().manual_seed(0),
                                "cpu")
    batch = make_demo_inputs(rcfg, ShapeConfig("t", 64, 2, "train"))
    grads = {}
    flash0 = ops.launch_counts()["flash_attention"]
    for dev in ("cuda", "cpu"):
        params = params_to(cpu_params, dev)
        live = [p.requires_grad_() for p in tree_leaves(params)]
        loss = LM(rcfg).train_loss(params, {k: v.to(dev) for k, v in
                                            batch.items()})
        grads[dev] = (loss.item(), [g.cpu() for g in
                                    torch.autograd.grad(loss, live)])
    flash_c = ops.launch_counts()["flash_attention"] - flash0
    (lc, gcuda), (lp, gcpu) = grads["cuda"], grads["cpu"]
    rel = abs(lc - lp) / abs(lp)
    worst = max(((a - b).abs() - 1e-4 * b.abs()).max().item()
                for a, b in zip(gcuda, gcpu))
    log(f"train fp32 gemma3-1b-reduced 6 layers, card vs CPU: loss {lc:.7f} "
        f"vs {lp:.7f} (relative {rel:.2e}, tolerance 1e-5); gradients: "
        f"max of |card - cpu| - 1e-4 |cpu| over {len(gcpu)} leaves "
        f"{worst:.2e} (tolerance 1e-5); flash launches {flash_c}")
    if rel > 1e-5 or worst > 1e-5 or not flash_c:
        raise AssertionError("train fp32: the card's loss or gradients "
                             "differ from the CPU's")
    log(f"phase 12 wall: {time.perf_counter() - t_phase:.2f} s")
    return launches, (losses, sums3)


# --------------------------------------------------------------- phase 13

def roofline_decode(torch, cfg, steps=3, device="cuda"):
    """The roofline of one S1 decode iteration on ``device``: ``cfg``
    (llama3-8b at full width in bf16 on the card) through
    ``ServingEngine`` with the paged runner, 8 requests of
    1,016 prompt tokens (context about 1,024); once every request decodes,
    ``steps`` iterations are traced (device ms) and timed (wall ms, ending
    in a synchronize), then one more runs under ``FlopCounterMode``.
    FLOPs: the aten matmuls counted plus the paged kernel's own
    (``flops_and_bytes`` over this iteration's contexts, a launch a
    layer); bytes: the weights once, the K/V the kernel reads, the fp32
    logits (``roofline.analytic_memory_bytes``)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import GH200, ServingConfig, ShapeConfig
    from repro_torch.core.types import RequestState, SamplingParams
    from repro_torch.kernels import paged_attention as paged
    from repro_torch.launch import roofline
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.tree import tree_leaves
    B, plen = 8, 1016
    sv = ServingConfig(num_hbm_blocks=1024, paged_runner=True, block_size=16,
                       prefill_chunk=512, kv_dtype="bf16")
    eng = ServingEngine(cfg, sv, GH200, runner_seed=0, device=device)
    rng = np.random.default_rng(13)
    handles = [eng.add_request(
        prompt_ids=[int(x) for x in rng.integers(1, cfg.vocab_size, plen)],
        sampling_params=SamplingParams(max_tokens=64)) for _ in range(B)]
    for _ in range(200):
        if all(h.request.state == RequestState.RUNNING
               and h.request.generated_ids for h in handles):
            break
        eng.step()
    else:
        raise AssertionError("roofline: the requests never all decoded")
    ex = eng.executor
    eng.step()                                   # a decode-only warm-up
    torch.cuda.synchronize()
    batches, chunks = ex.decode_batches, ex.prefill_chunks_run
    with device_profile(torch) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    if (ex.decode_batches - batches != steps
            or ex.prefill_chunks_run != chunks):
        raise AssertionError("roofline: the traced iterations were not "
                             "decode-only")
    by_family = device_time_by_family(prof)
    device_ms = sum(by_family.values()) / steps
    ctx = [h.request.total_len for h in handles]    # this step's contexts
    with FlopCounterMode(display=False) as fc:
        eng.step()
        torch.cuda.synchronize()
    L = cfg.num_layers
    e = 2
    mb = 1 << max(-(-max(ctx) // 16) - 1, 0).bit_length()
    pf, _ = paged.flops_and_bytes(B, cfg.num_heads, cfg.num_kv_heads,
                                   cfg.head_dim, mb, sum(ctx), itemsize=e,
                                   kv_itemsize=e, quant=False)
    aten = float(fc.get_total_flops())
    flops = aten + L * pf
    weights = sum(t.numel() * t.element_size()
                  for t in tree_leaves({"l": ex._layers, "h": ex._head}))
    kv = sum(ctx) * L * 2 * cfg.num_kv_heads * cfg.head_dim * e
    shape = ShapeConfig("s1_decode", int(np.mean(ctx)), B, "decode")
    mem = roofline.analytic_memory_bytes(
        cfg, shape, weights_local=weights, opt_local=0, cache_local=kv,
        data_shards=1, model_shards=1, fsdp_shards=1)
    summ = roofline.summarize(cfg, shape, 1, {"flops": flops}, {}, mem)
    bound_ms = summ["step_s_lower_bound"] * 1e3
    res = dict(flops=flops, aten_flops=aten, paged_flops=L * pf,
               model_flops=summ["model_flops_global"], bytes=mem["total"],
               weights_bytes=weights, kv_bytes=kv, logits_bytes=mem["logits"],
               compute_ms=summ["compute_s"] * 1e3,
               memory_ms=summ["memory_s"] * 1e3, bound_ms=bound_ms,
               bottleneck=summ["bottleneck"], device_ms=device_ms,
               wall_ms=wall_ms, share_of_device=bound_ms / device_ms,
               share_of_wall=bound_ms / wall_ms, contexts=ctx,
               device_ms_by_family={k: v / steps
                                    for k, v in by_family.items()})
    log(f"roofline S1 decode iteration (B={B}, contexts {min(ctx)}-"
        f"{max(ctx)}, bf16): FLOPs {flops:.4e} (aten {aten:.4e} + paged "
        f"{L * pf:.4e}; model_flops {res['model_flops']:.4e}), bytes "
        f"{mem['total']:.4e} (weights {weights}, KV {kv}, logits "
        f"{mem['logits']:.0f}); compute {res['compute_ms']:.4f} ms, memory "
        f"{res['memory_ms']:.4f} ms, bound {bound_ms:.4f} ms "
        f"({summ['bottleneck']}); measured device {device_ms:.4f} ms, wall "
        f"{wall_ms:.4f} ms a iteration (mean of {steps}); bound / device "
        f"{res['share_of_device']:.4f}, bound / wall "
        f"{res['share_of_wall']:.4f}; device ms by family "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            res["device_ms_by_family"].items(), key=lambda kv: -kv[1])))
    del eng, ex, handles
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tool_run(args, timeout):
    """Run ``python -m <args>`` from the repository root with ``src`` on the
    path; log its output; fail on a non-zero exit."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m"] + args, cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    for line in (r.stdout + r.stderr).splitlines():
        if "profiler_st" not in line:       # the profiler's USDT chatter
            log(f"  | {line}")
    log(f"{args[0]}: rc {r.returncode} in {time.perf_counter() - t0:.2f} s")
    if r.returncode != 0:
        raise AssertionError(f"{' '.join(args)} exited {r.returncode}")


def tooling_phase(torch):
    """The launch tooling on the card: (a) the in-place audit at llama3-8b's
    full width in bf16 weights with S1 (a)'s pool (1,024 HBM blocks, block
    16, chunk 512), bf16 and int8 KV, at tp=1 and at tp=2 over two shards
    stacked on the card, every launch entry in place (each shard's pool and
    scales) with its peak memory growth below one (shard's) pool's bytes,
    the out-of-place control caught; (b) the roofline of one S1 decode iteration; (c) the inspector
    on llama3-8b decode_32k at one layer (B 128 over 32,768 positions) as a
    subprocess; (d) the dry-run of llama3-405b train_4k on both meshes
    (bytes, FLOPs, collective bytes, the single pod's roofline) as a
    subprocess, alongside (c). Returns the kernel launches of (a) and
    (b)."""
    from repro_torch.configs import ServingConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import audit_donation
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    cfg = get_config("llama3-8b")
    sv = ServingConfig(num_hbm_blocks=1024, paged_runner=True, block_size=16,
                       prefill_chunk=512)
    rows = audit_donation.audit(cfg, sv, "cuda", tp2=["cuda:0", "cuda:0"])
    audit_donation.print_table(rows)
    for r in rows:
        log(f"audit {r.name}: peak growth {r.growth} B of a {r.pool_bytes} B "
            f"pool ({r.growth / r.pool_bytes:.6f}), {r.verdict}")
    bad = [r.name for r in rows if not r.ok]
    if bad or len(rows) != 17:
        raise AssertionError(f"audit: {len(rows)} entries, failed {bad}")
    gc.collect()
    torch.cuda.empty_cache()
    roof = roofline_decode(torch, cfg)
    launches = ops.launch_counts()
    log(f"tooling path kernel launches: {launches}")
    idle = [k for k, n in launches.items() if not n]
    if idle:
        raise AssertionError(f"tooling: kernels never launched {idle}")
    root = Path(__file__).resolve().parent
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3-405b", "--shape", "train_4k", "--mesh", "both", "--force"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, PYTHONPATH=str(root / "src")))
    try:
        tool_run(["repro_torch.launch.inspect_hlo", "--arch", "llama3-8b",
                  "--shape", "decode_32k", "--periods", "1"], timeout=300)
        t0 = time.perf_counter()
        out, _ = dry.communicate(timeout=300)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    for line in out.splitlines():
        log(f"  | {line}")
    log(f"repro_torch.launch.dryrun: rc {dry.returncode} "
        f"({time.perf_counter() - t0:.2f} s after the inspector)")
    if dry.returncode != 0:
        raise AssertionError(f"dryrun exited {dry.returncode}")
    log(f"phase 13 wall: {time.perf_counter() - t_phase:.2f} s")
    return launches, roof


# --------------------------------------------------------------- phase 14

# the tensor-parallel tests' BASE: reduced llama3-8b with heads wide enough
# for tp=4 to shard whole kv-head groups
TP_BASE_HEADS = dict(num_heads=8, num_kv_heads=4, head_dim=16)


def first_divergences(a, b):
    """Per request, its first differing step with both runs' top-2 margins
    there (past it the two runs decode different contexts)."""
    out = []
    for rid in sorted(a["streams"]):
        for i, (s, t) in enumerate(zip(a["streams"][rid],
                                       b["streams"][rid])):
            if s != t:
                out.append((rid, i, a["margins"][rid][i],
                            b["margins"][rid][i]))
                break
    return out


def tp_full_width(torch, cfg, prompts, full, mesh=("cuda:0", "cuda:0")):
    """Phase 14 (a): llama3-8b at full width in bf16 at tp=2 over ``mesh``
    (both shards stacked on the card), with phase 5's prompts and weights
    (seed 0), at S1's 1024 and 119 HBM blocks, bf16 and int8 KV, against
    ``full``, tp=1's runs of ``cfg`` (``serving_runs``; phase 14 cuts
    ``cfg`` to ``TP_DEPTH`` layers)."""
    from repro_torch.models.common import dtype_of
    from repro_torch.models.params import init_params
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, torch.device("cuda"), dtype_of(cfg.dtype))
    mesh = list(mesh)
    paged = {"bf16": "paged_attention", "int8": "paged_attention_int8"}
    for kvd in ("bf16", "int8"):
        res = serving_runs(torch, cfg, prompts,
                           dict(block_size=16, prefill_chunk=512,
                                kv_dtype=kvd, tp=2), 1024, mesh,
                           f"llama3-8b tp=2 ({', '.join(mesh)}) {kvd} KV",
                           params=params, trace=("a",))
        for run in ("a", "b"):
            r, one = res[run], full[kvd][run]
            tr = r["transfer"]
            busy = ""
            if "device_ms" in r:
                ms = sum(r["device_ms"].values())
                busy = (f" (traced), device busy {ms:.1f} ms "
                        f"({ms / (r['wall_s'] * 1e3):.3f} of wall), by family "
                        + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(
                            r["device_ms"].items(), key=lambda kv: -kv[1])))
            log(f"tp=2 {kvd} run ({run}): wall {r['wall_s']:.3f} s{busy}, "
                f"peak memory {r['peak_bytes']} B (the caller's "
                f"full weights included), pool {r['pool_shard_bytes']} B a "
                f"shard of {r['pool_global_bytes']} B, link bytes a shard "
                f"d2h {tr['d2h_bytes_per_shard']} of {tr['d2h_bytes']}, h2d "
                f"{tr['h2d_bytes_per_shard']} of {tr['h2d_bytes']}")
            if (r["pool_shard_bytes"] * 2 != r["pool_global_bytes"]
                    or tr["kv_shards"] != 2
                    or tr["d2h_bytes_per_shard"] * 2 != tr["d2h_bytes"]
                    or tr["h2d_bytes_per_shard"] * 2 != tr["h2d_bytes"]):
                raise AssertionError(f"tp=2 {kvd} ({run}): a shard does not "
                                     f"hold or move half the bytes")
            # one logical launch per layer per decode iteration; the
            # kernel's own counter counts each shard's launch
            pa = paged[kvd]
            if r["launches"][pa] != 2 * r["attn_launches"]:
                raise AssertionError(f"tp=2 {kvd} ({run}): {pa} launched "
                                     f"{r['launches'][pa]} times for "
                                     f"{r['attn_launches']} layer launches")
            idle = [k for k in ("kv_copy", pa, "flash_attention")
                    if not r["launches"][k]]
            if idle:
                raise AssertionError(f"tp=2 {kvd} ({run}): kernels never "
                                     f"launched {idle}")
            share, first = agreement(one, r)
            divs = first_divergences(one, r)
            bad = [d for d in divs if min(d[2], d[3]) > DIVERGENCE_TIE]
            log(f"tp=2 vs tp=1 ({cfg.num_layers} layers) {kvd} run ({run}): "
                f"{share:.4f} of "
                f"tokens agree; first divergence (req, step, margin tp=1, "
                f"margin tp=2): {first}; {len(divs)} requests diverge, "
                f"{len(bad)} with both margins above {DIVERGENCE_TIE}; "
                f"rotations {r['rotations']} vs {one['rotations']}, decode "
                f"batches {r['decode_batches']} vs {one['decode_batches']}, "
                f"attn_launches {r['attn_launches']} vs "
                f"{one['attn_launches']}")
            if bad:
                raise AssertionError(f"tp=2 {kvd} ({run}): diverges past a "
                                     f"near tie: {bad}")
            if (r["streams"] == one["streams"]
                    and r["decode_batches"] == one["decode_batches"]
                    and r["attn_launches"] != one["attn_launches"]):
                raise AssertionError(f"tp=2 {kvd} ({run}): launch count "
                                     f"depends on tp")
        if not (res["b"]["rotations"] > 0):
            raise AssertionError(f"tp=2 {kvd} run (b) did not rotate")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def tp_reduced(torch, cfg, mesh_of, label):
    """Phase 14 (b): the reduced llama3-8b in fp32 (the TP tests' BASE:
    8/4/16) at tp 1, 2 and 4 under rotation, the plain reduced config (2
    kv heads) at tp 1 and 4 (the replicated-attention fallback), and BASE
    in the int8 tier at tp 1 and 2: on the card (``mesh_of(tp)`` the
    shards' devices) the streams equal tp=1's and the CPU's from the same
    weights. The int8 shards' scales against tp=1's: bitwise for the same
    tokens stored directly, and end to end reported by layer."""
    from repro_torch.configs import ServingConfig
    from repro_torch.kernels import quant
    from repro_torch.models.params import init_params
    from repro_torch.tree import tree_map
    base = dataclasses.replace(cfg.reduced(), dtype="float32",
                               **TP_BASE_HEADS)
    fb = dataclasses.replace(cfg.reduced(), dtype="float32")
    prompts = make_prompts(base, 5, (8, 16), (10, 16), seed=3)
    stores = {}
    for c, name, kvd, tps in ((base, "BASE", "bf16", (1, 2, 4)),
                              (fb, "fallback", "bf16", (1, 4)),
                              (base, "BASE", "int8", (1, 2))):
        params = init_params(c, torch.Generator().manual_seed(42), "cpu",
                             torch.float32)
        on_card = tree_map(lambda t: t.to("cuda"), params)
        one = None
        for tp in tps:
            sv = ServingConfig(num_hbm_blocks=16, num_dram_blocks=512,
                               block_size=4, max_model_len=64,
                               prefill_chunk=8, paged_runner=True, tp=tp,
                               kv_dtype=kvd)
            res = serve(torch, c, sv, prompts,
                         mesh_of(tp) if tp > 1 else "cuda",
                         params=on_card if tp == 1 else params,
                         keep_store=kvd == "int8")
            cpu = serve(torch, c, sv, prompts, "cpu", params=params)
            one = one or res
            log(f"{label} {name} {kvd} tp={tp}: rotations "
                f"{res['rotations']}, card == tp=1 on the card "
                f"{res['streams'] == one['streams']}, card == CPU "
                f"{res['streams'] == cpu['streams']}, kernel launches "
                f"{res['launches']}")
            if res["rotations"] == 0:
                raise AssertionError(f"{label} {name} tp={tp}: no rotation")
            if not (res["streams"] == one["streams"] == cpu["streams"]):
                raise AssertionError(f"{label} {name} {kvd} tp={tp}: streams "
                                     f"differ from tp=1 or the CPU")
            if kvd == "int8":
                stores[tp] = res["store"]
    want = stores[1].scales
    got = torch.cat([t.to(want.device) for t in stores[2].scale_shards], -1)
    rel = [((got[:, li] - want[:, li]).abs()
            / want[:, li].abs().clamp(min=1e-30)).max().item()
           for li in range(base.num_layers)]
    log(f"{label} int8 tp=2 shard scales vs tp=1's slices, end to end: "
        f"layer 0 bitwise {torch.equal(got[:, 0], want[:, 0])}, max rel "
        f"diff by layer {[f'{x:.3e}' for x in rel]} (the all-reduce rounds "
        f"the residual stream in another order)")
    if max(rel) > 1e-5:
        raise AssertionError(f"{label} int8 shard scales off by {max(rel)}")
    # the same tokens stored into a pool and into its two kv-head shards
    g = torch.Generator(device="cuda").manual_seed(7)
    L, P, H, D, rows = 4, 4, 4, 16, 12
    full = torch.zeros(rows, L, 2, P, H, D, dtype=torch.int8, device="cuda")
    fsc = torch.zeros(rows, L, 2, H, device="cuda")
    dev = mesh_of(2)
    parts = [(torch.zeros(rows, L, 2, P, H // 2, D, dtype=torch.int8,
                          device=d), torch.zeros(rows, L, 2, H // 2,
                                                 device=d)) for d in dev]
    for step in range(16):
        # 9 distinct (row, layer, offset) slots, as a call of the runner
        # writes (a slot written twice in one call is a race on the card)
        slot = torch.randperm(rows * L * P, generator=g, device="cuda")[:9]
        idx = [slot // (L * P), slot // P % L, slot % P]
        for side in (0, 1):
            x = torch.randn((9, H, D), generator=g, device="cuda") * (1 + step)
            quant.quant_store_tokens(full, fsc, idx[0], idx[1], side, idx[2], x)
            for i, ((pool, sc), d) in enumerate(zip(parts, dev)):
                quant.quant_store_tokens(
                    pool, sc, *(t.to(d) for t in idx[:2]), side,
                    idx[2].to(d), x[:, 2 * i:2 * i + 2].to(d))
    same = (torch.equal(torch.cat([p.to("cuda") for p, _ in parts], -2), full)
            and torch.equal(torch.cat([s.to("cuda") for _, s in parts], -1),
                            fsc))
    log(f"{label} int8 store of the same tokens into a pool and its two "
        f"kv-head shards: values and scales bitwise equal {same}")
    if not same:
        raise AssertionError("int8 shard scales are not the pool's slices")


# phase 14 (a)'s depth: 4 of llama3-8b's 32 layers, at full width, held to
# tp=1 at the same depth (at 32 layers it took 143.4 s of the script's
# 1200, at 8 layers 86.71 s; cut to 4 to make room for phase 19,
# scripts/phase_budget.py, PERF.md §7)
TP_DEPTH = 4


def tp_phase(torch, cfg, prompts):
    """Tensor parallelism on the card (target 90 s): (a) full width at
    ``TP_DEPTH`` layers, tp=2 stacked on one card against tp=1, (b) the
    reduced fp32 matrix, (c) (b) over two cards where the machine has
    them. Returns the phase's kernel launches."""
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    cut = dataclasses.replace(cfg, num_layers=TP_DEPTH)
    sv_kw = dict(block_size=16, prefill_chunk=512)
    one = {kvd: serving_runs(torch, cut, prompts, dict(sv_kw, kv_dtype=kvd),
                             1024, "cuda", f"llama3-8b at {TP_DEPTH} layers "
                             f"tp=1 {kvd} KV") for kvd in ("bf16", "int8")}
    tp_full_width(torch, cut, prompts, one)
    log(f"phase 14 (a) wall: {time.perf_counter() - t_phase:.2f} s")
    t0 = time.perf_counter()
    tp_reduced(torch, cfg, lambda tp: ["cuda:0"] * tp, "tp stacked")
    log(f"phase 14 (b) wall: {time.perf_counter() - t0:.2f} s")
    n = torch.cuda.device_count()
    if n >= 2:
        t0 = time.perf_counter()
        tp_reduced(torch, cfg, lambda tp: [f"cuda:{i % n}" for i in
                                           range(tp)], "tp over cards")
        log(f"phase 14 (c) wall: {time.perf_counter() - t0:.2f} s")
    else:
        log(f"phase 14 (c) not run: the machine has {n} CUDA device; the "
            f"cross-card all-reduce needs two")
    launches = ops.launch_counts()
    log(f"tp path kernel launches (each shard's launch counted): {launches}")
    log(f"phase 14 wall: {time.perf_counter() - t_phase:.2f} s")
    return launches


# --------------------------------------------------------------- phase 15

MESH_STACK = ["cuda:0"] * 4
# gemma3-1b's bf16 losses on a mesh against one card's: they read
# 1.717e-05 apart (the partials add in another order); a forward on half
# the batch or a wrong mask count reads further off
MESH_TOL = 1e-3
# the same run's state after its steps against one card's, leaf by leaf:
# the largest relative gap of the leaves' measures (``leaf_measures``).
# The losses cannot tell a step that leaves the state as it was (at the
# warm-up's learning rate the bf16 weights barely move in 3 steps); its
# zero moments read 1 here (the frozen-update control, measured in each
# run), a sound mesh step 1.376e-02 stacked and 1.304e-02 over four cards
# (bf16 gradients added in another order move a small leaf's int8 scale
# by about 1%). Phase 16 (a) holds mamba2-2.7b's parameters and moments
# to it apart, and its frozen control must read past it on both. An int8
# moment's measure, the norm of its dequantised values, is linear in its
# leaf's gradient scale: a leaf whose gradient is off by 10% in scale
# moves its first moment's by 0.1 (its codes alone follow no scale, being
# relative to their block's maximum). mamba2 reads 4.367e-02 stacked,
# 6.025e-02 over four cards, 5.208e-02 for no mesh with one microbatch
# against two (the noise of bf16 adds in another order)
STATE_TOL = 0.1
# qwen3-moe's bf16 losses on (1, 2) against no mesh: 7.969e-03 apart
# (1.214e-02 on an earlier tree): the partials add in another order and
# flip routing at near ties (18,104 dropped assignments against 18,153),
# while two runs with no mesh read 0 apart (printed beside it in each run)
MOE_MESH_TOL = 2e-2


def worst(xs):
    """The largest of ``xs``, NaN where any is NaN (``max`` keeps a NaN
    only where it comes first), so that ``not (worst(xs) <= tol)`` fails
    on a NaN."""
    return float(np.max(np.asarray(list(xs), dtype=np.float64)))


def leaf_measures(torch, leaves):
    """Each leaf's measure, in fp64: its sum of |x|; for an int8 moment's
    codes (the next leaf being their fp32 block scales, as AdamW stores
    them) the L2 norm of the dequantised values. ``leaves`` is an iterable
    of tensors in a train state's leaf order."""
    out, codes = [], None
    for t in leaves:
        if codes is not None:
            deq = codes.double().reshape(*t.shape, -1) * t.double()[..., None]
            out[-1] = float(torch.linalg.vector_norm(deq))
            codes = None
        elif t.dtype == torch.int8:
            codes = t
        out.append(float(t.double().abs().sum()))
    return out


def checkpoint_measures(torch, directory, dev):
    """``leaf_measures`` of a checkpoint directory of the port's format,
    read leaf by leaf onto ``dev``."""
    manifest = json.loads((directory / "manifest.json").read_text())

    def leaves():
        for meta in manifest["leaves"]:
            arr = np.load(directory / f"leaf_{meta['i']}.npy")
            t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                 if meta["dtype"] == "bfloat16" else torch.from_numpy(arr))
            yield t.to(dev)
    return leaf_measures(torch, leaves())


def state_measures(torch, state):
    """``leaf_measures`` of a train state held in memory (whole or laid
    over a mesh), in the checkpoint's leaf order."""
    from repro_torch.distributed import spmd
    from repro_torch.tree import flatten
    return leaf_measures(torch, (spmd.gather(x) if spmd.is_placed(x) else x
                                 for x in flatten(state)[0]))


def state_gap(got, want):
    """The largest relative gap between two lists of leaf measures."""
    return worst(abs(a - b) / max(abs(b), 1e-30)
                 for a, b in zip(got, want, strict=True))


def leaf_names(tree, prefix=""):
    """Dotted names of a tree's leaves in the checkpoint's leaf order
    (sorted dict keys; named tuples by field)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None) or range(len(tree))
        return [n for f, v in zip(fields, tree)
                for n in leaf_names(v, f"{prefix}{f}.")]
    return [prefix[:-1]]


def split_gaps(got, want, names):
    """(the parameters' state gap, the moments' state gap) of two lists of
    leaf measures in the order of ``names`` (``leaf_names`` of a train
    state). An int8 moment counts once, by its dequantised norm: its
    scales' own measures are left out."""
    par = [i for i, n in enumerate(names) if n.startswith("params.")]
    opt = [i for i, n in enumerate(names)
           if not n.startswith("params.") and not n.endswith(".scale")]
    return tuple(state_gap([got[i] for i in ix], [want[i] for i in ix])
                 for ix in (par, opt))


def widest_gaps(got, want, names, n=3):
    """The ``n`` leaves whose measures lie relatively furthest apart."""
    gaps = sorted(((abs(a - b) / max(abs(b), 1e-30), name) for a, b, name
                   in zip(got, want, names, strict=True)
                   if not name.endswith(".scale")), reverse=True)
    return ", ".join(f"{name} {g:.3e}" for g, name in gaps[:n])


class _Tee:
    """A text stream that writes to several."""

    def __init__(self, *outs):
        self.outs = outs

    def write(self, text):
        for out in self.outs:
            out.write(text)
        return len(text)

    def flush(self):
        for out in self.outs:
            out.flush()


def launch_with_state(torch, args, dev, step_ms=None):
    """The launcher run with ``args`` and a checkpoint at its end: its
    losses and ``checkpoint_measures`` of its last state. ``step_ms``, a
    list, receives the wall of each step the launcher logs (``--log-every
    1``: all), as it prints it."""
    import contextlib
    import io
    import re
    from repro_torch.launch.train import main as train_main
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as ck:
        with contextlib.redirect_stdout(_Tee(sys.stdout, out)):
            losses = train_main(args + ["--ckpt-dir", ck])
        last = max(Path(ck).glob("step_*"))
        if step_ms is not None:
            step_ms.extend(float(ms) for ms in re.findall(
                r"^step +\d+ loss \S+ \((\d+) ms", out.getvalue(), re.M))
        return losses, checkpoint_measures(torch, last, dev)


def mesh_step_profile(torch, step_fn, state, batches, mesh, label,
                      warm_up=True):
    """A warm-up step on the first batch (unless the caller's runs warmed
    this path already), timed steps on the batches up to the last (mean
    wall, ending in a synchronize) and one traced step on the last:
    (state, step seconds (the traced step's, where no batch is left to
    time), traced seconds, device ms by family, collective bytes of the
    traced step by position). Logs the trace's top device operations
    too."""
    from repro_torch.distributed import spmd
    from repro_torch.launch.inspect_hlo import top_ops
    if warm_up:
        state, _ = step_fn(state, batches[0])
        torch.cuda.synchronize()
    timed = batches[1:-1] if warm_up else batches[:-1]
    t0 = time.perf_counter()
    for b in timed:
        state, m = step_fn(state, b)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / max(len(timed), 1)
    spmd.reset_collective_bytes()
    with device_profile(torch) as prof:
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[-1])
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    if not timed:
        step_s = traced_s
    coll = [spmd.collective_bytes(r) for r in range(mesh.size)]
    fams = device_time_by_family(prof)
    busy = sum(fams.values())
    log(f"{label}: wall {step_s * 1e3:.1f} ms a step ("
        + (f"mean of {len(timed)}{' after a warm-up' if warm_up else ''}"
           if timed else "the traced step's") + "); traced step "
        f"wall {traced_s * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({busy / (traced_s * 1e3):.3f} of wall), by family "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in
                    sorted(fams.items(), key=lambda kv: -kv[1])))
    tops = sorted(top_ops(prof, mesh.devices[0]).items(),
                  key=lambda kv: -kv[1][0])[:5]
    log(f"{label}: top device operations of the traced step (ms, calls): "
        + "; ".join(f"{name[:60]} {ms:.1f} ({calls})"
                    for name, (ms, calls) in tops))
    return state, step_s, traced_s, fams, coll


def mesh_phase(torch, train_losses, train_sums, dev="cuda"):
    """Training on a (data, model) mesh (cell S10): (a) gemma3-1b at full
    width through the launcher on (2, 2) stacked on the card, against
    phase 12's losses and state at step 3 (``train_sums``), then the same
    step through ``make_train_step``: the frozen-update control, the
    bytes a position holds against the dry-run, wall, busy share,
    collective bytes and the roofline's terms; (b) qwen3-moe-30b-a3b at
    full width, 4 layers, with no mesh (twice), on (1, 2) and on (2, 2);
    (c) the reduced llama3-8b and qwen3-moe in fp32 on the card against
    the CPU, and a checkpoint across meshes; (d) (a) across four cards
    where the machine has them. Returns the phase's kernel launches.
    ``dev`` other than "cuda" runs the phase there (a dry run of its
    logic; (d) where torch reports four cards)."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data.pipeline import SyntheticPacked
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import TRAIN_RULES
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.lm import LM
    from repro_torch.models.params import init_lm_params, params_to
    from repro_torch.optimizer import adamw
    from repro_torch.optimizer.adamw import AdamWConfig
    from repro_torch.tree import flatten
    from repro_torch.training import step as steplib
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    axes = ("data", "model")
    stack = MESH_STACK if dev == "cuda" else [dev] * 4
    cfg = get_config("gemma3-1b")
    B, S, MB, steps = 4, 1024, 2, 3
    ops.reset_launch_counts()

    # (a) through the launcher, as a user runs it
    args = ["--arch", "gemma3-1b", "--steps", str(steps), "--batch", str(B),
            "--seq", str(S), "--microbatches", str(MB), "--moments-dtype",
            "int8", "--log-every", "1", "--mesh", "2,2", "--device",
            ",".join(stack)]
    torch.cuda.reset_peak_memory_stats()
    spmd.reset_collective_bytes()
    t0 = time.perf_counter()
    losses, sums = launch_with_state(torch, args, dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    flash = ops.launch_counts()["flash_attention"]
    fwd = steps * MB * cfg.num_attn_layers * 4
    gap = max(abs(a - b) for a, b in zip(losses, train_losses[:steps]))
    sgap = state_gap(sums, train_sums)
    log(f"mesh (a) gemma3-1b full width on a (2, 2) mesh stacked on "
        f"cuda:0 (4 shards), {B} x {S} in {MB} microbatches, int8 moments, "
        f"remat: losses {losses} against phase 12's "
        f"{train_losses[:steps]}: max |gap| {gap:.3e} (tolerance "
        f"{MESH_TOL}); its state after {steps} steps against phase 12's: "
        f"largest relative gap of a leaf's measure {sgap:.3e} "
        f"(tolerance {STATE_TOL}); {wall:.2f} s for {steps} steps and a "
        f"checkpoint (weights drawn and placed at start); peak device "
        f"memory {peak} B; flash launches "
        f"{flash}: forward {fwd} (steps x microbatches x "
        f"{cfg.num_attn_layers} attention layers x 4 shards) + recompute "
        f"{flash - fwd}; collective bytes per position (max) "
        f"{spmd.collective_bytes()}")
    if not all(np.isfinite(losses)) or gap > MESH_TOL:
        raise AssertionError(f"mesh (a): losses {losses} vs {train_losses}")
    if not sgap <= STATE_TOL:
        raise AssertionError(f"mesh (a): state gap {sgap} to phase 12's")
    if flash != 2 * fwd:
        raise AssertionError(f"mesh (a): flash launched {flash} times, "
                             f"expected {fwd} forward + {fwd} recompute")
    gc.collect()
    torch.cuda.empty_cache()

    # the same step through make_train_step: bytes, walls, a trace
    mesh = make_mesh((2, 2), axes, stack)
    lm = LM(cfg)
    opt = AdamWConfig(moments_dtype="int8")
    state = steplib.init_train_state(
        lm, torch.Generator(device=dev).manual_seed(0), opt, stack[0],
        mesh=mesh)
    # the frozen-update control: the state a step that changes nothing
    # leaves (the one just drawn) against phase 12's at step 3
    frozen = state_gap(state_measures(torch, state), train_sums)
    log(f"mesh (a) frozen-update control: the drawn state against phase "
        f"12's at step {steps}: largest relative gap {frozen:.3e} (must "
        f"exceed the tolerance {STATE_TOL}; the mesh run's {sgap:.3e})")
    if not frozen > STATE_TOL:
        raise AssertionError(f"mesh (a): an unchanged state reads within "
                             f"{STATE_TOL} of phase 12's")
    structs = steplib.train_state_structs(lm, opt)
    st_axes = steplib.train_state_logical_axes(lm, opt)
    held = {}
    for part in ("params", "opt"):
        want = dryrun.tree_bytes_per_device(getattr(structs, part),
                                            getattr(st_axes, part), mesh,
                                            TRAIN_RULES)
        held[part] = spmd.bytes_per_position(getattr(state, part))
        if held[part] != [want] * mesh.size:
            raise AssertionError(f"mesh (a): {part} bytes a position "
                                 f"{held[part]} != dry-run's {want}")
    log(f"mesh (a) bytes a position holds (= dryrun.tree_bytes_per_device "
        f"for gemma3-1b, (2, 2), TRAIN_RULES, int8 moments): params "
        f"{held['params'][0]} B, moments {held['opt'][0]} B; whole params "
        f"{sum(int(np.prod(s.shape)) * 2 for s in flatten(structs.params)[0])}"
        f" B")
    step_fn = steplib.make_train_step(lm, opt, microbatches=MB, mesh=mesh)
    data = SyntheticPacked(cfg.vocab_size, S, B)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                next(data).items()} for _ in range(4)]
    torch.cuda.reset_peak_memory_stats()
    state, step_s, traced_s, fams, coll = mesh_step_profile(
        torch, step_fn, state, batches, mesh, "mesh (a) step, gemma3-1b on "
        "(2, 2) stacked")
    peak_step = torch.cuda.max_memory_allocated()
    shape = ShapeConfig("t", S, B, "train")
    coll_dev = max(sum(c.values()) for c in coll)
    mem = roofline.analytic_memory_bytes(
        cfg, shape, weights_local=held["params"][0],
        opt_local=held["opt"][0], cache_local=0.0, data_shards=2,
        model_shards=2, fsdp_shards=2, microbatches=MB)
    terms = roofline.roofline_terms(roofline.model_flops(cfg, shape) / 4,
                                    mem["total"], coll_dev)
    log(f"mesh (a) step: {B * S / step_s:.1f} tokens/s; peak device memory "
        f"over the steps {peak_step} B; collective bytes of the traced "
        f"step, position 0: {coll[0]} (max over positions {coll_dev} B); "
        f"roofline a position (H100 SXM peaks; the 4 positions share one "
        f"card here): compute {terms['compute_s'] * 1e3:.3f} ms (model "
        f"FLOPs / 4), memory {terms['memory_s'] * 1e3:.3f} ms, collective "
        f"{terms['collective_s'] * 1e3:.3f} ms at "
        f"{roofline.H100_SXM.link_bw:.3e} B/s; bound "
        f"{terms['step_s_lower_bound'] * 1e3:.3f} ms ({terms['bottleneck']})"
        f" against {step_s * 1e3:.1f} ms of wall")
    del state, batches, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # (b) qwen3-moe-30b-a3b at full width, 4 of 48 layers
    qcfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), num_layers=4)
    qlm = LM(qcfg)
    qopt = AdamWConfig(moments_dtype="int8")
    qdata = SyntheticPacked(qcfg.vocab_size, 512, 2)
    qbatches = [{k: torch.from_numpy(v).to(dev) for k, v in
                 next(qdata).items()} for _ in range(2)]
    qlosses = {}
    # no mesh twice: how far two runs of the same step read apart
    for run, shape_m in enumerate((None, None, (1, 2), (2, 2))):
        qmesh = (make_mesh(shape_m, axes, stack[:int(np.prod(shape_m))])
                 if shape_m else None)
        t0 = time.perf_counter()
        qstate = steplib.init_train_state(
            qlm, torch.Generator(device=dev).manual_seed(0), qopt, stack[0],
            mesh=qmesh)
        fn = steplib.make_train_step(qlm, qopt, mesh=qmesh)
        out = []
        for b in qbatches:
            qstate, m = fn(qstate, b)
            out.append(float(m["loss"]))
        qlosses[run] = out
        recording, seen = route_records(torch, moe)
        orig, moe.route_logits = moe.route_logits, recording
        try:
            with torch.no_grad():
                qlm.train_loss(qstate.params, qbatches[0], remat=False,
                               mesh=qmesh)
        finally:
            moe.route_logits = orig
        held_b = (spmd.bytes_per_position(qstate.params) if qmesh
                  else [sum(t.numel() * t.element_size()
                            for t in flatten(qstate.params)[0])])
        n = qmesh.size if qmesh else 1
        drops = [int(x[0]) for x in seen]
        per_data = {}
        for i, dcount in enumerate(drops):
            r = i % n
            di = qmesh.axis_index(r, "data") if qmesh else 0
            if qmesh is None or qmesh.axis_index(r, "model") == 0:
                per_data[di] = per_data.get(di, 0) + dcount
        log(f"mesh (b) qwen3-moe-30b-a3b at full width ({qcfg.num_layers} "
            f"of 48 layers, {qcfg.moe.num_experts} experts, top-"
            f"{qcfg.moe.top_k}), 2 x 512, int8 moments, mesh {shape_m}: "
            f"losses {out}; params a position {held_b[0]} B; dropped "
            f"assignments per data shard over the {qcfg.num_layers} layers "
            f"of one forward {per_data}; {time.perf_counter() - t0:.2f} s")
        if not all(np.isfinite(out)):
            raise AssertionError(f"mesh (b): non-finite losses {out}")
        del qstate, fn
        gc.collect()
        torch.cuda.empty_cache()
    qspread = max(abs(a - b) for a, b in zip(qlosses[1], qlosses[0]))
    qgap = max(abs(a - b) for a, b in zip(qlosses[2], qlosses[0]))
    log(f"mesh (b) (1, 2) against no mesh: max |gap| {qgap:.3e} (tolerance "
        f"{MOE_MESH_TOL}; one data shard: the same capacity); two runs "
        f"with no mesh: max |gap| {qspread:.3e}; (2, 2) against no mesh: "
        f"{qlosses[3]} vs {qlosses[0]} (each data shard's own capacity)")
    if qgap > MOE_MESH_TOL or qspread > MOE_MESH_TOL:
        raise AssertionError(f"mesh (b): {qlosses}")
    del qbatches

    # (c) the reduced configs in fp32 on the card against the CPU
    for arch in ("llama3-8b", "qwen3-moe-30b-a3b"):
        rcfg = dataclasses.replace(get_config(arch).reduced(),
                                   dtype="float32")
        rlm = LM(rcfg)
        ropt = AdamWConfig(warmup_steps=1)
        cpu_params = init_lm_params(rcfg, torch.Generator().manual_seed(0),
                                    "cpu")
        rdata = SyntheticPacked(rcfg.vocab_size, 32, 4)
        rbatches = [{k: torch.from_numpy(v) for k, v in next(rdata).items()}
                    for _ in range(2)]
        res = {}
        for where in ("card", "cpu"):
            rmesh = make_mesh((2, 2), axes,
                              stack if where == "card" else "cpu")
            rdev = rmesh.devices[0]
            params = params_to(cpu_params, rdev)
            state = steplib.place_state(rlm, ropt, steplib.TrainState(
                params, adamw.init_state(params, ropt)), rmesh)
            fn = steplib.make_train_step(rlm, ropt, microbatches=2,
                                         mesh=rmesh)
            ls = []
            for b in rbatches:
                state, m = fn(state, {k: v.to(rdev) for k, v in b.items()})
                ls.append(float(m["loss"]))
            res[where] = (ls, state)
        (lc, sc), (lp, sp) = res["card"], res["cpu"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
        pc = [spmd.gather(x).cpu() for x in flatten(sc.params)[0]]
        pp = [spmd.gather(x) for x in flatten(sp.params)[0]]
        worst = max(((a - b).abs() - 1e-4 * b.abs()).max().item()
                    for a, b in zip(pc, pp))
        log(f"mesh (c) {rcfg.name} fp32 on (2, 2), card vs CPU: losses {lc} "
            f"vs {lp} (max relative {rel:.2e}, tolerance 1e-5); params after "
            f"2 steps: max of |card - cpu| - 1e-4 |cpu| {worst:.2e} "
            f"(tolerance 1e-5)")
        if rel > 1e-5 or worst > 1e-5:
            raise AssertionError(f"mesh (c): {rcfg.name} card != CPU")
        with tempfile.TemporaryDirectory() as ck:
            mgr = CheckpointManager(ck)
            mgr.save(2, sc)
            want = [spmd.gather(x).cpu() for x in flatten(sc)[0]]
            other = make_mesh((1, 2), axes, stack[:2])
            on_other = mgr.restore(2, steplib.train_state_logical_axes(
                rlm, ropt), mesh=other)
            plain = mgr.restore(2, sp, device=stack[0])
            for w, a, b in zip(want, flatten(on_other)[0],
                               flatten(plain)[0], strict=True):
                if not (torch.equal(spmd.gather(a).cpu(), w)
                        and torch.equal(b.cpu(), w)):
                    raise AssertionError("mesh (c): a restored leaf differs")
        log(f"mesh (c) {rcfg.name}: the checkpoint saved on (2, 2) restores "
            f"on (1, 2) and with no mesh to equal leaves "
            f"({len(want)} leaves)")
        del res, sc, sp
    launches = ops.launch_counts()

    # (d) across four cards
    if torch.cuda.device_count() >= 4:
        t0 = time.perf_counter()
        cards = ([f"cuda:{i}" for i in range(4)] if dev == "cuda"
                 else [dev] * 4)
        spread, dsums = launch_with_state(
            torch, args[:-1] + [",".join(cards)], dev)
        dgap = max(abs(a - b) for a, b in zip(spread, train_losses[:steps]))
        dsgap = state_gap(dsums, train_sums)
        log(f"mesh (d) (a) over {cards}: losses {spread}, max |gap| to "
            f"phase 12's {dgap:.3e} (tolerance {MESH_TOL}); state against "
            f"phase 12's {dsgap:.3e} (tolerance {STATE_TOL}); "
            f"{time.perf_counter() - t0:.2f} s")
        if not (dgap <= MESH_TOL and dsgap <= STATE_TOL):
            raise AssertionError(f"mesh (d): {spread} vs {train_losses}")
    else:
        log(f"mesh (d) not run: it needs four cards, torch sees "
            f"{torch.cuda.device_count()} (scripts/mesh_cards.py runs (a) "
            f"over four)")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 15 wall: {time.perf_counter() - t_phase:.2f} s")
    return launches


# --------------------------------------------------------------- phase 16

# the families of phase 16 (c), reduced in fp32: jamba at one whole period
FAMILY_REDUCED = (("mamba2-2.7b", {}), ("jamba-1.5-large-398b",
                                        {"num_layers": 8}),
                  ("paligemma-3b", {}), ("seamless-m4t-medium", {}))
# phase 16 (c)'s losses, card against CPU (relative)
FAMILY_CPU_RTOL = 1e-6
# phase 16 (b)'s losses on (2, 2) against no mesh: in bf16 the
# row-parallel partials round before they add, and an encoder-decoder has
# 60 such sums a step (seamless reads 1.197e-03, paligemma 6.2e-05); in
# fp32 the same comparison reads 0.0 for both, and holds the mesh's
# arithmetic
FAMILY_BF16_TOL = 3e-3
FAMILY_FP32_RTOL = 1e-5
# phase 16 (c), as tests/test_torch_mesh_families.py holds the mesh to the
# reference: Adam's first step moves an element by lr g / (|g| + eps), so
# where the clipped gradient lies within ADAM_FLAT eps of zero that step
# reads the gradient's last bits, which the card adds in another order.
# Such elements are held within 2 lr a step, at most MAX_FLAT a config
# past atol 1e-5 + rtol 1e-4: 1 measured (reduced mamba2's w_x, first
# gradient ~0, the second step's m^ / sqrt(v^) 0.7350 on both), 0 in the
# others; every other element within atol + rtol
ADAM_FLAT = 100.0
MAX_FLAT = 2


def fp32_states_apart(got, want, first_grads, opt):
    """Two train states with fp32 moments after the same two AdamW steps
    from one state (card and CPU), and the CPU's clipped gradients of the
    first step: (the moments' largest |got - want|; the largest gap past
    atol 1e-5 + rtol 1e-4 of an element whose first gradient is not flat
    (``ADAM_FLAT``), which must be <= 0; the flat elements' largest gap,
    held within 2 lr a step; how many flat elements lie past atol + rtol;
    the first few of them as "leaf[index] gap, first gradient"). NaN
    anywhere reads NaN or, in a flat element, counts."""
    from repro_torch.distributed import spmd
    from repro_torch.tree import flatten

    def whole(tree):
        return [spmd.gather(x).cpu().double() if spmd.is_placed(x)
                else x.cpu().double() for x in flatten(tree)[0]]
    mom = worst(float((a - b).abs().max()) for a, b in zip(
        whole(got.opt.m) + whole(got.opt.v),
        whole(want.opt.m) + whole(want.opt.v), strict=True))
    off_rest, flat_gap, flat_apart, seen = [], [], 0, []
    for name, a, b, g in zip(leaf_names(got.params), whole(got.params),
                             whole(want.params), first_grads, strict=True):
        gap = (a - b).abs()
        past = gap - (1e-5 + 1e-4 * b.abs())
        flat = g.abs() < ADAM_FLAT * opt.eps
        off_rest.append(float(past[~flat].max()) if (~flat).any() else
                        -1.0)
        flat_gap.append(float(gap[flat].max()) if flat.any() else 0.0)
        apart = (~(past <= 0) & flat).nonzero().tolist()
        flat_apart += len(apart)
        seen += [f"{name}{i} {float(gap[tuple(i)]):.3e}, "
                 f"{float(g[tuple(i)]):.1e}" for i in apart[:4 - len(seen)]]
    return mom, worst(off_rest), worst(flat_gap), flat_apart, seen


# phase 16 (a)'s depth: 8 of mamba2-2.7b's 64 layers at full width (the
# script passed 900 s of its 1200 s on a slow host once phase 18 came, so
# 32; 16 to make room for phase 19, 8 for phase 20, scripts/phase_budget.py)
MESH_FAMILY_DEPTH = 8


def mesh_families_phase(torch):
    """Training the SSM, hybrid, frontend and encoder-decoder families on a
    (data, model) mesh stacked on the card (cell S11): (a) mamba2-2.7b at
    full width and ``MESH_FAMILY_DEPTH`` layers through the launcher with
    no mesh and on (2, 2), 2 steps each with a checkpoint: losses, the
    launcher's step walls, the
    state against the no-mesh run's with the frozen-update control, the
    bytes a position holds against the dry-run, then one traced step
    through ``make_train_step`` (busy, peak, collective bytes by kind, top
    device operations); (b) paligemma-3b and seamless-m4t-medium at full
    width and depth through ``make_train_step`` with no mesh and on (2,
    2), 2 x 1024 positions with their embeddings, 2 steps, in bf16 and in
    fp32: losses and flash launches a shard; (c) the reduced mamba2, jamba
    (8 layers), paligemma and seamless in fp32 on (2, 2), card against
    CPU, and a checkpoint of the reduced mamba2 saved on (2, 2) restored
    on (1, 2). Returns the phase's kernel launches."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticPacked
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import TRAIN_RULES
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import LM
    from repro_torch.models.params import init_lm_params, params_to
    from repro_torch.optimizer import adamw
    from repro_torch.optimizer.adamw import AdamWConfig
    from repro_torch.tree import flatten
    from repro_torch.training import step as steplib
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    axes = ("data", "model")
    dev = MESH_STACK[0]
    ops.reset_launch_counts()

    # (a) mamba2-2.7b through the launcher, with no mesh and on (2, 2)
    cfg = dataclasses.replace(get_config("mamba2-2.7b"),
                              num_layers=MESH_FAMILY_DEPTH)
    B, S, MB, steps = 4, 1024, 2, 2
    args = ["--arch", "mamba2-2.7b", "--layers", str(MESH_FAMILY_DEPTH),
            "--steps", str(steps), "--batch", str(B), "--seq", str(S),
            "--microbatches", str(MB), "--moments-dtype", "int8",
            "--log-every", "1"]
    runs = {}
    for name, extra in (("no mesh", ["--device", dev]),
                        ("(2, 2)", ["--mesh", "2,2", "--device",
                                    ",".join(MESH_STACK)])):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step_ms = []
        losses, sums = launch_with_state(torch, args + extra, dev, step_ms)
        runs[name] = dict(losses=losses, sums=sums,
                          peak=torch.cuda.max_memory_allocated(),
                          wall=time.perf_counter() - t0, step_ms=step_ms)
        gc.collect()
        torch.cuda.empty_cache()
    flash_a = ops.launch_counts()["flash_attention"]
    one, mesh_run = runs["no mesh"], runs["(2, 2)"]
    gap = worst(abs(a - b) for a, b in zip(mesh_run["losses"],
                                           one["losses"], strict=True))
    names = leaf_names(steplib.train_state_structs(
        LM(cfg), AdamWConfig(moments_dtype="int8")))
    pgap, mgap = split_gaps(mesh_run["sums"], one["sums"], names)
    log(f"mesh families (a) {cfg.name} ({cfg.num_layers} layers, d_in "
        f"{cfg.ssm.expand * cfg.d_model}, "
        f"{cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} heads) through "
        f"the launcher, {B} x {S} in {MB} microbatches, int8 moments, remat, "
        f"{steps} steps and a checkpoint: no mesh losses {one['losses']} "
        f"({one['wall']:.2f} s, steps {one['step_ms']} ms, peak "
        f"{one['peak']} B); (2, 2) stacked losses {mesh_run['losses']} "
        f"({mesh_run['wall']:.2f} s, steps {mesh_run['step_ms']} ms, "
        f"{B * S / mesh_run['step_ms'][-1] * 1e3:.1f} tokens/s at the last, "
        f"peak {mesh_run['peak']} B): max |gap| {gap:.3e} (tolerance "
        f"{MESH_TOL}); state after {steps} steps against no mesh's, the "
        f"largest relative gap of a leaf's measure: parameters' sums of "
        f"|x| {pgap:.3e}, int8 moments' dequantised norms {mgap:.3e} "
        f"(tolerance {STATE_TOL} each; widest: "
        f"{widest_gaps(mesh_run['sums'], one['sums'], names)}); flash "
        f"launches {flash_a} (no attention layer)")
    if not gap <= MESH_TOL:
        raise AssertionError(f"mesh families (a): losses {mesh_run['losses']}"
                             f" vs {one['losses']}")
    if not (pgap <= STATE_TOL and mgap <= STATE_TOL):
        raise AssertionError(f"mesh families (a): state gap {pgap}, {mgap}")

    mesh = make_mesh((2, 2), axes, MESH_STACK)
    lm = LM(cfg)
    opt = AdamWConfig(moments_dtype="int8")
    state = steplib.init_train_state(
        lm, torch.Generator(device=dev).manual_seed(0), opt, dev, mesh=mesh)
    # the frozen-update control: the state a step that changes nothing
    # leaves (the one just drawn) must read past the tolerance on both
    fpar, fmom = split_gaps(state_measures(torch, state), one["sums"], names)
    log(f"mesh families (a) frozen-update control: the drawn state against "
        f"the no-mesh run's at step {steps}: largest relative gap, "
        f"parameters {fpar:.3e}, moments {fmom:.3e} (each must exceed "
        f"{STATE_TOL}; the mesh run's {pgap:.3e}, {mgap:.3e})")
    if not (fpar > STATE_TOL and fmom > STATE_TOL):
        raise AssertionError("mesh families (a): an unchanged state reads "
                             f"within {STATE_TOL} of the trained one")
    structs = steplib.train_state_structs(lm, opt)
    st_axes = steplib.train_state_logical_axes(lm, opt)
    held = {}
    for part in ("params", "opt"):
        want = dryrun.tree_bytes_per_device(getattr(structs, part),
                                            getattr(st_axes, part), mesh,
                                            TRAIN_RULES)
        held[part] = spmd.bytes_per_position(getattr(state, part))
        if held[part] != [want] * mesh.size:
            raise AssertionError(f"mesh families (a): {part} bytes a "
                                 f"position {held[part]} != dry-run's {want}")
    log(f"mesh families (a) bytes a position holds (= dryrun."
        f"tree_bytes_per_device for {cfg.name}, (2, 2), TRAIN_RULES, int8 "
        f"moments): params {held['params'][0]} B, moments {held['opt'][0]} "
        f"B; whole params "
        f"{sum(int(np.prod(s.shape)) * 2 for s in flatten(structs.params)[0])}"
        f" B")
    step_fn = steplib.make_train_step(lm, opt, microbatches=MB, mesh=mesh)
    data = SyntheticPacked(cfg.vocab_size, S, B)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                next(data).items()}]
    torch.cuda.reset_peak_memory_stats()
    # the launcher's runs warmed this path and timed its steps: one step,
    # traced (the profiler's records slow its host side)
    state, step_s, traced_s, fams, coll = mesh_step_profile(
        torch, step_fn, state, batches, mesh, f"mesh families (a) step, "
        f"{cfg.name} on (2, 2) stacked", warm_up=False)
    log(f"mesh families (a) traced step: peak device memory "
        f"{torch.cuda.max_memory_allocated()} B; collective bytes by "
        f"position: {coll}")
    del state, batches, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # (b) paligemma-3b and seamless-m4t-medium with their embeddings
    T_all = 1024
    for arch in ("paligemma-3b", "seamless-m4t-medium"):
        bcfg = get_config(arch)
        enc = bcfg.num_encoder_layers > 0
        F, e = bcfg.frontend.num_embeds, bcfg.frontend.embed_dim
        T = T_all if enc else T_all - F
        key = "src_embeds" if enc else "embeds"
        g = torch.Generator(device=dev).manual_seed(16)
        bdata = SyntheticPacked(bcfg.vocab_size, T, 2)
        bbatches = []
        for _ in range(2):
            b = {k: torch.from_numpy(v).to(dev) for k, v in
                 next(bdata).items()}
            b[key] = torch.randn((2, F, e), generator=g, device=dev).to(
                torch.bfloat16)
            bbatches.append(b)
        bopt = AdamWConfig(moments_dtype="int8")
        # flash a position a step: the decoder's self- (and cross-)
        # attention forward and in remat's recompute, the encoder's once
        per_pos = (2 * bcfg.num_layers * (2 if enc else 1)
                   + bcfg.num_encoder_layers)
        out = {}
        for dtype, shape_m in itertools.product(("bfloat16", "float32"),
                                                (None, (2, 2))):
            blm = LM(dataclasses.replace(bcfg, dtype=dtype))
            bmesh = make_mesh(shape_m, axes, MESH_STACK) if shape_m else None
            n = bmesh.size if bmesh else 1
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            bstate = steplib.init_train_state(
                blm, torch.Generator(device=dev).manual_seed(0), bopt, dev,
                mesh=bmesh)
            fn = steplib.make_train_step(blm, bopt, mesh=bmesh)
            before = ops.launch_counts()["flash_attention"]
            ls = []
            for b in bbatches:
                bstate, m = fn(bstate, b)
                ls.append(float(m["loss"]))
            flash = ops.launch_counts()["flash_attention"] - before
            out[dtype, shape_m] = ls
            log(f"mesh families (b) {bcfg.name} ({bcfg.num_layers} decoder "
                f"layers"
                + (f", {bcfg.num_encoder_layers} encoder" if enc else "") +
                f"), 2 x ({F} embeddings + {T} tokens), {dtype}, int8 "
                f"moments, mesh {shape_m}: losses {ls}; "
                f"{time.perf_counter() - t0:.2f} s "
                f"for the draw and 2 steps, peak "
                f"{torch.cuda.max_memory_allocated()} B; flash launches "
                f"{flash} ({per_pos} a position a step x {n} x 2 steps)")
            if flash != per_pos * n * 2:
                raise AssertionError(f"mesh families (b): {bcfg.name} flash "
                                     f"launched {flash} times")
            del bstate, fn
            gc.collect()
            torch.cuda.empty_cache()
        bgap = worst(abs(a - b) for a, b in zip(
            out["bfloat16", (2, 2)], out["bfloat16", None], strict=True))
        frel = worst(abs(a - b) / abs(b) for a, b in zip(
            out["float32", (2, 2)], out["float32", None], strict=True))
        log(f"mesh families (b) {bcfg.name} (2, 2) against no mesh: bf16 "
            f"max |gap| {bgap:.3e} (tolerance {FAMILY_BF16_TOL}), fp32 max "
            f"relative {frel:.3e} (tolerance {FAMILY_FP32_RTOL})")
        if not (bgap <= FAMILY_BF16_TOL and frel <= FAMILY_FP32_RTOL):
            raise AssertionError(f"mesh families (b): {bcfg.name} {out}")

    # (c) the reduced configs in fp32 on the card against the CPU
    for arch, over in FAMILY_REDUCED:
        rcfg = dataclasses.replace(get_config(arch).reduced(),
                                   dtype="float32", **over)
        rlm = LM(rcfg)
        ropt = AdamWConfig(warmup_steps=1)
        cpu_params = init_lm_params(rcfg, torch.Generator().manual_seed(0),
                                    "cpu")
        rdata = SyntheticPacked(rcfg.vocab_size, 32, 4)
        rng = np.random.default_rng(0)
        rbatches = []
        for _ in range(2):
            b = {k: torch.from_numpy(v) for k, v in next(rdata).items()}
            if rcfg.frontend.kind != "none":
                b["src_embeds" if rcfg.num_encoder_layers else "embeds"] = \
                    torch.from_numpy(rng.standard_normal(
                        (4, rcfg.frontend.num_embeds,
                         rcfg.frontend.embed_dim)).astype(np.float32))
            rbatches.append(b)
        res = {}
        for where in ("card", "cpu"):
            rmesh = make_mesh((2, 2), axes, MESH_STACK if where == "card"
                              else "cpu")
            rdev = rmesh.devices[0]
            params = params_to(cpu_params, rdev)
            rstate = steplib.place_state(rlm, ropt, steplib.TrainState(
                params, adamw.init_state(params, ropt)), rmesh)
            fn = steplib.make_train_step(rlm, ropt, microbatches=2,
                                         mesh=rmesh)
            ls = []
            for b in rbatches:
                rstate, m = fn(rstate, {k: v.to(rdev) for k, v in b.items()})
                ls.append(float(m["loss"]))
                if len(ls) == 1:    # the first step's gradients: m / (1 - b1)
                    first = [spmd.gather(x).cpu().double() / (1 - ropt.b1)
                             for x in flatten(rstate.opt.m)[0]]
            res[where] = (ls, rstate, first)
        (lc, sc, _), (lp, sp, first) = res["card"], res["cpu"]
        rel = worst(abs(a - b) / abs(b) for a, b in zip(lc, lp, strict=True))
        mom, rest, flat_gap, flat_apart, seen = fp32_states_apart(
            sc, sp, first, ropt)
        log(f"mesh families (c) {rcfg.name} ({rcfg.num_layers} layers) fp32 "
            f"on (2, 2), card vs CPU: losses {lc} vs {lp} (max relative "
            f"{rel:.2e}, tolerance {FAMILY_CPU_RTOL}); after 2 steps the fp32 "
            f"moments max |card - cpu| {mom:.2e} (tolerance 1e-6); params: "
            f"the largest gap past atol 1e-5 + rtol 1e-4 {rest:.2e} (must "
            f"be <= 0) where the first gradient is not within {ADAM_FLAT:g} "
            f"eps of zero; where it is, {flat_apart} elements past it (at "
            f"most {MAX_FLAT}: {seen}), at most {flat_gap:.2e} apart "
            f"(within 2 lr a step, {4 * ropt.lr:.1e})")
        if not (rel <= FAMILY_CPU_RTOL and mom <= 1e-6 and rest <= 0
                and flat_gap <= 4 * ropt.lr and flat_apart <= MAX_FLAT):
            raise AssertionError(f"mesh families (c): {rcfg.name} card != "
                                 f"CPU")
        if arch == "mamba2-2.7b":
            with tempfile.TemporaryDirectory() as ck:
                mgr = CheckpointManager(ck)
                mgr.save(2, sc)
                want = [spmd.gather(x).cpu() for x in flatten(sc)[0]]
                other = make_mesh((1, 2), axes, MESH_STACK[:2])
                on_other = mgr.restore(2, steplib.train_state_logical_axes(
                    rlm, ropt), mesh=other)
                for w, a in zip(want, flatten(on_other)[0], strict=True):
                    if not torch.equal(spmd.gather(a).cpu(), w):
                        raise AssertionError("mesh families (c): a restored "
                                             "leaf differs")
            log(f"mesh families (c) {rcfg.name}: the checkpoint saved on "
                f"(2, 2) restores on (1, 2) to equal leaves ({len(want)} "
                f"leaves)")
        del res, sc, sp
    launches = ops.launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 16 wall: {time.perf_counter() - t_phase:.2f} s")
    return launches


# --------------------------------------------------------------- phase 17

# phase 17 (b): the reduced configs' logits, card against CPU (relative)
SERVE_MESH_CPU_RTOL = 1e-5


def serve_mesh_decode_bytes(cfg, D, M, B):
    """The collective bytes a position counts in one decode step of
    ``cfg`` (weights at ``cfg.dtype``) on a (D, M) mesh under
    ``DECODE_RULES`` with batch B, from the shapes, each at its result's
    size. Where d splits over "data", every norm all-reduces its fp32 sum
    of squares (B, 1) over "data", and every input projection its partial
    sums: an attention layer's q (B, H/M, hd), k and v (B, Hkv/M, hd); a
    cross-attention's q (B, H/M, hd); an SSM layer's z and x (B, d_in/M),
    B and C (B, N) and dt (B, Hs/M); a dense FFN's w_gate and w_up (B,
    d_ff/M); an MoE FFN's fp32 router logits (B, E) and its w_gate and
    w_up products (E/M, cap, f), cap the whole batch's. Over "model",
    where they split, the output projections' partials (B, d/D): wo, cwo,
    out_proj (after the gated norm's fp32 sum of squares), w_down, the
    experts' fp32 combine. Over the grid each attention's (self and
    cross) softmax's fp32 max and weight sums (B, Hkv, G, 1) and outputs
    (B, Hkv, G, hd); it all-gathers over "model" each attention's q (B, H,
    hd) and the new k and v (B, Hkv, hd), and an SSM layer whose channels
    split but heads do not its conv outputs (B, d_in). The head
    all-reduces the embedding (B, d/D) over "model", the final norm's sum
    of squares, the logits' partials (B, V/M) over "data", and all-gathers
    the logits (B, V) over "model". A frontend's embeddings and an
    encoder's frames are in the caches already: the step moves none."""
    import math
    from repro_torch.models.blocks import make_layer_spec
    from repro_torch.models.common import dtype_of
    from repro_torch.models.moe import expert_parallelism
    e = dtype_of(cfg.dtype).itemsize
    d, V = cfg.d_model, cfg.vocab_size
    sd = D > 1 and d % D == 0
    dp = d // D if sd else d

    def per(n):                     # a dim's piece over "model"
        return n // M if M > 1 and n % M == 0 else n

    def data(n):                    # partial sums over "data"
        return n if sd else 0

    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // max(Hkv, 1)

    def attention(kv):              # q (and k, v): (all-reduce, all-gather)
        red = data(B * 4 + B * per(H) * hd * e + kv * B * per(Hkv) * hd * e)
        if D * M > 1:
            red += 2 * B * Hkv * G * 4 + B * Hkv * G * hd * 4
        if per(H) == H:
            return red, 0
        return red + B * dp * e, B * H * hd * e

    ar = ag = 0
    for i in range(cfg.num_layers):
        spec = make_layer_spec(cfg, i)
        if spec.mixer == "attn":
            r, g = attention(2)
            ar, ag = ar + r, ag + g
            if per(Hkv) != Hkv:
                ag += 2 * B * Hkv * hd * e
        else:
            s = cfg.ssm
            d_in = s.expand * d
            Hs = d_in // s.head_dim
            ar += data(B * 4 + 2 * B * per(d_in) * e + 2 * B * s.state_dim
                       * e + B * per(Hs) * e)
            if per(d_in) != d_in:
                ar += B * 4 + B * dp * e
                if per(Hs) == Hs:
                    ag += B * d_in * e
        if spec.has_cross:
            r, g = attention(0)
            ar, ag = ar + r, ag + g
        if spec.ffn == "dense":
            f = cfg.d_ff
            ar += data(B * 4 + 2 * B * per(f) * e)
            if per(f) != f:
                ar += B * dp * e
        elif spec.ffn == "moe":
            m = cfg.moe
            E, f = m.num_experts, m.expert_d_ff or cfg.d_ff
            ep = expert_parallelism(E, M)
            el = E // M if ep == M and M > 1 else E
            cap = max(math.ceil(B * m.top_k / (el * ep)
                                * m.capacity_factor), 1)
            ar += data(B * 4 + B * E * 4 + 2 * el * cap * f * e)
            if el != E:
                ar += B * dp * 4
    if per(V) != V:
        ar += B * dp * e
        ag += B * V * e
    ar += data(B * 4 + B * per(V) * e)
    return {"all-reduce": ar, "all-gather": ag, "reduce-scatter": 0}


def route_records(torch, moe):
    """A wrapper of ``moe.route_logits`` (every routing: the prefill's and
    the serving mesh's decode) and the list it appends each call's record
    to: its dropped assignments, each token's top-k experts in order, and
    the router's margin between the k-th and the (k+1)-th logit."""
    seen = []
    route = moe.route_logits

    def recording(logits, mcfg, *a, **kw):
        r = route(logits, mcfg, *a, **kw)
        v = logits.topk(mcfg.top_k + 1, dim=-1).values
        seen.append(((~r.keep).sum(), r.top_idx.sort(dim=-1).values,
                     v[:, -2] - v[:, -1]))
        return r
    return recording, seen


def routed_agree(torch, want, got, rec_want, rec_got, n_moe, mesh, B,
                 prefill_rows, label, tol, tie):
    """``streams_agree`` for an MoE, row by row, up to each row's first
    routing that differs: where a token's top-k experts differ between
    no mesh (``rec_want``, ``route_records``; a prefill of
    ``prefill_rows`` rows at a time, or all) and the mesh (``rec_got``:
    a data row's prefill on its positions, the decode's batch on every
    position), the row's logits past it are not held, and the router's
    k-th margin there must be a near tie (at most ``tie`` on one side).
    Returns (worst relative gap, divergences as ``streams_agree``'s,
    the stream entries held a row, the first routing that differs a row
    as (MoE layer, token, margins))."""
    P, M = mesh.size, mesh.shape["model"]
    D = P // M
    G = B // (prefill_rows or B)
    S = rec_got[0][1].shape[0] // (B // D)

    def sides(t, i):
        """Each side's (top-k, margins) of MoE layer i at stream entry t
        (0 the prefill, rows' tokens in order; t the decode step t-1)."""
        if t == 0:
            w = [rec_want[g * n_moe + i] for g in range(G)]
            m = [rec_got[i * P + g * M] for g in range(D)]
        else:
            w = [rec_want[G * n_moe + (t - 1) * n_moe + i]]
            m = [rec_got[P * n_moe + ((t - 1) * n_moe + i) * P]]
        return [(torch.cat([r[1] for r in x]), torch.cat([r[2] for r in x]))
                for x in (w, m)]

    held, first = [len(want)] * B, [None] * B
    for t in range(len(want)):
        tok = S if t == 0 else 1
        for i in range(n_moe):
            (tw, mw), (tg, mg) = sides(t, i)
            diff = (tw != tg).any(dim=-1).reshape(B, tok)
            for b in range(B):
                if held[b] <= t or not diff[b].any():
                    continue
                j = int(diff[b].nonzero()[0])
                m = (float(mw[b * tok + j]), float(mg[b * tok + j]))
                held[b], first[b] = t, (i, j, m)
                if min(m) > tie:
                    raise AssertionError(f"{label}: row {b} routes token {j}"
                                         f" of stream entry {t} at MoE layer "
                                         f"{i} apart with router margins {m}")
    worst, divs = 0.0, []
    for b in range(B):
        if held[b]:
            rel, d = streams_agree(torch, [w[b:b + 1] for w in want[:held[b]]],
                                   [g[b:b + 1] for g in got[:held[b]]],
                                   f"{label} row {b}", tol, DIVERGENCE_TIE)
            worst = max(worst, rel)
            divs += [(b,) + x[1:] for x in d]
    return worst, divs, held, first


def greedy_run(torch, lm, params, toks, cap, steps, mesh=None,
               prefill_rows=None, extra=None, offset=0):
    """``lm.prefill`` of ``toks`` (B, S) at ``cap``, then ``steps`` greedy
    ``decode_step``s; on ``mesh``, the prefill's caches moved to the
    decode layout between the two (``LM.caches_for_decode``, outside the
    timed decode); with ``prefill_rows`` (no mesh), each ``prefill_rows``
    rows prefilled on their own (as a data row of a mesh prefills them:
    an MoE's capacity counts their tokens), their caches joined, and the
    batch decoded whole. ``extra``: the prefill's other inputs (a
    frontend's ``embeds`` or an encoder's ``src_embeds``, (B, F, e));
    ``offset``: the positions ahead of the tokens (a frontend's F), which
    the decode's ``cache_len`` counts. Returns each step's logits in fp32
    (the prefill's first; position 0's on a mesh), the prefill's flash
    launches, its caches' bytes a position (on a mesh), the walls, and
    the caches."""
    from repro_torch.distributed import spmd
    from repro_torch.kernels import ops
    S = toks.shape[1]
    extra = extra or {}
    sync = torch.cuda.synchronize
    sync()
    before = ops.launch_counts()["flash_attention"]
    spmd.reset_collective_bytes()
    t0 = time.perf_counter()
    if prefill_rows:
        parts = [lm.prefill(params, {k: t[i:i + prefill_rows] for k, t in
                                     dict(extra, tokens=toks).items()}, cap)
                 for i in range(0, toks.shape[0], prefill_rows)]
        logits = torch.cat([z for z, _ in parts])
        caches = [{k: torch.cat([p[1][i][k] for p in parts])
                   for k in layer} for i, layer in enumerate(parts[0][1])]
        del parts
    else:
        logits, caches = lm.prefill(params, dict(extra, tokens=toks), cap,
                                    mesh=mesh)
    sync()
    res = dict(prefill_s=time.perf_counter() - t0,
               flash=ops.launch_counts()["flash_attention"] - before)
    if mesh is not None:
        res["prefill_coll"] = [spmd.collective_bytes(r)
                               for r in range(mesh.size)]
        logits = same_everywhere(torch, logits, mesh)
        res["prefill_cache_bytes"] = spmd.bytes_per_position(caches)
        spmd.reset_collective_bytes()
        t0 = time.perf_counter()
        caches = lm.caches_for_decode(caches)
        sync()
        res["relayout_s"] = time.perf_counter() - t0
        res["moved"] = [spmd.moved_bytes(r) for r in range(mesh.size)]
        res["decode_cache_bytes"] = spmd.bytes_per_position(caches)
    out = [logits.float()]
    tok = out[-1].argmax(-1)
    t0 = time.perf_counter()
    for i in range(steps):
        z, caches = lm.decode_step(params, caches, {
            "token": tok, "cache_len": offset + S + i}, mesh=mesh)
        out.append((same_everywhere(torch, z, mesh) if mesh is not None
                    else z).float())
        tok = out[-1].argmax(-1)
    sync()
    res.update(step_s=(time.perf_counter() - t0) / steps, logits=out,
               caches=caches)
    return res


def meta_serve_collectives(cfg, mesh, B, plen, cap):
    """The collective bytes a position that ``serve_mesh_full``'s prefill
    (B prompts of ``plen`` tokens at capacity ``cap``, ``PREFILL_RULES``)
    and one decode step (``DECODE_RULES``) count, from the dry-run's run
    of the same steps over meta positions of ``mesh``'s axes
    (``launch/dryrun.py::count_collectives``): {"prefill": [...],
    "decode": [...], "count_s": seconds}."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed.sharding import DECODE_RULES, PREFILL_RULES
    from repro_torch.launch import dryrun
    from repro_torch.models.api import make_step_bundle
    pre = make_step_bundle(cfg, ShapeConfig("prefill", plen, B, "prefill"))
    pre.static_meta["capacity"] = cap
    dec = make_step_bundle(cfg, ShapeConfig("decode", cap, B, "decode"))
    counts = [dryrun.count_collectives(b, cfg, mesh, rules)
              for b, rules in ((pre, PREFILL_RULES), (dec, DECODE_RULES))]
    return {"prefill": counts[0]["per_position"],
            "decode": counts[1]["per_position"],
            "count_s": sum(c["count_s"] for c in counts)}


def same_everywhere(torch, zs, mesh):
    """Position 0's logits of a mesh step; on a multi-pod mesh, which
    computes the same step in every pod, every position's first, held
    equal to it bit for bit."""
    if "pod" in mesh.shape:
        for r, z in enumerate(zs):
            if not torch.equal(z, zs[0]):
                raise AssertionError(f"position {r}'s logits differ from "
                                     f"position 0's")
    return zs[0]


def streams_agree(torch, want, got, label, tol=CONTINUITY_TOL,
                  tie=DIVERGENCE_TIE):
    """``got``'s greedy steps against ``want``'s, row by row: each step's
    logits within ``tol`` of the largest |logit| up to the row's first
    divergence (past it the two decode other tokens), and a divergence
    only where not both top-2 margins exceed ``tie``. Returns (worst
    relative gap, divergences as (row, step, margin want, margin
    got))."""
    B = want[0].shape[0]
    worst_rel, divs = 0.0, []
    for b in range(B):
        for t, (w, g) in enumerate(zip(want, got)):
            gap = (w[b] - g[b]).abs().max().item()
            rel = gap / w[b].abs().max().item()
            worst_rel = max(worst_rel, rel) if np.isfinite(rel) else rel
            if not np.isfinite(rel) or rel > tol:
                raise AssertionError(f"{label}: row {b} step {t}: max "
                                     f"|dlogit| {gap} is {rel:.4f} of the "
                                     f"largest logit")
            if w[b].argmax() != g[b].argmax():
                m = [(x[b].topk(2).values[0] - x[b].topk(2).values[1]).item()
                     for x in (w, g)]
                divs.append((b, t, m[0], m[1]))
                if min(m) > tie:
                    raise AssertionError(f"{label}: row {b} parts at step "
                                         f"{t} with top-2 margins {m}")
                break
    return worst_rel, divs


def floor_hold(torch, want, exact, label):
    """The hold ``serve_mesh_full(..., floor=...)`` widens to: ``want``
    (no mesh, in the config's dtype) against ``exact`` (the same model and
    prompts with no mesh in fp32) gives the noise floor of the dtype
    itself, the worst relative gap up to each row's first divergence and
    the widest top-2 margin where they part; returns (twice the gap, at
    least ``CONTINUITY_TOL``; twice that margin, at least
    ``DIVERGENCE_TIE``): the mesh may stand as far from no mesh as two
    runs each as far from fp32."""
    rel, divs = streams_agree(torch, exact, want, label, np.inf, np.inf)
    widest = max((min(a, c) for _, _, a, c in divs), default=0.0)
    tol = max(CONTINUITY_TOL, 2 * rel)
    tie = max(DIVERGENCE_TIE, 2 * widest)
    log(f"{label}: noise floor, no mesh against the same in fp32: logits "
        f"within {rel:.4e} of the largest |logit| up to each row's first "
        f"divergence, divergences (row, step, margin fp32, margin) {divs}; "
        f"the mesh is held within {tol:.4e}, near ties up to {tie:.4e}")
    return tol, tie


def serve_mesh_full(torch, devices, label, arch="llama3-8b", layers=None,
                    tag="serve mesh (a)", dtype=None, floor=None,
                    detail=True, steps=32, tol=CONTINUITY_TOL,
                    prefill_rows=None, capacity_factor=None,
                    routed=False, mesh_shape=(2, 2), meta=None):
    """Phase 17 (a): llama3-8b at full width and depth, seeded bf16
    weights (``init_lm_params``, seed 0, as phase 5 draws them), placed on
    a (2, 2) mesh over ``devices`` beside a copy with no mesh; 4 prompts
    of 1,016 tokens (numpy seed 13: the first 4 of phase 13's decode
    prompts) prefilled at capacity 4,096 under ``PREFILL_RULES``, the
    caches moved to ``DECODE_RULES``, then 32 greedy decode steps, held to
    the same with no mesh (``streams_agree``); bytes a position against
    the dry-run, flash launched once an attention layer a position in the
    prefill, then one traced decode step (busy share, top operations,
    collective bytes a position against ``serve_mesh_decode_bytes``) and
    one under ``FlopCounterMode`` for the roofline's terms. Phase 18 runs
    it for ``arch`` at ``layers`` of its layers (all by default), in
    ``dtype`` (the config's by default), for ``steps`` decode steps, and
    for an MoE config counts and prints each side's dropped assignments;
    phase 19 for a frontend config (its 256 image embeddings, numpy seed
    13 after the tokens, ahead of 760 tokens: 1,016 positions) and an
    encoder-decoder (1,016 tokens over 1,024 source frames), flash
    counted in every self-, encoder and cross-attention layer.
    ``floor``: the no-mesh fp32 logits of the same prompts (which
    ``detail=False`` returns), against which ``floor_hold`` widens the
    hold. ``detail=False`` stops after the logits check (no traced step,
    no roofline). ``tol``: the hold without ``floor``.
    ``prefill_rows``: the no-mesh side prefills a data row's prompts at a
    time and decodes the batch whole (``greedy_run``), as the mesh
    reckons an MoE's capacity. ``capacity_factor``: the MoE's, in place
    of the config's; at E / top_k or more no expert can drop a token, and
    a drop on either side fails. ``tol=None``: the logits' gap is
    reported, not held. ``routed``: an MoE held row by row up to its
    first token routed to other experts (``routed_agree``).
    ``mesh_shape``: (P, D, M) puts the positions on the multi-pod mesh
    (phase 20): every position's logits then equal bit for bit, and the
    prefill's and a decode step's collective bytes a position equal the
    dry-run's count of the same steps on meta positions
    (``meta_serve_collectives``; ``meta``: that count, made
    beforehand)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import DECODE_RULES, PREFILL_RULES
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.inspect_hlo import top_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import specs_logical_axes, specs_to_structs
    from repro_torch.models import moe
    from repro_torch.models.lm import LM
    from repro_torch.models.params import init_lm_params
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    lm = LM(cfg)
    B, plen, cap = 4, 1016, 4096
    for d in sorted(set(devices)):
        torch.cuda.reset_peak_memory_stats(d)
    F = cfg.frontend.num_embeds if cfg.frontend.kind != "none" else 0
    key = "src_embeds" if lm.enc_program else "embeds"
    off = F if F and key == "embeds" else 0       # positions ahead of tokens
    rng = np.random.default_rng(13)
    toks = torch.from_numpy(np.stack([
        rng.integers(1, cfg.vocab_size, plen - off) for _ in range(B)])
    ).long().cuda()
    extra = ({key: torch.from_numpy(rng.standard_normal(
        (B, F, cfg.frontend.embed_dim)).astype(np.float32)).cuda()}
        if F else {})
    params = init_lm_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda")
    mesh = make_mesh(mesh_shape, ("pod", "data", "model")[-len(mesh_shape):],
                     list(devices))
    pod = "pod" in mesh.shape
    t0 = time.perf_counter()
    placed = spmd.place_tree(params, lm.param_axes(), mesh, PREFILL_RULES)
    place_s = time.perf_counter() - t0
    held = spmd.bytes_per_position(placed)
    specs = lm.cache_specs(B, cap, F if key == "src_embeds" else 0)
    want = {}
    for name, rules in (("prefill", PREFILL_RULES), ("decode", DECODE_RULES)):
        want[name] = (dryrun.tree_bytes_per_device(
            lm.param_structs(), lm.param_axes(), mesh, rules),
            dryrun.tree_bytes_per_device(specs_to_structs(specs),
                                         specs_logical_axes(specs), mesh,
                                         rules))
    drops, runs, recs = {}, {}, {}
    for side, p, m in (("no mesh", params, None), ("mesh", placed, mesh)):
        recording, seen = route_records(torch, moe)
        orig, moe.route_logits = moe.route_logits, recording
        try:
            res = greedy_run(torch, lm, p, toks, cap, steps, m,
                             None if m is not None else prefill_rows,
                             extra, off)
        finally:
            moe.route_logits = orig
        n_pre = sum(map(cfg.layer_is_moe, range(cfg.num_layers))) * (
            mesh.size if m is not None else B // (prefill_rows or B))
        # every position of a data row routes its tokens alike, and every
        # position routes the decode's batch: each routing counted once
        pre, dec = (mesh.shape["model"], mesh.size) if m is not None \
            else (1, 1)
        drops[side] = (sum(int(x[0]) for x in seen[:n_pre]) // pre,
                       sum(int(x[0]) for x in seen[n_pre:]) // dec)
        runs[side], recs[side] = res, seen
    one, got = runs.pop("no mesh"), runs.pop("mesh")
    log(f"{tag} {label}: bytes a position: weights {held} (dry-run "
        f"{want['prefill'][0]:.0f} under PREFILL_RULES, "
        f"{want['decode'][0]:.0f} under DECODE_RULES), caches "
        f"{got['prefill_cache_bytes']} after the prefill (dry-run "
        f"{want['prefill'][1]:.0f}), {got['decode_cache_bytes']} after the "
        f"move to the decode layout (dry-run {want['decode'][1]:.0f}), "
        f"which copied {got['moved']} B a position in "
        f"{got['relayout_s'] * 1e3:.1f} ms; weights placed in {place_s:.2f} s")
    n = mesh.size
    if not (held == [want["prefill"][0]] * n == [want["decode"][0]] * n
            and got["prefill_cache_bytes"] == [want["prefill"][1]] * n
            and got["decode_cache_bytes"] == [want["decode"][1]] * n):
        raise AssertionError(f"{tag} {label}: bytes a position "
                             f"differ from the dry-run's")
    # every self-, encoder and cross-attention layer launches flash once
    n_attn = (sum(sp.mixer == "attn" for sp in lm.specs) + len(lm.enc_specs)
              + sum(sp.has_cross for sp in lm.specs))
    n_flash = n_attn * mesh.size
    log(f"{tag} {label}: flash launches in the prefill {got['flash']}"
        f" ({n_attn} attention layers (self, encoder, cross) x {mesh.size} "
        f"positions = {n_flash}); no mesh {one['flash']}")
    if got["flash"] != n_flash or one["flash"] != n_attn * (
            B // (prefill_rows or B)):
        raise AssertionError(f"{tag} {label}: flash launched "
                             f"{got['flash']} times, not {n_flash}")
    if pod and meta is None:
        meta = meta_serve_collectives(cfg, mesh, B, plen, cap)
    if pod:
        log(f"{tag} {label}: the prefill's collective bytes a position "
            f"{got['prefill_coll'][0]} (the dry-run's meta count "
            f"{meta['prefill'][0]}, in {meta['count_s']:.2f} s for both "
            f"steps); every position's logits equal bit for bit, both pods' "
            f"alike, in the prefill and each of the {steps} steps")
        if got["prefill_coll"] != meta["prefill"]:
            raise AssertionError(f"{tag} {label}: prefill collective bytes "
                                 f"{got['prefill_coll']} differ from the "
                                 f"meta count {meta['prefill']}")
    if cfg.moe is not None:
        if cfg.moe.capacity_factor * cfg.moe.top_k >= cfg.moe.num_experts \
                and any(sum(d) for d in drops.values()):
            raise AssertionError(f"{tag} {label}: an expert dropped a "
                                 f"token at capacity factor "
                                 f"{cfg.moe.capacity_factor}: {drops}")
        alike = ", as the no-mesh side does" if prefill_rows else ""
        log(f"{tag} {label}: dropped expert assignments (prefill, decode; "
            f"each routing once): no mesh {drops['no mesh']}, mesh "
            f"{drops['mesh']} (the mesh prefill's capacity counts a data "
            f"row's tokens{alike}; capacity factor "
            f"{cfg.moe.capacity_factor})")
    tie = DIVERGENCE_TIE
    if floor is not None:
        tol, tie = floor_hold(torch, one["logits"], floor, f"{tag} {label}")
    hold = (f"tolerance {tol:.4e}, near ties up to {tie:.4e}"
            if tol is not None else "reported, not held")
    if tol is None:
        tol, tie = np.inf, np.inf
    if routed:
        n_moe = sum(map(cfg.layer_is_moe, range(cfg.num_layers)))
        rel, divs, held, first = routed_agree(
            torch, one["logits"], got["logits"], recs["no mesh"],
            recs["mesh"], n_moe, mesh, B, prefill_rows, f"{tag} {label}",
            tol, DIVERGENCE_TIE)
        log(f"{tag} {label}: stream entries held a row (up to its first "
            f"routing that differs; {steps + 1} in all) {held}; first "
            f"routings that differ (MoE layer, token, router k-th margins "
            f"no mesh, mesh) {first}")
    else:
        rel, divs = streams_agree(torch, one["logits"], got["logits"],
                                  f"{tag} {label}", tol, tie)
    del recs
    log(f"{tag} {label}: {steps} greedy steps against no mesh: "
        f"logits within {rel:.4e} of the largest |logit| up to each row's "
        f"first divergence ({hold}); divergences (row, step, margin no "
        f"mesh, margin mesh): {divs}")
    log(f"{tag} {label}: prefill of {B} x {plen} positions "
        f"{got['prefill_s'] * 1e3:.1f} ms on the mesh, "
        f"{one['prefill_s'] * 1e3:.1f} ms with no mesh; decode "
        f"{got['step_s'] * 1e3:.1f} ms a step on the mesh, "
        f"{one['step_s'] * 1e3:.1f} ms with no mesh (mean of {steps}); the "
        f"positions run from one host thread: no wall here is a speed-up")
    if not detail:
        no_mesh = one["logits"]
        del params, placed, one, got
        gc.collect()
        torch.cuda.empty_cache()
        return dict(rel=rel, divs=divs, drops=drops, no_mesh=no_mesh)
    caches = got["caches"]
    tok = got["logits"][-1].argmax(-1)
    del one, got["logits"]
    gc.collect()
    # one traced decode step and one counted, past the compared ones
    spmd.reset_collective_bytes()
    with device_profile(torch) as prof:
        t0 = time.perf_counter()
        z, caches = lm.decode_step(placed, caches, {
            "token": tok, "cache_len": plen + steps}, mesh=mesh)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    coll = [spmd.collective_bytes(r) for r in range(mesh.size)]
    pred = (meta["decode"] if pod else
            [serve_mesh_decode_bytes(cfg, mesh.shape["data"],
                                     mesh.shape["model"], B)] * mesh.size)
    rows = top_ops(prof, mesh.devices[0])
    busy = sum(ms for ms, _ in rows.values())
    tops = sorted(rows.items(), key=lambda kv: -kv[1][0])[:6]
    with FlopCounterMode(display=False) as fc:
        lm.decode_step(placed, caches, {"token": z[0].argmax(-1),
                                        "cache_len": plen + steps + 1},
                       mesh=mesh)
    flops = float(fc.get_total_flops()) / mesh.size
    shape = ShapeConfig("mesh_decode", plen + steps, B, "decode")
    mem = roofline.analytic_memory_bytes(
        cfg, shape, weights_local=held[0], opt_local=0,
        cache_local=want["decode"][1], data_shards=1, model_shards=2,
        fsdp_shards=2)
    terms = roofline.roofline_terms(flops, mem["total"],
                                    sum(coll[0].values()))
    peaks = [torch.cuda.max_memory_allocated(d) for d in sorted(set(devices))]
    log(f"{tag} {label}: a traced decode step {traced_s * 1e3:.1f} "
        f"ms of wall, device busy {busy:.1f} ms ({busy / (traced_s * 1e3):.3f}"
        f" of wall); top device operations (ms, calls): "
        + "; ".join(f"{n[:60]} {ms:.2f} ({c})" for n, (ms, c) in tops))
    log(f"{tag} {label}: collective bytes a position a decode step "
        f"{coll[0]} (" + ("the dry-run's meta count" if pod else
                          "predicted from the shapes") + f" {pred[0]}; "
        f"equal at all {mesh.size} positions); roofline a position: "
        f"FLOPs {flops:.4e}, bytes {mem['total']:.4e}, compute "
        f"{terms['compute_s'] * 1e3:.4f} ms, memory "
        f"{terms['memory_s'] * 1e3:.4f} ms, collective "
        f"{terms['collective_s'] * 1e3:.4f} ms ({terms['bottleneck']}); "
        f"peak memory {peaks} B (the no-mesh copy and its caches included)")
    if coll != pred:
        raise AssertionError(f"{tag} {label}: collective bytes "
                             f"{coll} differ from the prediction {pred}")
    del params, placed, caches
    gc.collect()
    torch.cuda.empty_cache()
    return dict(traced_s=traced_s, busy_ms=busy, coll=coll[0], peaks=peaks,
                terms=terms, drops=drops)


# phase 17 (b)'s reduced configs, meshes and capacities
SERVE_MESH_REDUCED = tuple((arch, over, shape, 64)
                           for arch, over in (("llama3-8b", {}),
                                              ("gemma3-1b", {"num_layers": 6}))
                           for shape in ((2, 2), (1, 4), (4, 1)))
# phase 18 (c)'s: the cases of tests/test_torch_mesh_serve_families.py
SERVE_FAMILIES_REDUCED = (
    ("qwen3-moe-30b-a3b", {}, (2, 2), 64),
    ("qwen3-moe-30b-a3b", {}, (1, 4), 64),
    ("mamba2-2.7b", {}, (2, 2), 64),
    ("mamba2-2.7b", {"ssm": dict(expand=3, head_dim=64)}, (1, 2), 64),
    ("jamba-1.5-large-398b", {"num_layers": 8}, (2, 2), 62))
# phase 19 (c)'s: the cases of tests/test_torch_mesh_serve_encdec.py
SERVE_ENCDEC_REDUCED = tuple(
    (arch, {}, shape, 64) for arch in ("paligemma-3b", "seamless-m4t-medium")
    for shape in ((2, 2), (1, 4), (4, 1))) + (
    ("seamless-m4t-medium", {"frontend": dict(num_embeds=6)}, (2, 2), 64),)


def serve_mesh_reduced(torch, cases=SERVE_MESH_REDUCED,
                       tag="serve mesh (b)"):
    """Phase 17 (b): the reduced llama3-8b and gemma3-1b (6 layers, five
    local with 32-token rings, one global) in fp32 on (2, 2), (1, 4) and
    (4, 1) stacked on the card against the same on the CPU: prefill of 4 x
    28 tokens at capacity 64, the move to the decode layout, 6 decode
    steps on fixed tokens (slots 28-33, across a piece boundary and round
    the rings), every step's logits within ``SERVE_MESH_CPU_RTOL`` of the
    largest |logit| and every position's equal. Phase 18 (c) runs
    ``SERVE_FAMILIES_REDUCED`` (arch, config overrides, mesh, capacity)
    alike, and phase 19 (c) ``SERVE_ENCDEC_REDUCED``: a frontend's 8
    embeddings (numpy seed 0) ahead of 20 tokens, or an encoder's 8 (or
    6) source frames under 28, so that the decode writes slots 28-33
    alike."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import PREFILL_RULES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import LM
    from repro_torch.models.params import init_lm_params
    for arch, over, shape, cap in cases:
        base = get_config(arch).reduced()
        over = dict(over)
        for sub in ("ssm", "frontend"):
            if sub in over:
                over[sub] = dataclasses.replace(getattr(base, sub),
                                                **over[sub])
        cfg = dataclasses.replace(base, dtype="float32", **over)
        lm = LM(cfg)
        params = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 34))).long()
        batch, plen, note = {}, 28, ""
        if cfg.frontend.kind != "none":
            key = "src_embeds" if lm.enc_program else "embeds"
            F, e = cfg.frontend.num_embeds, cfg.frontend.embed_dim
            batch[key] = torch.from_numpy(np.random.default_rng(0)
                                          .standard_normal((4, F, e))
                                          .astype(np.float32))
            plen -= F if key == "embeds" else 0
            note = f" with {F} {key}"
        batch["tokens"] = toks[:, :plen]
        runs = []
        for where in ("cpu", "cuda"):
            mesh = make_mesh(shape, ("data", "model"),
                             [where] * (shape[0] * shape[1]))
            placed = spmd.place_tree(params, lm.param_axes(), mesh,
                                     PREFILL_RULES)
            z, caches = lm.prefill(placed, {k: t.to(where) for k, t in
                                            batch.items()}, cap, mesh=mesh)
            caches = lm.caches_for_decode(caches)
            out = [z]
            for i in range(6):
                z, caches = lm.decode_step(placed, caches, {
                    "token": toks[:, plen + i].to(where),
                    "cache_len": 28 + i}, mesh=mesh)
                out.append(z)
            for step in out:
                if any(not torch.equal(t, step[0]) for t in step[1:]):
                    raise AssertionError(f"{tag} {cfg.name} {shape}: "
                                         f"positions' logits differ")
            runs.append([step[0].cpu() for step in out])
        rel = max(((a - b).abs().max() / a.abs().max()).item()
                  for a, b in zip(*runs))
        log(f"{tag} {cfg.name}{note} fp32 on {shape} stacked at capacity "
            f"{cap}, card vs CPU: prefill and 6 decode steps' logits within "
            f"{rel:.3e} relative (tolerance {SERVE_MESH_CPU_RTOL})")
        if not rel <= SERVE_MESH_CPU_RTOL:
            raise AssertionError(f"{tag}: {cfg.name} {shape} card != CPU "
                                 f"({rel})")


# phase 17 (a)'s depth: 8 of llama3-8b's 32 layers at full width (cut
# from 32 to make room for phase 20, scripts/phase_budget.py)
SERVE_MESH_DEPTH = 8


def serve_mesh_phase(torch):
    """Prefill and decode on a (data, model) mesh (cell S12; target 60 s):
    (a) llama3-8b at full width, ``SERVE_MESH_DEPTH`` of its layers, on
    (2, 2) stacked on the card against no mesh (``serve_mesh_full``), (b)
    the reduced fp32 configs on three meshes, card against CPU
    (``serve_mesh_reduced``), (c) (a) over four cards where the machine
    has them. Returns the phase's kernel launches."""
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    serve_mesh_full(torch, MESH_STACK, "stacked", layers=SERVE_MESH_DEPTH)
    log(f"phase 17 (a) wall: {time.perf_counter() - t_phase:.2f} s")
    t0 = time.perf_counter()
    serve_mesh_reduced(torch)
    log(f"phase 17 (b) wall: {time.perf_counter() - t0:.2f} s")
    n = torch.cuda.device_count()
    if n >= 4:
        t0 = time.perf_counter()
        serve_mesh_full(torch, [f"cuda:{i}" for i in range(4)],
                        "over four cards", layers=SERVE_MESH_DEPTH)
        log(f"phase 17 (c) wall: {time.perf_counter() - t0:.2f} s")
    else:
        log(f"phase 17 (c) not run: it needs four cards, torch sees {n} "
            f"(scripts/mesh_cards.py --phase 17 runs (a) over four)")
    launches = ops.launch_counts()
    log(f"serve mesh path kernel launches: {launches}")
    log(f"phase 17 wall: {time.perf_counter() - t_phase:.2f} s")
    return launches


# --------------------------------------------------------------- phase 18

# phase 18 (a) in fp32: the logits on the mesh against no mesh, relative
# to the largest |logit| (fp32 rounding over 64 layers; the CPU gives
# below 5e-5 at mamba2's width and 16 layers)
SERVE_FP32_TOL = 1e-3
# phase 18 (b)'s depth: 12 of qwen3-moe-30b-a3b's 48 layers at full width
# (8.1 B parameters, 16.2 GB in bf16): the stacked shards, a no-mesh copy
# and the caches fit one card
SERVE_MOE_DEPTH = 12
# phase 18 (a)'s depth: 16 of mamba2-2.7b's 64 layers at full width (cut
# from 64 to make room for phase 20, scripts/phase_budget.py)
SERVE_SSM_DEPTH = 16


def serve_mesh_families_phase(torch):
    """Prefill and decode of the MoE, SSM and hybrid families on a (data,
    model) mesh (cell S13), four positions stacked on the card, each as
    phase 17 (a) (``serve_mesh_full``). (a) mamba2-2.7b at full width and
    ``SERVE_SSM_DEPTH`` of its 64 layers (tied embeddings; its conv and
    state caches on their channels and heads): first in fp32 for 8 steps,
    held within ``SERVE_FP32_TOL`` of no mesh, then in bf16 for 32, held
    within twice the gap of no mesh in bf16 to no mesh in fp32
    (``floor_hold``). (b) qwen3-moe-30b-a3b at
    full width and ``SERVE_MOE_DEPTH`` layers (flash at each position's 16
    q heads; each side's dropped assignments): at the capacity factor E /
    top_k, where no expert drops a token, in fp32 for 8 steps within
    ``CONTINUITY_TOL`` (a top-k choice at a near tie, which fp32 sums in
    another order can flip, moves a token's output: 2.2e-3 of the
    largest logit with no drop at all), the no-mesh side prefilling a
    data row's prompts at a time (for memory), then in bf16 for 8, held
    as (a); then at the config's capacity for 32
    steps, its logits' gap reported beside each side's drops, not held: a
    capacity-bound MoE is not continuous (in fp32, both sides reckoning
    capacity per data row, their prefills' drops differed by 3 of 390,144
    assignments and one row's logits parted by 0.12 of the largest at
    decode step 6). (c) The reduced qwen3-moe, mamba2 and jamba (one
    8-layer period) in fp32 on the test's meshes, card against CPU
    (``serve_mesh_reduced``). Returns the phase's kernel launches."""
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    exact = serve_mesh_full(torch, MESH_STACK, "stacked", arch="mamba2-2.7b",
                            layers=SERVE_SSM_DEPTH,
                            tag="serve families (a) fp32", dtype="float32",
                            detail=False, steps=8,
                            tol=SERVE_FP32_TOL)["no_mesh"]
    serve_mesh_full(torch, MESH_STACK, "stacked", arch="mamba2-2.7b",
                    layers=SERVE_SSM_DEPTH, tag="serve families (a)",
                    floor=exact)
    log(f"phase 18 (a) wall: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    from repro_torch.configs import get_config
    m = get_config("qwen3-moe-30b-a3b").moe
    moe = dict(arch="qwen3-moe-30b-a3b", layers=SERVE_MOE_DEPTH)
    no_drops = m.num_experts / m.top_k
    serve_mesh_full(torch, MESH_STACK, "stacked",
                    tag="serve families (b) fp32, no drops",
                    dtype="float32", detail=False, steps=8,
                    tol=SERVE_FP32_TOL, prefill_rows=2,
                    capacity_factor=no_drops, routed=True, **moe)
    serve_mesh_full(torch, MESH_STACK, "stacked", tag="serve families (b)",
                    tol=None, **moe)
    log(f"phase 18 (b) wall: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    serve_mesh_reduced(torch, SERVE_FAMILIES_REDUCED, "serve families (c)")
    log(f"phase 18 (c) wall: {time.perf_counter() - t0:.2f} s")
    launches = ops.launch_counts()
    log(f"serve families path kernel launches: {launches}")
    if not launches["flash_attention"]:
        raise AssertionError("phase 18: flash never launched")
    log(f"phase 18 wall: {time.perf_counter() - t_phase:.2f} s")
    return launches


# --------------------------------------------------------------- phase 19

def serve_mesh_encdec_phase(torch):
    """Prefill and decode of the frontend and encoder-decoder families on
    a (data, model) mesh (cell S14), four positions stacked on the card,
    each at full width and depth as phase 17 (a) (``serve_mesh_full``):
    (a) paligemma-3b (256 image embeddings ahead of 760 tokens; one kv
    head of 256, whole on every position), (b) seamless-m4t-medium (12
    encoder and 12 decoder layers; 1,016 tokens over 1,024 source frames,
    the cross caches' frames split over the grid); each first in fp32 for
    8 steps, held within ``SERVE_FP32_TOL`` of no mesh, then in bf16 for
    32, held within ``CONTINUITY_TOL``; (c) the reduced paligemma and
    seamless in fp32 on the test's meshes, card against CPU
    (``serve_mesh_reduced``). Returns the phase's kernel launches."""
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    for part, arch in (("a", "paligemma-3b"), ("b", "seamless-m4t-medium")):
        t0 = time.perf_counter()
        serve_mesh_full(torch, MESH_STACK, "stacked", arch=arch,
                        tag=f"serve encdec ({part}) fp32", dtype="float32",
                        detail=False, steps=8, tol=SERVE_FP32_TOL)
        serve_mesh_full(torch, MESH_STACK, "stacked", arch=arch,
                        tag=f"serve encdec ({part})")
        log(f"phase 19 ({part}) wall: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    serve_mesh_reduced(torch, SERVE_ENCDEC_REDUCED, "serve encdec (c)")
    log(f"phase 19 (c) wall: {time.perf_counter() - t0:.2f} s")
    launches = ops.launch_counts()
    log(f"serve encdec path kernel launches: {launches}")
    if not launches["flash_attention"]:
        raise AssertionError("phase 19: flash never launched")
    log(f"phase 19 wall: {time.perf_counter() - t_phase:.2f} s")
    return launches


# --------------------------------------------------------------- phase 20

# the multi-pod mesh (pod, data, model), all eight positions on the card
POD_SHAPE = (2, 2, 2)
POD_STACK = ["cuda:0"] * 8


def pod_meta_counts():
    """The dry-run's counts over meta positions (no card) that phase 20
    holds its runs to: {(2, 2) and ``POD_SHAPE``: ``count_collectives``
    of a train step on that mesh, "serve": {dtype:
    ``meta_serve_collectives``}}."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.distributed.sharding import (Mesh, TRAIN_RULES,
                                                  sharding_ctx)
    from repro_torch.launch import dryrun
    from repro_torch.models.api import make_step_bundle
    cfg = get_config("gemma3-1b")
    out = {}
    for shape in ((2, 2), POD_SHAPE):
        desc = Mesh(("pod", "data", "model")[-len(shape):], shape)
        with sharding_ctx(desc, TRAIN_RULES):
            bundle = make_step_bundle(cfg, ShapeConfig("pod_train", 1024, 4,
                                                       "train"),
                                      microbatches=1, moments_dtype="int8")
        out[shape] = dryrun.count_collectives(bundle, cfg, desc, TRAIN_RULES)
    desc = Mesh(("pod", "data", "model"), POD_SHAPE)
    out["serve"] = {dtype: meta_serve_collectives(
        dataclasses.replace(cfg, dtype=dtype), desc, 4, 1016, 4096)
        for dtype in ("float32", "bfloat16")}
    return out


def finish(proc, what, timeout=600):
    """``proc``'s (stdout, stderr) once it ends; a non-zero exit fails."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}: "
                             f"{err[-3000:]}")
    return out, err


def pod_train(torch, meta_counts):
    """Phase 20 (a): gemma3-1b at full width and depth trains 3 steps of
    S8's data (``SyntheticPacked`` seed 0, 4 x 1024 in one microbatch:
    one row a (pod, data) position) with int8 moments on (2, 2, 2)
    stacked on the card, against the same with no mesh and on (2, 2):
    losses within ``MESH_TOL``, the state after 3 steps within
    ``STATE_TOL`` a leaf (the drawn state, an unchanged one, must fail
    it), the bytes a position holds equal to the dry-run's, and each
    position's collective bytes in a step equal to the dry-run's count of
    the same step over meta positions (exact; ``meta_counts``:
    ``pod_meta_counts``). Prints each run's step walls, peak memory and
    collective bytes."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticPacked
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import TRAIN_RULES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import LM
    from repro_torch.optimizer.adamw import AdamWConfig
    from repro_torch.training import step as steplib
    cfg = get_config("gemma3-1b")
    lm = LM(cfg)
    B, S, steps = 4, 1024, 3
    opt = AdamWConfig(moments_dtype="int8")
    data = SyntheticPacked(cfg.vocab_size, S, B, seed=0)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in next(data).items()}
               for _ in range(steps)]
    structs = steplib.train_state_structs(lm, opt)
    st_axes = steplib.train_state_logical_axes(lm, opt)
    runs = {}
    for shape in (None, (2, 2), POD_SHAPE):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh = (make_mesh(shape, ("pod", "data", "model")[-len(shape):],
                          POD_STACK[:int(np.prod(shape))]) if shape else None)
        state = steplib.init_train_state(
            lm, torch.Generator(device="cuda").manual_seed(0), opt, "cuda",
            mesh=mesh)
        name = "no mesh" if mesh is None else str(shape)
        if shape == POD_SHAPE:
            drawn = state_measures(torch, state)
        if mesh is not None:
            held = spmd.bytes_per_position(state)
            want = dryrun.tree_bytes_per_device(structs, st_axes, mesh,
                                                TRAIN_RULES)
            if held != [want] * mesh.size:
                raise AssertionError(f"pod (a) {name}: bytes a position "
                                     f"{held} != the dry-run's {want}")
        fn = steplib.make_train_step(lm, opt, mesh=mesh)
        losses, walls = [], []
        for b in batches:
            spmd.reset_collective_bytes()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = fn(state, b)
            losses.append(float(m["loss"]))
            walls.append(time.perf_counter() - t0)
        coll = ([spmd.collective_bytes(r) for r in range(mesh.size)]
                if mesh is not None else None)
        runs[shape] = dict(losses=losses, walls=walls, coll=coll,
                           sums=state_measures(torch, state),
                           peak=torch.cuda.max_memory_allocated(),
                           held=held[0] if mesh is not None else None)
        del state, fn
    base = runs[None]
    frozen = state_gap(drawn, base["sums"])
    names = leaf_names(structs)
    for shape in ((2, 2), POD_SHAPE):
        run = runs[shape]
        meta = meta_counts[shape]
        gap = max(abs(a - b) for a, b in zip(run["losses"], base["losses"]))
        sgap = state_gap(run["sums"], base["sums"])
        log(f"pod (a) gemma3-1b on {shape} stacked ({len(run['coll'])} "
            f"positions) "
            f"against no mesh, {B} x {S} in one microbatch, int8 moments: "
            f"losses {run['losses']} against {base['losses']}: max |gap| "
            f"{gap:.3e} (tolerance {MESH_TOL}); state after {steps} steps: "
            f"largest relative gap of a leaf's measure {sgap:.3e} "
            f"(tolerance {STATE_TOL}; widest "
            f"{widest_gaps(run['sums'], base['sums'], names)}); "
            f"step walls {[round(w * 1e3, 1) for w in run['walls']]} ms "
            f"(no mesh {[round(w * 1e3, 1) for w in base['walls']]} ms); "
            f"peak memory {run['peak']} B (no mesh {base['peak']} B); bytes "
            f"a position {run['held']} B (= dryrun.tree_bytes_per_device)")
        log(f"pod (a) {shape}: collective bytes a position in the last "
            f"step {run['coll'][0]}, the dry-run's meta count of the same "
            f"step {meta['per_position'][0]} ({meta['count_s']:.2f} s on "
            f"{len(run['coll'])} meta positions, before the runs)")
        if not all(np.isfinite(run["losses"])) or gap > MESH_TOL:
            raise AssertionError(f"pod (a) {shape}: losses {run['losses']} "
                                 f"vs {base['losses']}")
        if not sgap <= STATE_TOL:
            raise AssertionError(f"pod (a) {shape}: state gap {sgap}")
        if run["coll"] != meta["per_position"]:
            raise AssertionError(f"pod (a) {shape}: collective bytes "
                                 f"{run['coll']} differ from the meta count "
                                 f"{meta['per_position']}")
    log(f"pod (a) frozen-update control: the drawn state against no mesh's "
        f"after {steps} steps: largest relative gap {frozen:.3e} (must "
        f"exceed {STATE_TOL})")
    if not frozen > STATE_TOL:
        raise AssertionError("pod (a): an unchanged state reads within "
                             f"{STATE_TOL} of the trained one")
    del batches
    gc.collect()
    torch.cuda.empty_cache()


def pod_phase(torch):
    """The multi-pod mesh (cell S15; budget 60 s), its eight positions
    stacked on the card: first (c) ``examples/torch/serve_small_real.py``
    as a user runs it, on the card in a process of its own: exit 0 and
    "lossless ✓", while this process makes the dry-run's meta counts
    (``pod_meta_counts``); then, with nothing beside them, (a) training
    (``pod_train``) and (b) gemma3-1b at full width and depth prefills 4
    x 1,016 tokens (numpy seed 13) at capacity 4,096 under
    ``PREFILL_RULES`` (the batch over the pods and data rows), moves the
    caches to ``DECODE_RULES`` (both pods hold the same four pieces of
    1,024 slots) and decodes greedy steps across the piece boundary, 9
    in fp32 (within ``SERVE_FP32_TOL``; the ninth writes the second
    piece's first slot) and then 16 in bf16 (within ``CONTINUITY_TOL``,
    near-tie flips reported), against no mesh
    (``serve_mesh_full`` with ``mesh_shape``: bytes and collective bytes
    exact; every position's logits equal bit for bit). Returns the
    phase's kernel launches (the example's are its own process's)."""
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    root = Path(__file__).resolve().parent
    example = subprocess.Popen(
        [sys.executable, str(root / "examples" / "torch" /
                             "serve_small_real.py")],
        cwd=root, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        counts = pod_meta_counts()
        log(f"pod: the dry-run's meta counts in "
            f"{time.perf_counter() - t_phase:.2f} s, beside (c)")
        t0 = time.perf_counter()
        out, _ = finish(example, "pod (c) serve_small_real")
    finally:
        if example.poll() is None:
            example.kill()
            example.communicate()
    lines = out.strip().splitlines()
    log(f"pod (c) examples/torch/serve_small_real.py on the card: exit 0, "
        f"waited for {time.perf_counter() - t0:.2f} s after the meta counts; "
        + " | ".join(ln for ln in lines if ln.startswith(("[", "token"))))
    if "lossless ✓" not in out:
        raise AssertionError("pod (c): serve_small_real did not print "
                             "lossless ✓")
    log(f"phase 20 (c) wall: {time.perf_counter() - t_phase:.2f} s")
    t0 = time.perf_counter()
    pod_train(torch, counts)
    log(f"phase 20 (a) wall: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    for dtype, detail, steps, tol in (
            ("float32", False, 9, SERVE_FP32_TOL),
            ("bfloat16", True, 16, CONTINUITY_TOL)):
        serve_mesh_full(torch, POD_STACK, "stacked", arch="gemma3-1b",
                        tag=f"pod (b) {dtype}", dtype=dtype, detail=detail,
                        steps=steps, tol=tol, mesh_shape=POD_SHAPE,
                        meta=counts["serve"][dtype])
    log(f"phase 20 (b) wall: {time.perf_counter() - t0:.2f} s")
    launches = ops.launch_counts()
    log(f"pod path kernel launches: {launches}")
    if not launches["flash_attention"]:
        raise AssertionError("phase 20: flash never launched")
    log(f"phase 20 wall: {time.perf_counter() - t_phase:.2f} s")
    return launches


# the phases ``--phase N`` runs alone (after phases 1 and 2)
ALONE = ("14", "16", "17", "18", "19", "20")


def run_alone(torch, phase):
    """Phase ``phase`` (one of ``ALONE``) on its own, the kernels built;
    returns its kernel launches."""
    from repro_torch.configs import get_config
    cfg = get_config("llama3-8b")
    run = {"14": lambda: tp_phase(torch, cfg, make_prompts(
               cfg, 8, (200, 1001), (32, 65), seed=0)),
           "16": lambda: mesh_families_phase(torch),
           "17": lambda: serve_mesh_phase(torch),
           "18": lambda: serve_mesh_families_phase(torch),
           "19": lambda: serve_mesh_encdec_phase(torch),
           "20": lambda: pod_phase(torch)}
    return run[phase]()


def main(argv) -> int:
    if argv not in ([], ["--timing"]) and not (
            len(argv) == 2 and argv[0] == "--phase" and argv[1] in ALONE):
        log(f"usage: chip_smoke.py [--timing | --phase {{{','.join(ALONE)}}}]")
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
    if argv[:1] == ["--phase"]:          # one phase alone
        torch.cuda.init()
        log(f"phase {argv[1]} kernel launches: {run_alone(torch, argv[1])}")
        return 0
    if argv:                             # --timing: phase 4 alone
        print(json.dumps({"timing": kernel_timing(torch, ops, ref, quant,
                                                  cfg)}), flush=True)
        return 0

    # 3. kernel vs plain
    errs = {}
    kernel_checks(torch, ops, ref, cfg, errs)
    int8_checks(torch, ops, ref, quant, cfg, errs)
    tp_shard_checks(torch, ops, ref, cfg, errs)
    mesh_shard_checks(torch, ops, ref, errs)

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

    # 11. every model family through the LM, at full width where one card
    # holds it
    ops.reset_launch_counts()
    families_phase(torch)
    launches["families"] = ops.launch_counts()
    log(f"families path kernel launches: {launches['families']}")

    # 12. training at full width through the launcher
    launches["train"], train_ref = train_phase(torch)
    log(f"train path kernel launches: {launches['train']}")

    # 13. the launch tooling: audit, roofline, inspector, dry-run
    launches["tooling"], _ = tooling_phase(torch)

    # 14. tensor parallelism: llama3-8b at tp=2 on the card, the reduced
    # matrix on the card against the CPU
    launches["tp"] = tp_phase(torch, cfg, prompts)

    # 15. training on a (data, model) mesh, shards stacked on the card
    launches["mesh"] = mesh_phase(torch, *train_ref)

    # 16. the SSM, hybrid, frontend and encoder-decoder families on a mesh
    launches["mesh_families"] = mesh_families_phase(torch)

    # 17. prefill and decode of a dense decoder on a mesh
    launches["mesh_serve"] = serve_mesh_phase(torch)

    # 18. prefill and decode of the MoE, SSM and hybrid families on a mesh
    launches["mesh_serve_families"] = serve_mesh_families_phase(torch)

    # 19. prefill and decode of the frontend and encoder-decoder families
    # on a mesh
    launches["mesh_serve_encdec"] = serve_mesh_encdec_phase(torch)

    # 20. training, prefill and decode on the multi-pod mesh
    launches["mesh_pod"] = pod_phase(torch)

    sources = {"kv_copy": ("kv_copy.cu", "src/repro/kernels/kv_copy.py:29"),
               "paged_attention": ("paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:84"),
               "paged_attention_int8": ("paged_attention.cu", INT8_REPLACES),
               "flash_attention": ("flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:72")}
    kernels = []
    for name, (src, replaces) in sources.items():
        entry = dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}", replaces=replaces,
            launches=sum(c.get(name, 0) for c in launches.values()),
            max_abs_err=errs[name], **times[name],
            launches_by_phase={phase: c.get(name, 0) for phase, c in
                               (("5_bf16", launches["bf16"]),
                                ("5_int8", launches["int8"]),
                                ("8_server", launches["server"]),
                                ("9_supervisor", launches["supervisor"]),
                                ("10_dense", launches["dense"]),
                                ("11_families", launches["families"]),
                                ("12_train", launches["train"]),
                                ("13_tooling", launches["tooling"]),
                                ("14_tp", launches["tp"]),
                                ("15_mesh", launches["mesh"]),
                                ("16_mesh_families",
                                 launches["mesh_families"]),
                                ("17_mesh_serve", launches["mesh_serve"]),
                                ("18_mesh_serve_families",
                                 launches["mesh_serve_families"]),
                                ("19_mesh_serve_encdec",
                                 launches["mesh_serve_encdec"]),
                                ("20_mesh_pod", launches["mesh_pod"]))})
        for tag, key in (("@B=8", "at_decode_batch_8"),
                         ("@D=256", "at_head_dim_256"),
                         ("@D=256,paligemma", "at_head_dim_256_paligemma"),
                         ("@train", "at_train_shape")):
            if name + tag in times:    # the main paths' other shapes
                entry[key] = times[name + tag]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
