#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device: the card's name and power limit; TF32 off for the fp32 phases;
2. build: nvcc builds the three CUDA kernels from ``src/repro_torch``;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, at llama3-8b's full-width shapes, in bf16 and fp32, edge cases
   included, each within a stated tolerance;
4. timing: each kernel at main-path shapes (CUDA events, median after
   warm-up) beside its bound, its plain version and a library yardstick;
5. serving: llama3-8b at full width in bf16 (random weights from a seeded
   generator) through ``ServingEngine(..., paged_runner=True)``: (a) ample
   HBM, (b) HBM for about two requests, which forces rotation; the
   kernels' launch counts are read from this phase alone;
6. lossless: the same two runs with ``llama3-8b.reduced()`` in fp32 must
   emit equal token streams.

It prints a JSON line of kernel results, then the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. It imports nothing of
JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_S = 3.35e12            # H100 SXM device memory, bytes/s
PEAK_BF16_FLOPS = 989e12          # dense tensor-core rate, FLOP/s
TOL = {"bf16": 2e-2, "fp32": 1e-5}   # atol = rtol: bf16 output rounding
#                                      (the reference kernel tests' bf16
#                                      tolerance); fp32 summation order
ROW_MOVES = ("copy_launches", "d2d_rows", "d2h_rows", "h2d_rows")


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
    """Each kernel against its plain version at llama3-8b's widths."""
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
        del pool
        # flash attention: a 512-token chunk over a 1024-token context at
        # q_offset 300 (!= Skv - Sq), then a 256-token window, tail-aligned
        for off, win in ((300, 0), (None, 256)):
            q = torch.randn((1, 512, H, D), generator=g, device=dev).to(dt)
            k = torch.randn((1, 1024, Hkv, D), generator=g, device=dev).to(dt)
            v = torch.randn((1, 1024, Hkv, D), generator=g, device=dev).to(dt)
            got = ops.flash_attention(q, k, v, causal=True, window=win,
                                      q_offset=off, force="kernel")
            want = ref.flash_attention_ref(q, k, v, causal=True, window=win,
                                           q_offset=off)
            torch.cuda.synchronize()
            check("flash_attention", dname,
                  f"T=512 Skv=1024 q_offset={off} window={win}", got, want,
                  tol, errs)
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4

def kernel_timing(torch, ops, ref, cfg, dev="cuda"):
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
    # paged attention: decode B=32 at context 1024, one layer of the pool
    B, MB, ctx = 32, 64, 1024
    q = torch.randn((B, H, D), generator=g, device=dev).to(dt)
    bt = torch.randint(0, NB, (B, MB), generator=g, device=dev,
                       dtype=torch.int32)
    cl = torch.full((B,), ctx, device=dev, dtype=torch.int32)
    nbytes = 2 * B * H * D * e + B * ctx * Hkv * D * 2 * e + B * MB * 4 + B * 4
    flops = 4 * B * ctx * H * D
    out["paged_attention"] = (
        time_ms(torch, lambda: ops.paged_attention(q, pool, bt, cl, layer=0,
                                                   force="kernel")),
        time_ms(torch, lambda: ref.paged_attention_ref(q, pool, bt, cl,
                                                       layer=0)),
        *bound(nbytes, flops), None)
    del pool
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


KERNEL_FAMILIES = (("paged_decode_kernel", "paged_attention"),
                   ("flash_fwd_kernel", "flash_attention"),
                   ("kv_copy_kernel", "kv_copy"), ("Memcpy", "memcpy"),
                   ("nvjet", "matmul"), ("gemm", "matmul"),
                   ("cutlass", "matmul"))


def device_time_by_family(prof):
    """Device milliseconds of a torch.profiler trace by kernel family."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        fam = next((f for k, f in KERNEL_FAMILIES if k in e.name), "other")
        out[fam] = out.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def serve(torch, cfg, sv, prompts, device, seed=0, trace=False):
    """Serve ``prompts`` [(ids, max_tokens)] to completion through the
    port's ServingEngine with the paged runner; return streams, margins,
    wall seconds and counters. ``trace`` records the drain with
    torch.profiler and adds device milliseconds by kernel family."""
    from repro_torch.configs import GH200
    from repro_torch.core.types import RequestState, SamplingParams
    from repro_torch.serving.engine import ServingEngine
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
    res = dict(
        streams={h.req_id: list(h.request.generated_ids) for h in handles},
        margins=margins, wall_s=wall,
        tokens=sum(len(h.request.generated_ids) for h in handles),
        rotations=eng.stats.active_rotations + eng.stats.passive_preemptions,
        move_wall_s=st.copy_launch_wall_s + st.upload_launch_wall_s,
        prefill_wall_s=ex.prefill_launch_wall_s,
        decode_wall_s=ex.decode_launch_wall_s,
        decode_batches=ex.decode_batches, attn_launches=ex.attn_launches,
        prefill_chunks=ex.prefill_chunks_run,
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
        log(f"{label} run ({run}) hbm={hbm} blocks: wall {res['wall_s']:.3f} "
            f"s, {res['tokens']} tokens, "
            f"{res['tokens'] / res['wall_s']:.2f} tok/s, rotations "
            f"{res['rotations']}, rows d2h {res['d2h_rows']} h2d "
            f"{res['h2d_rows']} d2d {res['d2d_rows']}, copy launches "
            f"{res['copy_launches']}, host wall in row movement "
            f"{res['move_wall_s']:.3f} s, prefill dispatch "
            f"{res['prefill_wall_s']:.3f} s, decode dispatch "
            f"{res['decode_wall_s']:.3f} s, decode batches "
            f"{res['decode_batches']}, prefill chunks "
            f"{res['prefill_chunks']}")
        out[run] = res
    b = out["b"]
    if not (b["rotations"] > 0 and b["d2h_rows"] > 0 and b["h2d_rows"] > 0
            and b["copy_launches"] > 0):
        raise AssertionError(f"{label} run (b) did not rotate: {b}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref

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

    # 3. kernel vs plain
    cfg = get_config("llama3-8b")
    errs = {}
    kernel_checks(torch, ops, ref, cfg, errs)

    # 4. timing
    times = kernel_timing(torch, ops, ref, cfg)

    # 5. full-width serving; the launch counts come from this phase only
    prompts = make_prompts(cfg, 8, (200, 1001), (32, 65), seed=0)
    ops.reset_launch_counts()
    full = serving_runs(torch, cfg, prompts,
                        dict(block_size=16, prefill_chunk=512), 1024,
                        "cuda", "llama3-8b bf16")
    launches = ops.launch_counts()
    log(f"main-path kernel launches: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    share, first = agreement(full["a"], full["b"])
    log(f"llama3-8b bf16 (a) vs (b): {share:.4f} of tokens agree; first "
        f"divergence (req, step, margin a, margin b): {first}")
    # where the time goes: run (a) again under torch.profiler
    from repro_torch.configs import ServingConfig
    traced = serve(torch, cfg, ServingConfig(
        num_hbm_blocks=1024, paged_runner=True, block_size=16,
        prefill_chunk=512), prompts, "cuda", trace=True)
    busy = sum(traced["device_ms"].values())
    wall_ms = traced["wall_s"] * 1e3
    log(f"llama3-8b bf16 run (a) traced: wall {wall_ms:.1f} ms, device "
        f"busy {busy:.1f} ms ({busy / wall_ms:.3f} of wall), by family "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in
                    sorted(traced["device_ms"].items(),
                           key=lambda kv: -kv[1])))

    # 6. lossless: reduced llama3-8b in fp32, ample vs tight HBM
    tiny = dataclasses.replace(cfg.reduced(), dtype="float32")
    small = make_prompts(tiny, 5, (8, 16), (10, 16), seed=3)
    lossless = serving_runs(torch, tiny, small,
                            dict(block_size=4, prefill_chunk=8,
                                 max_model_len=64, num_dram_blocks=512),
                            4096, "cuda", "llama3-8b-reduced fp32")
    if lossless["a"]["streams"] != lossless["b"]["streams"]:
        share, first = agreement(lossless["a"], lossless["b"])
        raise AssertionError(f"lossless: streams differ under rotation "
                             f"(agree {share:.4f}, first {first})")
    log("lossless: reduced fp32 token streams equal with and without "
        "rotation")

    sources = {"kv_copy": ("kv_copy.cu", "src/repro/kernels/kv_copy.py:29"),
               "paged_attention": ("paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:84"),
               "flash_attention": ("flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:72")}
    kernels = []
    for name, (src, replaces) in sources.items():
        ms, pms, bms, by, lms = times[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}", replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=ms,
            plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=lms))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
