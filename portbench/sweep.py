#!/usr/bin/env python3
"""Size a cell once, on the card: the KV pool the card holds, and the knee.

    python3 portbench/sweep.py --workload <name> --seed <n> --probe \
        --rates 3,4,5,6 --seconds 30 --warm 10

``--probe`` draws the cell's weights, reads the card's free memory, runs
the largest shapes the cell's traffic makes (a decode batch of
``max_batch_size`` sequences beside a prompt of ``in_max`` tokens) to find
the peak working memory, and prints the largest pool (a multiple of 64
rows) that fits beside them. ``--rates`` then serves the cell's traffic at
each rate in turn (same weights, a fresh engine each, the pool from
``--hbm-blocks`` or the probe), and prints per rate the output tokens per
second, the TTFT tail and how fast the count of requests still waiting for
their first token grows over the window: the knee is the highest rate at
which it does not grow. Each line is JSON, also written under
``chiprun_out/``.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

MARGIN = 1 << 30          # bytes left free beside the pool and the peak


def emit(out_path: Path, row: dict) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    with out_path.open("a") as f:
        f.write(line + "\n")


def probe(cell, params, device) -> dict:
    """The largest pool beside the weights and the peak working memory."""
    import numpy as np
    import torch
    from repro_torch.core.types import SamplingParams
    from portbench import harness
    free0, total = torch.cuda.mem_get_info()
    weights_b = torch.cuda.memory_allocated()
    s = cell.traffic["serving"]
    small = dataclasses.replace(harness.serving_config(cell),
                                num_hbm_blocks=1024)
    engine = harness.build_engine(cell, params, device, sv=small)
    pool_b = torch.cuda.memory_allocated() - weights_b
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(0)
    sp = SamplingParams(max_tokens=2, ignore_eos=True)
    engine.add_request(prompt_ids=rng.integers(
        1, cell.dims.vocab, cell.traffic["lengths"]["in_max"]).tolist(),
        sampling_params=sp)
    for _ in range(s["max_batch_size"] - 1):
        engine.add_request(prompt_ids=rng.integers(
            1, cell.dims.vocab, 16).tolist(), sampling_params=sp)
    engine.drain()
    torch.cuda.synchronize()
    work_b = torch.cuda.max_memory_allocated() - weights_b - pool_b
    row_b = cell.dims.row_bytes
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    free1, _ = torch.cuda.mem_get_info()
    rows = (free1 - work_b - MARGIN) // row_b - 64 - 1
    return {"total_b": total, "free_before_weights_b": free0,
            "weights_b": weights_b, "free_after_weights_b": free1,
            "row_b": row_b, "working_peak_b": work_b, "margin_b": MARGIN,
            "num_hbm_blocks": int(rows // 64 * 64)}


def waiting_slope(rec, step: float = 1.0) -> float:
    """Least-squares growth, in requests a second, of the count of
    requests due but still without a first token, over the window."""
    import numpy as np
    ts = np.arange(rec.w0, rec.w1 + 1e-9, step)
    counts = [sum(1 for r in rec.requests if r.due <= t and not (
        r.token_times and r.token_times[0] <= t)) for t in ts]
    return float(np.polyfit(ts, counts, 1)[0])


def serve_at(cell, params, device, rate: float, seconds: float,
             warm_s: float, seed: int, sv) -> dict:
    import torch
    from portbench import harness, loadgen
    from portbench.record import RunRecord
    from portbench.stats import percentile
    traffic = dict(cell.traffic, rate_rps=rate, warm_s=warm_s)
    c = dataclasses.replace(cell, traffic=traffic)
    engine = harness.build_engine(c, params, device, sv=sv)
    harness.warm(engine, c)
    specs = loadgen.schedule(traffic, seconds, seed, c.dims.vocab)
    torch.cuda.synchronize()
    drive = asyncio.run(harness._drive(engine, c, specs, seconds, False,
                                       lambda t: None))
    sn = drive.snaps
    rec = RunRecord(dims=c.dims, w0=warm_s, w1=warm_s + seconds,
                    span=(sn["w0"][0], sn["w1"][0]),
                    counters={"start": sn["w0"][1], "end": sn["w1"][1]},
                    requests=drive.requests, setup_s=0.0)
    counted = rec.counted()
    ttfts = [r.ttft(rec.w1)[0] for r in counted]
    rd = {k: harness.metric_reader(k)(rec) for k in (
        "output_tok_s", "engine_iter_ms",
        "decode_batch", "rotated_gb_s", "row_move_share",
        "decode_dispatch_ms", "prefill_dispatch_ms", "mfu")}
    row = {"rate_rps": rate, "seconds": seconds, "warm_s": warm_s,
           "due_in_window": len(counted),
           "waiting_slope_rps": waiting_slope(rec),
           "ttft_p50_ms": (percentile(ttfts, 50) or 0) * 1e3,
           "ttft_p95_ms": (percentile(ttfts, 95) or 0) * 1e3,
           "failed": sum(r.failed for r in rec.requests),
           "rotated_back": len(drive.back),
           "counters": {k: rec.delta(k) for k in rec.counters["end"]},
           "peak_b": torch.cuda.max_memory_allocated(), **rd}
    del engine, drive
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--warm", type=float, default=10.0)
    ap.add_argument("--hbm-blocks", type=int, default=0)
    args = ap.parse_args()
    import torch
    from portbench import harness, weights
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    out_path = ROOT / "chiprun_out" / f"sweep_{args.workload}.jsonl"
    out_path.parent.mkdir(exist_ok=True)
    harness.one_thread()
    cell = harness.load_cell(args.workload)
    device = "cuda:0"
    t = time.monotonic()
    params = weights.draw(cell.dims, args.seed, device)
    torch.cuda.synchronize()
    emit(out_path, {"workload": args.workload,
                    "card": torch.cuda.get_device_name(0),
                    "draw_s": time.monotonic() - t})
    blocks = args.hbm_blocks
    if args.probe:
        p = probe(cell, params, device)
        emit(out_path, {"probe": p})
        blocks = blocks or p["num_hbm_blocks"]
    sv = harness.serving_config(cell)
    if blocks:
        sv = dataclasses.replace(sv, num_hbm_blocks=blocks,
                                 num_dram_blocks=max(sv.num_dram_blocks,
                                                     3 * blocks))
    for rate in [float(r) for r in args.rates.split(",") if r]:
        emit(out_path, serve_at(cell, params, device, rate, args.seconds,
                                args.warm, args.seed, sv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
