#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the CUDA card it starts on.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Prints the run's readings on earlier lines
and, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number the correctness check
compared, beside its limit (also the last lines of standard error). Exits
non-zero with no result when no CUDA card is there, when the port's
sources are missing, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """This process's start on the monotonic clock (Linux: both count from
    boot), or now where /proc cannot say."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        return int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic()


def forbidden_modules(names=None) -> list:
    """Loaded modules (of ``names``, else ``sys.modules``) whose top-level
    name is JAX's or the JAX package's, compared whole (``repro_torch`` is
    not ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    proc_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"the port's sources are not under {ROOT / 'src'}",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    build = ROOT / "build" / "portbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "extensions"))
    os.environ.setdefault("USE_FLAX", "0")

    import torch
    from portbench import harness, trace as tracing
    from portbench.stats import percentile

    cell = harness.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found {cards}",
              file=sys.stderr)
        return 3

    harness.one_thread()
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda:0", proc_start)
    rec = out.rec
    correct, nums = harness.verdict(cell, out)

    metrics = {}
    for m in harness.cell_metrics(args.workload, bool(args.trace)):
        v = harness.metric_reader(m["name"].split(".")[0])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    counted = rec.counted()
    ttfts = [r.ttft(rec.w1)[0] for r in counted]
    gaps = [t - r.token_times[k - 1] for r, k, t in rec.tokens(rec.w0, rec.w1)
            if k > 0]
    print(json.dumps({"readings": {
        "requests_due_in_window": len(counted),
        "ttft_samples": len(ttfts), "tbt_samples": len(gaps),
        "ttft_p50_ms": (percentile(ttfts, 50) or 0) * 1e3,
        "ttft_p90_ms": (percentile(ttfts, 90) or 0) * 1e3,
        "ttft_p95_ms": (percentile(ttfts, 95) or 0) * 1e3,
        "tbt_p50_ms": (percentile(gaps, 50) or 0) * 1e3,
        "tbt_p95_ms": (percentile(gaps, 95) or 0) * 1e3,
        "first_tokens_by_close": sum(r.ttft(rec.w1)[1] for r in counted),
        "generator_late_max_ms": max(out.lateness, default=0) * 1e3,
        "generator_late_p99_ms": (percentile(out.lateness, 99) or 0) * 1e3,
        "setup_s": rec.setup_s,
        "counters": {k: rec.delta(k) for k in rec.counters["end"]},
        "counter_span_s": rec.span[1] - rec.span[0],
        "host": out.host, "check": out.check,
        "sample_rotated": out.sample_rotated}}),
        flush=True)

    found = forbidden_modules()
    if found:
        print(f"loaded in the run's process: {found}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": correct, "attempted": len(counted),
              "failed": sum(r.failed for r in counted), "metrics": metrics,
              "device": device}
    if rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        result["breakdown"] = tracing.breakdown(rec.trace)
    result["check"] = nums
    for k, v in nums.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
