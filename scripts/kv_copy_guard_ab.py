#!/usr/bin/env python3
"""Same-process A/B of the kernel wrappers' device guard on one CUDA card.

The wrappers launch under ``_build.on_device(tensor.device)``, which
switches the thread's current CUDA device only when it is not the
tensor's. This script times ``kv_copy`` (64 rows of 2 MiB, as
``chip_smoke.py`` phase 4) and paged attention (bf16, B=8, context 1024)
with the guard as shipped ("guard"), with no guard ("none") and with no
guard again ("none_b", an A/A control whose difference from "none" is
the noise), within one process so that the variants share the machine's
state: each of ``--rounds`` rounds runs the three in an order drawn from
a seeded generator. Each turn is ``chip_smoke.time_ms`` (CUDA events
around 10 back-to-back calls, median of 10) plus the host's enqueue time
per call. Run from the repository root:

    python3 scripts/kv_copy_guard_ab.py [--rounds 24]

It prints the card's name and power limit, one line per turn, and last
one JSON object: per kernel and metric, each variant's median, min and
max, and for "guard" and "none_b" the median and quartiles over rounds of
their difference from "none" in the same round.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=24)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kv_copy_guard_ab: no CUDA device")
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    _build.build()
    shipped = _build.on_device
    variants = {"guard": shipped, "none": lambda d: contextlib.nullcontext(),
                "none_b": lambda d: contextlib.nullcontext()}
    order = np.random.default_rng(0)
    rows, NB = 1089, 1024
    flat = torch.randn((rows, 1 << 20), device="cuda").to(torch.bfloat16)
    src = np.arange(64, dtype=np.int32)
    dst = np.arange(NB - 64, NB, dtype=np.int32)
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((8, 32, 128), generator=g, device="cuda").to(
        torch.bfloat16)
    pool = flat.view(rows, 32, 2, 16, 8, 128)
    bt = torch.randint(0, NB, (8, 64), generator=g, device="cuda",
                       dtype=torch.int32)
    cl = torch.full((8,), 1024, device="cuda", dtype=torch.int32)
    calls = {"kv_copy": lambda: ops.kv_copy(flat, src, dst, force="kernel"),
             "paged_B8": lambda: ops.paged_attention(q, pool, bt, cl, layer=3,
                                                     force="kernel")}
    res = {n: {v: {"device_ms": [], "host_ms": []} for v in variants}
           for n in calls}
    try:
        for r in range(args.rounds):
            for name, fn in calls.items():
                for v in order.permutation(list(variants)):
                    _build.on_device = variants[v]
                    ms = cs.time_ms(torch, fn)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(100):
                        fn()
                    host = (time.perf_counter() - t0) / 100 * 1e3
                    torch.cuda.synchronize()
                    res[name][v]["device_ms"].append(ms)
                    res[name][v]["host_ms"].append(host)
                    print(f"round {r} {name} {v}: device {ms:.4f} ms, host "
                          f"enqueue {host:.4f} ms per call", flush=True)
    finally:
        _build.on_device = shipped
    t0 = time.perf_counter()
    for _ in range(10000):
        torch.cuda.current_device()
    cur_us = (time.perf_counter() - t0) / 10000 * 1e6
    out = {"current_device_us": cur_us}
    for name, by in res.items():
        out[name] = {}
        for metric in ("device_ms", "host_ms"):
            cell = {v: {"median": statistics.median(by[v][metric]),
                        "min": min(by[v][metric]), "max": max(by[v][metric])}
                    for v in variants}
            for v in ("guard", "none_b"):
                d = np.subtract(by[v][metric], by["none"][metric])
                cell[f"{v}_minus_none"] = {
                    "median": float(np.median(d)),
                    "q25": float(np.percentile(d, 25)),
                    "q75": float(np.percentile(d, 75))}
            out[name][metric] = cell
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
