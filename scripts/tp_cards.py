#!/usr/bin/env python3
"""``chip_smoke.py`` phase 14 with its shards on separate cards: the
cross-card path of tensor parallelism (each shard's weights, pool and
kernels on its own card, the all-reduce across cards).

Needs a host with at least two CUDA cards. It builds the kernels, serves
phase 5's llama3-8b runs at tp=1 on ``cuda:0`` (full width, bf16 weights
from seed 0; 1024 and 119 HBM blocks; bf16 and int8 KV), then phase 14
(a) at tp=2 over ``cuda:0`` and ``cuda:1`` against them, and phase 14 (b)
over the cards (the reduced fp32 matrix at tp 2 and 4, shard ``i`` on
``cuda:i % n``, against tp=1 and the CPU). Run from the repository root:

    python3 scripts/tp_cards.py

It prints the card's name, power limit and count, each run's lines, and
last one JSON object with the phases' walls. The shards run from one host
thread, so no wall here is a TP speed-up.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    n = torch.cuda.device_count()
    if n < 2:
        print(f"tp_cards: needs two CUDA cards, torch sees {n}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    cs.log(f"device: {card} x {n}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    walls = {}
    t0 = time.perf_counter()
    _build.build()
    walls["build"] = time.perf_counter() - t0
    cfg = get_config("llama3-8b")
    prompts = cs.make_prompts(cfg, 8, (200, 1001), (32, 65), seed=0)
    t0 = time.perf_counter()
    full = {kvd: cs.serving_runs(
        torch, cfg, prompts, dict(block_size=16, prefill_chunk=512,
                                  kv_dtype=kvd), 1024, "cuda",
        f"llama3-8b {kvd} KV") for kvd in ("bf16", "int8")}
    walls["tp1"] = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cs.tp_full_width(torch, cfg, prompts, full, mesh=("cuda:0", "cuda:1"))
    walls["tp2_cards"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs.tp_reduced(torch, cfg, lambda tp: [f"cuda:{i % n}" for i in
                                          range(tp)], "tp over cards")
    walls["reduced_cards"] = time.perf_counter() - t0
    cs.log(f"kernel launches over the cards (each shard's counted): "
           f"{ops.launch_counts()}")
    print(card)
    print(json.dumps({"cards": n, "walls_s": walls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
