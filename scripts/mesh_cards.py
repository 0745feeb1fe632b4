#!/usr/bin/env python3
"""``chip_smoke.py`` phase 15 (a) with its shards on separate cards: the
cross-card path of training on a (data, model) mesh (each position's
pieces and kernels on its own card, the collectives across cards).

Needs a host with at least four CUDA cards. It builds the kernels, then
trains gemma3-1b at full width and depth through the launcher (phase 12's
seeded bf16 weights and data, 4 x 1024 in 2 microbatches, int8 moments,
3 steps) with no mesh on ``cuda:0``, on a (2, 2) mesh stacked on
``cuda:0``, and on a (2, 2) mesh over ``cuda:0..3``, each with a
checkpoint at its end. The mesh runs' losses must lie within
``chip_smoke.MESH_TOL`` of the run without one, and their states within
``chip_smoke.STATE_TOL`` (``chip_smoke.state_gap``). Run from the
repository root:

    python3 scripts/mesh_cards.py

It prints the card's name, power limit and count, each run's lines, and
last one JSON object with the runs' losses and walls. The positions run
from one host thread, so no wall here is a data- or model-parallel
speed-up.
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
    if n < 4:
        print(f"mesh_cards: needs four CUDA cards, torch sees {n}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    cs.log(f"cards: {card}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    for i in range(4):      # a context on each card, for its memory stats
        torch.zeros(1, device=f"cuda:{i}")
    _build.build()
    args = ["--arch", "gemma3-1b", "--steps", "3", "--batch", "4", "--seq",
            "1024", "--microbatches", "2", "--moments-dtype", "int8",
            "--log-every", "1"]
    runs = {"one card": [], "stacked": ["--mesh", "2,2", "--device",
                                        ",".join(cs.MESH_STACK)],
            "four cards": ["--mesh", "2,2", "--device",
                           ",".join(f"cuda:{i}" for i in range(4))]}
    out = {}
    for name, extra in runs.items():
        ops.reset_launch_counts()
        for i in range(n):
            torch.cuda.reset_peak_memory_stats(i)
        t0 = time.perf_counter()
        losses, sums = cs.launch_with_state(torch, args + extra, "cuda:0")
        wall = time.perf_counter() - t0
        peaks = [torch.cuda.max_memory_allocated(i) for i in range(4)]
        out[name] = dict(losses=losses, wall_s=wall, peak_bytes=peaks,
                         flash=ops.launch_counts()["flash_attention"],
                         sums=sums)
        cs.log(f"{name}: losses {losses}, {wall:.2f} s for 3 steps and a "
               f"checkpoint (weights drawn and placed at start), peak "
               f"memory a card {peaks}, flash launches "
               f"{out[name]['flash']}")
    for name in ("stacked", "four cards"):
        gap = max(abs(a - b) for a, b in zip(out[name]["losses"],
                                              out["one card"]["losses"]))
        sgap = cs.state_gap(out[name]["sums"], out["one card"]["sums"])
        cs.log(f"{name} against one card: losses max |gap| {gap:.3e} "
               f"(tolerance {cs.MESH_TOL}), state {sgap:.3e} (tolerance "
               f"{cs.STATE_TOL})")
        if gap > cs.MESH_TOL or sgap > cs.STATE_TOL:
            raise AssertionError(f"{name}: {out[name]['losses']}")
    for run in out.values():
        del run["sums"]
    print("\n".join(card))
    print(json.dumps({"mesh_cards": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
