#!/usr/bin/env python3
"""``chip_smoke.py`` phase 8 (the HTTP server at full width) of two trees,
in turns, on one CUDA card.

Each turn runs one tree's ``chip_smoke.server_phase`` in a fresh process
on phase 5's prompts (llama3-8b at full width, 8 streaming clients and one
that leaves, HBM for the two largest requests), after building that
tree's kernels. The turns go this, other, other, this, ... for
``--rounds`` rounds. Run from the repository root, with ``--other`` a
checkout of another commit (such as the parent unpacked with ``git
archive``):

    python3 scripts/server_phase_ab.py --other build/parent [--rounds 1]

It prints the card's name and power limit, each turn's summary lines, and
last one JSON object: per tree, each turn's rotations, engine steps, load
wall and client-side TTFT and TBT medians.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
TURN = """
import sys
sys.path.insert(0, {tree!r}); sys.path.insert(0, {tree!r} + "/src")
import torch
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.kernels import _build
_build.build()
cfg = get_config("llama3-8b")
cs.server_phase(torch, cfg, cs.make_prompts(cfg, 8, (200, 1001), (32, 65),
                                            seed=0))
"""
PATTERNS = {
    "rotations": r"server phase: .*rotations (\d+)",
    "engine_steps": r"server phase: .*engine steps (\d+)",
    "load_wall_s": r"server phase: .*finished in ([\d.]+) s wall",
    "ttft_median_s": r"TTFT median ([\d.]+)",
    "tbt_median_s": r"TBT median ([\d.]+)"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("server_phase_ab: no CUDA device")
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    trees = {"this": ROOT, "other": args.other.resolve()}
    order = [t for _ in range(args.rounds)
             for t in ("this", "other", "other", "this")]
    out = {t: [] for t in trees}
    for name in order:
        proc = subprocess.run(
            [sys.executable, "-c", TURN.format(tree=str(trees[name]))],
            cwd=trees[name], capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:])
            return 1
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("server phase")]
        print(f"--- {name}\n" + "\n".join(lines), flush=True)
        text = "\n".join(lines)
        out[name].append({k: float(re.search(p, text).group(1))
                          for k, p in PATTERNS.items()})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
