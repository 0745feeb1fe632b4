#!/usr/bin/env python3
"""The seconds that cuts of ``chip_smoke.py``'s depths save against the
seconds that a phase added to it costs, timed in one process on one card.

``chip_smoke.py`` must end within its time limit, so a phase is added
only after earlier phases lose depth (never width). This builds the
kernels, runs each cut phase alone at the depth it had before its cut and
at the depth it has now (``CUTS``), then the added phase (``ADDED``), and
prints each wall, the seconds saved and the seconds added, the card's
name and power limit, and last one JSON object with the walls. It exits
1 where the cuts saved fewer seconds than the phase took. Run from the
repository root on a machine with one CUDA card:

    python3 scripts/phase_budget.py

Host-bound walls differ between machines by up to 2x: compare them only
within one run.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# (phase, chip_smoke's depth constant, its value before the cut)
CUTS = (("16", "MESH_FAMILY_DEPTH", 16), ("17", "SERVE_MESH_DEPTH", 32),
        ("18", "SERVE_SSM_DEPTH", 64))
ADDED = "20"


def main() -> int:
    if not torch.cuda.is_available():
        print("phase_budget: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    cs.log(f"device: {card}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    torch.cuda.init()
    walls, saved = {}, 0.0
    for phase, name, before in CUTS:
        now = getattr(cs, name)
        for depth in (before, now):
            setattr(cs, name, depth)
            t0 = time.perf_counter()
            cs.run_alone(torch, phase)
            walls[f"phase {phase} at {name}={depth}"] = \
                time.perf_counter() - t0
        setattr(cs, name, now)
        cut = (walls[f"phase {phase} at {name}={before}"]
               - walls[f"phase {phase} at {name}={now}"])
        cs.log(f"phase {phase}: {name} {before} -> {now} saved {cut:.2f} s")
        saved += cut
    t0 = time.perf_counter()
    cs.run_alone(torch, ADDED)
    added = walls[f"phase {ADDED}"] = time.perf_counter() - t0
    cs.log(f"the cuts saved {saved:.2f} s; phase {ADDED} took {added:.2f} "
           f"s: {'room made' if saved >= added else 'NOT ENOUGH ROOM'}")
    print(card)
    print(json.dumps({"phase_budget": walls, "saved_s": saved,
                      "added_s": added, "card": card}), flush=True)
    return 0 if saved >= added else 1


if __name__ == "__main__":
    sys.exit(main())
