#!/usr/bin/env python3
"""``chip_smoke.py`` phase 16 (a), phase 15 (a) or phase 17 (a), with its
shards on separate cards: the cross-card path of training, or of prefill
and decode, on a (data, model) mesh (each position's pieces and kernels
on its own card, the collectives across cards).

Needs a host with at least four CUDA cards. It builds the kernels, then
trains mamba2-2.7b (phase 16, the default: 2 steps) or gemma3-1b
(``--phase 15``: 3 steps) at full width and depth through the launcher
(seeded bf16 weights, ``SyntheticPacked`` seed 0, 4 x 1024 in 2
microbatches, int8 moments) with no mesh on ``cuda:0``, on a (2, 2) mesh
stacked on ``cuda:0``, and on a (2, 2) mesh over ``cuda:0..3``, each with
a checkpoint at its end. The mesh runs' losses must lie within
``chip_smoke.MESH_TOL`` of the run without one, and their states within
``chip_smoke.STATE_TOL``, the parameters and the int8 moments each
(``chip_smoke.split_gaps`` of each leaf's ``chip_smoke.leaf_measures``).
Phase 16 adds a control with no mesh at
all: one microbatch of 4 rows in place of two of 2, the same step with
its bf16 adds in another order, whose state gap to the two-microbatch
run is the noise floor of the check (printed, not held). ``--phase 17``
runs ``chip_smoke.serve_mesh_full`` (llama3-8b's prefill of 4 x 1016
tokens and 32 greedy decode steps on (2, 2) against no mesh) stacked on
``cuda:0`` and over ``cuda:0..3``. Run from the repository root:

    python3 scripts/mesh_cards.py [--phase 15|17]

It prints the card's name, power limit and count, each run's lines with
each card's peak memory, and last one JSON object with the runs' losses,
walls and peaks. The positions run from one host thread, so no wall here
is a data- or model-parallel speed-up.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


ARCH = {15: "gemma3-1b", 16: "mamba2-2.7b", 17: "llama3-8b"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", type=int, choices=sorted(ARCH), default=16)
    phase = ap.parse_args(argv).phase
    arch = ARCH[phase]
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
    if phase == 17:
        out = {}
        for name, devs in (("stacked", cs.MESH_STACK),
                           ("four cards", [f"cuda:{i}" for i in range(4)])):
            t0 = time.perf_counter()
            res = cs.serve_mesh_full(torch, devs, name)
            out[name] = dict(wall_s=time.perf_counter() - t0,
                             traced_step_s=res["traced_s"],
                             busy_ms=res["busy_ms"], peak_bytes=res["peaks"])
            cs.log(f"{name}: {out[name]}")
        print("\n".join(card))
        print(json.dumps({"mesh_cards": out, "arch": arch}), flush=True)
        return 0
    steps = 2 if arch == "mamba2-2.7b" else 3
    args = ["--arch", arch, "--steps", str(steps), "--batch", "4", "--seq",
            "1024", "--moments-dtype", "int8", "--log-every", "1"]
    mb2 = ["--microbatches", "2"]
    runs = {"one card": mb2, "stacked": mb2 + [
        "--mesh", "2,2", "--device", ",".join(cs.MESH_STACK)],
        "four cards": mb2 + ["--mesh", "2,2", "--device",
                             ",".join(f"cuda:{i}" for i in range(4))]}
    if arch == "mamba2-2.7b":
        runs["one card, 1 microbatch"] = ["--microbatches", "1"]
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
        cs.log(f"{name}: losses {losses}, {wall:.2f} s for {steps} steps and "
               f"a checkpoint (weights drawn and placed at start), peak "
               f"memory a card {peaks}, flash launches "
               f"{out[name]['flash']}")
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.optimizer.adamw import AdamWConfig
    from repro_torch.training.step import train_state_structs
    names = cs.leaf_names(train_state_structs(
        LM(get_config(arch)), AdamWConfig(moments_dtype="int8")))
    base = out["one card"]
    for name in [n for n in out if n != "one card"]:
        gap = cs.worst(abs(a - b) for a, b in zip(out[name]["losses"],
                                                  base["losses"]))
        pgap, mgap = cs.split_gaps(out[name]["sums"], base["sums"], names)
        out[name]["state_gap"] = dict(params=pgap, moments=mgap)
        cs.log(f"{name} against one card: losses max |gap| {gap:.3e} "
               f"(tolerance {cs.MESH_TOL}), state: parameters {pgap:.3e}, "
               f"moments {mgap:.3e} (tolerance {cs.STATE_TOL} each); widest "
               f"{cs.widest_gaps(out[name]['sums'], base['sums'], names)}")
        if "microbatch" in name:
            continue                    # the control: printed, not held
        if not (gap <= cs.MESH_TOL and pgap <= cs.STATE_TOL
                and mgap <= cs.STATE_TOL):
            raise AssertionError(f"{name}: {out[name]['losses']}")
    for run in out.values():
        del run["sums"]
    print("\n".join(card))
    print(json.dumps({"mesh_cards": out, "arch": arch}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
