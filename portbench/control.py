#!/usr/bin/env python3
"""The readings a cell's correctness limit is set from, on the card at the
cell's own size and load, several seeds in one process.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--int8-seeds 4] [--sound-seeds 5,6] [--seconds 51]

For each of ``--seeds``: a sound run of the cell with the fp8 control read
beside the reference on the same prompts and served tokens. For each of
``--int8-seeds``: the cell served on the program's own lower-precision
path (its int8 KV tier) and checked like a sound run. ``--sound-seeds``
adds sound runs alone. Each run is one JSON line, also written under ``chiprun_out/``:
its widest gap, the control's, and the harness's verdict on each
(``correct``, ``control_correct``); both controls have to come out not
correct. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--int8-seeds", default="")
    ap.add_argument("--sound-seeds", default="")
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args()
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    out_path = ROOT / "chiprun_out" / f"control_{args.workload}.jsonl"
    out_path.parent.mkdir(exist_ok=True)
    harness.one_thread()
    cell = harness.load_cell(args.workload)
    int8 = dataclasses.replace(harness.serving_config(cell), kv_dtype="int8")
    runs = ([(int(s), "bf16+fp8", True, None) for s in args.seeds.split(",")
             if s]
            + [(int(s), "int8_kv", False, int8)
               for s in args.int8_seeds.split(",") if s]
            + [(int(s), "bf16", False, None)
               for s in args.sound_seeds.split(",") if s])
    for seed, what, control, sv in runs:
        t = time.monotonic()
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               "cuda:0", t, control=control, sv=sv)
        correct, _ = harness.verdict(cell, out)
        row = {"workload": args.workload, "seed": seed, "run": what,
               "card": torch.cuda.get_device_name(0), "correct": correct,
               **out.check, "kv_dtype_departures": out.kv_departures,
               "sample_rotated": out.sample_rotated, "failed": out.failed,
               "h2d_rows": out.rec.delta("h2d_rows"),
               "d2h_rows": out.rec.delta("d2h_rows"),
               "wall_s": time.monotonic() - t}
        if control:
            row["control_correct"] = harness.verdict(
                cell, harness.control_outcome(out))[0]
        line = json.dumps(row)
        print(line, flush=True)
        with out_path.open("a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
