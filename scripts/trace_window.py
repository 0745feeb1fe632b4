#!/usr/bin/env python3
"""How often a short torch.profiler trace of the card comes back with no
device event at all, with and without ``chip_smoke.device_profile``'s
padding.

``chip_smoke.py`` times each kernel alone from a trace of 20 launches
(phase 4). Such a trace lasts a millisecond or less, and now and then it
holds no device event, so the row fails for want of its kernel. This
builds the kernels, then alternates ``N`` times between a bare trace of
``CALLS`` launches of the flash kernel at phase 4's paligemma-3b row
(8 q heads, 1 kv head, head_dim 256, 320 positions, causal, bf16) and the
same launches under ``device_profile``. It prints each empty trace, the
card's name and power limit, and last one JSON object with the counts.
It exits 1 where a padded trace came back empty. Run from the repository
root on a machine with one CUDA card:

    python3 scripts/trace_window.py [N [CALLS]]     # default 1500 1
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def device_events(prof) -> int:
    from torch.autograd import DeviceType
    return sum(e.device_type() == DeviceType.CUDA
               for e in prof.profiler.kineto_results.events())


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("trace_window: no CUDA device", file=sys.stderr)
        return 1
    n = int(argv[0]) if argv else 1500
    calls = int(argv[1]) if len(argv) > 1 else 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _build, ops
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    _build.build()
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((1, 320, h, 256), generator=g,
                           device="cuda").bfloat16() for h in (8, 1, 1))

    def launches():
        for _ in range(calls):
            ops.flash_attention(q, k, v, causal=True, force="kernel")
        torch.cuda.synchronize()

    launches()
    empty = {"bare": 0, "padded": 0}
    t0 = time.perf_counter()
    for i in range(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            launches()
        if device_events(prof) == 0:
            empty["bare"] += 1
            print(f"trace {i} bare: no device event", flush=True)
        with chip_smoke.device_profile(torch) as prof:
            launches()
        if device_events(prof) == 0:
            empty["padded"] += 1
            print(f"trace {i} padded: no device event", flush=True)
    print(card, flush=True)
    print(json.dumps({"traces_each": n, "calls": calls, "empty": empty,
                      "pad_s": chip_smoke.TRACE_PAD_S,
                      "seconds": round(time.perf_counter() - t0, 2)}),
          flush=True)
    return 1 if empty["padded"] else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
