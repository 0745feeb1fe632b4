#!/usr/bin/env python3
"""Two trees' bf16 flash-attention kernels in turns on one CUDA card.

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` of this tree
and of ``--other`` (a checkout of another commit, such as the parent
unpacked with ``git archive``) with this tree's nvcc flags, loads both
libraries into one process and calls each one's ``repro_flash_attention``
(the same C entry in both) on the same tensors: llama3-8b's prefill chunk
(``chip_smoke.py`` phase 4: 512 queries at q_offset 512 over 1024 keys,
32/8 heads of 128) and seamless-m4t-medium's non-causal encoder (1024
over 1024, 16/16 heads of 64). Each of ``--rounds`` rounds times "this",
"other" and "this_b" (this tree again: an A/A control whose difference
from "this" is the noise) in an order drawn from a seeded generator. A
turn is the kernel's own device time per launch from a torch.profiler
trace of 20 launches (``chip_smoke.kernel_ms``); CUDA events around
back-to-back launches would measure the host's launch rate at these
sizes. Both outputs are checked equal within bf16 rounding first. Run
from the repository root:

    python3 scripts/flash_ab.py --other build/parent [--rounds 12]

It prints the card's name and power limit, one line per turn, and last
one JSON object: per shape, each variant's median, and for "this" and
"this_b" the median and quartiles over rounds of their difference from
"other" in the same round.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

SHAPES = {  # name: (Sq, Skv, H, Hkv, D, q_offset, causal)
    "llama3-8b T=512 over 1024": (512, 1024, 32, 8, 128, 512, 1),
    "seamless encoder 1024 non-causal": (1024, 1024, 16, 16, 64, 0, 0)}


def build(tree: Path, out: Path):
    """Start nvcc on ``tree``'s flash_attention.cu; returns the process."""
    src = tree / "src" / "repro_torch" / "kernels" / "csrc" / \
        "flash_attention.cu"
    return subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                             str(out), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device")
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {"this": ROOT, "other": args.other.resolve()}
    procs = {k: (build(t, _build.BUILD_DIR / f"flash_ab_{k}.so"))
             for k, t in libs.items()}
    fns = {}
    for k, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(log)
            return 1
        fn = ctypes.CDLL(str(_build.BUILD_DIR / f"flash_ab_{k}.so")
                         ).repro_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[k] = fn
    fns["this_b"] = fns["this"]
    g = torch.Generator(device="cuda").manual_seed(0)
    order = np.random.default_rng(0)
    rows = {s: {v: [] for v in fns} for s in SHAPES}
    for shape, (Sq, Skv, H, Hkv, D, off, causal) in SHAPES.items():
        q = torch.randn((1, Sq, H, D), generator=g, device="cuda").bfloat16()
        k = torch.randn((1, Skv, Hkv, D), generator=g,
                        device="cuda").bfloat16()
        v = torch.randn((1, Skv, Hkv, D), generator=g,
                        device="cuda").bfloat16()
        outs = {name: torch.empty_like(q) for name in fns}
        stream = torch.cuda.current_stream().cuda_stream

        def call(name):
            err = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            outs[name].data_ptr(), 1, 1, Sq, Skv, H, Hkv, D,
                            off, causal, 0, D ** -0.5, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        for name in fns:
            call(name)
        torch.cuda.synchronize()
        diff = (outs["this"].float() - outs["other"].float()).abs().max()
        print(f"{shape}: this vs other max |diff| {diff.item():.3e}",
              flush=True)
        if not diff.item() < 2e-2:
            return 1
        for r in range(args.rounds):
            for name in order.permutation(list(fns)):
                ms = cs.kernel_ms(torch, lambda: call(name),
                                  "flash_attention")
                rows[shape][name].append(ms)
                print(f"round {r} {shape} {name}: {ms:.5f} ms", flush=True)
    summary = {}
    for shape, by in rows.items():
        s = {name: {"median_ms": statistics.median(x)}
             for name, x in by.items()}
        for name in ("this", "this_b"):
            d = [a - b for a, b in zip(by[name], by["other"])]
            q1, q2, q3 = np.percentile(d, [25, 50, 75])
            s[name]["minus_other_ms"] = {"median": float(q2),
                                         "q1": float(q1), "q3": float(q3)}
        summary[shape] = s
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
