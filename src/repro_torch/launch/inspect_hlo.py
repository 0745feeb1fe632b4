"""Top operations of one cell's step, from a ``torch.profiler`` trace.

The port of ``src/repro/launch/inspect_hlo.py`` (same name, so a reader
finds the counterpart). The reference compiles a shallow unrolled variant
of a cell and prints its top collectives from the HLO text, since it has
no TPU timings. The port runs the cell's step for real, at ``--periods``
repeats of the model's layer pattern and at the shape's full batch and
length, with random weights from a seeded generator: once to warm up,
then once under ``torch.profiler``. It prints the top operations by self
device time (kernels by name on CUDA; aten operators by self CPU time with
``--device cpu``), with their share of the traced total and their calls.

    PYTHONPATH=src python -m repro_torch.launch.inspect_hlo --arch llama3-8b \\
        --shape decode_32k --periods 1 [--top 20] [--device cpu]

It runs on CUDA unless ``--device cpu``. A mesh of more than one device is
tensor parallelism, not ported yet (ROADMAP.md §1 item 3), so ``--mesh``
takes only "none" (one device).
"""
from __future__ import annotations

import argparse
import collections
import sys

import torch


def concrete_args(bundle, cfg, shape, device, seed: int = 0):
    """The step's arguments on ``device``: weights drawn from a seeded
    generator, zero moments and caches, ``make_demo_inputs``'s batch."""
    from repro_torch.models.api import make_demo_inputs
    from repro_torch.models.params import init_lm_params
    from repro_torch.optimizer import adamw
    from repro_torch.optimizer.adamw import TensorSpec
    from repro_torch.training.step import TrainState
    from repro_torch.tree import tree_map
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_lm_params(cfg, gen, device)
    batch = make_demo_inputs(cfg, shape, device=device)
    if bundle.kind == "train":
        opt = adamw.AdamWConfig(
            moments_dtype=bundle.static_meta["moments_dtype"])
        return [TrainState(params, adamw.init_state(params, opt)), batch]
    if bundle.kind == "prefill":
        return [params, batch]
    caches = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                            device=device),
                      bundle.args_structs[1],
                      is_leaf=lambda x: isinstance(x, TensorSpec))
    return [params, caches, batch]


def top_ops(prof, device) -> collections.Counter:
    """(name -> [self ms, calls]) of a trace: the device's kernels by name
    on CUDA, the aten operators' self CPU time on the CPU."""
    out = collections.defaultdict(lambda: [0.0, 0])
    if device.type == "cuda":
        from torch.autograd import DeviceType
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                row = out[e.name()]
                row[0] += e.duration_ns() / 1e6
                row[1] += 1
    else:
        for e in prof.key_averages():
            if e.self_cpu_time_total > 0:
                row = out[e.key]
                row[0] += e.self_cpu_time_total / 1e3
                row[1] += e.count
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="none", choices=["none"],
                    help="one device (a mesh waits for ROADMAP.md §1 "
                         "item 3)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--periods", type=int, default=1)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--opt", action="append", default=[],
                    help="k=v overrides passed to make_step_bundle")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' to run there)")
    args = ap.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import depth_variant, period_len
    from repro_torch.models.api import make_step_bundle

    opts = {}
    for kv in args.opt:
        k, v = kv.split("=", 1)
        opts[k] = int(v) if v.isdigit() else v
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    var = depth_variant(cfg, args.periods, period_len(cfg))
    shape = SHAPES[args.shape]
    bundle = make_step_bundle(var, shape, microbatches=args.microbatches,
                              **opts)
    step_args = concrete_args(bundle, var, shape, device)

    def run():
        bundle.fn(*step_args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run()                                   # warm-up
    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        run()
    rows = top_ops(prof, device)
    total = sum(ms for ms, _ in rows.values())
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    what = "device" if device.type == "cuda" else "self CPU"
    print(f"# {args.arch} {args.shape} periods={args.periods} "
          f"({var.num_layers} layers) mb={args.microbatches} opts={opts} on "
          f"{where}: {sum(c for _, c in rows.values())} operations, "
          f"{total:.3f} ms {what} time")
    print(f"{'ms':>10} {'share':>6} {'calls':>6}  operation")
    for name, (ms, calls) in sorted(rows.items(),
                                    key=lambda kv: -kv[1][0])[:args.top]:
        print(f"{ms:10.3f} {ms / total if total else 0.0:6.3f} {calls:6d}  "
              f"{name[:100]}")
    print(f"# model_flops={roofline.model_flops(var, shape):.3e} "
          f"(this depth)")
    if device.type == "cuda":
        print(f"# peak device memory "
              f"{torch.cuda.max_memory_allocated(device)} B")
    return 0


if __name__ == "__main__":
    sys.exit(main())
