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

It runs on CUDA unless ``--device cpu``. ``--mesh D,M`` runs the cell's
step on a ``(data, model)`` mesh (``launch.mesh.make_mesh``: CUDA needs
``D·M`` cards unless ``--device`` lists one device a shard, e.g.
``cuda:0,cuda:0,cuda:0,cuda:0``; ``--device cpu`` puts every shard on
the CPU): a train cell, a prefill cell under ``PREFILL_RULES`` or a
decode cell under ``DECODE_RULES``, of any family (an encoder-decoder's
decode reads cross caches over its source frames). ``--mesh P,D,M``
puts a "pod" axis first: the multi-pod mesh, its batch over the pods and
data rows together. It prints the top operations of each device, then
the bytes each position's collectives counted and the roofline's
collective term they give.

    PYTHONPATH=src python -m repro_torch.launch.inspect_hlo --arch gemma3-1b \
        --shape train_4k --periods 1 --mesh 2,2,2 \
        --device cuda:0,cuda:0,cuda:0,cuda:0,cuda:0,cuda:0,cuda:0,cuda:0
"""
from __future__ import annotations

import argparse
import collections
import sys

import torch


def concrete_args(bundle, cfg, shape, device, seed: int = 0, mesh=None):
    """The step's arguments on ``device``: weights drawn from a seeded
    generator, zero moments and caches, ``make_demo_inputs``'s batch; with
    ``mesh``, a train state, or the weights and a decode's caches, laid
    over it under the cell's rules (each weight placed as it is drawn,
    each cache piece made in place)."""
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import rules_for_shape
    from repro_torch.models.api import make_demo_inputs
    from repro_torch.models.params import init_lm_params
    from repro_torch.optimizer import adamw
    from repro_torch.optimizer.adamw import TensorSpec
    from repro_torch.training.step import TrainState
    from repro_torch.tree import tree_map
    gen = torch.Generator(device=device).manual_seed(seed)
    batch = make_demo_inputs(cfg, shape, device=device)
    if mesh is not None and bundle.kind != "train":
        rules = rules_for_shape(bundle.kind)
        params = init_lm_params(cfg, gen, device, place=lambda w, axes: (
            spmd.place(w, axes, mesh, rules)))
        if bundle.kind == "prefill":
            return [params, batch]
        caches = tree_map(
            lambda s, a: spmd.zeros(s.shape, s.dtype, a[0], mesh, rules),
            bundle.args_structs[1], bundle.args_axes[1],
            is_leaf=lambda x: isinstance(x, TensorSpec))
        return [params, caches, batch]
    params = init_lm_params(cfg, gen, device)
    if bundle.kind == "train":
        opt = adamw.AdamWConfig(
            moments_dtype=bundle.static_meta["moments_dtype"])
        state = TrainState(params, adamw.init_state(params, opt))
        if mesh is not None:
            from repro_torch.models.lm import LM
            from repro_torch.training.step import place_state
            state = place_state(LM(cfg), opt, state, mesh)
        return [state, batch]
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
            if (e.device_type() == DeviceType.CUDA
                    and e.device_index() == (device.index or 0)):
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
    ap.add_argument("--mesh", default="none",
                    help="'none' (one device) or 'D,M': the cell on a "
                         "(data, model) mesh ('P,D,M': the multi-pod "
                         "(pod, data, model) mesh)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--periods", type=int, default=1)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--opt", action="append", default=[],
                    help="k=v overrides passed to make_step_bundle")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' to run there)")
    args = ap.parse_args(argv)
    mesh_shape = None
    if args.mesh != "none":
        try:
            mesh_shape = tuple(int(x) for x in args.mesh.split(","))
        except ValueError:
            ap.error(f"--mesh takes 'none', 'D,M' or 'P,D,M', got "
                     f"{args.mesh!r}")

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.device import resolve_device
    from repro_torch.distributed import spmd
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import depth_variant, mesh_step, period_len
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.api import make_step_bundle

    opts = {}
    for kv in args.opt:
        k, v = kv.split("=", 1)
        opts[k] = int(v) if v.isdigit() else v
    cfg = get_config(args.arch)
    var = depth_variant(cfg, args.periods, period_len(cfg))
    shape = SHAPES[args.shape]
    bundle = make_step_bundle(var, shape, microbatches=args.microbatches,
                              **opts)
    mesh, fn = None, bundle.fn
    if mesh_shape is not None:
        dev = (args.device.split(",") if args.device and "," in args.device
               else args.device)
        axes = (("pod", "data", "model") if len(mesh_shape) == 3
                else ("data", "model")[:len(mesh_shape)])
        mesh = make_mesh(mesh_shape, axes, dev)
        device = mesh.devices[0]
        fn = mesh_step(bundle, var, mesh)
    else:
        device = resolve_device(args.device)
    step_args = concrete_args(bundle, var, shape, device, mesh=mesh)
    devices = sorted(set(mesh.devices if mesh is not None else [device]),
                     key=str)

    def run():
        fn(*step_args)
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    run()                                   # warm-up
    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    spmd.reset_collective_bytes()
    with profile(activities=acts) as prof:
        run()
    for dev in devices:
        print_top(prof, dev, args, var, opts, mesh)
    print(f"# model_flops={roofline.model_flops(var, shape):.3e} "
          f"(this depth)")
    if mesh is not None:
        for r in range(mesh.size):
            coll = spmd.collective_bytes(r)
            term = roofline.roofline_terms(0.0, 0.0, sum(coll.values()))
            print(f"# position {r} ({mesh.devices[r]}): collective bytes "
                  f"{coll}, collective term {term['collective_s']:.6f} s "
                  f"at {roofline.H100_SXM.link_bw:.3e} B/s")
    for dev in devices:
        if dev.type == "cuda":
            print(f"# peak device memory on {dev} "
                  f"{torch.cuda.max_memory_allocated(dev)} B")
    return 0


def print_top(prof, device, args, var, opts, mesh) -> None:
    """The top operations of one device of the trace."""
    rows = top_ops(prof, device)
    total = sum(ms for ms, _ in rows.values())
    where = (torch.cuda.get_device_name(device) + f" ({device})"
             if device.type == "cuda" else "cpu")
    what = "device" if device.type == "cuda" else "self CPU"
    on_mesh = (f" mesh={dict(mesh.shape)}, {mesh.devices.count(device)} "
               f"shards here" if mesh is not None else "")
    print(f"# {args.arch} {args.shape} periods={args.periods} "
          f"({var.num_layers} layers) mb={args.microbatches} opts={opts} on "
          f"{where}{on_mesh}: {sum(c for _, c in rows.values())} "
          f"operations, {total:.3f} ms {what} time")
    print(f"{'ms':>10} {'share':>6} {'calls':>6}  operation")
    for name, (ms, calls) in sorted(rows.items(),
                                    key=lambda kv: -kv[1][0])[:args.top]:
        print(f"{ms:10.3f} {ms / total if total else 0.0:6.3f} {calls:6d}  "
              f"{name[:100]}")


if __name__ == "__main__":
    sys.exit(main())
