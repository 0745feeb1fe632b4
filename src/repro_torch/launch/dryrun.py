"""Dry-run of every (arch x shape x mesh) cell on ``torch.device("meta")``.

The port of ``src/repro/launch/dryrun.py``. Each cell builds its step
(``models.api.make_step_bundle``) under the production mesh's sharding
rules and reports, without allocating anything or touching a device:

- per-device bytes of the step's arguments and of the memory model's
  groups (weights, optimizer state, caches), from each tensor's logical
  axes laid over the mesh (``distributed/sharding.py``);
- on the single-pod mesh, the step's FLOPs: the step runs once at full
  depth on meta tensors under ``torch.utils.flop_counter.FlopCounterMode``
  (aten matmuls and convolutions), plus each hand-written kernel's own
  formula (``kernels/*.py::flops_and_bytes``), which its wrapper adds on a
  meta tensor in place of a launch. A train step counts its forward,
  remat's recompute (``torch.utils.checkpoint`` reruns the forward of a
  layer group up to the tensors the backward needs) and the backward, with
  flash's backward as the plain PyTorch it is; ``model_flops`` counts a
  3x forward. Both are recorded, and their ratio is ``useful_flops_ratio``.
  FLOPs per device are the step's over the device count (an even split);
- the roofline of those terms on an H100 (``launch/roofline.py``), with
  the memory term from ``analytic_memory_bytes``.

The reference compiles each cell for 512 forced host devices and reads
XLA's cost analysis, which counts a ``lax.scan`` body once, so it
extrapolates from shallow unrolled compiles (``extrapolate_costs``). Here
the layers are a Python loop that the counter sees whole, so that has no
counterpart; and a meta cell needs no process of its own, so ``--all``
runs the cells in this process.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --report

Each cell writes results/dryrun_torch/<arch>__<shape>__<mesh>.json (cached;
``--force`` recomputes). A cell that fails records its traceback.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ARCH_IDS
from repro_torch.distributed.sharding import (is_axes_leaf, mesh_axis_size,
                                              pspec_for, rules_for_shape,
                                              sharding_ctx, shards_of)
from repro_torch.kernels import ops
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import make_step_bundle
from repro_torch.models.lm import build_program
from repro_torch.optimizer.adamw import TensorSpec
from repro_torch.tree import tree_leaves, tree_map

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def depth_variant(cfg, periods: int, period_len: int):
    """``cfg`` at ``periods`` repeats of its layer pattern (the encoder
    scaled jointly)."""
    L = periods * period_len
    kw = {"num_layers": L}
    if cfg.num_encoder_layers:
        kw["num_encoder_layers"] = L
    return dataclasses.replace(cfg, **kw)


def period_len(cfg) -> int:
    return len(build_program(cfg)[0].pattern)


def tree_bytes_per_device(structs, axes_tree, mesh, rules) -> float:
    """Bytes one device holds of a tree of ``TensorSpec``s whose logical
    axes are ``axes_tree``; a dim its mesh axes do not divide stays
    replicated."""
    total = 0.0
    sl = tree_leaves(structs)
    al = tree_leaves(axes_tree, is_leaf=is_axes_leaf)
    if len(sl) != len(al):
        raise ValueError(f"{len(sl)} tensors but {len(al)} axes leaves")
    for st, (axes, shape) in zip(sl, al):
        if tuple(st.shape) != tuple(shape):
            raise ValueError(f"spec shape {st.shape} != axes shape {shape}")
        spec = pspec_for(axes or (), mesh, rules, shape)
        n = 1
        for d in st.shape:
            n *= d
        total += n * st.dtype.itemsize / shards_of(spec, mesh)
    return total


def arg_bytes_per_device(bundle, mesh, rules) -> float:
    return tree_bytes_per_device(bundle.args_structs, bundle.args_axes,
                                 mesh, rules)


def group_bytes_per_device(grp, mesh, rules) -> float:
    structs, axes_tree = grp
    return tree_bytes_per_device(structs, axes_tree, mesh, rules)


def meta_args(bundle):
    """The step's arguments as meta tensors; a decode step's ``cache_len``
    is the last position of its cache (the port passes it as an int)."""
    def empty(s):
        return torch.empty(s.shape, dtype=s.dtype, device="meta")
    args = [tree_map(empty, a, is_leaf=lambda x: isinstance(x, TensorSpec))
            for a in bundle.args_structs]
    if bundle.kind == "decode":
        args[-1]["cache_len"] = bundle.static_meta["capacity"] - 1
    return args


def count_flops(bundle, times: int = 1) -> dict:
    """Run the step once on meta tensors: aten FLOPs from FlopCounterMode,
    the kernels' own from their formulas; each count times ``times``."""
    args = meta_args(bundle)
    ops.reset_meta_costs()
    t0 = time.time()
    with FlopCounterMode(display=False) as fc:
        bundle.fn(*args)
    kern = ops.meta_costs()
    aten = float(fc.get_total_flops()) * times
    return {"aten_flops": aten,
            "kernel_flops": kern["total"]["flops"] * times,
            "kernel_bytes": kern["total"]["bytes"] * times,
            "kernel_calls": {k: v["calls"] * times for k, v in kern.items()
                             if k != "total"},
            "flops": aten + kern["total"]["flops"] * times,
            "count_s": round(time.time() - t0, 2)}


def count_step_flops(cfg, shape, bundle, opts) -> dict:
    """The step's FLOPs. A train step of ``mb`` microbatches runs the same
    shapes ``mb`` times, and its accumulation and AdamW update hold no
    operation the counter counts (no matmul), so it counts one microbatch's
    step and multiplies by ``mb``: the same total as the whole step (a test
    holds the two equal), in a ``mb``-th of the host time."""
    mb = bundle.static_meta.get("microbatches", 1) if bundle.kind == "train" \
        else 1
    if mb == 1:
        return count_flops(bundle)
    one = make_step_bundle(
        cfg, dataclasses.replace(shape,
                                 global_batch=shape.global_batch // mb),
        microbatches=1, **opts)
    out = count_flops(one, times=mb)
    out["counted_microbatches"] = 1
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             microbatches=None, opt_flags=None, count: bool = True) -> dict:
    """One cell's record. ``count=False`` skips the FLOP count and the
    roofline (bytes only). FLOPs and the roofline are for the single-pod
    mesh; the multi-pod cell proves the layout (bytes), as in the
    reference."""
    opts = dict(opt_flags or {})
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "opt_flags": opt_flags or {}}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rec["devices"] = mesh.size
    rules = rules_for_shape(shape.kind, shape.global_batch)
    t0 = time.time()
    with sharding_ctx(mesh, rules):
        bundle = make_step_bundle(cfg, shape, microbatches=microbatches,
                                  **opts)
    rec.update(bundle.static_meta)
    rec["kind"] = bundle.kind
    rec["arg_bytes_per_device"] = arg_bytes_per_device(bundle, mesh, rules)
    rec["local_bytes"] = {name: group_bytes_per_device(grp, mesh, rules)
                          for name, grp in bundle.byte_groups.items()}
    rec["build_s"] = round(time.time() - t0, 2)
    if count and mesh_kind == "single":
        fc = count_step_flops(cfg, shape, bundle, opts)
        rec["flop_count"] = fc
        lb = rec["local_bytes"]
        mem_model = roofline.analytic_memory_bytes(
            cfg, shape, weights_local=lb.get("weights", 0.0),
            opt_local=lb.get("opt", 0.0), cache_local=lb.get("cache", 0.0),
            data_shards=mesh.size // mesh.shape["model"],
            model_shards=mesh.shape["model"],
            fsdp_shards=mesh_axis_size(mesh, rules.fsdp),
            microbatches=rec.get("microbatches", 1))
        rec["roofline"] = roofline.summarize(
            cfg, shape, mesh.size, {"flops": fc["flops"] / mesh.size},
            None if mesh.size > 1 else {}, mem_model)
    rec["status"] = "ok"
    return rec


def cell_path(arch, shape, mesh_kind, tag="") -> Path:
    sfx = f"__{tag}" if tag else ""
    return RESULTS_DIR / f"{arch}__{shape}__{mesh_kind}{sfx}.json"


def all_cells(meshes=("single", "multi")):
    for arch in ARCH_IDS:
        for shape in SHAPES:
            for m in meshes:
                yield arch, shape, m


def run_and_write(arch, shape, mesh_kind, args) -> dict:
    """Run one cell and write its JSON; a failure is recorded with its
    traceback."""
    try:
        rec = run_cell(arch, shape, mesh_kind,
                       microbatches=args.microbatches,
                       opt_flags={"remat_group": args.remat_group,
                                  "moments_dtype": args.moments_dtype,
                                  "accum_dtype": args.accum_dtype})
    except (RuntimeError, ValueError, TypeError, KeyError,
            NotImplementedError, IndexError) as e:
        # a shape or layout fault is recorded in the cell's JSON and said
        # loudly; anything else (an AssertionError) ends the run
        print(f"[dryrun] {arch} {shape} {mesh_kind} failed with "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
               "status": "error", "error_type": type(e).__name__,
               "traceback": traceback.format_exc()[-6000:]}
    cell_path(arch, shape, mesh_kind, args.tag).write_text(
        json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--tag", default="", help="results filename suffix")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat-group", type=int, default=1)
    ap.add_argument("--moments-dtype", default="float32")
    ap.add_argument("--accum-dtype", default="float32")
    args = ap.parse_args(argv)

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    if args.report:
        report(args.tag)
        return 0
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        todo = [(a, s, m) for a, s, m in all_cells(meshes)
                if args.force or not cell_path(a, s, m, args.tag).exists()]
        print(f"{len(todo)} cells to run")
        for i, (a, s, m) in enumerate(todo):
            t0 = time.time()
            rec = run_and_write(a, s, m, args)
            print(f"[{i + 1}/{len(todo)}] {a} {s} {m}: {rec['status']} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        return 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all/--report")
    failed = 0
    for m in meshes:
        rec = run_and_write(args.arch, args.shape, m, args)
        failed += rec["status"] == "error"
        short = {k: rec.get(k) for k in ("status", "microbatches", "reason",
                                         "arg_bytes_per_device",
                                         "local_bytes")}
        rl = rec.get("roofline", {})
        if rl:
            short.update({k: rl[k] for k in (
                "bottleneck", "roofline_fraction", "roofline_fraction_hw",
                "flops_per_device", "model_flops_global",
                "useful_flops_ratio")})
            short["count_s"] = rec["flop_count"]["count_s"]
        print(f"{args.arch} {args.shape} {m}: {json.dumps(short)}",
              flush=True)
    return 1 if failed else 0


def report(tag: str = ""):
    rows = []
    pat = f"*__{tag}.json" if tag else "*.json"
    for p in sorted(RESULTS_DIR.glob(pat)):
        if not tag and p.stem.count("__") > 2:     # a tagged run's cell
            continue
        r = json.loads(p.read_text())
        rl = r.get("roofline", {})
        coll = rl.get("collective_s")
        rows.append((r["arch"], r["shape"], r["mesh"], r.get("status"),
                     rl.get("bottleneck", "-"),
                     f"{rl.get('roofline_fraction_hw', 0):.3f}",
                     f"{rl.get('roofline_fraction', 0):.3f}",
                     f"{rl.get('compute_s', 0):.4f}",
                     f"{rl.get('memory_s', 0):.4f}",
                     "-" if coll is None else f"{coll:.4f}",
                     f"{rl.get('useful_flops_ratio', 0):.2f}",
                     f"{r.get('arg_bytes_per_device', 0):.4g}"))
    hdr = ("arch", "shape", "mesh", "status", "bneck", "roofline_hw",
           "mfu_frac", "compute_s", "memory_s", "coll_s", "useful",
           "arg_bytes_per_device")
    print(",".join(hdr))
    for row in rows:
        print(",".join(str(x) for x in row))


if __name__ == "__main__":
    sys.exit(main())
