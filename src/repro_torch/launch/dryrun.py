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
- on both meshes, the collective bytes one position receives in the
  step (``collective_detail_full_compile``, the reference's key): the
  step runs on the mesh itself, every one of its 256 or 512 positions a
  ``torch.device("meta")`` (``launch.mesh.make_mesh``), its inputs laid
  out under the cell's rules, and ``distributed/spmd.py`` counts what
  each collective delivers (``count_collectives``). The busiest
  position's count is recorded, by kind;
- the roofline of those terms on an H100 (``launch/roofline.py``), with
  the memory term from ``analytic_memory_bytes`` and the collective term
  from the single-pod mesh's count.

The reference compiles each cell for 512 forced host devices and reads
XLA's cost analysis, which counts a ``lax.scan`` body once, so it
extrapolates from shallow unrolled compiles (``extrapolate_costs``). The
FLOP counter sees every layer of the port's Python loop, so the FLOPs
need no extrapolation. The collectives do, for time: one meta step over
512 positions runs every position's operations from one host thread
(each position after the first takes its results' shapes from
``_MetaMemo``), so ``collective_costs`` counts at one and at two periods
of the layer pattern and extrapolates linearly, ``c1 + (periods - 1)
(c2 - c1)``, the reference's two-point rule; a train step counts one
microbatch and multiplies by their number (every collective of the step
lies in a microbatch's forward and backward). A meta cell needs no
process of its own, so ``--all`` runs the cells in this process.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --report

Each cell writes results/dryrun_torch/<arch>__<shape>__<mesh>.json (cached;
``--force`` recomputes). A cell that fails records its traceback.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import sys
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ARCH_IDS
from repro_torch.distributed.sharding import (is_axes_leaf, mesh_axis_size,
                                              pspec_for, rules_for_shape,
                                              sharding_ctx, shards_of)
from repro_torch.distributed import spmd
from repro_torch.kernels import ops
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import attention
from repro_torch.models.api import make_step_bundle
from repro_torch.models.lm import LM, build_program, check_mesh_support
from repro_torch.optimizer.adamw import AdamWConfig, TensorSpec
from repro_torch.training.step import make_train_step
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


def mesh_step(bundle, cfg, mesh):
    """The cell's step over ``mesh`` (a mesh of devices): the train step
    with the bundle's microbatches, moments and accumulation, or
    ``LM.prefill`` / ``LM.decode_step`` with ``mesh=``."""
    meta = bundle.static_meta
    lm = LM(cfg, remat_group=meta.get("remat_group", 1))
    check_mesh_support(mesh, bundle.kind)
    if bundle.kind == "train":
        return make_train_step(
            lm, AdamWConfig(moments_dtype=meta["moments_dtype"]),
            microbatches=meta["microbatches"],
            accum_dtype=meta["accum_dtype"], mesh=mesh)
    if bundle.kind == "prefill":
        return lambda params, batch: lm.prefill(params, batch,
                                                meta["capacity"], mesh=mesh)
    return lambda params, caches, batch: lm.decode_step(params, caches,
                                                        batch, mesh=mesh)


def placed_args(bundle, mesh, rules, device):
    """The step's arguments over ``mesh``: zeros on ``device`` (``meta``:
    nothing allocated) for every ``TensorSpec``, the weights, the train
    state and a decode's caches laid out by their logical axes under
    ``rules``, the batch whole; a decode's ``cache_len`` the last slot of
    its cache."""
    def zeros(s):
        if torch.device(device).type == "meta":     # no values to fill
            return torch.empty(s.shape, dtype=s.dtype, device=device)
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    args = [tree_map(zeros, a, is_leaf=lambda x: isinstance(x, TensorSpec))
            for a in bundle.args_structs]
    for i in range(len(args) - 1):
        args[i] = spmd.place_tree(args[i], bundle.args_axes[i], mesh, rules)
    if bundle.kind == "decode":
        args[-1]["cache_len"] = bundle.static_meta["capacity"] - 1
    return args


def _memo_key(args):
    """A key of an operation's arguments: a meta tensor by its shape,
    strides and dtype, a list by its items, anything else by its type and
    value; ``None`` where a tensor is not on meta."""
    keys = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if not a.is_meta:
                return None
            keys.append((a.shape, a.stride(), a.dtype))
        elif isinstance(a, (list, tuple)):
            k = _memo_key(a)
            if k is None:
                return None
            keys.append(k)
        else:
            keys.append((type(a), a))
    return tuple(keys)


@functools.lru_cache(maxsize=None)
def _fresh(func) -> bool:
    """Whether ``func`` writes into no input and returns no view."""
    schema = func._schema
    return not schema.is_mutable and all(r.alias_info is None
                                         for r in schema.returns)


class _MetaMemo(TorchDispatchMode):
    """On meta tensors, an operation that returns fresh tensors gives
    empty ones of the shapes, strides and dtypes it gave the last time it
    met the same arguments (``_memo_key``). Every position of a meta mesh
    runs the same operations on pieces of the same shapes, and meta runs
    many of them as Python references (hundreds of microseconds each), so
    all but the first position's skip them. ``count_collectives`` runs a
    step over hundreds of meta positions under it; a test holds its
    counts equal to the same step's on real tensors."""

    def __init__(self):
        super().__init__()
        self.made = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = hit = None
        if _fresh(func):
            key = (func, _memo_key(args), _memo_key(kwargs.values()),
                   tuple(kwargs))
            if None in key[1:3]:        # a tensor not on meta
                key = None
            else:
                try:
                    hit = self.made.get(key)
                except TypeError:       # an argument without a value key
                    key = None
        if hit is not None:
            many, outs = hit
            made = [torch.empty_strided(size, stride, dtype=dtype,
                                        device="meta")
                    for size, stride, dtype in outs]
            return tuple(made) if many else made[0]
        out = func(*args, **kwargs)
        many = isinstance(out, tuple)
        ts = out if many else (out,)
        if key is not None and all(isinstance(t, torch.Tensor)
                                   and t.device.type == "meta" for t in ts):
            self.made[key] = many, [(tuple(t.shape), t.stride(), t.dtype)
                                    for t in ts]
        return out


@contextlib.contextmanager
def _one_backward_chunk():
    """The plain flash backward over all its query rows at once: it
    chunks them to bound the scores it holds, which meta does not hold,
    and the gradients' shapes (all that a collective sees) are the
    same."""
    keep = attention.BWD_CHUNK_Q
    attention.BWD_CHUNK_Q = sys.maxsize
    try:
        yield
    finally:
        attention.BWD_CHUNK_Q = keep


def count_collectives(bundle, cfg, mesh_desc, rules, device="meta") -> dict:
    """Run the cell's step once over ``mesh_desc``'s axes with every
    position on ``device`` (on meta, under ``_MetaMemo`` and
    ``_one_backward_chunk``): the busiest position's collective bytes by
    kind (the most in all), every position's (``per_position``),
    ``positions`` and the seconds it took (``count_s``)."""
    mesh = make_mesh(mesh_desc.axis_sizes, mesh_desc.axis_names,
                     [device] * mesh_desc.size)
    ops.reset_meta_costs()
    t0 = time.time()
    spmd.reset_collective_bytes()
    with contextlib.ExitStack() as stack:
        if torch.device(device).type == "meta":
            stack.enter_context(_MetaMemo())
            stack.enter_context(_one_backward_chunk())
        mesh_step(bundle, cfg, mesh)(*placed_args(bundle, mesh, rules,
                                                  device))
    per = [spmd.collective_bytes(r) for r in range(mesh.size)]
    spmd.reset_collective_bytes()
    ops.reset_meta_costs()
    out = dict(max(per, key=lambda c: sum(c.values())))
    return {"bytes": out, "per_position": per, "positions": len(per),
            "count_s": round(time.time() - t0, 2)}


def collective_costs(cfg, shape, mesh_desc, rules, mb: int, opts,
                     device="meta") -> dict:
    """The step's collective bytes a position at full depth, from
    ``count_collectives`` at one and at two periods of the layer pattern
    (``depth_variant``) extrapolated linearly to ``num_layers / period``
    periods; a train step at one microbatch's batch, times ``mb``."""
    p = period_len(cfg)
    X = cfg.num_layers / p
    if shape.kind == "train":
        one_shape = dataclasses.replace(
            shape, global_batch=shape.global_batch // mb)
        times = mb
    else:
        one_shape, times = shape, 1
    counts = []
    for periods in (1, 2):
        var = depth_variant(cfg, periods, p)
        with sharding_ctx(mesh_desc, rules):
            b = make_step_bundle(var, one_shape, microbatches=1, **opts)
        counts.append(count_collectives(b, var, mesh_desc, rules, device))
    c1, c2 = (c["bytes"] for c in counts)
    full = {k: times * (c1[k] + (X - 1) * (c2[k] - c1[k])) for k in c1}
    return {"bytes": full, "period_len": p, "periods_full": X,
            "counted_microbatches": 1, "microbatches": times,
            "positions": counts[0]["positions"],
            "count_s": round(sum(c["count_s"] for c in counts), 2)}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             microbatches=None, opt_flags=None, count: bool = True) -> dict:
    """One cell's record. ``count=False`` skips the FLOP and collective
    counts and the roofline (bytes only). The collective bytes are
    counted on both meshes; FLOPs and the roofline are for the single-pod
    mesh, as in the reference."""
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
    if count:
        cc = collective_costs(cfg, shape, mesh, rules,
                              rec.get("microbatches", 1), opts)
        rec["collective_detail_full_compile"] = cc.pop("bytes")
        rec["collective_count"] = cc
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
            rec["collective_detail_full_compile"], mem_model)
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
                                         "local_bytes",
                                         "collective_detail_full_compile")}
        if "collective_count" in rec:
            short["collective_count_s"] = rec["collective_count"]["count_s"]
        rl = rec.get("roofline", {})
        if rl:
            short.update({k: rl[k] for k in (
                "bottleneck", "roofline_fraction", "roofline_fraction_hw",
                "flops_per_device", "model_flops_global",
                "useful_flops_ratio", "collective_s")})
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
