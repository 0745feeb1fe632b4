"""One run of one cell: set-up, open-loop load, the window, the check.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
its configuration file (the entry's ``file``),
``portbench/traffic/<traffic>.json``, ``portbench/cells/<workload>.json``
(the limits of its check) and one reader a metric,
``portbench/metrics/<base>.py``. A new cell, mix or metric is new files and
entries, never an edit here.

The system under test is the port's serving stack: an
``AsyncServingEngine`` over ``ServingEngine`` with the ``PagedModelRunner``
on the benchmark's weights (RotaSched, DuplexKV and ``PagedKVStore``
underneath). Clients are asyncio tasks in this process; each request is
timed from the moment it was due, on the host's monotonic clock.
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import importlib.util
import json
import threading
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Set, Tuple

import numpy as np

from portbench import hostload, loadgen, trace as tracing, weights as wdraw
from portbench.costs import Dims
from portbench.record import ClientRecord, RunRecord

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_S = 6.0            # the traced span: the window's last seconds
WARM_PROMPTS = 8         # requests that warm the kernels before the load

# the configuration file's keys (the published config.json's names) and
# the program's ModelConfig fields they are checked against
SIZE_KEYS = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
             "num_attention_heads": "num_heads",
             "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
             "intermediate_size": "d_ff", "vocab_size": "vocab_size",
             "rope_theta": "rope_theta", "rms_norm_eps": "rms_eps",
             "tie_word_embeddings": "tie_embeddings",
             "torch_dtype": "dtype"}
COUNTERS = (("runner", ("decode_batches", "decode_tokens", "attn_launches",
                        "prefill_chunks_run", "decode_launch_wall_s",
                        "prefill_launch_wall_s")),
            ("store", ("d2h_rows", "h2d_rows", "d2d_rows", "copy_launches",
                       "copy_launch_wall_s", "upload_launch_wall_s")))


@dataclasses.dataclass
class Cell:
    name: str
    entry: Mapping
    config: Mapping
    traffic: Mapping
    check: Mapping
    dims: Dims


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = load_bench(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic"
                          / f"{entry['traffic']}.json").read_text())
    check = json.loads((root / "portbench" / "cells"
                        / f"{workload}.json").read_text())
    dims = Dims(layers=config["num_hidden_layers"],
                d_model=config["hidden_size"],
                heads=config["num_attention_heads"],
                kv_heads=config["num_key_value_heads"],
                head_dim=config["head_dim"],
                d_ff=config["intermediate_size"],
                vocab=config["vocab_size"],
                block_size=traffic["serving"]["block_size"])
    return Cell(workload, entry, config, traffic, check, dims)


def metric_reader(base: str, root: Path = ROOT):
    """``read`` of ``portbench/metrics/<base>.py``, loaded by path."""
    path = root / "portbench" / "metrics" / f"{base}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{base}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(workload: str, traced: bool, root: Path = ROOT
                 ) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end ones
    untraced, its per-layer ones traced."""
    bench = load_bench(root)
    pool = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in pool if workload in m.get("workloads", [workload])]


def registry_config(arch_id: str):
    """The port's registered ModelConfig of ``arch_id``."""
    from repro_torch.configs.base import get_config
    return get_config(arch_id)


def program_config(cell: Cell):
    """The program's ModelConfig of the cell, held against the file: the
    run stops if the port's registry has other sizes."""
    cfg = registry_config(cell.config["registry_id"])
    bad = {k: (v, getattr(cfg, f)) for k, f in SIZE_KEYS.items()
           for v in [cell.config[k]] if getattr(cfg, f) != v}
    if bad:
        raise SystemExit(f"{cfg.name}: the port's registry differs from "
                         f"{cell.entry['config']}'s file (file, registry): "
                         f"{bad}")
    return cfg


def serving_config(cell: Cell):
    from repro_torch.configs.base import ServingConfig
    s = cell.traffic["serving"]
    return ServingConfig(block_size=s["block_size"],
                         num_hbm_blocks=s["num_hbm_blocks"],
                         num_dram_blocks=s["num_dram_blocks"],
                         max_batch_size=s["max_batch_size"],
                         prefill_chunk=s["prefill_chunk"],
                         scheduler=s["scheduler"], kv_dtype=s["kv_dtype"],
                         max_model_len=s["max_model_len"])


def build_engine(cell: Cell, params, device, sv=None):
    """The system under test on ``params``; returns the ServingEngine."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paged_runner import PagedModelRunner
    cfg = program_config(cell)
    sv = sv or serving_config(cell)
    runner = PagedModelRunner(cfg, sv, params=params, device=device)
    return ServingEngine(cfg, sv, executor=runner)


def warm(engine, cell: Cell) -> None:
    """Load and launch every kernel before the first arrival: a prompt of
    two full prefill chunks (the second attends the first through the
    pool) and a few short ones decoded together."""
    from repro_torch.core.types import SamplingParams
    rng = np.random.default_rng(0)
    chunk = cell.traffic["serving"]["prefill_chunk"]
    lens = [min(2 * chunk, cell.traffic["lengths"]["in_max"])] + \
        [16 + 8 * i for i in range(WARM_PROMPTS - 1)]
    for n in lens:
        engine.add_request(
            prompt_ids=rng.integers(1, cell.dims.vocab, n).tolist(),
            sampling_params=SamplingParams(max_tokens=4, ignore_eos=True))
    engine.drain()


def counters(engine) -> Dict[str, float]:
    core = getattr(engine, "core", engine)
    out = {"iterations": float(core.stats.iterations)}
    for owner, names in COUNTERS:
        obj = core.executor if owner == "runner" else core.executor.store
        out.update({n: float(getattr(obj, n)) for n in names})
    return out


def rotated_back(engine) -> Set[int]:
    """Requests that were rotated out to the host tier and have run again:
    running, or finished, after a rotation."""
    from repro_torch.core.types import RequestState
    core = getattr(engine, "core", engine)
    return {r.req_id for r in core.submitted if r.rotations > 0 and (
        r.state == RequestState.RUNNING or (
            r.state == RequestState.FINISHED and not r.aborted))}


KV_DTYPES = {"bf16": "bfloat16", "fp16": "float16", "fp32": "float32",
             "int8": "int8"}


def kv_departures(engine, kv_dtype: str) -> int:
    """KV tensors held in another dtype than the traffic file's
    ``kv_dtype``: each pool shard and each row of the host tier (of an int8
    row, its values; its scales are fp32 by design). A store whose tensors
    cannot be found counts as one departure."""
    import torch
    want = getattr(torch, KV_DTYPES[kv_dtype])
    store = getattr(engine, "core", engine).executor.store
    found = list(getattr(store, "pools", []))
    host = getattr(store, "host", {})
    rows = host.values() if isinstance(host, dict) else [host]
    found += [r[0] if isinstance(r, tuple) else r for r in rows]
    found = [t for t in found if isinstance(t, torch.Tensor)]
    if not found:
        return 1
    return sum(t.dtype != want for t in found)


@dataclasses.dataclass
class Drive:
    """What the load phase hands back."""
    requests: List[ClientRecord]
    snaps: Dict[str, Tuple[float, Dict[str, float]]]
    prof: object
    lateness: List[float]
    back: Set[int]               # rotated out and back by the close
    host: Dict[str, float]       # hostload's readings over the window
    kv_departures: int           # at the close, kv_departures()


async def _drive(engine, cell: Cell, specs, seconds: float, traced: bool,
                 t_zero_cb) -> Drive:
    from repro_torch.core.types import SamplingParams
    from repro_torch.serving.async_engine import AsyncServingEngine
    service = AsyncServingEngine(engine, pace=False)
    await service.start()
    limits = cell.traffic["slo_ttft_s"]
    warm_s = float(cell.traffic["warm_s"])
    w1_rel = warm_s + seconds
    t0 = time.monotonic()
    t_zero_cb(t0)
    recs = [ClientRecord(due=s.due, slo_class=s.slo_class,
                         ttft_limit_s=float(limits[s.slo_class]),
                         prompt_len=len(s.prompt_ids),
                         max_tokens=s.max_tokens) for s in specs]
    snaps: Dict[str, Tuple[float, Dict[str, float]]] = {}
    box = {"prof": None, "host": {}}
    loop_tid = threading.get_native_id()

    def now() -> float:
        return time.monotonic() - t0

    async def until(t: float) -> None:
        d = t - now()
        if d > 0:
            await asyncio.sleep(d)

    async def client(spec, rec: ClientRecord) -> None:
        await until(spec.due)
        rec.sent = now()
        try:
            h = await service.submit(
                prompt_ids=spec.prompt_ids, slo_class=spec.slo_class,
                sampling_params=SamplingParams(max_tokens=spec.max_tokens,
                                               ignore_eos=True))
            rec.req_id = h.req_id
            async for ev in h.stream():
                t = now()
                for tok in ev.new_token_ids:
                    rec.token_times.append(t)
                    rec.token_ids.append(int(tok))
                if ev.finished:
                    rec.finish_reason = ("cut" if ev.finish_reason ==
                                         "aborted" and t >= w1_rel
                                         else ev.finish_reason)
        except Exception as e:          # the run reports it as failed
            rec.error = f"{type(e).__name__}: {e}"

    async def snapshot(key: str, prof_op: Optional[str] = None) -> None:
        """Counters and the time, read on the driver thread between two
        iterations; the profiler starts before the reading and stops
        after it (stopping takes seconds)."""
        def fn(eng):
            if prof_op == "start":
                box["prof"] = tracing.start()
            snap = now(), counters(eng)
            box["host"][key] = hostload.sample(threading.get_native_id(),
                                               loop_tid)
            if key == "w1":
                box["back"] = rotated_back(eng)
                box["kv"] = kv_departures(
                    eng, cell.traffic["serving"]["kv_dtype"])
            if prof_op == "stop":
                box["prof"].stop()
            return snap
        snaps[key] = await service.call(fn)

    tasks = [asyncio.ensure_future(client(s, r)) for s, r in zip(specs, recs)]
    await until(warm_s)
    await snapshot("w0")
    if traced:
        await until(w1_rel - min(TRACE_S, seconds / 2))
        await snapshot("ts", "start")
    await until(w1_rel)
    await snapshot("w1", "stop" if traced else None)
    await service.shutdown(drain_timeout_s=0.0)
    await asyncio.gather(*tasks)
    lateness = [r.sent - r.due for r in recs if r.sent is not None]
    return Drive(recs, snaps, box["prof"], lateness, box["back"],
                 hostload.delta(box["host"]["w0"], box["host"]["w1"]),
                 box["kv"])


def sample_for_check(recs: List[ClientRecord], back: Set[int],
                     check: Mapping, seed: int) -> List[ClientRecord]:
    """Served requests for the reference, drawn from ``seed``: the longest
    finished one, the one rotated out and back with the most tokens served
    by the close (finished or not), then finished ones in random order
    until ``check_tokens`` served tokens, within ``check_positions``
    positions in all."""
    done = [r for r in recs if r.finished]
    size = lambda r: r.prompt_len + len(r.token_ids)  # noqa: E731
    picks = [max(done, key=size)] if done else []
    rot = [r for r in recs if r.req_id in back and r.token_ids
           and not r.failed]
    if rot:
        best = max(rot, key=lambda r: len(r.token_ids))
        if best not in picks:
            picks.append(best)
    rng = np.random.default_rng([int(seed), 0xC4EC])
    for i in rng.permutation(len(done)):
        if sum(len(r.token_ids) for r in picks) >= check["check_tokens"]:
            break
        r = done[int(i)]
        if r in picks or (sum(size(p) for p in picks) + size(r)
                          > check["check_positions"]):
            continue
        picks.append(r)
    return picks


def reference_check(params, cell: Cell, sample: List[ClientRecord],
                    prompts: Dict[int, List[int]], device,
                    control: bool = False) -> dict:
    """The widest gap of the sample's served tokens below the reference's
    best logit (and the fp8 control's, with ``control``)."""
    from portbench.reference.model import served_gaps
    import torch
    t = time.monotonic()
    gaps, ctl = served_gaps(
        params, float(cell.config["rms_norm_eps"]),
        float(cell.config["rope_theta"]),
        [prompts[id(r)] for r in sample], [r.token_ids for r in sample],
        device, control=control)
    g = torch.cat(gaps)
    out = {"widest_gap": float(g.max()), "mean_gap": float(g.mean()),
           "tokens_off_argmax": int((g > 0).sum()),
           "served_tokens": int(g.numel()),
           "positions": sum(r.prompt_len + len(r.token_ids)
                            for r in sample),
           "requests": len(sample), "reference_s": time.monotonic() - t}
    if ctl is not None:
        c = torch.cat(ctl)
        out["control_widest_gap"] = float(c.max())
        out["control_mean_gap"] = float(c.mean())
    return out


@dataclasses.dataclass
class Outcome:
    """A run's record, its check and its device readings."""
    rec: RunRecord
    check: dict
    sample_rotated: int
    lateness: List[float]
    memory_peak_bytes: int
    failed: int
    host: Dict[str, float]
    kv_departures: int


def one_thread() -> None:
    """One intra-op thread for the process: the program's host-side copies
    of its host tier would otherwise wake a team of OpenMP threads, which
    took about a core beside the engine's driver thread (PERF.md,
    section 2)."""
    import torch
    torch.set_num_threads(1)


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device, proc_start: float, root: Path = ROOT,
             control: bool = False, sv=None) -> Outcome:
    """One run of ``workload``; ``proc_start`` is the process's start on
    the monotonic clock (set-up is counted from it)."""
    import torch
    cell = load_cell(workload, root)
    on_card = torch.device(device).type == "cuda"
    params = wdraw.draw(cell.dims, seed, device)
    engine = build_engine(cell, params, device, sv=sv)
    warm(engine, cell)
    specs = loadgen.schedule(cell.traffic, seconds, seed, cell.dims.vocab)
    if traced and on_card:              # CUPTI's first start is slow
        tracing.start().stop()
    if on_card:
        torch.cuda.synchronize()
    box = {}
    drive = asyncio.run(_drive(engine, cell, specs, seconds, traced,
                               lambda t: box.setdefault("t0", t)))
    t0 = box["t0"]
    warm_s = float(cell.traffic["warm_s"])
    snaps = drive.snaps
    end = "ts" if traced else "w1"
    trace_sum = None
    if traced and drive.prof is not None and on_card:
        trace_sum = tracing.reduce(drive.prof, snaps["ts"][0], snaps["w1"][0])
    rec = RunRecord(dims=cell.dims, w0=warm_s, w1=warm_s + seconds,
                    span=(snaps["w0"][0], snaps[end][0]),
                    counters={"start": snaps["w0"][1], "end": snaps[end][1]},
                    requests=drive.requests, setup_s=t0 - proc_start,
                    trace=trace_sum)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    prompts = {id(r): s.prompt_ids for s, r in zip(specs, drive.requests)}
    sample = sample_for_check(drive.requests, drive.back, cell.check, seed)
    n_rot = sum(r.req_id in drive.back for r in sample)
    lateness, host, kv = drive.lateness, drive.host, drive.kv_departures
    del engine, drive
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    check = (reference_check(params, cell, sample, prompts, device,
                             control=control) if sample else
             {"widest_gap": None, "served_tokens": 0, "requests": 0})
    failed = sum(r.failed for r in rec.requests)
    return Outcome(rec, check, n_rot, lateness, peak, failed, host, kv)


def verdict(cell: Cell, out: Outcome) -> Tuple[bool, Dict[str, dict]]:
    """``correct`` and each number compared, beside its limit: an upper
    one, but for the served tokens checked and the checked requests that
    were rotated out to the host tier and back, which have to reach
    theirs."""
    lim = cell.check
    gap = out.check["widest_gap"]        # None: nothing was served
    nums = {"widest_gap": {"value": gap, "limit": lim["gap_limit"]},
            "served_tokens_checked": {"value": out.check["served_tokens"],
                                      "limit": lim["check_tokens_min"]},
            "rotated_back_checked": {"value": out.sample_rotated,
                                     "limit": lim["rotated_back_min"]},
            "failed_requests": {"value": out.failed, "limit": 0},
            "kv_dtype_departures": {"value": out.kv_departures, "limit": 0}}
    ok = (gap is not None and gap <= lim["gap_limit"]
          and out.check["served_tokens"] >= lim["check_tokens_min"]
          and out.sample_rotated >= lim["rotated_back_min"]
          and out.failed == 0 and out.kv_departures == 0)
    return bool(ok), nums


def control_outcome(out: Outcome) -> Outcome:
    """The run as the fp8 control would have served it: the control's
    widest gap, read on the same prompts and served tokens, in the
    program's place."""
    check = dict(out.check, widest_gap=out.check["control_widest_gap"])
    return dataclasses.replace(out, check=check)
