"""The serving engine's wall-clock counters and profiler ranges, on the
tiny paged runner on the CPU with a pool small enough to rotate: the
phases partition each step, each non-idle step opens each phase's range
once, queue waits and rotation returns are counted per request, eager
demotion's rows are told apart from the rest, and the flight recorder's
wall stamps, on the profiler's clock, lie inside the matching ranges.
Counts and containment only, never wall ratios: nothing here depends on
how fast the machine runs."""
import asyncio
import dataclasses
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.core.types import SamplingParams  # noqa: E402
from repro_torch.serving.async_engine import AsyncServingEngine  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.paged_runner import PagedModelRunner  # noqa: E402
from repro_torch.serving.telemetry import PHASES  # noqa: E402
from repro_torch.serving.trace_export import (  # noqa: E402
    REQ_TRACK_BASE, SIM_CLOCK, TRACK_PHASES, TRACK_STEP, WALL_CLOCK,
    trace_from_cores)

CFG = dataclasses.replace(tcfg.get_config("llama3-8b").reduced(),
                          dtype="float32", num_layers=2)
RANGED = ("schedule", "kv_plan", "commit")
TOL_NS = 1_000_000          # the clock conversion's allowance: 1 ms


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def engine(eager=True, telemetry=False, pipeline=False):
    """The tiny engine: 16 HBM blocks of 4 tokens for five requests of up
    to 30 tokens, so RotaSched rotates and rows move both ways."""
    sv = tcfg.ServingConfig(num_hbm_blocks=16, num_dram_blocks=512,
                            scheduler="rotasched", block_size=4,
                            max_model_len=64, prefill_chunk=8,
                            paged_runner=True, eager_rotation=eager,
                            telemetry=telemetry, pipeline=pipeline)
    runner = PagedModelRunner(CFG, sv, tcfg.GH200, seed=42, timing_cfg=CFG,
                              device="cpu")
    return ServingEngine(CFG, sv, tcfg.GH200, executor=runner)


def requests(seed=3):
    rng = np.random.default_rng(seed)
    for i in range(5):
        ids = [int(x) for x in rng.integers(1, CFG.vocab_size,
                                            int(rng.integers(8, 16)))]
        yield i, ids, SamplingParams(max_tokens=int(rng.integers(10, 16)))


def run(eng):
    """Submit the requests, step to the end; the non-idle steps taken."""
    core = eng.core
    for i, ids, sp in requests():
        core.add_request(prompt_ids=ids, sampling_params=sp,
                         arrival_time=0.02 * i)
    steps = 0
    while core.has_work:
        steps += not core.step().idle
    core.kv.table.check_invariants()
    return steps


def ranges(prof, name):
    """(start, end) Unix-epoch ns of each ``name`` range, in order."""
    out = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() == name]
    return sorted(out)


@pytest.fixture(scope="module")
def traced():
    """One run of the tiny engine, flight recorder on, under the
    profiler: (engine, non-idle steps, profiler)."""
    eng = engine(telemetry=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps = run(eng)
    return eng, steps, prof


def test_phases_partition_each_step():
    eng = engine()
    core = eng.core
    steps = run(eng)
    w = core.wall_counters()
    assert steps == core.stats.iterations > 0
    assert abs(sum(w[f"{p}_wall_s"] for p in PHASES)
               - w["step_wall_s"]) <= 1e-9
    assert all(w[f"{p}_wall_s"] > 0 for p in PHASES)
    # idle steps count in no wall counter
    before = core.wall_counters()
    assert core.step().idle and core.wall_counters() == before


def test_each_step_opens_each_phase_range_once(traced):
    eng, steps, prof = traced
    store = eng.core.executor.store
    for phase in RANGED:
        assert len(ranges(prof, f"superinfer.{phase}")) == steps
    assert 0 < len(ranges(prof, "superinfer.sync")) <= steps
    # the store's new ranges sit inside the ones that were there
    assert len(ranges(prof, "superinfer.kv_stack")) == len(
        ranges(prof, "superinfer.kv_upload")) > 0
    assert len(ranges(prof, "superinfer.kv_readback")) > 0
    assert store.readback_wall_s <= store.copy_launch_wall_s
    assert store.kv_stack_wall_s <= store.upload_launch_wall_s


def test_queue_waits_and_rotation_returns_are_counted_per_request():
    eng = engine()
    run(eng)
    core = eng.core
    w = core.wall_counters()
    planned = [r for r in core.submitted if r.wall_first_chunk_ns is not None]
    assert w["queue_waits"] == len(planned) == len(core.submitted) == 5
    assert all(r.wall_submit_ns <= r.wall_first_chunk_ns for r in planned)
    assert w["queue_wait_wall_s"] >= 0
    rotated = core.stats.active_rotations + core.stats.passive_preemptions
    assert 0 < w["rotation_returns"] <= rotated
    assert w["rotated_out_wall_s"] > 0
    assert all(r.wall_rotated_ns is None for r in core.submitted)


@pytest.mark.parametrize("eager,pipeline", [(True, False), (True, True),
                                            (False, False)],
                         ids=["eager", "eager-pipelined", "no-eager"])
def test_eager_rows_apart_from_rotation(eager, pipeline):
    """Eager demotion's rows, in the iteration or carried across it
    (pipelined), are a part of the store's rows to the host tier."""
    eng = engine(eager=eager, pipeline=pipeline)
    run(eng)
    w = eng.core.wall_counters()
    store = eng.core.executor.store
    assert store.d2h_rows > 0
    assert w["eager_d2h_rows"] <= store.d2h_rows
    if eager:
        assert w["eager_d2h_rows"] > 0 and w["eager_d2h_wall_s"] > 0
    else:
        assert w["eager_d2h_rows"] == w["eager_d2h_wall_s"] == 0


def test_wall_counters_leave_the_benchmark_counters_alone():
    """The names are new beside the benchmark harness's, which read the
    same objects."""
    from portbench.harness import COUNTERS
    eng = engine()
    run(eng)
    w = eng.core.wall_counters()
    assert set(w) == {f"{p}_wall_s" for p in PHASES} | {
        "step_wall_s", "queue_wait_wall_s", "queue_waits",
        "rotated_out_wall_s", "rotation_returns", "sync_wall_s",
        "readback_wall_s", "kv_stack_wall_s", "eager_d2h_rows",
        "eager_d2h_wall_s"}
    harness = {"iterations"} | {n for _, names in COUNTERS for n in names}
    assert not set(w) & harness


def test_event_wall_stamps_lie_inside_the_profiler_ranges(traced):
    eng, steps, prof = traced
    bus = eng.core.telemetry
    events = list(bus.events)
    assert len(events) == steps and bus.wall_offset_ns is not None
    got = {p: ranges(prof, f"superinfer.{p}") for p in RANGED}
    for i, e in enumerate(events):
        t = e.wall_start_ns + bus.wall_offset_ns
        for phase in PHASES:
            end = t + round(getattr(e, f"{phase}_wall_s") * 1e9)
            if phase in got:
                lo, hi = got[phase][i]
                assert lo - TOL_NS <= t <= end <= hi + TOL_NS, (i, phase)
            t = end
        assert abs(t - (e.wall_end_ns + bus.wall_offset_ns)) <= 4


def test_trace_export_is_on_the_profiler_clock(traced, tmp_path):
    """``write_trace`` (and ``/v1/trace``, which serves
    ``trace_from_cores``) lays a paged-runner engine out on the wall:
    each phase slice inside its profiler range, each request's spans on
    its own track, the clock named in the metadata."""
    eng, steps, prof = traced
    trace = eng.write_trace(str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == trace
    assert trace == trace_from_cores([eng.core])
    assert trace["otherData"]["clock"] == WALL_CLOCK
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert sum(e["tid"] == TRACK_STEP for e in xs) == steps
    for phase in RANGED:
        got = ranges(prof, f"superinfer.{phase}")
        mine = sorted((e["ts"], e["ts"] + e["dur"]) for e in xs
                      if e["tid"] == TRACK_PHASES
                      and e["name"].startswith(phase + "#"))
        assert len(mine) == len(got) == steps
        for (a, b), (lo, hi) in zip(mine, got):
            assert lo - TOL_NS <= a * 1e3 <= b * 1e3 <= hi + TOL_NS, phase
    kinds = {e["name"] for e in trace["traceEvents"]
             if e.get("tid", 0) >= REQ_TRACK_BASE and e["ph"] in "Xi"}
    assert {"ADMIT", "PREFILL", "DECODE", "ROTATE_OUT", "ROTATE_IN",
            "FINISH"} <= kinds


def test_sim_engine_keeps_the_sim_clock():
    sv = tcfg.ServingConfig(telemetry=True)
    eng = ServingEngine(tcfg.get_config("qwen2.5-32b"), sv, tcfg.GH200)
    assert eng.core.telemetry.wall_offset_ns is None
    assert trace_from_cores([eng.core])["otherData"]["clock"] == SIM_CLOCK


def test_async_submission_is_stamped_at_the_call():
    """Through the asyncio front door the stamp is taken when ``submit``
    is called, before the driver thread registers the request."""
    eng = engine()
    stamps = []

    async def main():
        service = AsyncServingEngine(eng, pace=False)
        await service.start()
        try:
            for _, ids, sp in list(requests())[:2]:
                t = time.monotonic_ns()
                h = await service.submit(prompt_ids=ids, sampling_params=sp)
                stamps.append((t, h.req_id))
                await h.result()
        finally:
            await service.shutdown(drain_timeout_s=5.0)

    asyncio.run(main())
    core = eng.core
    for t, rid in stamps:
        r = next(r for r in core.submitted if r.req_id == rid)
        assert t <= r.wall_submit_ns <= r.wall_first_chunk_ns
    assert core.wall_counters()["queue_waits"] == 2
