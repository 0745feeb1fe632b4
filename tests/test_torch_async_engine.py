"""The port's ``AsyncServingEngine`` against the reference's on the CPU.

The same request list, with explicit arrival times, goes through each
package's ``AsyncServingEngine(pace=False)`` over a sim-mode ``EngineCore``:
every streamed event (token counts, finish reasons, engine times) and the
report row must be equal. The port's service then shows its admission,
abort, drain and driver-claim semantics."""
import asyncio
import dataclasses
import threading

import pytest

pytest.importorskip("torch")

import repro.configs as rc  # noqa: E402
import repro.serving.async_engine as ra  # noqa: E402
import repro.serving.core as rcore  # noqa: E402
import repro.serving.server as rserver  # noqa: E402
from repro.core.types import SamplingParams as RSamplingParams  # noqa: E402

import repro_torch.configs as tc  # noqa: E402
import repro_torch.serving.async_engine as ta  # noqa: E402
import repro_torch.serving.core as tcore  # noqa: E402
import repro_torch.serving.server as tserver  # noqa: E402
from repro_torch.core.types import SamplingParams  # noqa: E402

PKGS = {"reference": (rc, ra, rcore, rserver, RSamplingParams),
        "port": (tc, ta, tcore, tserver, SamplingParams)}

# (arrival time, prompt_len, max_tokens, slo class)
REQUESTS = [(0.0, 512, 24, "interactive"), (0.0, 96, 40, "standard"),
            (0.01, 1500, 12, "interactive"), (0.02, 64, 64, "batch"),
            (0.05, 700, 30, "standard"), (0.05, 32, 8, "interactive"),
            (0.2, 2048, 16, "standard"), (0.3, 128, 48, "interactive")]


def make_core(configs, core_mod, hbm=256):
    return core_mod.EngineCore(
        configs.get_config("llama3-8b"),
        configs.ServingConfig(num_hbm_blocks=hbm, num_dram_blocks=2048),
        configs.GH200)


def run_replay(pkg):
    """Submit REQUESTS while the driver is held inside a ``call`` (so all
    of them register before the first step), then stream every handle to
    its end. Returns ({req_id: [event dicts]}, report row, unfinished)."""
    configs, amod, core_mod, server_mod, SP = PKGS[pkg]
    core = make_core(configs, core_mod)

    async def scenario():
        svc = amod.AsyncServingEngine(core, pace=False)
        await svc.start()
        gate = threading.Event()
        held = asyncio.ensure_future(svc.call(lambda eng: gate.wait(30)))
        subs = [asyncio.ensure_future(svc.submit(
            plen, sampling_params=SP(max_tokens=mt), slo_class=cls,
            arrival_time=t)) for t, plen, mt, cls in REQUESTS]
        await asyncio.sleep(0)           # every submit is now enqueued
        gate.set()
        assert await held is True
        handles = await asyncio.gather(*subs)
        events = {}
        for h in handles:
            events[h.req_id] = [dataclasses.asdict(e)
                                async for e in h.stream()]
        row = await svc.call(server_mod.snapshot_report_row)
        left = await svc.shutdown(drain_timeout_s=30)
        return events, row, left

    return asyncio.run(scenario())


def test_event_sequence_and_report_row_equal_reference():
    want = run_replay("reference")
    got = run_replay("port")
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2] == []
    events = got[0]
    assert len(events) == len(REQUESTS)
    for (_, _, mt, cls), evts in zip(REQUESTS, events.values()):
        assert evts[-1]["finished"] and evts[-1]["finish_reason"] == "length"
        assert sum(e["new_tokens"] for e in evts) == mt
        assert evts[-1]["slo_class"] == cls
    assert got[1]["n"] == len(REQUESTS)


def test_abort_drain_admission_and_driver_claim():
    """Abort mid-stream frees the request's blocks; the driver claim makes
    the blocking surfaces refuse; shutdown with a request that cannot
    finish in the drain deadline aborts it and returns its id; submissions
    while draining and after the stop are refused; the claim is released
    and the blocking API works again."""
    core = make_core(tc, tcore, hbm=8192)
    hbm0 = core.kv.hbm_free_blocks

    async def scenario():
        svc = ta.AsyncServingEngine(core, pace=False)
        await svc.start()
        with pytest.raises(RuntimeError, match="already started"):
            await svc.start()
        # abort mid-stream: the stream ends "aborted", blocks come back
        h = await svc.submit(64, sampling_params=SamplingParams(
            max_tokens=100000))
        n = 0
        async for e in h.stream():
            n += 1
            if n == 2:
                assert await h.abort() is True
            if e.finished:
                break
        assert e.finish_reason == "aborted" and h.finished
        assert await svc.call(lambda eng: eng.kv.hbm_free_blocks) == hbm0
        # the engine is claimed: blocking surfaces refuse loudly
        with pytest.raises(RuntimeError, match="AsyncServingEngine"):
            core.drain()
        # a request that cannot finish inside the drain deadline
        long = await svc.submit(64, sampling_params=SamplingParams(
            max_tokens=100000))
        first = await long.stream().__anext__()
        assert not first.finished
        stop = asyncio.ensure_future(svc.shutdown(drain_timeout_s=0.3))
        await asyncio.sleep(0)
        assert svc.draining
        with pytest.raises(ta.ServiceDraining):
            await svc.submit(16, sampling_params=SamplingParams(max_tokens=2))
        left = await stop
        assert left == [long.req_id]
        final = await long.result()
        assert final.finished and final.finish_reason == "aborted"
        with pytest.raises(ta.ServiceStopped):
            await svc.submit(16, sampling_params=SamplingParams(max_tokens=2))
        with pytest.raises(ta.ServiceStopped):
            await svc.call(lambda eng: None)
        assert await svc.shutdown() == []      # idempotent once stopped
        assert not svc.started and svc.crashed is None

    asyncio.run(scenario())
    assert core.kv.hbm_free_blocks == hbm0
    # claim released: the legacy blocking API works again
    h2 = core.add_request(prompt_len=16,
                          sampling_params=SamplingParams(max_tokens=3))
    assert h2.result().tokens_generated == 3


def test_driver_crash_reaches_streams_and_health():
    """An engine exception on the driver thread fails every open stream with
    ServiceStopped and is kept as ``crashed``; submissions then raise."""
    core = make_core(tc, tcore)

    def boom():
        raise ValueError("injected engine fault")

    async def scenario():
        svc = ta.AsyncServingEngine(core, pace=False)
        await svc.start()
        gate = threading.Event()
        held = asyncio.ensure_future(svc.call(lambda eng: gate.wait(30)))
        sub = asyncio.ensure_future(svc.submit(
            64, sampling_params=SamplingParams(max_tokens=50)))
        await asyncio.sleep(0)
        core.step = boom                 # the next iteration raises
        gate.set()
        await held
        h = await sub
        with pytest.raises(ta.ServiceStopped, match="crashed"):
            async for _ in h.stream():
                pass
        assert isinstance(svc.crashed, ValueError)
        with pytest.raises(ta.ServiceStopped):
            await svc.submit(16, sampling_params=SamplingParams(max_tokens=2))
        with pytest.raises(ta.ServiceStopped):
            await svc.shutdown()

    asyncio.run(scenario())
