"""The port's host layer (scheduler, block table, DuplexKV, engine core,
SimExecutor) replays the reference's golden trace exactly: the sim-mode
report row of ``ServingEngine.run`` on qwen2.5-32b, with the ServingConfig
``launch/serve.py`` builds from its defaults, equals the reference's in
every field (the trace tests/test_pipeline.py pins)."""
import pytest

pytest.importorskip("torch")


def serve_defaults(configs):
    return configs.ServingConfig(
        num_hbm_blocks=4000, num_dram_blocks=100000, scheduler="rotasched",
        rotary=configs.RotaSchedConfig(alpha=3.0, beta_b=0.0, beta_f=0.5,
                                       b_xfer=2400),
        auto_b_xfer=True, duplex=True, eager_rotation=True,
        block_first_layout=True, batched_transfer_kernel=True,
        pipeline_overlap=True, pipeline=False, prefix_cache=False,
        paged_runner=False, tp=1, kv_dtype="bf16", telemetry=False)


def run(configs, engine, workload):
    eng = engine.ServingEngine(configs.get_config("qwen2.5-32b"),
                               serve_defaults(configs), configs.GH200)
    return eng.run(workload.generate_requests("sharegpt", 20, 10, seed=0)
                   ).row()


def test_sim_report_row_equals_reference():
    import repro.configs as rc
    import repro.serving.engine as re_
    import repro.serving.workload as rw
    import repro_torch.configs as tc
    import repro_torch.serving.engine as te
    import repro_torch.serving.workload as tw
    want = run(rc, re_, rw)
    got = run(tc, te, tw)
    assert got == want
    assert want["n"] == 200
    assert want["total_time_s"] == 30.602083992290844   # the golden replay


@pytest.mark.parametrize("field,value", [("telemetry", True), ("tp", 2)])
def test_unported_serving_options_raise(field, value):
    """tp > 1 is not ported and raises. The flight recorder is ported
    now: with telemetry on, the engine builds and carries its bus."""
    import dataclasses
    import repro_torch.configs as tc
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.telemetry import TelemetryBus
    sv = dataclasses.replace(serve_defaults(tc), **{field: value})
    if field == "telemetry":
        eng = ServingEngine(tc.get_config("qwen2.5-32b"), sv, tc.GH200)
        assert isinstance(eng.telemetry, TelemetryBus)
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        ServingEngine(tc.get_config("qwen2.5-32b"), sv, tc.GH200)


def test_real_executor_is_not_ported():
    """The dense per-request RealExecutor is ported now: ``real_executor=``
    is wrapped in the protocol adapter, timed by a SimExecutor, and the
    prefix cache is forced off under it, as in the reference. (The name
    dates from when ``real_executor=`` raised; this is what it checks
    now.)"""
    import dataclasses
    import repro_torch.configs as tc
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.executor import RealExecutorAdapter, SimExecutor
    real = object()
    sv = dataclasses.replace(serve_defaults(tc), prefix_cache=True)
    eng = ServingEngine(tc.get_config("qwen2.5-32b"), sv, tc.GH200,
                        real_executor=real)
    ex = eng.core.executor
    assert isinstance(ex, RealExecutorAdapter) and ex.real is real
    assert isinstance(ex.sim, SimExecutor)
    assert eng.core._prefix_cache is False
