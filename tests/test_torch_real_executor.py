"""The port's dense per-request ``RealExecutor`` behind ``EngineCore``
against the reference's on the CPU: the same weights (bridged with
``from_jax_lm_params``), requests and ServingConfig give equal token
streams with ample HBM and under rotation, for llama3-8b.reduced() and for
gemma3-1b.reduced() at six layers (prompts longer than its 32-token
window). Plus the swap contract (mid-prefill sentinel, loud errors for a
lost cache), the adapter, and agreement of the port's paged runner with
its dense executor on the same seed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as rc  # noqa: E402
from repro.core.types import Request  # noqa: E402
from repro.serving.engine import ServingEngine  # noqa: E402
from repro.serving.executor import RealExecutor as RefRealExecutor  # noqa: E402

import repro_torch.configs as tc  # noqa: E402
from repro_torch.core.types import Request as TRequest  # noqa: E402
from repro_torch.models.params import from_jax_lm_params  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TServingEngine  # noqa: E402
from repro_torch.serving.executor import (BatchPlan,  # noqa: E402
                                          ExecutionResult, RealExecutor,
                                          RealExecutorAdapter, SimExecutor)

SEED = 42
# arch -> (config overrides, prompt and output length ranges, tight HBM
# blocks); gemma3's lengths take few values, since the jitted reference
# compiles once per prompt length and cache capacity
CASES = {"llama3-8b": ({}, ((8, 16), (10, 16)), 16),
         "gemma3-1b": ({"num_layers": 6}, ((37, 38), (12, 14)), 20)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # tiny CPU tensors: a thread pool costs far more than it saves
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(arch):
    kw = CASES[arch][0]
    return (dataclasses.replace(rc.get_config(arch).reduced(),
                                dtype="float32", **kw),
            dataclasses.replace(tc.get_config(arch).reduced(),
                                dtype="float32", **kw))


def make_requests(req_cls, vocab, lens):
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(5):
        ids = [int(x) for x in rng.integers(1, vocab,
                                            int(rng.integers(*lens[0])))]
        reqs.append(req_cls(req_id=i, arrival_time=0.02 * i,
                            prompt_len=len(ids),
                            output_len=int(rng.integers(*lens[1])),
                            prompt_ids=ids))
    return reqs


def serving(configs, hbm, paged=False):
    return configs.ServingConfig(num_hbm_blocks=hbm, num_dram_blocks=512,
                                 scheduler="rotasched", block_size=4,
                                 max_model_len=64, prefill_chunk=8,
                                 paged_runner=paged)


def run(engine_cls, configs, req_cls, cfg, real, hbm, lens, paged=False):
    eng = engine_cls(cfg, serving(configs, hbm, paged), configs.GH200,
                     real_executor=real, runner_cfg=cfg, runner_seed=SEED,
                     **({} if engine_cls is ServingEngine
                        else {"device": "cpu"}))
    for r in make_requests(req_cls, cfg.vocab_size, lens):
        eng.add_request(r)
    eng.drain(max_time_s=500)
    eng.kv.table.check_invariants()
    streams = {r.req_id: list(r.generated_ids) for r in eng.core.submitted}
    return streams, eng.stats.active_rotations + eng.stats.passive_preemptions


def reference_streams(ref_cfg, hbm, lens):
    """The reference engine over its RealExecutor, with the executor's LM
    calls jitted (the same functions, compiled once per shape instead of
    traced op by op on every call)."""
    ref = RefRealExecutor(ref_cfg, seed=SEED)
    ref.lm.prefill = jax.jit(ref.lm.prefill, static_argnums=2)
    ref.lm.decode_step = jax.jit(ref.lm.decode_step)
    streams, rot = run(ServingEngine, rc, Request, ref_cfg, ref, hbm, lens)
    return streams, rot, ref.params


@pytest.mark.parametrize("arch", sorted(CASES))
def test_streams_equal_reference_with_and_without_rotation(arch):
    """The reference runs once, under rotation; the port runs with ample
    HBM (no rotation) and with the same tight HBM (the same rotations),
    and both emit the reference's streams."""
    ref_cfg, cfg = cfgs(arch)
    _, lens, tight = CASES[arch]
    want, rot_ref, ref_params = reference_streams(ref_cfg, tight, lens)
    assert rot_ref > 0
    params = from_jax_lm_params(ref_params, cfg, "cpu")
    for hbm in (4096, tight):
        got, rot = run(TServingEngine, tc, TRequest, cfg,
                       RealExecutor(cfg, device="cpu", params=params), hbm,
                       lens)
        assert got == want, f"hbm {hbm}"
        assert rot == (rot_ref if hbm == tight else 0)


def test_paged_runner_agrees_with_dense_executor():
    """One seed, one model: the port's paged runner (init_params) and its
    dense executor (init_lm_params) emit the same streams, as the
    reference's tests/test_paged_runner.py asserts for the reference."""
    _, cfg = cfgs("llama3-8b")
    lens = CASES["llama3-8b"][1]
    dense, _ = run(TServingEngine, tc, TRequest, cfg,
                   RealExecutor(cfg, seed=SEED, device="cpu"), 4096, lens)
    for hbm in (4096, 16):
        paged, _ = run(TServingEngine, tc, TRequest, cfg, None, hbm, lens,
                       paged=True)
        assert paged == dense, f"hbm {hbm}"


def test_mid_prefill_swap_roundtrip_and_lost_cache_is_loud():
    """A request rotated out before its prefill ran resumes cleanly; a
    token-bearing request whose cache vanished fails loudly on swap_out,
    swap_in and decode, as the reference's does."""
    _, cfg = cfgs("llama3-8b")
    ex1 = RealExecutor(cfg, seed=7, device="cpu")
    ex2 = RealExecutor(cfg, seed=7, device="cpu")
    prompt = list(range(1, 9))
    t_plain = ex1.prefill(1, prompt, 32)
    ex2.swap_out(1)                 # mid-prefill: no cache yet — legal
    ex2.swap_in(1)
    assert ex2.prefill(1, prompt, 32) == t_plain
    assert ex2.decode(1, t_plain, len(prompt)) == ex1.decode(
        1, t_plain, len(prompt))
    # a swap round trip copies every cache tensor byte for byte
    before = [{k: t.clone() for k, t in c.items()} for c in ex2._caches[1]]
    ex2.swap_out(1)
    assert 1 not in ex2._caches and all(
        t.device.type == "cpu" for c in ex2._host[1] for t in c.values())
    ex2.swap_in(1)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(before, ex2._caches[1])
               for k in a)
    assert ex2._caches[1][0]["k"].data_ptr() != before[0]["k"].data_ptr()

    ex = RealExecutor(cfg, seed=7, device="cpu")
    ex.prefill(1, list(range(1, 9)), 32)
    ex._caches.pop(1)               # simulate the lost-cache state
    with pytest.raises(RuntimeError, match="lost"):
        ex.swap_out(1)
    with pytest.raises(RuntimeError, match="without a KV"):
        ex.swap_in(1)
    with pytest.raises(RuntimeError, match="no device cache"):
        ex.decode(1, 3, 8)


def test_adapter_forwards_lifecycle_and_skips_idless_requests():
    class FakeReal:
        def __init__(self):
            self.dropped = []

        def prefill(self, rid, toks, capacity):
            return 5

        def decode(self, rid, tok, cl):
            return 6

        def swap_out(self, rid):
            pass

        def swap_in(self, rid):
            pass

        def drop(self, rid):
            self.dropped.append(rid)

    _, cfg = cfgs("llama3-8b")
    fake = FakeReal()
    ad = RealExecutorAdapter(fake, SimExecutor(cfg, tc.GH200))
    assert not ad.supports_prefix_cache
    ad.drop(3)
    assert fake.dropped == [3]
    r = TRequest(req_id=0, arrival_time=0.0, prompt_len=4, output_len=2)
    out = ad.execute(BatchPlan(prefill_chunks=[(0, 4)], prefill_tokens=4),
                     {0: r})
    assert isinstance(out, ExecutionResult)
    assert out.tokens == {}         # no prompt_ids -> oracle mode, no token
