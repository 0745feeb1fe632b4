"""The port's PagedModelRunner against the reference PagedModelRunner on the
CPU: the same weights (bridged with ``from_jax_params``), the same requests
and the same ServingConfig must give equal token streams and equal store /
launch counters, in five scenarios (ample HBM, rotation, prefix cache with
and without rotation, pipelined). Plus the PagedKVStore's row movement,
its lost-copy error, and in-place pool updates."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import GH200, ServingConfig, get_config  # noqa: E402
from repro.core.types import Request  # noqa: E402
from repro.serving.engine import ServingEngine  # noqa: E402
from repro.serving.paged_runner import PagedModelRunner  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.core.blocktable import TransferDesc  # noqa: E402
from repro_torch.core.duplexkv import DuplexKV  # noqa: E402
from repro_torch.core.types import Request as TRequest  # noqa: E402
from repro_torch.models.params import from_jax_params  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TServingEngine  # noqa: E402
from repro_torch.serving.paged_runner import PagedKVStore  # noqa: E402
from repro_torch.serving.paged_runner import \
    PagedModelRunner as TPagedModelRunner  # noqa: E402

# two layers keep the reference's interpret-mode compiles short; every
# other width is llama3-8b.reduced()
CFG = dataclasses.replace(get_config("llama3-8b").reduced(), dtype="float32",
                          num_layers=2)
TCFG = dataclasses.replace(tcfg.get_config("llama3-8b").reduced(),
                           dtype="float32", num_layers=2)
SEED = 42

# name -> (hbm blocks, prefix cache, shared prefix, pipeline, request seed)
SCENARIOS = {
    "ample": (128, False, 0, False, 3),
    "rotation": (16, False, 0, False, 3),
    "prefix_cache": (128, True, 12, False, 3),
    "prefix_cache_rotation": (16, True, 12, False, 3),
    "pipeline": (14, True, 12, True, 7),
}
STORE_COUNTERS = ("copy_launches", "d2d_rows", "d2h_rows", "h2d_rows")
RUNNER_COUNTERS = ("decode_batches", "decode_tokens", "attn_launches",
                   "prefill_chunks_run")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # tiny CPU tensors: a thread pool costs far more than it saves
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_requests(req_cls, seed, shared_prefix):
    rng = np.random.default_rng(seed)
    pref = ([int(x) for x in rng.integers(1, CFG.vocab_size, shared_prefix)]
            if shared_prefix else [])
    reqs = []
    for i in range(5):
        plen = int(rng.integers(8, 16))
        ids = pref + [int(x) for x in rng.integers(1, CFG.vocab_size, plen)]
        reqs.append(req_cls(req_id=i, arrival_time=0.02 * i,
                            prompt_len=len(ids),
                            output_len=int(rng.integers(10, 16)),
                            prompt_ids=ids))
    return reqs


def serving_kw(hbm, prefix_cache, pipeline):
    return dict(num_hbm_blocks=hbm, num_dram_blocks=512,
                scheduler="rotasched", block_size=4, max_model_len=64,
                prefill_chunk=8, paged_runner=True,
                prefix_cache=prefix_cache, pipeline=pipeline)


@pytest.fixture(scope="module")
def reference():
    """One reference runner serves every scenario (its jit caches are
    shared, which keeps the interpret-mode compiles to a minimum); results
    are computed once per scenario."""
    runner = PagedModelRunner(CFG, ServingConfig(**serving_kw(128, False,
                                                              False)),
                              GH200, seed=SEED, timing_cfg=CFG)
    results = {}

    def run(name):
        if name not in results:
            hbm, pc, sp, pipe, seed = SCENARIOS[name]
            sv = ServingConfig(**serving_kw(hbm, pc, pipe))
            runner.serving = sv           # bind() sizes the store from it
            for c in RUNNER_COUNTERS:
                setattr(runner, c, 0)
            eng = ServingEngine(CFG, sv, GH200, executor=runner)
            for r in make_requests(Request, seed, sp):
                eng.add_request(r)
            eng.drain(max_time_s=500)
            results[name] = dict(
                streams={r.req_id: list(r.generated_ids)
                         for r in eng.core.submitted},
                store={c: getattr(runner.store, c) for c in STORE_COUNTERS},
                runner={c: getattr(runner, c) for c in RUNNER_COUNTERS},
                rotations=(eng.stats.active_rotations
                           + eng.stats.passive_preemptions),
                cache_hit_tokens=eng.kv.table.cache_hit_tokens)
        return results[name]

    run.runner = runner
    return run


def run_port(name, ref_runner):
    hbm, pc, sp, pipe, seed = SCENARIOS[name]
    sv = tcfg.ServingConfig(**serving_kw(hbm, pc, pipe))
    params = from_jax_params(ref_runner._layers, ref_runner._head, "cpu",
                             torch.float32)
    runner = TPagedModelRunner(TCFG, sv, tcfg.GH200, timing_cfg=TCFG,
                               params=params, device="cpu")
    runner.record_margins = True
    eng = TServingEngine(TCFG, sv, tcfg.GH200, executor=runner)
    ptr = runner.store.pool.data_ptr()
    for r in make_requests(TRequest, seed, sp):
        eng.add_request(r)
    eng.drain(max_time_s=500)
    eng.kv.table.check_invariants()
    return eng, runner, ptr


def first_divergence(want, got, margins):
    for rid in sorted(want):
        a, b = want[rid], got.get(rid, [])
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                m = margins.get(rid, [])
                return (f"req {rid} step {i}: reference {x}, port {y}, port "
                        f"top-2 margin {m[i] if i < len(m) else 'n/a'}")
        if len(a) != len(b):
            return f"req {rid}: lengths {len(a)} vs {len(b)}"
    return None


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_runner_matches_reference(reference, name):
    want = reference(name)
    eng, runner, ptr = run_port(name, reference.runner)
    got = {r.req_id: list(r.generated_ids) for r in eng.core.submitted}
    assert got == want["streams"], first_divergence(want["streams"], got,
                                                    runner.margins)
    assert {c: getattr(runner.store, c) for c in STORE_COUNTERS} \
        == want["store"]
    assert {c: getattr(runner, c) for c in RUNNER_COUNTERS} == want["runner"]
    # updates were in place: the pool's storage never moved
    assert runner.store.pool.data_ptr() == ptr
    # one batched paged-attention launch per layer per decode iteration
    assert runner.attn_launches == runner.decode_batches * TCFG.num_layers
    rot = eng.stats.active_rotations + eng.stats.passive_preemptions
    assert rot == want["rotations"]
    hbm, pc, _, pipe, _ = SCENARIOS[name]
    if hbm < 128:
        assert rot > 0, "no rotation: the scenario is vacuous"
        assert runner.store.d2h_rows > 0 and runner.store.h2d_rows > 0
    if pc:
        assert eng.kv.table.cache_hit_tokens == want["cache_hit_tokens"] > 0
    if pipe:
        assert runner.store.double_buffer and eng.stats.overlap_ms > 0


# ------------------------------------------------------------ the store

def _desc(i, src, dst):
    return TransferDesc(block_id=i, req_id=0, direction="d2h", src_slot=src,
                        dst_slot=dst, nbytes=1, segments=1)


@pytest.mark.parametrize("double_buffer,staging", [(False, 4), (True, 8)])
def test_store_roundtrip_in_place_and_lost_copy(double_buffer, staging):
    """Rows survive device -> host -> device movement bit-exactly through
    single- and double-buffered staging, CoW D2D duplicates rows, every
    movement updates the pool in place, and an H2D from an empty DRAM slot
    raises."""
    sv = tcfg.ServingConfig(num_hbm_blocks=16, num_dram_blocks=64,
                            block_size=4, max_model_len=64)
    store = PagedKVStore(TCFG, sv, torch.float32, device="cpu",
                         staging=staging, double_buffer=double_buffer)
    ptr = store.pool.data_ptr()
    rng = np.random.default_rng(0)
    n = 5                                   # > 2 chunks: exercises alternation
    rows = torch.from_numpy(
        rng.standard_normal((n,) + store.row_shape).astype(np.float32))
    store.pool[:n] = rows
    store.run_d2h([_desc(i, i, 100 + i) for i in range(n)])
    assert set(store.host) == {100 + i for i in range(n)}
    for i in range(n):
        torch.testing.assert_close(store.host[100 + i], rows[i], rtol=0,
                                   atol=0)
    store.run_h2d([_desc(i, 100 + i, 8 + i) for i in range(n)])
    torch.testing.assert_close(store.pool[8:8 + n], rows, rtol=0, atol=0)
    store.run_d2d([(8, 7)])
    torch.testing.assert_close(store.pool[7], rows[0], rtol=0, atol=0)
    assert store.d2h_rows == n and store.h2d_rows == n and store.d2d_rows == 1
    assert store.pool.data_ptr() == ptr
    with pytest.raises(RuntimeError, match="lost copy"):
        store.run_h2d([_desc(9, 99, 0)])


def test_store_staging_checks():
    sv = tcfg.ServingConfig(num_hbm_blocks=8, num_dram_blocks=32,
                            block_size=4, max_model_len=64)
    with pytest.raises(ValueError, match="power of two"):
        PagedKVStore(TCFG, sv, torch.float32, device="cpu", staging=6)
    with pytest.raises(ValueError, match="double_buffer"):
        PagedKVStore(TCFG, sv, torch.float32, device="cpu", staging=2,
                     double_buffer=True)
    store = PagedKVStore(TCFG, sv, torch.float32, device="cpu", staging=8,
                         double_buffer=True)
    assert (store.d2h_chunk, store.h2d_chunk, store.h2d_base) == (2, 4, 12)
    assert store.trash_row == 16 and store.pool.shape[0] == 17


def test_runner_refuses_unported_and_unsupported():
    sv = tcfg.ServingConfig(num_hbm_blocks=16, block_size=4)
    ssm = dataclasses.replace(tcfg.get_config("mamba2-2.7b").reduced(),
                              dtype="float32")
    with pytest.raises(ValueError, match="dense-attention"):
        TPagedModelRunner(ssm, sv, device="cpu")
    # the int8 KV tier is ported: accepted, and its pool is int8
    sv8 = dataclasses.replace(sv, kv_dtype="int8")
    int8 = TPagedModelRunner(TCFG, sv8, device="cpu")
    int8.bind(DuplexKV(TCFG, sv8, tcfg.GH200))
    assert int8.store.quantized and int8.store.pool.dtype == torch.int8
    # tensor parallelism is ported: tp=2 builds on the CPU's two logical
    # shards, binds, and holds a pool of Hkv/2 heads per shard
    sv2 = dataclasses.replace(sv, tp=2)
    tp2 = TPagedModelRunner(TCFG, sv2, device="cpu")
    tp2.bind(DuplexKV(TCFG, sv2, tcfg.GH200))
    assert tp2.tp_plan.shard_kv and len(tp2.store.pools) == 2
    for pool in tp2.store.pools:
        assert pool.shape[1:] == (TCFG.num_layers, 2, 4,
                                  TCFG.num_kv_heads // 2, TCFG.head_dim)
    assert tp2.store.pool_shard_bytes * 2 == tp2.store.pool_global_bytes
