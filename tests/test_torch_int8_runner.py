"""The int8 KV tier of the port's paged runner on the CPU.

* Against the reference's int8 PagedModelRunner: the same weights (bridged
  with ``from_jax_params``), requests and ServingConfig give equal token
  streams and equal store / runner counters under rotation, the prefix
  cache with rotation, and the pipelined engine.
* int8 against bf16 in the port: top-1 agreement >= 0.95 under rotation
  and the prefix cache (the reference's quality gate).
* The int8 PagedKVStore: (int8 row, fp32 scale row) tuples survive
  device -> host -> device movement and a D2D fork byte for byte, single-
  and double-buffered; and they ride swap-out, swap-in, migration to a
  second replica and abort (the port of tests/test_kv_quant.py's
  ``test_scale_rows_survive_swap_migrate_abort``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import GH200, ServingConfig, get_config  # noqa: E402
from repro.core.types import Request  # noqa: E402
from repro.serving.engine import ServingEngine  # noqa: E402
from repro.serving.paged_runner import PagedModelRunner  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.core.blocktable import BlockLoc, TransferDesc  # noqa: E402
from repro_torch.core.duplexkv import DuplexKV, prefix_hash_chain  # noqa: E402
from repro_torch.core.migration import MigrationEngine  # noqa: E402
from repro_torch.core.types import Request as TRequest  # noqa: E402
from repro_torch.models.params import from_jax_params, init_params  # noqa: E402
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
BS = 4

# name -> (hbm blocks, prefix cache, shared prefix, pipeline, request seed)
SCENARIOS = {
    "rotation": (16, False, 0, False, 3),
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


def make_requests(req_cls, seed, shared_prefix, vocab):
    rng = np.random.default_rng(seed)
    pref = ([int(x) for x in rng.integers(1, vocab, shared_prefix)]
            if shared_prefix else [])
    reqs = []
    for i in range(5):
        plen = int(rng.integers(8, 16))
        ids = pref + [int(x) for x in rng.integers(1, vocab, plen)]
        reqs.append(req_cls(req_id=i, arrival_time=0.02 * i,
                            prompt_len=len(ids),
                            output_len=int(rng.integers(10, 16)),
                            prompt_ids=ids))
    return reqs


def serving_kw(hbm, prefix_cache, pipeline, kv_dtype="int8"):
    return dict(num_hbm_blocks=hbm, num_dram_blocks=512,
                scheduler="rotasched", block_size=BS, max_model_len=64,
                prefill_chunk=8, paged_runner=True,
                prefix_cache=prefix_cache, pipeline=pipeline,
                kv_dtype=kv_dtype)


@pytest.fixture(scope="module")
def reference():
    """One reference int8 runner serves every scenario (its jit caches are
    shared, which keeps the interpret-mode compiles to a minimum)."""
    runner = PagedModelRunner(CFG, ServingConfig(**serving_kw(16, False,
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
            for r in make_requests(Request, seed, sp, CFG.vocab_size):
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
def test_int8_runner_matches_reference(reference, name):
    want = reference(name)
    hbm, pc, sp, pipe, seed = SCENARIOS[name]
    sv = tcfg.ServingConfig(**serving_kw(hbm, pc, pipe))
    params = from_jax_params(reference.runner._layers,
                             reference.runner._head, "cpu", torch.float32)
    runner = TPagedModelRunner(TCFG, sv, tcfg.GH200, timing_cfg=TCFG,
                               params=params, device="cpu")
    runner.record_margins = True
    eng = TServingEngine(TCFG, sv, tcfg.GH200, executor=runner)
    store = runner.store
    ptrs = (store.pool.data_ptr(), store.scales.data_ptr())
    for r in make_requests(TRequest, seed, sp, TCFG.vocab_size):
        eng.add_request(r)
    eng.drain(max_time_s=500)
    eng.kv.table.check_invariants()
    got = {r.req_id: list(r.generated_ids) for r in eng.core.submitted}
    assert got == want["streams"], first_divergence(want["streams"], got,
                                                    runner.margins)
    assert {c: getattr(store, c) for c in STORE_COUNTERS} == want["store"]
    assert {c: getattr(runner, c) for c in RUNNER_COUNTERS} == want["runner"]
    assert eng.stats.active_rotations + eng.stats.passive_preemptions \
        == want["rotations"] > 0
    assert store.quantized and store.pool.dtype == torch.int8
    assert store.d2h_rows > 0 and store.h2d_rows > 0
    # pool and scales were updated in place
    assert (store.pool.data_ptr(), store.scales.data_ptr()) == ptrs
    for v in store.host.values():
        assert isinstance(v, tuple) and v[0].dtype == torch.int8 \
            and v[1].dtype == torch.float32
    if pc:
        assert eng.kv.table.cache_hit_tokens == want["cache_hit_tokens"] > 0
    if pipe:
        assert store.double_buffer and eng.stats.overlap_ms > 0


def test_int8_top1_agreement_with_bf16():
    """The quality gate of the quantized tier (the reference's
    test_engine_int8_top1_agreement_under_rotation_and_prefix_cache): over
    three seeded workloads on the reduced llama (4 layers), the int8
    engine's tokens agree with the bf16 engine's on >= 95% of positions,
    with rotation and cache-hit blocks shared between requests."""
    cfg = dataclasses.replace(tcfg.get_config("llama3-8b").reduced(),
                              dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu",
                         torch.float32)
    same = total = 0
    for seed in (3, 5, 9):
        streams = {}
        for kv_dtype in ("bf16", "int8"):
            sv = tcfg.ServingConfig(**serving_kw(16, True, False, kv_dtype))
            runner = TPagedModelRunner(cfg, sv, tcfg.GH200, params=params,
                                       device="cpu")
            eng = TServingEngine(cfg, sv, tcfg.GH200, executor=runner)
            for r in make_requests(TRequest, seed, 12, cfg.vocab_size):
                eng.add_request(r)
            eng.drain(max_time_s=500)
            assert eng.stats.active_rotations \
                + eng.stats.passive_preemptions > 0
            assert eng.kv.table.cache_hit_tokens > 0
            streams[kv_dtype] = {r.req_id: list(r.generated_ids)
                                 for r in eng.core.submitted}
        for rid, ref in streams["bf16"].items():
            for x, y in zip(ref, streams["int8"][rid]):
                same += int(x == y)
                total += 1
    assert total > 100
    assert same / total >= 0.95, f"top-1 agreement {same}/{total}"


# ------------------------------------------------------------ the store

def _desc(i, src, dst):
    return TransferDesc(block_id=i, req_id=0, direction="d2h", src_slot=src,
                        dst_slot=dst, nbytes=1, segments=1)


@pytest.mark.parametrize("double_buffer,staging", [(False, 4), (True, 8)])
def test_int8_store_roundtrip_and_fork(double_buffer, staging):
    """int8 rows and their fp32 scale rows survive device -> host ->
    device movement and a CoW D2D fork byte for byte (movement never
    requantizes), in place, through single- and double-buffered staging;
    the footprint counts the scales."""
    sv = tcfg.ServingConfig(num_hbm_blocks=16, num_dram_blocks=64,
                            block_size=BS, max_model_len=64)
    store = PagedKVStore(TCFG, sv, torch.float32, device="cpu",
                         staging=staging, double_buffer=double_buffer,
                         kv_dtype="int8")
    assert store.pool.dtype == torch.int8
    assert store.scales.shape == (store.pool.shape[0], TCFG.num_layers, 2,
                                  TCFG.num_kv_heads)
    assert store.pool_global_bytes == store.pool_shard_bytes == (
        store.pool.numel() + 4 * store.scales.numel())
    ptrs = (store.pool.data_ptr(), store.scales.data_ptr())
    rng = np.random.default_rng(0)
    n = 5                                   # > 2 chunks: exercises alternation
    rows = torch.from_numpy(rng.integers(-127, 128, (n,) + store.row_shape,
                                         dtype=np.int8))
    srows = torch.from_numpy(rng.uniform(
        1e-3, 2.0, (n,) + store.scale_row_shape).astype(np.float32))
    store.pool[:n], store.scales[:n] = rows, srows
    store.run_d2h([_desc(i, i, 100 + i) for i in range(n)])
    for i in range(n):
        v, s = store.host[100 + i]
        assert torch.equal(v, rows[i]) and torch.equal(s, srows[i])
    store.pool[:n] = 0
    store.scales[:n] = 0
    store.run_h2d([_desc(i, 100 + i, 8 + i) for i in range(n)])
    assert torch.equal(store.pool[8:8 + n], rows)
    assert torch.equal(store.scales[8:8 + n], srows)
    store.run_d2d([(8, 7)])
    assert torch.equal(store.pool[7], rows[0])
    assert torch.equal(store.scales[7], srows[0])
    assert (store.pool.data_ptr(), store.scales.data_ptr()) == ptrs
    with pytest.raises(RuntimeError, match="lost copy"):
        store.run_h2d([_desc(9, 99, 0)])


def _mk_kv_with_store(hbm=8, dram=64):
    sv = tcfg.ServingConfig(num_hbm_blocks=hbm, num_dram_blocks=dram,
                            block_size=BS, max_model_len=64,
                            prefix_cache=True, paged_runner=True,
                            kv_dtype="int8")
    kv = DuplexKV(TCFG, sv, tcfg.GH200)
    store = PagedKVStore(TCFG, sv, torch.float32, device="cpu", staging=8,
                         kv_dtype="int8")
    kv.attach_data_backend(store)
    return kv, store


def _prefill_on(kv, rid, ids):
    """Table-level prefill (the disagg-test idiom): alloc + hash chain."""
    kv.lookup_prefix(rid, ids)
    kv.plan_iteration([], [], 0.0)
    need = -(-len(ids) // BS) - len(kv.table.blocks_of(rid))
    if need > 0:
        kv.table.alloc(rid, need)
    kv._chains.setdefault(rid, prefix_hash_chain(ids, BS))
    kv.sync_progress(rid, len(ids))


def _stamp_rows(store, blocks):
    """Give each HBM-resident block row a recognizable int8 fill + scale."""
    for b in blocks:
        fill = (b.block_id % 100) + 1
        store.pool[b.hbm_slot] = fill
        store.scales[b.hbm_slot] = fill / 64.0


def _assert_rows_match(store, blocks):
    for b in blocks:
        fill = (b.block_id % 100) + 1
        assert torch.all(store.pool[b.hbm_slot] == fill), \
            f"block {b.block_id} values"
        assert torch.all(store.scales[b.hbm_slot] == fill / 64.0), \
            f"block {b.block_id} scales"


def _assert_conserved(table):
    table.check_invariants()
    hbm_used = sum(1 for b in table._blocks.values()
                   if b.hbm_slot is not None
                   and (b.loc in (BlockLoc.HBM, BlockLoc.BOTH)
                        or b.h2d_inflight))
    dram_used = sum(1 for b in table._blocks.values()
                    if b.dram_slot is not None
                    and (b.loc in (BlockLoc.DRAM, BlockLoc.BOTH)
                         or b.d2h_inflight))
    assert hbm_used + len(table._hbm_free) == table.num_hbm_blocks
    assert dram_used + len(table._dram_free) == table.num_dram_blocks


def test_scale_rows_survive_swap_migrate_abort():
    """(int8 row, scale row) tuples ride swap-out, swap-in, migration to a
    second replica (by reference) and abort — values AND scales restored
    exactly at each hop, slot accounting conserved on both tables."""
    rng = np.random.default_rng(SEED)
    ids = [int(x) for x in rng.integers(1, TCFG.vocab_size, 3 * BS + 2)]
    a, store_a = _mk_kv_with_store()
    b, store_b = _mk_kv_with_store()
    _prefill_on(a, 1, ids)
    blocks = a.table.blocks_of(1)
    _stamp_rows(store_a, blocks)

    # swap out: every block's tuple lands in the host tier
    a.plan_iteration([1], [], 0.0)
    for blk in a.table.blocks_of(1):
        assert blk.loc in (BlockLoc.DRAM, BlockLoc.BOTH)
        v = store_a.host[blk.dram_slot]
        assert isinstance(v, tuple) and v[0].dtype == torch.int8 \
            and v[1].dtype == torch.float32
    _assert_conserved(a.table)

    # swap in: int8 values and fp32 scales restored exactly
    a.plan_iteration([], [1], 0.0)
    live = a.table.blocks_of(1)
    assert all(blk.loc in (BlockLoc.HBM, BlockLoc.BOTH) for blk in live)
    _assert_rows_match(store_a, live)
    _assert_conserved(a.table)

    # migrate to replica b: the payload tuples travel inside the export, by
    # reference
    held = {id(v) for v in store_a.host.values()}
    me = MigrationEngine()
    assert me.can_migrate(1, a, b)
    me.migrate(1, a, b, t=0.0)
    assert not a.table.blocks_of(1)
    _assert_conserved(a.table)
    got = b.table.blocks_of(1)
    assert len(got) == len(blocks)
    for blk in got:
        v = store_b.host[blk.dram_slot]
        assert isinstance(v, tuple) and id(v) in held
    _assert_conserved(b.table)

    # swap in on b: the stamped content crossed replicas intact
    b.plan_iteration([], [1], 0.0)
    _assert_rows_match(store_b, b.table.blocks_of(1))
    _assert_conserved(b.table)

    # abort on the final owner: all slots return to the free lists
    b.finish(1)
    assert not b.table.blocks_of(1)
    _assert_conserved(b.table)
    _assert_conserved(a.table)
