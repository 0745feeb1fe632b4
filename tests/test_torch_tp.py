"""Tensor parallelism of the port's paged serving path (``repro_torch/
distributed/tp.py``, ``launch/hostenv.py``, ``launch/mesh.py::
make_tp_mesh``, the sharded ``PagedKVStore`` and ``PagedModelRunner``) on
the CPU, against the reference. The matrix of ``tests/test_tp_runner.py``
with its configs (``BASE``, ``FALLBACK_CFG``, ``SEED``; 16 HBM blocks of
4 tokens, chunks of 8, 5 requests from numpy seed 3):

* the plan contract, and the plan, its errors and specs equal to the
  reference's for every config at tp 1..16;
* the port's streams at tp 2 and 4 under rotation equal the reference's
  single-device streams (in process, one XLA device), with the reference's
  weights (``from_jax_params``);
* the same streams, transfer counters, plan and pool bytes equal the
  reference's own sharded runs, ``run_engine(2)`` and the fallback's
  ``run_engine(4)``, in a subprocess with four forced XLA host devices;
* rotation, prefix cache and the pipelined engine all on, tp=2 against
  the reference's tp=1; the replicated-attention fallback at tp=4;
* the pool footprint and transfer counters per shard, launch-count
  invariance, the sharded store's round trip (the host tier holds the full
  global row, bitwise), the device-count error's recipe;
* int8 at tp=2: streams equal tp=1's; each shard's scales are the kv-head
  slice of tp=1's, bitwise in the first layer and for a direct store of the
  same tokens, within fp32 rounding after (the all-reduce rounds the
  residual stream);
* the sim CLI at ``--tp 2`` and ``--tp 4`` (``--device cpu``): rows equal
  the reference's (its CLI in a subprocess)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from test_tp_runner import FALLBACK_CFG, run_engine  # noqa: E402

import repro.configs as rc  # noqa: E402
import repro.distributed.tp as rtp  # noqa: E402

import repro_torch.configs as tc  # noqa: E402
import repro_torch.distributed.tp as ttp  # noqa: E402
from repro_torch.core.blocktable import TransferDesc  # noqa: E402
from repro_torch.core.types import Request  # noqa: E402
from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.kernels.quant import quant_store_tokens  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.hostenv import ensure_host_devices  # noqa: E402
from repro_torch.launch.mesh import make_tp_mesh  # noqa: E402
from repro_torch.models.params import from_jax_params  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.paged_runner import (PagedKVStore,  # noqa: E402
                                              PagedModelRunner)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TBASE = dataclasses.replace(tc.get_config("llama3-8b").reduced(),
                            dtype="float32", num_heads=8, num_kv_heads=4,
                            head_dim=16)
TFALLBACK = dataclasses.replace(tc.get_config("llama3-8b").reduced(),
                                dtype="float32")
FULL = dict(pipeline=True, prefix_cache=True, shared_prefix=12)
RUNNER_COUNTERS = ("decode_batches", "decode_tokens", "attn_launches",
                   "prefill_chunks_run")


def _env(**kw):
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), str(ROOT / "tests"),
                    os.environ.get("PYTHONPATH")) if p), **kw)


# The reference's own sharded runs: run_engine(2) and the fallback's
# run_engine(4), with four XLA host devices forced before jax loads. They
# start when the module does and are read when a test needs them, so they
# run beside the in-process reference's runs.
_REF_TP_CODE = """
import dataclasses, json
from test_tp_runner import FALLBACK_CFG, run_engine
out = {}
for name, kw in (("tp2", dict(tp=2)), ("fallback4", dict(tp=4, cfg=FALLBACK_CFG))):
    streams, eng = run_engine(**kw)
    ex = eng.core.executor
    out[name] = dict(
        streams={str(k): v for k, v in streams.items()},
        counters=eng.kv.transfer_counters(),
        plan=dataclasses.asdict(ex.tp_plan),
        pool_shard_bytes=ex.store.pool_shard_bytes,
        pool_global_bytes=ex.store.pool_global_bytes,
        runner={c: getattr(ex, c) for c in %r},
        rotations=eng.stats.active_rotations + eng.stats.passive_preemptions)
print(json.dumps(out))
""" % (RUNNER_COUNTERS,)


@pytest.fixture(scope="module")
def reference_tp_proc():
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_TP_CODE], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference_tp(reference_tp_proc):
    out, err = reference_tp_proc.communicate(timeout=900)
    assert reference_tp_proc.returncode == 0, err[-3000:]
    res = json.loads(out.splitlines()[-1])
    for r in res.values():
        r["streams"] = {int(k): v for k, v in r["streams"].items()}
    return res


@pytest.fixture(scope="module", autouse=True)
def _one_thread(reference_tp_proc):
    # tiny CPU tensors: a thread pool costs far more than it saves (the
    # reference's subprocess starts first, so it runs beside this module)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- plan logic

class TestPlan:
    """GQA divisibility contract on the real llama3-405b geometry
    (num_heads=128, num_kv_heads=8) — no devices required."""

    CFG = tc.get_config("llama3-405b")

    @pytest.mark.parametrize("tp", [2, 4, 8])
    def test_sharded_at_divisors(self, tp):
        plan = ttp.plan_tp_sharding(self.CFG, tp)
        assert plan.shard_kv and plan.shard_mlp
        assert plan.kv_shards == tp
        assert not plan.trivial

    def test_tp1_trivial(self):
        plan = ttp.plan_tp_sharding(self.CFG, 1)
        assert plan.trivial and plan.kv_shards == 1
        assert not plan.shard_kv and not plan.shard_mlp

    def test_replicate_fallback_above_kv_heads(self):
        plan = ttp.plan_tp_sharding(self.CFG, 16)
        assert not plan.shard_kv and plan.shard_mlp
        assert plan.kv_shards == 1

    @pytest.mark.parametrize("tp", [3, 5, 6, 7])
    def test_indivisible_kv_heads_names_field(self, tp):
        with pytest.raises(ValueError, match="num_kv_heads"):
            ttp.plan_tp_sharding(self.CFG, tp)

    def test_indivisible_q_heads_names_field(self):
        cfg = dataclasses.replace(self.CFG, num_heads=12, num_kv_heads=8)
        with pytest.raises(ValueError, match=r"num_heads=12.*tp=8"):
            ttp.plan_tp_sharding(cfg, 8)

    def test_indivisible_d_ff_names_field(self):
        cfg = dataclasses.replace(self.CFG, d_ff=53250)
        with pytest.raises(ValueError, match="d_ff"):
            ttp.plan_tp_sharding(cfg, 4)
        cfg2 = dataclasses.replace(self.CFG, d_ff=53247)
        with pytest.raises(ValueError, match="d_ff"):
            ttp.plan_tp_sharding(cfg2, 16)

    def test_tp_below_one_rejected(self):
        with pytest.raises(ValueError, match="tp"):
            ttp.plan_tp_sharding(self.CFG, 0)

    def test_attention_free_rejected(self):
        ssm = tc.get_config("mamba2-2.7b")
        assert ssm.num_attn_layers == 0
        with pytest.raises(ValueError, match="num_attn_layers"):
            ttp.plan_tp_sharding(ssm, 2)


def _plan_or_error(mod, cfg, tp):
    try:
        return dataclasses.asdict(mod.plan_tp_sharding(cfg, tp))
    except ValueError as e:
        return str(e)


def _strip(spec):
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


@pytest.mark.parametrize("arch", sorted(set(rc.ARCH_IDS)
                                        | set(rc.PAPER_MODEL_IDS)))
def test_plan_and_specs_equal_reference(arch):
    """Every config at tp 0..16: the same plan or the same error message,
    and the same pool, scale, layer and head specs."""
    for tp in range(0, 17):
        want = _plan_or_error(rtp, rc.get_config(arch), tp)
        got = _plan_or_error(ttp, tc.get_config(arch), tp)
        assert got == want, (arch, tp)
        if isinstance(got, str):
            continue
        rplan = rtp.plan_tp_sharding(rc.get_config(arch), tp)
        tplan = ttp.plan_tp_sharding(tc.get_config(arch), tp)
        assert ttp.pool_pspec(tplan) == _strip(rtp.pool_pspec(rplan))
        assert ttp.scale_pspec(tplan) == _strip(rtp.scale_pspec(rplan))
        assert ttp.layer_pspecs(tplan) == {
            k: _strip(v) for k, v in rtp.layer_pspecs(rplan).items()}
        head = {"embed": 0, "final_norm": 0, "lm_head": 0}
        assert ttp.head_pspecs(head) == {
            k: _strip(v) for k, v in rtp.head_pspecs(head).items()}


def test_shard_slice_and_all_reduce():
    """A shard is the contiguous i-th piece along the spec's "model" dim
    (all of it when replicated), a tensor of its own; the all-reduce adds
    the partials in shard order in their dtype. The runner takes both from
    ``distributed/spmd.py`` over ``make_tp_mesh``'s 1-D mesh."""
    mesh = make_tp_mesh(4, "cpu")
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    parts = spmd.place_spec(x, (None, "model"), mesh).pieces
    for i, p in enumerate(parts):
        assert p.is_contiguous() and p.shape == (2, 2, 3)
        assert torch.equal(p, x[:, 2 * i:2 * i + 2])
    assert torch.equal(torch.cat(parts, 1), x)
    rep = spmd.place_spec(x, (), mesh).pieces[1]
    assert torch.equal(rep, x) and rep.data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="not divisible"):
        spmd.place_spec(x, ("model",), mesh)
    h = [torch.tensor([1.0, 2.0 ** -9], dtype=torch.bfloat16),
         torch.tensor([2.0 ** 8, 2.0 ** -9], dtype=torch.bfloat16),
         torch.tensor([-(2.0 ** 8), 1.0], dtype=torch.bfloat16)]
    out = spmd.all_reduce(h, make_tp_mesh(3, "cpu"), "model")
    want = (h[0] + h[1]) + h[2]          # in order, rounded in bf16
    assert all(o.dtype == torch.bfloat16 and torch.equal(o, want)
               for o in out)
    assert not torch.equal(want, h[0] + (h[1] + h[2]))


# ------------------------------------------------------------ host / mesh

def test_device_count_error_names_recipe():
    """More shards than cards fails loudly with the port's recipe (the CPU
    or an explicit device list), never a silent single-device fallback."""
    ensure_host_devices(1)
    ensure_host_devices(4, "cpu")
    ensure_host_devices(2, ["cuda:0", "cuda:0"])     # taken as given
    with pytest.raises(ValueError, match="list of 2 devices"):
        ensure_host_devices(2, ["cpu"])
    with pytest.raises(ValueError, match="tp"):
        make_tp_mesh(0)
    too_many = max(2, torch.cuda.device_count() + 1)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match=r"device='cpu'.*explicit "
                                               r"list"):
            make_tp_mesh(too_many, dev)
    mesh = make_tp_mesh(4, "cpu")
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert mesh.axis_names == ("model",)
    assert make_tp_mesh(2, ["cpu", "cpu"]).devices == mesh.devices[:2]


# ------------------------------------------------------- engine harness

def make_requests(n, seed=3, shared_prefix=0, out_hi=16, cfg=TBASE):
    """``test_tp_runner.make_requests`` with the port's Request."""
    rng = np.random.default_rng(seed)
    pref = ([int(x) for x in rng.integers(1, cfg.vocab_size, shared_prefix)]
            if shared_prefix else [])
    reqs = []
    for i in range(n):
        plen = int(rng.integers(8, 16))
        ids = pref + [int(x) for x in rng.integers(1, cfg.vocab_size, plen)]
        reqs.append(Request(req_id=i, arrival_time=0.02 * i,
                            prompt_len=len(ids),
                            output_len=int(rng.integers(10, out_hi)),
                            prompt_ids=ids))
    return reqs


def run_port(tp, params, hbm=16, pipeline=False, prefix_cache=False,
             shared_prefix=0, cfg=TBASE, kv_dtype="bf16"):
    """``test_tp_runner.run_engine`` on the port, with given weights."""
    sv = tc.ServingConfig(num_hbm_blocks=hbm, num_dram_blocks=512,
                          scheduler="rotasched", block_size=4,
                          max_model_len=64, prefill_chunk=8,
                          paged_runner=True, tp=tp, pipeline=pipeline,
                          prefix_cache=prefix_cache, kv_dtype=kv_dtype)
    runner = PagedModelRunner(cfg, sv, tc.GH200, timing_cfg=cfg,
                              params=params, device="cpu")
    eng = ServingEngine(cfg, sv, tc.GH200, executor=runner)
    for r in make_requests(5, shared_prefix=shared_prefix, cfg=cfg):
        eng.add_request(r)
    eng.drain(max_time_s=500)
    eng.kv.table.check_invariants()
    streams = {r.req_id: list(r.generated_ids) for r in eng.core.submitted}
    return streams, eng


def rotations(eng):
    return eng.stats.active_rotations + eng.stats.passive_preemptions


def _weights(eng):
    ex = eng.core.executor
    return lambda: from_jax_params(ex._layers, ex._head, "cpu",
                                   torch.float32)


@pytest.fixture(scope="module")
def ref_base():
    """The reference's single-device run under rotation, in process on
    one XLA device, and a maker of its weights for the port."""
    assert jax.device_count() == 1
    streams, eng = run_engine(1)
    assert rotations(eng) > 0
    return streams, eng, _weights(eng)


@pytest.fixture(scope="module")
def ref_fallback():
    streams, eng = run_engine(1, cfg=FALLBACK_CFG)
    return streams, eng, _weights(eng)


@pytest.fixture(scope="module")
def port_runs(ref_base):
    _, _, weights = ref_base
    return {tp: run_port(tp, weights()) for tp in (1, 2, 4)}


# ----------------------------------------------------------- token parity

@pytest.mark.parametrize("tp", [2, 4])
def test_parity_under_rotation(ref_base, port_runs, tp):
    ref, _, _ = ref_base
    got, eng = port_runs[tp]
    assert rotations(eng) > 0
    assert eng.core.executor.tp_plan.kv_shards == tp
    assert got == ref


@pytest.mark.parametrize("name,tp", [("tp2", 2), ("fallback4", 4)])
def test_equal_to_reference_sharded_runs(reference_tp, ref_base,
                                         ref_fallback, port_runs, name, tp):
    """The port against the reference's own sharded runner (not only by
    way of tp=1): streams, per-shard transfer counters, plan, pool bytes
    and runner counters."""
    want = reference_tp[name]
    if name == "tp2":
        got, eng = port_runs[2]
    else:
        got, eng = run_port(4, ref_fallback[2](), cfg=TFALLBACK)
    ex = eng.core.executor
    assert got == want["streams"]
    assert eng.kv.transfer_counters() == want["counters"]
    assert dataclasses.asdict(ex.tp_plan) == want["plan"]
    assert ex.store.pool_shard_bytes == want["pool_shard_bytes"]
    assert ex.store.pool_global_bytes == want["pool_global_bytes"]
    assert {c: getattr(ex, c) for c in RUNNER_COUNTERS} == want["runner"]
    assert rotations(eng) == want["rotations"] > 0


def test_parity_full_features(ref_base):
    """Rotation + prefix cache + pipelined engine all ON: the port at tp=2
    against the reference at tp=1 (DESIGN.md §Tensor-parallel execution's
    acceptance combination)."""
    ref, _ = run_engine(1, **FULL)
    got, eng = run_port(2, ref_base[2](), **FULL)
    assert eng.kv.table.cache_hit_tokens > 0
    assert eng.core.executor.store.double_buffer
    assert got == ref


def test_replicate_fallback_parity(ref_fallback):
    """tp=4 > num_kv_heads=2: attention and the pool replicate
    (kv_shards=1), only the MLP shards; streams equal the reference's
    single-device run."""
    ref, _, weights = ref_fallback
    got, eng = run_port(4, weights(), cfg=TFALLBACK)
    ex = eng.core.executor
    plan = ex.tp_plan
    assert not plan.shard_kv and plan.shard_mlp and plan.kv_shards == 1
    assert len(ex.store.pools) == 4
    for pool in ex.store.pools:
        assert pool.shape[-2] == TFALLBACK.num_kv_heads
    # attention weights whole on every shard, the MLP's d_ff split
    assert ex._layers[0]["wq"].shape == (TFALLBACK.d_model,
                                        TFALLBACK.num_heads,
                                        TFALLBACK.head_dim)
    assert ex._layers[0]["w_gate"].shape[1] == TFALLBACK.d_ff // 4
    assert got == ref


# ----------------------------------------- footprint / accounting / launches

def test_pool_shard_footprint(port_runs):
    """Each shard holds exactly 1/TP of the KV pool bytes, in a pool of
    Hkv/TP heads per row."""
    for tp in (2, 4):
        store = port_runs[tp][1].core.executor.store
        assert store.pool_shard_bytes * tp == store.pool_global_bytes
        assert len(store.pools) == tp
        for pool in store.pools:
            assert pool.shape[-2] == TBASE.num_kv_heads // tp
    one = port_runs[1][1].core.executor.store
    assert one.pool_global_bytes == port_runs[2][1].core.executor.store \
        .pool_global_bytes


def test_transfer_counters_per_shard(port_runs):
    """DuplexKV reports per-shard link bytes == global / kv_shards."""
    for tp in (2, 4):
        tc_ = port_runs[tp][1].kv.transfer_counters()
        assert tc_["kv_shards"] == tp
        assert tc_["d2h_bytes"] > 0
        assert tc_["d2h_bytes_per_shard"] == tc_["d2h_bytes"] // tp
        assert tc_["h2d_bytes_per_shard"] == tc_["h2d_bytes"] // tp


def test_launch_count_invariance(ref_base, port_runs):
    """Decode stays one logical launch per layer per iteration: the
    runner's attention launch count is the same at every TP degree and
    equal to the reference's; the kernels' own counters would count each
    shard."""
    _, ref_eng, _ = ref_base
    ref_ex = ref_eng.core.executor
    assert ref_ex.attn_launches == ref_ex.decode_batches * len(
        ref_ex._layers)
    for tp in (1, 2, 4):
        ex = port_runs[tp][1].core.executor
        assert ex.decode_batches == ref_ex.decode_batches
        assert ex.attn_launches == ref_ex.attn_launches
        assert ex.decode_tokens == ref_ex.decode_tokens


def test_kv_store_roundtrip_sharded():
    """Rows survive device -> host -> device bit-exactly through the
    SHARDED staging path, the host tier holds FULL global rows, and each
    shard holds its heads of them; in the int8 tier the scale rows too."""
    sv = tc.ServingConfig(num_hbm_blocks=8, num_dram_blocks=64,
                          block_size=4, max_model_len=64, tp=2)
    plan = ttp.plan_tp_sharding(TBASE, 2)
    rng = np.random.default_rng(0)
    for kvd in ("bf16", "int8"):
        store = PagedKVStore(TBASE, sv, torch.float32, staging=4,
                             tp_plan=plan, mesh=make_tp_mesh(2, "cpu"),
                             kv_dtype=kvd)
        row = torch.from_numpy(rng.standard_normal(
            store.row_shape).astype(np.float32))
        if kvd == "int8":
            row = (row * 40).to(torch.int8)
            srow = torch.from_numpy(rng.random(
                store.scale_row_shape).astype(np.float32))
            store.host[9] = (row, srow)
        else:
            store.host[9] = row
        up = TransferDesc(block_id=0, req_id=0, direction="h2d",
                          src_slot=9, dst_slot=3, nbytes=1, segments=1)
        store.run_h2d([up])
        hk = TBASE.num_kv_heads // 2
        for i, pool in enumerate(store.pools):
            assert torch.equal(pool[3], row[..., i * hk:(i + 1) * hk, :])
        d = TransferDesc(block_id=0, req_id=0, direction="d2h",
                         src_slot=3, dst_slot=7, nbytes=1, segments=1)
        store.run_d2h([d])
        got = store.host[7]
        if kvd == "int8":
            assert torch.equal(got[0], row) and torch.equal(got[1], srow)
            for i, sc in enumerate(store.scale_shards):
                assert torch.equal(sc[3], srow[..., i * hk:(i + 1) * hk])
        else:
            assert got.shape == store.row_shape      # full GLOBAL row
            assert torch.equal(got, row)
        store.run_h2d([TransferDesc(block_id=0, req_id=0, direction="h2d",
                                    src_slot=7, dst_slot=5, nbytes=1,
                                    segments=1)])
        store.run_d2d([(5, 6)])
        for i, pool in enumerate(store.pools):
            assert torch.equal(pool[6], pool[3])
        assert store.copy_launches == 4


# ---------------------------------------------------------------- int8

def test_int8_tp2_streams_and_scales(ref_base):
    """int8 KV at tp=2: streams equal tp=1's in int8; each shard's scales
    are the kv-head slice of tp=1's, bitwise in the first layer (whose K/V
    come straight from the embedding) and within fp32 rounding after it
    (the all-reduce rounds the residual stream in another order)."""
    weights = ref_base[2]
    s1, e1 = run_port(1, weights(), kv_dtype="int8")
    s2, e2 = run_port(2, weights(), kv_dtype="int8")
    assert rotations(e2) > 0
    assert s2 == s1
    st1, st2 = e1.core.executor.store, e2.core.executor.store
    assert len(st2.scale_shards) == 2
    got = torch.cat(st2.scale_shards, -1)
    assert torch.equal(got[:, 0], st1.scales[:, 0])
    torch.testing.assert_close(got, st1.scales, rtol=1e-5, atol=0)


def test_int8_shard_scales_exact_for_the_same_tokens():
    """Quantizing the same K/V tokens into a pool and into its two kv-head
    shards gives the shards exactly the slices of the pool's values and
    scales, in every layer: the reduction axes of a scale (P, D) are never
    sharded."""
    g = torch.Generator().manual_seed(5)
    L, P, H, D, rows = 3, 4, 4, 16, 6
    full = torch.zeros(rows, L, 2, P, H, D, dtype=torch.int8)
    fsc = torch.zeros(rows, L, 2, H)
    shards = [(torch.zeros(rows, L, 2, P, H // 2, D, dtype=torch.int8),
               torch.zeros(rows, L, 2, H // 2)) for _ in range(2)]
    for step in range(10):                 # running scales grow
        T = 5
        # distinct (row, layer, offset) slots, as a call of the runner
        # writes them
        slot = torch.randperm(rows * L * P, generator=g)[:T]
        wrow, lrow, woff = slot // (L * P), slot // P % L, slot % P
        for side in (0, 1):
            x = torch.randn(T, H, D, generator=g) * (1 + step)
            quant_store_tokens(full, fsc, wrow, lrow, side, woff, x)
            for i, (pool, sc) in enumerate(shards):
                quant_store_tokens(pool, sc, wrow, lrow, side, woff,
                                   x[:, i * 2:(i + 1) * 2])
    assert torch.equal(torch.cat([p for p, _ in shards], -2), full)
    assert torch.equal(torch.cat([s for _, s in shards], -1), fsc)


# ------------------------------------------------------------ the sim CLI

_REF_CLI_CODE = """
import json
from repro.launch import serve
rows = [serve.main(["--tp", tp, "--rps", "5", "--duration", "5", "--seed",
                    "0", "--json"]) for tp in ("2", "4")]
print("ROWS " + json.dumps(rows))
"""


def test_sim_cli_rows_equal_reference(capsys):
    proc = subprocess.run(
        [sys.executable, "-c", _REF_CLI_CODE], cwd=ROOT, text=True,
        capture_output=True, timeout=300,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.split("ROWS ", 1)[1])
    for tp, w in zip((2, 4), want):
        row = tserve.main(["--tp", str(tp), "--device", "cpu", "--rps", "5",
                           "--duration", "5", "--seed", "0", "--json"])
        got = json.loads(capsys.readouterr().out)
        assert got == json.loads(json.dumps(row))
        assert got == w
        assert got["tp"] == tp and got["kv_shards"] == tp
        assert got["d2h_bytes_per_shard"] == got["d2h_bytes"] // tp
