"""The CUDA kernels against their plain PyTorch versions over a sweep of
small shapes (the paged kernel in both its modes, its split-K across
contexts that cross split boundaries and its batch invariance, the bf16
tensor-core flash kernel, ``kv_copy`` on pool and scale rows),
``quant_store_tokens`` on the card against the CPU, the paged runner
on the card against itself on the CPU, bf16 and int8 KV, the dense
executor likewise on a model with sliding windows, and launches from a
thread that set no CUDA device.
These need a CUDA card (nvcc builds the kernels at first use); without one
every test here skips. On the card:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

``chip_smoke.py`` checks the same kernels at llama3-8b's full widths.
Tolerance: fp32 atol=rtol=1e-5; bf16 atol=rtol=2e-2 (output rounding).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,D,P,MB,L", [
    (3, 4, 2, 16, 4, 6, 4),        # the reduced llama the runner serves
    (2, 8, 8, 32, 8, 3, 0),        # MHA, flat pool
    (5, 8, 1, 64, 16, 5, 2),       # MQA
    (4, 16, 2, 128, 32, 2, 1),     # group of 8, 32-token blocks
    (2, 32, 2, 64, 16, 9, 2),      # group of 16: all rows of the mma tile
    (2, 32, 1, 32, 8, 9, 0),       # group of 32: bf16 on the CUDA cores
])
def test_paged_attention_kernel(gen, dtype, B, H, Hkv, D, P, MB, L):
    NB = B * MB + 2
    lead = (NB, L) if L else (NB,)
    q = randn(gen, (B, H, D), dtype)
    pool = randn(gen, lead + (2, P, Hkv, D), dtype)
    bt = torch.randint(0, NB - 1, (B, MB), generator=gen, device="cuda",
                       dtype=torch.int32)
    cl = torch.randint(1, MB * P + 1, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    bt[-1], cl[-1] = NB - 1, 1                     # a padded lane
    layer = L - 1 if L else -1
    got = ops.paged_attention(q, pool, bt, cl, layer=layer, force="kernel")
    want = ref.paged_attention_ref(q, pool, bt, cl, layer=layer)
    torch.testing.assert_close(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,H,Hkv,D,causal,window,q_offset", [
    (8, 16, 4, 2, 16, True, 0, 5),         # pow2 chunk over a pow2 context
    (37, 70, 4, 2, 16, True, 0, None),     # ragged tiles, tail-aligned
    (40, 40, 3, 3, 32, True, 0, None),
    (64, 64, 2, 1, 64, True, 24, None),    # sliding window
    (48, 48, 2, 2, 16, False, 0, None),    # non-causal
    (16, 96, 8, 2, 128, True, 7, 60),      # window + offset + GQA
    (1, 33, 4, 4, 32, True, 0, 32),        # one query row
])
def test_flash_attention_kernel(gen, dtype, Sq, Skv, H, Hkv, D, causal,
                                window, q_offset):
    q = randn(gen, (2, Sq, H, D), dtype)
    k = randn(gen, (2, Skv, Hkv, D), dtype)
    v = randn(gen, (2, Skv, Hkv, D), dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, force="kernel")
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    torch.testing.assert_close(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,D,P,MB,L", [
    (3, 4, 2, 16, 4, 6, 4),        # the reduced llama the runner serves
    (2, 8, 8, 32, 8, 3, 0),        # MHA, flat pool
    (5, 8, 1, 64, 16, 5, 2),       # MQA
    (4, 16, 2, 128, 32, 2, 1),     # group of 8, 32-token blocks
    (6, 32, 8, 128, 16, 4, 0),     # llama3-8b's heads, flat pool
])
def test_paged_attention_int8_kernel(gen, dtype, B, H, Hkv, D, P, MB, L):
    """The int8 mode (fused dequant) against its plain version, with a
    padded lane on the trash row and a row whose scales are SCALE_EPS."""
    from repro_torch.kernels.quant import SCALE_EPS
    NB = B * MB + 2
    lead = (NB, L) if L else (NB,)
    q = randn(gen, (B, H, D), dtype)
    pool = torch.randint(-127, 128, lead + (2, P, Hkv, D), generator=gen,
                         device="cuda", dtype=torch.int8)
    scales = torch.rand(lead + (2, Hkv), generator=gen, device="cuda") * 0.05
    scales[0] = SCALE_EPS
    bt = torch.randint(0, NB - 1, (B, MB), generator=gen, device="cuda",
                       dtype=torch.int32)
    cl = torch.randint(1, MB * P + 1, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    bt[0, 0] = 0                                    # the EPS row
    bt[-1], cl[-1] = NB - 1, 1                     # a padded lane
    layer = L - 1 if L else -1
    ops.reset_launch_counts()
    got = ops.paged_attention(q, pool, bt, cl, layer=layer, kv_scales=scales,
                              force="kernel")
    assert ops.launch_counts()["paged_attention_int8"] == 1
    want = ref.paged_attention_ref(q, pool, bt, cl, layer=layer,
                                   kv_scales=scales)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL[dtype])


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("Sq", [1, 37, 64, 512])
def test_flash_attention_tensor_core_kernel(gen, D, Sq):
    """The bf16 kernel (wgmma) against its plain version: Skv not a
    multiple of the 64-key tile (two tiles or more, so state carried from
    tile to tile is checked), q_offset != Skv - Sq, window off and on, GQA
    groups of 1, 4 and 8."""
    off = 45
    Skv = off + Sq + 23
    for G in (1, 4, 8):
        Hkv = 2
        q = randn(gen, (1, Sq, G * Hkv, D), torch.bfloat16)
        k = randn(gen, (1, Skv, Hkv, D), torch.bfloat16)
        v = randn(gen, (1, Skv, Hkv, D), torch.bfloat16)
        for window in (0, 100):
            got = ops.flash_attention(q, k, v, causal=True, window=window,
                                      q_offset=off, force="kernel")
            want = ref.flash_attention_ref(q, k, v, causal=True,
                                           window=window, q_offset=off)
            torch.testing.assert_close(got, want, **TOL[torch.bfloat16])


def paged_case(gen, mode, B, ctxs, layered, P=16, H=32, Hkv=8, D=128, L=2,
               NB=1026):
    """q, pool (int8 with scales in the "int8" mode), a block table of
    random rows as wide as the longest context, and those contexts."""
    dt = torch.float32 if mode == "fp32" else torch.bfloat16
    MB = -(-max(ctxs) // P)
    lead = (NB, L) if layered else (NB,)
    q = randn(gen, (B, H, D), dt)
    scales = None
    if mode == "int8":
        pool = torch.randint(-127, 128, lead + (2, P, Hkv, D), generator=gen,
                             device="cuda", dtype=torch.int8)
        scales = torch.rand(lead + (2, Hkv), generator=gen,
                            device="cuda") * 0.05 + 1e-3
    else:
        pool = randn(gen, lead + (2, P, Hkv, D), dt)
    bt = torch.randint(0, NB - 1, (B, MB), generator=gen, device="cuda",
                       dtype=torch.int32)
    cl = torch.tensor(ctxs, device="cuda", dtype=torch.int32)
    bt[cl == 1] = NB - 1                                 # padded lanes
    return q, pool, scales, bt, cl, (L - 1 if layered else -1), dt


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("layered", [True, False])
def test_paged_attention_split_kernel(gen, mode, B, layered):
    """Split-K over a cluster: contexts from 1 to past 1024 that end on,
    before and after split boundaries (128-token units up to 1024, then
    256-token splits), with empty trailing splits, at llama3-8b's heads."""
    edges = [1, 31, 32, 127, 128, 129, 500, 1024, 1025, 1100, 77, 256]
    ctxs = [edges[i % len(edges)] for i in range(B)] if B > 1 else [1025]
    q, pool, sc, bt, cl, layer, dt = paged_case(gen, mode, B, ctxs, layered)
    ops.reset_launch_counts()
    got = ops.paged_attention(q, pool, bt, cl, layer=layer, kv_scales=sc,
                              force="kernel")
    counts = ops.launch_counts()
    assert counts["paged_attention_int8" if mode == "int8"
                  else "paged_attention"] == 1
    want = ref.paged_attention_ref(q, pool, bt, cl, layer=layer,
                                   kv_scales=sc)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL[dt])


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
def test_paged_attention_is_batch_invariant(gen, mode):
    """One sequence's output is bitwise the same alone (a table just wide
    enough: a cluster of 4), in a batch of 8 and in a batch of 32 with
    longer companions (clusters of 8, wider tables, other lanes)."""
    P, ctx = 16, 300
    q, pool, sc, bt, cl, layer, dt = paged_case(
        gen, mode, 32, [ctx] + [2000 - 37 * i for i in range(31)], True)
    nblk = -(-ctx // P)
    outs = []
    for B, lane in ((1, 0), (8, 5), (32, 17)):
        idx = torch.arange(B, device="cuda")
        idx[lane], idx[0] = 0, lane
        qb, btb, clb = q[idx].contiguous(), bt[idx].contiguous(), cl[idx]
        if B == 1:
            btb = btb[:, :nblk].contiguous()
        else:
            btb = btb[:, :max(nblk, -(-int(clb.max()) // P))].contiguous()
        out = ops.paged_attention(qb, pool, btb, clb.contiguous(),
                                  layer=layer, kv_scales=sc, force="kernel")
        outs.append(out[lane])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_quant_store_tokens_on_the_card_matches_the_cpu(gen):
    """A prefill chunk over several blocks (duplicate rows, mid-block start,
    padded lanes on the trash row) and a decode step, K and V, on a pool
    with stale content and scales: int8 values and scales as on the CPU."""
    from repro_torch.kernels.quant import quant_store_tokens
    g = torch.Generator().manual_seed(1)
    R, L, P, Hkv, D = 24, 2, 4, 2, 16
    pool_c = torch.randint(-127, 128, (R, L, 2, P, Hkv, D), generator=g,
                           dtype=torch.int8)
    scales_c = torch.rand((R, L, 2, Hkv), generator=g) + 1e-3
    pool_g, scales_g = pool_c.cuda(), scales_c.cuda()
    T, start = 16, 5
    tpos = start + torch.arange(T)
    wrow = 2 + tpos // P
    wrow[-3:] = R - 1
    vals = torch.randn((T, Hkv, D), generator=g) * 3.0
    drow = torch.tensor([10, 11, 12, R - 1, R - 1])
    doff = torch.tensor([0, 2, 3, 0, 0])
    dvals = torch.randn((5, Hkv, D), generator=g) * 9.0
    dvals[-2:] = dvals[-1]
    for wr, li, wo, v in ((wrow, 1, tpos % P, vals), (drow, 0, doff, dvals)):
        for side in (0, 1):
            lr = torch.full_like(wr, li)
            quant_store_tokens(pool_c, scales_c, wr, lr, side, wo, v)
            quant_store_tokens(pool_g, scales_g, wr.cuda(), lr.cuda(), side,
                               wo.cuda(), v.cuda())
    diff = (pool_g.cpu().int() - pool_c.int()).abs()
    assert int(diff.max()) <= 1, f"{int((diff > 0).sum())} values differ"
    torch.testing.assert_close(scales_g.cpu(), scales_c, rtol=1e-6, atol=0)


@pytest.mark.parametrize("L,Hkv", [(1, 1), (2, 2), (32, 8)])
def test_kv_copy_kernel_on_scale_rows(gen, L, Hkv):
    """The int8 tier's fp32 scale rows, 8 * L * Hkv bytes: 8 (not a
    multiple of 16, the narrow-word path), 32 and 2048 (llama3-8b)."""
    scales = torch.rand((12, L, 2, Hkv), generator=gen, device="cuda")
    flat = scales.view(12, -1)
    assert flat[0].numel() * 4 == 8 * L * Hkv
    src = np.array([1, 4, 6, -1], np.int32)
    dst = np.array([8, 9, 10, 0], np.int32)
    want = ref.kv_copy_ref(flat.clone(), src, dst)
    got = ops.kv_copy(flat, src, dst, force="kernel")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_kv_copy_kernel(gen, dtype):
    pool = torch.randint(-100, 100, (20, 4, 64), generator=gen,
                         device="cuda").to(dtype)
    src = np.array([2, 5, 5, -1, -1, -1, -1, -1], np.int32)
    dst = np.array([10, 11, 12, 0, 0, 0, 0, 0], np.int32)
    want = ref.kv_copy_ref(pool.clone(), src, dst)
    got = ops.kv_copy(pool, src, dst, force="kernel")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="overlap"):
        ops.kv_copy(pool, np.array([1, 2], np.int32),
                    np.array([2, 3], np.int32), force="kernel")


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_runner_on_the_card_matches_the_cpu(gen, kv_dtype):
    """The reduced llama in fp32 under rotation: the runner on CUDA (the
    kernels) emits the token streams it emits on the CPU (the plain
    versions), from the same weights, with its pool updated in place."""
    import repro_torch.configs as tcfg
    from repro_torch.core.types import Request
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paged_runner import PagedModelRunner
    cfg = dataclasses.replace(tcfg.get_config("llama3-8b").reduced(),
                              dtype="float32")
    sv = tcfg.ServingConfig(num_hbm_blocks=16, num_dram_blocks=512,
                            block_size=4, max_model_len=64, prefill_chunk=8,
                            paged_runner=True, prefix_cache=True,
                            kv_dtype=kv_dtype)
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu",
                         torch.float32)
    rng = np.random.default_rng(3)
    pref = [int(x) for x in rng.integers(1, cfg.vocab_size, 12)]
    reqs = [dict(req_id=i, arrival_time=0.02 * i,
                 ids=pref + [int(x) for x in rng.integers(
                     1, cfg.vocab_size, int(rng.integers(8, 16)))],
                 out=int(rng.integers(10, 16))) for i in range(5)]
    streams = {}
    for device in ("cpu", "cuda"):
        p = {"layers": [{k: v.to(device) for k, v in layer.items()}
                        for layer in params["layers"]],
             "head": {k: v.to(device) for k, v in params["head"].items()}}
        runner = PagedModelRunner(cfg, sv, tcfg.GH200, params=p,
                                  device=device)
        eng = ServingEngine(cfg, sv, tcfg.GH200, executor=runner)
        ptr = runner.store.pool.data_ptr()
        for r in reqs:
            eng.add_request(Request(req_id=r["req_id"],
                                    arrival_time=r["arrival_time"],
                                    prompt_len=len(r["ids"]),
                                    output_len=r["out"],
                                    prompt_ids=r["ids"]))
        eng.drain(max_time_s=500)
        assert eng.stats.active_rotations + eng.stats.passive_preemptions
        assert runner.store.pool.data_ptr() == ptr
        streams[device] = {r.req_id: list(r.generated_ids)
                           for r in eng.core.submitted}
    assert streams["cuda"] == streams["cpu"]


def test_kernels_launch_from_a_thread_that_set_no_device(gen):
    """The async engine's driver thread launches every kernel, and it never
    sets a CUDA device: its launches give the main thread's outputs."""
    import threading
    q = randn(gen, (4, 8, 64), torch.bfloat16)
    pool = randn(gen, (10, 2, 2, 16, 2, 64), torch.bfloat16)
    bt = torch.randint(0, 10, (4, 3), generator=gen, device="cuda",
                       dtype=torch.int32)
    cl = torch.tensor([1, 17, 40, 48], device="cuda", dtype=torch.int32)
    qf = randn(gen, (1, 37, 8, 64), torch.bfloat16)
    kf = randn(gen, (1, 100, 2, 64), torch.bfloat16)

    def run():
        return (ops.paged_attention(q, pool, bt, cl, layer=1, force="kernel"),
                ops.flash_attention(qf, kf, kf, q_offset=63, window=32,
                                    force="kernel"))
    want = run()
    got = {}
    t = threading.Thread(target=lambda: got.update(out=run()))
    t.start()
    t.join(120)
    assert not t.is_alive()
    torch.cuda.synchronize()
    for a, b in zip(got["out"], want):
        assert torch.equal(a, b)


def test_dense_executor_on_the_card_matches_the_cpu(gen):
    """gemma3-1b.reduced() at 6 layers in fp32 (five local layers with a
    32-token window, one global), prompts longer than the window, under
    rotation: the dense RealExecutor on CUDA (the flash kernel with its
    window) emits the streams it emits on the CPU, from the same weights."""
    import repro_torch.configs as tcfg
    from repro_torch.core.types import Request
    from repro_torch.models.params import init_lm_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.executor import RealExecutor
    cfg = dataclasses.replace(tcfg.get_config("gemma3-1b").reduced(),
                              dtype="float32", num_layers=6)
    sv = tcfg.ServingConfig(num_hbm_blocks=20, num_dram_blocks=512,
                            block_size=4, max_model_len=64, prefill_chunk=8)
    params = init_lm_params(cfg, torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(3)
    reqs = [dict(ids=[int(x) for x in rng.integers(1, cfg.vocab_size, 37)],
                 out=int(rng.integers(12, 14))) for _ in range(5)]
    streams = {}
    for device in ("cpu", "cuda"):
        p = {"layers": [{k: v.to(device) for k, v in layer.items()}
                        for layer in params["layers"]],
             "head": {k: v.to(device) for k, v in params["head"].items()}}
        eng = ServingEngine(cfg, sv, tcfg.GH200, real_executor=RealExecutor(
            cfg, device=device, params=p))
        for i, r in enumerate(reqs):
            eng.add_request(Request(req_id=i, arrival_time=0.02 * i,
                                    prompt_len=len(r["ids"]),
                                    output_len=r["out"], prompt_ids=r["ids"]))
        eng.drain(max_time_s=500)
        assert eng.stats.active_rotations + eng.stats.passive_preemptions
        streams[device] = {r.req_id: list(r.generated_ids)
                           for r in eng.core.submitted}
    assert streams["cuda"] == streams["cpu"]
