"""The port's roofline (``repro_torch/launch/roofline.py``) against the
reference's: ``tests/test_roofline.py``'s cases except the HLO parser (the
port has no HLO), then parity: ``model_flops`` and
``analytic_memory_bytes`` equal the reference's (rtol 1e-12) for every
config x shape, and ``roofline_terms``/``summarize`` equal them (rtol
1e-12) under the same constants; the H100's constants are the data
sheet's; and each kernel's ``flops_and_bytes`` gives phase 4's bound
column of ``chip_smoke.py`` at its shapes (PERF.md's kernel table, 4
decimals)."""
import pytest

torch = pytest.importorskip("torch")

import repro.configs as rc  # noqa: E402
from repro.launch import roofline as ref_rl  # noqa: E402

import repro_torch.configs as tc  # noqa: E402
from repro_torch.kernels import flash_attention as flash_k  # noqa: E402
from repro_torch.kernels import kv_copy as kv_copy_k  # noqa: E402
from repro_torch.kernels import paged_attention as paged_k  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

V5E = roofline.Peaks("tpu-v5e", rc.TPU_V5E.flops_bf16, rc.TPU_V5E.hbm_bw,
                     rc.TPU_V5E.ici_bw)
RTOL = 1e-12


def test_h100_constants_are_the_data_sheet():
    assert roofline.PEAK_BF16_FLOPS == 989e12
    assert roofline.HBM_BYTES_S == 3.35e12
    assert roofline.NVLINK_BYTES_S == 900e9
    assert roofline.H100_SXM == roofline.Peaks("h100-sxm", 989e12, 3.35e12,
                                               450e9)


def test_roofline_terms_bottleneck():
    t = roofline.roofline_terms(989e12, 3.35e12 / 2, 0)
    assert t["bottleneck"] == "compute" and t["compute_s"] == 1.0
    t2 = roofline.roofline_terms(1e12, 3.35e12 * 2, 0)
    assert t2["bottleneck"] == "memory" and t2["memory_s"] == 2.0
    t3 = roofline.roofline_terms(1e12, 1e9, 450e9 * 3)
    assert t3["bottleneck"] == "collective" and t3["collective_s"] == 3.0
    t4 = roofline.roofline_terms(1e12, 1e9, None)
    assert t4["collective_s"] is None and t4["bottleneck"] == "compute"


@pytest.mark.parametrize("coll", [0, 25e9, 800e9])
@pytest.mark.parametrize("flops,nbytes", [(197e12, 819e9 / 2), (1e12, 2e12),
                                          (3e13, 1e10)])
def test_roofline_terms_equal_reference(flops, nbytes, coll):
    got = roofline.roofline_terms(flops, nbytes, coll, V5E)
    want = ref_rl.roofline_terms(flops, nbytes, coll, rc.TPU_V5E)
    assert got["bottleneck"] == want["bottleneck"]
    for k in ("compute_s", "memory_s", "collective_s", "step_s_lower_bound"):
        assert got[k] == pytest.approx(want[k], rel=RTOL), k


def test_model_flops_scaling():
    cfg = tc.get_config("llama3-8b")
    tr = roofline.model_flops(cfg, tc.SHAPES["train_4k"])
    six_nd = 6 * cfg.param_count() * 256 * 4096
    assert six_nd * 0.9 <= tr <= six_nd * 1.6
    assert roofline.model_flops(cfg, tc.SHAPES["decode_32k"]) < tr / 1000


def test_moe_uses_active_params():
    moe = tc.get_config("qwen3-moe-30b-a3b")
    f = roofline.model_flops(moe, tc.SHAPES["train_4k"])
    assert f == pytest.approx(6 * moe.active_param_count() * 256 * 4096,
                              rel=0.5)


def test_analytic_memory_model_decode():
    m = roofline.analytic_memory_bytes(
        tc.get_config("yi-34b"), tc.SHAPES["decode_32k"], weights_local=1e9,
        opt_local=0, cache_local=4e9, data_shards=16, model_shards=16,
        fsdp_shards=16)
    assert m["weights"] == 1e9 and m["kv"] == 4e9
    assert m["total"] >= 5e9


@pytest.mark.parametrize("arch", tc.ARCH_IDS)
def test_model_flops_and_memory_model_equal_reference(arch):
    cfg, ref_cfg = tc.get_config(arch), rc.get_config(arch)
    for name in tc.SHAPES:
        shape, ref_shape = tc.SHAPES[name], rc.SHAPES[name]
        mf = roofline.model_flops(cfg, shape)
        assert mf == pytest.approx(ref_rl.model_flops(ref_cfg, ref_shape),
                                   rel=RTOL), name
        for mb in (1, 4):
            kw = dict(weights_local=3.5e9, opt_local=7e9, cache_local=2.5e9,
                      data_shards=16, model_shards=16, fsdp_shards=16,
                      microbatches=mb)
            got = roofline.analytic_memory_bytes(cfg, shape, **kw)
            want = ref_rl.analytic_memory_bytes(ref_cfg, ref_shape, **kw)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=RTOL), (name, k)
        # the summary under the reference's constants
        mem = roofline.analytic_memory_bytes(cfg, shape, weights_local=3.5e9,
                                             opt_local=7e9, cache_local=2.5e9,
                                             data_shards=16, model_shards=16,
                                             fsdp_shards=16)
        got = roofline.summarize(cfg, shape, 256, {"flops": mf / 200}, {},
                                 mem, V5E)
        want = ref_rl.summarize(ref_cfg, ref_shape, 256, {"flops": mf / 200},
                                {}, mem, rc.TPU_V5E)
        assert got["bottleneck"] == want["bottleneck"]
        for k in ("roofline_fraction_hw", "roofline_fraction",
                  "model_flops_global", "useful_flops_ratio", "ideal_step_s",
                  "compute_s", "memory_s", "collective_s",
                  "step_s_lower_bound"):
            assert got[k] == pytest.approx(want[k], rel=RTOL), (name, k)


def test_collectives_unknown_on_a_mesh():
    """Where nothing counted them, a mesh's collective bytes are unknown:
    None, never 0, and the term does not bind; counted ones (the
    dry-run's, a run's) give the term; one device counts none."""
    cfg = tc.get_config("llama3-8b")
    s = roofline.summarize(cfg, tc.SHAPES["decode_32k"], 256,
                           {"flops": 1e12}, None, {"total": 1e9})
    assert s["collective_s"] is None
    assert s["collective_bytes_per_device"] is None
    assert s["bottleneck"] == "compute" and "collective_note" not in s
    counted = roofline.summarize(
        cfg, tc.SHAPES["decode_32k"], 256, {"flops": 1e12},
        {"all-reduce": 9e9, "all-gather": 0, "reduce-scatter": 0},
        {"total": 1e9})
    assert counted["collective_s"] == 9e9 / roofline.H100_SXM.link_bw
    assert counted["bottleneck"] == "collective"
    one = roofline.summarize(cfg, tc.SHAPES["decode_32k"], 1,
                             {"flops": 1e12}, {}, {"total": 1e9})
    assert one["collective_s"] == 0.0 and "collective_note" not in one


def bound(cost):
    flops, nbytes = cost
    tf, tb = flops / roofline.PEAK_BF16_FLOPS, nbytes / roofline.HBM_BYTES_S
    return round(max(tf, tb) * 1e3, 4), "operations" if tf > tb else "bytes"


# phase 4's shapes (llama3-8b's 32/8/128 heads, a row of 32 layers x 2 x 16
# x 8 x 128 bf16 values; gemma3-1b 4/1/256, paligemma-3b 8/1/256) and the
# bound column PERF.md's kernel table holds for them
PHASE4 = [
    ("kv_copy", lambda: kv_copy_k.flops_and_bytes(64, 2 * 32 * 2 * 16 * 8
                                                  * 128), (0.0801, "bytes")),
    ("paged B=32", lambda: paged_k.flops_and_bytes(
        32, 32, 8, 128, 64, 32 * 1024, itemsize=2, kv_itemsize=2,
        quant=False), (0.0402, "bytes")),
    ("paged B=8", lambda: paged_k.flops_and_bytes(
        8, 32, 8, 128, 64, 8 * 1024, itemsize=2, kv_itemsize=2,
        quant=False), (0.0101, "bytes")),
    ("paged int8 B=32", lambda: paged_k.flops_and_bytes(
        32, 32, 8, 128, 64, 32 * 1024, itemsize=2, kv_itemsize=1,
        quant=True), (0.0202, "bytes")),
    ("paged int8 B=8", lambda: paged_k.flops_and_bytes(
        8, 32, 8, 128, 64, 8 * 1024, itemsize=2, kv_itemsize=1, quant=True),
     (0.0051, "bytes")),
    ("flash", lambda: flash_k.flops_and_bytes(
        1, 512, 1024, 32, 8, 128, causal=True, window=0, q_offset=512,
        itemsize=2), (0.0065, "operations")),
    ("flash D=256", lambda: flash_k.flops_and_bytes(
        1, 512, 1024, 4, 1, 256, causal=True, window=512, q_offset=512,
        itemsize=2), (0.0011, "operations")),
    ("flash D=256 paligemma", lambda: flash_k.flops_and_bytes(
        1, 320, 320, 8, 1, 256, causal=True, window=0, q_offset=0,
        itemsize=2), (0.0009, "bytes")),
    ("flash train", lambda: flash_k.flops_and_bytes(
        2, 1024, 1024, 4, 1, 256, causal=True, window=512, q_offset=0,
        itemsize=2), (0.0033, "operations")),
]


@pytest.mark.parametrize("name,cost,want", PHASE4,
                         ids=[p[0] for p in PHASE4])
def test_kernel_bounds_equal_phase4(name, cost, want):
    assert bound(cost()) == want


def test_flash_pairs_match_a_mask():
    """The flash formula's visible pairs equal a materialized mask's, for
    causal/non-causal, windows and offsets (non-causal windows too)."""
    for Sq, Skv, causal, win, off in [(7, 19, True, 0, 12), (7, 19, True, 5, 3),
                                      (16, 16, False, 0, 0),
                                      (9, 30, False, 4, 20), (5, 5, True, 0, -2)]:
        q = torch.arange(Sq)[:, None] + off
        k = torch.arange(Skv)[None, :]
        mask = torch.ones(Sq, Skv, dtype=torch.bool)
        if causal:
            mask &= k <= q
        if win:
            mask &= k > q - win
        flops, nbytes = flash_k.flops_and_bytes(2, Sq, Skv, 3, 1, 8,
                                                causal=causal, window=win,
                                                q_offset=off, itemsize=4)
        assert flops == 4 * 2 * int(mask.sum()) * 3 * 8
        assert nbytes == (2 * 2 * Sq * 3 * 8 + 2 * 2 * Skv * 8) * 4
