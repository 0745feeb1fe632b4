"""The split-K rule of the paged decode kernel, on the CPU: the plain
version computed split by split (``paged_attention_ref(n_splits=...)``)
against the JAX package's Pallas kernel in interpret mode, and the
wrapper's split and cluster plan (``ref.split_bounds``, ``ref.cluster_size``).

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against these plain versions there, and check
that a sequence's output is bitwise the same in any batch). Tolerance:
fp32 atol=rtol=1e-5.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import quant as jquant  # noqa: E402
from repro.kernels.paged_attention import paged_attention_tpu  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # tiny CPU tensors: a thread pool costs far more than it saves
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def inputs(seed, B, H, Hkv, D, P, MB, ctx, L=0, int8=False):
    """q, a pool (int8 with its scales when ``int8``), a block table of
    distinct rows and the given contexts; a context of 1 marks a padded
    lane, whose blocks are all the trash row (the pool's last)."""
    rng = np.random.default_rng(seed)
    NB = B * MB + 2
    lead = (NB, L) if L else (NB,)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    pool = rng.standard_normal(lead + (2, P, Hkv, D)).astype(np.float32)
    scales = None
    if int8:
        qp, sc = jquant.quantize_kv(jnp.asarray(pool))
        pool, scales = np.array(qp), np.array(sc)
    bt = rng.permutation(NB - 1)[:B * MB].reshape(B, MB).astype(np.int32)
    cl = np.asarray(ctx, np.int32)
    bt[cl == 1] = NB - 1
    return q, pool, scales, bt, cl


# P = 4, MB = 8 (32 tokens). With split_unit = P: at 2 splits the 32- and
# 8-token contexts end on a split boundary; at 3 the 12-token one gives
# three full splits and the 5-token one an empty trailing split; at 8 the
# 32-token one fills all eight and the others leave trailing splits empty.
SMALL = dict(B=6, H=4, Hkv=2, D=16, P=4, MB=8, ctx=[1, 32, 12, 8, 17, 5])
MODES = {"flat": dict(L=0, int8=False, layer=-1),
         "layered": dict(L=3, int8=False, layer=1),
         "int8 layered": dict(L=2, int8=True, layer=1)}
_want = {}


def jax_reference(mode, seed, shape):
    """The Pallas kernel in interpret mode, once per (mode, shape)."""
    key = (mode, seed, tuple(sorted((k, str(v)) for k, v in shape.items())))
    m = MODES[mode]
    q, pool, sc, bt, cl = inputs(seed, **shape, L=m["L"], int8=m["int8"])
    if key not in _want:
        _want[key] = np.asarray(paged_attention_tpu(
            jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt),
            jnp.asarray(cl), layer=m["layer"],
            kv_scales=None if sc is None else jnp.asarray(sc)))
    return (q, pool, sc, bt, cl), _want[key]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n_splits", [1, 2, 3, 8])
def test_split_combine_matches_tpu_kernel(mode, n_splits):
    (q, pool, sc, bt, cl), want = jax_reference(mode, 0, SMALL)
    got = ref.paged_attention_ref(
        t(q), t(pool), t(bt), t(cl), layer=MODES[mode]["layer"],
        kv_scales=None if sc is None else t(sc), n_splits=n_splits)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# The kernel's own plan (128-token units, up to 8 splits) at P = 16 over a
# 1152-token table: contexts on a unit boundary (128, 1024: eight full
# splits), just past one (129, 1025: 256-token splits), a full table, a
# padded lane, and a short one whose cluster is mostly empty splits.
KERNEL_PLAN = dict(B=7, H=8, Hkv=2, D=16, P=16, MB=72,
                   ctx=[128, 1, 1024, 1025, 129, 1152, 40])


@pytest.mark.parametrize("mode", ["layered", "int8 layered"])
def test_kernel_plan_matches_tpu_kernel(mode):
    (q, pool, sc, bt, cl), want = jax_reference(mode, 1, KERNEL_PLAN)
    got = ref.paged_attention_ref(
        t(q), t(pool), t(bt), t(cl), layer=MODES[mode]["layer"],
        kv_scales=None if sc is None else t(sc), n_splits=ref.MAX_SPLITS,
        split_unit=ref.SPLIT_UNIT)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    one = ref.paged_attention_ref(
        t(q), t(pool), t(bt), t(cl), layer=MODES[mode]["layer"],
        kv_scales=None if sc is None else t(sc))
    np.testing.assert_allclose(got.numpy(), one.numpy(), **TOL)


@pytest.mark.parametrize("P", [1, 4, 16, 32])
def test_split_plan_covers_every_block_once(P):
    """Each context's splits tile [0, ctx) in order, start on block (and
    32-token stage) boundaries, number at most the cluster the wrapper
    launches for any table that holds the context, and at most 8."""
    ctxs = sorted(set(range(1, 2600, 37)) | {1, 127, 128, 129, 1023, 1024,
                                              1025, 2048, 2049, 4096})
    for ctx in ctxs:
        bounds = ref.split_bounds(ctx)
        assert bounds[0][0] == 0 and bounds[-1][1] == ctx
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert all(lo < hi for lo, hi in bounds)
        assert all(lo % P == 0 and lo % 32 == 0 for lo, _ in bounds)
        tps = ref.split_tokens(ctx)
        assert tps % ref.SPLIT_UNIT == 0
        assert all(hi - lo == tps for lo, hi in bounds[:-1])
        mb_min = -(-ctx // P)
        for mb in (mb_min, mb_min + 1, 2 * mb_min, 4096 // P):
            if mb * P < ctx:
                continue
            s = ref.cluster_size(mb, P)
            assert len(bounds) <= s <= ref.MAX_SPLITS
            assert s & (s - 1) == 0


def test_split_plan_does_not_depend_on_the_batch():
    """A sequence's splits come from its own context alone: in batches of
    other widths and companions they are the same, and every cluster the
    wrapper launches holds all of them."""
    rng = np.random.default_rng(3)
    P, ctx = 16, 700
    alone = ref.split_bounds(ctx)
    assert len(alone) <= ref.cluster_size(-(-ctx // P), P)
    for B in (1, 8, 32):
        cl = rng.integers(1, 2049, B)
        cl[rng.integers(B)] = ctx
        mb = -(-int(cl.max()) // P)
        s = ref.cluster_size(mb, P)
        plans = [ref.split_bounds(int(c)) for c in cl]
        assert all(len(p) <= s for p in plans)
        assert [p for p, c in zip(plans, cl) if c == ctx][0] == alone


def test_kernel_split_constants_are_the_plain_versions():
    """The CUDA kernel compiles the split plan in (kSplitUnit, kMaxSplits):
    the constants are ref.py's, so the plain version and the wrapper's
    cluster size describe the splits the kernel walks."""
    src = (Path(ref.__file__).parent / "csrc"
           / "paged_attention.cu").read_text()
    got = dict(re.findall(r"constexpr int (kSplitUnit|kMaxSplits) = (\d+);",
                          src))
    assert got == {"kSplitUnit": str(ref.SPLIT_UNIT),
                   "kMaxSplits": str(ref.MAX_SPLITS)}
