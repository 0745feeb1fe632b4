"""The port's int8 KV quantization (``repro_torch.kernels.quant``) against
the reference's (``repro.kernels.quant``) on the same numpy inputs: int8
values equal, scales within rtol 1e-6, in the cases of
tests/test_kv_quant.py (seeded sweep, zero block, streaming append, the
offset-0 reset of a stale scale, a prefill chunk's duplicate rows, padded
lanes on the trash row). And the int8 mode of the paged kernel's plain
version (``paged_attention_ref(kv_scales=)``) against the Pallas kernel in
interpret mode, flat and layered, fp32 tol 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import quant as jquant  # noqa: E402
from repro.kernels.paged_attention import paged_attention_tpu  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402

SEED = 42
BS = 4
SCALE_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # tiny CPU tensors: a thread pool costs far more than it saves
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_same(got_q, got_s, want_q, want_s):
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=SCALE_RTOL, atol=0)


def test_constants_and_scale_shape():
    assert quant.SCALE_EPS == jquant.SCALE_EPS
    for shape in [(3, 2, 2, 4, 2, 8), (5, 2, 8, 1, 16)]:
        assert quant.kv_scale_shape(shape) == jquant.kv_scale_shape(shape)


@pytest.mark.parametrize("shape", [(3, 2, 2, 4, 2, 8), (1, 1, 2, 16, 4, 16),
                                   (5, 4, 2, 8), (2, 3, 2, 4, 1, 4)])
def test_quantize_dequantize_match_reference(shape):
    """The seeded sweep of test_kv_quant.py: four amplitudes per shape."""
    rng = np.random.default_rng(SEED)
    for _ in range(4):
        x = (rng.standard_normal(shape)
             * rng.uniform(1e-3, 30.0)).astype(np.float32)
        q, s = quant.quantize_kv(t(x))
        jq, js = jquant.quantize_kv(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert_same(q, s, jq, js)
        np.testing.assert_allclose(
            quant.dequantize_kv(q, s).numpy(),
            np.asarray(jquant.dequantize_kv(jq, js)), rtol=1e-6, atol=0)


def test_zero_block_is_exact():
    q, s = quant.quantize_kv(torch.zeros(2, 2, 4, 2, 8))
    jq, js = jquant.quantize_kv(jnp.zeros((2, 2, 4, 2, 8)))
    assert_same(q, s, jq, js)
    assert torch.all(q == 0) and torch.all(s > 0)
    assert torch.all(quant.dequantize_kv(q, s) == 0)


def fresh_pool(nb=4, layers=2, page=BS, hkv=2, d=8):
    shape = (nb, layers, 2, page, hkv, d)
    return (np.zeros(shape, np.int8),
            np.zeros(quant.kv_scale_shape(shape), np.float32))


class Both:
    """One pool + scales held by both packages; ``store`` applies the same
    ``quant_store_tokens`` call to each and checks they agree."""

    def __init__(self, pool, scales):
        self.jp, self.js = jnp.asarray(pool), jnp.asarray(scales)
        self.tp, self.ts = t(pool.copy()), t(scales.copy())

    def store(self, wrow, lrow, side, woff, vals):
        self.jp, self.js = jquant.quant_store_tokens(
            self.jp, self.js, jnp.asarray(wrow, jnp.int32),
            jnp.asarray(lrow, jnp.int32), side,
            jnp.asarray(woff, jnp.int32), jnp.asarray(vals))
        ptrs = (self.tp.data_ptr(), self.ts.data_ptr())
        out = quant.quant_store_tokens(
            self.tp, self.ts, t(np.asarray(wrow, np.int32)),
            t(np.asarray(lrow, np.int32)), side,
            t(np.asarray(woff, np.int32)), t(vals))
        assert out[0] is self.tp and out[1] is self.ts      # in place
        assert (self.tp.data_ptr(), self.ts.data_ptr()) == ptrs
        assert_same(self.tp, self.ts, self.jp, self.js)


def test_streaming_append_tracks_running_scale():
    """Decode idiom: one token per call into one block row, amplitude
    growing, so every call rescales the earlier content in place."""
    rng = np.random.default_rng(SEED)
    both = Both(*fresh_pool())
    for step in range(BS):
        val = rng.standard_normal((1, 2, 8)).astype(np.float32) * 2.0 ** step
        both.store([0], [0], 0, [step], val)
    sc = both.ts[0, 0, 0]
    assert torch.all(sc > quant.SCALE_EPS)


def test_offset_zero_write_resets_stale_scale():
    """A reused row keeps the last tenant's huge scale; the new tenant's
    write at offset 0 resets it (scatter-min) before growing it."""
    rng = np.random.default_rng(SEED + 1)
    both = Both(*fresh_pool())
    huge = rng.standard_normal((1, 2, 8)).astype(np.float32) * 1e4
    both.store([0], [0], 0, [0], huge)
    assert both.ts[0, 0, 0].max() > 1.0
    tiny = rng.standard_normal((1, 2, 8)).astype(np.float32) * 1e-2
    both.store([0], [0], 0, [0], tiny)
    assert torch.all(both.ts[0, 0, 0]
                     <= float(np.abs(tiny).max()) / 127.0 + 1e-9)


def test_prefill_chunk_duplicate_rows():
    """A prefill chunk writes several tokens of one block row in a single
    call (duplicate row indices), then a second chunk resumes mid-block and
    grows the scale: the rescale of the duplicate lanes agrees."""
    rng = np.random.default_rng(SEED + 2)
    both = Both(*fresh_pool())
    vals = rng.standard_normal((3, 2, 8)).astype(np.float32) * 3.0
    both.store([2, 2, 2], [1, 1, 1], 1, [0, 1, 2], vals)
    more = rng.standard_normal((3, 2, 8)).astype(np.float32) * 9.0
    # the chunk's tail spills into row 3, whose offset 0 resets its scale
    both.store([2, 3, 3], [1, 1, 1], 1, [3, 0, 1], more)


def test_padded_lanes_on_the_trash_row():
    """Padded decode lanes all write offset 0 of the trash row (the last
    row) with identical values, beside real lanes on their own rows."""
    rng = np.random.default_rng(SEED + 3)
    pool, scales = fresh_pool(nb=6)
    pool[:] = rng.integers(-127, 128, pool.shape, dtype=np.int8)
    scales[:] = rng.uniform(0.01, 1.0, scales.shape).astype(np.float32)
    both = Both(pool, scales)
    pad = rng.standard_normal((1, 2, 8)).astype(np.float32)
    vals = np.concatenate(
        [rng.standard_normal((2, 2, 8)).astype(np.float32) * 5.0,
         np.repeat(pad, 3, axis=0)])
    both.store([1, 2, 5, 5, 5], [0, 0, 0, 0, 0], 0, [3, 1, 0, 0, 0], vals)


# ------------------------------------------ paged attention, int8 mode

def quant_inputs(seed, B, H, Hkv, D, P, NB, MB, L=0, padded=0, eps_row=True):
    """q, an int8 pool with its scales from ``quantize_kv`` of a random
    pool, a block table of distinct rows, ragged contexts; the last
    ``padded`` lanes point at the trash row (NB - 1) with context 1, and
    lane 0's first block is row 0, whose content is all zero, so its
    scales are SCALE_EPS."""
    rng = np.random.default_rng(seed)
    lead = (NB, L) if L else (NB,)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    pool_f = rng.standard_normal(lead + (2, P, Hkv, D)).astype(np.float32)
    if eps_row:
        pool_f[0] = 0.0
    qp, sc = jquant.quantize_kv(jnp.asarray(pool_f))
    bt = rng.permutation(np.arange(1, NB - 1))[:B * MB].reshape(B, MB)
    bt = bt.astype(np.int32)
    if eps_row:
        bt[0, 0] = 0
    cl = rng.integers(1, MB * P + 1, B).astype(np.int32)
    if padded:
        bt[-padded:] = NB - 1
        cl[-padded:] = 1
    return q, np.array(qp), np.array(sc), bt, cl


@pytest.mark.parametrize("B,H,Hkv,D,P,NB,MB,L,padded", [
    (3, 4, 2, 8, 4, 16, 2, 0, 1),     # flat pool, a padded lane
    (4, 8, 1, 16, 8, 24, 2, 0, 2),    # MQA, two padded lanes
    (3, 4, 2, 16, 4, 20, 3, 2, 1),    # layered: the runner's reduced llama
    (2, 8, 2, 32, 16, 12, 2, 3, 0),   # layered, group of 4
])
def test_paged_attention_int8_matches_tpu_kernel(B, H, Hkv, D, P, NB, MB, L,
                                                 padded):
    q, qp, sc, bt, cl = quant_inputs(7, B, H, Hkv, D, P, NB, MB, L=L,
                                     padded=padded)
    for layer in ((0, L - 1) if L else (-1,)):
        got = ops.paged_attention(t(q), t(qp), t(bt), t(cl), layer=layer,
                                  kv_scales=t(sc), force="ref")
        assert torch.isfinite(got).all()
        want = paged_attention_tpu(jnp.asarray(q), jnp.asarray(qp),
                                   jnp.asarray(bt), jnp.asarray(cl),
                                   layer=layer, kv_scales=jnp.asarray(sc))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
