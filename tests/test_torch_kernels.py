"""The port's plain kernel versions against the JAX package's Pallas kernels
(interpret mode, as tests/test_kernels.py runs them) and its jnp oracles,
on the same numpy inputs; the wrappers' CPU dispatch; and ``force``.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against these plain versions there. Tolerance: fp32 atol=rtol=1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_tpu  # noqa: E402
from repro.kernels.kv_copy import kv_copy_tpu  # noqa: E402
from repro.kernels.paged_attention import paged_attention_tpu  # noqa: E402
from repro.models.attention import flash_attention as jflash  # noqa: E402

from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import kv_copy as kv_copy_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402
from repro_torch.models.attention import flash_attention  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # tiny CPU tensors: a thread pool costs far more than it saves
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------- paged attention

def paged_inputs(seed, B, H, Hkv, D, P, NB, MB, L=0, padded=0):
    """Random q/pool, a block table of distinct rows, ragged context lengths;
    the last ``padded`` lanes point at the trash row (NB - 1) with context
    1, as the runner pads a batch."""
    rng = np.random.default_rng(seed)
    lead = (NB, L) if L else (NB,)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    pool = rng.standard_normal(lead + (2, P, Hkv, D)).astype(np.float32)
    bt = rng.permutation(NB - 1)[:B * MB].reshape(B, MB).astype(np.int32)
    cl = rng.integers(1, MB * P + 1, B).astype(np.int32)
    if padded:
        bt[-padded:] = NB - 1
        cl[-padded:] = 1
    return q, pool, bt, cl


@pytest.mark.parametrize("B,H,Hkv,D,P,NB,MB,padded", [
    (2, 8, 2, 32, 8, 16, 4, 0),       # GQA
    (3, 4, 4, 16, 16, 32, 3, 1),      # MHA, a padded lane
    (4, 8, 1, 32, 16, 24, 2, 2),      # MQA, two padded lanes
    (5, 4, 2, 16, 4, 40, 6, 0),       # the runner's reduced llama shape
])
def test_paged_attention_flat_pool(B, H, Hkv, D, P, NB, MB, padded):
    q, pool, bt, cl = paged_inputs(0, B, H, Hkv, D, P, NB, MB,
                                   padded=padded)
    got = ops.paged_attention(t(q), t(pool), t(bt), t(cl), force="ref")
    assert torch.isfinite(got).all()
    close(got, paged_attention_tpu(jnp.asarray(q), jnp.asarray(pool),
                                   jnp.asarray(bt), jnp.asarray(cl)))
    close(got, jref.paged_attention_ref(jnp.asarray(q), jnp.asarray(pool),
                                        jnp.asarray(bt), jnp.asarray(cl)))


@pytest.mark.parametrize("layer", [0, 2])
def test_paged_attention_layered_pool(layer):
    """``layer=`` reads (row, layer) of the runner's (NB, L, 2, P, Hkv, D)
    pool, as the Pallas kernel's index map does."""
    q, pool, bt, cl = paged_inputs(1, 4, 8, 2, 16, 4, 30, 5, L=3, padded=1)
    got = ops.paged_attention(t(q), t(pool), t(bt), t(cl), layer=layer,
                              force="ref")
    close(got, paged_attention_tpu(jnp.asarray(q), jnp.asarray(pool),
                                   jnp.asarray(bt), jnp.asarray(cl),
                                   layer=layer))
    close(got, jref.paged_attention_ref(jnp.asarray(q),
                                        jnp.asarray(pool[:, layer]),
                                        jnp.asarray(bt), jnp.asarray(cl)))


# ---------------------------------------------------------------- kv_copy

def test_kv_copy_matches_reference_and_padding_writes_nothing():
    rng = np.random.default_rng(2)
    pool = rng.standard_normal((12, 64)).astype(np.float32)
    src = np.array([3, 7, -1, -1], np.int32)     # pow2-padded, as the store
    dst = np.array([9, 10, 0, 0], np.int32)
    got = ops.kv_copy(t(pool.copy()), src, dst, force="ref")
    want = pool.copy()
    want[9], want[10] = pool[3], pool[7]
    close(got, want)
    torch.testing.assert_close(got[0], t(pool[0]), rtol=0, atol=0)
    close(got, jref.kv_copy_ref(jnp.asarray(pool), jnp.asarray(src),
                                jnp.asarray(dst)))
    close(got, kv_copy_tpu(jnp.asarray(pool), jnp.asarray(src),
                           jnp.asarray(dst)))


def test_kv_copy_wrapper_copies_in_place_and_refuses_races():
    """The GPU runs descriptors in parallel: a batch whose destination is
    also a source, or repeats a destination, is refused before any copy."""
    pool = torch.arange(8 * 4, dtype=torch.float32).reshape(8, 4)
    ptr, before = pool.data_ptr(), pool.clone()
    out = kv_copy_mod.kv_copy(pool, np.array([1, -1], np.int32),
                              np.array([5, 0], np.int32))
    assert out is pool and pool.data_ptr() == ptr
    torch.testing.assert_close(pool[5], before[1], rtol=0, atol=0)
    torch.testing.assert_close(pool[0], before[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="overlap"):
        kv_copy_mod.kv_copy(pool, np.array([1, 2], np.int32),
                            np.array([2, 3], np.int32))
    with pytest.raises(ValueError, match="unique"):
        kv_copy_mod.kv_copy(pool, np.array([1, 2], np.int32),
                            np.array([3, 3], np.int32))
    with pytest.raises(ValueError, match="out of range"):
        kv_copy_mod.kv_copy(pool, np.array([1], np.int32),
                            np.array([8], np.int32))


# -------------------------------------------------------- flash attention

def qkv(seed, B, Sq, Skv, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("B,Sq,Skv,H,D,causal,window", [
    (2, 64, 64, 2, 32, True, 0),
    (1, 40, 40, 3, 16, True, 0),          # non-multiple of block
    (2, 32, 96, 2, 32, True, 0),          # kv longer than q (tail-aligned)
    (1, 64, 64, 2, 64, True, 24),         # sliding window
    (2, 48, 48, 1, 16, False, 0),         # non-causal
])
def test_flash_attention_matches_tpu_kernel(B, Sq, Skv, H, D, causal,
                                            window):
    """q_offset=None is the TPU kernel's Skv - Sq alignment; heads arrive
    pre-repeated there, so Hkv == H here."""
    q, k, v = qkv(3, B, Sq, Skv, H, H, D)
    got = ops.flash_attention(t(q), t(k), t(v), causal=causal, window=window,
                              force="ref")
    close(got, flash_attention_tpu(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, block_q=16, block_k=16))
    close(got, jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        window=window))


@pytest.mark.parametrize("Sq,Skv,H,Hkv,start,window", [
    (8, 16, 4, 2, 5, 0),      # the runner's case: pow2 chunk and context,
    (4, 16, 4, 2, 13, 0),     # so Skv - Sq != start
    (16, 32, 8, 2, 3, 0),
    (8, 32, 4, 1, 9, 6),      # GQA + window
    (32, 32, 4, 2, 0, 0),     # first chunk
])
def test_flash_attention_matches_jnp_prefill_attention(Sq, Skv, H, Hkv,
                                                       start, window):
    """The call the paged runner makes at prefill: the port's
    models/attention.py::flash_attention against the reference's, with
    q_offset=start over a pow2-padded context and native GQA."""
    q, k, v = qkv(4, 1, Sq, Skv, H, Hkv, 16)
    got = flash_attention(t(q), t(k), t(v), causal=True, window=window,
                          q_offset=start)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, window=window, q_offset=start)
    close(got, want)


def test_flash_attention_row_without_keys_is_zero():
    q, k, v = qkv(5, 1, 4, 8, 2, 2, 16)
    out = ops.flash_attention(t(q), t(k), t(v), causal=True, window=2,
                              q_offset=20, force="ref")
    assert torch.count_nonzero(out) == 0


# ------------------------------------------------------------- dispatch

def test_force_kernel_on_cpu_raises():
    q, pool, bt, cl = paged_inputs(6, 2, 4, 2, 16, 4, 8, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_attention(t(q), t(pool), t(bt), t(cl), force="kernel")
    qq, k, v = qkv(6, 1, 4, 8, 2, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(t(qq), t(k), t(v), force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.kv_copy(torch.zeros(4, 8), np.array([0], np.int32),
                    np.array([1], np.int32), force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        paged_mod.paged_attention_kernel(t(q), t(pool), t(bt), t(cl))
    qpool, scales = quant.quantize_kv(t(pool))
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_attention(t(q), qpool, t(bt), t(cl), kv_scales=scales,
                            force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        flash_mod.flash_attention_kernel(t(qq), t(k), t(v))
    with pytest.raises(ValueError, match="force"):
        ops.kv_copy(torch.zeros(4, 8), np.array([0], np.int32),
                    np.array([1], np.int32), force="pallas")


def test_cpu_tensors_take_the_plain_version_uncounted():
    ops.reset_launch_counts()
    q, pool, bt, cl = paged_inputs(7, 2, 4, 2, 16, 4, 8, 2)
    got = paged_mod.paged_attention(t(q), t(pool), t(bt), t(cl))
    torch.testing.assert_close(
        got, ops.paged_attention(t(q), t(pool), t(bt), t(cl), force="ref"),
        rtol=0, atol=0)
    qpool, scales = quant.quantize_kv(t(pool))
    got = paged_mod.paged_attention(t(q), qpool, t(bt), t(cl),
                                    kv_scales=scales)
    torch.testing.assert_close(
        got, ops.paged_attention(t(q), qpool, t(bt), t(cl), kv_scales=scales,
                                 force="ref"), rtol=0, atol=0)
    qq, k, v = qkv(7, 1, 4, 8, 2, 2, 16)
    flash_mod.flash_attention(t(qq), t(k), t(v))
    kv_copy_mod.kv_copy(torch.zeros(4, 8), np.array([0], np.int32),
                        np.array([1], np.int32))
    assert ops.launch_counts() == {"flash_attention": 0, "kv_copy": 0,
                                   "paged_attention": 0,
                                   "paged_attention_int8": 0}
