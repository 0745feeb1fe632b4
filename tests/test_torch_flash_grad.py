"""The gradient of the port's flash attention: ``models.attention.
flash_attention`` runs as the ``FlashAttention`` autograd.Function when
grad is on, whose backward (``flash_attention_backward``) recomputes the
softmax per chunk of query rows. The same Function runs on the card, where
its forward is the CUDA kernel; here its forward is the plain version.

Checked on the CPU: ``torch.autograd.gradcheck`` in fp64 on tiny shapes;
dq/dk/dv against autograd through ``flash_attention_ref`` in fp32 (within
atol = rtol = 1e-5: fp32 sums in another order) for causal, a window,
``q_offset > 0``, non-causal with Sq != Skv and GQA 4:1, with chunks of 1,
3 and 256 query rows; rows that see no key get zero gradients; and the
no-grad (prefill) path skips the Function."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402

# name -> (B, Sq, Skv, H, Hkv, D, causal, window, q_offset)
CASES = {
    "causal": (2, 9, 9, 4, 2, 8, True, 0, 0),
    "window": (1, 11, 11, 4, 2, 8, True, 4, 0),
    "q_offset": (1, 5, 12, 4, 2, 8, True, 0, 7),
    "window_q_offset": (2, 6, 14, 2, 2, 8, True, 5, 8),
    "noncausal_sq_ne_skv": (2, 5, 9, 4, 2, 8, False, 0, 0),
    "gqa_4_1": (1, 8, 8, 8, 2, 8, True, 0, 0),
    # rows 12..15 sit past the 8 keys, beyond the window: they see nothing
    "rows_without_keys": (1, 4, 8, 2, 1, 8, True, 3, 12),
}


def inputs(case, dtype, seed=0):
    B, Sq, Skv, H, Hkv, D = CASES[case][:6]
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s)).to(dtype).requires_grad_()
    return mk(B, Sq, H, D), mk(B, Skv, Hkv, D), mk(B, Skv, Hkv, D)


def opts(case):
    causal, window, q_offset = CASES[case][6:]
    return dict(causal=causal, window=window, q_offset=q_offset)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradcheck_fp64(case):
    q, k, v = inputs(case, torch.float64)
    fn = lambda q, k, v: attention.FlashAttention.apply(  # noqa: E731
        q, k, v, *opts(case).values(), None)
    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-7,
                                    rtol=1e-5)


@pytest.mark.parametrize("chunk", [1, 3, 256])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_autograd_through_plain_version(case, chunk,
                                                    monkeypatch):
    monkeypatch.setattr(attention, "BWD_CHUNK_Q", chunk)
    q, k, v = inputs(case, torch.float32)
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tuple(q.shape))).float()
    out = attention.flash_attention(q, k, v, **opts(case))
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (q, k, v), dout)
    want_out = flash_attention_ref(q, k, v, **opts(case))
    want = torch.autograd.grad(want_out, (q, k, v), dout)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  want_out.detach().numpy())
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name}")


def test_rows_without_keys_get_zero_gradient():
    q, k, v = inputs("rows_without_keys", torch.float32)
    out = attention.flash_attention(q, k, v, **opts("rows_without_keys"))
    dq, dk, dv = torch.autograd.grad(out.square().sum() + out.sum(),
                                     (q, k, v))
    assert torch.all(out == 0)
    for g in (dq, dk, dv):
        assert torch.all(g == 0)


def test_noncontiguous_grad_out_and_bf16_dtypes():
    """A transposed upstream gradient, and bf16 inputs: gradients in bf16
    from an fp32 accumulation, within bf16 rounding of the fp32 ones."""
    q, k, v = inputs("gqa_4_1", torch.float32)
    qb, kb, vb = (t.detach().bfloat16().requires_grad_() for t in (q, k, v))
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8, 8))).float()               # (D, H): mixes heads after transpose
    loss32 = (attention.flash_attention(q, k, v).transpose(2, 3) @ w).sum()
    g32 = torch.autograd.grad(loss32, (q, k, v))
    out = attention.flash_attention(qb, kb, vb)
    g16 = torch.autograd.grad((out.float().transpose(2, 3) @ w).sum(),
                              (qb, kb, vb))
    for a, b in zip(g16, g32):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=5e-2,
                                   rtol=5e-2)


def test_no_grad_prefill_path_skips_the_function():
    q, k, v = inputs("causal", torch.float32)
    with torch.no_grad():
        out = attention.flash_attention(q, k, v)
    assert out.grad_fn is None
    plain = attention.flash_attention(q.detach(), k.detach(), v.detach())
    assert plain.grad_fn is None
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
