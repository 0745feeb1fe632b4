"""The port's Mamba-2 SSD (``repro_torch.models.ssm``) against the
reference's on the CPU, on the same numpy-seeded inputs, in fp32 within
1e-5: the causal conv and its one-step form, ``ssd_forward`` over a
sequence that is not a multiple of the chunk (with and without an initial
state), and ``ssd_decode_step``; the final state is cast to the input's
dtype (bf16 at full width). Plus the reference's check that the chunked
form equals the per-step recurrence, on the port alone."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SSMConfig as RefSSMConfig  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402

from repro_torch.configs.base import SSMConfig  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
B, H, P, N = 2, 3, 4, 8
KW = dict(state_dim=N, head_dim=P, expand=2, chunk_size=8)


def seq_inputs(S, seed=0):
    rng = np.random.default_rng(seed)
    xz = {"x": rng.standard_normal((B, S, H * P)).astype(np.float32),
          "b": rng.standard_normal((B, S, N)).astype(np.float32),
          "c": rng.standard_normal((B, S, N)).astype(np.float32),
          "dt": rng.standard_normal((B, S, H)).astype(np.float32)}
    params = {"A_log": rng.uniform(0, 1, H).astype(np.float32),
              "D": rng.uniform(0.5, 1.5, H).astype(np.float32),
              "dt_bias": rng.uniform(-1, 1, H).astype(np.float32)}
    return xz, params


def t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("W", [2, 4])
def test_causal_conv_and_step_match_reference(W):
    rng = np.random.default_rng(W)
    x = rng.standard_normal((B, 13, 6)).astype(np.float32)
    w = rng.standard_normal((W, 6)).astype(np.float32)
    np.testing.assert_allclose(
        ssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(ref_ssm.causal_conv(jnp.asarray(x), jnp.asarray(w))),
        **TOL)
    state = rng.standard_normal((B, W - 1, 6)).astype(np.float32)
    out, new = ssm.causal_conv_step(torch.from_numpy(x[:, 0]),
                                    torch.from_numpy(state),
                                    torch.from_numpy(w))
    r_out, r_new = ref_ssm.causal_conv_step(jnp.asarray(x[:, 0]),
                                            jnp.asarray(state),
                                            jnp.asarray(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), **TOL)
    np.testing.assert_array_equal(new.numpy(), np.asarray(r_new))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [5, 8, 21])
def test_ssd_forward_matches_reference(S, with_state):
    """S = 5 (one partial chunk), 8 (one whole chunk), 21 (a partial last
    chunk padded with dt = 0)."""
    xz, params = seq_inputs(S)
    h0 = (np.random.default_rng(9).standard_normal((B, H, P, N))
          .astype(np.float32) if with_state else None)
    y, h = ssm.ssd_forward(t(xz), t(params), SSMConfig(**KW),
                           init_state=None if h0 is None
                           else torch.from_numpy(h0), return_state=True)
    ry, rh = ref_ssm.ssd_forward(j(xz), j(params), RefSSMConfig(**KW),
                                 init_state=None if h0 is None
                                 else jnp.asarray(h0), return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), **TOL)


def test_ssd_decode_step_matches_reference():
    xz, params = seq_inputs(1, seed=4)
    step = {k: v[:, 0] for k, v in xz.items()}
    h = np.random.default_rng(5).standard_normal((B, H, P, N)).astype(
        np.float32)
    y, hn = ssm.ssd_decode_step(t(step), t(params), SSMConfig(**KW),
                                torch.from_numpy(h))
    ry, rhn = ref_ssm.ssd_decode_step(j(step), j(params), RefSSMConfig(**KW),
                                      jnp.asarray(h))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(hn.numpy(), np.asarray(rhn), **TOL)


def test_bf16_state_is_cast_to_the_input_dtype():
    xz, params = seq_inputs(12, seed=6)
    bf = {k: torch.from_numpy(v).bfloat16() for k, v in xz.items()}
    y, h = ssm.ssd_forward(bf, t(params), SSMConfig(**KW), return_state=True)
    assert y.dtype == h.dtype == torch.bfloat16
    ry, rh = ref_ssm.ssd_forward(
        {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in xz.items()},
        j(params), RefSSMConfig(**KW), return_state=True)
    np.testing.assert_allclose(h.float().numpy(),
                               np.asarray(rh.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(ry.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_ssd_matches_sequential_recurrence():
    """The chunked form equals the per-step recurrence (the reference's
    ``tests/test_models.py`` test, on the port)."""
    cfg = SSMConfig(**KW)
    S = 24
    rng = np.random.default_rng(0)
    xz = {"x": torch.from_numpy(rng.standard_normal((B, S, H * P))).float(),
          "b": torch.from_numpy(rng.standard_normal((B, S, N))).float(),
          "c": torch.from_numpy(rng.standard_normal((B, S, N))).float(),
          "dt": torch.from_numpy(rng.standard_normal((B, S, H))).float()}
    params = {"A_log": torch.from_numpy(rng.uniform(0, 1, H)).float(),
              "D": torch.ones(H), "dt_bias": torch.zeros(H)}
    y_chunk, h_chunk = ssm.ssd_forward(xz, params, cfg, return_state=True)
    h = torch.zeros((B, H, P, N))
    ys = []
    for i in range(S):
        y, h = ssm.ssd_decode_step({k: v[:, i] for k, v in xz.items()},
                                   params, cfg, h)
        ys.append(y)
    y_seq = torch.stack(ys, dim=1)
    np.testing.assert_allclose(y_chunk.numpy(),
                               y_seq.reshape(B, S, H, P).numpy(),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(h_chunk.numpy(), h.numpy(), atol=2e-4,
                               rtol=1e-3)


def test_ssd_gradient_finite_where_the_masked_decay_overflows():
    """A fault of the reference (ROADMAP.md §3): it exponentiates the
    intra-chunk decay ``L_q - L_s`` above the diagonal too and zeroes it
    after, so where that passes fp32's exp range (a chunk of 16 steps at
    dt·|A| ≈ 8.5 here; a 256-step chunk at full width) its gradient with
    respect to ``dt`` (and ``A_log``) is NaN. The port masks the exponent
    first: its forward equals the reference's, and its gradient is finite
    and equals the reference's own gradient at chunk size 1 (the same
    function, with nothing above a diagonal)."""
    import jax
    kw = dict(KW, chunk_size=16)
    xz, params = seq_inputs(16, seed=3)
    xz["dt"] = np.full_like(xz["dt"], 2.0)
    params["A_log"] = np.full_like(params["A_log"], np.log(4.0))
    params["dt_bias"] = np.zeros_like(params["dt_bias"])

    def ref_loss(dt):
        return ref_ssm.ssd_forward(dict(j(xz), dt=dt), j(params),
                                   RefSSMConfig(**kw)).sum()

    r_grad = np.asarray(jax.grad(ref_loss)(jnp.asarray(xz["dt"])))
    assert np.isnan(r_grad).any()
    dt = torch.from_numpy(xz["dt"]).requires_grad_()
    y = ssm.ssd_forward(dict(t(xz), dt=dt), t(params), SSMConfig(**kw))
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(ref_ssm.ssd_forward(
            j(xz), j(params), RefSSMConfig(**kw))), **TOL)
    (g,) = torch.autograd.grad(y.sum(), dt)
    assert torch.isfinite(g).all()
    # the chunked form is the recurrence at any chunk size: at chunk 1
    # nothing lies above a diagonal, and the reference's own gradient is
    # finite there
    r_one = jax.grad(lambda dt: ref_ssm.ssd_forward(
        dict(j(xz), dt=dt), j(params),
        RefSSMConfig(**dict(kw, chunk_size=1))).sum())(jnp.asarray(xz["dt"]))
    np.testing.assert_allclose(g.numpy(), np.asarray(r_one), atol=1e-4,
                               rtol=1e-4)
