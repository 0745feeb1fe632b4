"""The port's model numerics against the reference's
(``src/repro/models/common.py``) on the same numpy inputs: RMSNorm's
``(1 + scale)``, the half-split RoPE, SwiGLU's fp32 silu, and the weight
tree. Tolerance: fp32 atol=rtol=1e-5."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import common as jcommon  # noqa: E402

import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.params import (from_jax_params, init_params,  # noqa: E402
                                       param_shapes)

TOL = dict(atol=1e-5, rtol=1e-5)
RNG = np.random.default_rng(0)


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 16)])
def test_rms_norm(shape):
    x = RNG.standard_normal(shape).astype(np.float32)
    scale = (0.1 * RNG.standard_normal(shape[-1])).astype(np.float32)
    close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
          jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))


def test_rms_norm_scales_by_one_plus():
    """Zero-initialised norm weights leave the normalised input unscaled."""
    x = torch.tensor([[3.0, 4.0]])
    out = common.rms_norm(x, torch.zeros(2), 0.0)
    torch.testing.assert_close(out, x / (12.5 ** 0.5))


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope_half_split(theta):
    x = RNG.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = (RNG.integers(0, 900, (2, 7))).astype(np.int32)
    close(common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
          jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_swiglu():
    x = RNG.standard_normal((2, 3, 32)).astype(np.float32)
    wg, wu = (RNG.standard_normal((32, 48)).astype(np.float32) / 6
              for _ in range(2))
    wd = RNG.standard_normal((48, 32)).astype(np.float32) / 7
    close(common.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd))),
          jcommon.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd))))


@pytest.mark.parametrize("name", ["bfloat16", "float32", "float16"])
def test_dtype_of(name):
    assert str(common.dtype_of(name)) == "torch." + name


def test_param_tree_matches_reference_runner_layout():
    """init_params draws the tree the runner consumes, shaped as the
    reference runner's flattened layers and head; the bridge carries the
    reference's values over unchanged."""
    from repro.configs import GH200, ServingConfig, get_config
    from repro.serving.paged_runner import PagedModelRunner
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32", num_layers=2)
    ref = PagedModelRunner(cfg, ServingConfig(num_hbm_blocks=8,
                                              block_size=4), GH200, seed=1)
    tc = dataclasses.replace(tcfg.get_config("llama3-8b").reduced(),
                             dtype="float32", num_layers=2)
    drawn = init_params(tc, torch.Generator().manual_seed(1), "cpu",
                        torch.float32)
    bridged = from_jax_params(ref._layers, ref._head, "cpu", torch.float32)
    layer_shapes, head_shapes = param_shapes(tc)
    for tree in (drawn, bridged):
        assert len(tree["layers"]) == 2
        for layer, ref_layer in zip(tree["layers"], ref._layers):
            assert set(layer) == set(ref_layer) == set(layer_shapes)
            for k, v in layer.items():
                assert tuple(v.shape) == tuple(ref_layer[k].shape)
        assert set(tree["head"]) == set(ref._head) == set(head_shapes)
    for k, v in bridged["layers"][1].items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(ref._layers[1][k]))
    # the reference's init rules: zeros for norms, 1/sqrt(fan_in) normals
    assert not drawn["layers"][0]["ln1"].any()
    std = drawn["head"]["embed"].std().item() * np.sqrt(tc.vocab_size)
    assert 0.9 < std < 1.1
