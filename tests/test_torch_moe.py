"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
``moe_ffn`` on the CPU, on the same numpy-seeded inputs: fp32 within 1e-5
with tokens dropped at the default capacity factor (the same tokens in
both packages) and with none dropped, ties in the router logits broken to
the lower expert index as ``jax.lax.top_k`` breaks them, bf16 within
2e-2, one token (a decode step: capacity 1), and the expert-parallel
branch on a one-data-shard mesh, which needs the mesh's devices."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig as RefMoEConfig  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402

from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402


def inputs(T, d=32, E=8, f=24, seed=0, tie=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, T, d)).astype(np.float32)
    p = {"router": rng.standard_normal((d, E)).astype(np.float32),
         "w_gate": rng.standard_normal((E, d, f)).astype(np.float32) / 6,
         "w_up": rng.standard_normal((E, d, f)).astype(np.float32) / 6,
         "w_down": rng.standard_normal((E, f, d)).astype(np.float32) / 5}
    if tie:     # experts 2 and 5 (and 3 and 6) route alike: exact ties
        p["router"][:, 5] = p["router"][:, 2]
        p["router"][:, 6] = p["router"][:, 3]
    return x, p


def run_both(x, p, cf, k=2, dtype=torch.float32, jdtype=jnp.float32):
    E = p["w_gate"].shape[0]
    want = ref_moe.moe_ffn(jnp.asarray(x, jdtype),
                           {n: jnp.asarray(v, jdtype) for n, v in p.items()},
                           RefMoEConfig(E, k, capacity_factor=cf))
    got = moe.moe_ffn(torch.from_numpy(x).to(dtype),
                      {n: torch.from_numpy(v).to(dtype)
                       for n, v in p.items()},
                      MoEConfig(E, k, capacity_factor=cf))
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def changed_tokens(out, no_drop):
    """Tokens whose output differs from the run where nothing drops."""
    return set(np.nonzero(np.abs(out - no_drop).max(-1)[0] > 1e-6)[0])


def test_dropped_tokens_match_reference():
    x, p = inputs(T=48)
    got, want = run_both(x, p, 1.25)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    got_all, want_all = run_both(x, p, 8.0)
    np.testing.assert_allclose(got_all, want_all, atol=1e-5, rtol=1e-5)
    # the port's routing says which tokens lost an assignment; the
    # reference's outputs say which changed when the capacity was cut
    r = moe.route(torch.from_numpy(x[0]), torch.from_numpy(p["router"]),
                  MoEConfig(8, 2, capacity_factor=1.25))
    dropped = set(np.nonzero(~r.keep.reshape(48, 2).all(-1).numpy())[0])
    assert len(dropped) > 0
    assert dropped == changed_tokens(want, want_all) == changed_tokens(
        got, got_all)
    assert r.cap == 15               # ceil(48 * 2 / 8 * 1.25)


def test_ties_break_to_the_lower_expert_like_lax_top_k():
    x, p = inputs(T=40, tie=True)
    got, want = run_both(x, p, 1.25)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    logits = x[0] @ p["router"]
    _, ref_idx = jax.lax.top_k(jnp.asarray(logits), 2)
    r = moe.route(torch.from_numpy(x[0]), torch.from_numpy(p["router"]),
                  MoEConfig(8, 2))
    np.testing.assert_array_equal(r.top_idx.numpy(), np.asarray(ref_idx))
    assert (np.asarray(ref_idx)[:, 0] == 2).any()   # a tie was at the top


@pytest.mark.parametrize("T", [1, 3])
def test_few_tokens_match_reference(T):
    """A decode step's T = 1 gives capacity 1: every expert's weights are
    read, and no assignment drops (each token picks distinct experts)."""
    x, p = inputs(T=T, seed=T)
    got, want = run_both(x, p, 1.25, k=3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_bf16_matches_reference():
    x, p = inputs(T=64, seed=2)
    got, want = run_both(x, p, 1.25, dtype=torch.bfloat16,
                         jdtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_expert_parallel_branch_raises():
    """The expert-parallel branch is ported (held to the reference's in
    ``tests/test_torch_moe_ep.py``): on a mesh of one data shard and two
    model shards it gives the unsharded output; a mesh that is only a
    description, with no devices, raises."""
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch.mesh import make_mesh
    x, p = inputs(T=4)
    x, p = torch.from_numpy(x), {n: torch.from_numpy(v) for n, v in p.items()}
    got = moe.moe_ffn(x, p, MoEConfig(8, 2),
                      mesh=make_mesh((1, 2), ("data", "model"), "cpu"))
    torch.testing.assert_close(got, moe.moe_ffn(x, p, MoEConfig(8, 2)),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="make_mesh"):
        moe.moe_ffn(x, p, MoEConfig(8, 2),
                    mesh=Mesh(("data", "model"), (1, 2)))
