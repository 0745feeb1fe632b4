"""The port's expert-parallel MoE (``repro_torch/models/moe.py``:
``moe_ffn(..., mesh=...)`` and ``moe_shard``) against the reference's
``shard_map`` branch (``src/repro/models/moe.py:77-127``) on the CPU.

The reference runs once for the module, in a subprocess with four forced
XLA host devices on a mesh with Auto axes (``tests/torch_mesh_ref.py``):
meshes (2, 2), (1, 4) and (2, 1), the ``gcd`` fallback (6 experts over 4
model shards: ``ep = 2``, experts whole on every shard, no all-reduce,
capacity halved), and a skewed batch whose first data shard sends more
tokens to one expert than that shard's capacity holds. The port's output
on a CPU mesh of the same shape equals the reference's within 1e-5, and
so does each package's call with no mesh. The reference's ``shard_map``
refuses its own specs on the (2, 1) mesh (ROADMAP.md §3); its body runs
there with the check off."""
import dataclasses
import math
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as tc  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from torch_mesh_ref import MOE_B, MOE_CASES, MOE_S  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
BASE = tc.get_config("qwen3-moe-30b-a3b").reduced()


def ref_env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4",
                PYTHONPATH=os.pathsep.join(
                    p for p in (str(ROOT / "src"), str(ROOT / "tests"),
                                os.environ.get("PYTHONPATH")) if p))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_ep") / "ref.pkl"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"), "moe",
         str(path)], cwd=ROOT, env=ref_env(), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as fh:
        return pickle.load(fh)


def case(ref, name):
    r = ref[name]
    _, shape, E, _ = next(c for c in MOE_CASES if c[0] == name)
    mcfg = dataclasses.replace(BASE.moe, num_experts=E)
    x = torch.from_numpy(r["x"])
    p = {k: torch.from_numpy(v) for k, v in r["params"].items()}
    return r, mcfg, x, p, make_mesh(shape, ("data", "model"), "cpu")


@pytest.fixture
def routes(monkeypatch):
    """(capacity, dropped assignments) of each routing the port makes."""
    seen = []
    route = moe.route

    def counting(*a, **kw):
        r = route(*a, **kw)
        seen.append((r.cap, int((~r.keep).sum())))
        return r
    monkeypatch.setattr(moe, "route", counting)
    return seen


@pytest.mark.parametrize("name", [c[0] for c in MOE_CASES])
def test_moe_ffn_on_a_mesh_matches_reference(ref, name):
    r, mcfg, x, p, mesh = case(ref, name)
    got = moe.moe_ffn(x, p, mcfg, mesh=mesh)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), r["mesh"], **TOL)
    np.testing.assert_allclose(moe.moe_ffn(x, p, mcfg).numpy(), r["whole"],
                               **TOL)
    # the reference's shard_map raises on a mesh with one model shard
    assert (r["raised"] is not None) == (name == "2x1"), r["raised"]


def test_per_data_shard_capacity_drops_what_the_whole_batch_keeps(
        ref, routes):
    """Each data shard routes its own tokens: the first half of the batch
    sends its 16 tokens to expert 0, past its shard's capacity of 10, and
    the second half spreads 32 assignments over the other three; the
    whole batch's capacity of 20 keeps every assignment."""
    r, mcfg, x, p, mesh = case(ref, "drops")
    got = moe.moe_ffn(x, p, mcfg, mesh=mesh).numpy()
    whole = moe.moe_ffn(x, p, mcfg).numpy()
    T, k, E = MOE_B * MOE_S, mcfg.top_k, mcfg.num_experts
    cap_shard = math.ceil(T // 2 * k / E * mcfg.capacity_factor)
    cap_whole = math.ceil(T * k / E * mcfg.capacity_factor)
    # 4 positions route their data shard's tokens, then the whole call
    assert [c for c, _ in routes] == [cap_shard] * 4 + [cap_whole]
    drops = [n for _, n in routes]
    # the model shards of a data shard route alike
    assert drops[0] == drops[1] >= 6 and drops[2] == drops[3], drops
    assert drops[4] == 0
    gap = np.abs(got - whole).max(axis=(1, 2))
    assert gap[:MOE_B // 2].max() > 0.1, gap
    # the reference's mesh and whole calls differ the same way
    np.testing.assert_allclose(got, r["mesh"], **TOL)
    assert np.abs(r["mesh"] - r["whole"]).max() > 0.1


def test_gcd_fallback_keeps_experts_whole_and_halves_capacity(ref, routes):
    """6 experts over 4 model shards: ``ep = gcd(6, 4) = 2``; every shard
    holds all 6 experts and adds nothing across shards, yet ``ep`` still
    divides the capacity, as the reference does."""
    assert moe.expert_parallelism(6, 4) == 2
    assert moe.expert_parallelism(4, 4) == 4
    assert moe.expert_parallelism(5, 2) == 1
    r, mcfg, x, p, mesh = case(ref, "gcd_E6_M4")
    got = moe.moe_ffn(x, p, mcfg, mesh=mesh)
    T, k = MOE_B * MOE_S, mcfg.top_k
    cap = math.ceil(T * k / (6 * 2) * mcfg.capacity_factor)
    assert [c for c, _ in routes] == [cap] * 4
    np.testing.assert_allclose(got.numpy(), r["mesh"], **TOL)
    assert np.abs(r["mesh"] - r["whole"]).max() > 0.1


def test_expert_parallel_all_reduce_counts_bytes(ref):
    """On (1, 4) each model shard holds one expert and the partial
    combines are all-reduced over "model": each position counts the
    result's bytes once; (2, 1) has one model shard and adds nothing."""
    from repro_torch.distributed import spmd
    for name, want in (("1x4", MOE_B * MOE_S * BASE.d_model * 4),
                       ("2x1", 0)):
        _, mcfg, x, p, mesh = case(ref, name)
        spmd.reset_collective_bytes()
        moe.moe_ffn(x, p, mcfg, mesh=mesh)
        for r in range(mesh.size):
            assert spmd.collective_bytes(r)["all-reduce"] == want
