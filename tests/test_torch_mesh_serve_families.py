"""Prefill and decode of the MoE, SSM and hybrid families on a (data,
model) mesh: the port's ``LM.prefill(..., mesh=)`` under ``PREFILL_RULES``
and ``LM.decode_step(..., mesh=)`` under ``DECODE_RULES`` against the
reference's jitted ``lm.prefill`` / ``lm.decode_step`` under
``sharding_ctx`` of an Auto mesh on four XLA host devices, and against
the port's own ``LM`` with no mesh; the caches' layout; and the tokens
the experts drop on each side.

The reference runs in a subprocess started with the module
(``tests/torch_mesh_ref.py serve_families``): reduced configs in fp32,
``PRNGKey(0)`` weights (bridged by ``from_jax_lm_params``), batch 4, a
28-token prompt and 6 decode steps (numpy seed 0): qwen3-moe (4 experts,
top-2) on (2, 2) and (1, 4) at capacity 64, mamba2 on (2, 2) and on (1,
2) with expand 3 and head_dim 64 (d_in 192 splits over "model", its 3
heads do not) at capacity 64, and jamba at one 8-layer period (one
attention layer, seven SSM layers, MoE on the odd layers) on (2, 2) at
capacity 62, which the decode's ``kv_seq`` split over four positions
does not divide. The prefill's logits and caches (gathered), every
decode step's logits and the last caches agree within atol 1e-5 + rtol
1e-5: fp32, the partial sums add in another order.

Against no mesh the prefill routes each data row's tokens on its own, so
its capacity counts them and not the whole batch's: there the MoE
configs run at ``capacity_factor`` = E, where no expert drops a token on
either side (counted), and hold the same tolerance."""
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_ref import (SERVE_B, SERVE_FAMILY_CASES,  # noqa: E402
                            SERVE_PROMPT, SERVE_STEPS, family_cfg,
                            serve_family_name)

import repro_torch.configs as tc  # noqa: E402
from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.distributed.sharding import (DECODE_RULES,  # noqa: E402
                                              PREFILL_RULES, pspec_for)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.models.params import (from_jax_lm_params,  # noqa: E402
                                       init_lm_params, layers_of_segments)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
CASES = [pytest.param(arch, shape, cap, over,
                      id=serve_family_name(arch, shape, cap, over))
         for arch, shape, cap, over in SERVE_FAMILY_CASES]


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_serve_families") / "sf.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT / "src"), str(ROOT / "tests"),
                               os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"),
         "serve_families", str(path)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield path, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _one_thread(ref_proc):
    # tiny CPU tensors: a thread pool costs more than it saves (the
    # reference's subprocess starts first and runs beside this module)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(ref_proc):
    path, proc = ref_proc
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    with open(path, "rb") as fh:
        return pickle.load(fh)


def cpu_mesh(shape):
    return make_mesh(shape, ("data", "model"), "cpu")


def one_of(per_position):
    """The logits every position holds: equal, so position 0's."""
    for t in per_position[1:]:
        assert torch.equal(t, per_position[0])
    return per_position[0]


def counting_drops(monkeypatch):
    """Every routing's dropped assignments, appended to the list returned
    (``moe.route_logits`` serves the prefill's and the decode's)."""
    seen = []
    orig = moe.route_logits

    def count(*a, **kw):
        r = orig(*a, **kw)
        seen.append(int((~r.keep).sum()))
        return r
    monkeypatch.setattr(moe, "route_logits", count)
    return seen


def serve(lm, params, toks, cap, mesh=None):
    """Prefill then ``SERVE_STEPS`` decode steps on the tokens' columns:
    (prefill logits, prefill caches, [step logits], last caches), whole
    tensors; on a mesh the weights placed under ``PREFILL_RULES`` and the
    caches moved to the decode layout between the two."""
    placed = (spmd.place_tree(params, lm.param_axes(), mesh, PREFILL_RULES)
              if mesh is not None else params)
    logits, caches = lm.prefill(placed, {"tokens": toks[:, :SERVE_PROMPT]},
                                cap, mesh=mesh)
    if mesh is not None:
        logits = one_of(logits)
        first = spmd.gather_tree(caches)
        caches = lm.caches_for_decode(caches)
    else:
        first = [{k: t.clone() for k, t in c.items()} for c in caches]
    steps = []
    for i in range(SERVE_STEPS):
        out, caches = lm.decode_step(placed, caches, {
            "token": toks[:, SERVE_PROMPT + i],
            "cache_len": SERVE_PROMPT + i}, mesh=mesh)
        steps.append(one_of(out) if mesh is not None else out)
    last = spmd.gather_tree(caches) if mesh is not None else caches
    return logits, first, steps, last


@pytest.mark.parametrize("arch,shape,cap,over", CASES)
def test_mesh_serve_families_match_reference(ref, arch, shape, cap, over):
    """The port on the mesh against the reference under ``sharding_ctx``
    on the same mesh: the prefill's logits and caches, each decode step's
    logits and the last caches; the caches cut as the rules say."""
    c = ref[serve_family_name(arch, shape, cap, over)]
    assert c["raised"] is None, c["raised"]
    cfg = family_cfg(tc, arch, over)
    lm = LM(cfg)
    mesh = cpu_mesh(shape)
    params = from_jax_lm_params(c["params"], cfg, "cpu")
    toks = torch.from_numpy(c["tokens"]).long()
    placed = spmd.place_tree(params, lm.param_axes(), mesh, PREFILL_RULES)
    logits, caches = lm.prefill(placed, {"tokens": toks[:, :SERVE_PROMPT]},
                                cap, mesh=mesh)
    np.testing.assert_allclose(one_of(logits).numpy(), c["prefill"], **TOL)
    specs = lm.cache_specs(SERVE_B, cap)
    for rules, got, want in ((PREFILL_RULES, caches, c["prefill_caches"]),
                             (DECODE_RULES, None, c["decode_caches"])):
        if got is None:
            caches = lm.caches_for_decode(caches)
            for i in range(SERVE_STEPS):
                out, caches = lm.decode_step(placed, caches, {
                    "token": toks[:, SERVE_PROMPT + i],
                    "cache_len": SERVE_PROMPT + i}, mesh=mesh)
                np.testing.assert_allclose(
                    one_of(out).numpy(), c["decode"][i], **TOL,
                    err_msg=f"decode step {i}")
            got = caches
        for layer, c_got, c_want in zip(specs, got, layers_of_segments(
                lm.program, want), strict=True):
            assert set(c_got) == set(layer)
            for k, x in c_got.items():
                assert x.spec == pspec_for(layer[k].logical_axes, mesh,
                                           rules, x.shape), (k, x.spec)
                np.testing.assert_allclose(
                    spmd.gather(x).numpy(), np.asarray(c_want[k]), **TOL,
                    err_msg=f"{k} under {rules}")


def test_ssm_caches_lie_on_channels_and_heads():
    """The reduced mamba2's caches on (2, 2): the prefill's batch over
    "data", ``conv_x``'s channels and ``h``'s heads over "model"; the
    decode's batch whole, the same channels and heads over "model", and
    ``conv_b``/``conv_c`` whole on every position. On (1, 2) with 3 heads
    of 64 the heads stay whole and the channels split."""
    for over, shape, want in (
            ({}, (2, 2), {"prefill": {"conv_x": ("data", None, "model"),
                                      "conv_b": ("data",),
                                      "h": ("data", "model")},
                          "decode": {"conv_x": (None, None, "model"),
                                     "conv_b": (), "h": (None, "model")}}),
            ({"ssm": dict(expand=3, head_dim=64)}, (1, 2),
             {"prefill": {"conv_x": ("data", None, "model"),
                          "conv_b": ("data",), "h": ("data",)},
              "decode": {"conv_x": (None, None, "model"), "conv_b": (),
                         "h": ()}})):
        cfg = family_cfg(tc, "mamba2-2.7b", over)
        lm = LM(cfg)
        mesh = cpu_mesh(shape)
        params = spmd.place_tree(
            init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu"),
            lm.param_axes(), mesh, PREFILL_RULES)
        _, caches = lm.prefill(params, {"tokens": torch.zeros(
            (SERVE_B, 8), dtype=torch.long)}, 16, mesh=mesh)
        for kind in ("prefill", "decode"):
            if kind == "decode":
                caches = lm.caches_for_decode(caches)
            for k, spec in want[kind].items():
                assert caches[0][k].spec == spec, (kind, k)
            assert caches[0]["conv_c"].spec == want[kind]["conv_b"]


@pytest.mark.parametrize("arch,shape,cap,over", CASES)
def test_mesh_serve_families_match_no_mesh(ref, monkeypatch, arch, shape,
                                           cap, over):
    """The same cases (the reference's weights and tokens) against the
    port's ``LM`` with no mesh, the MoE layers at ``capacity_factor`` =
    E, where neither side drops a token."""
    c = ref[serve_family_name(arch, shape, cap, over)]
    cfg = family_cfg(tc, arch, over)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    lm = LM(cfg)
    params = from_jax_lm_params(c["params"], cfg, "cpu")
    toks = torch.from_numpy(c["tokens"]).long()
    drops = counting_drops(monkeypatch)
    want = serve(lm, params, toks, cap)
    got = serve(lm, params, toks, cap, cpu_mesh(shape))
    assert (len(drops) > 0) == (cfg.moe is not None)
    assert sum(drops) == 0, drops
    torch.testing.assert_close(got[0], want[0], **TOL)
    for g, w in zip(got[1] + got[3], want[1] + want[3], strict=True):
        assert set(g) == set(w)
        for k in g:
            torch.testing.assert_close(g[k], w[k], **TOL, msg=k)
    for i, (g, w) in enumerate(zip(got[2], want[2], strict=True)):
        torch.testing.assert_close(g, w, **TOL, msg=f"decode step {i}")


def test_mesh_prefill_drops_count_each_data_row(monkeypatch):
    """At the default capacity the reduced qwen3-moe's mesh prefill on
    (2, 2) routes each data row's 2 x 28 tokens against a capacity of 35
    (no mesh: all 4 x 28 against 70); its decode steps route the whole
    batch on every position (capacity 3, as no mesh's) and drop alike at
    every position."""
    cfg = family_cfg(tc, "qwen3-moe-30b-a3b", {})
    lm = LM(cfg)
    params = init_lm_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT + SERVE_STEPS))).long()
    caps = []
    orig = moe.route_logits

    def record(*a, **kw):
        r = orig(*a, **kw)
        caps.append((r.cap, int((~r.keep).sum())))
        return r
    monkeypatch.setattr(moe, "route_logits", record)
    serve(lm, params, toks, 64)
    no_mesh = list(caps)
    caps.clear()
    serve(lm, params, toks, 64, cpu_mesh((2, 2)))
    L = cfg.num_layers
    assert [c for c, _ in no_mesh] == [70] * L + [3] * L * SERVE_STEPS
    assert [c for c, _ in caps] == ([35] * 4 * L
                                    + [3] * 4 * L * SERVE_STEPS)
    dec = [d for _, d in caps[4 * L:]]
    assert all(dec[i:i + 4] == [dec[i]] * 4 for i in range(0, len(dec), 4))
