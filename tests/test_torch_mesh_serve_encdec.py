"""Prefill and decode of the frontend and encoder-decoder families on a
(data, model) mesh: the port's ``LM.prefill(..., mesh=)`` under
``PREFILL_RULES`` and ``LM.decode_step(..., mesh=)`` under
``DECODE_RULES`` against the reference's jitted ``lm.prefill`` /
``lm.decode_step`` under ``sharding_ctx`` of an Auto mesh on four XLA
host devices, and against the port's own ``LM`` with no mesh; and the
cross caches' layout.

The reference runs in a subprocess started with the module
(``tests/torch_mesh_ref.py serve_encdec``): reduced configs in fp32,
``PRNGKey(0)`` weights (bridged by ``from_jax_lm_params``), batch 4,
capacity 64, 6 decode steps: paligemma (4 heads, one kv head of 16) with
8 image embeddings ahead of a 20-token prompt, and seamless (2 encoder
layers, 4 decoder layers with cross-attention, 4 heads over 2 kv heads)
with a 28-token prompt over 8 source frames, each on (2, 2), (1, 4) and
(4, 1); and seamless over 6 source frames on (2, 2), whose cross caches
keep their frames whole in the decode (four pieces do not divide them).
Tokens and embeddings come from numpy seed 0. Every decode writes slots
28-33, across the boundary at 32 between two positions' pieces. The
prefill's logits and caches (``ck``/``cv`` included, gathered), every
decode step's logits and the last caches agree within atol 1e-5 + rtol
1e-5: fp32, the distributed softmax and the partial sums add in another
order."""
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_ref import (SERVE_B, SERVE_ENCDEC_CAP,  # noqa: E402
                            SERVE_ENCDEC_CASES, SERVE_PROMPT, SERVE_STEPS,
                            frontend_key, serve_encdec_cfg,
                            serve_encdec_name, serve_prompt)

import repro_torch.configs as tc  # noqa: E402
from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.distributed.sharding import (DECODE_RULES,  # noqa: E402
                                              PREFILL_RULES, pspec_for)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.models.params import (from_jax_lm_params,  # noqa: E402
                                       init_lm_params, layers_of_segments)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
CAP = SERVE_ENCDEC_CAP
CASES = [pytest.param(arch, shape, frames,
                      id=serve_encdec_name(arch, shape, frames))
         for arch, shape, frames in SERVE_ENCDEC_CASES]


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_serve_encdec") / "se.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT / "src"), str(ROOT / "tests"),
                               os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"),
         "serve_encdec", str(path)], cwd=ROOT, env=env,
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


def prefill_batch(cfg, toks, embeds):
    """The prompt's ``serve_prompt`` tokens and the frontend's embeddings
    under their key."""
    batch = {"tokens": toks[:, :serve_prompt(cfg)]}
    batch[frontend_key(cfg)] = embeds
    return batch


def serve(lm, params, toks, embeds, mesh=None):
    """Prefill then ``SERVE_STEPS`` decode steps (``cache_len`` from
    ``SERVE_PROMPT``: a frontend's embeddings counted): (prefill logits,
    prefill caches whole, their specs on a mesh, [step logits], last
    caches); on a mesh the weights placed under ``PREFILL_RULES`` and the
    caches moved to the decode layout between the two."""
    cfg = lm.cfg
    placed = (spmd.place_tree(params, lm.param_axes(), mesh, PREFILL_RULES)
              if mesh is not None else params)
    logits, caches = lm.prefill(placed, prefill_batch(cfg, toks, embeds),
                                CAP, mesh=mesh)
    specs = None
    if mesh is not None:
        logits = one_of(logits)
        first = spmd.gather_tree(caches)
        specs = [{k: x.spec for k, x in c.items()} for c in caches]
        caches = lm.caches_for_decode(caches)
    else:
        first = [{k: t.clone() for k, t in c.items()} for c in caches]
    plen, steps = serve_prompt(cfg), []
    for i in range(SERVE_STEPS):
        out, caches = lm.decode_step(placed, caches, {
            "token": toks[:, plen + i], "cache_len": SERVE_PROMPT + i},
            mesh=mesh)
        steps.append(one_of(out) if mesh is not None else out)
    return logits, first, specs, steps, caches


def case_inputs(ref, arch, shape, frames):
    c = ref[serve_encdec_name(arch, shape, frames)]
    assert c["raised"] is None, c["raised"]
    cfg = serve_encdec_cfg(tc, arch, frames)
    return (c, cfg, from_jax_lm_params(c["params"], cfg, "cpu"),
            torch.from_numpy(c["tokens"]).long(),
            torch.from_numpy(c["embeds"]))


@pytest.mark.parametrize("arch,shape,frames", CASES)
def test_mesh_serve_encdec_match_reference(ref, arch, shape, frames):
    """The port on the mesh against the reference under ``sharding_ctx``
    on the same mesh: the prefill's logits and caches, each decode step's
    logits and the last caches, every cache (the cross caches too) cut as
    ``pspec_for`` lays it out under each rule set."""
    c, cfg, params, toks, embeds = case_inputs(ref, arch, shape, frames)
    lm = LM(cfg)
    mesh = cpu_mesh(shape)
    logits, first, specs, steps, last = serve(lm, params, toks, embeds,
                                              mesh)
    np.testing.assert_allclose(logits.numpy(), c["prefill"], **TOL)
    for i, out in enumerate(steps):
        np.testing.assert_allclose(out.numpy(), c["decode"][i], **TOL,
                                   err_msg=f"decode step {i}")
    src_len = embeds.shape[1] if cfg.num_encoder_layers else 0
    layers = lm.cache_specs(SERVE_B, CAP, src_len)
    last_specs = [{k: x.spec for k, x in c_.items()} for c_ in last]
    for rules, got, got_specs, want in (
            (PREFILL_RULES, first, specs, c["prefill_caches"]),
            (DECODE_RULES, spmd.gather_tree(last), last_specs,
             c["decode_caches"])):
        for layer, c_got, s_got, c_want in zip(
                layers, got, got_specs,
                layers_of_segments(lm.program, want), strict=True):
            assert set(c_got) == set(layer) == set(c_want)
            assert ("ck" in layer) == bool(cfg.num_encoder_layers)
            for k, x in c_got.items():
                assert s_got[k] == pspec_for(layer[k].logical_axes, mesh,
                                             rules, layer[k].shape), k
                np.testing.assert_allclose(
                    x.numpy(), np.asarray(c_want[k]), **TOL,
                    err_msg=f"{k} under {rules}")


@pytest.mark.parametrize("arch,shape,frames", CASES)
def test_mesh_serve_encdec_match_no_mesh(ref, arch, shape, frames):
    """The same cases (the reference's weights, tokens and embeddings)
    against the port's ``LM`` with no mesh."""
    _, cfg, params, toks, embeds = case_inputs(ref, arch, shape, frames)
    lm = LM(cfg)
    want = serve(lm, params, toks, embeds)
    got = serve(lm, params, toks, embeds, cpu_mesh(shape))
    torch.testing.assert_close(got[0], want[0], **TOL)
    last = spmd.gather_tree(got[4])
    for g, w in zip(got[1] + last, want[1] + want[4], strict=True):
        assert set(g) == set(w)
        for k in g:
            torch.testing.assert_close(g[k], w[k], **TOL, msg=k)
    for i, (g, w) in enumerate(zip(got[3], want[3], strict=True)):
        torch.testing.assert_close(g, w, **TOL, msg=f"decode step {i}")


def test_cross_caches_lie_as_the_rules_say():
    """The reduced seamless's cross caches on (2, 2): over 8 frames the
    prefill's batch over "data" and frames over "model", the decode's
    frames over the whole grid; over 6 frames the prefill splits them
    over "model" too (two pieces divide them), while the decode, whose
    four pieces do not, keeps the frames whole and splits the kv heads
    over "model". The cross caches are read, never written:
    the decode steps leave them as the prefill made them."""
    for frames, want in ((8, {"prefill": ("data", "model"),
                              "decode": (None, ("data", "model"))}),
                         (6, {"prefill": ("data", "model"),
                              "decode": (None, None, "model")})):
        cfg = serve_encdec_cfg(tc, "seamless-m4t-medium", frames)
        lm = LM(cfg)
        params = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT + SERVE_STEPS))).long()
        embeds = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (SERVE_B, frames, cfg.frontend.embed_dim)).astype(np.float32))
        _, first, specs, _, last = serve(lm, params, toks, embeds,
                                         cpu_mesh((2, 2)))
        for layer, s, c in zip(first, specs, last, strict=True):
            for k in ("ck", "cv"):
                assert s[k] == want["prefill"], (frames, k, s[k])
                assert c[k].spec == want["decode"], (frames, k, c[k].spec)
                assert torch.equal(spmd.gather(c[k]), layer[k])
