"""Training, prefill and decode on the multi-pod mesh ("pod", "data",
"model"): the port's mesh path on (2, 2, 2) against the reference's
jitted steps under ``sharding_ctx`` of an Auto mesh on eight XLA host
devices, and the port against itself on meshes that must agree.

The reference runs in one subprocess started with the module
(``tests/torch_mesh_ref.py pod``, about 40 s): reduced configs in fp32
from ``PRNGKey(0)`` weights (bridged by ``from_jax_lm_params``).

- One train step of llama3-8b and qwen3-moe-30b-a3b, batch 4 x 32 in 2
  microbatches (``SyntheticPacked`` seed 0). Each microbatch's 2 rows do
  not split over the 4 (pod, data) positions, so ``pspec_for`` keeps the
  activations whole on every position, while the MoE's ``shard_map``
  drops "pod" alone and splits the rows over "data": both of the
  reference's drop rules at once. Loss and grad norm within 1e-5
  relative, new parameters within atol 1e-5 and rtol 1e-4, fp32 moments
  within atol 1e-6 (``tests/test_torch_mesh_train.py``'s tolerances).
- A 28-token prefill under ``PREFILL_RULES`` at capacity 64 and 6 decode
  steps under ``DECODE_RULES`` (numpy seed 0) of llama3-8b,
  qwen3-moe-30b-a3b, mamba2-2.7b and seamless-m4t-medium at batch 4 (one
  row a (pod, data) position) and llama3-8b at batch 2 (whole on every
  position): the prefill's logits and caches, every step's logits and
  the last caches within atol 1e-5 + rtol 1e-5
  (``tests/test_torch_mesh_serve*.py``'s), each cache laid out as
  ``pspec_for`` says; the two pods' logits are equal bit for bit.

Without the reference: (1, 2, 2) equals (2, 2) bit for bit in train,
prefill and decode; (2, 1, 1) equals no mesh within fp32 rounding (atol
1e-5 + rtol 1e-5); a (2, 2, 2) checkpoint restores onto (2, 2) and onto
no mesh; the bytes a position holds equal the dry-run's."""
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as rc  # noqa: E402
from repro.models.lm import LM as RefLM  # noqa: E402
from test_torch_train_step import port_tree  # noqa: E402
from torch_mesh_ref import (POD_CAP, POD_DEVICES,  # noqa: E402
                            POD_SERVE_CASES, POD_SHAPE, POD_TRAIN_ARCHS,
                            SERVE_PROMPT, SERVE_STEPS, TRAIN_B, TRAIN_MB,
                            TRAIN_S, frontend_key, pod_serve_name,
                            serve_prompt)

import repro_torch.configs as tc  # noqa: E402
from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import SyntheticPacked  # noqa: E402
from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.distributed.sharding import (DECODE_RULES,  # noqa: E402
                                              PREFILL_RULES, TRAIN_RULES,
                                              pspec_for)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import (specs_logical_axes,  # noqa: E402
                                       specs_to_structs)
from repro_torch.models.lm import LM, batch_split  # noqa: E402
from repro_torch.models.params import (from_jax_lm_params,  # noqa: E402
                                       init_lm_params, layers_of_segments)
from repro_torch.optimizer import adamw  # noqa: E402
from repro_torch.training import step as steplib  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
POD = ("pod", "data", "model")


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_pod") / "pod.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=("--xla_force_host_platform_device_count="
                          f"{POD_DEVICES}"),
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT / "src"), str(ROOT / "tests"),
                               os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"), "pod",
         str(path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
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


def cfg_of(arch):
    return dataclasses.replace(tc.get_config(arch).reduced(),
                               dtype="float32")


def mesh_of(shape):
    return make_mesh(shape, POD[-len(shape):], "cpu")


def torch_batch(np_batch):
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in np_batch.items()}
    for k in ("tokens", "labels"):
        b[k] = b[k].long()
    return b


def one_of(per_position):
    """The logits every position holds: equal bit for bit (the two pods'
    too), so position 0's."""
    for t in per_position[1:]:
        assert torch.equal(t, per_position[0])
    return per_position[0]


def test_batch_drop_rules():
    """``pspec_for`` drops the batch's ("pod", "data") whole where its
    positions do not divide the batch; the MoE's rows drop "pod" first
    and keep "data" (``moe.moe_batch_axes``, the reference's
    ``moe_ffn``)."""
    mesh = mesh_of(POD_SHAPE)
    for B, act, rows in ((4, ("pod", "data"), ("pod", "data")),
                         (8, ("pod", "data"), ("pod", "data")),
                         (2, (), ("data",)), (6, (), ("data",)),
                         (3, (), ())):
        for rules in (TRAIN_RULES, PREFILL_RULES):
            assert batch_split(mesh, rules, B) == act, B
        assert moe.moe_batch_axes(mesh, B) == rows, B
    assert batch_split(mesh, DECODE_RULES, 4) == ()
    two = mesh_of((2, 2))
    assert batch_split(two, TRAIN_RULES, 2) == ("data",)
    assert moe.moe_batch_axes(two, 3) == ()


@pytest.mark.parametrize("arch", POD_TRAIN_ARCHS)
def test_pod_train_step_matches_reference(ref, monkeypatch, arch):
    """The MoE's capacity counts one data row's tokens (a row of 32):
    the rows split over "data" while the activations stay whole."""
    r = ref["train"][arch]
    cfg = cfg_of(arch)
    lm = LM(cfg)
    opt = adamw.AdamWConfig(warmup_steps=1)
    params = from_jax_lm_params(r["params0"], cfg, "cpu")
    state = steplib.place_state(lm, opt, steplib.TrainState(
        params, adamw.init_state(params, opt)), mesh_of(POD_SHAPE))
    fn = steplib.make_train_step(lm, opt, microbatches=TRAIN_MB,
                                 mesh=mesh_of(POD_SHAPE))
    caps, route = [], moe.route_logits

    def record(*a, **kw):
        out = route(*a, **kw)
        caps.append((out.cap, a[0].shape[0]))
        return out
    monkeypatch.setattr(moe, "route_logits", record)
    new, m = fn(state, torch_batch(r["batch"]))
    if cfg.moe is not None:
        row = TRAIN_B // TRAIN_MB // POD_SHAPE[1] * TRAIN_S
        one = route(torch.zeros(row, cfg.moe.num_experts), cfg.moe).cap
        assert caps and set(caps) == {(one, row)}, set(caps)
    np.testing.assert_allclose(float(m["loss"]), r["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), r["grad_norm"],
                               rtol=1e-5)
    ref_lm = RefLM(dataclasses.replace(rc.get_config(arch).reduced(),
                                       dtype="float32"))
    for tree, got, tol in (
            (r["state"].params, new.params, dict(atol=1e-5, rtol=1e-4)),
            (r["state"].opt.m, new.opt.m, dict(atol=1e-6, rtol=0)),
            (r["state"].opt.v, new.opt.v, dict(atol=1e-6, rtol=0))):
        pairs = []
        tree_map(lambda w, g: pairs.append((w, g)), port_tree(ref_lm, tree),
                 got)
        assert len(pairs) == len(tree_leaves(new.params))
        for i, (w, g) in enumerate(pairs):
            np.testing.assert_allclose(spmd.gather(g).numpy(),
                                       np.asarray(w), **tol,
                                       err_msg=f"leaf {i}")


def prefill_batch(cfg, toks, embeds):
    batch = {"tokens": toks[:, :serve_prompt(cfg)]}
    key = frontend_key(cfg)
    if key is not None:
        batch[key] = torch.from_numpy(embeds)
    return batch


def serve(lm, params, toks, embeds, mesh=None):
    """Prefill at ``POD_CAP`` then ``SERVE_STEPS`` decode steps: (prefill
    logits, prefill caches whole and their specs, [step logits], last
    caches whole and their specs); on a mesh the weights placed under
    ``PREFILL_RULES`` and the caches moved to the decode layout between
    the two."""
    cfg = lm.cfg
    placed = (spmd.place_tree(params, lm.param_axes(), mesh, PREFILL_RULES)
              if mesh is not None else params)
    logits, caches = lm.prefill(placed, prefill_batch(cfg, toks, embeds),
                                POD_CAP, mesh=mesh)

    def whole(cs):
        if mesh is None:
            return [{k: t.clone() for k, t in c.items()} for c in cs], None
        return (spmd.gather_tree(cs),
                [{k: x.spec for k, x in c.items()} for c in cs])
    if mesh is not None:
        logits = one_of(logits)
    first = whole(caches)
    if mesh is not None:
        caches = lm.caches_for_decode(caches)
    plen, steps = serve_prompt(cfg), []
    for i in range(SERVE_STEPS):
        out, caches = lm.decode_step(placed, caches, {
            "token": toks[:, plen + i], "cache_len": SERVE_PROMPT + i},
            mesh=mesh)
        steps.append(one_of(out) if mesh is not None else out)
    return logits, first, steps, whole(caches)


@pytest.mark.parametrize("arch,batch", [
    pytest.param(a, b, id=pod_serve_name(a, b)) for a, b in POD_SERVE_CASES])
def test_pod_serve_matches_reference(ref, arch, batch):
    c = ref["serve"][pod_serve_name(arch, batch)]
    assert c["raised"] is None, c["raised"]
    cfg = cfg_of(arch)
    lm = LM(cfg)
    mesh = mesh_of(POD_SHAPE)
    params = from_jax_lm_params(c["params"], cfg, "cpu")
    toks = torch.from_numpy(c["tokens"]).long()
    logits, first, steps, last = serve(lm, params, toks, c["embeds"], mesh)
    np.testing.assert_allclose(logits.numpy(), c["prefill"], **TOL)
    for i, z in enumerate(steps):
        np.testing.assert_allclose(z.numpy(), c["decode"][i], **TOL,
                                   err_msg=f"decode step {i}")
    src = c["embeds"].shape[1] if frontend_key(cfg) == "src_embeds" else 0
    layers = lm.cache_specs(batch, POD_CAP, src)
    for rules, (got, specs), want in (
            (PREFILL_RULES, first, c["prefill_caches"]),
            (DECODE_RULES, last, c["decode_caches"])):
        for layer, g, s, w in zip(layers, got, specs, layers_of_segments(
                lm.program, want), strict=True):
            assert set(g) == set(layer)
            for k, x in g.items():
                assert s[k] == pspec_for(layer[k].logical_axes, mesh, rules,
                                         tuple(x.shape)), (k, s[k])
                np.testing.assert_allclose(x.numpy(), np.asarray(w[k]),
                                           **TOL, err_msg=f"{k} {rules}")


def train_states(arch, meshes, steps=1):
    """``steps`` fp32 train steps (batch 4 x 32 in 2 microbatches) on each
    mesh shape of ``meshes`` (None: no mesh) from the same drawn weights:
    (losses, the whole state) a mesh."""
    cfg = cfg_of(arch)
    lm = LM(cfg)
    opt = adamw.AdamWConfig(warmup_steps=1)
    data = SyntheticPacked(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0)
    batches = [torch_batch(next(data)) for _ in range(steps)]
    out = {}
    for shape in meshes:
        mesh = mesh_of(shape) if shape is not None else None
        state = steplib.init_train_state(
            lm, torch.Generator().manual_seed(0), opt, "cpu", mesh=mesh)
        fn = steplib.make_train_step(lm, opt, microbatches=TRAIN_MB,
                                     mesh=mesh)
        losses = []
        for b in batches:
            state, m = fn(state, b)
            losses.append(float(m["loss"]))
        out[shape] = (losses, spmd.gather_tree(state) if mesh else state)
    return out


def serve_runs(arch, meshes, batch=4):
    cfg = cfg_of(arch)
    lm = LM(cfg)
    params = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, SERVE_PROMPT + SERVE_STEPS))).long()
    return {shape: serve(lm, params, toks, None,
                         mesh_of(shape) if shape is not None else None)
            for shape in meshes}


def flat_serve(run):
    logits, (first, _), steps, (last, _) = run
    return [logits, *steps] + [t for cs in (first, last) for c in cs
                               for _, t in sorted(c.items())]


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-moe-30b-a3b"])
def test_one_pod_equals_the_two_axis_mesh(arch):
    """(1, 2, 2) runs the (2, 2) mesh's operations in the same order: its
    train step, prefill and decode equal (2, 2)'s bit for bit."""
    runs = train_states(arch, [(2, 2), (1, 2, 2)])
    assert runs[(2, 2)][0] == runs[(1, 2, 2)][0]
    for a, b in zip(tree_leaves(runs[(2, 2)][1]),
                    tree_leaves(runs[(1, 2, 2)][1]), strict=True):
        assert torch.equal(a, b)
    runs = serve_runs(arch, [(2, 2), (1, 2, 2)])
    for a, b in zip(flat_serve(runs[(2, 2)]), flat_serve(runs[(1, 2, 2)]),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-2.7b"])
def test_pods_alone_equal_no_mesh(arch):
    """(2, 1, 1): each pod trains on half of each microbatch and holds
    whole weights; the prefill splits the batch over the pods, the
    decode runs the whole batch on each. Within fp32 rounding of no
    mesh (the pods' gradients add in another order)."""
    runs = train_states(arch, [None, (2, 1, 1)], steps=2)
    np.testing.assert_allclose(runs[(2, 1, 1)][0], runs[None][0], rtol=1e-5)
    for a, b in zip(tree_leaves(runs[(2, 1, 1)][1]),
                    tree_leaves(runs[None][1]), strict=True):
        torch.testing.assert_close(a, b, **TOL)
    runs = serve_runs(arch, [None, (2, 1, 1)])
    for a, b in zip(flat_serve(runs[(2, 1, 1)]), flat_serve(runs[None]),
                    strict=True):
        torch.testing.assert_close(a, b, **TOL)


def test_pod_checkpoint_restores_onto_other_meshes(tmp_path):
    """A train state saved from (2, 2, 2) restores onto (2, 2) and onto
    no mesh, leaf for leaf equal to what was saved, each laid out as
    ``TRAIN_RULES`` say on its mesh."""
    cfg = cfg_of("qwen3-moe-30b-a3b")
    lm = LM(cfg)
    opt = adamw.AdamWConfig(moments_dtype="int8")
    mesh = mesh_of(POD_SHAPE)
    state = steplib.init_train_state(lm, torch.Generator().manual_seed(0),
                                     opt, "cpu", mesh=mesh)
    batch = torch_batch(next(SyntheticPacked(cfg.vocab_size, TRAIN_S,
                                             TRAIN_B)))
    state, _ = steplib.make_train_step(lm, opt, mesh=mesh)(state, batch)
    ck = CheckpointManager(tmp_path)
    ck.save(1, state)
    want = tree_leaves(spmd.gather_tree(state))
    axes = steplib.train_state_logical_axes(lm, opt)
    two = mesh_of((2, 2))
    onto = ck.restore(1, axes, mesh=two)
    for x, w in zip(tree_leaves(onto), want, strict=True):
        assert x.spec == pspec_for(x.axes or (), two, TRAIN_RULES, x.shape)
        assert torch.equal(spmd.gather(x), w)
    whole = ck.restore(1, state, device="cpu")
    for x, w in zip(tree_leaves(whole), want, strict=True):
        assert torch.equal(x, w)
    back = ck.restore(1, state, mesh=mesh)
    for x, y in zip(tree_leaves(back), tree_leaves(state), strict=True):
        assert x.spec == y.spec and all(
            torch.equal(a, b) for a, b in zip(x.pieces, y.pieces))


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-moe-30b-a3b",
                                  "seamless-m4t-medium"])
def test_pod_bytes_per_position_equal_dryrun(arch):
    """Every position of (2, 2, 2) holds exactly the bytes
    ``tree_bytes_per_device`` counts: a train state under
    ``TRAIN_RULES``; the weights and a prefill's caches under
    ``PREFILL_RULES``, and the caches moved under ``DECODE_RULES``."""
    cfg = cfg_of(arch)
    lm = LM(cfg)
    mesh = mesh_of(POD_SHAPE)
    opt = adamw.AdamWConfig(moments_dtype="int8")
    state = steplib.init_train_state(lm, torch.Generator().manual_seed(0),
                                     opt, "cpu", mesh=mesh)
    structs = steplib.train_state_structs(lm, opt)
    axes = steplib.train_state_logical_axes(lm, opt)
    assert spmd.bytes_per_position(state) == [dryrun.tree_bytes_per_device(
        structs, axes, mesh, TRAIN_RULES)] * mesh.size
    key = frontend_key(cfg)
    F = cfg.frontend.num_embeds if key else 0
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.long)}
    if key:
        batch[key] = torch.zeros((4, F, cfg.frontend.embed_dim))
    placed = spmd.relayout_tree(state.params, PREFILL_RULES)
    assert spmd.bytes_per_position(placed) == [dryrun.tree_bytes_per_device(
        lm.param_structs(), lm.param_axes(), mesh, PREFILL_RULES)] * mesh.size
    _, caches = lm.prefill(placed, batch, 32, mesh=mesh)
    specs = lm.cache_specs(4, 32, F if key == "src_embeds" else 0)
    for rules in (PREFILL_RULES, DECODE_RULES):
        if rules is DECODE_RULES:
            caches = lm.caches_for_decode(caches)
        want = dryrun.tree_bytes_per_device(
            specs_to_structs(specs), specs_logical_axes(specs), mesh, rules)
        assert spmd.bytes_per_position(caches) == [want] * mesh.size
