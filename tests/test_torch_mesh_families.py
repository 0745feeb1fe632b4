"""The SSM, hybrid, frontend and encoder-decoder families on a (data,
model) mesh: the port's mesh step (``make_train_step(..., mesh=)``) against
the reference's ``make_train_step`` under ``sharding_ctx(mesh,
TRAIN_RULES)`` on the CPU, and the bytes each position holds against the
dry-run.

The reference runs in a subprocess with four forced XLA host devices on a
mesh with Auto axes (``tests/torch_mesh_ref.py families``), started with
the module. One fp32 step (fp32 moments, batch 4 x 32 in two
microbatches, ``SyntheticPacked`` seed 0, ``embeds`` / ``src_embeds`` from
numpy seed 0) of the reduced mamba2-2.7b, jamba-1.5-large at 8 layers (one
whole period: SSM, attention, MoE), paligemma-3b and seamless-m4t-medium
on (2, 2), and of mamba2 with ``expand=3, head_dim=64`` on (1, 2), where
``d_in`` (192) splits over "model" and its 3 heads do not, from the
reference's ``PRNGKey(0)`` weights (bridged): loss and grad norm within
1e-5 relative, the fp32 moments of every leaf (every SSM, encoder and
frontend leaf included) within atol 1e-6, every new parameter within atol
1e-5 and rtol 1e-4. Except where Adam's first step is ill-conditioned: it
moves an element by ``lr * g / (|g| + eps)``, so where the clipped
gradient is within 100 eps of zero (a sum that cancels to its last fp32
bits) the step's size follows those bits, which the port sums in another
order with a mesh or without one. Those elements are held within 2 lr,
the most two first steps can differ, and counted (at most ``MAX_FLAT`` a
case moved apart). jamba's loss is the reference's mesh value: each data
shard's tokens fill their own expert capacity."""
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
from torch_mesh_ref import (FAMILY_CASES, TRAIN_B, TRAIN_MB,  # noqa: E402
                            TRAIN_S, family_case_name, family_cfg)

import repro_torch.configs as tc  # noqa: E402
from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.distributed.sharding import TRAIN_RULES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.models.params import (from_jax_lm_params,  # noqa: E402
                                       init_lm_params, param_axes)
from repro_torch.optimizer import adamw  # noqa: E402
from repro_torch.training import step as steplib  # noqa: E402
from repro_torch.tree import flatten, tree_map  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ("mamba2-2.7b", "jamba-1.5-large-398b", "paligemma-3b",
            "seamless-m4t-medium")
CASES = [family_case_name(a, s) for a, s, _ in FAMILY_CASES]
# Adam's eps (1e-8) times this: below it the first step's size reads the
# gradient's last bits, whose sums add in another order on a mesh
ADAM_FLAT = 100.0
# such elements moved apart in one step: 1, 0, 1, 1 and 1 measured on the
# CPU in the five cases; the bound is twice that
MAX_FLAT = 2


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_families") / "families.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT / "src"), str(ROOT / "tests"),
                               os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"),
         "families", str(path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield path, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _one_thread(ref_proc):
    # tiny CPU tensors: a thread pool costs far more than it saves (the
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


def torch_batch(np_batch):
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in np_batch.items()}
    for k in ("tokens", "labels"):
        b[k] = b[k].long()
    return b


@pytest.mark.parametrize("case", range(len(FAMILY_CASES)), ids=CASES)
def test_mesh_step_matches_reference_mesh_step(ref, case):
    arch, shape, over = FAMILY_CASES[case]
    r = ref[CASES[case]]
    cfg = family_cfg(tc, arch, over)
    lm = LM(cfg)
    mesh = cpu_mesh(shape)
    opt = adamw.AdamWConfig(warmup_steps=1)
    params = from_jax_lm_params(r["params0"], cfg, "cpu")
    state = steplib.place_state(lm, opt, steplib.TrainState(
        params, adamw.init_state(params, opt)), mesh)
    fn = steplib.make_train_step(lm, opt, microbatches=TRAIN_MB, mesh=mesh)
    new, m = fn(state, torch_batch(r["batch"]))
    np.testing.assert_allclose(float(m["loss"]), r["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), r["grad_norm"],
                               rtol=1e-5)
    ref_lm = RefLM(family_cfg(rc, arch, over))
    names = [k for k, _ in _named_leaves(new.params)]
    pairs = {}
    for part, got_tree in (("param", new.params), ("m", new.opt.m),
                           ("v", new.opt.v)):
        want_tree = (r["state"].params if part == "param"
                     else getattr(r["state"].opt, part))
        got = []
        tree_map(lambda w, g: got.append((np.asarray(w),
                                          spmd.gather(g).numpy())),
                 port_tree(ref_lm, want_tree), got_tree)
        assert len(got) == len(names)
        pairs[part] = got
    flat = 0
    for i, name in enumerate(names):
        for part in ("m", "v"):
            w, g = pairs[part][i]
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0,
                                       err_msg=f"{part} {name}")
        w, g = pairs["param"][i]
        # Adam's first step moves an element by lr * g / (|g| + eps): where
        # the (clipped) gradient is near eps, that reads its fp32 rounding
        g_ref = pairs["m"][i][0] / (1.0 - opt.b1)
        near_eps = np.abs(g_ref) < ADAM_FLAT * opt.eps
        off = np.abs(g - w) > 1e-5 + 1e-4 * np.abs(w)
        assert not (off & ~near_eps).any(), (name, np.argwhere(
            off & ~near_eps)[:4], g[off & ~near_eps][:4],
            w[off & ~near_eps][:4])
        assert (np.abs(g - w) <= 2 * opt.lr)[near_eps].all(), name
        flat += int((off & near_eps).sum())
    print(f"{CASES[case]}: loss {float(m['loss'])} (reference {r['loss']}); "
          f"elements whose gradient |g| < {ADAM_FLAT} x eps moved apart: "
          f"{flat}")
    assert flat <= MAX_FLAT
    # the leaves this slice brings to the mesh are among those held
    if cfg.ssm is not None:
        assert any(n.endswith("A_log") for n in names)
    if cfg.frontend.kind != "none":
        assert "head.frontend_proj" in names
    if cfg.num_encoder_layers:
        assert "head.enc_norm" in names
        assert sum(n.startswith("encoder.") for n in names) == (
            cfg.num_encoder_layers * len(flatten(new.params["encoder"][0])[0]))


def _named_leaves(tree, prefix=""):
    """(dotted name, leaf) in the trees' leaf order (sorted dict keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def test_ssm_channels_split_while_heads_stay_whole():
    """mamba2 with ``expand=3, head_dim=64`` on (1, 2): ``pspec_for``
    splits ``d_in`` = 192 over "model" but not its 3 heads, so a shard's
    channels would cut head 1. ``shard_weights`` then gathers the channel
    leaves over "model" and every position runs the whole mixer; the step
    equals the reference's in ``test_mesh_step_matches_reference_mesh_step``
    (its ``@1x2`` case)."""
    arch, shape, over = FAMILY_CASES[-1]
    cfg = family_cfg(tc, arch, over)
    assert (cfg.ssm.expand * cfg.d_model, cfg.ssm.expand * cfg.d_model
            // cfg.ssm.head_dim) == (192, 3)
    mesh = cpu_mesh(shape)
    state = steplib.init_train_state(
        LM(cfg), torch.Generator().manual_seed(0), adamw.AdamWConfig(), "cpu",
        mesh=mesh)
    layer = state.params["layers"][0]
    assert layer["w_x"].pieces[0].shape == (64, 96)
    assert layer["w_dt"].pieces[0].shape == (64, 3)
    assert blocks._ssm_cut_in_heads(layer)
    spmd.reset_collective_bytes()
    ws = blocks.shard_weights(cfg, layer, mesh)
    assert [tuple(w["w_x"].shape) for w in ws] == [(64, 192)] * 2
    assert [tuple(w["out_proj"].shape) for w in ws] == [(192, 64)] * 2
    assert spmd.collective_bytes(0)["all-gather"] > 0
    # on (2, 2) the reduced mamba2's 16 heads split with its channels
    wide = family_cfg(tc, arch, {})
    placed = steplib.init_train_state(
        LM(wide), torch.Generator().manual_seed(0), adamw.AdamWConfig(),
        "cpu", mesh=cpu_mesh((2, 2)))
    assert not blocks._ssm_cut_in_heads(placed.params["layers"][0])


def test_frontend_proj_gradient_is_the_sum_of_its_copies():
    """paligemma on (2, 2): each model position projects its data shard's
    embeddings again, so each copy of ``frontend_proj`` gets a partial
    gradient (its position's share through the vocabulary-split loss and
    the row-parallel partials), and the leaf's gradient is their sum: the
    unsharded gradient."""
    cfg = family_cfg(tc, "paligemma-3b", {})
    lm = LM(cfg)
    params = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S))),
        "embeds": torch.from_numpy(rng.standard_normal(
            (TRAIN_B, cfg.frontend.num_embeds, cfg.frontend.embed_dim)
        ).astype(np.float32)), "mask": torch.ones(TRAIN_B, TRAIN_S)}
    batch["labels"] = torch.roll(batch["tokens"], -1, 1)
    w = params["head"]["frontend_proj"].requires_grad_()
    want = torch.autograd.grad(lm.train_loss(params, batch), w)[0]
    mesh = cpu_mesh((2, 2))
    placed = spmd.place_tree(params, param_axes(cfg), mesh, TRAIN_RULES)
    fp = placed["head"]["frontend_proj"]
    fp = fp.like([p.detach().requires_grad_() for p in fp.pieces])
    placed["head"]["frontend_proj"] = fp
    parts = torch.autograd.grad(lm.train_loss(placed, batch, mesh=mesh),
                                fp.pieces)
    assert fp.holders() == [[0, 1], [2, 3]]
    for a, b in ((0, 1), (2, 3)):       # copies of one piece, unlike parts
        assert parts[a].abs().sum() > 0 and parts[b].abs().sum() > 0
        assert not torch.allclose(parts[a], parts[b])
    got = spmd.gather(spmd.sum_copies(fp.like(list(parts))))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("arch", FAMILIES)
def test_placed_bytes_per_device_equal_dryrun(arch, shape):
    """Every position holds exactly the bytes ``tree_bytes_per_device``
    counts for the train cell's state (bf16 weights, as the configs are,
    and int8 moments) on the mesh under ``TRAIN_RULES``."""
    cfg = tc.get_config(arch).reduced()
    if cfg.ssm is not None and cfg.attn.attn_period > 1:
        cfg = dataclasses.replace(cfg, num_layers=8)
    lm = LM(cfg)
    mesh = cpu_mesh(shape)
    opt = adamw.AdamWConfig(moments_dtype="int8")
    state = steplib.init_train_state(lm, torch.Generator().manual_seed(0),
                                     opt, "cpu", mesh=mesh)
    structs = steplib.train_state_structs(lm, opt)
    axes = steplib.train_state_logical_axes(lm, opt)
    for part in ("params", "opt"):
        want = dryrun.tree_bytes_per_device(getattr(structs, part),
                                            getattr(axes, part), mesh,
                                            TRAIN_RULES)
        got = spmd.bytes_per_position(getattr(state, part))
        assert got == [want] * mesh.size, (part, got, want)
