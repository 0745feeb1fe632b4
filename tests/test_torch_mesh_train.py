"""Training on a (data, model) mesh: the port's mesh step
(``make_train_step(..., mesh=)``, ``LM.train_loss(..., mesh=)``, AdamW over
``spmd.Placed`` leaves) against the reference's ``make_train_step`` under
``sharding_ctx((2, 2) mesh, TRAIN_RULES)`` on the CPU, and the rest of the
slice: per-device bytes against the dry-run, checkpoints across meshes,
the launcher's ``--mesh``, the inspector's ``--mesh`` and the reference
launcher's own fault.

The reference runs in two subprocesses with four forced XLA host devices
on a mesh with Auto axes (``tests/torch_mesh_ref.py``: fp32 moments, and
int8 moments), started with the module, beside a third that shows its
launcher failing on ``jax.make_mesh``'s Explicit axes. One step of the
reduced llama3-8b, gemma3-1b and qwen3-moe-30b-a3b in fp32, batch 4 x 32
in two microbatches, from the reference's ``PRNGKey(0)`` weights (bridged)
and ``SyntheticPacked`` batch: loss and grad norm within 1e-5 relative,
new parameters within atol 1e-5 and rtol 1e-4, fp32 moments within atol
1e-6; int8 moments by the rounding-boundary rule of
``test_torch_train_step.stored_equal``: each unit of whole last-dim rows
stores exactly the round-half-to-even codes and scales of the port's own
fp32 values, and a code apart from the reference's only at a rounding
tie (scales within 1e-4 relative, as the parameters). qwen3-moe's loss
is the reference's *mesh* value, not its unsharded one: each data
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
from test_torch_train_step import port_tree, stored_equal  # noqa: E402
from torch_mesh_ref import ARCHS, TRAIN_B, TRAIN_MB, TRAIN_S  # noqa: E402

import repro_torch.configs as tc  # noqa: E402
from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import SyntheticPacked  # noqa: E402
from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.distributed.sharding import TRAIN_RULES  # noqa: E402
from repro_torch.launch import dryrun, inspect_hlo  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models.lm import LM, check_mesh_support  # noqa: E402
from repro_torch.models.params import (from_jax_lm_params,  # noqa: E402
                                       init_lm_params)
from repro_torch.optimizer import adamw  # noqa: E402
from repro_torch.training import step as steplib  # noqa: E402
from repro_torch.tree import flatten, tree_leaves, tree_map  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MOMENTS = ("float32", "int8")
REF_LAUNCHER = ["-m", "repro.launch.train", "--reduced", "--mesh", "2,2",
                "--steps", "1", "--batch", "4", "--seq", "32"]
# bf16 configs on two meshes: the partials add in another order
BF16_RTOL = 2e-3
# int8 codes stored apart from the reference's, at ties, in one step:
# 6, 4 and 68 measured on the CPU; the bound is twice that
MAX_APART = {"llama3-8b": 12, "gemma3-1b": 8, "qwen3-moe-30b-a3b": 136}


def ref_env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4",
                PYTHONPATH=os.pathsep.join(
                    p for p in (str(ROOT / "src"), str(ROOT / "tests"),
                                os.environ.get("PYTHONPATH")) if p))


@pytest.fixture(scope="module")
def ref_procs(tmp_path_factory):
    """The reference's runs, started with the module: the fp32 and int8
    steps, and its launcher on ``--mesh 2,2``."""
    d = tmp_path_factory.mktemp("mesh_ref")
    procs = {}
    for md in MOMENTS:
        procs[md] = (d / f"{md}.pkl", subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"),
             "train", str(d / f"{md}.pkl"), md], cwd=ROOT, env=ref_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    procs["launcher"] = (None, subprocess.Popen(
        [sys.executable] + REF_LAUNCHER, cwd=ROOT, env=ref_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    yield procs
    for _, p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module", autouse=True)
def _one_thread(ref_procs):
    # tiny CPU tensors: a thread pool costs far more than it saves (the
    # reference's subprocesses start first and run beside this module)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(ref_procs):
    out = {}
    for md in MOMENTS:
        path, proc = ref_procs[md]
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-3000:]
        with open(path, "rb") as fh:
            res = pickle.load(fh)
        for arch, r in res.items():
            out.setdefault(arch, {}).update(r)
    return out


def cpu_mesh(shape):
    return make_mesh(shape, ("data", "model"), "cpu")


def cfg_of(arch, dtype="float32"):
    return dataclasses.replace(tc.get_config(arch).reduced(), dtype=dtype)


def ref_lm_of(arch):
    return RefLM(dataclasses.replace(rc.get_config(arch).reduced(),
                                     dtype="float32"))


def torch_batch(np_batch):
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in np_batch.items()}
    for k in ("tokens", "labels"):
        b[k] = b[k].long()
    return b


@pytest.fixture
def stores(monkeypatch):
    """Each int8 store of the port's optimizer in call order: (the stored
    codes, the fp32 value before it; for v, its square root)."""
    seen = []
    store = adamw._store

    def recording(x, mode, sqrt_map=False):
        out = store(x, mode, sqrt_map)
        if mode == "int8":
            pre = torch.sqrt(torch.clamp(x, min=0.0)) if sqrt_map else x
            seen.append((out.q, pre.numpy()))
        return out
    monkeypatch.setattr(adamw, "_store", recording)
    return seen


def unit_stores(params, seen):
    """The recorded stores by (leaf, unit, "m" or "v"): the optimizer
    updates each leaf's units (``adamw._rows``) in order, storing m then v
    once a unit."""
    out, i = {}, 0
    for j, p in enumerate(tree_leaves(params)):
        for u in range(len(adamw._rows(p))):
            out[j, u, "m"], out[j, u, "v"] = seen[i], seen[i + 1]
            i += 2
    assert i == len(seen)
    return out


def check_int8_units(ref_q, got, stored, what):
    """The rounding-boundary rule (``stored_equal``), unit by unit (the whole last-dim rows a piece lies
    in, ``adamw._rows``): the port stored exactly its own fp32 values'
    codes and scales (``stored_equal``), and the reference's codes of
    those rows differ only at ties. ``stored``: the unit's recorded
    stores in order. Returns the ties."""
    q, scale = got.q, got.scale
    nd = len(q.shape)
    rows_spec = q.spec[:nd - 1]
    ties = []
    for unit, (codes_seen, pre) in zip(adamw._rows(q), stored, strict=True):
        reps = [members[0] for members in unit]
        codes = torch.cat([q.pieces[r] for r in reps], -1)
        assert torch.equal(codes, codes_seen), what
        r = reps[0]
        want = adamw.Quantized(
            spmd._narrow(torch.from_numpy(np.asarray(ref_q.q)), rows_spec,
                         q.mesh, r).numpy(),
            spmd._narrow(torch.from_numpy(np.asarray(ref_q.scale)),
                         rows_spec, q.mesh, r).numpy())
        ties += stored_equal(want, adamw.Quantized(codes, scale.pieces[r]),
                             pre, f"{what}, unit at {r}")
        # a block's scale is its largest |value|, a gradient's image, held
        # as the parameters are (rtol 1e-4)
        np.testing.assert_allclose(scale.pieces[r].numpy(), want.scale,
                                   rtol=1e-4, atol=0, err_msg=what)
    return ties


@pytest.mark.parametrize("moments", MOMENTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_reference_mesh_step(ref, arch, moments, stores):
    r = ref[arch]
    cfg = cfg_of(arch)
    lm = LM(cfg)
    mesh = cpu_mesh((2, 2))
    opt = adamw.AdamWConfig(moments_dtype=moments, warmup_steps=1)
    params = from_jax_lm_params(r["params0"], cfg, "cpu")
    state = steplib.place_state(lm, opt, steplib.TrainState(
        params, adamw.init_state(params, opt)), mesh)
    fn = steplib.make_train_step(lm, opt, microbatches=TRAIN_MB, mesh=mesh)
    stores.clear()              # the zero moments' stores
    new, m = fn(state, torch_batch(r["batch"]))
    want = r[moments]
    np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), want["grad_norm"],
                               rtol=1e-5)
    if cfg.moe is not None:
        # each data shard's capacity: not the unsharded step's loss
        assert abs(want["loss"] - r["loss_no_mesh"]) > 1e-3 * want["loss"]
    ref_lm = ref_lm_of(arch)
    pairs = []
    tree_map(lambda w, g: pairs.append((w, g)),
             port_tree(ref_lm, want["state"].params), new.params)
    n_leaves = len(tree_leaves(new.params))
    assert len(pairs) == n_leaves
    for i, (w, g) in enumerate(pairs):
        np.testing.assert_allclose(spmd.gather(g).numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-4,
                                   err_msg=f"param {i}")
    assert int(new.opt.step.pieces[0]) == 1
    ties = []
    by_unit = unit_stores(new.params, stores) if moments == "int8" else {}
    for name in ("m", "v"):
        ref_m = port_tree(ref_lm, getattr(want["state"].opt, name))
        got_m = getattr(new.opt, name)
        mp = []
        tree_map(lambda w, g: mp.append((w, g)), ref_m, got_m,
                 is_leaf=lambda x: isinstance(x, adamw.Quantized))
        assert len(mp) == n_leaves
        for i, (w, g) in enumerate(mp):
            what = f"{name} leaf {i}"
            if moments == "int8":
                n_units = len(adamw._rows(g.q))
                ties += check_int8_units(
                    w, g, [by_unit[i, u, name] for u in range(n_units)],
                    what)
            else:
                np.testing.assert_allclose(spmd.gather(g).numpy(),
                                           np.asarray(w), atol=1e-6, rtol=0,
                                           err_msg=what)
    print(f"{arch} {moments}: loss {float(m['loss'])} (reference "
          f"{want['loss']}), codes apart at ties: {len(ties)}")
    assert len(ties) <= MAX_APART[arch]


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_bytes_per_device_equal_dryrun(arch, shape):
    """Every position holds exactly the bytes ``tree_bytes_per_device``
    counts for the config, mesh and ``TRAIN_RULES``: params and int8
    moments (bf16 weights, as the configs are)."""
    cfg = tc.get_config(arch).reduced()
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


@pytest.mark.parametrize("moments", MOMENTS)
def test_mesh_init_places_each_leaf_as_it_is_drawn(moments):
    """``init_train_state(mesh=)`` places each weight and its moments as
    soon as the weight is drawn, and gives exactly ``place_state`` of the
    state drawn with no mesh: the same pieces, specs and logical axes."""
    cfg = cfg_of("gemma3-1b")
    lm = LM(cfg)
    mesh = cpu_mesh((2, 2))
    opt = adamw.AdamWConfig(moments_dtype=moments)
    got = steplib.init_train_state(lm, torch.Generator().manual_seed(0),
                                   opt, "cpu", mesh=mesh)
    want = steplib.place_state(lm, opt, steplib.init_train_state(
        lm, torch.Generator().manual_seed(0), opt, "cpu"), mesh)
    gl, wl = flatten(got)[0], flatten(want)[0]
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert (g.spec, g.shape, g.axes) == (w.spec, w.shape, w.axes), i
        for r in range(mesh.size):
            assert g.pieces[r].dtype == w.pieces[r].dtype, i
            assert torch.equal(g.pieces[r], w.pieces[r]), (i, r)
    drawn = []      # the hook sees every weight whole, once, in order
    init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu",
                   place=lambda x, axes: drawn.append(tuple(x.shape)) or x)
    assert drawn == [tuple(p.shape) for p in _in_draw_order(got.params)]


def _in_draw_order(params):
    """The weights of a tree in ``init_params``' order: layers, then the
    head, each dict in insertion order."""
    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from walk(v)
        elif isinstance(t, list):
            for v in t:
                yield from walk(v)
        else:
            yield t
    yield from walk(params["layers"])
    yield from walk(params["head"])


def test_restore_lays_a_checkpoint_out_under_other_rules(tmp_path):
    """``restore(..., mesh=, rules=)`` lays a train checkpoint out under
    the rules it is given (here without FSDP, every weight's d_model dim
    whole on each data row): each leaf cut by ``pspec_for`` of those
    rules, and whole again equal to the saved leaf."""
    from repro_torch.distributed.sharding import is_axes_leaf, pspec_for
    no_fsdp = dataclasses.replace(TRAIN_RULES, fsdp=None)
    cfg = cfg_of("llama3-8b")
    lm = LM(cfg)
    opt = adamw.AdamWConfig()
    state = steplib.init_train_state(lm, torch.Generator().manual_seed(0),
                                     opt, "cpu")
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, state)
    mesh = cpu_mesh((2, 2))
    axes = steplib.train_state_logical_axes(lm, opt)
    out = mgr.restore(1, axes, mesh=mesh, rules=no_fsdp)
    moved = 0
    for (ax, shape), x, w in zip(tree_leaves(axes, is_leaf=is_axes_leaf),
                                 flatten(out)[0], flatten(state)[0],
                                 strict=True):
        assert x.spec == pspec_for(ax, mesh, no_fsdp, tuple(shape))
        moved += x.spec != pspec_for(ax, mesh, TRAIN_RULES, tuple(shape))
        assert torch.equal(spmd.gather(x), w)
    assert moved       # the layout differs from the train one


def test_checkpoint_saved_on_one_mesh_restores_on_another(tmp_path):
    """A state after a step on (2, 2) saves the files of an unsharded run
    (the same manifest and arrays) and restores onto (1, 2) and onto no
    mesh to equal leaves."""
    cfg = cfg_of("qwen3-moe-30b-a3b")
    lm = LM(cfg)
    opt = adamw.AdamWConfig(moments_dtype="int8")
    mesh = cpu_mesh((2, 2))
    state = steplib.init_train_state(lm, torch.Generator().manual_seed(0),
                                     opt, "cpu", mesh=mesh)
    batch = torch_batch(next(SyntheticPacked(cfg.vocab_size, TRAIN_S,
                                             TRAIN_B)))
    state, _ = steplib.make_train_step(lm, opt, microbatches=2,
                                       mesh=mesh)(state, batch)
    whole = spmd.gather_tree(state)
    a, b = CheckpointManager(tmp_path / "mesh"), CheckpointManager(
        tmp_path / "whole")
    a.save(1, state)
    b.save(1, whole)
    ma = (tmp_path / "mesh" / "step_00000001" / "manifest.json").read_text()
    mb = (tmp_path / "whole" / "step_00000001" / "manifest.json").read_text()
    strip = lambda s: s.split('"leaves"')[1]  # noqa: E731
    assert strip(ma) == strip(mb)
    for i in range(len(tree_leaves(whole))):
        f = f"step_00000001/leaf_{i}.npy"
        np.testing.assert_array_equal(np.load(tmp_path / "mesh" / f),
                                      np.load(tmp_path / "whole" / f))
    want = [x for x in flatten(whole)[0]]
    other = cpu_mesh((1, 2))
    template = steplib.init_train_state(
        lm, torch.Generator().manual_seed(1), opt, "cpu", mesh=other)
    on_other = a.restore(1, template, mesh=other)
    leaves = flatten(on_other)[0]
    assert all(x.mesh is other for x in leaves)
    for w, g in zip(want, leaves, strict=True):
        assert torch.equal(spmd.gather(g), w)
    # the logical-axes tree is a template too
    by_axes = a.restore(1, steplib.train_state_logical_axes(lm, opt),
                        mesh=other)
    for w, g in zip(want, flatten(by_axes)[0], strict=True):
        assert torch.equal(spmd.gather(g), w)
    plain = a.restore(1, whole, device="cpu")
    for w, g in zip(want, flatten(plain)[0], strict=True):
        assert torch.equal(g, w)


LAUNCH = ["--reduced", "--batch", "4", "--seq", "32", "--log-every", "100",
          "--device", "cpu", "--microbatches", "2"]


def test_launcher_mesh_against_unsharded_run():
    """``--mesh 2,2 --device cpu`` trains the unsharded run's weights on
    the unsharded run's data: llama3-8b's bf16 losses within BF16_RTOL
    (the partials add in another order), with int8 moments too."""
    for extra in ([], ["--moments-dtype", "int8"]):
        args = ["--arch", "llama3-8b", "--steps", "3"] + LAUNCH + extra
        whole = train_main(args)
        mesh = train_main(args + ["--mesh", "2,2"])
        np.testing.assert_allclose(mesh, whole, rtol=BF16_RTOL)


def test_launcher_resume_onto_another_mesh(tmp_path, capsys):
    """A run on (2, 2) checkpoints at step 2; resumed on the same mesh it
    continues with the uninterrupted run's losses exactly (the CPU is
    deterministic), and on (1, 2) within BF16_RTOL."""
    args = ["--arch", "gemma3-1b", "--steps", "4", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"] + LAUNCH
    losses = train_main(args + ["--mesh", "2,2"])
    out = capsys.readouterr().out
    assert "devices=4" in out and "mesh {'data': 2, 'model': 2}" in out
    import shutil
    shutil.rmtree(tmp_path / "step_00000004")
    same = train_main(args + ["--mesh", "2,2", "--resume"])
    assert same == losses[2:]
    shutil.rmtree(tmp_path / "step_00000004")
    other = train_main(args + ["--mesh", "1,2", "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    np.testing.assert_allclose(other, losses[2:], rtol=BF16_RTOL)


def test_other_families_on_a_mesh_name_item_3(monkeypatch, capsys):
    """Every family trains on a (data, model) mesh
    (``tests/test_torch_mesh_families.py``), and prefills and decodes on
    one (``tests/test_torch_mesh_serve.py``,
    ``tests/test_torch_mesh_serve_families.py``,
    ``tests/test_torch_mesh_serve_encdec.py``), and does all three on a
    multi-pod mesh (``tests/test_torch_mesh_pod.py``): a "pod" axis is
    taken for each of the other families, to train, prefill or decode,
    and a mesh axis that no sharding rule names raises; the inspector's
    ``--mesh`` runs the reduced paligemma's prefill cell on (2, 2) and on
    (1, 2, 2), one collective line a position."""
    pod = make_mesh((1, 1, 2), ("pod", "data", "model"), "cpu")
    other = make_mesh((1, 1, 2), ("stage", "data", "model"), "cpu")
    for arch in ("mamba2-2.7b", "jamba-1.5-large-398b",
                 "seamless-m4t-medium", "paligemma-3b"):
        steplib.make_train_step(LM(cfg_of(arch)), adamw.AdamWConfig(),
                                mesh=pod)
        with pytest.raises(NotImplementedError, match="sharding rules"):
            steplib.make_train_step(LM(cfg_of(arch)), adamw.AdamWConfig(),
                                    mesh=other)
        for kind in ("prefill", "decode"):
            check_mesh_support(pod, kind)
            with pytest.raises(NotImplementedError, match="sharding rules"):
                check_mesh_support(other, kind)
    orig = tc.get_config
    monkeypatch.setattr(tc, "get_config", lambda a: orig(a).reduced())
    monkeypatch.setattr(tc, "SHAPES",
                        {"p": tc.ShapeConfig("p", 32, 4, "prefill")})
    for mesh, n in (("2,2", 4), ("1,2,2", 4)):
        assert inspect_hlo.main(["--arch", "paligemma-3b", "--shape", "p",
                                 "--mesh", mesh, "--device", "cpu", "--top",
                                 "5"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith("# paligemma-3b p periods=1")
        coll = [ln for ln in out if ln.startswith("# position")]
        assert len(coll) == n
        assert all("'all-gather': 0," not in ln for ln in coll)


def test_mesh_on_cuda_without_the_cards_gives_the_recipe():
    if torch.cuda.device_count() >= 4:
        pytest.skip("four cards present")
    with pytest.raises(RuntimeError, match="explicit list of 4"):
        make_mesh((2, 2), ("data", "model"))
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert [mesh.coords(r) for r in range(4)] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]


def test_inspector_traces_a_mesh_step(monkeypatch, capsys):
    orig = tc.get_config
    monkeypatch.setattr(tc, "get_config", lambda a: orig(a).reduced())
    monkeypatch.setattr(tc, "SHAPES", {
        "t": tc.ShapeConfig("t", 32, 4, "train"),
        "d": tc.ShapeConfig("d", 32, 2, "decode")})
    assert inspect_hlo.main(["--arch", "qwen3-moe-30b-a3b", "--shape", "t",
                             "--mesh", "2,2", "--device", "cpu", "--top",
                             "5", "--microbatches", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# qwen3-moe-30b-a3b t periods=1")
    assert "mesh={'data': 2, 'model': 2}, 4 shards here" in out[0]
    coll = [ln for ln in out if ln.startswith("# position")]
    assert len(coll) == 4
    assert all("'all-gather'" in ln and "collective term" in ln
               for ln in coll)
    # a dense decoder's decode cell runs on the mesh under DECODE_RULES
    assert inspect_hlo.main(["--arch", "llama3-8b", "--shape", "d",
                             "--mesh", "2,2", "--device", "cpu", "--top",
                             "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# llama3-8b d periods=1")
    coll = [ln for ln in out if ln.startswith("# position")]
    assert len(coll) == 4
    assert all("'all-reduce'" in ln and "'all-reduce': 0," not in ln
               for ln in coll)
    # so do an SSM's and a frontend config's, and on a multi-pod mesh
    for arch in ("mamba2-2.7b", "paligemma-3b"):
        assert inspect_hlo.main(["--arch", arch, "--shape", "d", "--mesh",
                                 "2,2", "--device", "cpu", "--top",
                                 "5"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith(f"# {arch} d periods=1")
        coll = [ln for ln in out if ln.startswith("# position")]
        assert len(coll) == 4
        assert all("'all-reduce': 0," not in ln for ln in coll)
    assert inspect_hlo.main(["--arch", "paligemma-3b", "--shape", "d",
                             "--mesh", "2,1,2", "--device", "cpu", "--top",
                             "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "mesh={'pod': 2, 'data': 1, 'model': 2}, 4 shards here" in out[0]
    coll = [ln for ln in out if ln.startswith("# position")]
    assert len(coll) == 4
    assert all("'all-reduce': 0," not in ln for ln in coll)


def test_inspector_traces_a_mamba2_mesh_step(monkeypatch, capsys):
    """``inspect_hlo --mesh`` on an SSM train cell: the reduced mamba2 on
    (2, 2), whose channels and heads split over "model" (the out
    projection's and the output norm's all-reduces) and whose weights
    gather over "data"."""
    orig = tc.get_config
    monkeypatch.setattr(tc, "get_config", lambda a: orig(a).reduced())
    monkeypatch.setattr(tc, "SHAPES",
                        {"t": tc.ShapeConfig("t", 32, 4, "train")})
    assert inspect_hlo.main(["--arch", "mamba2-2.7b", "--shape", "t",
                             "--mesh", "2,2", "--device", "cpu", "--top",
                             "5", "--microbatches", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# mamba2-2.7b t periods=1")
    assert "mesh={'data': 2, 'model': 2}, 4 shards here" in out[0]
    coll = [ln for ln in out if ln.startswith("# position")]
    assert len(coll) == 4
    assert all("'all-gather'" in ln and "'all-reduce': 0," not in ln
               for ln in coll)


def test_collectives_count_bytes_and_match_autograd():
    """all_reduce and all_gather over one axis: values, gradients (the
    backward of an all-gather is a reduce-scatter), and the bytes each
    position counts, forward and backward."""
    mesh = cpu_mesh((2, 2))
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(3, 4, generator=g, requires_grad=True)
          for _ in range(4)]
    spmd.reset_collective_bytes()
    ys = spmd.all_reduce(xs, mesh, "model")
    for r in range(4):
        partner = r ^ 1
        lo, hi = min(r, partner), max(r, partner)
        torch.testing.assert_close(ys[r], xs[lo] + xs[hi], rtol=0, atol=0)
    w = [float(r + 1) for r in range(4)]
    sum(y.sum() * c for y, c in zip(ys, w)).backward()
    for r in range(4):
        lo = r & ~1
        torch.testing.assert_close(xs[r].grad,
                                   torch.full((3, 4), w[lo] + w[lo + 1]))
    assert spmd.collective_bytes()["all-reduce"] == 2 * 3 * 4 * 4
    xs = [torch.randn(2, 5, generator=g, requires_grad=True)
          for _ in range(4)]
    spmd.reset_collective_bytes()
    gs = spmd.all_gather(xs, mesh, "data", dim=0)
    torch.testing.assert_close(gs[1], torch.cat([xs[1], xs[3]]))
    sum(y.sum() * c for y, c in zip(gs, w)).backward()
    torch.testing.assert_close(xs[1].grad, torch.full((2, 5), w[1] + w[3]))
    assert spmd.collective_bytes(0) == {"all-reduce": 0,
                                        "all-gather": 4 * 5 * 4,
                                        "reduce-scatter": 2 * 5 * 4}


def test_place_and_gather_round_trip():
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    p = spmd.place(x, ("fsdp", "heads", None), mesh, TRAIN_RULES)
    assert p.spec == ("data", "model")
    assert [tuple(t.shape) for t in p.pieces] == [(4, 3, 4)] * 4
    torch.testing.assert_close(p.pieces[1], x[:4, 3:])
    assert torch.equal(spmd.gather(p), x)
    # heads 3 do not split over 2: replicated, a copy each
    y = torch.ones(8, 3)
    q = spmd.place(y, ("fsdp", "heads"), mesh, TRAIN_RULES)
    assert q.spec == ("data",) and [m for m in q.holders()] == [[0, 1],
                                                                [2, 3]]
    assert q.pieces[0].data_ptr() != q.pieces[1].data_ptr()


def test_reference_launcher_fails_on_explicit_mesh_axes(ref_procs, ref):
    """The reference's ``--mesh 2,2`` builds its mesh with
    ``jax.make_mesh``, whose axes are Explicit in this jax: its sharding
    constraints refuse them (ROADMAP.md §3). Its train step runs under a
    mesh built with Auto axes (``torch_mesh_ref.auto_mesh``), which is
    what the parity tests use."""
    _, proc = ref_procs["launcher"]
    _, err = proc.communicate(timeout=900)
    assert proc.returncode != 0
    assert "can only refer to Auto axes" in err, err[-2000:]
    assert all(np.isfinite(ref[a][md]["loss"]) for a in ARCHS
               for md in MOMENTS)
