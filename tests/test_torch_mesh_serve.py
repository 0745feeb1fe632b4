"""Prefill and decode of the dense decoder families on a (data, model)
mesh: the port's ``LM.prefill(..., mesh=)`` under ``PREFILL_RULES`` and
``LM.decode_step(..., mesh=)`` under ``DECODE_RULES`` against the
reference's jitted ``lm.prefill`` / ``lm.decode_step`` under
``sharding_ctx`` of an Auto mesh on four XLA host devices, and against the
port's own ``LM`` with no mesh; the caches' layout and the bytes each
position holds against the dry-run; one decode step's collective bytes;
the collectives over several mesh axes; the partial decode attention; and
what still refuses the mesh (a "pod" axis).

The reference runs in a subprocess started with the module
(``tests/torch_mesh_ref.py serve``): the reduced llama3-8b (4 heads, 2 kv
heads, head_dim 16, d 64) and gemma3-1b at six layers (five local layers
with 32-token rings, one global), fp32, ``PRNGKey(0)`` weights (bridged
by ``from_jax_lm_params``), batch 4, a 28-token prompt and 6 decode steps
(numpy seed 0), capacity 64 on (2, 2), (1, 4) and (4, 1), and 62 on
(2, 2). The decode steps write slots 28-33: across the boundary at slot
32 between two positions' pieces of a full cache (four of 16), and
round gemma3's 32-slot rings (four pieces of 8). The prefill's logits,
its caches (gathered), every decode step's logits and the last caches
agree within atol 1e-5 + rtol 1e-5: fp32, the distributed softmax and
the partial sums add in another order."""
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_mesh_ref import (SERVE_ARCHS, SERVE_B, SERVE_CASES,  # noqa: E402
                            SERVE_PROMPT, SERVE_STEPS, frontend_key,
                            serve_case_name, serve_cfg, serve_prompt)

import repro_torch.configs as tc  # noqa: E402
from repro_torch.distributed import spmd  # noqa: E402
from repro_torch.distributed.sharding import (DECODE_RULES,  # noqa: E402
                                              PREFILL_RULES, TRAIN_RULES,
                                              pspec_for)
from repro_torch.launch import dryrun, inspect_hlo  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.common import (specs_logical_axes,  # noqa: E402
                                       specs_to_structs)
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.models.params import (from_jax_lm_params,  # noqa: E402
                                       init_lm_params, layers_of_segments)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
CASES = [(arch, shape, cap) for arch, _ in SERVE_ARCHS
         for shape, cap in SERVE_CASES]
OVER = dict(SERVE_ARCHS)


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_serve") / "serve.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT / "src"), str(ROOT / "tests"),
                               os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"),
         "serve", str(path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
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


def cpu_mesh(shape):
    return make_mesh(shape, ("data", "model"), "cpu")


def cfg_of(arch):
    return serve_cfg(tc, arch, OVER.get(arch, {}))


def serve(lm, params, toks, cap, mesh=None):
    """Prefill then ``SERVE_STEPS`` decode steps on the tokens' columns:
    (prefill logits, prefill caches, [step logits], last caches); on a
    mesh, the logits of position 0 (each position's are checked equal),
    the caches moved to the decode layout between the two, gathered
    where asked."""
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
    return logits, first, steps, caches


def one_of(per_position):
    """The logits every position holds: equal, so position 0's."""
    for t in per_position[1:]:
        assert torch.equal(t, per_position[0])
    return per_position[0]


@pytest.mark.parametrize("arch,shape,cap", CASES)
def test_mesh_prefill_and_decode_match_reference(ref, arch, shape, cap):
    """The port on the mesh against the reference under ``sharding_ctx``
    on the same mesh, and the caches split as the rules say: ``kv_seq``
    over "model" in the prefill and over ("data", "model") in the decode
    (at capacity 62 the decode's full caches keep their slots whole and
    split their kv heads over "model", as ``pspec_for`` lays them)."""
    r = ref[arch]
    c = r[serve_case_name(shape, cap)]
    cfg = cfg_of(arch)
    lm = LM(cfg)
    mesh = cpu_mesh(shape)
    params = from_jax_lm_params(r["params"], cfg, "cpu")
    toks = torch.from_numpy(r["tokens"]).long()
    placed = spmd.place_tree(params, lm.param_axes(), mesh, PREFILL_RULES)
    logits, caches = lm.prefill(placed, {"tokens": toks[:, :SERVE_PROMPT]},
                                cap, mesh=mesh)
    np.testing.assert_allclose(one_of(logits).numpy(), c["prefill"], **TOL)
    for c_got, c_want in zip(caches, layers_of_segments(
            lm.program, c["prefill_caches"]), strict=True):
        for k in ("k", "v"):
            x = c_got[k]
            assert x.spec[:2] == ("data", "model"), x.spec
            np.testing.assert_allclose(spmd.gather(x).numpy(),
                                       np.asarray(c_want[k]), **TOL)
    caches = lm.caches_for_decode(caches)
    for i in range(SERVE_STEPS):
        out, caches = lm.decode_step(placed, caches, {
            "token": toks[:, SERVE_PROMPT + i],
            "cache_len": SERVE_PROMPT + i}, mesh=mesh)
        np.testing.assert_allclose(one_of(out).numpy(), c["decode"][i],
                                   **TOL, err_msg=f"decode step {i}")
    for c_got, c_want in zip(caches, layers_of_segments(
            lm.program, c["decode_caches"]), strict=True):
        for k in ("k", "v"):
            x = c_got[k]
            want_spec = ((None, ("data", "model")) if x.shape[1] % 4 == 0
                         else (None, None, "model")
                         if cfg.num_kv_heads % shape[1] == 0 else ())
            assert x.spec == want_spec, (x.spec, x.shape)
            np.testing.assert_allclose(spmd.gather(x).numpy(),
                                       np.asarray(c_want[k]), **TOL)


@pytest.mark.parametrize("arch,shape,cap", CASES)
def test_mesh_prefill_and_decode_match_no_mesh(arch, shape, cap):
    """The same run against the port's ``LM`` with no mesh on the same
    seeded weights and tokens (no jax in this check)."""
    cfg = cfg_of(arch)
    lm = LM(cfg)
    params = init_lm_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT + SERVE_STEPS))).long()
    want = serve(lm, params, toks, cap)
    got = serve(lm, params, toks, cap, cpu_mesh(shape))
    torch.testing.assert_close(got[0], want[0], **TOL)
    for g, w in zip(got[1], want[1], strict=True):
        for k in ("k", "v"):
            torch.testing.assert_close(g[k], w[k], **TOL)
    for i, (g, w) in enumerate(zip(got[2], want[2], strict=True)):
        torch.testing.assert_close(g, w, **TOL, msg=f"decode step {i}")
    for g, w in zip(got[3], want[3], strict=True):
        for k in ("k", "v"):
            torch.testing.assert_close(spmd.gather(g[k]), w[k], **TOL)


def batch_of(cfg, src_len=None):
    """A prefill's zero batch: ``serve_prompt`` tokens and a frontend's
    embeddings (``src_len`` frames of an encoder's), and the frames the
    cross caches hold."""
    key = frontend_key(cfg)
    batch = {"tokens": torch.zeros((SERVE_B, serve_prompt(cfg)),
                                   dtype=torch.long)}
    if key is None:
        return batch, 0
    F = src_len or cfg.frontend.num_embeds
    batch[key] = torch.zeros((SERVE_B, F, cfg.frontend.embed_dim))
    return batch, (F if key == "src_embeds" else 0)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("arch", [a for a, _ in SERVE_ARCHS]
                         + ["qwen3-moe-30b-a3b", "mamba2-2.7b",
                            "paligemma-3b", "seamless-m4t-medium"])
def test_placed_bytes_per_position_equal_dryrun(arch, shape):
    """The weights placed under either rule set, the prefill's caches and
    the decode's (after ``caches_for_decode``) hold at each position
    exactly the bytes ``dryrun.tree_bytes_per_device`` counts for the
    config, the mesh and the rules, for the dense configs, an MoE
    (qwen3-moe), an SSM (mamba2, whose caches are the conv inputs and
    the state), a frontend (paligemma: one kv head) and an
    encoder-decoder (seamless, whose cross caches hold its 8 source
    frames); the relayout copies what each position lacks, and no more
    than its decode pieces."""
    cfg = cfg_of(arch)
    lm = LM(cfg)
    mesh = cpu_mesh(shape)
    params = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch, src_len = batch_of(cfg)
    cache_specs = lm.cache_specs(SERVE_B, 64, src_len)
    for rules in (PREFILL_RULES, DECODE_RULES):
        placed = spmd.place_tree(params, lm.param_axes(), mesh, rules)
        want = dryrun.tree_bytes_per_device(lm.param_structs(),
                                            lm.param_axes(), mesh, rules)
        assert spmd.bytes_per_position(placed) == [want] * mesh.size
        # the train layout is the same: one placement serves every cell
        assert spmd.bytes_per_position(spmd.place_tree(
            params, lm.param_axes(), mesh, TRAIN_RULES)) == [want] * mesh.size
    _, caches = lm.prefill(placed, batch, 64, mesh=mesh)
    structs = specs_to_structs(cache_specs)
    axes = specs_logical_axes(cache_specs)
    want = {rules: dryrun.tree_bytes_per_device(structs, axes, mesh, rules)
            for rules in (PREFILL_RULES, DECODE_RULES)}
    for rules in (PREFILL_RULES, DECODE_RULES):
        assert spmd.bytes_per_position(caches) == [want[rules]] * \
            mesh.size, rules
        if rules is PREFILL_RULES:
            spmd.reset_collective_bytes()
            caches = lm.caches_for_decode(caches)
            moved = [spmd.moved_bytes(r) for r in range(mesh.size)]
            # on (1, 4) both layouts cut the slots alike: nothing moves
            assert (max(moved) > 0) == (shape != (1, 4)), moved
            assert max(moved) <= want[DECODE_RULES], moved


def test_decode_step_collective_bytes():
    """One decode step on (2, 2) with batch 4 counts at every position the
    bytes that ``chip_smoke.serve_mesh_decode_bytes`` derives from the
    shapes, for three reduced configs in fp32 (4 layers each; the head
    all-reduces 512 + 16 + 2,048 and all-gathers the logits' 4,096):

    - llama3-8b: 23,696 all-reduced (5,280 a layer: 16 + 512 + 256 + 256
      for the norm and q/k/v, 64 + 64 + 1,024 for the softmax's merge,
      512 + 16 + 1,024 + 1,024 + 512 for ``wo`` and the FFN) and 12,288
      all-gathered (2,048 a layer);
    - qwen3-moe (4 experts, top-2, capacity 3 for the whole batch of 4):
      40,336 all-reduced (9,440 a layer: the attention's 2,704 as
      llama3's, then 16 for the norm, 64 for the fp32 router logits,
      3,072 + 3,072 for the two experts' w_gate and w_up products (2, 3,
      128), 512 for the fp32 combine) and 12,288 all-gathered;
    - mamba2 (d_in 128, 16 heads, state 16; tied embeddings): 15,504
      all-reduced (3,232 a layer: 16 for the norm, 1,024 + 1,024 for z
      and x, 256 + 256 for B and C, 128 for dt; 16 for the gated norm's
      sum of squares and 512 for ``out_proj``) and 4,096 all-gathered;
    - paligemma (one kv head of 16, whole on every position; tied
      embeddings): 23,696 all-reduced (5,280 a layer, llama3's: its k and
      v partials 256 + 256 and its softmax's 64 + 64 + 1,024 over one kv
      head of 4 q heads) and 8,192 all-gathered (1,024 a layer: q alone,
      the new k and v whole already);
    - seamless (cross-attention over 8 source frames): 32,464
      all-reduced (7,472 a layer: llama3's 5,280, then 16 for
      ``ln_cross``, 512 for ``cwq``, 64 + 64 + 1,024 for the cross
      softmax's merge, 512 for ``cwo``) and 16,384 all-gathered (3,072 a
      layer: llama3's 2,048 and the cross q's 1,024); the cross caches
      move nothing."""
    mesh = cpu_mesh((2, 2))
    for arch, want in (
            ("llama3-8b", {"all-reduce": 23696, "all-gather": 12288,
                           "reduce-scatter": 0}),
            ("qwen3-moe-30b-a3b", {"all-reduce": 40336, "all-gather": 12288,
                                   "reduce-scatter": 0}),
            ("mamba2-2.7b", {"all-reduce": 15504, "all-gather": 4096,
                             "reduce-scatter": 0}),
            ("paligemma-3b", {"all-reduce": 23696, "all-gather": 8192,
                              "reduce-scatter": 0}),
            ("seamless-m4t-medium", {"all-reduce": 32464,
                                     "all-gather": 16384,
                                     "reduce-scatter": 0})):
        cfg = cfg_of(arch)
        lm = LM(cfg)
        params = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
        placed = spmd.place_tree(params, lm.param_axes(), mesh, DECODE_RULES)
        caches = [{k: spmd.zeros(s.shape, torch.float32, s.logical_axes,
                                 mesh, DECODE_RULES)
                   for k, s in layer.items()}
                  for layer in lm.cache_specs(SERVE_B, 64, batch_of(cfg)[1])]
        spmd.reset_collective_bytes()
        lm.decode_step(placed, caches, {"token": torch.arange(SERVE_B),
                                        "cache_len": 31}, mesh=mesh)
        assert chip_smoke.serve_mesh_decode_bytes(cfg, 2, 2, SERVE_B) == \
            want, arch
        for r in range(mesh.size):
            assert spmd.collective_bytes(r) == want, (arch, r)


def test_collectives_over_the_whole_grid():
    """``groups``, ``all_reduce``, ``all_gather`` and ``gathered_over``
    over ("data", "model") together: values against a plain sum or
    concatenation in ``piece_index``'s order, gradients through autograd,
    and the bytes each position counts."""
    mesh = cpu_mesh((2, 2))
    assert spmd.groups(mesh, "data", "model") == [[0, 1, 2, 3]]
    assert spmd.groups(mesh, "model", "data") == [[0, 2, 1, 3]]
    assert spmd.groups(mesh, "model") == [[0, 1], [2, 3]]
    g = torch.Generator().manual_seed(0)
    w = [float(r + 1) for r in range(4)]
    xs = [torch.randn(3, 5, generator=g, requires_grad=True)
          for _ in range(4)]
    spmd.reset_collective_bytes()
    ys = spmd.all_reduce(xs, mesh, ("data", "model"))
    for y in ys:
        torch.testing.assert_close(y, xs[0] + xs[1] + xs[2] + xs[3],
                                   rtol=0, atol=0)
    sum(y.sum() * c for y, c in zip(ys, w)).backward()
    for x in xs:
        torch.testing.assert_close(x.grad, torch.full((3, 5), sum(w)))
    # forward and backward, each the whole tensor
    assert spmd.collective_bytes(3)["all-reduce"] == 2 * 3 * 5 * 4
    m = spmd.all_reduce_max([x.detach() for x in xs], mesh,
                            ("data", "model"))
    torch.testing.assert_close(m[2], torch.stack(xs).amax(0), rtol=0,
                               atol=0)
    xs = [torch.randn(2, 3, generator=g, requires_grad=True)
          for _ in range(4)]
    spmd.reset_collective_bytes()
    gs = spmd.all_gather(xs, mesh, ("model", "data"), dim=0)
    torch.testing.assert_close(gs[1], torch.cat([xs[0], xs[2], xs[1],
                                                 xs[3]]))
    sum(y.sum() * c for y, c in zip(gs, w)).backward()
    torch.testing.assert_close(xs[2].grad, torch.full((2, 3), sum(w)))
    assert spmd.collective_bytes(0) == {"all-reduce": 0,
                                        "all-gather": 8 * 3 * 4,
                                        "reduce-scatter": 2 * 3 * 4}
    # a dim split over the whole grid (a decode cache's kv_seq)
    x = torch.randn(2, 16, 3, generator=g)
    p = spmd.place(x, ("batch", "kv_seq", None), mesh, DECODE_RULES)
    assert p.spec == (None, ("data", "model"))
    pieces = [t.clone().requires_grad_() for t in p.pieces]
    whole = spmd.gathered_over(p.like(pieces), "data", "model")
    for t in whole:
        assert torch.equal(t, x)
    sum(t.sum() * c for t, c in zip(whole, w)).backward()
    for t in pieces:
        torch.testing.assert_close(t.grad, torch.full((2, 4, 3), sum(w)))
    # the minor axis alone joins pieces that lie side by side
    rows = spmd.gathered_over(p, "model")
    assert torch.equal(rows[3], x[:, 8:])
    with pytest.raises(NotImplementedError, match="side by side"):
        spmd.gathered_over(p, "data")


def test_relayout_copies_what_a_position_lacks():
    """``relayout`` moves a placed tensor to another spec without
    gathering it whole; each position counts the bytes it took from
    others."""
    mesh = cpu_mesh((2, 2))
    x = torch.arange(4 * 8 * 2 * 3, dtype=torch.float32).reshape(4, 8, 2, 3)
    axes = ("batch", "kv_seq", "kv_heads", None)
    p = spmd.place(x, axes, mesh, PREFILL_RULES)
    assert p.spec == ("data", "model")
    spmd.reset_collective_bytes()
    q = spmd.relayout(p, pspec_for(axes, mesh, DECODE_RULES, x.shape))
    assert q.spec == (None, ("data", "model"))
    assert torch.equal(spmd.gather(q), x)
    for r in range(4):
        assert torch.equal(q.pieces[r], spmd._narrow(x, q.spec, mesh, r))
    # position 0 holds rows 0-1, slots 0-3 and needs rows 0-3, slots 0-1:
    # it lacks rows 2-3's 2 slots (2 x 2 x 2 x 3 floats)
    assert spmd.moved_bytes(0) == 2 * 2 * 2 * 3 * 4
    same = spmd.relayout(q, q.spec)
    assert all(torch.equal(a, b) for a, b in zip(same.pieces, q.pieces))


def old_decode_attention(q, k, v, valid_from, valid_to):
    """``decode_attention`` as it stood before its split into pieces."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = (q * D ** -0.5).reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float())
    pos = torch.arange(S)[None]
    mask = ((pos >= torch.as_tensor(valid_from).reshape(-1, 1))
            & (pos < torch.as_tensor(valid_to).reshape(-1, 1)))
    s = s.masked_fill(~mask[:, None, None, :], attention.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", (p / l).to(v.dtype).float(),
                       v.float())
    return out.reshape(B, Hq, D).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partial_decode_attention(dtype):
    """One piece gives the function as it stood, bit for bit (so the
    no-mesh path keeps its numbers); 2 and 4 pieces, one of them with no
    valid slot, give one piece's values within 1e-6 (fp32), ragged
    bounds included."""
    g = torch.Generator().manual_seed(0)
    B, H, Hkv, D, S = 3, 8, 2, 16, 32
    q = torch.randn(B, H, D, generator=g).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=g).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=g).to(dtype)
    for vf, vt in ((0, 13), (0, S), (torch.tensor([0, 2, 5]),
                                     torch.tensor([7, 13, 20]))):
        one = attention.decode_attention(q, k, v, vf, vt)
        assert torch.equal(one, old_decode_attention(q, k, v, vf, vt))
        if dtype != torch.float32:
            continue
        for n in (2, 4):
            c = S // n
            parts = [attention.decode_attention_partial(
                q, k[:, i * c:(i + 1) * c], v[:, i * c:(i + 1) * c], i * c,
                vf, vt) for i in range(n)]
            if isinstance(vt, int) and vt <= S - c:
                m, l, o = parts[-1]          # slots past valid_to
                assert (m == attention.NEG_INF).all() and (l == 0).all()
                assert (o == 0).all()
            outs = attention.combine_decode_attention(parts)
            got = outs[0].reshape(B, H, D)
            torch.testing.assert_close(got, one, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-2.7b",
                                  "paligemma-3b", "seamless-m4t-medium"])
def test_other_families_refuse_the_serving_mesh(arch):
    """Every family prefills and decodes on a (data, model) mesh (the
    MoE, SSM and hybrid families: ``tests/test_torch_mesh_serve_families.
    py``; the frontend and encoder-decoder families:
    ``tests/test_torch_mesh_serve_encdec.py``), and on a multi-pod mesh
    (``tests/test_torch_mesh_pod.py``); a mesh axis that no sharding rule
    names raises on both paths, for every family."""
    cfg = dataclasses.replace(tc.get_config(arch).reduced(), dtype="float32")
    lm = LM(cfg)
    mesh = make_mesh((1, 2, 2), ("stage", "data", "model"), "cpu")
    with pytest.raises(NotImplementedError, match="sharding rules"):
        lm.prefill({}, batch_of(cfg)[0], 16, mesh=mesh)
    with pytest.raises(NotImplementedError, match="sharding rules"):
        lm.decode_step({}, [], {"token": torch.zeros(4, dtype=torch.long),
                                "cache_len": 3}, mesh=mesh)


def test_inspector_traces_a_mesh_prefill(monkeypatch, capsys):
    """``inspect_hlo --mesh 2,2`` on a prefill cell of the reduced
    gemma3-1b: flash at each position's heads, the caches built, four
    position lines with their all-gathers (the heads gathered for the
    caches, the logits) and all-reduces; and on decode cells of the
    reduced qwen3-moe and seamless (one layer each, the inspector's one
    period; seamless's cross caches over its 8 source frames): four
    position lines, each with the bytes ``serve_mesh_decode_bytes``
    derives from the shapes."""
    orig = tc.get_config
    monkeypatch.setattr(tc, "get_config", lambda a: orig(a).reduced())
    monkeypatch.setattr(tc, "SHAPES",
                        {"p": tc.ShapeConfig("p", 32, 4, "prefill"),
                         "d": tc.ShapeConfig("d", 32, 4, "decode")})
    assert inspect_hlo.main(["--arch", "gemma3-1b", "--shape", "p",
                             "--mesh", "2,2", "--device", "cpu", "--top",
                             "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# gemma3-1b p periods=1")
    assert "mesh={'data': 2, 'model': 2}, 4 shards here" in out[0]
    coll = [ln for ln in out if ln.startswith("# position")]
    assert len(coll) == 4
    assert all("'all-reduce': 0," not in ln and "'all-gather': 0," not in ln
               for ln in coll)
    assert inspect_hlo.main(["--arch", "qwen3-moe-30b-a3b", "--shape", "d",
                             "--mesh", "2,2", "--device", "cpu", "--top",
                             "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# qwen3-moe-30b-a3b d periods=1")
    cfg = dryrun.depth_variant(tc.get_config("qwen3-moe-30b-a3b"), 1, 1)
    want = chip_smoke.serve_mesh_decode_bytes(cfg, 2, 2, 4)
    assert want == {"all-reduce": 6896, "all-gather": 3072,
                    "reduce-scatter": 0}
    coll = [ln for ln in out if ln.startswith("# position")]
    assert len(coll) == 4
    assert all(f"collective bytes {want}," in ln for ln in coll), coll
    assert inspect_hlo.main(["--arch", "seamless-m4t-medium", "--shape",
                             "d", "--mesh", "2,2", "--device", "cpu",
                             "--top", "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# seamless-m4t-medium d periods=1")
    cfg = dryrun.depth_variant(tc.get_config("seamless-m4t-medium"), 1, 1)
    want = chip_smoke.serve_mesh_decode_bytes(cfg, 2, 2, 4)
    assert want == {"all-reduce": 6208, "all-gather": 3584,
                    "reduce-scatter": 0}
    coll = [ln for ln in out if ln.startswith("# position")]
    assert len(coll) == 4
    assert all(f"collective bytes {want}," in ln for ln in coll), coll
