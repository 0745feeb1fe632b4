"""The port's dry-run (``repro_torch/launch/dryrun.py``) and inspector
(``launch/inspect_hlo.py``) on the CPU.

- Per-device bytes of every cell (13 configs x 4 shapes x both production
  meshes, full geometry): the weights/opt/cache groups and the step's
  arguments equal the reference's ``_group_bytes_per_device`` and
  ``_arg_bytes_per_device`` (rtol 1e-9), and so does the microbatch count
  a mesh rounds to.
- FLOPs on meta: affine in depth (the reference's extrapolation identity
  has no counterpart: the counter sees every layer); a train step counted
  one microbatch at a time equals the whole step's count exactly; a
  reduced cell's count against ``model_flops`` (exact where the
  difference is known: the norm weights ``model_flops`` counts as matmul
  parameters, the prefill's logits at the last token only, exact causal
  pairs; a band for train, whose count adds remat's recompute and the
  plain flash backward); a flash call on meta counted by the kernel's
  formula, not the plain version's.
- Collective bytes: a step run over a mesh of meta positions counts, at
  every position, exactly what the same step counts on CPU positions
  (reduced llama3-8b and qwen3-moe, train, prefill and decode, on (2, 2)
  and (2, 2, 2)); the one-and-two-period extrapolation of a cell equals
  its full-depth count exactly (a train step: one microbatch's count
  times their number); a production cell's collective term on both
  meshes.
- ``--all --report`` over reduced configs at small shapes on both
  production meshes writes every cell's JSON and reads it back; each
  cell's collective count there runs on (1, 2) or (2, 1, 2) in place of
  the production mesh (at 256 or 512 positions a count runs every
  position's operations on meta: seconds a cell). The inspector runs a
  reduced cell on the CPU.
"""
import dataclasses
import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import repro.configs as rc  # noqa: E402
import repro.distributed.sharding as rsh  # noqa: E402
import repro.models.api as ref_api  # noqa: E402

import repro_torch.configs as tc  # noqa: E402
import repro_torch.distributed.sharding as rsh_port  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels import flash_attention as flash_k  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.launch import dryrun, inspect_hlo, roofline  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.api import make_step_bundle  # noqa: E402
from repro_torch.models.attention import flash_attention  # noqa: E402

RTOL = 1e-9


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module. It sets XLA_FLAGS to 512 host
    devices when imported; the backend is brought up first, so this process
    keeps its devices, and the variable is restored for later processes."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as m
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return m


def fake_mesh(m):
    n = m.size
    devs = np.array(jax.devices() * (n // len(jax.devices()) + 1))[:n]
    return JaxMesh(devs.reshape(m.axis_sizes), m.axis_names)


@pytest.mark.parametrize("arch", tc.ARCH_IDS)
def test_bytes_per_device_equal_reference(arch, ref_dryrun):
    cfg = rc.get_config(arch)
    for shape_name in tc.SHAPES:
        ok, _ = rc.shape_applicable(cfg, rc.SHAPES[shape_name])
        for mesh_kind in ("single", "multi"):
            rec = dryrun.run_cell(arch, shape_name, mesh_kind, count=False)
            if not ok:
                assert rec["status"] == "skipped"
                continue
            assert rec["status"] == "ok"
            m = make_production_mesh(multi_pod=mesh_kind == "multi")
            ref_m = fake_mesh(m)
            shape = rc.SHAPES[shape_name]
            rules = rsh.rules_for_shape(shape.kind, shape.global_batch)
            with rsh.sharding_ctx(ref_m, rules):
                rb = ref_api.make_step_bundle(cfg, shape)
            assert rec.get("microbatches") == rb.static_meta.get(
                "microbatches")
            want = {name: ref_dryrun._group_bytes_per_device(
                grp, ref_m, rules, rsh.pspec_for)
                for name, grp in rb.byte_groups.items()}
            assert rec["local_bytes"].keys() == want.keys()
            for name, v in want.items():
                assert rec["local_bytes"][name] == pytest.approx(
                    v, rel=RTOL), (shape_name, mesh_kind, name)
            assert rec["arg_bytes_per_device"] == pytest.approx(
                ref_dryrun._arg_bytes_per_device(rb, ref_m, rules,
                                                 rsh.pspec_for), rel=RTOL)


def count(cfg, shape, **kw):
    b = make_step_bundle(cfg, shape, **kw)
    return dryrun.count_step_flops(cfg, shape, b, {})


@pytest.mark.parametrize("shape", [ShapeConfig("p", 64, 2, "prefill"),
                                   ShapeConfig("t", 32, 4, "train")],
                         ids=["prefill", "train"])
def test_counted_flops_affine_in_depth(shape):
    base = tc.get_config("yi-34b").reduced()
    p = dryrun.period_len(base)
    f1, f2, f3 = (count(dryrun.depth_variant(base, n, p), shape,
                        microbatches=2)["flops"] for n in (1, 2, 3))
    assert f2 > f1 > 0
    assert f3 - f2 == pytest.approx(f2 - f1, rel=1e-12)


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-moe-30b-a3b"])
def test_train_counted_per_microbatch_equals_whole_step(arch):
    cfg = tc.get_config(arch).reduced()
    shape = ShapeConfig("t", 32, 8, "train")
    b = make_step_bundle(cfg, shape, microbatches=4)
    whole = dryrun.count_flops(b)
    per_mb = dryrun.count_step_flops(cfg, shape, b, {})
    assert per_mb["counted_microbatches"] == 1
    assert per_mb["flops"] == whole["flops"] > 0
    assert per_mb["kernel_calls"] == whole["kernel_calls"]


def test_counted_flops_against_model_flops():
    cfg = tc.get_config("llama3-8b").reduced()
    L, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    hq = cfg.num_heads * cfg.head_dim
    norms = 2 * L * d     # ln1, ln2: weights model_flops counts, no matmul
    B, S = 4, 64
    dec = ShapeConfig("d", S, B, "decode")
    assert count(cfg, dec)["flops"] == pytest.approx(
        roofline.model_flops(cfg, dec) - 2 * B * norms, rel=1e-12)
    pre = ShapeConfig("p", S, B, "prefill")
    c = count(cfg, pre)
    # logits at the last token only; causal pairs S(S+1)/2, not S^2/2
    want = (roofline.model_flops(cfg, pre) - 2 * B * S * norms
            - 2 * B * (S - 1) * d * V + 4 * B * (S / 2) * hq * L)
    assert c["flops"] == pytest.approx(want, rel=1e-12)
    assert c["kernel_calls"]["flash_attention"] == L
    # train: a 3x forward in model_flops; the count adds remat's recompute
    # and the plain chunked flash backward (measured 1.33 here)
    tr = ShapeConfig("t", S, 8, "train")
    ratio = count(cfg, tr)["flops"] / roofline.model_flops(cfg, tr)
    assert 1.2 <= ratio <= 1.45


def test_flash_on_meta_counts_the_kernel_formula():
    B, S, H, Hkv, D = 2, 96, 4, 2, 16
    q = torch.empty(B, S, H, D, device="meta", dtype=torch.bfloat16)
    k = torch.empty(B, S, Hkv, D, device="meta", dtype=torch.bfloat16)
    ops.reset_meta_costs()
    with FlopCounterMode(display=False) as fc:
        out = flash_attention(q, k, k, causal=True, window=32, q_offset=0)
    assert out.shape == q.shape and out.device.type == "meta"
    assert fc.get_total_flops() == 0 and ops.launch_counts()[
        "flash_attention"] == 0
    want = flash_k.flops_and_bytes(B, S, S, H, Hkv, D, causal=True,
                                   window=32, q_offset=0, itemsize=2)
    got = ops.meta_costs()["flash_attention"]
    assert (got["calls"], got["flops"], got["bytes"]) == (1, *want)
    # the plain version would count every score, masked ones included
    with FlopCounterMode(display=False) as fc:
        flash_attention_ref(q, k, k, causal=True, window=32, q_offset=0)
    assert fc.get_total_flops() == 4 * B * S * S * H * D > want[0]
    ops.reset_meta_costs()


SMALL = {"train_4k": ShapeConfig("train_4k", 32, 32, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 64, 2, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 64, 4, "decode"),
         "long_500k": ShapeConfig("long_500k", 128, 1, "decode")}


def small_mesh(*, multi_pod=False):
    return tc_mesh((2, 1, 2) if multi_pod else (1, 2))


def tc_mesh(shape):
    from repro_torch.distributed.sharding import Mesh
    return Mesh(("pod", "data", "model")[-len(shape):], shape)


def reduced(monkeypatch, tmp_path):
    """Reduced configs at ``SMALL`` shapes on the production meshes, each
    cell's collectives counted on ``small_mesh`` of the same axes."""
    orig = tc.get_config
    monkeypatch.setattr(dryrun, "get_config", lambda a: orig(a).reduced())
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    costs = dryrun.collective_costs

    def on_small_mesh(cfg, shape, mesh_desc, *args, **kw):
        multi = "pod" in mesh_desc.axis_names
        return costs(cfg, shape, small_mesh(multi_pod=multi), *args, **kw)
    monkeypatch.setattr(dryrun, "collective_costs", on_small_mesh)


def test_all_and_report_on_reduced_configs(monkeypatch, tmp_path, capsys):
    reduced(monkeypatch, tmp_path)
    assert dryrun.main(["--all", "--mesh", "both"]) == 0
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == len(tc.ARCH_IDS) * len(SMALL) * 2
    for f in files:
        rec = json.loads(f.read_text())
        assert rec["status"] in ("ok", "skipped"), (f.name, rec)
        if rec["status"] == "ok" and rec["mesh"] == "single":
            rl = rec["roofline"]
            assert rl["flops_per_device"] > 0 and rl["memory_s"] > 0
            assert rl["collective_s"] > 0 and "collective_note" not in rl
            assert rl["collective_detail"] == \
                rec["collective_detail_full_compile"]
        if rec["status"] == "ok":
            assert rec["devices"] == (256 if rec["mesh"] == "single"
                                      else 512)
            assert sum(rec["collective_detail_full_compile"].values()) > 0
            assert rec["collective_count"]["positions"] == (
                2 if rec["mesh"] == "single" else 4)
        if rec["mesh"] == "multi":
            assert "roofline" not in rec
    # cached: a second --all runs nothing
    capsys.readouterr()
    assert dryrun.main(["--all", "--mesh", "both"]) == 0
    assert capsys.readouterr().out.startswith("0 cells to run")
    assert dryrun.main(["--report"]) == 0
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows[0].startswith("arch,shape,mesh,status,bneck")
    assert len(rows) == 1 + len(files)


def test_single_cell_cli_on_reduced_config(monkeypatch, tmp_path, capsys):
    reduced(monkeypatch, tmp_path)
    assert dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k",
                        "--mesh", "single", "--microbatches", "2",
                        "--moments-dtype", "int8", "--tag", "t"]) == 0
    rec = json.loads((tmp_path / "gemma3-1b__train_4k__single__t.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["microbatches"] == 2
    assert rec["moments_dtype"] == "int8"
    assert rec["flop_count"]["kernel_calls"]["flash_attention"] > 0
    assert "gemma3-1b train_4k single" in capsys.readouterr().out


def test_inspector_on_cpu(monkeypatch, capsys):
    orig = tc.get_config
    monkeypatch.setattr(tc, "get_config", lambda a: orig(a).reduced())
    monkeypatch.setattr(tc, "SHAPES", SMALL)
    assert inspect_hlo.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                             "--device", "cpu", "--top", "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# llama3-8b decode_32k periods=1")
    assert "on cpu" in out[0]
    assert out[1].split() == ["ms", "share", "calls", "operation"]
    assert len([ln for ln in out[2:] if ln.startswith(" ")]) == 5
    assert "aten::" in "\n".join(out)
    with pytest.raises(SystemExit):
        inspect_hlo.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                          "--mesh", "single", "--device", "cpu"])


def small_bundle(cfg, shape, mesh_desc, **kw):
    rules = rsh_port.rules_for_shape(shape.kind)
    with rsh_port.sharding_ctx(mesh_desc, rules):
        return make_step_bundle(cfg, shape, **kw), rules


COLL_SHAPES = [ShapeConfig("t", 16, 8, "train"),
               ShapeConfig("p", 32, 4, "prefill"),
               ShapeConfig("d", 32, 4, "decode")]


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 2, 2)])
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-moe-30b-a3b"])
def test_meta_collectives_equal_cpu(arch, mesh_shape):
    """The same step run over meta positions and over CPU positions (zero
    weights and inputs) counts the same bytes of every kind at every
    position, exactly: the meta run's memoized results (``_MetaMemo``)
    and its flash backward in one chunk give the CPU's shapes and
    dtypes."""
    cfg = tc.get_config(arch).reduced()
    desc = tc_mesh(mesh_shape)
    for shape in COLL_SHAPES:
        b, rules = small_bundle(cfg, shape, desc, microbatches=1)
        meta = dryrun.count_collectives(b, cfg, desc, rules, "meta")
        cpu = dryrun.count_collectives(b, cfg, desc, rules, "cpu")
        assert meta["per_position"] == cpu["per_position"], shape.kind
        assert sum(meta["bytes"].values()) > 0
        assert meta["positions"] == desc.size


@pytest.mark.parametrize("arch,layers,kinds", [
    ("llama3-8b", 3, ("train", "prefill", "decode")),
    ("gemma3-1b", 18, ("decode",)), ("seamless-m4t-medium", 3, ("prefill",))])
def test_collective_extrapolation_equals_full_depth(arch, layers, kinds):
    """``collective_costs`` from one and two periods of the layer pattern
    (gemma3's six layers, seamless's encoder scaled with its decoder) at
    one microbatch, extrapolated to three periods (and a train step's two
    microbatches), equals the count of the whole step at full depth, on
    (2, 2, 2)."""
    cfg = tc.get_config(arch).reduced()
    kw = {"num_layers": layers}
    if cfg.num_encoder_layers:
        kw["num_encoder_layers"] = layers
    cfg = dataclasses.replace(cfg, **kw)
    desc = tc_mesh((2, 2, 2))
    for shape in COLL_SHAPES:
        if shape.kind not in kinds:
            continue
        b, rules = small_bundle(cfg, shape, desc, microbatches=2)
        whole = dryrun.count_collectives(b, cfg, desc, rules)["bytes"]
        mb = b.static_meta.get("microbatches", 1)
        got = dryrun.collective_costs(cfg, shape, desc, rules, mb, {})
        assert got["periods_full"] == 3
        assert got["bytes"] == whole, shape.kind


def test_meta_memo_gives_meta_results():
    """Under ``_MetaMemo`` an operation met again (other tensors of the
    same shapes, strides and dtypes) gives what plain meta gives: shape,
    strides and dtype, a Python int and float apart, a tuple as a tuple,
    a view still a view of its input; the one-chunk flash backward is
    undone on leaving."""
    def cases():
        x = torch.empty((4, 6), device="meta")
        i = torch.empty((4, 6), dtype=torch.int32, device="meta")
        t = torch.empty((6, 4), device="meta").t()      # not contiguous
        return [x * 2.0, i * 2, i * 2.0, i / 2, t + 1, t.exp(),
                torch.cat([x, t]), x.max(dim=1), torch.sort(i, dim=0),
                x.sum(dim=(0,), keepdim=True), x @ x.t(), x[:, 1:3],
                (x > 0).to(torch.bfloat16), torch.where(x > 0, i, x)]

    def flat(outs):
        return [o if isinstance(o, tuple) else (o,) for o in outs]
    want = flat(cases())
    with dryrun._MetaMemo() as memo:
        first, again = flat(cases()), flat(cases())
    assert memo.made
    for w, f, a in zip(want, first, again):
        assert len(w) == len(f) == len(a)
        for wt, ft, at in zip(w, f, a):
            for got in (ft, at):
                assert (got.shape, got.stride(), got.dtype) == (
                    wt.shape, wt.stride(), wt.dtype)
    assert again[11][0]._base is not None        # x[:, 1:3] stays a view
    keep = dryrun.attention.BWD_CHUNK_Q
    with dryrun._one_backward_chunk():
        assert dryrun.attention.BWD_CHUNK_Q > 2 ** 40
    assert dryrun.attention.BWD_CHUNK_Q == keep


def test_production_cell_collective_term(monkeypatch, tmp_path, capsys):
    """A production cell on both meshes (256 and 512 meta positions): the
    single-pod record's roofline has a collective term, from the count
    recorded under the reference's key on both. The cell is llama3-8b's
    decode: a dense decoder's pattern is one layer, so its count runs
    three layers; gemma3-1b's six-layer pattern runs eighteen, 22 s and 42
    s on a CPU host (PERF.md), too long for this file's share of the
    suite."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    t0 = time.time()
    assert dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                        "--mesh", "both"]) == 0
    took = time.time() - t0
    single = json.loads((tmp_path / "llama3-8b__decode_32k__single.json")
                        .read_text())
    multi = json.loads((tmp_path / "llama3-8b__decode_32k__multi.json")
                       .read_text())
    for rec, n in ((single, 256), (multi, 512)):
        assert rec["status"] == "ok"
        assert rec["collective_count"]["positions"] == n
        coll = rec["collective_detail_full_compile"]
        assert coll["all-reduce"] > 0 and coll["all-gather"] > 0
    rl = single["roofline"]
    assert rl["collective_s"] == pytest.approx(
        sum(single["collective_detail_full_compile"].values())
        / roofline.H100_SXM.link_bw, rel=1e-12)
    assert "roofline" not in multi
    print(f"llama3-8b decode_32k on both meshes: {took:.1f} s")
    assert took < 60
