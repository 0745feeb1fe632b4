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
- ``--all --report`` over reduced configs at small shapes writes every
  cell's JSON and reads it back; the inspector runs a reduced cell on the
  CPU.
"""
import dataclasses
import json
import os

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


def reduced(monkeypatch, tmp_path):
    orig = tc.get_config
    monkeypatch.setattr(dryrun, "get_config", lambda a: orig(a).reduced())
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)


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
            assert rl["collective_s"] is None and "item 3" in \
                rl["collective_note"]
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
