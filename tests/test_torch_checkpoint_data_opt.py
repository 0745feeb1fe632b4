"""The port's checkpoints, data pipeline and AdamW: the nine tests of
``tests/test_checkpoint_data_opt.py`` ported to ``repro_torch`` (round
trip, async save and retention, the snapshot taken before the async
write, data determinism and resume, the prefetcher, AdamW on a quadratic,
the moment dtypes, int8 structs matching init, the blockwise round trip),
plus: the port's ``SyntheticPacked`` batches equal the reference's bit for
bit, and a leaf of a port checkpoint read with the reference's
``CheckpointManager._from_storable`` and its manifest dtype equals the
port's tensor (the on-disk format is the reference's)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.ckpt import CheckpointManager as RefManager  # noqa: E402
from repro.data.pipeline import SyntheticPacked as RefPacked  # noqa: E402

from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402
from repro_torch.data.pipeline import Prefetcher, SyntheticPacked  # noqa: E402
from repro_torch.optimizer import adamw  # noqa: E402


def test_checkpoint_roundtrip(tmp_path):
    state = {"a": torch.arange(12.0).reshape(3, 4),
             "b": {"c": torch.ones(5, dtype=torch.bfloat16)},
             "step": torch.tensor(7, dtype=torch.int32)}
    mgr = CheckpointManager(tmp_path)
    mgr.save(7, state)
    out = mgr.restore(7, state, "cpu")
    for a, b in zip(flatten(state)[0], flatten(out)[0]):
        assert torch.equal(a, b)
        assert a.dtype == b.dtype


def test_checkpoint_async_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.full((4,), float(s))}, async_=True)
    mgr.wait()
    assert sorted(mgr.all_steps()) == [3, 4]
    out = mgr.restore(4, {"x": torch.zeros(4)}, "cpu")
    np.testing.assert_array_equal(out["x"].numpy(), np.full(4, 4.0))


def test_checkpoint_values_snapshot_before_async(tmp_path):
    """Async save must capture values at call time, not at write time."""
    mgr = CheckpointManager(tmp_path)
    x = torch.zeros(1000)
    mgr.save(1, {"x": x}, async_=True)
    x.add_(1)   # in place; the saved value must remain 0
    mgr.wait()
    out = mgr.restore(1, {"x": x}, "cpu")
    assert float(out["x"].sum()) == 0.0


def test_data_determinism_and_resume():
    a = SyntheticPacked(1000, 32, 4, seed=5)
    b = SyntheticPacked(1000, 32, 4, seed=5)
    batches_a = [next(a) for _ in range(5)]
    b.skip_to(3)
    batch_b3 = next(b)
    np.testing.assert_array_equal(batches_a[3]["tokens"], batch_b3["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(batches_a[0]["tokens"][:, 1:],
                                  batches_a[0]["labels"][:, :-1])


def test_data_prefetcher():
    it = Prefetcher(iter([{"x": np.ones(2)} for _ in range(4)]), depth=2)
    got = list(it)
    assert len(got) == 4


def _grad(p, fn):
    p = p.detach().requires_grad_()
    return torch.autograd.grad(fn(p), p)[0]


def test_adamw_converges_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init_state(params, cfg)
    for _ in range(200):
        g = {"w": _grad(params["w"], lambda w: torch.sum(w ** 2))}
        params, state, _ = adamw.apply_update(params, g, state, cfg)
    assert float(params["w"].abs().max()) < 0.05


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_adamw_moment_dtypes(mode):
    cfg = adamw.AdamWConfig(lr=0.05, moments_dtype=mode, weight_decay=0.0,
                            warmup_steps=1)
    params = {"w": torch.from_numpy(np.random.default_rng(0)
                                    .standard_normal(512).astype(np.float32))}
    state = adamw.init_state(params, cfg)
    for _ in range(150):
        g = {"w": _grad(params["w"], lambda w: torch.sum((w - 1.0) ** 2))}
        params, state, _ = adamw.apply_update(params, g, state, cfg)
    err = float((params["w"] - 1.0).abs().mean())
    assert err < 0.15, f"{mode}: {err}"


def test_int8_state_structs_match_init():
    cfg = adamw.AdamWConfig(moments_dtype="int8")
    params = {"w": torch.zeros((130, 7))}   # non-multiple of BLOCK
    state = adamw.init_state(params, cfg)
    structs = adamw.state_structs(params, cfg)
    got, want = flatten(state)[0], flatten(structs)[0]
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape and a.dtype == b.dtype


def test_blockwise_quant_roundtrip():
    x = torch.from_numpy((np.random.default_rng(1).standard_normal(1000)
                          * 3).astype(np.float32))
    q, s = adamw._blockwise_quant(x)
    y = adamw._blockwise_dequant(q, s, (1000,))
    assert float((x - y).abs().max()) < 3 * float(s.max()) / 127 * 127
    rel = float((x - y).abs().max() / x.abs().max())
    assert rel < 0.02


@pytest.mark.parametrize("seed", [0, 1])
def test_data_equals_reference_bit_for_bit(seed):
    ref, port = RefPacked(256, 32, 4, seed=seed), SyntheticPacked(
        256, 32, 4, seed=seed)
    for step in range(4):
        want, got = next(ref), next(port)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{k} at step {step}")
    ref.skip_to(5)
    port.skip_to(5)
    want, got = next(ref), next(port)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert port.state() == ref.state() == {"step": 6, "seed": seed}


def test_restore_needs_cuda_unless_asked_for_cpu(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.zeros(2)})
    if torch.cuda.is_available():
        assert mgr.restore(1, {"x": 0})["x"].is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        mgr.restore(1, {"x": 0})


def test_checkpoint_format_is_the_references(tmp_path):
    """Each leaf of a port checkpoint (bf16, fp32, int8 and int32), read
    as the reference reads it, equals the port's tensor; the manifest
    has the reference's keys."""
    g = torch.Generator().manual_seed(0)
    state = {"w": torch.randn((3, 5), generator=g).to(torch.bfloat16),
             "m": adamw.Quantized(torch.randint(-127, 128, (3, 4),
                                                generator=g,
                                                dtype=torch.int8),
                                  torch.rand((3, 1), generator=g)),
             "step": torch.tensor(3, dtype=torch.int32)}
    CheckpointManager(tmp_path).save(3, state)
    d = tmp_path / "step_00000003"
    manifest = json.loads((d / "manifest.json").read_text())
    assert sorted(manifest) == ["leaves", "step", "time"]
    assert manifest["step"] == 3
    leaves = flatten(state)[0]
    assert [m["dtype"] for m in manifest["leaves"]] == [
        "int8", "float32", "int32", "bfloat16"]
    for i, (meta, t) in enumerate(zip(manifest["leaves"], leaves)):
        assert meta["i"] == i and meta["shape"] == list(t.shape)
        arr = RefManager._from_storable(np.load(d / f"leaf_{i}.npy"),
                                        meta["dtype"])
        assert str(arr.dtype) == meta["dtype"]
        np.testing.assert_array_equal(np.asarray(arr, np.float32),
                                      t.float().numpy())
