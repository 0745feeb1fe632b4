"""The port's training launcher and grouped remat on the CPU: ports of
``tests/test_system.py::test_train_launcher_and_resume`` and
``::test_train_int8_moments`` (``--device cpu``), with the resumed losses
equal to an uninterrupted run's (on the CPU the steps are deterministic);
``tests/test_elastic.py::test_remat_group_preserves_loss`` (``remat_group``
1 against 2: loss within 1e-6 relative, gradients within 1e-5); ``--mesh``
on the SSM and hybrid configs against no mesh, frontend configs failing
alike with and without it, and a third mesh axis raising; the launcher
and examples refusing to run without a card unless asked for the CPU; and
``examples/torch/quickstart.py`` at two steps."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as tc  # noqa: E402
from repro_torch.launch.train import main  # noqa: E402
from repro_torch.models.api import make_demo_inputs  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.models.params import init_lm_params  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "yi-34b", "--reduced", "--batch", "4", "--seq", "32",
        "--log-every", "100", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    # tiny CPU tensors: a thread pool costs far more than it saves
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_launcher_and_resume(tmp_path):
    losses = main(ARGS + ["--steps", "8", "--ckpt-dir", str(tmp_path),
                          "--ckpt-every", "4"])
    assert len(losses) == 8
    # resume continues from the step-8 checkpoint
    more = main(ARGS + ["--steps", "10", "--ckpt-dir", str(tmp_path),
                        "--resume"])
    assert len(more) == 2
    whole = main(ARGS + ["--steps", "10"])
    assert whole == losses + more


def test_train_int8_moments():
    losses = main(ARGS + ["--steps", "6", "--moments-dtype", "int8"])
    assert losses[-1] < losses[0] + 0.5


def test_remat_group_preserves_loss():
    """Grouped remat is a pure memory optimization: identical loss/grads."""
    cfg = dataclasses.replace(tc.get_config("yi-34b").reduced(),
                              num_layers=4, dtype="float32")
    batch = make_demo_inputs(cfg, tc.ShapeConfig("t", 16, 2, "train"))
    params = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    out = []
    for g in (1, 2):
        loss = LM(cfg, remat_group=g).train_loss(params, batch)
        out.append((loss.item(), torch.autograd.grad(loss, leaves)))
    (l1, g1), (l2, g2) = out
    assert l1 == pytest.approx(l2, rel=1e-6)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_mesh_raises_naming_item_3():
    """A mesh trains every family (``tests/test_torch_mesh_families.py``)
    and serves the dense decoder families
    (``tests/test_torch_mesh_serve.py``), the multi-pod mesh too
    (``tests/test_torch_mesh_pod.py``); what the step still refuses, a
    mesh axis that no sharding rule names, raises; the launcher's
    ``--mesh`` keeps the reference's two axes, and a third raises."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optimizer.adamw import AdamWConfig
    from repro_torch.training.step import make_train_step
    make_train_step(LM(tc.get_config("mamba2-2.7b").reduced()),
                    AdamWConfig(), mesh=make_mesh(
                        (1, 1, 2), ("pod", "data", "model"), "cpu"))
    mesh = make_mesh((1, 1, 2), ("stage", "data", "model"), "cpu")
    with pytest.raises(NotImplementedError, match="sharding rules"):
        make_train_step(LM(tc.get_config("mamba2-2.7b").reduced()),
                        AdamWConfig(), mesh=mesh)
    with pytest.raises(ValueError, match="differ in length"):
        main(ARGS + ["--mesh", "1,1,2", "--steps", "1"])


MESH_ARGS = ARGS[2:] + ["--microbatches", "2", "--steps", "3", "--reduced"]
# bf16 losses on a mesh against none: the partials add in another order
# (mamba2 2.4e-4, jamba on (1, 2) 9.2e-4 measured on the CPU)
BF16_RTOL = 2e-3
# jamba on (2, 2): each data shard fills its own expert capacity (9.4e-3)
MOE_RTOL = 2e-2


def test_mesh_trains_ssm_and_hybrid_as_without_one():
    """``--mesh`` on the reduced mamba2 (SSM heads and channels over
    "model") and jamba at one whole period of 8 layers (SSM, attention,
    MoE) against the same launcher with no mesh: the same weights and data,
    bf16 losses within ``BF16_RTOL`` (jamba on (2, 2) within ``MOE_RTOL``:
    its per-data-shard capacity drops other tokens)."""
    for arch, extra, meshes in (
            ("mamba2-2.7b", [], (("2,2", BF16_RTOL),)),
            ("jamba-1.5-large-398b", ["--layers", "8"],
             (("1,2", BF16_RTOL), ("2,2", MOE_RTOL)))):
        args = MESH_ARGS + ["--arch", arch] + extra
        whole = main(args)
        for shape, rtol in meshes:
            on_mesh = main(args + ["--mesh", shape])
            assert len(on_mesh) == 3
            np.testing.assert_allclose(on_mesh, whole, rtol=rtol,
                                       err_msg=f"{arch} {shape}")


@pytest.mark.parametrize("arch,key", [("paligemma-3b", "embeds"),
                                      ("seamless-m4t-medium", "src_embeds")])
def test_frontend_configs_fail_alike_with_and_without_mesh(arch, key):
    """The launcher's data (``SyntheticPacked``) has tokens only, as the
    reference launcher's: a frontend config finds no ``embeds`` or
    ``src_embeds`` with a mesh exactly as without one."""
    for extra in ([], ["--mesh", "2,2"]):
        with pytest.raises(KeyError, match=key):
            main(MESH_ARGS + ["--arch", arch] + extra)


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_launcher_and_examples_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "yi-34b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        load_example("quickstart").main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        load_example("serve_small_real").main([])


def test_quickstart_example_on_cpu(capsys):
    losses, toks = load_example("quickstart").main(["--steps", "2",
                                                    "--device", "cpu"])
    assert len(losses) == 2 and len(toks) == 11
    assert "generated token ids:" in capsys.readouterr().out
