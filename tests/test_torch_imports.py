"""Import hygiene of the port: no file of ``src/repro_torch`` or
``examples/torch`` and no line of ``chip_smoke.py`` imports JAX or the JAX
package, and the port's entry
points never fall back to the CPU on their own."""
import ast
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples" / "torch").glob(
        "*.py"))
FORBIDDEN = re.compile(r"^(jax|jaxlib|repro)(\.|$)")


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], (ast.Constant, ast.JoinedStr))):
            arg = node.args[0]
            head = arg.value if isinstance(arg, ast.Constant) else \
                "".join(v.value for v in arg.values
                        if isinstance(v, ast.Constant))
            yield head


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    bad = [m for m in imported_modules(path) if FORBIDDEN.match(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_new_modules_are_covered_and_import_no_jax():
    """The modules of the int8 tier, the serving CLI, the HTTP front door,
    the dense executor and its LM (MoE, SSM, inputs included), the
    training stack (data, optimizer, train step, checkpoints, launcher) and
    the launch tooling (sharding rules, meshes, roofline, dry-run,
    inspector, in-place audit) and tensor parallelism (the plan, the
    host check) are among the files checked above, and
    importing
    all of them loads neither JAX nor the reference package (checked in a
    fresh interpreter)."""
    import os
    import subprocess
    import sys
    mods = ["repro_torch.kernels.quant", "repro_torch.serving.telemetry",
            "repro_torch.serving.trace_export", "repro_torch.serving.router",
            "repro_torch.serving.disagg", "repro_torch.core.migration",
            "repro_torch.launch.serve", "repro_torch.serving.async_engine",
            "repro_torch.serving.server", "repro_torch.launch.server_main",
            "repro_torch.models.attention", "repro_torch.models.blocks",
            "repro_torch.models.lm", "repro_torch.models.params",
            "repro_torch.models.moe", "repro_torch.models.ssm",
            "repro_torch.models.api", "repro_torch.serving.executor",
            "repro_torch.data.pipeline", "repro_torch.optimizer.adamw",
            "repro_torch.training.step", "repro_torch.checkpoint.ckpt",
            "repro_torch.launch.train", "repro_torch.tree",
            "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
            "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
            "repro_torch.launch.inspect_hlo",
            "repro_torch.launch.audit_donation",
            "repro_torch.distributed.tp", "repro_torch.launch.hostenv"]
    covered = {str(p.relative_to(ROOT / "src")) for p in PORT_FILES
               if ROOT / "src" in p.parents}
    for m in mods:
        assert m.replace(".", "/") + ".py" in covered, m
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro'))\n"
              "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_runner_without_device_needs_cuda():
    import dataclasses
    import repro_torch.configs as tc
    from repro_torch.serving.paged_runner import PagedModelRunner
    cfg = dataclasses.replace(tc.get_config("llama3-8b").reduced(),
                              dtype="float32")
    sv = tc.ServingConfig(num_hbm_blocks=8, block_size=4)
    if torch.cuda.is_available():
        assert PagedModelRunner(cfg, sv).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PagedModelRunner(cfg, sv)
        with pytest.raises(RuntimeError, match="CUDA"):
            PagedModelRunner(cfg, sv, device="cuda")
        # tensor-parallel: no shard falls back to the CPU either
        sv2 = dataclasses.replace(sv, tp=2)
        for dev in (None, "cuda", ["cuda:0", "cuda:0"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                PagedModelRunner(cfg, sv2, device=dev)


def test_server_and_dense_executor_without_device_need_cuda():
    """The HTTP server's engine and the dense executor run on CUDA unless
    the caller names the CPU; with no card they raise, never fall back."""
    import dataclasses
    import repro_torch.configs as tc
    from repro_torch.serving.executor import RealExecutor
    from repro_torch.serving.server import ServerConfig
    cfg = dataclasses.replace(tc.get_config("llama3-8b").reduced(),
                              dtype="float32")
    if torch.cuda.is_available():
        assert RealExecutor(cfg).device.type == "cuda"
        return
    for kw in ({}, {"paged_runner": True}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            ServerConfig(**kw).build_engine()
    with pytest.raises(RuntimeError, match="CUDA"):
        RealExecutor(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        RealExecutor(cfg, device="cuda")
    assert RealExecutor(cfg, device="cpu").device.type == "cpu"
    assert ServerConfig(device="cpu").build_engine() is not None
