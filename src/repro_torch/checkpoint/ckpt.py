"""Checkpointing with async save and restore onto one device.

The port of ``src/repro/checkpoint/ckpt.py``, in the reference's on-disk
format: one ``leaf_{i}.npy`` per leaf plus ``manifest.json`` (``step``,
``time`` and ``leaves[{i, shape, dtype}]``); a bf16 leaf is stored as its
``uint16`` bit view with dtype ``"bfloat16"``. The leaves are the port's
tree's in ``repro_torch.tree``'s order (the one the optimizer and the train
step use), named tuples (``TrainState``, ``AdamWState`` and the int8
moments' ``Quantized``) included. Saves are atomic (``.tmp-{step}``, then a
rename) and optionally asynchronous: the values are copied to the host
before the writer thread starts, and one writer runs at a time. The last
``keep`` checkpoints are retained. A state laid over a mesh
(``spmd.Placed`` leaves) is saved whole, so its files are those of an
unsharded run; ``restore`` lays it onto one device or onto any mesh (the
reference's elastic-reshard hook).
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import TRAIN_RULES, is_axes_leaf
from repro_torch.tree import flatten


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A host copy of ``x`` (whole, if placed over a mesh: its pieces
    gathered straight into host memory) as numpy; bf16 as its bit pattern
    in uint16."""
    x = (spmd.gather(x, "cpu").detach() if spmd.is_placed(x)
         else x.detach().to("cpu", copy=True))
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: Any, *, async_: bool = False) -> None:
        leaves, _ = flatten(state)
        # copied to the host BEFORE the thread starts: the values at step t
        host = [(_to_host(x), str(x.dtype).removeprefix("torch."))
                for x in leaves]
        self.wait()   # never two writers at once
        if async_:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _write(self, step: int, host_leaves) -> None:
        tmp = self.dir / f".tmp-{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "leaves": []}
        for i, (arr, dt) in enumerate(host_leaves):
            np.save(tmp / f"leaf_{i}.npy", arr)
            manifest["leaves"].append(
                {"i": i, "shape": list(arr.shape), "dtype": dt})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self.dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def all_steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, step: int, template: Any, device=None, mesh=None,
                rules=None) -> Any:
        """``template``: a tree of the saved structure (values unused); the
        leaves come back as tensors on ``device`` (CUDA unless the caller
        names the CPU, as every entry point of the port), or, with
        ``mesh``, laid over it under ``rules`` (``TRAIN_RULES`` by default)
        by each leaf's logical axes: the template's leaves are then
        ``spmd.Placed`` (of any mesh) or ``(logical axes, shape)`` leaves
        (``training.step.train_state_logical_axes``)."""
        if mesh is None:
            device = resolve_device(device)
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves, rebuild = flatten(template, is_leaf=is_axes_leaf)
        if len(leaves) != len(manifest["leaves"]):
            raise ValueError(f"checkpoint has {len(manifest['leaves'])} "
                             f"leaves, template {len(leaves)}")
        out = []
        for i, meta in enumerate(manifest["leaves"]):
            arr = np.load(d / f"leaf_{i}.npy")
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if mesh is None:
                out.append(t.to(device))
                continue
            leaf = leaves[i]
            if spmd.is_placed(leaf):
                axes = leaf.axes
            elif is_axes_leaf(leaf):
                axes = leaf[0]
            else:
                raise ValueError(f"leaf {i}: restoring onto a mesh needs "
                                 f"its logical axes (a Placed or an axes "
                                 f"leaf in the template)")
            out.append(spmd.place(t, axes, mesh, rules or TRAIN_RULES))
        return rebuild(out)
