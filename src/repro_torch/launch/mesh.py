"""Production mesh descriptions (the port of ``src/repro/launch/mesh.py``).

A production mesh here is a ``distributed.sharding.Mesh``: axis names and
sizes, no devices. The dry-run lays every cell over these meshes to count
per-device bytes; nothing is placed on them. The tensor-parallel mesh
(``make_tp_mesh``) is a ``distributed.tp.TPMesh``: the serving replica's
shards and the torch device each lives on.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh
from repro_torch.distributed.tp import TPMesh
from repro_torch.launch.hostenv import ensure_host_devices


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 devices (data, model).
    Multi-pod: 2 pods x 256 = 512 devices (pod, data, model)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh(shape, axes) -> Mesh:
    """Arbitrary mesh (elastic scaling / tests)."""
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def make_tp_mesh(tp: int, device=None) -> TPMesh:
    """1-D ``("model",)`` mesh of ``tp`` torch devices: one logical serving
    replica spanning ``tp`` shards (the paged runner's tensor-parallel
    layout). ``device`` is one device or a list of ``tp``:

    * a list is taken exactly as given, repeats allowed — the only way to
      stack shards on one card (``["cuda:0", "cuda:0"]``);
    * ``"cpu"``: ``tp`` logical shards on the CPU;
    * ``None`` or a CUDA device: ``cuda:0 .. cuda:tp-1``, which needs
      ``tp`` cards (``launch.hostenv.ensure_host_devices`` raises with the
      recipe otherwise), so no run quietly puts every shard on one card.
    """
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    ensure_host_devices(tp, device)
    if isinstance(device, (list, tuple)):
        devs = [resolve_device(d) for d in device]
    elif device is not None and torch.device(device).type == "cpu":
        devs = [torch.device("cpu")] * tp
    elif tp == 1:
        devs = [resolve_device(device)]
    else:
        devs = [resolve_device(f"cuda:{i}") for i in range(tp)]
    return TPMesh(tuple(devs))
