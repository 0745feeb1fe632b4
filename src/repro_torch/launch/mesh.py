"""Production mesh descriptions (the port of ``src/repro/launch/mesh.py``).

A production mesh here is a ``distributed.sharding.Mesh``: axis names and
sizes, no devices. The dry-run lays every cell over these meshes to count
per-device bytes; nothing is placed on them. ``make_mesh`` gives a mesh
of torch devices, on which training places its tensors
(``distributed/spmd.py``); the tensor-parallel mesh (``make_tp_mesh``) is
its 1-D ``("model",)`` case, the serving replica's shards.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch.hostenv import ensure_host_devices


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 devices (data, model).
    Multi-pod: 2 pods x 256 = 512 devices (pod, data, model)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of torch devices, one a position in row-major order (elastic
    scaling, training on a mesh, serving TP, tests). ``device``:

    * a list of ``prod(shape)`` devices is taken as given, repeats allowed
      — the only way to stack shards on one card (``["cuda:0"] * 4``);
    * ``"cpu"``: every position on the CPU;
    * ``None`` or a CUDA device: ``cuda:0 .. cuda:n-1``, which needs ``n``
      cards (``launch.hostenv.ensure_host_devices`` raises with the recipe
      otherwise).

    A mesh without devices (what the dry-run reads) is
    ``distributed.sharding.Mesh(axes, shape)``."""
    desc = Mesh(tuple(axes), tuple(int(s) for s in shape))
    n = desc.size
    ensure_host_devices(n, device, what=f"a {desc.axis_sizes} mesh")
    if isinstance(device, (list, tuple)):
        devs = [resolve_device(d) for d in device]
    elif device is not None and torch.device(device).type == "cpu":
        devs = [torch.device("cpu")] * n
    elif n == 1:
        devs = [resolve_device(device)]
    else:
        devs = [resolve_device(f"cuda:{i}") for i in range(n)]
    return Mesh(desc.axis_names, desc.axis_sizes, tuple(devs))


def make_tp_mesh(tp: int, device=None) -> Mesh:
    """``make_mesh((tp,), ("model",), device)``: one logical serving
    replica spanning ``tp`` shards (the paged runner's tensor-parallel
    layout). A CUDA device with fewer than ``tp`` cards raises with the
    recipe (``launch.hostenv.ensure_host_devices``), so no run quietly
    puts every shard on one card."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    ensure_host_devices(tp, device)
    return make_mesh((tp,), ("model",), device)
