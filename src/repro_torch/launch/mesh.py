"""Production mesh descriptions (the port of ``src/repro/launch/mesh.py``).

A mesh here is a ``distributed.sharding.Mesh``: axis names and sizes, no
devices. The dry-run lays every cell over these meshes to count per-device
bytes; nothing is placed on them.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 devices (data, model).
    Multi-pod: 2 pods x 256 = 512 devices (pod, data, model)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh(shape, axes) -> Mesh:
    """Arbitrary mesh (elastic scaling / tests)."""
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def make_tp_mesh(tp: int):
    """The paged runner's tensor-parallel mesh: not ported yet."""
    raise NotImplementedError(
        f"tp={tp}: a tensor-parallel mesh over CUDA devices is not ported "
        f"yet (ROADMAP.md §1 item 3)")
