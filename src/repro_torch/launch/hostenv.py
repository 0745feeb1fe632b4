"""Host-environment check shared by the serve entry points.

The port of ``src/repro/launch/hostenv.py``. The reference forces XLA to
show ``n`` logical devices on a CPU host before jax loads; here a CPU
shard is logical already (every shard of a CPU mesh is the CPU), so the
CPU needs nothing forced. On CUDA a tensor-parallel replica needs ``n``
cards, unless the caller lists the ``n`` devices itself (a list may
repeat a card: shards stacked on one device).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

Device = Union[str, torch.device]


def ensure_host_devices(n: int, device: Optional[Union[
        Device, Sequence[Device]]] = None, what: str = "") -> None:
    """Make sure ``n`` shards (of ``what``: ``tp=n`` by default) can be
    placed on ``device``.

    No-op for ``n <= 1``, for the CPU, and for an explicit list of ``n``
    devices (``make_tp_mesh`` takes it as given). Otherwise ``device`` is
    CUDA (``None`` means CUDA, as everywhere in the port), which must show
    at least ``n`` cards; fewer raise ``RuntimeError`` with the recipe.
    """
    n = int(n)
    what = what or f"tp={n}"
    if n <= 1:
        return
    if isinstance(device, (list, tuple)):
        if len(device) != n:
            raise ValueError(f"{what} needs a list of {n} devices, got "
                             f"{len(device)}: {list(device)}")
        return
    if device is not None and torch.device(device).type == "cpu":
        return
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(
            f"need {n} devices for {what} but torch sees {have} CUDA "
            f"devices. Pass device='cpu' (--device cpu) to run the {n} "
            f"shards on the CPU, or an explicit list of {n} devices, e.g. "
            f"{['cuda:0'] * n} (--device {','.join(['cuda:0'] * n)}) to "
            f"stack the shards on one card.")
