"""Logical-axis sharding rules (MaxText-style) and a mesh/rules context.

The port of ``src/repro/distributed/sharding.py``. Tensors carry *logical*
axis names (``models/params.py``, ``LM.cache_specs``, the optimizer's
``state_logical_axes``); the active :class:`ShardingRules` maps each name
to mesh axes, and :func:`pspec_for` turns one tensor's names into a
partition spec: one entry per dim (a mesh axis name, a tuple of them, or
None), trailing Nones dropped, as ``jax.sharding.PartitionSpec`` holds it.
A mesh is a :class:`Mesh`, its axis names and sizes, and optionally
the torch device of each position in row-major order
(``launch.mesh.make_mesh``): the dry-run reads per-device bytes from a
mesh without devices on ``torch.device("meta")``; training places
tensors on a mesh with devices (``distributed/spmd.py``).

:func:`shard` is the reference's ``with_sharding_constraint``, which
never changes a value: it returns the tensor. Placing a tensor's pieces
is ``spmd.place``'s job, and the model's mesh path computes on the pieces
(``models/lm.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]
PSpec = Tuple[MeshAxes, ...]

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh by its axis names and sizes, in order; ``devices``
    (one per position, row-major, repeats allowed) when it places real
    tensors, None for a description such as the dry-run's."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Optional[Tuple[object, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axis names repeat: {self.axis_names}")
        if any(s < 1 for s in self.axis_sizes):
            raise ValueError(f"mesh axis sizes must be >= 1: "
                             f"{self.axis_sizes}")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"a mesh of {self.size} positions needs as "
                             f"many devices, got {len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coords(self, r: int) -> Dict[str, int]:
        """Position ``r``'s index along each axis (row-major; shared: not
        to be changed)."""
        return _coords(self.axis_names, self.axis_sizes, r)

    def axis_index(self, r: int, axis: str) -> int:
        """Position ``r``'s index along ``axis`` (0 if not an axis)."""
        return self.coords(r).get(axis, 0)


@functools.lru_cache(maxsize=None)
def _coords(names: Tuple[str, ...], sizes: Tuple[int, ...], r: int
            ) -> Dict[str, int]:
    out = {}
    for name, n in zip(reversed(names), reversed(sizes)):
        r, out[name] = divmod(r, n)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor's dims lie on a mesh: the counterpart of
    ``jax.sharding.NamedSharding``, a description that places nothing."""
    mesh: Mesh
    spec: PSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis -> mesh axis (None = replicated)."""
    batch: MeshAxes = ("pod", "data")       # missing axes are dropped per-mesh
    seq: MeshAxes = None                    # activation sequence dim
    embed: MeshAxes = None                  # activation d_model dim
    heads: MeshAxes = "model"               # attention heads (q)
    kv_heads: MeshAxes = "model"            # attention kv heads
    head_dim: MeshAxes = None
    mlp: MeshAxes = "model"                 # d_ff
    vocab: MeshAxes = "model"
    experts: MeshAxes = "model"
    kv_seq: MeshAxes = None                 # KV-cache sequence dim (SP decode)
    fsdp: MeshAxes = "data"                 # weight d_model dim (ZeRO-3)
    ssm_heads: MeshAxes = "model"
    ssm_state: MeshAxes = None
    expert_capacity: MeshAxes = None
    frames: MeshAxes = None                 # frontend embeds seq

    def axes_for(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return getattr(self, logical)


# Default rule-sets per shape kind ------------------------------------------

TRAIN_RULES = ShardingRules()
PREFILL_RULES = ShardingRules(kv_seq="model", fsdp="data")
# Decode: 2D weight-stationary (Pope et al.): batch replicated over data,
# and the residual stream's d_model dim sharded over "data" so it is
# co-sharded with the weights' contracting dim (partial sums and small
# activation all-reduces instead of re-gathering the d-sharded weights
# every step). The KV cache spreads its sequence dim over the whole
# (data x model) grid.
DECODE_RULES = ShardingRules(batch=None, embed="data",
                             kv_seq=("data", "model"), fsdp="data")


def rules_for_shape(kind: str, global_batch: int = 0) -> ShardingRules:
    if kind == "train":
        return TRAIN_RULES
    if kind == "prefill":
        return PREFILL_RULES
    if kind == "decode":
        return DECODE_RULES
    raise ValueError(kind)


# Context --------------------------------------------------------------------

class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Optional[ShardingRules] = None


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_ctx(mesh: Optional[Mesh], rules: Optional[ShardingRules]):
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def current_rules() -> Optional[ShardingRules]:
    return _CTX.rules


def mesh_axis_size(mesh: Mesh, axes: MeshAxes) -> int:
    """Devices along ``axes`` (1 for None; axes not in the mesh count 1)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh.shape
    return math.prod(shape[a] for a in axes if a in shape)


def _filter_axes(mesh: Mesh, axes: MeshAxes) -> MeshAxes:
    """Drop axes not present in the mesh (e.g. 'pod' on single-pod)."""
    if axes is None:
        return None
    shape = mesh.shape
    if isinstance(axes, str):
        return axes if axes in shape else None
    kept = tuple(a for a in axes if a in shape)
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else kept


def pspec_for(logical_axes: Sequence[Optional[str]], mesh: Mesh,
              rules: ShardingRules,
              shape: Optional[Sequence[int]] = None) -> PSpec:
    """A partition spec; drops shardings that don't divide the dim, and a
    mesh axis an earlier dim already took (a mesh axis appears once)."""
    parts = []
    used: set = set()
    for i, name in enumerate(logical_axes):
        axes = _filter_axes(mesh, rules.axes_for(name))
        if axes is not None:
            ax_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
            ax_tuple = tuple(a for a in ax_tuple if a not in used)
            axes = ax_tuple if len(ax_tuple) > 1 else (
                ax_tuple[0] if ax_tuple else None)
        if axes is not None and shape is not None:
            if shape[i] % mesh_axis_size(mesh, axes) != 0:
                axes = None
        if axes is not None:
            for a in ((axes,) if isinstance(axes, str) else axes):
                used.add(a)
        parts.append(axes)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def shards_of(spec: PSpec, mesh: Mesh) -> int:
    """How many pieces a tensor with partition spec ``spec`` is cut into."""
    return math.prod(mesh_axis_size(mesh, part) for part in spec)


def shard(x, logical_axes: Sequence[Optional[str]]):
    """The sharding annotation: ``x`` itself. The reference's constraint
    never changes a value; where a tensor's pieces lie is
    ``spmd.place``'s."""
    return x


def named_sharding(logical_axes: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None,
                   mesh: Optional[Mesh] = None,
                   rules: Optional[ShardingRules] = None
                   ) -> Optional[NamedSharding]:
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None or rules is None:
        return None
    return NamedSharding(mesh, pspec_for(logical_axes, mesh, rules, shape))


def batch_axes(mesh: Optional[Mesh] = None,
               rules: Optional[ShardingRules] = None) -> MeshAxes:
    """Mesh axes carrying the batch dim."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None:
        return None
    return _filter_axes(mesh, (rules or ShardingRules()).batch)


def single_device_mesh() -> Mesh:
    return Mesh(("data", "model"), (1, 1))


def is_axes_leaf(x) -> bool:
    """A leaf of a logical-axes tree: ``(logical axes or None, shape)``."""
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[1], tuple)
            and all(isinstance(i, int) for i in x[1])
            and (x[0] is None or isinstance(x[0], tuple)))


def tree_shardings(specs_tree, mesh: Mesh, rules: ShardingRules):
    """A tree of ``(logical axes, shape)`` leaves as ``NamedSharding``s."""
    from repro_torch.tree import tree_map
    return tree_map(
        lambda leaf: NamedSharding(
            mesh, pspec_for(leaf[0] or (), mesh, rules, leaf[1])),
        specs_tree, is_leaf=is_axes_leaf)
