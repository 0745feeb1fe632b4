"""What GSPMD and ``shard_map`` did implicitly, for one controller over a
mesh of torch devices.

A mesh (``distributed.sharding.Mesh`` with ``devices``, from
``launch.mesh.make_mesh``) is a grid of positions in row-major order, each
on a torch device; devices may repeat, which is how shards stack on one
card. A tensor laid over the mesh is a :class:`Placed`: one piece per
position, cut by its partition spec (``sharding.pspec_for``), a dim over
several mesh axes indexed major to minor as the spec lists them, as
``jax.sharding.NamedSharding`` lays it. Positions that hold the same piece
hold copies of it, each its own tensor.

An activation over the mesh is a plain list with one tensor per position.
The collectives take such a list and one mesh axis, or a tuple of axes
(``("data", "model")`` is the whole grid), and work on each group of
positions along those axes, in a fixed order on the group's first
device: :func:`all_reduce` (the sum, then the sum on every member),
:func:`all_reduce_max` (no gradient), and :func:`all_gather` along a dim.
The first and the last are differentiable: the gradient of an all-reduce
is an all-reduce of the members' gradients, and the gradient of an
all-gather is a reduce-scatter of them, both through ``Tensor.to``. Every
collective adds, for each member, the bytes of its result to the counter
of its kind (the reference's result-shape convention: an all-reduce
counts the whole tensor, an all-gather the gathered one, a reduce-scatter
a member's piece); :func:`collective_bytes` reads them per position.
:func:`relayout_tree` moves placed tensors to another layout (the
reference's ``device_put`` between two cells), each position copying
what it lacks from a holder; :func:`moved_bytes` counts what it copied.
"""
from __future__ import annotations

import collections
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.distributed.sharding import (Mesh, MeshAxes, PSpec,
                                              ShardingRules, is_axes_leaf,
                                              pspec_for)
from repro_torch.tree import flatten, tree_leaves, tree_map

KINDS = ("all-reduce", "all-gather", "reduce-scatter")
_BYTES: Dict[str, Dict[int, int]] = collections.defaultdict(
    lambda: collections.defaultdict(int))
_MOVED: Dict[int, int] = collections.defaultdict(int)
Axes = Union[str, Tuple[str, ...]]


def reset_collective_bytes() -> None:
    _BYTES.clear()
    _MOVED.clear()


def moved_bytes(position: Optional[int] = None) -> int:
    """Bytes :func:`relayout` copied into ``position`` from other
    positions since the last reset, or the most any position took."""
    if position is not None:
        return _MOVED.get(position, 0)
    return max(_MOVED.values(), default=0)


def collective_bytes(position: Optional[int] = None) -> Dict[str, int]:
    """Bytes counted since the last reset, by kind: at ``position``, or
    the most any position counted."""
    out = {}
    for kind in KINDS:
        per = _BYTES.get(kind, {})
        out[kind] = (per.get(position, 0) if position is not None
                     else max(per.values(), default=0))
    return out


def _count(kind: str, members: Sequence[int], nbytes: int) -> None:
    per = _BYTES[kind]
    for r in members:
        per[r] += nbytes


# --------------------------------------------------------------------------
# Pieces
# --------------------------------------------------------------------------

def _axes_of(part: MeshAxes) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def piece_index(spec: PSpec, mesh: Mesh, r: int) -> Tuple[int, ...]:
    """Which piece position ``r`` holds: its index along each dim."""
    coords = mesh.coords(r)
    shape = mesh.shape
    out = []
    for part in spec:
        i = 0
        for a in _axes_of(part):
            i = i * shape[a] + coords[a]
        out.append(i)
    return tuple(out)


def pieces_per_dim(spec: PSpec, mesh: Mesh) -> Tuple[int, ...]:
    shape = mesh.shape
    return tuple(math.prod(shape[a] for a in _axes_of(p)) for p in spec)


def piece_ranges(spec: PSpec, shape, mesh: Mesh, r: int
                 ) -> Tuple[Tuple[int, int], ...]:
    """(first index, size) along every dim of ``shape`` of the piece that
    position ``r`` holds."""
    idx = piece_index(spec, mesh, r)
    cuts = pieces_per_dim(spec, mesh)
    out = []
    for d, size in enumerate(shape):
        n = cuts[d] if d < len(cuts) else 1
        step = size // n
        out.append(((idx[d] if d < len(idx) else 0) * step, step))
    return tuple(out)


def _narrow(x: torch.Tensor, spec: PSpec, mesh: Mesh, r: int
            ) -> torch.Tensor:
    for d, (lo, n) in enumerate(piece_ranges(spec, x.shape, mesh, r)):
        if n != x.shape[d]:
            x = x.narrow(d, lo, n)
    return x


class Placed:
    """A tensor of global ``shape`` over ``mesh``: ``pieces[r]`` on
    ``mesh.devices[r]``, cut by ``spec``. ``axes`` are its logical axes,
    kept so a checkpoint can be laid over another mesh."""
    __slots__ = ("pieces", "spec", "shape", "mesh", "axes")

    def __init__(self, pieces, spec: PSpec, shape, mesh: Mesh, axes=None):
        self.pieces = list(pieces)
        self.spec = tuple(spec)
        self.shape = tuple(shape)
        self.mesh = mesh
        self.axes = axes

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    def like(self, pieces) -> "Placed":
        """Other pieces laid out as these."""
        return Placed(pieces, self.spec, self.shape, self.mesh, self.axes)

    def holders(self) -> List[List[int]]:
        """The positions holding each distinct piece, in order of their
        first position; each list in position order (shared: not to be
        changed)."""
        return _holders(self.spec, self.mesh)

    def nbytes(self, r: int) -> int:
        p = self.pieces[r]
        return p.numel() * p.element_size()

    def ranges(self, r: int) -> Tuple[Tuple[int, int], ...]:
        """(first index, size) of position ``r``'s piece along each dim."""
        return piece_ranges(self.spec, self.shape, self.mesh, r)

    def first_holder(self, r: int, within: Sequence[str] = ()) -> bool:
        """Whether ``r`` is the first position holding its piece; with
        ``within``, the first of those in its group along those axes
        (``groups``: a pod's positions over ("data", "model"))."""
        return r in _first_holders(self.spec, self.mesh, tuple(within))

    def __repr__(self):
        return (f"Placed(shape={self.shape}, spec={self.spec}, "
                f"dtype={self.dtype}, mesh={self.mesh.axis_sizes})")


@functools.lru_cache(maxsize=None)
def _holders(spec: PSpec, mesh: Mesh) -> List[List[int]]:
    seen: Dict[Tuple[int, ...], List[int]] = {}
    for r in range(mesh.size):
        seen.setdefault(piece_index(spec, mesh, r), []).append(r)
    return list(seen.values())


@functools.lru_cache(maxsize=None)
def _first_holders(spec: PSpec, mesh: Mesh, within: Tuple[str, ...]
                   ) -> frozenset:
    """The positions first among the holders of their piece, within their
    group along ``within`` (all positions: one group)."""
    group_of = {r: i for i, g in enumerate(groups(mesh, *within))
                for r in g} if within else {}
    out = set()
    for members in _holders(spec, mesh):
        seen = set()
        for r in members:
            g = group_of.get(r, 0)
            if g not in seen:
                seen.add(g)
                out.add(r)
    return frozenset(out)


def is_placed(x) -> bool:
    return isinstance(x, Placed)


def _copy_to(x: torch.Tensor, device) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    return out.copy_(x)


def place(x: torch.Tensor, logical_axes, mesh: Mesh,
          rules: ShardingRules) -> Placed:
    """The whole tensor ``x`` as its pieces on ``mesh`` under ``rules``. A
    dim its mesh axes do not divide stays whole (``pspec_for``)."""
    axes = tuple(logical_axes or ())
    return place_spec(x, pspec_for(axes, mesh, rules, tuple(x.shape)),
                      mesh, axes)


def zeros(shape, dtype: torch.dtype, logical_axes, mesh: Mesh,
          rules: ShardingRules) -> Placed:
    """A tensor of zeros laid out as ``place`` would lay it, each piece
    allocated on its own position (nothing whole)."""
    axes = tuple(logical_axes or ())
    spec = pspec_for(axes, mesh, rules, tuple(shape))
    pieces = [torch.zeros([n for _, n in piece_ranges(spec, shape, mesh, r)],
                          dtype=dtype, device=mesh.devices[r])
              for r in range(mesh.size)]
    return Placed(pieces, spec, shape, mesh, axes)


def place_spec(x: torch.Tensor, spec: PSpec, mesh: Mesh,
               axes=None) -> Placed:
    """The whole tensor ``x`` as its pieces on ``mesh``, cut by the
    partition spec ``spec``: each position gets its own contiguous copy of
    its piece. A dim that its pieces do not divide raises."""
    if mesh.devices is None:
        raise ValueError("placing tensors needs a mesh with devices "
                         "(launch.mesh.make_mesh)")
    for d, n in enumerate(pieces_per_dim(spec, mesh)):
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} is not "
                             f"divisible by its {n} pieces")
    pieces = [_copy_to(_narrow(x, spec, mesh, r), mesh.devices[r])
              for r in range(mesh.size)]
    return Placed(pieces, spec, x.shape, mesh, axes)


def gather(x: Placed, device=None) -> torch.Tensor:
    """The whole tensor from its pieces, on ``device`` (the mesh's first
    device by default); not differentiable."""
    mesh = x.mesh
    device = device if device is not None else mesh.devices[0]
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    for members in x.holders():
        r = members[0]
        _narrow(out, x.spec, mesh, r).copy_(x.pieces[r])
    return out


def place_tree(tree, axes_tree, mesh: Mesh, rules: ShardingRules):
    """``place`` over a tree of tensors whose logical axes are the
    ``(axes, shape)`` leaves of ``axes_tree``."""
    leaves, rebuild = flatten(tree)
    axes = tree_leaves(axes_tree, is_leaf=is_axes_leaf)
    if len(leaves) != len(axes):
        raise ValueError(f"{len(leaves)} tensors but {len(axes)} axes leaves")
    out = []
    for x, (ax, shape) in zip(leaves, axes):
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"tensor shape {tuple(x.shape)} != axes shape "
                             f"{shape}")
        out.append(place(x, ax, mesh, rules))
    return rebuild(out)


def relayout(x: Placed, spec: PSpec) -> Placed:
    """``x`` cut by ``spec`` instead: each position builds its new piece
    from the old pieces that overlap it, its own where it holds one, else
    the first holder's, and counts the bytes it copied from another
    position (:func:`moved_bytes`). Nothing is gathered whole."""
    mesh = x.mesh
    for d, n in enumerate(pieces_per_dim(spec, mesh)):
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} is not "
                             f"divisible by its {n} pieces")
    old = x.holders()
    out = []
    for r in range(mesh.size):
        want = piece_ranges(spec, x.shape, mesh, r)
        piece = torch.empty([n for _, n in want], dtype=x.dtype,
                            device=mesh.devices[r])
        for members in old:
            src = r if r in members else members[0]
            have = x.ranges(src)
            box = [(max(a, b), min(a + m, b + n))
                   for (a, m), (b, n) in zip(have, want)]
            if any(lo >= hi for lo, hi in box):
                continue
            part, dst = x.pieces[src], piece
            for d, ((lo, hi), (a, _), (b, _)) in enumerate(
                    zip(box, have, want)):
                part = part.narrow(d, lo - a, hi - lo)
                dst = dst.narrow(d, lo - b, hi - lo)
            dst.copy_(part)
            if src != r:
                _MOVED[r] += _nbytes(part)
        out.append(piece)
    return Placed(out, spec, x.shape, mesh, x.axes)


def relayout_tree(tree, rules: ShardingRules):
    """:func:`relayout` over a tree's ``Placed`` leaves to the specs
    ``pspec_for`` gives their logical axes under ``rules``: the
    counterpart of :func:`place_tree` for tensors already placed."""
    return tree_map(
        lambda x: relayout(x, pspec_for(x.axes or (), x.mesh, rules,
                                        x.shape)) if is_placed(x) else x,
        tree)


def gather_tree(tree, device=None):
    """Every ``Placed`` leaf of ``tree`` as its whole tensor."""
    return tree_map(lambda x: gather(x, device) if is_placed(x) else x,
                    tree)


def bytes_per_position(tree) -> List[int]:
    """Bytes of the pieces each position holds, over a tree's ``Placed``
    leaves."""
    leaves = [x for x in tree_leaves(tree) if is_placed(x)]
    if not leaves:
        return []
    return [sum(x.nbytes(r) for x in leaves)
            for r in range(leaves[0].mesh.size)]


# --------------------------------------------------------------------------
# Collectives over mesh axes
# --------------------------------------------------------------------------

def _axes_tuple(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def groups(mesh: Mesh, *axes: str) -> List[List[int]]:
    """The positions that vary along ``axes`` together, for each setting
    of the other axes: each list in the order of its index over ``axes``
    composed major to minor as listed (``piece_index``'s order for a dim
    split over them); ``groups(mesh, "data", "model")`` is the whole grid
    of a (data, model) mesh. An axis the mesh lacks counts one position
    (none at all: one position a group). The lists are shared: not to be
    changed."""
    return _groups(mesh, tuple(a for a in axes if a in mesh.shape))


@functools.lru_cache(maxsize=None)
def _groups(mesh: Mesh, axes: Tuple[str, ...]) -> List[List[int]]:
    if not axes:
        return [[r] for r in range(mesh.size)]
    shape = mesh.shape
    out: Dict[tuple, List[Tuple[int, int]]] = {}
    for r in range(mesh.size):
        c = mesh.coords(r)
        key = tuple(v for k, v in c.items() if k not in axes)
        i = 0
        for a in axes:
            i = i * shape[a] + c[a]
        out.setdefault(key, []).append((i, r))
    return [[r for _, r in sorted(m)] for m in out.values()]


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class _ReduceToRoot(torch.autograd.Function):
    """The members' sum in member order on the first one's device; its
    gradient goes to every member (the backward half of an all-reduce)."""

    @staticmethod
    def forward(ctx, members, *parts):
        ctx.devices = [p.device for p in parts]
        ctx.members = members
        root = parts[0].device
        acc = parts[0] + parts[1].to(root)
        for p in parts[2:]:
            acc = acc + p.to(root)
        return acc

    @staticmethod
    def backward(ctx, g):
        _count("all-reduce", ctx.members, _nbytes(g))
        return (None, *[g.to(d) for d in ctx.devices])


class _GatherToRoot(torch.autograd.Function):
    """The members' pieces joined along ``dim`` in member order on the
    first one's device; the gradient's pieces go back to their members
    (the scatter half of a reduce-scatter)."""

    @staticmethod
    def forward(ctx, dim, members, *parts):
        ctx.devices = [p.device for p in parts]
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.dim, ctx.members = dim, members
        root = parts[0].device
        return torch.cat([p.to(root) for p in parts], dim=dim)

    @staticmethod
    def backward(ctx, g):
        chunks = torch.split(g, ctx.sizes, dim=ctx.dim)
        _count("reduce-scatter", ctx.members, _nbytes(chunks[0]))
        return (None, None, *[c.to(d) for c, d in zip(chunks, ctx.devices)])


def all_reduce(xs: Sequence[torch.Tensor], mesh: Mesh,
               axis: Axes) -> List[torch.Tensor]:
    """Each position's tensor replaced by the sum over its group along
    ``axis`` (one axis or a tuple), added in group order on the group's
    first device."""
    out = list(xs)
    for members in groups(mesh, *_axes_tuple(axis)):
        if len(members) == 1:
            continue
        acc = _ReduceToRoot.apply(members, *[xs[r] for r in members])
        _count("all-reduce", members, _nbytes(acc))
        for r in members:
            out[r] = acc.to(mesh.devices[r])
    return out


def all_reduce_max(xs: Sequence[torch.Tensor], mesh: Mesh,
                   axis: Axes) -> List[torch.Tensor]:
    """The elementwise max over each group along ``axis`` (one axis or a
    tuple); detached."""
    out = [x.detach() for x in xs]
    for members in groups(mesh, *_axes_tuple(axis)):
        if len(members) == 1:
            continue
        root = out[members[0]].device
        acc = out[members[0]]
        for r in members[1:]:
            acc = torch.maximum(acc, out[r].to(root))
        _count("all-reduce", members, _nbytes(acc))
        for r in members:
            out[r] = acc.to(mesh.devices[r])
    return out


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh, axis: Axes,
               dim: int) -> List[torch.Tensor]:
    """Each position's tensor replaced by its group's pieces along
    ``axis`` (one axis or a tuple) joined on ``dim`` in group order."""
    out = list(xs)
    for members in groups(mesh, *_axes_tuple(axis)):
        if len(members) == 1:
            continue
        full = _GatherToRoot.apply(dim, members, *[xs[r] for r in members])
        _count("all-gather", members, _nbytes(full))
        for r in members:
            out[r] = full.to(mesh.devices[r])
    return out


def gathered_over(x: Placed, *axes: str) -> List[torch.Tensor]:
    """Each position's piece with the dims that any of ``axes`` shards
    gathered (an FSDP weight just before its use), dim by dim; a dim split
    over several mesh axes gathers over those of ``axes`` together, in the
    order ``piece_index`` composes them, which must be all of them or the
    minor ones (whose pieces lie side by side); differentiable."""
    xs = list(x.pieces)
    for d, part in enumerate(x.spec):
        names = _axes_of(part)
        hit = tuple(a for a in names if a in axes)
        if not hit:
            continue
        if hit != names[len(names) - len(hit):]:
            raise NotImplementedError(
                f"a dim sharded over {names}: gathering {hit} alone would "
                f"join pieces that do not lie side by side")
        xs = all_gather(xs, mesh=x.mesh, axis=hit, dim=d)
    return xs


def sum_copies(x: Placed) -> Placed:
    """Each distinct piece replaced on all its holders by the sum of their
    pieces (partial gradients of a replicated leaf), added in position
    order on the first holder's device: held once, counted once."""
    out = list(x.pieces)
    mesh = x.mesh
    for members in x.holders():
        if len(members) == 1:
            continue
        root = mesh.devices[members[0]]
        acc = x.pieces[members[0]]
        for r in members[1:]:
            acc = acc + x.pieces[r].to(root)
        _count("all-reduce", members, _nbytes(acc))
        for r in members:
            out[r] = acc.to(mesh.devices[r])
    return x.like(out)
