"""Manual SPMD over a ``DeviceMesh``: the port's counterpart of the
reference's ``NamedSharding``, ``_filter_spec`` / ``_sharding_tree`` and
the collectives inside its ``shard_map`` bodies.

Each rank holds its local block of every sharded array and the code
calls the collectives itself; ``DeviceMesh`` supplies the mesh and its
process groups only.  A dimension sharded over several axes is split in
the mesh's row-major order over them (``("pod", "data")`` is pod-major,
as in JAX), and a group over several axes ranks its members in that same
order, so gathered blocks come back in place.

* :func:`filter_spec`, :func:`local_shape`: pure arithmetic, no process
  group (``local_shape`` takes a ``{axis: size}`` dict or a mesh).
* :func:`shard` / :func:`unshard` (and the ``_tree`` forms): a global
  tensor to this rank's block and back.
* Collectives that gradients flow through, each a
  ``torch.autograd.Function``: :func:`all_gather_dim` /
  :func:`all_gather_rows` (reduce-scatter backward: FSDP's gather of a
  weight), :func:`reduce_scatter_rows` (all-gather backward),
  :func:`copy_to` (identity forward, sum backward: Megatron's *f*, where
  a replicated activation enters a column-parallel product), :func:`psum`
  (sum forward, identity backward: Megatron's *g*; the consumer is
  replicated over the axes and its params' grads are not reduced over
  them) and :func:`psum_partials` (sum forward, sum backward: each rank's
  replicated consumer counts ``1 / n`` of the loss and every grad is
  summed over the axes afterwards).
* :func:`pmax` (no grad) and :func:`all_reduce_grads` (sums grads in
  place over axes, no autograd).
* :func:`tally`: a context that counts every collective the functions
  here issue, by kind, with the byte semantics of the reference's
  ``roofline.collective_bytes`` (the dry run reads it).
* :class:`Rows`: rows split in blocks over some axes, the hook the
  models take where the reference applies its sharding constraints.

A collective over axes that span one block (absent from the mesh, or of
one rank, as a 1-rank mesh's) is the identity and calls no backend, as
GSPMD places none there: a (1, 2) mesh gathers nothing over its ``data``
axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from .rules import P

# torch 2.13 renames the two tensor collectives; the old names stay
all_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
reduce_scatter_into = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, dict):
        return tuple(mesh)
    return tuple(mesh.mesh_dim_names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` (or of such a dict)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def present(axes: Sequence[str], mesh) -> Tuple[str, ...]:
    """The axes of ``axes`` that ``mesh`` has, in their order."""
    if mesh is None:
        return ()
    names = axis_names(mesh)
    return tuple(a for a in axes if a in names)


def filter_spec(spec: P, mesh) -> P:
    """Drop mesh axes that don't exist on this mesh (pod on single-pod);
    ``P()`` without a mesh."""
    if mesh is None:
        return P()
    names = axis_names(mesh)
    parts = []
    for part in spec:
        if part is None:
            parts.append(None)
        elif isinstance(part, str):
            parts.append(part if part in names else None)
        else:
            kept = tuple(a for a in part if a in names)
            parts.append(kept if len(kept) > 1 else
                         (kept[0] if kept else None))
    return P(*parts)


def part_axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def map_specs(fn: Callable[[P], P], tree):
    """``fn`` over every :class:`P` leaf of a tree of dicts, lists and
    tuples (a ``None`` leaf stays ``None``)."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v) for v in tree)
    return tree


def spec_leaves(spec_tree):
    """The specs of a spec tree in ``tree_leaves`` order (dict keys
    sorted; a :class:`P` or ``None`` is a leaf)."""
    if isinstance(spec_tree, dict):
        return [x for k in sorted(spec_tree)
                for x in spec_leaves(spec_tree[k])]
    if isinstance(spec_tree, (list, tuple)) and not isinstance(spec_tree,
                                                               P):
        return [x for v in spec_tree for x in spec_leaves(v)]
    return [spec_tree]


def local_shape(global_shape: Sequence[int], spec: P, mesh_shape
                ) -> Tuple[int, ...]:
    """The block shape one rank holds of an array of ``global_shape``
    laid out by ``spec`` over a mesh of ``mesh_shape`` (``{axis: size}``
    or a mesh); raises ``ValueError`` when a sharded dimension does not
    divide."""
    sizes = mesh_sizes(mesh_shape)
    out = list(global_shape)
    for d, part in enumerate(spec):
        k = math.prod(sizes[a] for a in part_axes(part))
        if out[d] % k:
            raise ValueError(f"dimension {d} of {tuple(global_shape)} does "
                             f"not divide over {part!r} ({k} blocks)")
        out[d] //= k
    return tuple(out)


def block_index(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's block, the number of blocks) along ``axes``."""
    sizes = mesh_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes[a] + coord[a]
        n *= sizes[a]
    return idx, n


def axis_group(mesh, axes: Sequence[str]):
    """The process group of this rank's peers along ``axes`` (ranked in
    the mesh's row-major order over them), made once per mesh.  Every
    rank makes the groups together, so every rank must ask for the same
    axes in the same order."""
    axes = present(axes, mesh)
    names = axis_names(mesh)
    if list(axes) != sorted(axes, key=names.index):
        raise ValueError(f"axes {axes} must follow the mesh's order {names}")
    cache = mesh.__dict__.setdefault("_spmd_groups", {})
    if axes not in cache:
        if len(axes) == 1:
            cache[axes] = mesh.get_group(axes[0])
        else:
            dims = [names.index(a) for a in axes]
            rest = [d for d in range(len(names)) if d not in dims]
            ranks = mesh.mesh.permute(*rest, *dims).reshape(
                -1, math.prod(mesh.mesh.shape[d] for d in dims))
            cache[axes], _ = dist.new_subgroups_by_enumeration(
                ranks.tolist())
    return cache[axes]


def shard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` laid out by ``spec``
    (contiguous)."""
    for d, part in enumerate(spec):
        axes = part_axes(part)
        if not axes:
            continue
        i, n = block_index(mesh, axes)
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(x.shape)} does not "
                             f"divide over {part!r} ({n} blocks)")
        size = x.shape[d] // n
        x = x.narrow(d, i * size, size)
    return x.contiguous()


def _trivial(axes: Sequence[str], mesh) -> bool:
    """Whether ``axes`` span one block (absent from ``mesh``, or of one
    rank): a collective over them is the identity and calls no backend."""
    return axis_size(mesh, axes) == 1


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _gather_dim(x: torch.Tensor, d: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xt = x.movedim(d, 0).contiguous()
    out = torch.empty((n * xt.shape[0], *xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _record("all-gather", _nbytes(xt), _nbytes(out))
    all_gather_into(out, xt, group=group)
    # in x's own layout: a gathered weight must multiply as the unsharded
    # one does (a transposed view would take another GEMM on the card)
    return out.movedim(0, d).contiguous()


def _scatter_dim(x: torch.Tensor, d: int, group) -> torch.Tensor:
    """This rank's block along ``d`` of the sum over ``group``."""
    n = dist.get_world_size(group)
    xt = x.movedim(d, 0).contiguous()
    out = torch.empty((xt.shape[0] // n, *xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _record("reduce-scatter", _nbytes(xt), _nbytes(out))
    reduce_scatter_into(out, xt, group=group)
    return out.movedim(0, d).contiguous()


def unshard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The global tensor from every rank's block (all-gathers over the
    spec's axes; each rank gets the whole; no gradient)."""
    x = x.detach()
    for d, part in enumerate(spec):
        axes = part_axes(part)
        if not _trivial(axes, mesh):
            x = _gather_dim(x, d, axis_group(mesh, axes))
    return x.contiguous()


def _zip_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(specs, P):
        return type(tree)(_zip_specs(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def shard_tree(tree, spec_tree, mesh):
    """:func:`shard` of every tensor leaf by its spec (a leaf without a
    spec, ``None``, stays whole)."""
    return _zip_specs(lambda x, s: x if s is None else shard(x, s, mesh),
                      tree, spec_tree)


def unshard_tree(tree, spec_tree, mesh):
    return _zip_specs(lambda x, s: x if s is None else unshard(x, s, mesh),
                      tree, spec_tree)


# ---------------------------------------------------------------------------
# collectives that gradients flow through
# ---------------------------------------------------------------------------

# every collective above and below reports to the active tallies
_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")
_TALLIES: List["Tally"] = []


class Tally:
    """Per collective kind, the reference's ``collective_bytes`` keys:
    ``count``, ``operand_bytes`` and ``result_bytes`` (an all-gather's
    operand is its result over the group size, a reduce-scatter's its
    result times the group size, an all-reduce's its result)."""

    def __init__(self):
        self.kinds = {k: {"count": 0, "operand_bytes": 0, "result_bytes": 0}
                      for k in _KINDS}

    def add(self, kind: str, operand_bytes: int, result_bytes: int) -> None:
        rec = self.kinds[kind]
        rec["count"] += 1
        rec["operand_bytes"] += operand_bytes
        rec["result_bytes"] += result_bytes

    @property
    def operand_bytes(self) -> int:
        return sum(v["operand_bytes"] for v in self.kinds.values())


@contextlib.contextmanager
def tally():
    """Counts the collectives issued inside the block (a :class:`Tally`);
    tallies nest."""
    t = Tally()
    _TALLIES.append(t)
    try:
        yield t
    finally:
        _TALLIES.remove(t)


def _record(kind: str, operand_bytes: int, result_bytes: int) -> None:
    for t in _TALLIES:
        t.add(kind, operand_bytes, result_bytes)


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    _record("all-reduce", _nbytes(out), _nbytes(out))
    dist.all_reduce(out, group=group)
    return out


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, d, group):
        ctx.d, ctx.group = d, group
        return _gather_dim(x, d, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(g, ctx.d, ctx.group), None, None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter_dim(x, 0, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, 0, ctx.group), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sum_grad):
        ctx.group, ctx.sum_grad = group, sum_grad
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return (_summed(g, ctx.group) if ctx.sum_grad else g), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def all_gather_dim(x: torch.Tensor, dim: int, axes: Sequence[str], mesh
                   ) -> torch.Tensor:
    """Every rank's block along ``axes`` concatenated on ``dim`` in block
    order (FSDP's gather of a weight stored sharded on ``dim``); its
    backward reduce-scatters the gradient on ``dim``: the sum over the
    axes, each rank keeping its block."""
    if _trivial(axes, mesh):
        return x
    return _AllGatherDim.apply(x, dim, axis_group(mesh, axes))


def all_gather_rows(x: torch.Tensor, axes: Sequence[str], mesh
                    ) -> torch.Tensor:
    """The rows of every rank's block along ``axes``, concatenated in
    block order; its backward reduce-scatters the rows' gradient."""
    return all_gather_dim(x, 0, axes, mesh)


def reduce_scatter_rows(x: torch.Tensor, axes: Sequence[str], mesh
                        ) -> torch.Tensor:
    """This rank's row block of the sum over ``axes`` of every rank's
    ``x`` (rows divide by the axes' size); its backward all-gathers."""
    if _trivial(axes, mesh):
        return x
    return _ReduceScatterRows.apply(x, axis_group(mesh, axes))


def copy_to(x: torch.Tensor, axes: Sequence[str], mesh) -> torch.Tensor:
    """``x`` itself; its backward sums the gradient over ``axes``.  A
    replicated activation enters a product sharded over the axes through
    it, so each rank's partial gradient (from its own columns) adds up
    to the whole."""
    if _trivial(axes, mesh):
        return x
    return _CopyTo.apply(x, axis_group(mesh, axes))


def psum(x: torch.Tensor, axes: Sequence[str], mesh) -> torch.Tensor:
    """The sum over ``axes`` of every rank's ``x``; identity backward."""
    if _trivial(axes, mesh):
        return x
    return _Psum.apply(x, axis_group(mesh, axes), False)


def psum_partials(x: torch.Tensor, axes: Sequence[str], mesh
                  ) -> torch.Tensor:
    """The sum over ``axes`` of every rank's partial ``x``; the backward
    sums the ranks' cotangents too (the transpose of a sum of partials
    whose replicated consumer each rank counts ``1 / n`` of)."""
    if _trivial(axes, mesh):
        return x
    return _Psum.apply(x, axis_group(mesh, axes), True)


def pmax(x: torch.Tensor, axes: Sequence[str], mesh) -> torch.Tensor:
    """The elementwise max over ``axes`` of every rank's ``x``, without
    a gradient."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if not _trivial(axes, mesh):
        _record("all-reduce", _nbytes(out), _nbytes(out))
        dist.all_reduce(out, op=dist.ReduceOp.MAX,
                        group=axis_group(mesh, axes))
    return out


def all_reduce_grads(grads: Sequence[torch.Tensor], axes: Sequence[str],
                     mesh) -> None:
    """Sum each tensor of ``grads`` in place over ``axes``."""
    if _trivial(axes, mesh):
        return
    group = axis_group(mesh, axes)
    for g in grads:
        _record("all-reduce", _nbytes(g), _nbytes(g))
        dist.all_reduce(g, group=group)


def axis_size(mesh, axes: Sequence[str]) -> int:
    """The number of blocks over the axes of ``axes`` that ``mesh`` has
    (1 without a mesh)."""
    if mesh is None:
        return 1
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in present(axes, mesh))


@dataclasses.dataclass(frozen=True)
class Rows:
    """The rows of a model's arrays split in blocks over ``axes`` of
    ``mesh``: the hook a model takes (its ``shard=`` argument) where the
    reference applies its sharding constraints.  Node and edge arrays of
    the GNN cells, or the embedding table of DCN-v2, are split so."""
    mesh: Any
    axes: Tuple[str, ...]

    @property
    def size(self) -> int:
        return axis_size(self.mesh, self.axes)

    @property
    def index(self) -> int:
        return block_index(self.mesh, self.axes)[0]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather_rows(x, self.axes, self.mesh)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        return reduce_scatter_rows(x, self.axes, self.mesh)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return psum(x, self.axes, self.mesh)

    def psum_partials(self, x: torch.Tensor) -> torch.Tensor:
        return psum_partials(x, self.axes, self.mesh)
