"""Process-wide runtime context, ported from `repro/runtime.py`: which
logical mesh axes exist right now.

Model code calls `constrain(x, *axes)` to request an activation layout;
outside a mesh context (unit tests, one device) and on a plain tensor it
is a no-op, inside the trainer or the mesh engine it redistributes a
`DTensor` to the layout.  Axes that do not divide the corresponding
dimension are dropped (8 KV heads on a 16-way 'model' axis are
replicated), so one set of rules serves every (arch x mesh).

A layout is JAX's: a tuple of entries, one a tensor dim, each None, an
axis name or a tuple of axis names (`tuple(PartitionSpec(...))`), so a
test compares a rule of this package with JAX's directly.  `placements`
turns it into a `DTensor`'s placements over a `DeviceMesh` whose
`mesh_dim_names` are JAX's axis names: a tensor dim carrying axes gets
`Shard(dim)` on each of those mesh dims, the others `Replicate()`.  Eager
DTensor ops then play XLA SPMD's part: a column-parallel product followed
by a row-parallel one ends in a `Partial` sum and its all-reduce.

`abstract_mesh(sizes, names)` is JAX's device-free mesh: axis sizes only,
so rules can be built and tested for a 512-device pod without a process.

Where DTensor's own choices would move more than XLA's partitioner does,
the model code states the layout: `reduced` sums a row-parallel product
at once (`scaled_sum` with its channel scale), `grad_reduced` sums the
input gradients of column-parallel products once, and `on_shards` runs
an op on each rank's shards, with `reduce_over`/`sum_over` for the
(B, S)-sized reductions of a vocabulary-parallel loss.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_state = threading.local()

Spec = tuple  # one entry a tensor dim: None, "axis" or ("axis", ...)
DATA = ("pod", "data")  # the batch (data-parallel) axes of a mesh


class AbstractMesh:
    """Axis names and sizes, no devices (JAX's `AbstractMesh`)."""

    def __init__(self, sizes: Sequence[int], names: Sequence[str]):
        self.mesh_dim_names = tuple(names)
        self.shape = dict(zip(self.mesh_dim_names, (int(s) for s in sizes)))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def abstract_mesh(sizes: Sequence[int], names: Sequence[str]) -> AbstractMesh:
    return AbstractMesh(sizes, names)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of an `AbstractMesh` or a `DeviceMesh` (JAX's
    `mesh.shape`)."""
    if mesh is None:
        return {}
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def current_mesh():
    return getattr(_state, "mesh", None)


def current_param_rules():
    return getattr(_state, "param_rules", None)


def current_compute_rules():
    return getattr(_state, "compute_rules", None)


@contextlib.contextmanager
def use_mesh(mesh, param_rules=None, compute_rules=None):
    """Make `mesh` current.  `param_rules(path, leaf, mesh) -> spec` lets
    inner code (the quantizer) pin intermediates to the parameter STORAGE
    layout; `compute_rules` gives the layout of the transient COMPUTE copy
    (the cast or unpacked weight the matmuls read), see `constrain_param`."""
    prev = (current_mesh(), current_param_rules(), current_compute_rules())
    _state.mesh, _state.param_rules, _state.compute_rules = (
        mesh, param_rules, compute_rules)
    try:
        yield mesh
    finally:
        _state.mesh, _state.param_rules, _state.compute_rules = prev


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh) -> tuple:
    """A layout's `DTensor` placements over `mesh`, one a mesh dim: the
    tensor dim whose entry names a mesh axis is `Shard(dim)` there, every
    other mesh dim `Replicate()`.  A tensor dim split over several axes
    takes them in mesh order (pod before data, JAX's block order); an
    entry naming them in another order, or an axis the mesh lacks,
    raises.  An axis of size 1 splits nothing and stays `Replicate()`
    (DTensor will not reshape a dim sharded over it)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"axis {a!r} of {spec} is not on the mesh "
                                 f"{names}")
            if sizes[a] > 1:
                out[names.index(a)] = Shard(dim)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"entry {entry!r} of {spec} splits a dim in "
                             f"another order than the mesh's {names}")
    return tuple(out)


def constrain_param(path, master, derived, drop_axes: Sequence[str] = (),
                    kind: str = "storage"):
    """`derived` (a quantized sample, a cast, an unpacked weight) in the
    layout the parameter rules give `master`, so elementwise work stays
    shard-local.  `drop_axes` removes mesh axes from the layout (the
    unpacked compute copy is model-sharded only); axes that no longer
    divide a dim (a packed K) are dropped.  A no-op outside a mesh, without
    rules, or on a plain tensor."""
    mesh, rules = current_mesh(), current_param_rules()
    if kind == "compute" and current_compute_rules() is not None:
        rules, drop_axes = current_compute_rules(), ()
    if mesh is None or rules is None or not isinstance(derived, DTensor):
        return derived
    spec = tuple(rules(path, master, mesh))
    sizes = axis_sizes(mesh)
    entries = list(spec[:derived.dim()])
    entries += [None] * (derived.dim() - len(entries))
    fixed = []
    for dim, entry in zip(derived.shape, entries):
        kept = tuple(a for a in _axes(entry) if a not in drop_axes)
        n = 1
        for a in kept:
            n *= sizes.get(a, 1)
        if not kept or dim % n:
            fixed.append(None)
        else:
            fixed.append(kept if len(kept) > 1 else kept[0])
    return derived.redistribute(derived.device_mesh,
                                placements(tuple(fixed), mesh))


def _fit(dim: int, axes, mesh) -> Optional[object]:
    """The largest prefix of `axes` whose product divides `dim`."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    keep, prod = [], 1
    for a in axes:
        if a not in sizes:
            continue
        n = sizes[a]
        if dim % (prod * n) == 0:
            keep.append(a)
            prod *= n
        else:
            break
    if not keep:
        return None
    return tuple(keep) if len(keep) > 1 else keep[0]


def spec_for(shape: Sequence[int], *axes) -> Spec:
    """A layout for `shape`, replicating the dims an axis does not divide;
    () outside a mesh (JAX's `P()`)."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    return tuple(_fit(d, a, mesh) for d, a in zip(shape, axes))


def constrain(x, *axes):
    """`x` in the layout of its logical axes: a DTensor redistributed,
    anything else as it is; a no-op outside a mesh."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = spec_for(x.shape, *axes)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def shard_extent(shape: Sequence[int], mesh, placements) -> tuple:
    """(local shape, global offset) of this rank's shard of a tensor of
    global `shape` laid out by `placements` over `mesh`."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return compute_local_shape_and_global_offset(shape, mesh, placements)


def shard_like(lead: DTensor, dims: dict) -> list:
    """Placements splitting a tensor as DTensor `lead` is split: `dims`
    maps a split dim of `lead` to the tensor's dim for it; over a mesh dim
    whose split `dims` does not map, the tensor is whole."""
    return [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
            else Replicate() for p in lead.placements]


def on_shards(fn, mesh, args: Sequence, want: Sequence, out,
              shapes=None):
    """`fn` on each rank's shards, for work that DTensor's own ops cannot
    lay out (they flatten a split dim with its neighbours, which some
    versions refuse, or move data a rank can keep).  Arg i is laid out as
    `want[i]` over `mesh` (a plain tensor taken as replicated; None in
    `want` passes it as it is) and passed local; `fn`'s output, a tensor
    or a tuple of them, becomes DTensors of placements `out` (one list, or
    a list an output) and global shapes `shapes` where given (a shape, or
    one an output); an `fn` that writes into the local shards returns
    None.  to_local and
    from_local carry gradients: an arg whole over a mesh dim that splits
    another arg gets each rank's share of its gradient (`Partial`), a
    partial-sum arg the whole of it."""
    split = [any(w is not None and w[d].is_shard() for w in want)
             for d in range(mesh.ndim)]
    local = []
    for a, w in zip(args, want):
        if w is not None and a is not None:
            if not isinstance(a, DTensor):
                a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            if tuple(a.placements) != tuple(w):
                a = a.redistribute(mesh, w)
            a = a.to_local(grad_placements=[
                Partial() if s and p.is_replicate() else
                Replicate() if p.is_partial() else p
                for s, p in zip(split, w)])
        local.append(a)
    got = fn(*local)
    if got is None:  # fn wrote into the local shards
        return None
    if isinstance(got, torch.Tensor):
        return from_local(got, mesh, out, shapes)
    shapes = shapes or (None,) * len(got)
    return tuple(from_local(o, mesh, pl, sh)
                 for o, pl, sh in zip(got, out, shapes))


def reduce_over(t: torch.Tensor, groups: Sequence[str],
                op: str = "sum") -> torch.Tensor:
    """`t` all-reduced (`op`: "sum" or "max") over each process group in
    `groups` (group names) in turn: the rank-local half of a reduction
    over mesh dims, inside `on_shards`.  Carries no gradient."""
    for g in groups:
        t = torch.ops._c10d_functional.wait_tensor(
            torch.ops._c10d_functional.all_reduce(t, op, g))
    return t


class _SumOver(torch.autograd.Function):
    """The sum of every rank's share over `groups`; its gradient is the
    caller's replicated gradient as it is (each share enters the sum
    once, so its gradient is the sum's)."""

    @staticmethod
    def forward(ctx, t, groups):
        return reduce_over(t, groups)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over(t: torch.Tensor, groups: Sequence[str]) -> torch.Tensor:
    """`reduce_over(t, groups)` with gradients: each rank's share of a sum
    whose result every rank holds whole (a vocabulary-parallel softmax's
    denominator, a lookup's rows)."""
    return _SumOver.apply(t, tuple(groups))


def from_local(o: torch.Tensor, mesh, pl, shape=None) -> DTensor:
    """Rank-local `o` as a DTensor of placements `pl` over `mesh`; even
    shards unless the global `shape` is given (its strides contiguous,
    computed: a tensor of the global shape, even on the meta device, would
    count as an allocation in the dry-run)."""
    if shape is None:
        return DTensor.from_local(o, mesh, pl, run_check=False)
    stride, n = [], 1
    for size in reversed(tuple(shape)):
        stride.append(n)
        n *= max(int(size), 1)
    return DTensor.from_local(o, mesh, pl, run_check=False, shape=shape,
                              stride=tuple(reversed(stride)))


class _ReducedGrad(torch.autograd.Function):
    """The identity, whose gradient has its pending partial sums reduced
    (`reduced`)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return reduced(grad)


def grad_reduced(x):
    """`x`, whose gradient is summed over the mesh dims where it arrives
    as partial sums: the input of column-parallel products (the
    attention's projections, the MLP's gate and up, the experts' and
    the SSD mixer's input) gets one all-reduce of their summed input
    gradients, as XLA's
    partitioner reduces the transpose of JAX's products, and the residual
    stream's gradient stays whole over 'model'.  A plain tensor as it
    is."""
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    return _ReducedGrad.apply(x)


def reduced(x):
    """`x` with its pending partial sums reduced (a DTensor's `Partial`
    mesh dims all-reduced, as XLA reduces a row-parallel product before
    the elementwise ops that read it); anything else as it is.  Some
    DTensor versions would otherwise move the other operand of such an op
    to partial sums, which they cannot."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                              for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


class _ScaledPartial(torch.autograd.Function):
    """`y * s` for partial sums `y` and a scale `s` whole on every rank
    (`scaled_sum`).  Its backward runs on each rank's partial sums: `y`'s
    gradient is `s` times the whole gradient, `s`'s a partial sum of each
    rank's rows, so no op reads `y` whole (DTensor's own `mul` backward
    would, in some versions: an all-reduce of `y`).  The sum itself is
    left to `reduced`, so a recomputed region that stops once its saved
    tensors are back stops before it."""

    @staticmethod
    def forward(ctx, y, s):
        ctx.save_for_backward(y, s)
        return y * s

    @staticmethod
    def backward(ctx, grad):
        y, s = ctx.saved_tensors
        mesh = y.device_mesh
        grad = grad.redistribute(mesh, [Replicate() if p.is_partial() else p
                                        for p in y.placements])
        ds = (grad.to_local() * y.to_local()).sum_to_size(s.shape)
        return grad * s, from_local(ds, mesh, [
            Partial() if p.is_partial() or p.is_shard() else Replicate()
            for p in y.placements])


def scaled_sum(y, s):
    """`reduced(y * s)`: a row-parallel product's partial sums `y` scaled
    by `s` (its output channels' scale) and summed over the mesh dims
    where they are partial.  The scale's gradient stays a partial sum per
    rank, so the backward moves no activation; anything but partial sums
    of a last dim that no mesh dim splits, scaled by a whole `s`, as
    `reduced(y * s)`."""
    if (isinstance(y, DTensor) and isinstance(s, DTensor)
            and any(p.is_partial() for p in y.placements)
            and all(p.is_replicate() for p in s.placements)
            and not any(p.is_shard(y.dim() - 1) for p in y.placements)):
        return reduced(_ScaledPartial.apply(y, s))
    return reduced(y * s)
