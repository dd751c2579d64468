"""Parameter, state, batch and cache layouts for a mesh, ported from
`repro/launch/sharding.py`.

Weight layout: TP over 'model' (column-parallel up-projections,
row-parallel down-projections, the expert axis for MoE, the vocab axis for
the embedding and head), FSDP over 'data' on the other matmul dim.  Axes
that do not divide a dimension are dropped (replicated), so one rule set
serves every (arch x mesh).

A layout is JAX's `PartitionSpec` as a tuple of entries (None, "model",
("pod", "data")), so `tuple(P)` of a JAX rule compares with a rule here
directly; `runtime.placements` turns one into `DTensor` placements, and
`distribute` a tree of tensors and layouts into `DTensor`s.  Eager DTensor
ops then schedule what XLA SPMD does: the all-gather of a data-sharded
weight on use, the all-reduce of a row-parallel product's partial sums,
the reduction of a gradient back to its parameter's shards.  The
`*_shardings` functions return trees of layouts (a packed weight's a
`QTensor` whose codes and scale are layouts), where JAX's return
`NamedSharding`s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.core.qtensor import is_qtensor, tree_map, tree_map_with_path
from repro_torch.models.mamba2 import SSMState
from repro_torch.models.rwkv6 import RWKVState
from repro_torch.runtime import (DATA, axis_sizes, placements, shard_extent,
                                 use_mesh)
from repro_torch.serve.kvcache import (AttnCache, CrossCache, kv_pspec,
                                       slot_axis)

# row-parallel (input dim on 'model'): projections whose input is the
# model-sharded hidden (attention heads / ffn hidden / ssm inner).
ROW_W = {"Wo", "Wdown", "Wfc2", "Wout", "Wcv"}
DATA_AXES = DATA


def _fit(dim: int, axis: str, mesh) -> Optional[str]:
    n = axis_sizes(mesh).get(axis, 1)
    return axis if n > 1 and dim % n == 0 else None


def param_pspec(path, leaf, mesh) -> tuple:
    """The storage layout of parameter `leaf` at `path` (a tuple of key
    strings, JAX's path)."""
    keys = [str(p) for p in path]
    name = keys[-1] if keys else ""
    shape = tuple(leaf.shape)
    nd = len(shape)

    if name == "embed":
        return (_fit(shape[0], "model", mesh), _fit(shape[1], "data", mesh))
    if name == "head":
        return (_fit(shape[0], "data", mesh), _fit(shape[1], "model", mesh))
    if name.startswith("W") and nd >= 2:
        lead = (None,) * (nd - 2)
        if "moe" in keys and nd >= 3:
            # (.., E, din, dout): expert-parallel over 'model', FSDP over
            # 'data'; where E does not divide the model axis (mixtral: 8
            # experts, 16-way TP), tensor parallelism INSIDE the experts
            lead = (None,) * (nd - 3)
            e_ax = _fit(shape[-3], "model", mesh)
            if e_ax is not None:
                return (*lead, e_ax, _fit(shape[-2], "data", mesh), None)
            if name in ROW_W:  # (E, f, d): f on model, d on data
                return (*lead, None, _fit(shape[-2], "model", mesh),
                        _fit(shape[-1], "data", mesh))
            return (*lead, None, _fit(shape[-2], "data", mesh),
                    _fit(shape[-1], "model", mesh))
        if name in ROW_W:
            return (*lead, _fit(shape[-2], "model", mesh),
                    _fit(shape[-1], "data", mesh))
        return (*lead, _fit(shape[-2], "data", mesh),
                _fit(shape[-1], "model", mesh))
    # 1D / small parameters: replicated
    return ()


def param_shardings(params: Any, mesh) -> Any:
    return tree_map_with_path(lambda path, leaf: param_pspec(path, leaf, mesh),
                              params)


def _drop(spec: tuple, axes=DATA_AXES) -> tuple:
    def keep(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            kept = tuple(x for x in a if x not in axes)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return None if a in axes else a

    return tuple(keep(a) for a in spec)


def serve_param_pspec(path, leaf, mesh) -> tuple:
    """Serving layout: tensor-parallel only (weights replicated across the
    data axes): no optimizer shards to sit beside, and no per-token weight
    all-gather in a decode step."""
    return _drop(param_pspec(path, leaf, mesh))


def compute_param_pspec(path, leaf, mesh) -> tuple:
    """Layout of the transient COMPUTE copy of a weight (cast or unpacked):
    the storage layout minus the FSDP axes, TP kept."""
    return _drop(param_pspec(path, leaf, mesh))


def qtensor_pspecs(spec: tuple, q, mesh):
    """Project a dense layout of QTensor `q`'s LOGICAL shape (..., K, N)
    onto its packed codes (..., ceil(K/G), N): (codes layout, scale
    layout or None).

    The column entry carries over.  The contraction entry survives only
    when the PACKED row count divides its axes and packing padded
    nothing; otherwise a shard boundary would fall inside a pack word or
    the pad.  A per-output-channel scale follows the column entry."""
    nd = q.codes.dim()
    entries = list(spec) + [None] * (nd - len(spec))
    entries = entries[:nd]
    k_ax = nd - 2
    ke = entries[k_ax]
    if ke is not None:
        axes = ke if isinstance(ke, tuple) else (ke,)
        sizes = axis_sizes(mesh)
        parts = math.prod(sizes.get(a, 1) for a in axes)
        padded = q.codes.shape[k_ax] * q.group != q.k
        if padded or parts < 2 or q.codes.shape[k_ax] % parts:
            entries[k_ax] = None
    codes_spec = tuple(entries)
    scale_spec = None
    if q.scale is not None:
        ce = entries[-1] if q.scale.shape[-1] == q.codes.shape[-1] else None
        scale_spec = (*([None] * (q.scale.dim() - 1)), ce)
    return codes_spec, scale_spec


def serve_param_shardings(params: Any, mesh) -> Any:
    """Serving layouts, QTensor-aware: a packed leaf reports its logical
    (..., K, N) shape, so the name rules apply unchanged, and its layout
    is projected onto codes and scale (a QTensor of layouts)."""

    def one(path, leaf):
        spec = serve_param_pspec(path, leaf, mesh)
        if not is_qtensor(leaf):
            return spec
        cs, ss = qtensor_pspecs(spec, leaf, mesh)
        return dataclasses.replace(leaf, codes=cs, scale=ss)

    return tree_map_with_path(one, params)


def state_shardings(state: Any, mesh) -> Any:
    """TrainState layouts: params, optimizer moments and residual follow
    the param rules; the step, the noise seed and the RNN's BN state are
    replicated."""
    pshard = param_shardings(state.params, mesh)
    rep_tree = lambda t: tree_map(lambda _: (), t)
    return state._replace(
        params=pshard,
        opt=state.opt._replace(
            step=(),
            m=pshard if state.opt.m is not None else None,
            v=pshard if state.opt.v is not None else None),
        noise_seed=(),
        bn_state=rep_tree(state.bn_state) if state.bn_state is not None
        else None,
        residual=pshard if state.residual is not None else None)


def _data_entry(mesh):
    axes = tuple(a for a in DATA_AXES if a in axis_sizes(mesh))
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def batch_shardings(batch: Any, mesh) -> Any:
    """The batch axis over the data axes (all of them, or none where they
    do not divide it)."""
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in DATA_AXES if a in sizes)
    spec = _data_entry(mesh)
    n = math.prod(sizes[a] for a in axes) if axes else 1

    def one(x):
        b = spec
        if n > 1 and x.shape[0] % n != 0:
            b = None
        return (b, *([None] * (len(x.shape) - 1)))

    return tree_map(one, batch)


def _bd(mesh, batch: int):
    sizes = axis_sizes(mesh)
    axes, prod = [], 1
    for a in DATA_AXES:
        n = sizes.get(a, 1)
        if n > 1 and batch % (prod * n) == 0:
            axes.append(a)
            prod *= n
    return tuple(axes) if len(axes) > 1 else (axes[0] if axes else None)


def _is_node(x) -> bool:
    return isinstance(x, (AttnCache, CrossCache, SSMState, RWKVState))


def _map_nodes(f, tree, *rest):
    """`f` over the cache nodes of nested dicts, lists and tuples."""
    if _is_node(tree):
        return f(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_nodes(f, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map_nodes(f, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return f(tree, *rest)


def cache_shardings(caches: Any, mesh) -> Any:
    """Layouts of a cache tree (AttnCache/CrossCache/SSMState/RWKVState
    nodes, possibly stacked with a leading repeat axis)."""

    def kv_like(shape):  # (.., B, C, H, hd)
        lead = (None,) * (len(shape) - 4)
        B, C, H = shape[-4], shape[-3], shape[-2]
        with use_mesh(mesh):
            spec = kv_pspec(B, C, H)
        return (*lead, *spec)

    def node(c):
        if isinstance(c, AttnCache):
            s = kv_like(c.k.shape)
            return AttnCache(k=s, v=s, pos=(), ring=c.ring)
        if isinstance(c, CrossCache):
            s = kv_like(c.k.shape)
            return CrossCache(k=s, v=s)
        if isinstance(c, SSMState):
            lead = (None,) * (c.h.dim() - 4)
            B, H = c.h.shape[-4], c.h.shape[-3]
            bd = _bd(mesh, B)
            return SSMState(
                h=(*lead, bd, _fit(H, "model", mesh), None, None),
                conv=(*lead, bd, None, _fit(c.conv.shape[-1], "model", mesh)),
                pos=())
        if isinstance(c, RWKVState):
            lead = (None,) * (c.S.dim() - 4)
            B, H = c.S.shape[-4], c.S.shape[-3]
            bd = _bd(mesh, B)
            sh = (*lead, bd, _fit(c.tm_shift.shape[-1], "model", mesh))
            return RWKVState(
                S=(*lead, bd, _fit(H, "model", mesh), None, None),
                tm_shift=sh, cm_shift=sh, pos=())
        raise TypeError(type(c))

    return _map_nodes(node, caches)


def serve_pool_shardings(pool: Any, ref: Any, mesh) -> Any:
    """Layouts of a ServeEngine slot pool.

    The slot axis of every leaf, recovered against the batch-1 `ref` as
    the engine's slot surgery does, shards over the data axes, so slot s
    lives on data shard s // (slots / D).  AttnCache K/V also shard their
    KV-heads axis over 'model' where it divides (`kv_pspec`'s preferred
    layout); recurrent state keeps its feature axes local.  Leaves
    without a slot axis replicate."""

    def leaf_sh(p, r, extra=()):
        ax = slot_axis(p.shape, r.shape)
        spec = [None] * len(p.shape)
        if ax is not None:
            spec[ax] = _bd(mesh, p.shape[ax])
        for a, m_ax in extra:
            if a is not None and a < len(p.shape) and spec[a] is None:
                spec[a] = _fit(p.shape[a], m_ax, mesh)
        return tuple(spec)

    def node(p, r):
        if isinstance(p, (AttnCache, CrossCache)):
            ax = slot_axis(p.k.shape, r.k.shape)
            heads = None if ax is None else ax + 2  # (.., B, C, H, hd)
            kv = leaf_sh(p.k, r.k, extra=((heads, "model"),))
            if isinstance(p, CrossCache):
                return CrossCache(k=kv, v=kv)
            return AttnCache(k=kv, v=kv, pos=leaf_sh(p.pos, r.pos),
                             ring=p.ring)
        if isinstance(p, (SSMState, RWKVState)):
            return type(p)(*(leaf_sh(a, b) for a, b in zip(p, r)))
        return leaf_sh(p, r)

    return _map_nodes(node, pool, ref)


# ---------------------------------------------------------------------------
# layouts to DTensors
# ---------------------------------------------------------------------------


def to_dtensor(x: torch.Tensor, spec: tuple, mesh) -> DTensor:
    """`x` (the full tensor, the same on every rank) as a DTensor in
    layout `spec`: each rank keeps its shard, no collective.  A meta
    tensor (no data: the dry-run's) becomes an empty shard of its local
    shape, without splitting the whole."""
    pl = placements(spec, mesh)
    if x.is_meta:
        local, _ = shard_extent(x.shape, mesh, pl)
        return DTensor.from_local(
            torch.empty(local, dtype=x.dtype, device="meta"), mesh, pl,
            run_check=False, shape=x.shape, stride=x.stride())
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def distribute(tree: Any, layouts: Any, mesh) -> Any:
    """Every tensor of `tree` as a DTensor in its layout (a QTensor's codes
    and scale by theirs)."""

    def one(x, spec):
        if x is None:
            return None
        if is_qtensor(x):
            return dataclasses.replace(
                x, codes=to_dtensor(x.codes, spec.codes, mesh),
                scale=(None if x.scale is None
                       else to_dtensor(x.scale, spec.scale, mesh)))
        return to_dtensor(x, spec, mesh)

    return _map_leaves(one, tree, layouts)


def _map_leaves(f, tree, layouts):
    """`f(leaf, layout)` over a tree whose layouts mirror it; a layout is
    a tuple at a leaf, so the walk follows `tree`."""
    if tree is None:
        return None
    if isinstance(tree, AttnCache):
        return tree._replace(k=f(tree.k, layouts.k), v=f(tree.v, layouts.v),
                             pos=f(tree.pos, layouts.pos))
    if isinstance(tree, dict):
        return {k: _map_leaves(f, v, layouts[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        items = [_map_leaves(f, v, l) for v, l in zip(tree, layouts)]
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return f(tree, layouts)


def drop_data(tree: Any, layouts: Any) -> Any:
    """`layouts` (of `tree`'s leaves) with the data axes taken out: what a
    rank that holds its data shard whole lays over the other axes."""
    return _map_leaves(lambda _, spec: _drop(spec), tree, layouts)


def full(x):
    """The whole tensor of a DTensor (a collective); anything else as it
    is."""
    return x.full_tensor() if isinstance(x, DTensor) else x
