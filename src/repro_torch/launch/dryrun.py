"""Multi-pod dry-run: count every (architecture x input shape) cell on the
production meshes and extract the roofline terms, ported from
`repro/launch/dryrun.py`.

JAX lowers and compiles each cell on 512 forced host devices and reads
XLA's `cost_analysis`, `memory_analysis` and the collectives of the HLO
text.  Eager PyTorch has no compiled module to ask, so the port runs the
step once, as rank 0 of a fake process group (backend "fake": every
collective returns at once and moves nothing) over the same mesh, on the
meta device (shapes and dtypes, no storage), and counts rank 0's work as
it goes (`RankCounter`, a dispatch mode below DTensor, so it sees each
rank-local op and each collective DTensor issues):

  flops           every local op's FLOPs by `torch.utils.flop_counter`'s
                  formulas (the products; elementwise ops count none),
                  and a kernel's on the meta device as `dispatch`
                  reports it (2·M·K·N a packed product)
  bytes_accessed  each local op's inputs read and outputs written once,
                  fusion-blind as XLA's CPU `bytes accessed` is; views
                  and allocations move nothing; a gather counts its
                  rows, not its table, and an in-place scatter (a cache
                  write) its update, not its destination, as XLA's
                  cost analysis does
  min_bytes       the least traffic: each argument byte an op reads,
                  read once, each byte written into an argument, and the
                  fresh outputs written once (a bound's memory term, as
                  a kernel's bound counts it)
  elementwise_flops  the elementwise ops' and reductions' FLOPs, one an
                  element as XLA counts them (not in `flops`)
  collectives     each collective as (kind, result bytes on rank 0,
                  group size), turned into wire bytes by JAX's ring
                  factors (`roofline.collective_wire_bytes`);
                  `collective_sites` names the largest by the port's
                  function that issued them and the DTensor op before
  memory          JAX's keys: the local arguments (state and inputs),
                  the local outputs, the peak of live local allocations
                  made during the step (temp), and the outputs that share
                  storage with an argument (alias: caches updated in
                  place)

DTensor runs some ops once more at global shapes to place them (its
sharding propagation under a FakeTensorMode, its decompositions on meta
tensors that carry a `_spec`); the counter skips those.  The counts are
DTensor's: the collectives it issues and the placements it picks follow
its cost model, the torch version and the mesh's device type (each cell
records `mesh_device` and `torch`), not XLA's partitioner.

Eager PyTorch runs every layer, so JAX's scan correction (`_combine`: XLA
counts a while-loop body once) has nothing to correct: `raw` equals the
totals.  `count_s` takes the place of `lower_s`/`compile_s`.

Results go to `results/torch_dryrun/` (JAX's go to `results/dryrun/`).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape decode_32k \\
      --mesh single --out results/torch_dryrun
  python -m repro_torch.launch.dryrun --all --mesh both --out results/torch_dryrun
  python -m repro_torch.launch.dryrun --all --mesh both --jobs 8   # 8 at once
  python -m repro_torch.launch.dryrun --all --mesh single --skip-done   # resume
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time
import traceback
import weakref
from collections import Counter
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import (SHAPES, applicable, decode_context,
                                        decode_inputs, prefill_inputs,
                                        token_batch)
from repro_torch.core.qtensor import is_qtensor, tree_map
from repro_torch.kernels import dispatch
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import build as build_roofline
from repro_torch.launch.roofline import collective_wire_bytes
from repro_torch.models import transformer as T
from repro_torch.runtime import use_mesh
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import OptConfig

WORLD = 512  # the fake group's ranks: the multi-pod mesh's
SITES = 12  # the collective sites a cell records, by wire bytes


def mesh_device() -> str:
    """The production mesh's device type: the card's where there is one
    (NCCL's collectives), else the CPU's (a PyTorch built without CUDA
    cannot even fake a CUDA tensor; gloo has no all-to-all, so DTensor
    gathers and slices where it would exchange)."""
    return "cuda" if torch.cuda.is_available() else "cpu"

# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d",
                  "_dtensor")
# ops of those namespaces that move nothing themselves
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd", "barrier",
                    "monitored_barrier_", "check_for_nan",
                    "mesh_get_process_group")
# allocations: no byte is read or written
_ALLOCATIONS = {torch.ops.aten.empty.memory_format,
                torch.ops.aten.empty_strided.default,
                torch.ops.aten.empty_like.default,
                torch.ops.aten.new_empty.default,
                torch.ops.aten.new_empty_strided.default}
# gathers (the table first): XLA's HandleGather counts the output read
# and written and the indices read, not the table
_GATHERS = {torch.ops.aten.embedding.default,
            torch.ops.aten.index_select.default,
            torch.ops.aten.gather.default, torch.ops.aten.index.Tensor}
# in-place scatters (the destination first, the update last): XLA's
# HandleScatter counts three update sizes and the indices, not the
# destination
_SCATTERS = {torch.ops.aten.index_put_.default,
             torch.ops.aten.scatter_.src, torch.ops.aten.scatter_add_.default,
             torch.ops.aten.index_copy_.default,
             torch.ops.aten.index_add_.default}
# transcendental elementwise ops: XLA counts them apart from its FLOPs
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "pow",
                   "silu", "gelu", "softplus"}
_SOFTMAX = {"_softmax", "_log_softmax", "_softmax_backward_data",
            "_log_softmax_backward_data"}


def _storage(t: torch.Tensor):
    return t.untyped_storage()


def _group_size(args) -> int:
    """The group of a collective's arguments: a functional collective's
    group name, or a c10d op's ProcessGroup."""
    from torch.distributed import distributed_c10d as c10d
    for a in reversed(args):
        if isinstance(a, str):
            return c10d._resolve_process_group(a).size()
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in \
                a._type().qualified_name():
            return dist.ProcessGroup.unbox(a).size()
    raise ValueError("a collective without a group")


def _propagating(ins: list) -> bool:
    """True for an op DTensor runs at global shapes to find a layout: its
    sharding propagation under a FakeTensorMode, or a decomposition traced
    on meta tensors that carry a `_spec` (`ins`: the op's tensors)."""
    if torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE) is not None:
        return True
    return any(hasattr(t, "_spec") for t in ins)


class RankCounter(TorchDispatchMode):
    """Counts rank 0's work in the ops it runs (the module docstring):
    `flops`, `bytes`, `records` (kind, result bytes, group size) and
    their `sites`, `elementwise` FLOPs, the kernels called on the meta
    device, live/peak local allocation bytes, and what ops read of and
    write into the call's `args` (`min_bytes`).  DTensor calls pass
    through to DTensor, whose local ops and
    collectives come back here; ops under a FakeTensorMode (DTensor's
    global-shape propagation) are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.records: list = []
        self.kernels: Counter = Counter()
        self.live = 0
        self.peak = 0
        self._held: dict = {}  # storage key -> bytes, while alive
        # the elementwise ops' and reductions' FLOPs, one an element (XLA's
        # count of them; not in `flops`)
        self.elementwise = 0.0
        # (kind, site) -> wire bytes: the port's function that issued the
        # collective and the DTensor op dispatched last before it
        self.sites: Counter = Counter()
        self._op = "?"
        # the call's arguments (storage key -> bytes), the byte ranges of
        # them that ops read, the bytes that gathers read out of them and
        # the bytes written into them (`min_bytes`)
        self.args: dict = {}
        self._arg_spans: dict = {}
        self._arg_gathered: Counter = Counter()
        self._arg_written: Counter = Counter()

    def __enter__(self):
        dispatch.META_LISTENERS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        dispatch.META_LISTENERS.remove(self._kernel)
        return super().__exit__(*exc)

    def _kernel(self, name: str, flops: float, moved: int,
                operands=()) -> None:
        self.kernels[name] += 1
        self.flops += flops
        self.bytes += moved
        for t in operands:
            self._read(t)

    def _read(self, t: torch.Tensor) -> None:
        """Op input `t`: where it views an argument, the byte range it
        spans (a strided view's whole extent)."""
        key = _storage(t)._cdata
        if key in self.args and t.numel():
            start = t.storage_offset() * t.element_size()
            extent = 1 + sum((n - 1) * st for n, st in zip(t.shape,
                                                            t.stride()))
            self._arg_spans.setdefault(key, []).append(
                (start, start + extent * t.element_size()))

    def min_bytes(self, fresh_out: int) -> float:
        """The least traffic of the call: each argument byte an op reads,
        read once (the union of the ranges ops read, and the rows gathers
        read, at most the argument); the bytes written into arguments (a
        cache's new entries); and `fresh_out`, the outputs that are not
        arguments, written once."""
        total = fresh_out
        for key, size in self.args.items():
            read, end = 0, 0
            for lo, hi in sorted(self._arg_spans.get(key, ())):
                lo = max(lo, end)
                if hi > lo:
                    read += hi - lo
                    end = hi
            total += min(size, read + self._arg_gathered[key])
            total += min(size, self._arg_written[key])
        return total

    def _hold(self, st) -> None:
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key) -> None:
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            self._op = func.overloadpacket.__name__
            return NotImplemented
        out = func(*args, **kwargs)
        leaves = torch.utils._pytree.tree_leaves
        ins = [t for t in leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if not _propagating(ins):
            outs = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
            self._count(func, args, kwargs, out, ins, outs)
        return out

    def _count(self, func, args, kwargs, out, ins, outs) -> None:
        if func.namespace in _COLLECTIVE_NS:
            self._collective(func, args, outs)
        rule = flop_registry.get(func.overloadpacket)
        if rule is not None:
            self.flops += rule(*args, **kwargs, out_val=out)
        else:
            self._elementwise(func, ins, outs)
        in_keys = {_storage(t)._cdata for t in ins}
        fresh = [t for t in outs if _storage(t)._cdata not in in_keys]
        for t in fresh:
            self._hold(_storage(t))
        if func in _ALLOCATIONS or not (fresh or func._schema.is_mutable):
            return
        nb = dispatch.nbytes
        if func in _GATHERS:
            table, rest = args[0], [t for t in ins if t is not args[0]]
            got = sum(nb(t) for t in outs)
            self.bytes += 2 * got + sum(nb(t) for t in rest)
            key = _storage(table)._cdata
            if key in self.args:
                self._arg_gathered[key] += got
            for t in rest:
                self._read(t)
            return
        if func in _SCATTERS:
            dst, rest = args[0], [t for t in ins if t is not args[0]]
            update = nb(rest[-1])
            self.bytes += 3 * update + sum(nb(t) for t in rest[:-1])
            self._written(dst, update)
            for t in rest:
                self._read(t)
            return
        seen = set()
        for t in ins:
            if id(t) not in seen:
                seen.add(id(t))
                if func is torch.ops.aten.copy_.default and t is args[0]:
                    continue  # the destination is written, not read
                self.bytes += nb(t)
                self._read(t)
        self.bytes += sum(nb(t) for t in outs)
        if func._schema.is_mutable:
            for t in outs:
                self._written(t, nb(t))

    def _written(self, t: torch.Tensor, n: float) -> None:
        key = _storage(t)._cdata
        if key in self.args:
            self._arg_written[key] += n

    def _elementwise(self, func, ins, outs) -> None:
        name = func.overloadpacket.__name__.rstrip("_")
        if not outs or not outs[0].is_floating_point() or \
                name in _TRANSCENDENTAL:
            return
        if torch.Tag.pointwise in func.tags:
            self.elementwise += outs[0].numel()
        elif torch.Tag.reduction in func.tags and ins:
            self.elementwise += ins[0].numel()
        elif name in _SOFTMAX:  # max, subtract, sum, divide
            self.elementwise += 4 * outs[0].numel()

    def _collective(self, func, args, outs) -> None:
        name = func._opname
        if name in _NOT_COLLECTIVES:
            return
        kind = next((k for key, k in _KINDS if key in name), None)
        if kind is None:
            raise ValueError(f"the dry-run cannot count collective {func}")
        g = _group_size(args)
        site = f"{_site()} {self._op}"
        for t in outs:
            self.records.append((kind, float(dispatch.nbytes(t)), g))
            self.sites[(kind, site)] += collective_wire_bytes(
                [self.records[-1]]).get(kind, 0.0)


# the layout helpers a model calls: a collective is its caller's
_PLUMBING = {(__name__, None), ("repro_torch.runtime", None),
             ("repro_torch.core.qlinear", "scaled_sum")}


def _site() -> str:
    """The innermost frame of the port's model, serving or training code
    on the stack: where a collective was issued (module.function)."""
    f = sys._getframe(2)
    while f is not None:
        name, fn = f.f_globals.get("__name__", ""), f.f_code.co_name
        if name.startswith("repro_torch.") and not (
                (name, None) in _PLUMBING or (name, fn) in _PLUMBING):
            return f"{name[len('repro_torch.'):]}.{fn}"
        f = f.f_back
    return "?"


# ---------------------------------------------------------------------------
# trees on the meta device
# ---------------------------------------------------------------------------


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def eval_shape(fn: Callable, *args, **kwargs) -> Any:
    """JAX's `eval_shape`: `fn`'s output tree, each tensor (a QTensor's
    codes and scale too) an empty one of its shape and dtype on the meta
    device; `fn` runs under a FakeTensorMode, so nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        out = fn(*args, **kwargs)

    def one(x):
        if is_qtensor(x):
            return dataclasses.replace(
                x, codes=_meta(x.codes),
                scale=None if x.scale is None else _meta(x.scale))
        return _meta(x) if isinstance(x, torch.Tensor) else x
    return tree_map(one, out)


def params_struct(cfg, *, packed: bool = False) -> dict:
    """The parameter tree of `model_init` on the meta device."""
    return eval_shape(lambda: T.model_init(torch.Generator().manual_seed(0),
                                           cfg, packed=packed))


def meta_noise(name: str, leaf: torch.Tensor) -> torch.Tensor:
    """The training step's uniform draw of a leaf (`qlinear.step_noise`'s
    shape and dtype), on the meta device: a generator cannot live
    there."""
    del name
    return torch.rand(leaf.shape, dtype=leaf.dtype, device="meta")


def local_tensors(tree: Any) -> list:
    """The rank-local tensors of a tree: a DTensor's shard, a QTensor's
    codes and scale, nested dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):  # QTensor, AttnCache
        return [t for f in dataclasses.fields(tree)
                for t in local_tensors(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in local_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in local_tensors(v)]
    return []


def _storage_bytes(tensors: list) -> dict:
    """{storage key: bytes} of the tensors' storages, each once."""
    return {_storage(t)._cdata: _storage(t).nbytes() for t in tensors}


def _local_block(tree: Any, layouts: Any, mesh) -> Any:
    """Rank 0's block of a global batch laid out by `layouts`."""
    return tree_map(lambda t: t.to_local(), S.distribute(tree, layouts, mesh))


def with_step_on_cpu(state: TS.TrainState) -> TS.TrainState:
    """The optimizer's step counter as a CPU scalar: the step reads it (a
    meta tensor holds no value)."""
    return state._replace(opt=state.opt._replace(
        step=torch.zeros((), dtype=torch.int32)))


def count_call(run: Callable, args: Any) -> tuple[dict, Any]:
    """Run `run()` once under a `RankCounter`: (the counts, its output).
    `args` is the call's argument tree, for the memory keys."""
    counter = RankCounter()
    held = _storage_bytes(local_tensors(args))
    counter.args = held
    with counter:
        out = run()
    made = _storage_bytes(local_tensors(out))
    sites = sorted(counter.sites.items(), key=lambda kv: -kv[1])
    return {
        "flops": counter.flops,
        "bytes_accessed": counter.bytes,
        "min_bytes": counter.min_bytes(
            sum(n for k, n in made.items() if k not in held)),
        "elementwise_flops": counter.elementwise,
        "collectives": collective_wire_bytes(counter.records),
        "collective_records": len(counter.records),
        "collective_sites": {f"{k} {site}": b
                             for (k, site), b in sites[:SITES]},
        "kernels": dict(counter.kernels),
        "memory": {
            "argument_bytes": sum(held.values()),
            "output_bytes": sum(made.values()),
            "temp_bytes": counter.peak,
            "alias_bytes": sum(n for k, n in made.items() if k in held),
        },
    }, out


def count_step(cfg, shape_name: str, mesh, serve_tp: bool = False) -> dict:
    """Count one cell's step on `mesh` (this process rank 0 of a fake
    group that covers it): JAX's `lower_cell` + `_measure`."""
    shape = SHAPES[shape_name]
    opt_cfg = OptConfig(kind="adamw", lr=1e-4)
    serve_cell = shape.kind in ("prefill", "decode")
    tp_serve = serve_tp and serve_cell
    rules = S.serve_param_pspec if tp_serve else S.param_pspec
    p_layout = S.serve_param_shardings if tp_serve else S.param_shardings
    B = shape.global_batch

    def serve_params():
        params = params_struct(cfg)
        if tp_serve:  # deployment layout: bf16 weights, no fp32 masters
            params = tree_map(lambda t: t.to(torch.bfloat16)
                              if t.is_floating_point() else t, params)
        return S.distribute(params, p_layout(params, mesh), mesh)

    def serve_caches():
        ctx, src = decode_context(cfg, shape.seq_len)
        caches = T.init_caches(cfg, B, ctx, src_len=src, device="meta")
        return S.distribute(caches, S.cache_shardings(caches, mesh), mesh)

    with use_mesh(mesh, param_rules=rules, compute_rules=S.compute_param_pspec), \
            implicit_replication():
        if shape.kind == "train":
            state = with_step_on_cpu(
                TS.train_state_init(params_struct(cfg), opt_cfg, 0))
            if TS.tensor_parallel(mesh):  # else whole on every rank
                state = TS.shard_state(state, mesh)
            batch = token_batch(cfg, B, shape.seq_len)
            batch = _local_block(batch, S.batch_shardings(batch, mesh), mesh)
            step = TS.make_train_step(cfg, opt_cfg, mesh=mesh)
            args = (state, batch)
            run = lambda: step(state, batch, noise=meta_noise)
        else:
            params, caches = serve_params(), serve_caches()
            if shape.kind == "prefill":
                inputs = prefill_inputs(cfg, B, shape.seq_len)
            else:
                inputs = decode_inputs(cfg, B)
            inputs = S.distribute(inputs, S.batch_shardings(inputs, mesh),
                                  mesh)
            args = (params, caches, inputs)

            def run():
                with torch.no_grad():
                    if shape.kind == "prefill":
                        return T.prefill(params, inputs["tokens"], caches, cfg,
                                         img=inputs.get("img"),
                                         enc_frames=inputs.get("enc_frames"))
                    # decode against a full cache: every slot is read
                    return T.decode_step(params, inputs["token"], caches, cfg)
        counts, _ = count_call(run, args)
    counts["n_chips"] = mesh.size()
    return counts


def fake_group(world: int = WORLD) -> None:
    """Make this process rank 0 of a fake process group of `world` ranks
    (its collectives move nothing), unless it already is."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < world:
            raise RuntimeError(
                f"the dry-run needs a fake process group of {world} ranks; "
                f"this process is in a {dist.get_backend()} group of "
                f"{dist.get_world_size()}: run it in a process of its own")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def count_cell(cfg, shape_name: str, multi_pod: bool,
               serve_tp: bool = False) -> dict:
    """One grid cell on the production mesh of 256 (single) or 512 (multi)
    ranks: JAX's `lower_cell` + `_measure`."""
    t0 = time.time()
    fake_group()
    device = mesh_device()
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    out = count_step(cfg, shape_name, mesh, serve_tp)
    out["count_s"] = round(time.time() - t0, 2)
    # DTensor's choice of collectives follows both
    out.update(mesh_device=device, torch=torch.__version__)
    return out


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------


VARIANTS = ("baseline", "packed", "servetp", "dots", "parallel",
            "packed+servetp", "packed+dots", "parallel+dots",
            "parallel+packed+dots")


def apply_variant(cfg, variant: str):
    """Beyond-paper optimization toggles:
      packed  — FSDP/TP weight gathers move 2-bit/1-bit codes
      servetp — serve cells store weights TP-only + bf16 (no per-token gather)
      dots    — remat policy saves matmul outputs (~8ND -> 6ND train flops)
    """
    parts = set(variant.split("+"))
    if "packed" in parts and cfg.quant.mode in ("binary", "ternary"):
        cfg = cfg.with_quant(dataclasses.replace(cfg.quant, packed_comms=True))
    if "dots" in parts:
        cfg = dataclasses.replace(cfg, remat_policy="dots")
    if "parallel" in parts:
        cfg = dataclasses.replace(cfg, parallel_block=True)
    return cfg, ("servetp" in parts)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             variant: str = "baseline") -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    cell = {"arch": arch, "shape": shape_name, "variant": variant,
            "mesh": "multi" if multi_pod else "single"}
    if not ok:
        cell.update(status="skipped", reason=why)
        return cell
    cfg, serve_tp = apply_variant(cfg, variant)
    try:
        main = count_cell(cfg, shape_name, multi_pod, serve_tp)
        # every layer ran: nothing to correct (the module docstring)
        cell["raw"] = {k: main[k] for k in ("flops", "bytes_accessed",
                                            "collectives")}
        cell.update(status="ok", **main)
        wb = 16
        if "packed" in variant:
            wb = {"ternary": 2, "binary": 1}.get(cfg.quant.mode, 16)
        rf = build_roofline(cell, cfg, shape, main["n_chips"], weight_bits=wb)
        cell["roofline"] = rf.to_json()
    except Exception as e:  # record failures — they are bugs to fix
        cell.update(status="error", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-2000:])
    return cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/torch_dryrun")
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, each in a child process")
    args = ap.parse_args(argv)
    # DTensor warns of each two-axis all-reduce it issues: JAX's mesh has
    # those axes, so every cell would repeat it
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if args.all or not args.arch else (args.arch,)
    shapes = tuple(SHAPES) if args.all or not args.shape else (args.shape,)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)

    todo = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                suffix = "" if args.variant == "baseline" else f"__{args.variant}"
                path = out / f"{arch}__{shape}__{mesh_kind}{suffix}.json"
                if args.skip_done and path.exists():
                    prev = json.loads(path.read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        continue
                todo.append((arch, shape, mesh_kind, path))
    if args.jobs > 1:
        cells = _in_children(todo, args)
    else:
        cells = (_counted(run_cell(arch, shape, mesh_kind == "multi",
                                   args.variant), path)
                 for arch, shape, mesh_kind, path in todo)
    n_ok = n_err = n_skip = 0
    for cell in cells:
        st = cell["status"]
        n_ok += st == "ok"
        n_err += st == "error"
        n_skip += st == "skipped"
    print(f"done: {n_ok} ok, {n_err} errors, {n_skip} skipped")
    return 0 if n_err == 0 else 1


def _counted(cell: dict, path: Path) -> dict:
    """Write a cell's JSON and print its line."""
    path.write_text(json.dumps(cell, indent=1))
    st = cell["status"]
    if st == "ok":
        r = cell["roofline"]
        msg = (f"dom={r['dominant']} tc={r['t_compute_s']:.3e} "
               f"tm={r['t_memory_s']:.3e} tx={r['t_collective_s']:.3e} "
               f"count={cell['count_s']}s")
    elif st == "error":
        msg = cell["error"][:140]
    else:
        msg = cell["reason"][:80]
    print(f"[{st:7s}] {cell['arch']:22s} {cell['shape']:12s} "
          f"{cell['mesh']:6s} {msg}", flush=True)
    return cell


def _in_children(todo: list, args):
    """`--jobs`: each cell counted by this CLI in a child process of its
    own (a fake process group a process), `args.jobs` at once; yields each
    cell as its child ends.  A child that ends without its cell's JSON
    records an error."""
    import subprocess
    import tempfile
    pending, running = list(todo), []
    while pending or running:
        while pending and len(running) < args.jobs:
            arch, shape, mesh_kind, path = pending.pop(0)
            if path.exists():
                path.unlink()
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
                   "--out", str(path.parent), "--variant", args.variant]
            log = tempfile.TemporaryFile("w+")
            running.append(((arch, shape, mesh_kind, path), log,
                            subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                             stderr=log)))
        time.sleep(0.2)
        for item in [r for r in running if r[2].poll() is not None]:
            running.remove(item)
            (arch, shape, mesh_kind, path), log, p = item
            log.seek(0)
            err = log.read()
            log.close()
            if path.exists():
                cell = json.loads(path.read_text())
            else:
                cell = {"arch": arch, "shape": shape, "variant": args.variant,
                        "mesh": mesh_kind, "status": "error",
                        "error": f"the child exited {p.returncode}: "
                                 f"{err[-1500:]}"}
            yield _counted(cell, path)


if __name__ == "__main__":
    raise SystemExit(main())
