"""Continuous-batching serve engine, ported from `repro/serve/engine.py`
for the paper's RNN family and the transformer pool's dense, MoE, RWKV6
and hybrid (zamba2) families on one device.

`ServeEngine` owns a fixed pool of B slots over an `RNNRuntime` or a
`TransformerRuntime` (serve/recurrent.py) and turns
the lockstep prefill -> decode loop into mixed-length traffic serving:

  * requests are admitted from a priority queue as slots free up;
    admission is bookkeeping: the prompt is split into chunks of
    `prefill_chunk` tokens (the last one shorter), or kept as one chunk
    for a runtime whose `chunk_granularity` is "whole" (MoE, rwkv and
    mamba: a split is not exact there), and the slot starts prefilling;
  * each scheduler iteration runs at most one prefill chunk, straight into
    the admitted slot (gather the slot row, run the chunk, write the row
    back), then one batched decode tick over all B slots with the dead
    ones masked by `live`, never resliced: on a packed tree a tick is one
    launch of the fused kernel, whatever the occupancy, and a long prompt
    never stalls live decodes by more than one chunk;
  * a request's first token is sampled when its last chunk lands
    (`Completion.t_first` is the real time to first token); the slot then
    turns live and decodes;
  * slots retire on EOS or on the request's max tokens and are scrubbed
    (an RNN row's h, c and pos zeroed, a cache row's pos zeroed so its
    bytes read as unwritten) before the next occupant prefills into them;
  * `submit`, `step` and `cancel(rid)` make the scheduler resumable, as the
    front door (serve/frontdoor.py) drives it; `run()` is a loop over them.

Sampling is per slot (serve/sampler.sample_slots) and counter-based: a
request's token i draws from a hash of (seed, i), so a request's stream is
byte-identical to running it alone through `drive_session`, however it was
batched, chunked or spliced from the prefix cache.  The slot arrays
(pending token, seed, token counter, temperature, top-k, live) live on the
device and change in one place per admission; the host reads the sampled
ids once a tick (one small copy; a speculative round reads its emitted
tokens and counts as one array).

Speculative decoding replaces the tick with a draft-verify-accept round: a
packed draft runtime with its own slot pool proposes `spec_k` tokens a
live slot (spec_k + 1 draft ticks), the fp target verifies them in one
multi-token step, and rejection sampling commits each slot's accepted
prefix in both pools (the RNN's a select over its per-step states, a
transformer's the snapshot's bytes restored past it).  At temperature 0
the streams are those of plain greedy decoding, byte for byte.

With a `PrefixCache` (serve/prefixcache.py), admission splices the longest
cached prompt prefix into the slot (two (L, H) row copies for the RNN, the
prefix's kv columns for a transformer) instead of prefilling it, and every
full chunk that lands offers the slot's state back at its chunk-boundary
offset.

Slot surgery goes through the family's own row helpers: `bnlstm`'s
`rnn_gather_slot`/`rnn_write_slots`/`rnn_reset_slots` for the RNN state,
and `tree_gather_slot`/`tree_write_slot`/`tree_reset_slots` below (JAX's
generic ones, over `AttnCache` nodes and the bare leaves of an
`RWKVState` or `SSMState`) for the transformer caches.

What JAX's engine has and this one does not: jit trace counters
(`tick_traces`, `prefill_traces`, `spec_traces`, `splice_traces`), since
PyTorch runs eagerly and traces nothing; in their place `tick_launches`
counts the kernel calls a tick makes (1 fused tick on a packed RNN, one
packed GEMV a projection on a packed transformer; for a speculative round,
those of its spec_k + 1 draft ticks).  Nor does it pad a prompt's last
chunk to a power-of-two bucket (`declared_buckets`): JAX pads so that its
prefill jit traces once per bucket, and here a pad step would be one more
recurrent step on the device, so every chunk runs at its own length and
`prefill_steps` counts prompt tokens.  `warm()` runs a chunk and a
throwaway request before the clock starts.  Refused: a prefix cache over
ring (sliding-window) caches, whose live window need not start at column
0; and, with JAX's messages, runtimes with `extras` (cross-attention
sources: whisper and the VLM serve in lockstep), speculation and a prefix
cache over a "whole" runtime.

A mesh (`mesh=`, a `DeviceMesh` with JAX's axis names, one process a
device: `launch.mesh.make_serve_mesh`).  The slot pool shards over the
data axes: slot s lives on data shard s // (slots / D), and each rank
holds only its shard's rows (`serve_pool_shardings`' slot axis), so a
tick runs on the shard's slots alone and issues no collective.  On a
model axis above 1 the weights are tensor-parallel (`rt.on_mesh`: DTensors
over the 'model' dims, `serve_prm_shardings`' layouts) and so are the kv
caches' heads (`serve_pool_shardings`' model entries).  Every rank runs
the same scheduler over the same requests (SPMD): a prompt chunk runs on
the data shard that owns its slot, and after each tick the sampled tokens
are all-gathered over the data axes (a first token from its owner), so
every rank retires and admits alike.  That gather is the counterpart of
JAX's host read and lies outside the tick.  `tick_collectives()` replaces
JAX's `tick_hlo` (eager PyTorch compiles no module to read): the
collectives a decode tick issues, counted by `CommDebugMode` on the
first; 0 on a data-only mesh, JAX's assertion on the HLO.  As in JAX,
`slots % D` raises, admission spreads over the shards, `stats()` reports
each shard and the mesh, and a packed tree is refused when the CUDA
kernels are the route (they are single-device launches); on the CPU it
serves through the plain versions with its codes sharded.  A prefix cache
serves a mesh as JAX's does: an entry is the batch-1 state of a slot
copied on the rank that owns it and broadcast over the data axes
(`_from_owner`; a tensor-parallel state's shard over 'model' stays each
rank's), so every rank holds the same entry, and a splice writes it into
the owning shard's pool alone.  Every rank runs the same scheduler, so
lookups, insertions and evictions happen alike on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch.core import bnlstm as BL
from repro_torch.core.qtensor import (is_qtensor, tree_leaves, tree_map,
                                      tree_map_with_path)
from repro_torch.kernels import dispatch
from repro_torch.launch import sharding as S
from repro_torch.runtime import axis_sizes
from repro_torch.serve.kvcache import (AttnCache, cache_gather_slot,
                                       cache_reset_slots, cache_write_slot,
                                       same_bytes)
from repro_torch.serve.prefixcache import narrow_state, widen_state
from repro_torch.serve.sampler import DRAFT, sample_slots, spec_accept


@dataclasses.dataclass
class Request:
    """One generation request.  `arrival_s` is the submit time relative to
    engine start (0 = already queued); latency is measured against it.

    `priority` orders admission (lower first; ties by arrival, then submit
    order); a running request is never preempted.  `slo` is a reporting
    label: TTFT percentiles are broken out by it.  `seed` is taken mod
    2^32."""

    prompt: Any                  # (S,) int token ids (list / numpy / tensor)
    max_tokens: int
    temperature: float = 0.8
    top_k: int = 0
    seed: int = 0
    arrival_s: float = 0.0
    priority: int = 0
    slo: str = "default"
    rid: Optional[int] = None    # numbered by the engine when None (the
                                 # Request itself is never mutated)


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: List[int]            # sampled ids, EOS included when hit
    prompt_len: int
    finished: str                # 'length' | 'eos' | 'cancelled'
    slot: int
    t_submit: float              # engine-relative seconds
    t_admit: float               # slot allocated; prefill starts after this
    t_first: float               # the first token was sampled: real TTFT
    t_done: float
    cached_tokens: int = 0       # prompt tokens a prefix-cache splice skipped
    slo: str = "default"

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    @property
    def queue_s(self) -> float:
        return self.t_admit - self.t_submit

    @property
    def ttft_s(self) -> float:
        return self.t_first - self.t_submit


@dataclasses.dataclass
class _Active:
    req: Request
    rid: int
    tokens: List[int]
    t_submit: float
    t_admit: float
    t_first: Optional[float]
    chunks: Deque[np.ndarray]  # the prompt chunks still to run
    prompt: np.ndarray  # the whole prompt (prefix-cache keys slice it)
    off: int            # prompt tokens consumed so far, spliced included
    cached: int         # tokens a prefix-cache splice made unnecessary


# ---------------------------------------------------------------------------
# generic slot surgery over transformer state trees
# ---------------------------------------------------------------------------


def _slot_axis(path: tuple) -> int:
    """The slot axis of a bare leaf of the transformer cache tree (an
    `RWKVState` or `SSMState` field): 1 under "stack" (after the layer
    axis), 0 under "tail"."""
    if not path or path[0] not in ("stack", "tail"):
        raise TypeError(f"a transformer state is a stack/tail tree of "
                        f"attention caches and recurrent states, got a "
                        f"leaf at {'/'.join(path)!r}")
    return 1 if path[0] == "stack" else 0


def tree_write_slot(pool, sub, slot: int):
    """Copy a batch-1 state tree into row `slot` of every pool node, in
    place (`kvcache.cache_write_slot` for attention caches, a row copy for
    bare leaves), and return the pool.  A row that is already the pool's
    own view is not copied onto itself."""
    def write(path, p, s):
        if isinstance(p, AttnCache):
            return cache_write_slot(p, s, slot)
        row = p.narrow(_slot_axis(path), slot, 1)
        if not same_bytes(row, s):
            row.copy_(s.reshape(row.shape))
        return p
    return tree_map_with_path(write, pool, sub)


def tree_gather_slot(pool, slot: int):
    """Row `slot` of every pool node as a batch-1 state tree of views (the
    read half of in-slot chunked prefill); `tree_write_slot` of it is the
    identity."""
    return tree_map_with_path(
        lambda path, p: (cache_gather_slot(p, slot) if isinstance(p, AttnCache)
                         else p.narrow(_slot_axis(path), slot, 1)), pool)


def tree_reset_slots(pool, slots: Sequence[int]):
    """Scrub rows `slots` so a freed slot reads like a fresh one: an
    attention cache keeps its bytes and drops the rows' pos to 0; a bare
    recurrent leaf (S, shifts, pos) drops to zero.  In place."""
    def scrub(path, p):
        if isinstance(p, AttnCache):
            return cache_reset_slots(p, slots)
        for s in slots:
            p.narrow(_slot_axis(path), s, 1).zero_()
        return p
    return tree_map_with_path(scrub, pool)


def _clone(state):
    """A copy of a (gathered) state: the pool row changes in place."""
    return tree_map(lambda x: x._replace(k=x.k.clone(), v=x.v.clone(),
                                         pos=x.pos.clone())
                    if isinstance(x, AttnCache) else x.clone(), state)


def _tick_calls() -> int:
    """Kernel calls so far: launches on the card, plain-version calls on
    the CPU."""
    return sum(dispatch.LAUNCHES.values()) + sum(dispatch.PLAIN_CALLS.values())


class ServeEngine:
    """Slotted continuous-batching scheduler over one serving runtime.

    eng = ServeEngine(rt, vocab, slots=8, max_context=512, prefill_chunk=32)
    completions, metrics = eng.run(requests)

    or, resumably (the front door's way):

    rid = eng.submit(Request(...))
    while eng.has_work():
        token_events, completions = eng.step()   # [(rid, [ids])], [Completion]
    eng.cancel(rid)                              # any time, any phase

    Speculative mode pairs the fp target with its packed draft:

    eng = ServeEngine(rt, vocab, slots=8, max_context=512,
                      draft=speculative_draft(rt), spec_k=4)

    Invariants:
      * mask, don't reshape: the pool and the slot arrays keep shape (B, ...)
        for the engine's life; occupancy is the `live` mask;
      * no head-of-line blocking: at most one prefill chunk runs between
        decode ticks (`max_decode_stall_ticks` <= 1);
      * a request's stream depends only on (prompt, seed, temperature,
        top-k), never on its slot, its neighbours, its chunking, a prefix
        splice or cancelled neighbours.
    """

    def __init__(self, rt, vocab: int, *, slots: int, max_context: int,
                 eos_id: Optional[int] = None, prefill_chunk: int = 32,
                 draft=None, spec_k: int = 0, prefix_cache=None, mesh=None):
        if getattr(rt, "extras", None):
            raise NotImplementedError(
                "continuous batching over cross-attention runtimes (vlm/"
                "audio) needs per-request source encodings; the engine "
                "currently schedules self-attention and recurrent archs")
        family = getattr(rt, "family", None)
        if family not in ("rnn", "transformer"):
            raise NotImplementedError(
                f"the engine schedules the serving runtimes of "
                f"serve/recurrent.py (the RNN's and the transformer "
                f"pool's), as JAX's does; a {family} runtime has none of "
                f"their slot hooks")
        whole = getattr(rt, "chunk_granularity", "token") == "whole"
        if prefix_cache is not None and whole:
            raise NotImplementedError(
                "prefix-state caching needs token-granularity chunked "
                "prefill and (for attention archs) non-ring caches — the "
                "§8 bit-exact chunk-boundary contract is what makes a "
                "spliced prefix byte-identical to re-prefilling it")
        if prefix_cache is not None and getattr(rt, "ring_caches", False):
            raise ValueError("a prefix cache needs non-ring caches: a ring's "
                             "live window need not start at column 0")
        if slots < 1:
            raise ValueError("need at least one slot")
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if (draft is None) != (spec_k == 0) or spec_k < 0:
            raise ValueError("speculative mode needs BOTH a draft runtime "
                             "and spec_k >= 1 (got draft="
                             f"{'set' if draft is not None else 'None'}, "
                             f"spec_k={spec_k})")
        if spec_k > 64:
            raise ValueError(f"spec_k={spec_k} is past the supported draft "
                             "span (64); acceptance decays geometrically")
        if draft is not None:
            if not (getattr(rt, "spec_capable", False)
                    and getattr(draft, "spec_capable", False)):
                raise NotImplementedError(
                    "speculative decoding needs an exactly-rollbackable "
                    "multi-token step on both runtimes: RNN families and "
                    "pure-attention non-ring archs qualify; ring-cache, "
                    "MoE and rwkv/mamba runtimes do not (DESIGN.md §9)")
            if getattr(draft, "family", None) != rt.family:
                raise ValueError("draft and target must be the same serving "
                                 "family: self-speculation pairs a packed "
                                 "export with its own fp masters")
            if draft.device != rt.device:
                raise ValueError(f"draft on {draft.device}, target on "
                                 f"{rt.device}")
        self.mesh = mesh
        self._data_shards, self._shard = 1, 0
        self._data_dims: Tuple[str, ...] = ()
        if mesh is not None:
            sizes = axis_sizes(mesh)
            if rt.device.type == "cuda" and any(
                    is_qtensor(l) for r in (rt, draft) if r is not None
                    for l in tree_leaves(getattr(r, "params", None) or
                                         r.variables["params"])):
                raise NotImplementedError(
                    "mesh-sharded serving of packed trees runs through the "
                    "plain versions (CPU) — the packed CUDA kernels are "
                    "single-device launches; their sharded port is the "
                    "ROADMAP item")
            self._data_dims = tuple(a for a in S.DATA_AXES
                                    if sizes.get(a, 1) > 1)
            D = int(np.prod([sizes[a] for a in self._data_dims]))
            if slots % D:
                raise ValueError(
                    f"slots={slots} must split evenly over the mesh's {D} "
                    f"data shard(s) — the slot pool shards along 'data'")
            coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
            for a in self._data_dims:
                self._shard = self._shard * sizes[a] + coord[a]
            self._data_shards = D
            rt = rt.on_mesh(mesh)
            draft = draft.on_mesh(mesh) if draft is not None else None
        self.rt = rt
        self.device = rt.device
        if family == "rnn":
            self._slot_row, self._write, self._reset = (
                BL.rnn_gather_slot, BL.rnn_write_slots, BL.rnn_reset_slots)
        else:
            self._slot_row, self._write, self._reset = (
                tree_gather_slot, tree_write_slot, tree_reset_slots)
        self.vocab = int(vocab)
        self.n_slots = int(slots)
        self.max_context = int(max_context)
        self.eos_id = eos_id
        self.prefill_chunk = int(prefill_chunk)
        self.whole_prompt = whole

        self.prefix_cache = prefix_cache
        if prefix_cache is not None:
            prefix_cache.bind(self.prefill_chunk)

        # this rank's slots: [lo, lo + per) of the pool (all of them
        # without a mesh); every per-slot device array holds those rows
        B = self._per = self.n_slots // self._data_shards
        self._lo = self._shard * B
        self.pool = self._local_pool(rt)
        self.draft = draft
        self.spec_k = int(spec_k)
        self.spec = draft is not None
        if self.spec:
            self.draft_pool = self._local_pool(draft)
        self.tick_collective_count = -1
        dev = self.device
        self._pending = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._live = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._seed = torch.zeros((B,), dtype=torch.int64, device=dev)
        self._count = torch.zeros((B,), dtype=torch.int64, device=dev)
        self._temp = torch.ones((B,), dtype=torch.float32, device=dev)
        self._topk = torch.zeros((B,), dtype=torch.int64, device=dev)
        # the host's view of every slot, the same on every rank
        self._live_host = np.zeros(self.n_slots, bool)
        self._active: List[Optional[_Active]] = [None] * self.n_slots
        self._prefill_q: Deque[int] = deque()   # slots mid-prefill, FIFO
        self._rid = 0
        # the admission queue: a heap of (priority, arrival_s, submit seq,
        # rid, request); a cancelled queued rid is dropped when it surfaces
        self._heap: List[Tuple[int, float, int, int, Request]] = []
        self._seq = 0
        self._queued_rids: Set[int] = set()
        self._cancel_pending: Set[int] = set()
        self._t0 = time.perf_counter()

        self.ticks = 0
        self.tick_launches = -1   # kernel calls of the last tick
        self.prefill_chunks = 0   # prompt chunks run
        self.prefill_steps = 0    # prompt tokens they ran
        self._occupancy_sum = 0.0
        self._gen_tokens = 0
        self._drafted = 0
        self._accepted = 0
        # chunks an admission ran since the last decode tick while live
        # decodes waited: the scheduler holds it to one
        self._stall_pending: Dict[int, int] = {}
        self._stall_max = 0

    # -- the mesh: this rank's rows, the data-axis gather ---------------------

    def _local_pool(self, rt):
        """This rank's rows of a slot pool: `per` slots; on a model axis
        above 1 the kv heads sharded over it (`serve_pool_shardings`' model
        entries, the data axes dropped: the rank holds its slots whole)."""
        pool = rt.init_state(self._per, self.max_context, per_slot=True)
        if getattr(rt, "tp_mesh", None) is None:
            return pool
        ref = rt.init_state(1, self.max_context, per_slot=True)
        lay = S.drop_data(pool, S.serve_pool_shardings(pool, ref, self.mesh))
        return S.distribute(pool, lay, rt.tp_mesh)

    def _local(self, slot: int) -> Optional[int]:
        """The row of global `slot` in this rank's pool, None when another
        data shard owns it."""
        i = slot - self._lo
        return i if 0 <= i < self._per else None

    def _gather_data(self, t: torch.Tensor) -> torch.Tensor:
        """The data shards' rows of `t` (this rank's (per, ...)) in slot
        order, on every rank: one all-gather a data axis, the inner axis
        first (slot s of shard p * D_data + d).  Without data shards, `t`."""
        for a in reversed(self._data_dims):
            group = self.mesh.get_group(a)
            parts = [torch.empty_like(t) for _ in range(dist.get_world_size(
                group))]
            dist.all_gather(parts, t.contiguous(), group=group)
            t = torch.cat(parts)
        return t

    def _from_owner(self, state, slot: int):
        """`state` (a copied slot state, a DTensor's local shard on a
        tensor-parallel runtime) broadcast over the data axes from the
        data shard that owns `slot`, in place: every rank then holds the
        owner's bytes (one broadcast a data axis, the inner axis first, as
        `_gather_data`).  Without data shards, `state`."""
        if not self._data_dims:
            return state
        sizes, shard, src = axis_sizes(self.mesh), slot // self._per, {}
        for a in reversed(self._data_dims):
            shard, src[a] = divmod(shard, sizes[a])

        def bcast(t):
            t = t.to_local() if isinstance(t, DTensor) else t
            for a in reversed(self._data_dims):
                group = self.mesh.get_group(a)
                dist.broadcast(t, src=dist.get_global_rank(group, src[a]),
                               group=group)
        for leaf in tree_leaves(state):
            if isinstance(leaf, AttnCache):
                for t in (leaf.k, leaf.v, leaf.pos):
                    bcast(t)
            else:
                bcast(leaf)
        return state

    def _agreed(self, now: float) -> float:
        """On a mesh of several ranks, the latest of the ranks' clocks (one
        all-reduce a mesh dim), so every rank sees the same arrivals and
        admits alike; `now` itself otherwise."""
        if self.mesh is None or self.mesh.size() == 1:
            return now
        t = torch.tensor([now], dtype=torch.float64,
                         device=self.mesh.device_type)
        for a in self.mesh.mesh_dim_names:
            dist.all_reduce(t, op=dist.ReduceOp.MAX,
                            group=self.mesh.get_group(a))
        return float(t.item())

    # -- clock and transfers -------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host ids to the device: through pinned memory on the card, so the
        copy queues behind the device's work instead of waiting for it."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- admission -----------------------------------------------------------

    def _validate(self, req: Request) -> None:
        prompt = np.asarray(req.prompt).reshape(-1)
        if prompt.size == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_tokens < 1:
            raise ValueError(f"request {req.rid}: max_tokens must be >= 1 "
                             f"(got {req.max_tokens}): the last prompt "
                             f"chunk always samples the first token")
        if prompt.size + req.max_tokens > self.max_context:
            raise ValueError(
                f"request {req.rid}: needs {prompt.size}+{req.max_tokens} "
                f"tokens; engine provisioned max_context={self.max_context}")
        if prompt.min() < 0 or prompt.max() >= self.vocab:
            raise ValueError(f"request {req.rid}: token ids must lie in "
                             f"[0, {self.vocab})")

    @torch.no_grad()
    def warm(self) -> None:
        """Run one full chunk through slot 0, scrub it, and drain one
        throwaway request (admission, first-token sample, a tick), so a
        measured run starts with the kernels loaded and the allocator
        warm.  Eager PyTorch compiles nothing per chunk length, so one
        length warms them all."""
        self._run_chunk(np.zeros(self.prefill_chunk, np.int64), 0)
        self._scrub([0])
        n = min(2, self.max_context - 1)
        if n >= 1:
            self.run([Request(prompt=np.zeros(1, np.int32), max_tokens=n,
                              temperature=1.0, top_k=0, seed=0, rid=-1)],
                     realtime=False)

    def _free_slot(self) -> Optional[int]:
        # a prefilling slot is busy too: occupancy is "has an _Active"
        busy = np.array([a is not None for a in self._active])
        idle = np.flatnonzero(~busy)
        if not idle.size:
            return None
        if self._data_shards <= 1:
            return int(idle[0])
        # a mesh: spread admissions over the data shards (slot s lives on
        # shard s // per), so a half-empty pool decodes on every shard;
        # the slot never changes a request's bytes
        occ = busy.reshape(self._data_shards, self._per).sum(axis=1)
        return int(min(idle, key=lambda s: (occ[s // self._per], int(s))))

    # -- the resumable scheduling API -----------------------------------------

    def submit(self, req: Request) -> int:
        """Queue one request; returns its rid (the handle of `cancel` and the
        step events).  Admitted in priority order as slots free."""
        self._validate(req)
        rid = self._rid if req.rid is None else req.rid
        self._rid = max(self._rid, rid) + 1
        heapq.heappush(self._heap,
                       (req.priority, req.arrival_s, self._seq, rid, req))
        self._seq += 1
        self._queued_rids.add(rid)
        return rid

    def cancel(self, rid: int) -> Optional[Completion]:
        """Retire `rid` wherever it is: queued (dropped before it touches a
        slot), mid-prefill or mid-decode (the slot is scrubbed as on
        retirement, so nothing leaks into its next occupant).  Returns a
        'cancelled' Completion with the tokens streamed so far, or None for
        an unknown or finished rid."""
        for slot, act in enumerate(self._active):
            if act is not None and act.rid == rid:
                now = self._now()
                if slot in self._prefill_q:
                    self._prefill_q.remove(slot)
                    self._stall_pending.pop(rid, None)
                comp = self._completion(act, slot, now, finished="cancelled")
                self._retire(slot)
                self._scrub([slot])
                return comp
        if rid in self._queued_rids:
            self._queued_rids.discard(rid)
            self._cancel_pending.add(rid)
            req = next(r for (_, _, _, hr, r) in self._heap if hr == rid)
            now = self._now()
            return Completion(
                rid=rid, tokens=[],
                prompt_len=int(np.asarray(req.prompt).size),
                finished="cancelled", slot=-1, t_submit=req.arrival_s,
                t_admit=now, t_first=now, t_done=now, slo=req.slo)
        return None

    def has_work(self) -> bool:
        """True while a `step()` could make progress."""
        return bool(self._heap or self._prefill_q or self._live_host.any())

    @torch.no_grad()
    def step(self) -> Tuple[List[Tuple[int, List[int]]], List[Completion]]:
        """One scheduler iteration: admit queued requests into free slots
        (priority order), run at most one prefill chunk, run one batched
        decode tick (or speculative round), retire and scrub.

        Returns (token_events, completions): (rid, [ids sampled this
        iteration]) in stream order, and the requests finished."""
        while self._heap:
            slot = self._free_slot()
            if slot is None:
                break
            _, _, _, rid, req = heapq.heappop(self._heap)
            if rid in self._cancel_pending:
                self._cancel_pending.discard(rid)
                continue
            self._queued_rids.discard(rid)
            self._admit(req, rid, slot, self._now())

        retired: List[int] = []
        events: List[Tuple[int, List[int]]] = []
        comps: List[Completion] = []

        if self._prefill_q:  # at most one chunk, before the tick
            act0 = self._active[self._prefill_q[0]]
            if self._live_host.any():
                self._stall_pending[act0.rid] = \
                    self._stall_pending.get(act0.rid, 0) + 1
            sampled, comp, slot = self._prefill_step()
            if sampled:
                self._gen_tokens += sampled
                events.append((act0.rid, [act0.tokens[-1]]))
            if comp is not None:
                comps.append(comp)
                retired.append(slot)

        if not self._live_host.any():
            if retired:
                self._scrub(retired)
            return events, comps

        spec_out = self._spec_round() if self.spec else self._tick()
        self.ticks += 1
        if self._stall_pending:
            self._stall_max = max(self._stall_max,
                                  max(self._stall_pending.values()))
            self._stall_pending.clear()
        n_live = int(self._live_host.sum())
        self._occupancy_sum += (n_live + len(self._prefill_q)) / self.n_slots

        # the one device-to-host read of the tick (on a mesh, of every data
        # shard's rows: the gather lies outside the tick)
        out_host = self._gather_data(spec_out).cpu().numpy()
        now = self._now()
        for slot in np.flatnonzero(self._live_host):
            act = self._active[slot]
            if self.spec:
                take = int(out_host[slot, -1])
                self._drafted += self.spec_k
                self._accepted += max(take - 1, 0)
                row = out_host[slot, :take]
            else:
                row = out_host[slot:slot + 1]
            emitted: List[int] = []
            done = False
            for tok in row:
                act.tokens.append(int(tok))
                emitted.append(int(tok))
                self._gen_tokens += 1
                hit_eos = self.eos_id is not None and int(tok) == self.eos_id
                if hit_eos or len(act.tokens) >= act.req.max_tokens:
                    done = True  # a round's overshoot dies with the scrub
                    break
            events.append((act.rid, emitted))
            if done:
                comps.append(self._completion(act, int(slot), now))
                self._retire(int(slot))
                retired.append(int(slot))
        if retired:
            self._scrub(retired)
        return events, comps

    # -- the device work -----------------------------------------------------

    def _device(self, tick: bool = False):
        """The context of device work: a tensor-parallel runtime's mesh
        context, and on a mesh's first tick `CommDebugMode`, which counts
        its collectives (`tick_collectives`)."""
        stack = contextlib.ExitStack()
        stack.enter_context(self.rt.mesh_context())
        self._comm = None
        if tick and self.mesh is not None and self.tick_collective_count < 0:
            self._comm = stack.enter_context(CommDebugMode())
        return stack

    def tick_collectives(self) -> int:
        """The collectives a decode tick (or speculative round) issues,
        counted by `CommDebugMode` on the engine's first; -1 before it.
        Every tick runs the same ops over the whole pool (dead rows are
        masked, never resliced), so one count holds for all, and the
        dispatch mode that counts stays off the later ticks.  This replaces
        JAX's `tick_hlo`: eager PyTorch compiles no module whose
        collectives could be read.  0 on a data-only mesh (rows are
        independent and the weights whole on every rank), JAX's assertion
        on the HLO; a tensor-parallel tick reduces over 'model'."""
        return self.tick_collective_count

    def _logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Logits whole on this rank (a tensor-parallel head's are a
        DTensor over 'model')."""
        return S.full(logits)

    def _tick(self) -> torch.Tensor:
        """One batched decode tick over this rank's slots, dead ones
        frozen; dead slots keep their pending token and counter.  Returns
        the pending tokens (per,)."""
        calls = _tick_calls()
        with self._device(tick=True):
            logits, self.pool = self.rt.decode_fn(self._pending, self.pool,
                                                  self._live)
            logits = self._logits(logits)
        self._count_collectives()
        self.tick_launches = _tick_calls() - calls
        nxt = sample_slots(logits, self._seed, self._count,
                           temperature=self._temp, top_k=self._topk,
                           vocab=self.vocab)
        self._pending = torch.where(self._live, nxt, self._pending)
        self._count = self._count + self._live
        return self._pending

    def _count_collectives(self) -> None:
        if self._comm is not None:
            self.tick_collective_count = self._comm.get_total_counts()

    def _spec_round(self) -> torch.Tensor:
        """One draft-verify-accept round over every live slot:

          1. the packed draft proposes spec_k tokens a slot: spec_k + 1
             batched draft ticks (the last one advances the draft through
             its own last proposal, so a fully accepted round leaves it in
             step), proposal k drawn at token counter count + k;
          2. the target verifies all of them in one multi-token step;
          3. `spec_accept` runs the rejection rule per slot;
          4. both pools commit each slot's accepted prefix (the RNN a
             select over the per-step states, a transformer's caches the
             snapshot's bytes restored past it).

        Dead slots stay frozen: masked in every tick, accepted count forced
        to 0 (the commit keeps their rows), pending and counter unmoved.
        Returns (B, spec_k + 2): emitted tokens, the count last."""
        K = self.spec_k
        live, pending = self._live, self._pending
        samp = dict(temperature=self._temp, top_k=self._topk,
                    vocab=self.vocab)
        calls = _tick_calls()
        with self._device(tick=True):
            out = self._spec_work(K, live, pending, samp, calls)
        self._count_collectives()
        return out

    def _spec_work(self, K, live, pending, samp, calls) -> torch.Tensor:
        dsnap = self.draft.spec_snapshot(self.draft_pool, K + 1)
        dst, tok = self.draft_pool, pending
        qlg, dtoks, dem = [], [], []
        for k in range(K + 1):
            lg, dst = self.draft.decode_fn(tok, dst, live)
            lg = self._logits(lg)
            nxt = sample_slots(lg, self._seed, self._count + k, stream=DRAFT,
                               **samp)
            tok = torch.where(live, nxt, tok)
            qlg.append(lg)
            dtoks.append(tok)
            dem.append(self.draft.spec_emit(dst))
        self.tick_launches = _tick_calls() - calls
        drafts = torch.stack(dtoks[:K], dim=1)              # (B, K)
        q_logits = torch.stack(qlg[:K], dim=1)              # (B, K, V)
        demits = tuple(torch.stack(e) for e in zip(*dem))

        vtokens = torch.cat([pending[:, None], drafts], dim=1)
        vsnap = self.rt.spec_snapshot(self.pool, K + 1)
        p_logits, vafter, vemits = self.rt.verify(vtokens, self.pool, live)
        p_logits = self._logits(p_logits)
        n_acc, out = spec_accept(p_logits, q_logits, drafts, self._seed,
                                 self._count, **samp)
        n_acc = torch.where(live, n_acc, torch.zeros_like(n_acc))
        self.pool = self.rt.spec_commit(self.pool, vafter, vsnap, vemits,
                                        n_acc)
        self.draft_pool = self.draft.spec_commit(self.draft_pool, dst, dsnap,
                                                 demits, n_acc)
        last = (n_acc.long() - 1).clamp_min(0)[:, None]
        self._pending = torch.where(live, out.gather(1, last)[:, 0], pending)
        self._count = self._count + n_acc
        return torch.cat([out, n_acc[:, None]], dim=1)

    def _run_chunk(self, chunk: np.ndarray, slot: int):
        """One in-slot prefill chunk (both pools in speculative mode):
        gather the slot row, run the chunk, write the row back.  Returns
        the first-token logits (1, V); None on a rank whose data shard
        does not own the slot (it runs nothing)."""
        self.prefill_chunks += 1
        self.prefill_steps += int(chunk.size)
        row = self._local(slot)
        if row is None:
            return None
        tokens = self._upload(chunk)[None]
        with self.rt.mesh_context():
            sub = self._slot_row(self.pool, row)
            logits, sub = self.rt.prefill_chunk(tokens, sub)
            self._write(self.pool, sub, row)
            if self.spec:
                dsub = self._slot_row(self.draft_pool, row)
                _, dsub = self.draft.prefill_chunk(tokens, dsub)
                self._write(self.draft_pool, dsub, row)
            return self._logits(logits)

    def _admit_commit(self, logits: torch.Tensor, req: Request,
                      slot: int) -> int:
        """The request's first token (counter 0) and every slot-array write
        its admission needs, in one place; returns the token (the one read
        of an admission)."""
        dev = self.device
        seed = int(req.seed) & 0xFFFFFFFF
        row = self._local(slot)
        tok = torch.full((1,), -1, dtype=torch.int32, device=dev)
        if row is not None:
            t = torch.full((1,), float(req.temperature), device=dev)
            k = torch.full((1,), int(req.top_k), dtype=torch.int64,
                           device=dev)
            tok = sample_slots(logits, seed, 0, temperature=t, top_k=k,
                               vocab=self.vocab).to(torch.int32)
            self._pending[row] = tok[0]
            self._seed[row] = seed
            self._count[row] = 1
            self._temp[row] = float(req.temperature)
            self._topk[row] = int(req.top_k)
            self._live[row] = True
        if self._data_shards > 1:  # the owner's token, on every rank
            tok = self._gather_data(tok)[slot // self._per:][:1]
        return int(tok[0])

    # -- internals -----------------------------------------------------------

    def _admit(self, req: Request, rid: int, slot: int, now: float) -> None:
        """Bookkeeping plus, with a prefix cache, at most one splice of the
        longest cached prompt prefix (capped at size-1: the last chunk must
        run, since it samples the first token); the rest of the prompt is
        split into chunks and the slot queued for prefill."""
        prompt = np.asarray(req.prompt).reshape(-1).astype(np.int32)
        cached = 0
        if self.prefix_cache is not None:
            cached, entry = self.prefix_cache.lookup(prompt)
            if entry is not None and self.spec and entry.draft_state is None:
                # stored by a plain engine: no draft half to keep in step
                cached, entry = 0, None
            row = self._local(slot)  # the owning data shard splices
            if entry is not None and row is not None:
                with self.rt.mesh_context():
                    self._write(self.pool, widen_state(entry.state,
                                                       self.pool), row)
                    if self.spec:
                        self._write(self.draft_pool,
                                    widen_state(entry.draft_state,
                                                self.draft_pool), row)
        C = prompt.size if self.whole_prompt else self.prefill_chunk
        chunks = deque(prompt[i:i + C].astype(np.int64)
                       for i in range(cached, prompt.size, C))
        self._active[slot] = _Active(
            req=req, rid=rid, tokens=[], t_submit=req.arrival_s,
            t_admit=now, t_first=None, chunks=chunks, prompt=prompt,
            off=cached, cached=cached)
        self._prefill_q.append(slot)

    def _offer_snapshot(self, slot: int, act: _Active) -> None:
        """Offer the slot's state at the chunk boundary it just reached to
        the prefix cache: a copy (the pool row changes in place) of only the
        written history (`narrow_state`)."""
        prefix = act.prompt[:act.off]
        if self.prefix_cache.contains(prefix):
            return
        row = self._local(slot)
        with self.rt.mesh_context():
            # a rank of another data shard copies a row of its own as the
            # buffer the owner's bytes are broadcast into
            keep = lambda pool: self._from_owner(_clone(narrow_state(
                self._slot_row(pool, 0 if row is None else row), act.off)),
                slot)
            sub = keep(self.pool)
            dsub = keep(self.draft_pool) if self.spec else None
        self.prefix_cache.insert(prefix, sub, dsub)

    def _prefill_step(self):
        """Run one chunk of the oldest prefilling slot.  When its last chunk
        lands, sample the first token (stamping `t_first`) and turn the slot
        live, or complete it (max_tokens == 1, or EOS).  Returns
        (n_sampled, completion, retired slot)."""
        slot = self._prefill_q[0]
        act = self._active[slot]
        chunk = act.chunks.popleft()
        logits = self._run_chunk(chunk, slot)
        act.off += chunk.size
        if (self.prefix_cache is not None and chunk.size == self.prefill_chunk
                and act.off % self.prefill_chunk == 0):
            self._offer_snapshot(slot, act)
        if act.chunks:
            return 0, None, None
        self._prefill_q.popleft()
        act.tokens.append(self._admit_commit(logits, act.req, slot))
        act.t_first = self._now()
        if (act.req.max_tokens <= 1
                or (self.eos_id is not None and act.tokens[0] == self.eos_id)):
            # done at admission: the caller's scrub clears the device live
            # bit this same iteration
            comp = self._completion(act, slot, act.t_first)
            self._active[slot] = None
            return 1, comp, slot
        self._live_host[slot] = True
        return 1, None, None

    def _completion(self, act: _Active, slot: int, now: float,
                    finished: Optional[str] = None) -> Completion:
        if finished is None:
            hit_eos = (self.eos_id is not None and act.tokens
                       and act.tokens[-1] == self.eos_id)
            finished = "eos" if hit_eos else "length"
        return Completion(
            rid=act.rid, tokens=act.tokens, prompt_len=int(act.prompt.size),
            finished=finished, slot=slot, t_submit=act.t_submit,
            t_admit=act.t_admit,
            t_first=act.t_first if act.t_first is not None else act.t_admit,
            t_done=now, cached_tokens=act.cached, slo=act.req.slo)

    def _retire(self, slot: int) -> None:
        # host bookkeeping; the device side clears in the iteration's scrub
        self._active[slot] = None
        self._live_host[slot] = False

    def _scrub(self, slots: Sequence[int]) -> None:
        """Scrub the freed slots' rows (both pools in speculative mode) and
        clear their device live bits: the next occupant prefills into the
        row, so it must read like a fresh one."""
        rows = [r for r in map(self._local, slots) if r is not None]
        if not rows:
            return
        self._reset(self.pool, rows)
        if self.spec:
            self._reset(self.draft_pool, rows)
        for r in rows:
            self._live[r] = False

    # -- stats (the front door's /v1/stats) ----------------------------------

    def stats(self) -> dict:
        """Engine-lifetime counters, as a serving fleet scrapes them."""
        busy = sum(a is not None for a in self._active)
        d = {
            "slots": self.n_slots,
            "active": busy,
            "queued": len(self._queued_rids),
            "queue_depth": len(self._queued_rids),
            "ticks": self.ticks,
            "gen_tokens": self._gen_tokens,
            "tick_launches": self.tick_launches,
            "prefill_chunks": self.prefill_chunks,
            "prefill_steps": self.prefill_steps,
            "max_decode_stall_ticks": self._stall_max,
        }
        # per-shard occupancy (the queue is global: one heap feeds every
        # shard); an engine without a mesh is one shard
        per = self._per
        act = [a is not None for a in self._active]
        d["shards"] = [{"shard": i, "slots": per,
                        "active": int(sum(act[i * per:(i + 1) * per])),
                        "occupancy": sum(act[i * per:(i + 1) * per]) / per}
                       for i in range(self._data_shards)]
        if self.mesh is not None:
            d["mesh"] = {str(a): int(n)
                         for a, n in axis_sizes(self.mesh).items()}
            d["tick_collectives"] = self.tick_collective_count
        if self.spec:
            d.update({"drafted_tokens": self._drafted,
                      "accepted_drafts": self._accepted})
        if self.prefix_cache is not None:
            d["prefix_cache"] = self.prefix_cache.stats()
        return d

    # -- the batch loop ------------------------------------------------------

    def run(self, requests: Sequence[Request], *, realtime: bool = True):
        """Drive a workload to completion.  Returns (completions, metrics).

        `realtime=True` honours `arrival_s` against the wall clock (a
        request is invisible until it arrives); `realtime=False` treats
        arrivals as an admission order only.  A loop over `submit()` and
        `step()`: the batch loop and the front door run one scheduler."""
        for r in requests:  # fail before any request is in flight
            self._validate(r)
        arrivals = deque(sorted(requests, key=lambda r: r.arrival_s))
        completions: List[Completion] = []
        self._t0 = time.perf_counter()
        gen0, ticks0, occ0 = self._gen_tokens, self.ticks, self._occupancy_sum
        drafted0, accepted0 = self._drafted, self._accepted
        self._stall_pending.clear()
        self._stall_max = 0

        while (arrivals or self._heap or self._prefill_q
               or self._live_host.any()):
            now = self._agreed(self._now())
            while arrivals and (not realtime or arrivals[0].arrival_s <= now):
                self.submit(arrivals.popleft())
            _, comps = self.step()
            completions.extend(comps)
            if (not self._prefill_q and not self._live_host.any()
                    and not self._heap and arrivals and realtime):
                wait = arrivals[0].arrival_s - self._now()
                if wait > 0:
                    time.sleep(min(wait, 0.05))

        if self._stall_pending:  # prefill work after the last decode tick
            self._stall_max = max(self._stall_max,
                                  max(self._stall_pending.values()))
            self._stall_pending.clear()

        wall = time.perf_counter() - self._t0
        gen_tokens = self._gen_tokens - gen0
        ticks = self.ticks - ticks0
        occ = self._occupancy_sum - occ0
        lat = sorted(c.latency_s for c in completions)
        ttft = sorted(c.ttft_s for c in completions)
        pct = lambda xs, p: (xs[min(len(xs) - 1, int(p * len(xs)))]
                             if xs else 0.0)
        by_cls: Dict[str, List[float]] = {}
        for c in completions:
            by_cls.setdefault(c.slo, []).append(c.ttft_s)
        metrics = {
            "requests": len(completions),
            "wall_s": wall,
            "gen_tokens": gen_tokens,
            "agg_tok_s": gen_tokens / wall if wall > 0 else 0.0,
            "p50_latency_s": pct(lat, 0.50),
            "p95_latency_s": pct(lat, 0.95),
            "ttft_p50_s": pct(ttft, 0.50),
            "ttft_p95_s": pct(ttft, 0.95),
            "ttft_by_class": {
                cls: {"n": len(v), "p50_s": pct(sorted(v), 0.50),
                      "p95_s": pct(sorted(v), 0.95)}
                for cls, v in sorted(by_cls.items())},
            "max_decode_stall_ticks": self._stall_max,
            "ticks": ticks,
            "tick_launches": self.tick_launches,
            "occupancy": occ / ticks if ticks else 0.0,
        }
        if self.spec:
            drafted = self._drafted - drafted0
            accepted = self._accepted - accepted0
            metrics.update({
                "spec_k": self.spec_k,
                "spec_rounds": ticks,
                "drafted_tokens": drafted,
                "accepted_drafts": accepted,
                "accept_rate": accepted / drafted if drafted else 0.0,
                "draft_tok_s": drafted / wall if wall > 0 else 0.0,
            })
        if self.prefix_cache is not None:
            metrics["prefix_cache"] = self.prefix_cache.stats()
        return completions, metrics
