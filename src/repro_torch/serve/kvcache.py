"""KV caches for serving, full and ring buffer (sliding window), and the
cross-attention cache, ported from `repro/serve/kvcache.py`.

Layout on a mesh (`kv_pspec`): the batch axis over ('pod', 'data'), the KV
heads over 'model' where they divide, else the sequence axis over 'model'
(a length-sharded cache, which each rank writes in its own range:
`_write`).  `constrain_cache` redistributes a cache of `DTensor`s to it;
on plain tensors or outside a mesh it does nothing.

An `AttnCache` holds k, v (B, C, Hkv, hd) with capacity C and `pos`, the
tokens written: a scalar () in lockstep, or (B,) when every row is a
continuous-batching slot at its own depth.  Layer-stacked caches carry a
leading layer axis on every leaf ((L, B, C, Hkv, hd), pos (L,) or (L, B)).

Where JAX returns new arrays, this port writes k and v IN PLACE: a decode
step copies no cache, and a slot row gathered with `cache_gather_slot` is
a view, so a prompt chunk run on it writes straight into the pool.  `pos`
stays functional (each update returns a new one), so a speculative
snapshot's positions are never moved under it.  Callers thread the
returned cache as in JAX; the caches they passed in have changed.

A `CrossCache` holds the cross-attention source's k, v (B, S_src, Hkv,
hd).  Unlike an `AttnCache` it is never written into: a prefill replaces
it whole with the encoder's k/v at the source's own length, as JAX's does.

Slot surgery (the engine's admission, chunked prefill and retirement) and
the prefix cache's narrow/widen and the speculative snapshot/commit follow
JAX's functions one for one.  The slot axis of a leaf is the last axis of
its `pos` (0 bare, 1 stacked), so no batch-1 template is needed to find it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.runtime import (axis_sizes, constrain, current_mesh,
                                 on_shards, shard_extent)


@dataclasses.dataclass
class AttnCache:
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    ring: bool = False

    def _replace(self, **kw) -> "AttnCache":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "AttnCache":
        """The cache on `device` (`core.qtensor.tree_to` moves it whole)."""
        return self._replace(k=self.k.to(device), v=self.v.to(device),
                             pos=self.pos.to(device))


class CrossCache(NamedTuple):
    k: torch.Tensor  # (B, S_src, Hkv, hd): fixed after prefill
    v: torch.Tensor


def kv_pspec(batch: int, cap: int, heads: int) -> tuple:
    """The cache layout of the current mesh per the policy above; () outside
    one."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    sizes = axis_sizes(mesh)
    keep, prod = [], 1
    for a in ("pod", "data"):
        if a in sizes and batch % (prod * sizes[a]) == 0:
            keep.append(a)
            prod *= sizes[a]
    bspec = tuple(keep) if len(keep) > 1 else (keep[0] if keep else None)
    m = sizes.get("model", 1)
    if m > 1 and heads % m == 0:
        return (bspec, None, "model", None)
    if m > 1 and cap % m == 0:
        return (bspec, "model", None, None)
    return (bspec, None, None, None)


def constrain_cache(c: AttnCache) -> AttnCache:
    """k and v in `kv_pspec`'s layout (DTensors only; see `constrain`)."""
    if current_mesh() is None:
        return c
    spec = kv_pspec(*c.k.shape[-4:-1])
    return c._replace(k=constrain(c.k, *spec), v=constrain(c.v, *spec))


def slot_axis(pool_shape, sub_shape) -> Optional[int]:
    """The axis where a batch-1 sub-state differs from the pool: the slot
    axis.  Equal shapes mean a 1-slot pool (whole replace).  The mesh
    layer shards exactly this axis over the data axes
    (`launch.sharding.serve_pool_shardings`)."""
    if tuple(pool_shape) == tuple(sub_shape):
        return None
    for i, (p, s) in enumerate(zip(pool_shape, sub_shape)):
        if p != s:
            if s != 1:
                raise ValueError(f"sub-state axis {i} must be 1, got "
                                 f"{tuple(sub_shape)} vs pool "
                                 f"{tuple(pool_shape)}")
            return i
    raise ValueError(f"no slot axis between {tuple(pool_shape)} and "
                     f"{tuple(sub_shape)}")


def cache_bytes(c: AttnCache) -> int:
    """The bytes of a cache's k and v."""
    return c.k.numel() * c.k.element_size() * 2


def write_row(p: torch.Tensor, s: torch.Tensor, slot: int) -> torch.Tensor:
    """Copy batch-1 leaf `s` into row `slot` of pool leaf `p` along the
    recovered slot axis, IN PLACE, and return `p` (JAX's returns a new
    array); equal shapes replace the whole leaf (a 1-slot pool)."""
    ax = slot_axis(p.shape, s.shape)
    if ax is None:
        return s.to(p.dtype)
    row = p.narrow(ax, slot, 1)
    if not same_bytes(row, s):
        row.copy_(s)
    return p


def read_row(p: torch.Tensor, ref_shape, slot: int) -> torch.Tensor:
    """Row `slot` of pool leaf `p` as a batch-1 leaf shaped like
    `ref_shape` (a batch-1 template shape: how the slot axis is recovered),
    a VIEW of the pool where JAX's is a copy; `write_row(p, read_row(p, r,
    s), s)` leaves `p` as it was."""
    ax = slot_axis(p.shape, ref_shape)
    if ax is None:
        return p
    return p.narrow(ax, slot, 1)


def cache_init(batch: int, cap: int, heads: int, hd: int, dtype, *,
               ring: bool = False, per_slot: bool = False,
               lead: tuple = (), device=None) -> AttnCache:
    """A zero cache.  `per_slot=True` gives every row its own write
    position (B,) instead of the lockstep scalar; `lead` prepends stacked
    axes (the layer repeats) to every leaf."""
    pos = torch.zeros(lead + ((batch,) if per_slot else ()), dtype=torch.int32,
                      device=device)
    shape = lead + (batch, cap, heads, hd)
    return AttnCache(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device),
                     pos=pos, ring=ring)


def cache_positions(c: AttnCache) -> torch.Tensor:
    """Absolute position stored in each slot, -1 where unwritten.  Scalar
    pos -> (cap,); per-slot pos (B,) -> (B, cap)."""
    cap = c.k.shape[-3]
    slots = torch.arange(cap, dtype=torch.int32, device=c.k.device)
    pos = c.pos if c.pos.dim() == 0 else c.pos[:, None]
    if c.ring:
        # slot s holds the largest a < pos with a % cap == s
        a = pos - 1 - torch.remainder(pos - 1 - slots, cap)
        return torch.where((a >= 0) & (pos > 0), a, -1)
    return torch.where(slots < pos, slots, -1)


def _update_per_slot(c: AttnCache, k_new: torch.Tensor, v_new: torch.Tensor,
                     live: Optional[torch.Tensor] = None) -> AttnCache:
    """Per-slot append: every row writes its S new tokens at its own
    position.  Non-ring writes clamp at cap-1 (an overfull row is a
    retired slot whose output is masked anyway).  `live` (B,) freezes dead
    rows: their pos stays and their write puts back the bytes in place."""
    cap = c.k.shape[1]
    B, S = k_new.shape[:2]
    pos = c.pos
    if c.ring and S > cap:  # keep only the in-window tail
        k_new, v_new = k_new[:, -cap:], v_new[:, -cap:]
        pos = pos + (S - cap)
        S = cap
    abs_pos = pos[:, None] + torch.arange(S, dtype=torch.int32,
                                          device=pos.device)
    slot = (torch.remainder(abs_pos, cap) if c.ring
            else abs_pos.clamp(0, cap - 1)).long()
    rows = torch.arange(B, device=slot.device)[:, None].expand(B, S)
    step = S
    if live is not None:
        m = live[:, None, None, None]
        k_new = torch.where(m, k_new, c.k[rows, slot])
        v_new = torch.where(m, v_new, c.v[rows, slot])
        step = S * live.to(pos.dtype)
    c.k[rows, slot] = k_new.to(c.k.dtype)
    c.v[rows, slot] = v_new.to(c.v.dtype)
    return c._replace(pos=pos + step)


def cache_update(c: AttnCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 live: Optional[torch.Tensor] = None) -> AttnCache:
    """Append S new tokens (prefill: the prompt; decode: 1).

    Non-ring: writes at [pos, pos+S) (the start clamped so the span fits,
    as JAX's dynamic_update_slice clamps it).  Ring: each token at its
    (absolute position % capacity) slot, keeping the last min(S, cap).
    With a per-slot pos every row appends at its own offset; `live`
    additionally freezes dead rows."""
    cap = c.k.shape[1]
    S = k_new.shape[1]
    if c.pos.dim() == 1:
        return _update_per_slot(c, k_new, v_new, live)
    if live is not None:
        raise ValueError("live-masked cache updates need a per-slot pos")
    ar = lambda n: torch.arange(n, dtype=torch.int32, device=c.pos.device)
    if c.ring:
        take = min(S, cap)
        k_new, v_new = k_new[:, -take:], v_new[:, -take:]
        slots = torch.remainder(c.pos + S - take + ar(take), cap)
    else:
        slots = c.pos.clamp(0, cap - S) + ar(S)
    slots = slots.long()
    _write(c.k, slots, k_new)
    _write(c.v, slots, v_new)
    return c._replace(pos=c.pos + S)


def _write(buf: torch.Tensor, slots: torch.Tensor, new: torch.Tensor) -> None:
    """buf[:, slots] = new, in place; `slots` are consecutive modulo the
    capacity.  A DTensor buffer is written rank by rank into its own shard,
    `new` laid out as `buf` but whole along the slot axis: where that axis
    is split over the mesh (a length-sharded cache) each rank keeps the
    slots of its own range, a DTensor in-place write being unable to move
    them."""
    if not isinstance(buf, DTensor):
        buf[:, slots] = new.to(buf.dtype)
        return
    mesh, pl = buf.device_mesh, buf.placements
    if isinstance(slots, DTensor):
        slots = slots.to_local()  # replicated: every rank holds them all
    if not any(p.is_shard(1) for p in pl):
        def write(local, new):
            local[:, slots] = new.to(local.dtype)
    else:
        _, offset = shard_extent(buf.shape, mesh, pl)
        lo, cap, S = offset[1], buf.shape[1], new.shape[1]

        def write(local, new):
            new, n = new.to(local.dtype), local.shape[1]
            if S == 1:  # one slot: written where it falls, put back elsewhere
                at = (slots - lo).clamp(0, n - 1)
                inside = ((slots >= lo) & (slots < lo + n))[None, :, None,
                                                           None]
                local[:, at] = torch.where(inside, new, local[:, at])
                return
            # each local slot j takes new[:, (lo + j - slots[0]) % cap] if
            # that is one of the S written, and keeps its bytes otherwise
            j = torch.arange(n, device=slots.device)
            src = torch.remainder(lo + j - slots[0], cap)
            keep = (src < S)[None, :, None, None]
            local.copy_(torch.where(keep, new[:, src.clamp(max=S - 1)],
                                    local))
    whole = [Replicate() if p.is_shard(1) else p for p in pl]
    on_shards(write, mesh, (buf, new), (pl, whole), None)


# ---------------------------------------------------------------------------
# slot surgery (continuous batching): a cache row is a serving slot
# ---------------------------------------------------------------------------


def _slot_axis(c: AttnCache) -> int:
    if c.pos.dim() == 0:
        raise ValueError("slot surgery needs a per-slot cache")
    return c.pos.dim() - 1


def cache_gather_slot(c: AttnCache, slot: int) -> AttnCache:
    """Row `slot` of a per-slot pool as a batch-1 cache of VIEWS: a prompt
    chunk run on it writes k/v into the pool, and `cache_write_slot` puts
    its new pos back."""
    ax = _slot_axis(c)
    return c._replace(k=c.k.narrow(ax, slot, 1), v=c.v.narrow(ax, slot, 1),
                      pos=c.pos.narrow(ax, slot, 1))


def cache_write_slot(c: AttnCache, sub: AttnCache, slot: int) -> AttnCache:
    """Copy a batch-1 cache of the pool's capacity into row `slot`, in
    place, and return the pool.  A row that is already the pool's own view
    (a gathered slot run in place) is not copied onto itself."""
    ax = _slot_axis(c)
    for dst, src in ((c.k, sub.k), (c.v, sub.v), (c.pos, sub.pos)):
        row = dst.narrow(ax, slot, 1)
        if not same_bytes(row, src):
            row.copy_(src.reshape(row.shape))
    return c


def same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True where `a` and `b` view the same memory (a DTensor by its local
    shard: the wrapper's own address is its offset alone, so slot 0's row
    and any fresh tensor would compare equal)."""
    local = lambda t: t.to_local() if isinstance(t, DTensor) else t
    return local(a).data_ptr() == local(b).data_ptr()


def cache_reset_slots(c: AttnCache, slots: Sequence[int]) -> AttnCache:
    """Retire rows `slots`: their pos drops to 0, so every kv position of
    the row reads as unwritten and attention masks it; the k/v bytes stay.
    In place (one fill a slot, no index copied to the card), as the port's
    engine scrubs; JAX's takes a (B,) mask."""
    ax = _slot_axis(c)
    for s in slots:
        c.pos.narrow(ax, s, 1).zero_()
    return c


# ---------------------------------------------------------------------------
# prefix-state snapshots: only the first p kv columns of a gathered batch-1
# slot are live at a chunk boundary, so the stored entry keeps just those
# ---------------------------------------------------------------------------


def cache_narrow(c: AttnCache, p: int) -> AttnCache:
    """Keep kv columns [0, p) of a gathered batch-1 cache (bare or stacked:
    the cap axis is `pos.dim()` in both)."""
    if c.ring:
        raise ValueError("prefix snapshots need a non-ring cache")
    ax = c.pos.dim()
    return c._replace(k=c.k.narrow(ax, 0, p), v=c.v.narrow(ax, 0, p))


def cache_widen(c: AttnCache, full_shape) -> AttnCache:
    """Inverse of `cache_narrow` up to the masked tail: zero-fill the cap
    axis back to `full_shape` (the batch-1 leaf shape of the pool)."""
    ax = c.pos.dim()
    p = c.k.shape[ax]
    if p == full_shape[ax]:
        return c
    k = c.k.new_zeros(full_shape)
    v = c.v.new_zeros(full_shape)
    k.narrow(ax, 0, p).copy_(c.k)
    v.narrow(ax, 0, p).copy_(c.v)
    return c._replace(k=k, v=v)


# ---------------------------------------------------------------------------
# speculative-decoding rollback: a verify writes a span of K+1 candidates at
# each row's depth; rejection restores the overwritten bytes from a
# pre-verify snapshot, so a rolled-back cache equals one that never saw the
# rejected tokens, bit for bit.  Non-ring caches only.
# ---------------------------------------------------------------------------


class SpecSnap(NamedTuple):
    """The k/v bytes the next `span` writes will overwrite (gathered at
    [pos, pos+span) per row) and the pre-verify positions."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


def _span_index(pos: torch.Tensor, span: int, cap: int) -> tuple:
    """Advanced index of the next `span` write slots of every row (clamped
    like the non-ring append), for a bare pos (B,) or a stacked (L, B)."""
    slot = (pos[..., None] + torch.arange(span, dtype=pos.dtype,
                                          device=pos.device))
    slot = slot.clamp(0, cap - 1).long()
    lead = [torch.arange(n, device=pos.device).reshape(
        (-1,) + (1,) * (pos.dim() - i)) for i, n in enumerate(pos.shape)]
    return (*lead, slot)


def cache_spec_snapshot(c: AttnCache, span: int) -> SpecSnap:
    """Gather the bytes a `span`-token verify is about to overwrite."""
    if c.ring:
        raise ValueError("speculative rollback needs a non-ring cache "
                         "(a ring write recycles in-window history)")
    idx = _span_index(c.pos, span, c.k.shape[-3])
    return SpecSnap(k=c.k[idx], v=c.v[idx], pos=c.pos)


def cache_spec_commit(c: AttnCache, snap: SpecSnap,
                      keep: torch.Tensor) -> AttnCache:
    """Commit `keep` (B,) of the span written since `snap` and roll the rest
    back: bytes past pos0 + keep are restored and pos rewinds to
    pos0 + keep.  keep = 0 restores the snapshot bit for bit."""
    span = snap.k.shape[-3]
    idx = _span_index(snap.pos, span, c.k.shape[-3])
    ar = torch.arange(span, device=keep.device)
    m = (ar < keep[:, None])[..., None, None]   # (B, span, 1, 1)
    c.k[idx] = torch.where(m, c.k[idx], snap.k)
    c.v[idx] = torch.where(m, c.v[idx], snap.v)
    return c._replace(pos=snap.pos + keep.to(snap.pos.dtype))
