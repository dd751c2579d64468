"""Mixture-of-Experts FFN (mixtral / qwen3-moe style), ported from
`repro/models/moe.py`: grouped, capacity-based routing over SwiGLU
experts.

Routing is JAX's, step for step:
  * the router product runs in fp32 (`router` stays a full-precision leaf;
    on the card `dispatch.resolve_device` has turned TF32 off, which would
    flip top-k choices);
  * top-k with ties to the lower expert index (`jax.lax.top_k`'s order: a
    stable descending sort, since `torch.topk` does not promise it), then
    a softmax over the k gates;
  * queue positions by a k-major cumulative sum (every token's first
    choice is queued before any second choice), `keep = pos < cap`;
  * tokens split into groups of `GROUP_SIZE` (one group unless T is a
    multiple), capacity rounded up to `CAP_ALIGN` only when
    T >= CAP_ALIGN * E, and `no_drop` (the decode step) makes cap = Tg;
  * the aux loss E * sum(frac_tokens * frac_probs) over the first choices.

Dispatch and combine are index gathers and a sum over k where JAX has
one-hot einsums: they select the same rows and gates, and only the
combine's summation order differs (fp32, over a token's k kept choices,
then one cast to the compute dtype, as JAX's einsum on the gates it cast
to that dtype).  `route` returns JAX's dense (T, E, C) dispatch and
combine tensors, built from `route_slots`' slots: one routing decision
for every path.

The experts: fp masters take one batched product a weight over every
expert's C capacity slots, as JAX's einsum does (row by row on the CPU,
where a row's bits must not depend on its neighbours).  A packed tree runs
the kernels expert by expert through `ops.qmatmul` (the GEMV at <= 8 rows,
the GEMM above), and only the experts with at least one kept row: JAX
runs all E over their capacity slots, and every other expert's output
meets a combine weight of exactly 0, so skipping it changes no bit.
Finding the non-empty experts costs one device-to-host read a layer (the
per-expert row counts); a CUDA graph over a step would have to remove it.

The channel scales `sgate`/`sup`/`sdown` (one per layer, shared by the
experts) apply after each product in JAX's order: fp32 kernel sum, alpha,
the cast to the compute dtype, then the scale (`qlinear.scaled`).

On a mesh (`DTensor` activations) the layer runs JAX's dense one-hot
formulation instead (`_moe_mesh`: the same routing, `route`'s dispatch
and combine, and the experts as JAX's einsums, the experts' products and
the combine on each rank's shards), with JAX's `constrain` calls and its
expert/capacity sharding choice: the index gathers above have shapes
that depend on the data, which a `DTensor` cannot carry.  A packed tree on
a mesh runs the gathers above rank by rank (`_moe_packed_mesh`: each rank
its experts, or its capacity slots, on its local codes), as JAX runs a
packed expert through `qmatmul` under its mesh; the engine refuses it
where the CUDA kernels are the route.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.qlinear import maybe_scale, scaled, winit
from repro_torch.core.qtensor import QTensor
from repro_torch.kernels.ops import qmatmul, serve_matmul
from repro_torch.runtime import (DATA, axis_sizes, constrain, current_mesh,
                                 grad_reduced, on_shards, reduced)


GROUP_SIZE = 4096  # tokens per routing group
CAP_ALIGN = 128    # capacity rounded up to this at large token counts


def moe_init(gen: torch.Generator, cfg) -> dict:
    """One layer's router and stacked expert weights, drawn from `gen` on
    its device (the numbers differ from `jax.random`'s)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev = gen.device
    p = {
        "router": torch.randn((d, e), generator=gen, device=dev) * d ** -0.5,
        "Wgate": winit(gen, (e, d, f)),
        "Wup": winit(gen, (e, d, f)),
        "Wdown": winit(gen, (e, f, d)),
    }
    for n, dout in (("Wgate", f), ("Wup", f), ("Wdown", d)):
        maybe_scale(p, n, cfg.quant, dout, dev)
    return p


def capacity(n_tokens: int, cfg, align: int = 1) -> int:
    c = int(math.ceil(cfg.topk * n_tokens / cfg.n_experts * cfg.capacity_factor))
    c = max(c, cfg.topk)  # at least topk slots so tiny tests route
    return (c + align - 1) // align * align


def top_k(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index, as `jax.lax.top_k`."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_slots(logits: torch.Tensor, cfg, cap: int):
    """logits (T, E) fp32 -> (idx (T, k) expert of each choice, gates
    (T, k) fp32, pos (T, k) its queue position in that expert, keep (T, k)
    pos < cap, aux).  No shape depends on the data, so it runs on
    `DTensor`s too."""
    T, E = logits.shape
    k = cfg.topk
    gates, idx = top_k(logits, k)
    gates = torch.softmax(gates, dim=-1)               # normalize over k
    experts = torch.arange(E, device=logits.device)
    onehot = (idx[..., None] == experts).long()        # (T, k, E)
    oh_kt = onehot.transpose(0, 1).reshape(k * T, E)   # k-major priority
    pos_kt = torch.cumsum(oh_kt, dim=0) - oh_kt
    pos = torch.sum(pos_kt.reshape(k, T, E).transpose(0, 1) * onehot,
                    dim=-1)
    keep = pos < cap
    probs = torch.softmax(logits, dim=-1)
    frac_tokens = onehot[:, 0, :].float().mean(dim=0)
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0))
    return idx, gates, pos, keep, aux


def route(logits: torch.Tensor, cfg, cap: int):
    """JAX's form: logits (T, E) fp32 -> (dispatch (T, E, C), combine
    (T, E, C), aux), the dense one-hot tensors of `route_slots`' slots
    (the mesh path of `moe_apply`)."""
    idx, gates, pos, keep, aux = route_slots(logits, cfg, cap)
    experts = torch.arange(logits.shape[1], device=logits.device)
    chosen = ((idx[..., None] == experts) & keep[..., None]).float()
    slot = (pos[..., None] == torch.arange(cap, device=logits.device)
            ).float()                                  # (T, k, C)
    disp = torch.einsum("tke,tkc->tec", chosen, slot)
    comb = torch.einsum("tke,tkc->tec", chosen * gates[..., None], slot)
    return disp, comb, aux


def _expert(w: QTensor, e: int) -> QTensor:
    """Expert e of a stacked (E, K/G, N) QTensor: a contiguous slice."""
    return dataclasses.replace(
        w, codes=w.codes[e], scale=None if w.scale is None else w.scale[e])


def _ffn(p: dict, x: torch.Tensor, cfg, mm) -> torch.Tensor:
    """SwiGLU with the channel scales; `mm(x, name)` is one product."""
    g = scaled(mm(x, "Wgate"), p, "Wgate", cfg.quant)
    u = scaled(mm(x, "Wup"), p, "Wup", cfg.quant)
    return scaled(mm(F.silu(g) * u, "Wdown"), p, "Wdown", cfg.quant)


def _batched_mm(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, M, d) @ fp (E, d, f): one batched product on the card, row by
    row on the CPU (`ops.serve_matmul`)."""
    if xe.device.type == "cpu":
        return torch.stack([serve_matmul(xe[e], w[e])
                            for e in range(xe.shape[0])])
    return torch.bmm(xe, w)


def _experts_over_slots(p: dict, xt: torch.Tensor, slot: torch.Tensor,
                        n_slots: int, cfg) -> torch.Tensor:
    """JAX's formulation for fp masters: every expert over its capacity
    slots (rows `slot` of an (E * G * C, d) buffer hold the kept tokens,
    the rest zeros) in one batched product a weight, then the kept rows'
    outputs read back."""
    E = cfg.n_experts
    xe = xt.new_zeros((n_slots, xt.shape[1]))
    xe[slot] = xt
    xe = xe.reshape(E, n_slots // E, -1)
    ye = _ffn(p, xe, cfg, lambda x, n: _batched_mm(x, p[n]))
    return ye.reshape(n_slots, -1)[slot]


def _kept_experts(p: dict, rows: torch.Tensor, expert: torch.Tensor,
                  cfg) -> torch.Tensor:
    """The packed experts with at least one kept row, each on its kept rows
    only.  rows (n, d) with their experts (n,) -> outputs (n, d)."""
    order = torch.argsort(expert, stable=True)
    counts = torch.bincount(expert, minlength=cfg.n_experts).tolist()
    xs = rows[order]
    outs, off = [], 0
    for e, n in enumerate(counts):
        if n:
            outs.append(_ffn(p, xs[off:off + n], cfg,
                             lambda x, name: qmatmul(x, _expert(p[name], e))))
            off += n
    out = torch.empty((rows.shape[0], outs[0].shape[1]), dtype=outs[0].dtype,
                      device=rows.device)
    out[order] = torch.cat(outs)
    return out


def _expert_mm(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """JAX's einsum "gecd,edf->gecf": on DTensors shard by shard, the
    weight split over the experts as h is and whole elsewhere (an
    all-gather of its FSDP and tensor-parallel shards)."""
    mm = lambda x, y: torch.einsum("gecd,edf->gecf", x, y)
    if not isinstance(h, DTensor):
        return mm(h, w)
    want = [Shard(0) if p.is_shard(1) else Replicate() for p in h.placements]
    return on_shards(mm, h.device_mesh, (h, w), (h.placements, want),
                     h.placements, (*h.shape[:3], w.shape[-1]))


def _combine(ye: torch.Tensor, comb: torch.Tensor) -> torch.Tensor:
    """JAX's einsum "gecd,gtec->gtd": on DTensors shard by shard, `comb`
    split as `ye` over groups, experts and slots (slices: no collective),
    the sums over a rank's experts and slots left partial."""
    mm = lambda x, y: torch.einsum("gecd,gtec->gtd", x, y)
    if not isinstance(ye, DTensor):
        return mm(ye, comb)
    want, out = [], []
    for p in ye.placements:
        if p.is_shard(0):
            want.append(Shard(0))
            out.append(Shard(0))
        elif p.is_shard(1) or p.is_shard(2):
            want.append(Shard(p.dim + 1))
            out.append(Partial())
        else:
            want.append(Replicate())
            out.append(Replicate())
    G, E, C, d = ye.shape
    return on_shards(mm, ye.device_mesh, (ye, comb), (ye.placements, want),
                     out, (G, comb.shape[1], d))


def _moe_mesh(p: dict, x: torch.Tensor, cfg, G: int, Tg: int,
              cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`moe_apply` on `DTensor`s: JAX's dense formulation, einsum for
    einsum, with its layouts.  The expert axis goes over 'model' where it
    divides, else the CAPACITY axis (mixtral: 8 experts on a 16-way model
    axis), so the dispatch and combine do not replicate over 'model'.  A
    packed tree takes `_moe_packed_mesh`."""
    if isinstance(p["Wgate"], QTensor):
        return _moe_packed_mesh(p, x, cfg, G, Tg, cap)
    B, S, d = x.shape
    xt = constrain(grad_reduced(x).reshape(G, Tg, d), DATA, None, None)
    logits = torch.einsum("gtd,de->gte", xt.float(), p["router"])
    routes = [route(logits[g], cfg, cap) for g in range(G)]
    disp = torch.stack([r[0] for r in routes]).to(x.dtype)
    comb = torch.stack([r[1] for r in routes]).to(x.dtype)
    aux = torch.stack([r[2] for r in routes]).mean()
    m = axis_sizes(current_mesh()).get("model", 1)
    espec = ("model", None) if m > 1 and cfg.n_experts % m == 0 else (
        None, "model")
    xe = constrain(torch.einsum("gtd,gtec->gecd", xt, disp), DATA, *espec,
                   None)
    mm = lambda h, n: _expert_mm(h, p[n])
    g = scaled(mm(xe, "Wgate"), p, "Wgate", cfg.quant)
    u = scaled(mm(xe, "Wup"), p, "Wup", cfg.quant)
    h = constrain(F.silu(g) * u, DATA, *espec, None)
    ye = constrain(scaled(mm(h, "Wdown"), p, "Wdown", cfg.quant), DATA,
                   *espec, None)
    y = reduced(_combine(ye, comb))
    return y.reshape(B, S, d), aux.float()


def _moe_packed_mesh(p: dict, x: DTensor, cfg, G: int, Tg: int,
                     cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`moe_apply` of a packed tree on `DTensor`s: every rank routes its
    rows as mesh=None does and runs its own experts, the expert axis over
    'model' where it divides, else its range of capacity slots (the
    layouts `_moe_mesh` gives fp weights), through `qmatmul` on its local
    codes over the kept rows routed to them (`_kept_experts`), inside
    `on_shards`, so the data-dependent row counts never meet a DTensor.
    Each rank's fp32 sum over a token's choices is added over 'model' and
    cast, mesh=None's combine.  The rows stay split over the data axes
    where their routing groups do."""
    mesh, (B, S, d), E = x.device_mesh, x.shape, cfg.n_experts
    names = mesh.mesh_dim_names
    md = names.index("model") if "model" in names else None
    m = mesh.size(md) if md is not None else 1
    by_expert = m > 1 and E % m == 0
    by_slot = m > 1 and not by_expert and cap % m == 0
    r = mesh.get_local_rank(md) if m > 1 else 0
    rows = [Shard(0) if q.is_shard(0) and G % mesh.size(dim) == 0
            else Replicate() for dim, q in enumerate(x.placements)]
    split = [dim for dim, q in enumerate(rows) if q.is_shard(0)]
    R = [Replicate()] * mesh.ndim
    ws = ("Wgate", "Wup", "Wdown")
    whole = [Shard(0) if dim == md and by_expert else Replicate()
             for dim in range(mesh.ndim)]
    scales = [k for k in ("sgate", "sup", "sdown") if k in p]
    args = [x, p["router"]] + [p[n].codes for n in ws] + [
        p[n].scale for n in ws] + [p[k] for k in scales]
    want = [rows, R] + [whole] * 3 + [
        None if p[n].scale is None else whole for n in ws] + [R] * len(scales)
    n_groups = 1
    for dim in split:
        n_groups *= mesh.size(dim)
    E_l = E // m if by_expert else E
    e0, C_l = r * E_l if by_expert else 0, cap // m if by_slot else cap
    c0 = r * C_l if by_slot else 0

    def local(xl, router, *flat):
        codes, sc, ch = flat[:3], flat[3:6], flat[6:]
        pl = {k: v for k, v in zip(scales, ch)}
        for n, c, s in zip(ws, codes, sc):
            pl[n] = dataclasses.replace(p[n], codes=c, scale=s)
        T = xl.shape[0] * xl.shape[1]
        xt = xl.reshape(T, d)
        logits = serve_matmul(xt.float(), router).reshape(-1, Tg, E)
        routes = [route_slots(logits[g], cfg, cap)
                  for g in range(logits.shape[0])]
        idx, gates, pos, keep = (torch.cat([rt[i] for rt in routes])
                                 for i in range(4))
        aux = torch.stack([rt[4] for rt in routes]).mean() / n_groups
        mine = keep & (idx >= e0) & (idx < e0 + E_l) & (pos >= c0) & (
            pos < c0 + C_l)
        out = torch.zeros((T, cfg.topk, d), dtype=torch.float32,
                          device=xl.device)
        if bool(mine.any()):
            tok = torch.arange(T, device=xl.device)[:, None].expand_as(
                idx)[mine]
            ye = _kept_experts(pl, xt[tok], idx[mine] - e0, cfg)
            out[mine] = ye.float() * gates.to(xl.dtype)[mine].float()[:, None]
        return out.sum(dim=1), aux

    y_pl = [Partial() if dim == md and (by_expert or by_slot) else q
            for dim, q in enumerate(rows)]
    aux_pl = [Partial() if dim in split else Replicate()
              for dim in range(mesh.ndim)]
    y, aux = on_shards(local, mesh, args, want, (y_pl, aux_pl),
                       ((B * S, d), ()))
    return reduced(y).to(x.dtype).reshape(B, S, d), reduced(aux)


def moe_apply(p: dict, x: torch.Tensor, cfg, *, no_drop: bool = False,
              group_size: int = GROUP_SIZE) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y, aux loss).  SwiGLU experts, grouped routing.
    A packed tree runs only its experts with kept rows, where JAX runs
    every expert over its capacity slots (the tests hold the two
    bit-equal); a `DTensor` runs JAX's dense form (`_moe_mesh`)."""
    B, S, d = x.shape
    T = B * S
    E = cfg.n_experts
    Tg = min(group_size, T)
    if T % Tg:
        Tg = T  # odd tiny shapes: single group
    G = T // Tg
    align = CAP_ALIGN if T >= CAP_ALIGN * E else 1
    cap = Tg if no_drop else capacity(Tg, cfg, align)
    if isinstance(x, DTensor):
        return _moe_mesh(p, x, cfg, G, Tg, cap)

    xt = x.reshape(T, d)
    logits = serve_matmul(xt.float(), p["router"]).reshape(G, Tg, E)
    routes = [route_slots(logits[g], cfg, cap) for g in range(G)]
    idx, gates, pos, keep = (torch.cat([r[i] for r in routes])
                             for i in range(4))
    aux = torch.stack([r[4] for r in routes]).mean()

    # the kept (token, choice) pairs, in token-major order
    tok = torch.arange(T, device=x.device)[:, None].expand_as(idx)[keep]
    expert = idx[keep]
    if isinstance(p["Wgate"], QTensor):
        ye = _kept_experts(p, xt[tok], expert, cfg)
    else:
        group = tok // Tg
        slot = (expert * G + group) * cap + pos[keep]
        ye = _experts_over_slots(p, xt[tok], slot, E * G * cap, cfg)

    # combine: JAX casts the gates to the compute dtype, sums in fp32
    out = torch.zeros((T, cfg.topk, d), dtype=torch.float32, device=x.device)
    out[keep] = ye.float() * gates.to(x.dtype)[keep].float()[:, None]
    y = out.sum(dim=1).to(x.dtype)
    return y.reshape(B, S, d), aux.float()
