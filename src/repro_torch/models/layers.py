"""Shared transformer building blocks, ported from `repro/models/layers.py`:
RMSNorm, RoPE, sinusoidal positions, query-chunked grouped-query attention
(full, sliding window, non-causal and cross), the SwiGLU and GeLU MLPs.

Every weight matmul goes through `kernels.ops.serve_matmul`, which takes
an fp weight or a packed `QTensor` (the GEMV for at most 8 rows, the GEMM
for more), so the layer code serves either tree.  On the CPU it computes
row by row, so a row's bits do not depend on how many rows share the call
(the engine's byte parity).  Attention is two batched products a layer
(`kernels.ordered_bmm.model_bmm`): in serving on the card a kernel that
sums every output's terms in one order, whatever the batch and row
counts; in training and on the CPU the library's product, where each
has at least two rows a head group (G = Hq / Hkv >= 2 in the dense
family) and the library rounds a row alike at any row count.

Attention is plain tensor code, as it is in the JAX package (no Pallas
kernel there, no library attention kernel here): fp32 logits, GQA grouped
as (Hkv, G) without repeating K/V, `kv_pos < 0` masked, causal and
window masks, an optional tanh softcap.

Cross-attention (kind `cross`, the audio decoder's second attention)
takes its keys and values from a source (`kv_src`, the encoder's output),
applies no RoPE and no causal mask, and gates its output by tanh(xgate),
0 at init.  The GeLU MLP is the tanh approximation, as `jax.nn.gelu`'s
default.

On a mesh the activations are DTensors and `runtime.constrain` lays them
out at JAX's sites: the queries' heads and the MLP's hidden over 'model',
the batch over the data axes; elsewhere it does nothing.  The residual
stream stays whole over 'model', as XLA keeps it: a row-parallel
product's partial sums are scaled and all-reduced at once, its scale's
gradient taken on each rank's partial sums (`runtime.scaled_sum`), and
the input gradients of a block's column-parallel products once, summed
(`runtime.grad_reduced`).  Attention runs rank by rank on each rank's
batch rows and heads (`_sdpa_heads`).  Where 'model' does not divide a
head count (8 KV heads on 16 ranks) the projection must be whole on every
rank before the head reshape: a prompt's or a training batch's takes the
weight whole (`_head_proj`), a step's few rows gather their outputs
(`split_heads`), and each rank reads the KV heads its query heads need;
attention over a cache split along its length runs rank by rank on each
rank's keys (`_sdpa_split_keys`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.qlinear import maybe_scale, scaled, scaled_sum, winit
from repro_torch.core.qtensor import is_qtensor
from repro_torch.kernels.ops import serve_matmul
from repro_torch.kernels.ordered_bmm import model_bmm, ordered_bmm
from repro_torch.runtime import (DATA, axis_sizes, constrain, current_mesh,
                                 from_local, grad_reduced, on_shards,
                                 reduce_over, shard_extent)

NEG_INF = -1e30


def mean_square(x: torch.Tensor) -> torch.Tensor:
    """mean(x * x) over the last dim, keepdim, for fp32 x.  On the card,
    with autograd off (serving: the runtimes' steps), each row is summed
    in one order whatever the row count (a row of `ordered_bmm` against
    ones): the library's reduction splits a wide row otherwise by the
    number of rows, and a request's norm, so its stream, would follow its
    batch (and on the meta device, which stands in for the card in a
    count).  On the CPU and in training the library's mean, as before."""
    if x.device.type == "cpu" or torch.is_grad_enabled():
        return torch.mean(x * x, dim=-1, keepdim=True)
    D = x.shape[-1]
    ones = torch.ones((D, 1), dtype=torch.float32, device=x.device)
    return ordered_bmm(x * x, ones) / D


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm, `1 + scale`, in fp32 inside."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(mean_square(x) + eps)
    return (x * (1.0 + scale)).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Half-split rotary embedding.  x (..., S, H, hd); positions (S,) or
    broadcastable to x's S axis ((B, S) per row)."""
    hd = x.shape[-1]
    half = hd // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-log_theta * ar / half)
    ang = positions.float()[..., None] * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]               # over heads
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) fp32 sinusoids: sin at the even columns, cos at the odd."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


# ---------------------------------------------------------------------------
# scaled dot product with flexible masking, fp32 softmax
# ---------------------------------------------------------------------------


def _logits(q: torch.Tensor, k: torch.Tensor, q_pos: torch.Tensor,
            kv_pos: torch.Tensor, *, causal: bool, window: int,
            softcap: float) -> torch.Tensor:
    """The masked attention logits (B, Hkv, G, Sq, Skv) in fp32; masked
    entries NEG_INF."""
    B, Sq, Hq, hd = q.shape
    Hkv, Skv = k.shape[2], k.shape[1]
    G = Hq // Hkv
    # rows (g, q) of one kv head share its keys: (B, Hkv, G*Sq, hd)
    qg = q.reshape(B, Sq, Hkv, G, hd).permute(0, 2, 3, 1, 4).reshape(
        B, Hkv, G * Sq, hd)
    logits = model_bmm(qg.float(), k.permute(0, 2, 3, 1).float()) * (
        hd ** -0.5)
    logits = logits.reshape(B, Hkv, G, Sq, Skv)
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    qp = q_pos if q_pos.dim() == 2 else q_pos[None]     # (B|1, Sq)
    kp = kv_pos if kv_pos.dim() == 2 else kv_pos[None]  # (B|1, Skv)
    mask = kp[:, None, :] >= 0
    if causal:
        mask = mask & (kp[:, None, :] <= qp[:, :, None])
    if window > 0:
        mask = mask & (kp[:, None, :] > qp[:, :, None] - window)
    return torch.where(mask[:, None, None], logits,
                       torch.full((), NEG_INF, device=logits.device))


def _values(probs: torch.Tensor, v: torch.Tensor, shape) -> torch.Tensor:
    """probs (B, Hkv, G, Sq, Skv) against v (B, Skv, Hkv, hd): the output
    (B, Sq, Hq, hd) of q's `shape`."""
    B, Hkv, G, Sq, Skv = probs.shape
    o = model_bmm(probs.reshape(B, Hkv, G * Sq, Skv), v.permute(0, 2, 1, 3))
    return o.reshape(B, Hkv, G, Sq, -1).permute(0, 3, 1, 2, 4).reshape(shape)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
          window: int, softcap: float = 0.0) -> torch.Tensor:
    """q (B, Sq, Hq, hd); k, v (B, Skv, Hkv, hd) with Hq % Hkv == 0; q_pos
    (Sq,) or (B, Sq) and kv_pos (Skv,) or (B, Skv) absolute positions,
    kv_pos < 0 marking unwritten cache slots.  GQA groups the q heads as
    (Hkv, G) instead of repeating K/V.  DTensors run rank by rank
    (`_sdpa_heads`, or `_sdpa_split_keys` over a length-split cache)."""
    if isinstance(q, DTensor) or isinstance(k, DTensor):
        if isinstance(k, DTensor) and any(p.is_shard(1)
                                          for p in k.placements):
            return _sdpa_split_keys(q, k, v, q_pos, kv_pos, causal=causal,
                                    window=window, softcap=softcap)
        return _sdpa_heads(q, k, v, q_pos, kv_pos, causal=causal,
                           window=window, softcap=softcap)
    logits = _logits(q, k, q_pos, kv_pos, causal=causal, window=window,
                     softcap=softcap)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return _values(probs, v, q.shape)


def _sdpa_heads(q, k, v, q_pos, kv_pos, *, causal: bool, window: int,
                softcap: float) -> DTensor:
    """`_sdpa` of DTensors on each rank's batch rows and query heads, as
    XLA partitions JAX's einsums: K/V split over the heads alike where a
    mesh dim divides their heads, else whole there (a serving pool's) and
    each rank takes the KV heads its query heads read.  Attention is per
    head, so nothing crosses the mesh, forward or backward (a whole K/V's
    gradient is each rank's share)."""
    mesh = (q if isinstance(q, DTensor) else k).device_mesh
    R = [Replicate()] * mesh.ndim
    pq = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
          for p in (q.placements if isinstance(q, DTensor) else R)]
    sizes = [mesh.size(d) for d in range(mesh.ndim)]
    Hq, Hkv = q.shape[2], k.shape[2]
    pk = [p if p.is_shard(0) or (p.is_shard(2) and Hkv % sizes[d] == 0)
          else Replicate() for d, p in enumerate(pq)]
    shape, off = shard_extent(q.shape, mesh, pq)
    nb, b0, nq, h0 = shape[0], off[0], shape[2], off[2]
    G = Hq // Hkv
    repeat = any(a.is_shard(2) and not b.is_shard(2)
                 for a, b in zip(pq, pk))

    def local(ql, kl, vl, qp, kp):
        qp, kp = (t[b0:b0 + nb] if t.dim() == 2 else t for t in (qp, kp))
        if repeat:  # the KV head of each local query head
            idx = (h0 + torch.arange(nq, device=kl.device)) // G
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        logits = _logits(ql, kl, qp, kp, causal=causal, window=window,
                         softcap=softcap)
        probs = torch.softmax(logits, dim=-1).to(ql.dtype)
        return _values(probs, vl, ql.shape).contiguous()

    return on_shards(local, mesh, (q, k, v, q_pos, kv_pos),
                     (pq, pk, pk, R, R), pq, q.shape)


def _sdpa_split_keys(q, k, v, q_pos, kv_pos, *, causal: bool, window: int,
                     softcap: float) -> DTensor:
    """`_sdpa` over keys and values split along their key axis over the
    mesh: each rank scores its own keys against every query head, and the
    shares combine by three all-reduces of per-row values (the row maxima,
    the sums of exponentials, the outputs), as XLA partitions JAX's
    einsums over a length-sharded cache."""
    mesh, pl = k.device_mesh, k.placements
    whole = [p if p.is_shard(0) else Replicate() for p in pl]
    shape, off = shard_extent(k.shape, mesh, pl)
    nb, n, b0, lo = shape[0], shape[1], off[0], off[1]
    groups = [mesh.get_group(d).group_name for d, p in enumerate(pl)
              if p.is_shard(1)]

    def local(ql, kl, vl, qp, kp):
        qp, kp = (p[b0:b0 + nb] if p.dim() == 2 else p for p in (qp, kp))
        logits = _logits(ql, kl, qp, kp[..., lo:lo + n], causal=causal,
                         window=window, softcap=softcap)
        e = torch.exp(logits - reduce_over(
            logits.amax(dim=-1, keepdim=True), groups, "max"))
        probs = (e / reduce_over(e.sum(dim=-1, keepdim=True), groups)
                 ).to(ql.dtype)
        return reduce_over(_values(probs, vl, ql.shape), groups)

    R = [Replicate()] * mesh.ndim
    return on_shards(local, mesh, (q, k, v, q_pos, kv_pos),
                     (whole, pl, pl, R, R), whole, q.shape)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_offset=0,
              kv_pos: Optional[torch.Tensor] = None, chunk: int = 1024,
              softcap: float = 0.0) -> torch.Tensor:
    """Grouped-query attention with query chunking.

    q (B, Sq, Hq, hd); k, v (B, Skv, Hkv, hd).  `q_offset` is the absolute
    position of q[0]: an int, a 0-dim tensor, or (B,) when every row sits
    at its own depth.  `kv_pos` gives the cache slots' absolute positions
    ((Skv,) or (B, Skv)); it defaults to arange(Skv).  A query length that
    is a multiple of `chunk` (and longer) runs chunk by chunk, which bounds
    the logits' memory; a sliding window then also slices the keys."""
    B, Sq, Hq, hd = q.shape
    Skv = k.shape[1]
    dev = q.device
    if kv_pos is None:
        kv_pos = torch.arange(Skv, dtype=torch.int32, device=dev)
    off = torch.as_tensor(q_offset, dtype=torch.int32, device=dev)
    ar = torch.arange(Sq, dtype=torch.int32, device=dev)
    q_pos = off[:, None] + ar if off.dim() == 1 else off + ar
    batched = q_pos.dim() == 2 or kv_pos.dim() == 2

    if Sq <= chunk or Sq % chunk != 0:
        return _sdpa(q, k, v, q_pos, kv_pos, causal=causal, window=window,
                     softcap=softcap)

    # the window's key slice needs one start per chunk, so it stays off
    # when positions are per row
    use_slice = window > 0 and Skv > window + chunk and causal and not batched
    kv_span = window + chunk if use_slice else Skv
    outs = []
    for i in range(Sq // chunk):
        qi = q[:, i * chunk:(i + 1) * chunk]
        qp = q_pos[..., i * chunk:(i + 1) * chunk]
        if use_slice:
            base = q_offset if isinstance(q_offset, int) else int(off)
            start = min(max(base + i * chunk - window + 1, 0),
                        Skv - kv_span)
            ki, vi = k[:, start:start + kv_span], v[:, start:start + kv_span]
            kp = start + torch.arange(kv_span, dtype=torch.int32, device=dev)
        else:
            ki, vi, kp = k, v, kv_pos
        outs.append(_sdpa(qi, ki, vi, qp, kp, causal=causal, window=window,
                          softcap=softcap))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# attention layer (params + apply)
# ---------------------------------------------------------------------------


def attn_init(gen: torch.Generator, cfg, *, cross: bool = False,
              kv_d: Optional[int] = None) -> dict:
    """A self-attention layer's weights, or with `cross` a cross-attention
    layer's (keys and values from a source of width `kv_d`, and the
    output gate `xgate`, 0 at init)."""
    d, hd = cfg.d_model, cfg.hd
    dev = gen.device
    kvd = kv_d or d
    p = {
        "Wq": winit(gen, (d, cfg.n_heads * hd)),
        "Wk": winit(gen, (kvd, cfg.n_kv * hd)),
        "Wv": winit(gen, (kvd, cfg.n_kv * hd)),
        "Wo": winit(gen, (cfg.n_heads * hd, d)),
    }
    for n, dout in (("Wq", cfg.n_heads * hd), ("Wk", cfg.n_kv * hd),
                    ("Wv", cfg.n_kv * hd), ("Wo", d)):
        maybe_scale(p, n, cfg.quant, dout, dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), device=dev)
        p["k_norm"] = torch.zeros((hd,), device=dev)
    if cross:
        p["xgate"] = torch.zeros((), device=dev)  # tanh-gated cross-attention
    return p


def _heads_split_shards(heads: int) -> bool:
    """True on a mesh whose 'model' axis does not divide `heads` (8 KV
    heads on 16 ranks): a shard of their columns would end inside a head,
    which a DTensor cannot reshape."""
    mesh = current_mesh()
    return mesh is not None and heads % axis_sizes(mesh).get("model", 1) != 0


def split_heads(y: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """y (B, S, heads * hd) as (B, S, heads, hd), the columns gathered
    over 'model' first where its shards would split a head (a step's few
    rows: `_head_proj` takes the weight whole for more)."""
    if _heads_split_shards(heads):
        y = constrain(y, DATA, None, None)
    return y.reshape(*y.shape[:2], heads, hd)


def merge_heads(o: torch.Tensor, heads: int) -> torch.Tensor:
    """o (B, S, heads, hd) as (B, S, heads * hd), kept whole over 'model'
    where its shards would split a head (the gradient the row-parallel
    output product hands back is split over the columns)."""
    o = o.reshape(*o.shape[:2], -1)
    return constrain(o, DATA, None, None) if _heads_split_shards(heads) else o




def _whole(w):
    """Weight `w` (a DTensor, or a QTensor of them) whole on every rank."""
    if is_qtensor(w):
        return dataclasses.replace(
            w, codes=_whole(w.codes),
            scale=None if w.scale is None else _whole(w.scale))
    if not isinstance(w, DTensor):
        return w
    return w.redistribute(w.device_mesh, [Replicate()] * w.device_mesh.ndim)


def _local(w):
    """The rank-local tensors of a whole weight (a QTensor's codes and
    scale)."""
    if is_qtensor(w):
        return dataclasses.replace(
            w, codes=_local(w.codes),
            scale=None if w.scale is None else _local(w.scale))
    return w.to_local() if isinstance(w, DTensor) else w


class _WholeProduct(torch.autograd.Function):
    """x @ w for a weight whole on every rank: each rank multiplies its
    rows of x (split over the batch, whole elsewhere) by all of w, so the
    output is whole over 'model' (DTensor's own product would slice the
    whole weight's columns over 'model' and gather them back).  Its
    gradient is taken as it arrives (whole, or partial sums over a mesh
    dim), and the transposed products run on each rank's shares: the
    input's and the weight's gradients are partial sums where it is (the
    weight's also over the batch's dims)."""

    @staticmethod
    def forward(ctx, x, w, wl):
        ctx.save_for_backward(x.to_local(), w.to_local())
        ctx.mesh, ctx.x_pl, ctx.w_shape = x.device_mesh, x.placements, w.shape
        y = serve_matmul(x.to_local(), wl)
        return from_local(y, ctx.mesh, x.placements,
                        (*x.shape[:-1], y.shape[-1]))

    @staticmethod
    def backward(ctx, dy):
        xl, wl = ctx.saved_tensors
        mesh = ctx.mesh
        dy = dy.redistribute(mesh, [
            p if p.is_partial() or p.is_shard(0) else Replicate()
            for p in dy.placements])
        dyl = dy.to_local()
        dx = from_local(dyl @ wl.T, mesh, [
            Partial() if p.is_partial() else q
            for p, q in zip(dy.placements, ctx.x_pl)], (*dy.shape[:-1],
                                                       wl.shape[0]))
        dw = from_local(
            (xl.reshape(-1, xl.shape[-1]).T
             @ dyl.reshape(-1, dyl.shape[-1])).to(wl.dtype), mesh,
            [Partial() if p.is_partial() or p.is_shard(0) else Replicate()
             for p in dy.placements], ctx.w_shape)
        return dx, dw, None


def _head_proj(p: dict, x: torch.Tensor, name: str, heads: int,
               cfg) -> torch.Tensor:
    """x's projection by `p[name]` into `heads` heads of `cfg.hd`.  Where
    'model' does not divide the heads, the columns must be whole on every
    rank before the head reshape: where a rank's rows are at least its
    input width (a prompt, a training batch) the weight is gathered and
    the product runs whole on each rank (`_WholeProduct`), so no
    activation crosses the mesh; a step's few rows gather their outputs
    (`split_heads`), the fewer bytes."""
    w = p[name]
    if (_heads_split_shards(heads) and isinstance(x, DTensor)
            and math.prod(x.to_local().shape[:-1]) >= x.shape[-1]):
        rows = [Shard(0) if q.is_shard(0) else Replicate()
                for q in x.placements]
        if list(x.placements) != rows:
            x = x.redistribute(x.device_mesh, rows)
        w = _whole(w)
        wl = _local(w)
        if is_qtensor(w):  # serving: no gradient
            y = _WholeProduct.apply(x, w.codes, wl)
        else:
            y = _WholeProduct.apply(x, w, wl)
    else:
        y = serve_matmul(x, w)
    return split_heads(scaled(y, p, name, cfg.quant), heads, cfg.hd)


def attn_q(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Query projection only."""
    q = _head_proj(p, x, "Wq", cfg.n_heads, cfg)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    return q


def attn_kv(p: dict, src: torch.Tensor, cfg):
    """Key/value projections (the cache fill, the cross source's encode)."""
    k = _head_proj(p, src, "Wk", cfg.n_kv, cfg)
    v = _head_proj(p, src, "Wv", cfg.n_kv, cfg)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    return k, v


def kv_local_slots(k, S: int) -> bool:
    """True where a chunk of S tokens is projected rank by rank into a
    cache leaf (.., C, H, hd) split along its length over the mesh
    (`kv_pspec`, where 'model' does not divide the KV heads): a rank's
    slots are fewer than the chunk's tokens, so `kv_write_local` projects
    fewer rows than the whole chunk."""
    if not isinstance(k, DTensor):
        return False
    ax = k.dim() - 3
    return any(pl.is_shard(ax) for pl in k.placements) and \
        k.to_local().shape[ax] < S


def _kv_columns(p: dict, name: str, w, scale, cols: slice):
    """Columns `cols` of projection `name` from its local whole tensors
    (a QTensor's codes and per-column scale)."""
    if not is_qtensor(p[name]):
        return w[:, cols]
    per_col = scale is not None and scale.shape[-1] == w.shape[-1]
    return dataclasses.replace(p[name], codes=w[:, cols],
                               scale=scale[..., cols] if per_col else scale)


def _kv_args(p: dict):
    """The K/V projections' tensors for `on_shards`, whole on every rank:
    (tensors, their names in `p`), the weights (a QTensor's codes) and
    scales first."""
    names = ("Wk", "Wv")
    extra = tuple(n for n in ("sk", "sv", "k_norm") if n in p)
    ts = ([p[n].codes if is_qtensor(p[n]) else p[n] for n in names]
          + [p[n].scale if is_qtensor(p[n]) else None for n in names]
          + [p[n] for n in extra])
    return ts, extra


def _kv_project(p: dict, cfg, xl, local, extra, heads: slice):
    """Rank-local K/V of rows `xl` (B, T, d) onto KV heads `heads`, from
    the local whole tensors `local` of `_kv_args` (RoPE not applied)."""
    hd = cfg.hd
    cols = slice(heads.start * hd, heads.stop * hd)
    wk, wv, wk_scale, wv_scale, *rest = local
    lp = {k: (v[cols] if k in ("sk", "sv") else v)
          for k, v in zip(extra, rest)}
    kv = []
    for name, w, scale in (("Wk", wk, wk_scale), ("Wv", wv, wv_scale)):
        y = scaled(serve_matmul(xl, _kv_columns(p, name, w, scale, cols)),
                   lp, name, cfg.quant)
        kv.append(y.reshape(*y.shape[:2], heads.stop - heads.start, hd))
    k, v = kv
    if cfg.qk_norm:
        k = rms_norm(k, lp["k_norm"])
    return k, v


def kv_write_local(p: dict, h: DTensor, cfg, c, positions):
    """A prompt chunk's keys and values written into a cache split along
    its length (`kv_local_slots`, scalar pos): each rank projects only the
    chunk's tokens that land in its own range of slots, onto every KV
    head (the weights gathered whole), applies RoPE at their positions and
    writes them in place (the slots `cache_update` writes: the start
    clamped, a ring keeping the last `cap` tokens), so no activation
    crosses the mesh and no token is projected twice.  Returns the cache
    with pos advanced."""
    buf = c.k
    mesh, pl = buf.device_mesh, buf.placements
    R = [Replicate()] * mesh.ndim
    _, offset = shard_extent(buf.shape, mesh, pl)
    lo, cap, S = offset[1], buf.shape[1], h.shape[1]
    take = min(S, cap) if c.ring else S
    pos = c.pos.to_local() if isinstance(c.pos, DTensor) else c.pos
    start = (torch.remainder(pos + S - take, cap) if c.ring
             else pos.clamp(0, cap - S))
    ts, extra = _kv_args(p)
    rows = [Shard(0) if q.is_shard(0) else Replicate() for q in pl]
    heads = slice(0, cfg.n_kv)

    def write(kl, vl, hl, pos_all, *local):
        # local slot j takes token S - take + src_j where src_j < take
        j = torch.arange(kl.shape[1], device=kl.device)
        src = torch.remainder(lo + j - start, cap)
        keep = (src < take)[None, :, None, None]
        tok = (S - take + src.clamp(max=take - 1)).long()
        k, v = _kv_project(p, cfg, hl[:, tok], local, extra, heads)
        k = rope(k, pos_all[tok], cfg.rope_theta)
        kl.copy_(torch.where(keep, k.to(kl.dtype), kl))
        vl.copy_(torch.where(keep, v.to(vl.dtype), vl))

    on_shards(write, mesh, (c.k, c.v, h, positions, *ts),
              (pl, pl, rows, R, *[None if t is None else R for t in ts]),
              None)
    return c._replace(pos=c.pos + S)


def attn_qkv(p: dict, x: torch.Tensor, cfg,
             kv_src: Optional[torch.Tensor] = None):
    """Project x to q, and x (or `kv_src`) to k and v."""
    q = attn_q(p, x, cfg)
    k, v = attn_kv(p, x if kv_src is None else kv_src, cfg)
    return q, k, v


def attn_out(p: dict, o: torch.Tensor, cfg, *,
             cross: bool = False) -> torch.Tensor:
    o = merge_heads(o, cfg.n_heads)
    y = scaled_sum(serve_matmul(o, p["Wo"]), p, "Wo", cfg.quant)
    if cross and "xgate" in p:
        y = torch.tanh(p["xgate"]).to(y.dtype) * y
    return y


def attn_apply(p: dict, x: torch.Tensor, cfg, *, kind: str = "full",
               positions: Optional[torch.Tensor] = None,
               kv_src: Optional[torch.Tensor] = None,
               causal: Optional[bool] = None) -> torch.Tensor:
    """Self- or cross-attention over a whole sequence (the uncached
    forward).  Kind `cross` attends over `kv_src` without RoPE or a causal
    mask; `causal=False` makes a self-attention bidirectional (the
    encoder)."""
    B, S, _ = x.shape
    cross = kind == "cross"
    x = grad_reduced(x)
    src = grad_reduced(kv_src) if cross else x
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    window = cfg.window if kind == "local" or (
        kind == "full" and cfg.window and cfg.swa_all) else 0
    if causal is None:
        causal = cfg.causal and not cross
    q = attn_q(p, x, cfg)
    if not cross:
        q = rope(q, positions, cfg.rope_theta)
    q = constrain(q, DATA, None, "model", None)
    if isinstance(src, DTensor) and _heads_split_shards(cfg.n_kv):
        o = _attend_kv_local(p, q, src, cfg, None if cross else positions,
                             causal=causal, window=window)
        return attn_out(p, o, cfg, cross=cross)
    k, v = attn_kv(p, src, cfg)
    if not cross:
        k = rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=causal, window=window,
                  chunk=cfg.attn_chunk, softcap=cfg.attn_softcap)
    return attn_out(p, o, cfg, cross=cross)


def _attend_kv_local(p: dict, q: DTensor, src: DTensor, cfg, positions,
                     *, causal: bool, window: int) -> DTensor:
    """`attn_apply`'s keys, values and attention where 'model' does not
    divide the KV heads (8 on 16 ranks): each rank projects `src`'s rows
    onto the KV heads its query heads read (those columns of the weights,
    gathered whole), and attends (the KV head of each local query head
    picked where the heads' groups end inside a rank), all inside
    `on_shards`, so no activation crosses the mesh, forward or backward,
    and a KV head is computed by at most the ranks that read it."""
    mesh = q.device_mesh
    R = [Replicate()] * mesh.ndim
    pq = [pl if pl.is_shard(0) or pl.is_shard(2) else Replicate()
          for pl in q.placements]
    rows = [pl if pl.is_shard(0) else Replicate() for pl in pq]
    shape, off = shard_extent(q.shape, mesh, pq)
    nq, h0 = shape[2], off[2]
    G = cfg.n_heads // cfg.n_kv
    heads = slice(h0 // G, (h0 + nq - 1) // G + 1)   # the KV heads they read
    ts, extra = _kv_args(p)

    def local(ql, xl, pos, *tl):
        k, v = _kv_project(p, cfg, xl, tl, extra, heads)
        if pos is not None:
            k = rope(k, pos, cfg.rope_theta)
        if h0 % G or nq % G:
            idx = (h0 + torch.arange(nq, device=k.device)) // G - heads.start
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        return attention(ql, k, v, causal=causal, window=window,
                         chunk=cfg.attn_chunk,
                         softcap=cfg.attn_softcap).contiguous()

    return on_shards(local, mesh, (q, src, positions, *ts),
                     (pq, rows, None if positions is None else R,
                      *[None if t is None else R for t in ts]), pq, q.shape)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, cfg, *, kind: Optional[str] = None) -> dict:
    """The MLP's weights: SwiGLU, or the GeLU MLP with its biases."""
    kind = kind or cfg.mlp
    d, ff = cfg.d_model, cfg.d_ff
    if kind == "swiglu":
        p = {"Wgate": winit(gen, (d, ff)), "Wup": winit(gen, (d, ff)),
             "Wdown": winit(gen, (ff, d))}
        dims = (("Wgate", ff), ("Wup", ff), ("Wdown", d))
    else:  # gelu
        p = {"Wfc1": winit(gen, (d, ff)), "Wfc2": winit(gen, (ff, d)),
             "bfc1": torch.zeros((ff,), device=gen.device),
             "bfc2": torch.zeros((d,), device=gen.device)}
        dims = (("Wfc1", ff), ("Wfc2", d))
    for n, dout in dims:
        maybe_scale(p, n, cfg.quant, dout, gen.device)
    return p


def mlp_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    x = grad_reduced(x)
    if "Wgate" in p:
        g = scaled(serve_matmul(x, p["Wgate"]), p, "Wgate", cfg.quant)
        u = scaled(serve_matmul(x, p["Wup"]), p, "Wup", cfg.quant)
        h = constrain(F.silu(g) * u, DATA, None, "model")
        return scaled_sum(serve_matmul(h, p["Wdown"]), p, "Wdown",
                          cfg.quant)
    h = F.gelu(scaled(serve_matmul(x, p["Wfc1"]), p, "Wfc1", cfg.quant)
               + p["bfc1"].to(x.dtype), approximate="tanh")
    h = constrain(h, DATA, None, "model")
    return (scaled_sum(serve_matmul(h, p["Wfc2"]), p, "Wfc2", cfg.quant)
            + p["bfc2"].to(x.dtype))
