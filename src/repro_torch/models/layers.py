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
the batch over the data axes; elsewhere it does nothing.  Where 'model'
does not divide a head count (8 KV heads on 16 ranks), a projection's
columns are gathered before the head reshape (`split_heads`), training
repeats K/V to the query heads, and attention over a cache split along
its length runs rank by rank on each rank's keys (`_sdpa_split_keys`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.core.qlinear import maybe_scale, scaled, winit
from repro_torch.kernels.ops import serve_matmul
from repro_torch.kernels.ordered_bmm import model_bmm, ordered_bmm
from repro_torch.runtime import (DATA, axis_sizes, constrain, current_mesh,
                                 on_shards, shard_extent)

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
    (Hkv, G) instead of repeating K/V, except on a mesh whose 'model'
    axis does not divide Hkv (`_kv_heads_split`)."""
    if isinstance(k, DTensor):
        k_split = _kv_heads_split(q, k, v)
        if k_split == "keys":
            return _sdpa_split_keys(q, k, v, q_pos, kv_pos, causal=causal,
                                    window=window, softcap=softcap)
        if k_split is not None:
            q, k, v = k_split
    logits = _logits(q, k, q_pos, kv_pos, causal=causal, window=window,
                     softcap=softcap)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return _values(probs, v, q.shape)


def _kv_heads_split(q, k, v):
    """How `_sdpa` lays out DTensor operands whose KV heads the mesh's
    'model' axis does not divide (q's G-row groups would end inside a
    shard): "keys" where the keys are split along their axis (a
    length-sharded cache: `_sdpa_split_keys`); else (q, k, v) with K/V
    repeated to q's heads, all split over 'model' where it divides Hq,
    or q gathered whole where it does not; None where nothing is to do."""
    mesh = current_mesh()
    m = axis_sizes(mesh).get("model", 1) if mesh is not None else 1
    B, Skv, Hkv, hd = k.shape
    Hq = q.shape[2]
    if m == 1 or Hkv % m == 0:
        return None
    if any(p.is_shard(1) for p in k.placements):
        return "keys"
    if Hq % m:
        return constrain(q, DATA, None, None, None), k, v
    G = Hq // Hkv
    rep = lambda t: constrain(t[:, :, :, None].expand(
        B, Skv, Hkv, G, hd).reshape(B, Skv, Hq, hd), DATA, None, "model",
        None)
    return constrain(q, DATA, None, "model", None), rep(k), rep(v)


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

    def reduce(t, op):
        for g in groups:
            t = torch.ops._c10d_functional.wait_tensor(
                torch.ops._c10d_functional.all_reduce(t, op, g))
        return t

    def local(ql, kl, vl, qp, kp):
        qp, kp = (p[b0:b0 + nb] if p.dim() == 2 else p for p in (qp, kp))
        logits = _logits(ql, kl, qp, kp[..., lo:lo + n], causal=causal,
                         window=window, softcap=softcap)
        e = torch.exp(logits - reduce(logits.amax(dim=-1, keepdim=True),
                                      "max"))
        probs = (e / reduce(e.sum(dim=-1, keepdim=True), "sum")).to(ql.dtype)
        return reduce(_values(probs, vl, ql.shape), "sum")

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
    over 'model' first where its shards would split a head."""
    if _heads_split_shards(heads):
        y = constrain(y, DATA, None, None)
    return y.reshape(*y.shape[:2], heads, hd)


def merge_heads(o: torch.Tensor, heads: int) -> torch.Tensor:
    """o (B, S, heads, hd) as (B, S, heads * hd), kept whole over 'model'
    where its shards would split a head (the gradient the row-parallel
    output product hands back is split over the columns)."""
    o = o.reshape(*o.shape[:2], -1)
    return constrain(o, DATA, None, None) if _heads_split_shards(heads) else o


def attn_q(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Query projection only."""
    q = scaled(serve_matmul(x, p["Wq"]), p, "Wq", cfg.quant)
    q = split_heads(q, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    return q


def attn_kv(p: dict, src: torch.Tensor, cfg):
    """Key/value projections (the cache fill, the cross source's encode)."""
    k = scaled(serve_matmul(src, p["Wk"]), p, "Wk", cfg.quant)
    v = scaled(serve_matmul(src, p["Wv"]), p, "Wv", cfg.quant)
    k = split_heads(k, cfg.n_kv, cfg.hd)
    v = split_heads(v, cfg.n_kv, cfg.hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    return k, v


def attn_qkv(p: dict, x: torch.Tensor, cfg,
             kv_src: Optional[torch.Tensor] = None):
    """Project x to q, and x (or `kv_src`) to k and v."""
    q = attn_q(p, x, cfg)
    k, v = attn_kv(p, x if kv_src is None else kv_src, cfg)
    return q, k, v


def attn_out(p: dict, o: torch.Tensor, cfg, *,
             cross: bool = False) -> torch.Tensor:
    o = merge_heads(o, cfg.n_heads)
    y = scaled(serve_matmul(o, p["Wo"]), p, "Wo", cfg.quant)
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
    q, k, v = attn_qkv(p, x, cfg, kv_src=kv_src if cross else None)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    if not cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    window = cfg.window if kind == "local" or (
        kind == "full" and cfg.window and cfg.swa_all) else 0
    if causal is None:
        causal = cfg.causal and not cross
    q = constrain(q, DATA, None, "model", None)
    o = attention(q, k, v, causal=causal, window=window,
                  chunk=cfg.attn_chunk, softcap=cfg.attn_softcap)
    return attn_out(p, o, cfg, cross=cross)


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
    if "Wgate" in p:
        g = scaled(serve_matmul(x, p["Wgate"]), p, "Wgate", cfg.quant)
        u = scaled(serve_matmul(x, p["Wup"]), p, "Wup", cfg.quant)
        h = constrain(F.silu(g) * u, DATA, None, "model")
        return scaled(serve_matmul(h, p["Wdown"]), p, "Wdown", cfg.quant)
    h = F.gelu(scaled(serve_matmul(x, p["Wfc1"]), p, "Wfc1", cfg.quant)
               + p["bfc1"].to(x.dtype), approximate="tanh")
    h = constrain(h, DATA, None, "model")
    return (scaled(serve_matmul(h, p["Wfc2"]), p, "Wfc2", cfg.quant)
            + p["bfc2"].to(x.dtype))
