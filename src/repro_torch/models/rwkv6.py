"""RWKV-6 "Finch" mixer, ported from `repro/models/rwkv6.py`: linear
attention with a data-dependent per-channel decay (arXiv:2404.05892).

The WKV6 recurrence per head (head size N):

    y_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          w_t in (0,1), data-dependent

`wkv6_chunked` evaluates it chunk-wise in fp32: inside a chunk of Q tokens
a causally masked (Q x Q) product against cumulative log-decays, across
chunks a Python loop carrying the (H, N, N) state, as JAX's `lax.scan`
does.  It is plain tensor code (no Pallas kernel in JAX), so its products
stay `torch.einsum`.  Every exponent argument is <= 0: JAX factors the
intra-chunk decay exp(Lm1_i - L_j) into exp(Lm1_i) * exp(-L_j), whose
second argument is positive and overflows at strong decay.  The port cuts
the chunk into sub-chunks of WKV_SUB tokens.  A query i in sub-chunk a and
a key j in an earlier one meet through the decay at a's start, ref_a:
exp(Lm1_i - ref_a) * exp(ref_a - L_j), both factors <= 1, one (Q x Q)
product a head.  Inside a sub-chunk the decay is the pairwise difference,
taken one offset i - j at a time, so no intermediate has both the (i, j)
and the channel axis: memory stays (Q / WKV_SUB) times the inputs'.  The
exclusive cumulative decay is a shifted cumsum (JAX's L - logw rounds away
from L_{i-1} once |L| is large).
`wkv6_step` is the decode recurrence.  The recurrent state is always fp32.

Quantizable 'W*' leaves: Wr, Wk, Wv, Wg, Wo (time mix) and Wck, Wcv, Wcr
(channel mix); they go through `ops.serve_matmul` (the packed GEMV or GEMM
for a QTensor).  The decay and mix LoRAs and the u bonus stay fp, the
paper's biases-and-norms-stay-fp split.  Every matmul keeps a row's bits
its own on the CPU (`serve_matmul`), so a request served alone and in a
batch reaches the same bits.  Mixed-dtype products promote as JAX's do
(bf16 with fp32 gives fp32).

On a mesh r, k, v and the channel mix's hidden are laid over 'model'
(`runtime.constrain`, JAX's sites); elsewhere it does nothing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.core.qlinear import maybe_scale, scaled, scaled_sum, winit
from repro_torch.core.qtensor import QTensor
from repro_torch.kernels.ops import serve_matmul
from repro_torch.models.layers import split_heads
from repro_torch.runtime import DATA, constrain, on_shards, shard_like


LORA_R = 32
WKV_SUB = 16  # sub-chunk of the intra-chunk decay split (wkv6_chunked)


class RWKVState(NamedTuple):
    S: torch.Tensor         # (B, H, N, N) wkv state, fp32
    tm_shift: torch.Tensor  # (B, d) last token seen by time-mix
    cm_shift: torch.Tensor  # (B, d) last token seen by channel-mix
    pos: torch.Tensor       # () lockstep or (B,) per slot


def rwkv6_init(gen: torch.Generator, cfg) -> dict:
    """One layer's parameters, drawn from `gen` on its device."""
    d, dev = cfg.d_model, gen.device
    N = cfg.hd
    H = d // N
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    p = {
        # time mix
        "Wr": winit(gen, (d, d)), "Wk": winit(gen, (d, d)),
        "Wv": winit(gen, (d, d)), "Wg": winit(gen, (d, d)),
        "Wo": winit(gen, (d, d)),
        "mu_x": torch.full((5, d), 0.5, device=dev),  # r,k,v,w,g shift mix
        "lora_A": randn(d, LORA_R * 5) * 0.01,
        "lora_B": torch.zeros((5, LORA_R, d), device=dev),
        "w0": torch.linspace(-6.0, -1.0, d, device=dev),  # decay bias
        "wA": randn(d, 2 * LORA_R) * 0.01,
        "wB": torch.zeros((2 * LORA_R, d), device=dev),
        "u": torch.zeros((H, N), device=dev),             # bonus
        "ln_x": torch.ones((d,), device=dev),             # group-norm scale
        # channel mix
        "Wck": winit(gen, (d, cfg.d_ff)),
        "Wcv": winit(gen, (cfg.d_ff, d)),
        "Wcr": winit(gen, (d, d)),
        "mu_ck": torch.full((d,), 0.5, device=dev),
        "mu_cr": torch.full((d,), 0.5, device=dev),
    }
    for n, dout in (("Wr", d), ("Wk", d), ("Wv", d), ("Wg", d), ("Wo", d),
                    ("Wck", cfg.d_ff), ("Wcv", d), ("Wcr", d)):
        maybe_scale(p, n, cfg.quant, dout, dev)
    return p


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w through `serve_matmul`, an fp operand pair promoted to the
    wider dtype first, as JAX promotes (bf16 @ fp32 is fp32)."""
    if not isinstance(w, QTensor) and w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return serve_matmul(x, w)


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor, chunk: int,
                 S0: Optional[torch.Tensor] = None):
    """r, k, v (B, T, H, N); logw (B, T, H, N) <= 0; u (H, N).
    Returns (y (B, T, H, N) fp32, S_final (B, H, N, N) fp32)."""
    Bsz, T, H, N = r.shape
    f32 = torch.float32
    r, k, v, logw, u = (t.to(f32) for t in (r, k, v, logw, u))
    Q = min(chunk, T)
    c = min(WKV_SUB, Q)
    Q = -(-Q // c) * c                      # whole sub-chunks
    T0 = T
    if T % Q:
        # zero-pad to a chunk multiple: k = v = 0 adds nothing to the state
        # and logw = 0 (decay 1) leaves it untouched, so the state is exact
        pad = Q - T % Q
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
        T = T + pad
    nc, ns = T // Q, Q // c
    r, k, v, logw = (t.reshape(Bsz, nc, Q, H, N) for t in (r, k, v, logw))

    L = torch.cumsum(logw, dim=2)           # inclusive cumulative log decay
    # exclusive (L_{i-1}, row 0 -> 0), shifted rather than JAX's L - logw,
    # so that L_{i-1} - L_{i-1} is exactly 0 at any magnitude of L
    Lm1 = torch.cat([torch.zeros_like(L[:, :, :1]), L[:, :, :-1]], dim=2)
    Lend = L[:, :, -1]                      # (B, nc, H, N)
    sub = lambda t: t.reshape(Bsz, nc, ns, c, H, N)

    # diagonal bonus term: (r_i * u) . k_i
    y = (r * u * k).sum(-1, keepdim=True) * v
    if ns > 1:
        # keys of earlier sub-chunks: att[i,j] = sum_n r_i k_j
        # exp(Lm1_i - ref_a) exp(ref_a - L_j), ref_a = L_{ac-1} = Lm1_{ac}
        ref = Lm1[:, :, ::c]                                  # (b,c,a,h,n)
        rq = sub(r) * torch.exp(sub(Lm1) - ref[:, :, :, None])
        ar = torch.arange(Q, device=r.device)
        earlier = (ar[None, :] < ar[::c, None])[:, :, None, None]  # (a,j,1,1)
        kx = torch.where(earlier, ref[:, :, :, None] - L[:, :, None],
                         torch.full((), -torch.inf, device=r.device))
        kq = k[:, :, None] * torch.exp(kx)                    # (b,c,a,j,h,n)
        att = torch.einsum("bcaihn,bcajhn->bchaij", rq, kq)
        y = y + torch.einsum("bchij,bcjhn->bcihn",
                             att.reshape(Bsz, nc, H, Q, Q), v)
    # the same sub-chunk, one offset d = i - j at a time:
    # att[i, i-d] = sum_n r_i k_{i-d} exp(Lm1_i - L_{i-d})
    rs, ks, vs, Ls, Lm1s = (sub(t) for t in (r, k, v, L, Lm1))
    band = torch.zeros_like(rs)
    for d in range(1, c):
        a = torch.linalg.vecdot(
            rs[:, :, :, d:] * ks[:, :, :, :-d],
            torch.exp(Lm1s[:, :, :, d:] - Ls[:, :, :, :-d]))
        band[:, :, :, d:] += a[..., None] * vs[:, :, :, :-d]
    y = y + band.reshape(Bsz, nc, Q, H, N)

    # chunk state increments: sum_j diag(exp(Lend - L_j)) k_j^T v_j
    kdec = k * torch.exp(Lend[:, :, None] - L)
    inc = torch.einsum("bcjhn,bcjhm->bchnm", kdec, v)

    S = (torch.zeros((Bsz, H, N, N), dtype=f32, device=r.device)
         if S0 is None else S0.to(f32))
    S_in = []
    for ci in range(nc):
        S_in.append(S)
        S = S * torch.exp(Lend[:, ci])[..., None] + inc[:, ci]
    S_in = torch.stack(S_in, dim=1)         # (B, nc, H, N, N)

    ri = r * torch.exp(Lm1)                 # decayed queries
    y = y + torch.einsum("bcihn,bchnm->bcihm", ri, S_in)
    return y.reshape(Bsz, T, H, N)[:, :T0], S


def wkv6_step(r, k, v, logw, u, S):
    """One token: r, k, v, logw (B, H, N); S (B, H, N, N) fp32 -> (y, S').
    One outer product and one state-weighted readout a head."""
    f32 = torch.float32
    S = S.to(f32)
    kv = (k[..., :, None] * v[..., None, :]).to(f32)
    y = (r.to(f32)[..., :, None] * (S + u.to(f32)[None, :, :, None] * kv)
         ).sum(dim=-2)
    S = S * torch.exp(logw).to(f32)[..., None] + kv
    return y, S


def _group_norm(x: torch.Tensor, scale: torch.Tensor, H: int) -> torch.Tensor:
    """Per-head LayerNorm over the head dim (rwkv's ln_x)."""
    B, T, d = x.shape
    xh = x.reshape(B, T, H, d // H).float()
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, correction=0)
    xh = (xh - mu) * torch.rsqrt(var + 1e-5)
    return (xh.reshape(B, T, d) * scale).to(x.dtype)


def _proj(p: dict, x: torch.Tensor, name: str, cfg) -> torch.Tensor:
    return scaled(_mm(x, p[name]), p, name, cfg.quant)


def rwkv6_time_mix(p: dict, x: torch.Tensor, cfg, *,
                   state: Optional[RWKVState] = None,
                   decode: Optional[bool] = None):
    """x (B, T, d) -> (out, S_final, last token).  decode=None picks the
    `wkv6_step` recurrence for a single carried-state token and the chunked
    scan otherwise; the transformer block passes it explicitly (a prefill
    takes the chunked path even at T = 1)."""
    B, T, d = x.shape
    N = cfg.hd
    H = d // N
    if decode is None:
        decode = state is not None and T == 1

    prev = (state.tm_shift if state is not None
            else torch.zeros((B, d), dtype=x.dtype, device=x.device))
    xprev = torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)
    sx = xprev - x

    # data-dependent mixing (Finch): 5 deltas from a shared LoRA
    xxx = x + sx * p["mu_x"][0]
    lora = split_heads(torch.tanh(_mm(xxx, p["lora_A"].to(x.dtype))), 5,
                       LORA_R)
    lb = p["lora_B"].to(x.dtype)
    delta = torch.stack([_mm(lora[:, :, i], lb[i]) for i in range(5)], dim=2)
    mix = p["mu_x"].to(x.dtype)[None, None] + delta          # (B, T, 5, d)
    xr, xk, xv, xw, xg = [(x + sx * mix[:, :, i]).to(x.dtype)
                          for i in range(5)]

    r = _proj(p, xr, "Wr", cfg).reshape(B, T, H, N)
    k = _proj(p, xk, "Wk", cfg).reshape(B, T, H, N)
    v = _proj(p, xv, "Wv", cfg).reshape(B, T, H, N)
    g = F.silu(_proj(p, xg, "Wg", cfg))

    # data-dependent decay: w = exp(-exp(w0 + lora_w(xw))), logw <= 0 (fp32)
    ww = p["w0"] + _mm(torch.tanh(_mm(xw, p["wA"].to(x.dtype))),
                       p["wB"].to(x.dtype)).float()
    logw = -torch.exp(torch.clamp(ww, -10.0, 5.0)).reshape(B, T, H, N)

    r = constrain(r, DATA, None, "model", None)
    k = constrain(k, DATA, None, "model", None)
    v = constrain(v, DATA, None, "model", None)
    S0 = state.S if state is not None else None
    if decode:
        if S0 is None:
            S0 = torch.zeros((B, H, N, N), dtype=x.dtype, device=x.device)
        y1, ST = wkv6_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], p["u"], S0)
        y = y1[:, None]
    else:
        scan = lambda *a: wkv6_chunked(*a[:5], cfg.ssm_chunk, a[5])
        args = (r, k, v, logw, p["u"], S0)
        if isinstance(r, DTensor):  # (B, T, H, N): batch and heads apart
            bthn, bhnn = (shard_like(r, {0: 0, 2: d}) for d in (2, 1))
            y, ST = on_shards(scan, r.device_mesh, args,
                              (bthn,) * 4 + (shard_like(r, {2: 0}), bhnn),
                              (bthn, bhnn))
        else:
            y, ST = scan(*args)

    y = _group_norm(y.reshape(B, T, d), p["ln_x"], H) * g
    out = scaled_sum(_mm(y, p["Wo"]), p, "Wo", cfg.quant)
    return out, ST, x[:, -1]


def rwkv6_channel_mix(p: dict, x: torch.Tensor, cfg, *,
                      prev: Optional[torch.Tensor] = None):
    """x (B, T, d) -> (out, last token)."""
    B, T, d = x.shape
    if prev is None:
        prev = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    xprev = torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)
    sx = xprev - x
    xk = x + sx * p["mu_ck"].to(x.dtype)
    xr = x + sx * p["mu_cr"].to(x.dtype)
    k = constrain(torch.square(F.relu(_proj(p, xk, "Wck", cfg))), DATA,
                  None, "model")
    kv = scaled_sum(_mm(k, p["Wcv"]), p, "Wcv", cfg.quant)
    return torch.sigmoid(_proj(p, xr, "Wcr", cfg)) * kv, x[:, -1]


def state_init(cfg, batch: int, dtype=torch.float32, *,
               per_slot: bool = False, lead: tuple = (),
               device=None) -> RWKVState:
    """Zero per-session recurrent state.  `per_slot` makes the token counter
    (B,) so every continuous-batching slot tracks its own depth; `lead`
    prepends stacked axes (the layer repeats) to every leaf."""
    d = cfg.d_model
    N = cfg.hd
    H = d // N
    z = lambda shape, dt: torch.zeros(lead + shape, dtype=dt, device=device)
    return RWKVState(S=z((batch, H, N, N), torch.float32),  # fp32 core
                     tm_shift=z((batch, d), dtype),
                     cm_shift=z((batch, d), dtype),
                     pos=z((batch,) if per_slot else (), torch.int32))
