"""Mamba2 (SSD) mixer, ported from `repro/models/mamba2.py`: the chunked
selective state-space recurrence of zamba2-1.2b (arXiv:2405.21060).

Per head (state N, head dim P), with a single B/C group broadcast over the
heads:

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T      h: (N, P)
    y_t = C_t . h_t

`ssd_chunked` evaluates it chunk by chunk: inside a chunk of Q tokens a
causally masked (Q x Q) product against the cumulative log decay, the
chunk states as one product, and across chunks a Python loop carrying the
fp32 (H, N, P) state, as JAX's `lax.scan` does.  It is plain tensor code
(JAX has no Pallas kernel for it either).  JAX takes exp(cum_i - cum_j)
over the whole block and then masks j > i, whose arguments are positive
and overflow at strong decay; the port fills the masked entries with -inf
before the exp, so no inf is made and the kept values are the same.  It
is differentiable: with gradients on, its intra-chunk block is built out
of place.
`ssd_step` is the one-token recurrence of the decode step.  The recurrent
state is always fp32; the conv tail is in the compute dtype.

Quantizable 'W*' leaves: Win (d -> z, x, B, C, dt) and Wout, through
`ops.serve_matmul` (the packed GEMV or GEMM for a QTensor); the SSM
dynamics (A, the dt bias, the conv, D, the norm) stay fp, the paper's
biases-and-norms-stay-fp split.  Mixed-dtype products promote as JAX's
do (bf16 with fp32 gives fp32).

On a mesh the SSD heads of x are laid over 'model' (`runtime.constrain`,
JAX's site); elsewhere it does nothing.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.core.qlinear import maybe_scale, scaled, scaled_sum, winit
from repro_torch.kernels.ops import serve_matmul
from repro_torch.kernels.ordered_bmm import model_bmm
from repro_torch.models.layers import mean_square
from repro_torch.runtime import (DATA, constrain, grad_reduced, on_shards,
                                 shard_like)



class SSMState(NamedTuple):
    h: torch.Tensor     # (B, H, N, P) inter-chunk state, fp32
    conv: torch.Tensor  # (B, K-1, conv_dim) causal-conv tail
    pos: torch.Tensor   # () lockstep or (B,) per slot: tokens seen


def _dims(cfg):
    di = cfg.d_inner
    H = cfg.ssm_heads
    P = cfg.ssm_headdim
    N = cfg.ssm_state
    conv_dim = di + 2 * N  # x, B, C pass through the causal conv
    return di, H, P, N, conv_dim


def mamba2_init(gen: torch.Generator, cfg) -> dict:
    """One layer's parameters, drawn from `gen` on its device."""
    d, dev = cfg.d_model, gen.device
    di, H, P, N, conv_dim = _dims(cfg)
    d_proj = 2 * di + 2 * N + H  # z, x, B, C, dt
    lo, hi = math.log(1e-3), math.log(0.1)
    u = torch.rand((H,), generator=gen, device=dev)
    p = {
        "Win": winit(gen, (d, d_proj)),
        "Wout": winit(gen, (di, d)),
        "conv_w": torch.randn((cfg.ssm_conv, conv_dim), generator=gen,
                              device=dev) * 0.1,
        "conv_b": torch.zeros((conv_dim,), device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        "D": torch.ones((H,), device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(u * (hi - lo) + lo))),
        "norm": torch.ones((di,), device=dev),
    }
    maybe_scale(p, "Win", cfg.quant, d_proj, dev)
    maybe_scale(p, "Wout", cfg.quant, d, dev)
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: Optional[torch.Tensor] = None):
    """x (B, S, C), a depthwise causal conv with kernel w (K, C).  `tail`
    is the last K-1 inputs of the previous call; returns (y, new tail)."""
    K, S = w.shape[0], x.shape[1]
    if tail is None:
        tail = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)
    new_tail = xp[:, -(K - 1):].clone() if K > 1 else tail
    y = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(K))
    return F.silu(y + b.to(x.dtype)), new_tail


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """x (B, S, H, P), dt (B, S, H), A (H,) negative, Bm and Cm (B, S, N),
    h0 an optional (B, H, N, P) state.  Returns (y (B, S, H, P) fp32,
    h_final (B, H, N, P) fp32)."""
    f32 = torch.float32
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S0 = S
    if S % Q:
        # zero-pad to a chunk multiple: dt = 0 gives decay exp(0) = 1 and
        # no state increment, so the final state is exact
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bm, Cm))
        S = S + pad
    nc = S // Q
    x, dt, Bm, Cm = (t.reshape(Bsz, nc, Q, *t.shape[2:])
                     for t in (x, dt, Bm, Cm))

    dA = dt * A                                   # (B, nc, Q, H), <= 0
    cum = torch.cumsum(dA, dim=2)
    seg_end = cum[:, :, -1]                       # a chunk's total log decay

    # intra-chunk: att[i,j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, i >= j,
    # in one (B, nc, Qi, Qj, H) buffer; the masked entries become -inf
    # before the exp, so exp gives 0 there and no inf.  Serving builds it
    # in place (its peak memory); autograd needs exp's output intact, so a
    # call with gradients builds it out of place, the same values.
    idx = torch.arange(Q, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    att = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    cb = torch.einsum("bcin,bcjn->bcij", Cm, Bm)[..., None]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bm, Cm)):
        att = (att.masked_fill(~causal, -torch.inf).exp() * cb
               * dt[:, :, None, :, :])
    else:
        att.masked_fill_(~causal, -torch.inf).exp_()
        att.mul_(cb)
        att.mul_(dt[:, :, None, :, :])
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, x.to(att.dtype))
    del att

    # chunk states: sum_j exp(seg_end - cum_j) dt_j B_j x_j^T
    w_state = torch.exp(seg_end[:, :, None, :] - cum) * dt  # (B,nc,Q,H)
    states = torch.einsum("bcjh,bcjn,bcjhp->bchnp", w_state,
                          Bm.to(w_state.dtype), x.to(w_state.dtype))

    # inter-chunk carry over nc chunks, in fp32 always (decay products
    # compound; a bf16 state drifts over long contexts)
    h = (torch.zeros((Bsz, H, N, P), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    states = states.to(f32)
    h_in = []
    for c in range(nc):
        h_in.append(h)                            # the state entering chunk c
        h = h * torch.exp(seg_end[:, c])[:, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)               # (B, nc, H, N, P)

    # inter-chunk contribution: y_i += C_i . (exp(cum_i) h_in)
    y_inter = torch.einsum("bcin,bchnp->bcihp", Cm.to(f32), h_in) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y[:, :S0], h


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, h: torch.Tensor):
    """One token: x (B, H, P), dt (B, H), Bm and Cm (B, N), h (B, H, N, P)
    -> (y, h'): decay, rank-1 state update, readout."""
    dA = torch.exp(dt * A)                        # (B, H)
    inc = dt[:, :, None, None] * Bm[:, None, :, None] * x[:, :, None, :]
    h = h * dA[:, :, None, None] + inc
    # the readout sums over N in one order whatever the batch
    # (`model_bmm`): a request's stream must not follow its neighbours
    Bsz, H, N, P = h.shape
    y = model_bmm(Cm[:, None, :],
                    h.permute(0, 2, 1, 3).reshape(Bsz, N, H * P))
    return y.reshape(Bsz, H, P), h


def mamba2_apply(p: dict, x: torch.Tensor, cfg, *,
                 state: Optional[SSMState] = None,
                 decode: Optional[bool] = None
                 ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """x (B, S, d_model) -> (out, new state).  decode=True expects S == 1
    and runs `ssd_step`; decode=None picks it for a single carried-state
    token.  The transformer block passes the flag explicitly, so a prefill
    of one token takes the chunked scan (at Q = 1), as JAX's does."""
    Bsz, S, _ = x.shape
    di, H, P, N, conv_dim = _dims(cfg)
    f32 = torch.float32
    if decode is None:
        decode = state is not None and S == 1

    x = grad_reduced(x)
    proj = scaled(serve_matmul(x, p["Win"]), p, "Win", cfg.quant)
    z, xin, Bc, Cc, dt = torch.split(proj, [di, di, N, N, H], dim=-1)
    dt = F.softplus(dt.to(f32) + p["dt_bias"])    # (B, S, H)
    A = -torch.exp(p["A_log"])

    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    tail = state.conv if state is not None else None
    conv_out, new_tail = _causal_conv(conv_in, p["conv_w"], p["conv_b"], tail)
    xin, Bc, Cc = torch.split(conv_out, [di, N, N], dim=-1)
    xh = constrain(xin.reshape(Bsz, S, H, P), DATA, None, "model", None)
    h0 = state.h if state is not None else None

    if decode:
        h0 = (h0 if h0 is not None else
              torch.zeros((Bsz, H, N, P), dtype=f32, device=x.device)).to(f32)
        y1, hT = ssd_step(xh[:, 0].to(f32), dt[:, 0], A, Bc[:, 0].to(f32),
                          Cc[:, 0].to(f32), h0)
        y = y1[:, None]
    else:
        scan = lambda *a: ssd_chunked(*a[:5], cfg.ssm_chunk, a[5])
        args = (xh, dt, A, Bc, Cc, h0)
        if isinstance(xh, DTensor):  # (B, S, H, P): batch and heads apart
            bshp, bhnp = (shard_like(xh, {0: 0, 2: d}) for d in (2, 1))
            y, hT = on_shards(scan, xh.device_mesh, args,
                              (bshp, bshp, shard_like(xh, {2: 0}),
                               shard_like(xh, {0: 0}), shard_like(xh, {0: 0}),
                               bhnp), (bshp, bhnp))
        else:
            y, hT = scan(*args)

    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh.to(y.dtype)
    y = y.reshape(Bsz, S, di)

    # gated RMSNorm (mamba2): norm(y * silu(z)), fp32 inside
    g32 = (y * F.silu(z)).to(f32)
    g = (g32 * torch.rsqrt(mean_square(g32) + 1e-6)).to(x.dtype) * \
        p["norm"].to(x.dtype)

    out = scaled_sum(serve_matmul(g, p["Wout"]), p, "Wout", cfg.quant)
    new_state = None
    if state is not None or decode:
        pos = (state.pos if state is not None else
               torch.zeros((), dtype=torch.int32, device=x.device)) + S
        new_state = SSMState(h=hT, conv=new_tail, pos=pos)
    return out, new_state


def state_init(cfg, batch: int, dtype=torch.float32, *,
               per_slot: bool = False, lead: tuple = (),
               device=None) -> SSMState:
    """Zero per-session recurrent state.  `per_slot` makes the token counter
    (B,) so every continuous-batching slot tracks its own depth; `lead`
    prepends stacked axes (the layer repeats) to every leaf."""
    di, H, P, N, conv_dim = _dims(cfg)
    z = lambda shape, dt: torch.zeros(lead + shape, dtype=dt, device=device)
    return SSMState(h=z((batch, H, N, P), torch.float32),  # fp32 core
                    conv=z((batch, cfg.ssm_conv - 1, conv_dim), dtype),
                    pos=z((batch,) if per_slot else (), torch.int32))


ssm_state_init = state_init  # JAX's historical name
