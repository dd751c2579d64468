"""BN-LSTM / BN-GRU with learned recurrent binary/ternary weights, ported
from `repro/core/bnlstm.py` (paper Algorithm 1, Eq. 7).

Training (`rnn_lm_apply(training=True)`, `lm_loss`, `clip_masters`):
the fp32 masters are sampled once per forward pass into binary/ternary
weights, with the straight-through gradient, from uniform noise that is
either drawn from an explicit `torch.Generator` (`draw_noise`) or injected
by the caller as one `(ux, uh)` pair per layer; every matmul is
batch-normalized per timestep with gate-BN additive terms fixed at 0.  The
layer-0 token gather runs as a one-hot matmul, so its backward is a matmul
as well: the same on every run, where an indexed scatter-add into the
weight's gradient may use atomics on the card.

The trained masters export once into packed `QTensor`s (`export_packed_rnn`)
and serving runs against frozen BN statistics.  At inference every BN is a
per-column affine

    y = x * (phi * rsqrt(var + eps)) + (gamma - phi * mean * rsqrt(var + eps))

so a step is gathers, (packed) matmuls, affines and gate nonlinearities —
the shape the fused decode kernel consumes.  `rnn_decode_tables` folds the
statistics into those affines once per session, and, for a packed tree,
stacks the whole-tick artifact that `rnn_decode_step` feeds one launch of
the fused kernel per tick.

The engine's chunked prefill / verify / speculative commit are not ported
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import quantize as Q
from repro_torch.core.qtensor import export_packed, is_qtensor, tree_to
from repro_torch.core.recurrent_bn import BNParams, BNState, bn_apply, bn_init
from repro_torch.kernels import decode_step as DK
from repro_torch.kernels import dispatch
from repro_torch.kernels import ops as OPS

# Algorithm 1's split: quantize the recurrent and input matrices, keep the
# softmax classifier 'ws' and every bias/BN parameter fp
RNN_POLICY = Q.QuantPolicy(include=("wx", "wh"))


@dataclasses.dataclass(frozen=True)
class RNNConfig:
    vocab: int
    d_hidden: int
    n_layers: int = 1
    cell: str = "lstm"  # 'lstm' | 'gru'
    quant: Q.QuantSpec = Q.QuantSpec(mode="ternary", norm="batch")
    cell_norm: bool = True  # BN on the cell state (Algorithm 1 line 13)
    eps: float = 1e-5
    momentum: float = 0.99
    dtype: Any = torch.float32

    @property
    def n_gates(self) -> int:
        return 4 if self.cell == "lstm" else 3


# ---------------------------------------------------------------------------
# init and export
# ---------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, a: float, dtype) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=dtype) * 2.0 - 1.0) * a


def _layer_init(gen: torch.Generator, d_in: int, cfg: RNNConfig) -> dict:
    h, g = cfg.d_hidden, cfg.n_gates
    wx = _uniform(gen, (d_in, g * h), Q.glorot_alpha(d_in, g * h), cfg.dtype)
    wh = _uniform(gen, (h, g * h), Q.glorot_alpha(h, g * h), cfg.dtype)
    bn_x, bn_x_s = bn_init(g * h, dtype=cfg.dtype)
    bn_h, bn_h_s = bn_init(g * h, dtype=cfg.dtype)
    bn_c, bn_c_s = bn_init(h, dtype=cfg.dtype)
    params = {"wx": wx, "wh": wh, "b": torch.zeros((g * h,), dtype=cfg.dtype),
              "bn_x": bn_x, "bn_h": bn_h, "bn_c": bn_c}
    state = {"bn_x": bn_x_s, "bn_h": bn_h_s, "bn_c": bn_c_s}
    return {"params": params, "state": state}


def rnn_lm_init(gen: torch.Generator, cfg: RNNConfig, *,
                device: Optional[str | torch.device] = None) -> dict:
    """{'params': trainable, 'state': BN running stats}, drawn from the CPU
    generator `gen` (so a seed gives the same weights on every device) and
    moved to `device` (the card unless the caller asks for the CPU)."""
    device = dispatch.resolve_device(device)
    layers = []
    d_in = cfg.vocab
    for _ in range(cfg.n_layers):
        layers.append(_layer_init(gen, d_in, cfg))
        d_in = cfg.d_hidden
    a = Q.glorot_alpha(cfg.d_hidden, cfg.vocab)
    head = {"ws": _uniform(gen, (cfg.d_hidden, cfg.vocab), a, cfg.dtype),
            "bs": torch.zeros((cfg.vocab,), dtype=cfg.dtype)}
    var = {"params": {"layers": [l["params"] for l in layers], "head": head},
           "state": {"layers": [l["state"] for l in layers]}}
    return tree_to(var, device)


def export_packed_rnn(params: dict, cfg: RNNConfig) -> dict:
    """Pack a trained master tree for serving: every `wx`/`wh` becomes a
    QTensor; head, biases and BN parameters stay fp."""
    return export_packed(params, cfg.quant, policy=RNN_POLICY)


def serving_variables(params: dict, bn_state: dict, cfg: RNNConfig) -> dict:
    """The train -> serve handoff: pack the trained masters and carry the
    training run's BN running statistics along as the frozen serving
    statistics."""
    return {"params": export_packed_rnn(params, cfg), "state": bn_state}


def draw_noise(params: dict, gen: torch.Generator) -> list:
    """Uniform [0, 1) noise for one training forward: `(ux, uh)` per layer,
    in that order, shaped like the layer's `wx` and `wh` and drawn on
    their device from `gen` (a generator of that device)."""
    return [tuple(torch.rand(lp[k].shape, generator=gen, dtype=lp[k].dtype,
                             device=lp[k].device) for k in ("wx", "wh"))
            for lp in params["layers"]]


def _quantized_weights(params, cfg: RNNConfig, *, training: bool = False,
                       gen: Optional[torch.Generator] = None,
                       noise: Optional[list] = None) -> list:
    """The weights of one forward pass, per layer `(qx, qh)`.

    Packed QTensors pass through.  In training, binary/ternary masters are
    sampled with the straight-through gradient from `noise` (one `(ux, uh)`
    per layer), drawn from `gen` when not given; other modes go through
    `Q.apply_quant`.  At inference, binary/ternary masters quantize
    deterministically."""
    stochastic = (cfg.quant.stochastic and training
                  and cfg.quant.mode in ("binary", "ternary"))
    if stochastic and noise is None:
        if gen is None:
            raise ValueError("stochastic quantization needs noise in training "
                             "mode: pass `noise` or a generator `gen`")
        noise = draw_noise(params, gen)
    out = []
    for l, lp in enumerate(params["layers"]):
        wx, wh = lp["wx"], lp["wh"]
        if is_qtensor(wx) and is_qtensor(wh):
            out.append((wx, wh))
            continue
        if is_qtensor(wx) or is_qtensor(wh):
            raise ValueError(
                f"layer {l}: mixed packed/fp weights (wx packed={is_qtensor(wx)}, "
                f"wh packed={is_qtensor(wh)}); export both or neither")
        ax, ah = Q.glorot_alpha(*wx.shape), Q.glorot_alpha(*wh.shape)
        ux, uh = noise[l] if stochastic else (None, None)
        if cfg.quant.mode in ("binary", "ternary") and not stochastic:
            qx = Q.quantize(wx, cfg.quant.mode, ax, stochastic=False)
            qh = Q.quantize(wh, cfg.quant.mode, ah, stochastic=False)
        else:
            qx = Q.apply_quant(wx, cfg.quant, ax, ux)
            qh = Q.apply_quant(wh, cfg.quant, ah, uh)
        out.append((qx, qh))
    return out


# ---------------------------------------------------------------------------
# the training forward (Algorithm 1): cells, the time loop, the loss
# ---------------------------------------------------------------------------


def _lstm_step(h, c, ax, ah, b, bn_c_p, bn_c_s, cfg: RNNConfig, training):
    f, i, o, g = torch.chunk(ax + ah + b, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    if cfg.cell_norm:
        cn, bn_c_s = bn_apply(c, bn_c_p, bn_c_s, training=training,
                              eps=cfg.eps, momentum=cfg.momentum)
    else:
        cn = c
    return torch.sigmoid(o) * torch.tanh(cn), c, bn_c_s


def _gru_step(h, ax, ah, b, H: int):
    """ax, ah (B, 3H) batch-normalized preacts; b (3H,)."""
    r = torch.sigmoid(ax[..., :H] + ah[..., :H] + b[:H])
    z = torch.sigmoid(ax[..., H:2 * H] + ah[..., H:2 * H] + b[H:2 * H])
    g = torch.tanh(ax[..., 2 * H:] + r * ah[..., 2 * H:] + b[2 * H:])
    return (1.0 - z) * h + z * g


def _embed(rows: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """rows[tokens] as one_hot(tokens) @ rows: the same values (a sum of one
    row and zeros is exact), with a matmul for a backward."""
    return F.one_hot(tokens.long(), rows.shape[0]).to(rows.dtype) @ rows


def rnn_lm_apply(variables: dict, tokens: torch.Tensor, cfg: RNNConfig, *,
                 training: bool, gen: Optional[torch.Generator] = None,
                 noise: Optional[list] = None, return_state: bool = False,
                 features_only: bool = False):
    """tokens (B, T) int.  Returns logits (B, T, vocab) and, with
    `return_state`, the updated BN running statistics.  `features_only`
    returns the top layer's hidden states (B, T, H) instead of logits.
    Training samples the weights from `noise` or `gen` (see
    `_quantized_weights`)."""
    params, state = variables["params"], variables["state"]
    B, T = tokens.shape
    H = cfg.d_hidden
    qw = _quantized_weights(params, cfg, training=training, gen=gen,
                            noise=noise)
    bn = dict(training=training, eps=cfg.eps, momentum=cfg.momentum)
    x_seq = tokens
    new_state = {"layers": []}
    for l in range(cfg.n_layers):
        lp, ls = params["layers"][l], state["layers"][l]
        qx, qh = qw[l]
        if l == 0:
            rows = qx.dequantize(cfg.dtype) if is_qtensor(qx) else qx
            x_proj = _embed(rows, x_seq)                     # (B, T, gH)
        else:
            x_proj = OPS.qmatmul(x_seq, qx)
        h = torch.zeros((B, H), dtype=cfg.dtype, device=tokens.device)
        c = torch.zeros_like(h)
        s_x, s_h, s_c = ls["bn_x"], ls["bn_h"], ls["bn_c"]
        hs = []
        for t in range(T):
            axn, s_x = bn_apply(x_proj[:, t], lp["bn_x"], s_x,
                                trainable_gamma=False, **bn)
            ahn, s_h = bn_apply(OPS.qmatmul(h, qh), lp["bn_h"], s_h,
                                trainable_gamma=False, **bn)
            if cfg.cell == "lstm":
                h, c, s_c = _lstm_step(h, c, axn, ahn, lp["b"], lp["bn_c"],
                                       s_c, cfg, training)
            else:
                h = _gru_step(h, axn, ahn, lp["b"], H)
            hs.append(h)
        x_seq = torch.stack(hs, dim=1)                      # (B, T, H)
        new_state["layers"].append({"bn_x": s_x, "bn_h": s_h, "bn_c": s_c})

    if features_only:
        out = x_seq
    else:
        out = x_seq @ params["head"]["ws"] + params["head"]["bs"]
    if return_state:
        return out, new_state
    return out


def lm_loss(variables: dict, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: RNNConfig, *, training: bool,
            gen: Optional[torch.Generator] = None,
            noise: Optional[list] = None):
    """Mean next-token cross entropy (nats) and the new BN state.
    BPC = loss / ln(2)."""
    logits, new_state = rnn_lm_apply(variables, tokens, cfg,
                                     training=training, gen=gen, noise=noise,
                                     return_state=True)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    return nll.mean(), new_state


def clip_masters(params: dict, cfg: RNNConfig) -> dict:
    """Post-update clip of every `wx`/`wh` master to [-alpha, alpha], alpha
    from the matrix's own shape.  No-op for unquantized configs."""
    if not cfg.quant.enabled:
        return params
    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        for k in ("wx", "wh"):
            lp[k] = Q.clip_master(lp[k], Q.glorot_alpha(*lp[k].shape))
        layers.append(lp)
    return {**params, "layers": layers}


# ---------------------------------------------------------------------------
# stateful serving against frozen BN statistics
# ---------------------------------------------------------------------------


class RNNState(NamedTuple):
    """Per-session state: stacked per-layer hidden/cell vectors.  `c` is
    carried (zeros) for GRU too, so both cells share one layout."""

    h: torch.Tensor    # (n_layers, B, H)
    c: torch.Tensor    # (n_layers, B, H)
    pos: torch.Tensor  # () int32 tokens consumed


def rnn_state_init(cfg: RNNConfig, batch: int, dtype=None, *,
                   device: Optional[str | torch.device] = None) -> RNNState:
    device = dispatch.resolve_device(device)
    dtype = dtype or cfg.dtype
    z = torch.zeros((cfg.n_layers, batch, cfg.d_hidden), dtype=dtype,
                    device=device)
    pos = torch.zeros((), dtype=torch.int32, device=device)
    return RNNState(h=z, c=z.clone(), pos=pos)


def _bn_affine(p: BNParams, s: BNState, eps: float):
    """Frozen inference BN as (scale, shift): y = x * scale + shift."""
    inv = torch.rsqrt(s.var + eps)
    return p.phi * inv, p.gamma - p.phi * s.mean * inv


def rnn_decode_tables(variables: dict, cfg: RNNConfig, *,
                      dense: bool = False) -> list:
    """Per-session serving artifacts, computed once and reused every step.

    Per layer: the serving weights, the h-side and x-side BN affines, the
    cell-norm affine, and for layer 0 the token gather table with the
    x-side BN folded in (`rows_bn`).  When the whole tree serves packed,
    `tables[0]["tick"]` holds the stacked whole-tick artifact
    (`_tick_tables`).  `dense=True` expands packed weights into fp tables
    instead: no kernel runs and no tick is built — the unfused plain path
    the fused tick is checked against."""
    params, bn_state = variables["params"], variables["state"]
    qw = _quantized_weights(params, cfg)
    tables = []
    for l in range(cfg.n_layers):
        lp, ls = params["layers"][l], bn_state["layers"][l]
        qx, qh = qw[l]
        if dense and is_qtensor(qh):
            qh = qh.dequantize(cfg.dtype)
        if dense and is_qtensor(qx):
            qx = qx.dequantize(cfg.dtype)
        sx, tx = _bn_affine(lp["bn_x"], ls["bn_x"], cfg.eps)
        sh, th = _bn_affine(lp["bn_h"], ls["bn_h"], cfg.eps)
        if cfg.cell == "lstm" and cfg.cell_norm:
            sc, tc = _bn_affine(lp["bn_c"], ls["bn_c"], cfg.eps)
        else:
            sc = torch.ones_like(lp["b"][: cfg.d_hidden])
            tc = torch.zeros_like(lp["b"][: cfg.d_hidden])
        t = {"qh": qh, "b": lp["b"], "scale_h": sh, "shift_h": th,
             "scale_c": sc, "shift_c": tc}
        if l == 0:
            rows = qx.dequantize(cfg.dtype) if is_qtensor(qx) else qx
            t["rows_bn"] = rows * sx + tx  # gather -> already-BN'd preact
        else:
            t["qx"] = qx
            t["scale_x"], t["shift_x"] = sx, tx
        tables.append(t)
    packed = (all(is_qtensor(t["qh"]) and t["qh"].scale is None
                  for t in tables)
              and all(is_qtensor(t["qx"]) and t["qx"].scale is None
                      for t in tables[1:]))
    if packed:
        tables[0]["tick"] = _tick_tables(params, tables, cfg)
    return tables


def _tick_tables(params: dict, tables: list, cfg: RNNConfig) -> dict:
    """Stacked, padded, fold-complete operands of the fused tick: gate-
    aligned codes for the h-side (all layers) and x-side (layers >= 1), the
    frozen-BN affines with alpha folded into the scales and the bias into
    the input-side shifts (layer 0's bias folds into `rows0`), the
    cell-norm affine, and the padded fp head whose pad bias is finfo.min so
    pad columns never win the argmax."""
    g, H = cfg.n_gates, cfg.d_hidden
    hp = -(-H // DK.BN_TILE) * DK.BN_TILE
    f32 = torch.float32
    pad_g = lambda a: F.pad(a.to(f32).reshape(g, H), (0, hp - H))
    pad_1 = lambda a: F.pad(a.to(f32).reshape(1, H), (0, hp - H))
    codes_h, sh, th, sc, tc = [], [], [], [], []
    codes_x, sx, tx = [], [], []
    rows0 = None
    for l, t in enumerate(tables):
        codes_h.append(OPS.prepare_gate_codes(t["qh"], g))
        sh.append(pad_g(t["scale_h"] * t["qh"].alpha))
        th.append(pad_g(t["shift_h"]))
        sc.append(pad_1(t["scale_c"]))
        tc.append(pad_1(t["shift_c"]))
        if l == 0:
            rows0 = (t["rows_bn"] + t["b"]).to(f32)
        else:
            codes_x.append(OPS.prepare_gate_codes(t["qx"], g))
            sx.append(pad_g(t["scale_x"] * t["qx"].alpha))
            tx.append(pad_g(t["shift_x"] + t["b"]))
    if not codes_x:  # single layer: a dummy operand the kernel never reads
        codes_x = [torch.zeros_like(codes_h[0])]
        sx = [torch.zeros_like(sh[0])]
        tx = [torch.zeros_like(sh[0])]
    head = params["head"]
    V = cfg.vocab
    vp = -(-V // DK.BN_TILE) * DK.BN_TILE
    ws = F.pad(head["ws"].to(f32), (0, vp - V, 0, hp - H))
    bs = torch.full((1, vp), torch.finfo(f32).min, dtype=f32,
                    device=ws.device)
    bs[0, :V] = head["bs"].to(f32)
    stack = lambda xs: torch.stack(xs).contiguous()
    return {"rows0": rows0, "codes_h": stack(codes_h),
            "codes_x": stack(codes_x), "scale_h": stack(sh),
            "shift_h": stack(th), "scale_x": stack(sx), "shift_x": stack(tx),
            "scale_c": stack(sc), "shift_c": stack(tc),
            "ws": ws.contiguous(), "bs": bs}


def _serve_lstm_step(t: dict, ax, h, c):
    """ax (B, 4H) BN'd input-side preact (no bias).  Returns (h', c')."""
    ah = OPS.qmatmul(h, t["qh"]) * t["scale_h"] + t["shift_h"]
    f, i, o, g = torch.chunk(ax + ah + t["b"], 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    cn = c * t["scale_c"] + t["shift_c"]
    return torch.sigmoid(o) * torch.tanh(cn), c


def _serve_gru_step(t: dict, ax, h):
    """ax (B, 3H) BN'd input-side preact (no bias).  Returns h'."""
    ah = OPS.qmatmul(h, t["qh"]) * t["scale_h"] + t["shift_h"]
    axb = ax + t["b"]
    H = h.shape[-1]
    r = torch.sigmoid(axb[..., :H] + ah[..., :H])
    z = torch.sigmoid(axb[..., H:2 * H] + ah[..., H:2 * H])
    g = torch.tanh(axb[..., 2 * H:] + r * ah[..., 2 * H:])
    return (1.0 - z) * h + z * g


def _serve_x_preact(t: dict, l: int, x, dtype):
    """Input-side BN'd preact: layer 0 gathers the folded row table (token
    ids in, no matmul); deeper layers project the layer below."""
    if l == 0:
        return t["rows_bn"][x].to(dtype)
    return OPS.qmatmul(x, t["qx"]) * t["scale_x"] + t["shift_x"]


def _serve_scan_layer(t: dict, ax_seq, h0, c0, cell: str):
    """One layer over a (B, T, gH) preact sequence.  Returns (hs, cs, hl,
    cl): per-step h/c stacked over time, (T, B, H) (cs None for GRU), and
    the final carry."""
    h, c = h0, c0
    hs, cs = [], []
    for step in range(ax_seq.shape[1]):
        if cell == "lstm":
            h, c = _serve_lstm_step(t, ax_seq[:, step], h, c)
            cs.append(c)
        else:
            h = _serve_gru_step(t, ax_seq[:, step], h)
        hs.append(h)
    return (torch.stack(hs), torch.stack(cs) if cs else None, h, c)


def _prefill_state(variables: dict, tokens, cfg: RNNConfig,
                   state: RNNState, tables: list):
    """The prompt through every layer: (top-layer hs (B, T, H), state)."""
    x_seq = tokens
    hT, cT = [], []
    for l, t in enumerate(tables):
        ax_seq = _serve_x_preact(t, l, x_seq, cfg.dtype)  # (B, T, gH)
        hs, _, hl, cl = _serve_scan_layer(
            t, ax_seq, state.h[l].to(cfg.dtype), state.c[l].to(cfg.dtype),
            cfg.cell)
        x_seq = hs.transpose(0, 1)
        hT.append(hl)
        cT.append(cl)
    new_state = RNNState(h=torch.stack(hT), c=torch.stack(cT),
                         pos=state.pos + tokens.shape[1])
    return x_seq, new_state


def rnn_logits_last(variables: dict, state: RNNState, cfg: RNNConfig):
    """Next-token logits (B, vocab) from a carried state's top-layer h,
    through the (B, 1, H) head shape both prefill flavours share."""
    head = variables["params"]["head"]
    x = state.h[-1].to(cfg.dtype)[:, None]
    return (OPS.qmatmul(x, head["ws"]) + head["bs"])[:, 0]


def rnn_prefill(variables: dict, tokens, cfg: RNNConfig,
                state: Optional[RNNState] = None, *,
                tables: Optional[list] = None):
    """Run the prompt, carrying state.  tokens (B, T) int.  Returns
    (logits (B, T, vocab), new RNNState)."""
    if state is None:
        state = rnn_state_init(cfg, tokens.shape[0], device=tokens.device)
    if tables is None:
        tables = rnn_decode_tables(variables, cfg)
    x_seq, new_state = _prefill_state(variables, tokens, cfg, state, tables)
    head = variables["params"]["head"]
    return OPS.qmatmul(x_seq, head["ws"]) + head["bs"], new_state


def rnn_decode_step(variables: dict, tok, cfg: RNNConfig, state: RNNState, *,
                    tables: Optional[list] = None,
                    fused: Optional[bool] = None,
                    live: Optional[torch.Tensor] = None):
    """One serving step.  tok (B,) or (B, 1) int.  Returns (logits (B,
    vocab), new RNNState).

    With packed tables the whole tick runs as one fused-kernel launch;
    `fused=False` forces the unfused qmatmul path, `fused=True` requires the
    packed tick.  `live` (B,) bool freezes dead rows: their h/c/pos keep
    their values bit for bit (their logits are garbage)."""
    params = variables["params"]
    if tok.dim() == 2:
        tok = tok[:, 0]
    if tables is None:
        tables = rnn_decode_tables(variables, cfg)
    step = 1 if live is None else live.to(state.pos.dtype)

    tick = tables[0].get("tick")
    use_tick = (tick is not None) if fused is None else fused
    if use_tick:
        if tick is None:
            raise ValueError("fused decode needs packed (QTensor) weights; "
                             "export the tree or pass fused=False")
        logits, hT, cT, _greedy = OPS.fused_decode_tick(
            tok, state.h.to(cfg.dtype), state.c.to(cfg.dtype), tick,
            cell=cfg.cell, mode=tables[0]["qh"].mode, vocab=cfg.vocab,
            live=live)
        return logits, RNNState(h=hT, c=cT, pos=state.pos + step)

    x = tok
    hT, cT = [], []
    for l, t in enumerate(tables):
        ax = _serve_x_preact(t, l, x, cfg.dtype)
        h = state.h[l].to(cfg.dtype)
        c = state.c[l].to(cfg.dtype)
        if cfg.cell == "lstm":
            hn, cn = _serve_lstm_step(t, ax, h, c)
        else:
            hn, cn = _serve_gru_step(t, ax, h), c
        if live is not None:
            hn = torch.where(live[:, None], hn, h)
            cn = torch.where(live[:, None], cn, c)
        hT.append(hn)
        cT.append(cn)
        x = hn
    logits = OPS.qmatmul(x, params["head"]["ws"]) + params["head"]["bs"]
    return logits, RNNState(h=torch.stack(hT), c=torch.stack(cT),
                            pos=state.pos + step)
