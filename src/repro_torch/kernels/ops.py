"""Public wrappers around the kernels, ported from `repro/kernels/ops.py`:
padding, alpha scaling, the GEMV/GEMM routing, `quantize_pack`, and
`qmatmul` — the one matmul entry for fp and packed weights — plus the
fused decode tick's gate-aligned code layout and public entry."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.qtensor import QTensor
from repro_torch.core.quantize import pack_group
from repro_torch.kernels import decode_step as DK
from repro_torch.kernels import packed_matmul as PK

# x with at most this many rows takes the multiply-free GEMV, more the GEMM
GEMV_MAX_ROWS = 8


def packed_matmul(x: torch.Tensor, codes: torch.Tensor, alpha=1.0, *,
                  mode: str = "ternary") -> torch.Tensor:
    """y = alpha * (x @ unpack(codes)).  x (..., K), codes (Kp/G, N) int32
    with Kp >= K.

    Leading dims flatten into M.  x is zero-padded to the codes' K coverage,
    so pad codes add nothing.  M <= 8 routes to the multiply-free GEMV, more
    rows to the GEMM."""
    group = pack_group(mode)
    lead = x.shape[:-1]
    K = x.shape[-1]
    N = codes.shape[1]
    kp = codes.shape[0] * group
    if kp < K:
        raise ValueError(f"codes cover K={kp} < {K}")
    xm = F.pad(x.reshape(-1, K).float(), (0, kp - K)).contiguous()
    if xm.shape[0] <= GEMV_MAX_ROWS:
        y = PK.packed_gemv(xm, codes, mode=mode)
    else:
        y = PK.packed_matmul(xm, codes, mode=mode)
    return (y * alpha).reshape(*lead, N)


def quantize_pack(w: torch.Tensor, u: torch.Tensor, alpha, *,
                  mode: str = "ternary") -> torch.Tensor:
    """Fused stochastic quantize (paper Eqs. 4-6) and bit-pack.  w and u
    (K, N) with K % G == 0; returns (K/G, N) int32 bit-views of the packed
    words.  Pad a ragged K with w = 0 and u = 1.0: every pad code is then 0
    in both modes, the layout `QTensor.from_master` pads to."""
    return PK.quantize_pack(w.float().contiguous(), u.float().contiguous(),
                            float(alpha), mode=mode)


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """y = x @ w for an fp `w`, the packed kernels for a `QTensor` `w`.

    A stacked QTensor (codes (L, ..., K/G, N)) applies per matrix: x's
    leading axis must match L.  The output dtype follows x."""
    if not isinstance(w, QTensor):
        return x @ w
    if w.codes.dim() > 2:
        L = w.codes.shape[0]
        if x.shape[0] != L:
            raise ValueError(f"stacked QTensor with {L} matrices needs x "
                             f"batched the same way, got x {tuple(x.shape)}")
        return torch.stack([
            qmatmul(x[i], QTensor(codes=w.codes[i], k=w.k, mode=w.mode,
                                  alpha=w.alpha,
                                  scale=None if w.scale is None else w.scale[i]))
            for i in range(L)])
    if x.shape[-1] != w.k:
        raise ValueError(f"qmatmul contraction mismatch: x {tuple(x.shape)} vs "
                         f"QTensor k={w.k}")
    y = packed_matmul(x, w.codes, w.alpha, mode=w.mode)
    if w.scale is not None:
        y = y * w.scale
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# fused whole-tick recurrent decode (kernels/decode_step.py)
# ---------------------------------------------------------------------------


def prepare_gate_codes(qt: QTensor, n_gates: int) -> torch.Tensor:
    """Gate-align a packed recurrent weight for the fused tick: `qt` packs
    wh (H, n_gates*H); each gate's columns are sliced out and padded to the
    128-column tile Hp, the code rows to Hp/G, and the gates stacked:
    (n_gates, Hp/G, Hp) int32.  Done once per serving session."""
    if qt.scale is not None:
        raise ValueError("fused decode does not support channel-scaled "
                         "QTensors (RNN export packs scale-free weights); "
                         "use the unfused path")
    kg, N = qt.codes.shape
    H = N // n_gates
    if H * n_gates != N or qt.k != H:
        raise ValueError(f"expected a square-per-gate (H, {n_gates}*H) "
                         f"recurrent weight, got k={qt.k}, N={N}")
    hp = -(-max(H, 1) // DK.BN_TILE) * DK.BN_TILE
    gates = [F.pad(qt.codes[:, i * H:(i + 1) * H],
                   (0, hp - H, 0, hp // qt.group - kg))
             for i in range(n_gates)]
    return torch.stack(gates).contiguous()


def tick_operands(tok: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                  tick: dict, live: Optional[torch.Tensor] = None) -> tuple:
    """The padded operands of `decode_step.fused_tick` for one tick: the
    layer-0 row gather, batch padded to a multiple of 4 (the kernel's
    smallest row pass) and gate width to Hp, the live mask as 0/1 rows,
    and the padded head."""
    L, B, H = h.shape
    codes_h = tick["codes_h"]
    g, hp = codes_h.shape[1], codes_h.shape[-1]
    bp = -(-max(B, 1) // DK.ROW_PAD) * DK.ROW_PAD
    f32 = torch.float32

    rows = tick["rows0"][tok].to(f32)                          # (B, g*H)
    ax0 = F.pad(rows.reshape(B, g, H), (0, hp - H, 0, 0, 0, bp - B))
    pad_state = lambda a: F.pad(a.to(f32), (0, hp - H, 0, bp - B)).contiguous()
    if live is None:
        live_m = torch.ones((bp, hp), dtype=f32, device=h.device)
    else:  # pad rows 0: they select their (zero) previous state
        live_m = F.pad(live.to(f32)[:, None].expand(B, hp), (0, 0, 0, bp - B))
    return (ax0.contiguous(), pad_state(h), pad_state(c), live_m.contiguous(),
            codes_h, tick["codes_x"], tick["scale_h"], tick["shift_h"],
            tick["scale_x"], tick["shift_x"], tick["scale_c"],
            tick["shift_c"], tick["ws"], tick["bs"])


def fused_decode_tick(tok: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                      tick: dict, *, cell: str, mode: str, vocab: int,
                      live: Optional[torch.Tensor] = None):
    """One whole-model decode tick in one fused launch.

    tok (B,) int; h/c (L, B, H); `tick` is the stacked artifact that
    `core.bnlstm.rnn_decode_tables` builds once per session (rows0, codes_h,
    codes_x, scale/shift h/x/c, ws, bs).  The layer-0 row gather runs
    before the launch; the head and the greedy argmax run inside it, at any
    vocab.  `live` (B,) bool freezes dead rows bit for bit.

    Returns (logits (B, vocab), h', c', greedy (B,) int32)."""
    L, B, H = h.shape
    hn, cn, lg, greedy = DK.fused_tick(*tick_operands(tok, h, c, tick, live),
                                       cell=cell, mode=mode)
    return (lg[:B, :vocab].to(h.dtype), hn[:, :B, :H].to(h.dtype),
            cn[:, :B, :H].to(h.dtype), greedy[:B])
