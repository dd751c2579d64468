"""Whole-tick fused decode for BN-LSTM / BN-GRU serving, ported from
`repro/kernels/decode_step.py`.

One batched decode tick — every layer, then the logits head with a greedy
argmax — is one launch of csrc/fused_tick.cu.  Per layer: the
multiply-free h-side GEMV per gate against gate-aligned packed codes, the
frozen-BN affine (its scale folds the QTensor alpha), the LSTM or GRU gate
math with the cell-norm affine, and the `live` row select, so dead rows keep
h and c bit for bit even when they hold non-finite values.  Layers >= 1 run
their x-side GEMV in the same launch.  `fused_tick_plain` is the same
function in plain PyTorch; the wrapper runs it for CPU tensors.

Operands arrive padded from `ops.fused_decode_tick`: batch to a multiple of
4 (the kernel's row pass), each gate's width to the 128-column tile, code
rows to Hp/G.  Pad lanes carry zero activations and zero affines, so pad
h/c stay 0.0 across layers, and pad logit columns sit at finfo.min through
the padded bias.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import pack_group
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.packed_matmul import (MODES, packed_gemv_plain,
                                                rowwise_matmul)

BN_TILE = 128  # column tile each gate's width is padded to
SLICE_COLS = 8  # columns a block of the CUDA kernel owns (csrc kCols)
ROW_PAD = 4     # the batch is padded to a multiple of the smallest row pass
CELLS = {"lstm": 0, "gru": 1}


def greedy_argmax(lg: torch.Tensor) -> torch.Tensor:
    """Row argmax with ties to the minimum index, as the JAX kernel takes
    it: a row whose max is NaN matches no column and gets Vp."""
    vp = lg.shape[-1]
    mx = lg.max(dim=-1, keepdim=True).values
    col = torch.arange(vp, device=lg.device).expand_as(lg)
    return torch.where(lg == mx, col, vp).min(dim=-1).values.to(torch.int32)


def tick_rows(bp: int) -> int:
    """Batch rows one pass of the CUDA kernel covers: 8 where they divide
    the padded batch, else 4."""
    if bp < 1 or bp % ROW_PAD:
        raise ValueError(f"fused_tick needs the batch padded to {ROW_PAD}, "
                         f"got {bp}")
    return 8 if bp % 8 == 0 else 4


def tick_late_head(vp: int, n_sm: int) -> bool:
    """Whether the CUDA kernel runs the head after its last barrier, in
    units of 128 columns: where the head has at least 32 columns an SM
    (word-PTB's Vp 10,112 on 132 SMs), so ws streams once a row pass from a
    quarter of the SMs or more.  A narrower head (rnn-paper's Vp 128) is
    instead summed from partial products that each block computes as soon
    as it has written its slice of h; those partials take bp/8 times the
    bytes of ws, which only a narrow head can afford."""
    return vp % 128 == 0 and vp // 32 >= n_sm


def tick_grid_max(bp: int, hp: int, vp: int) -> int:
    """The most blocks the kernel launches (it takes fewer where fewer are
    co-resident): one per 8-column slice of Hp, or one per 8-column unit
    of the head's rows, whichever is more."""
    return max(hp // SLICE_COLS, -(-bp * vp // 8))


def fused_tick_plain(ax0, h, c, live, codes_h, codes_x, scale_h, shift_h,
                     scale_x, shift_x, scale_c, shift_c, ws, bs, *,
                     cell: str, mode: str):
    """Plain version of the fused tick, operand for operand."""
    L, g = codes_h.shape[:2]
    ax = ax0
    alive = live > 0
    h_out, c_out = [], []
    h_new = None
    for l in range(L):
        h_prev, c_prev = h[l], c[l]
        ah = [packed_gemv_plain(h_prev, codes_h[l, i], mode=mode)
              for i in range(g)]
        if cell == "lstm":
            f, i_, o, gg = [ah[i] * scale_h[l, i] + shift_h[l, i] + ax[:, i]
                            for i in range(4)]
            c_new = torch.sigmoid(f) * c_prev + torch.sigmoid(i_) * torch.tanh(gg)
            cn = c_new * scale_c[l] + shift_c[l]
            h_new = torch.where(alive, torch.sigmoid(o) * torch.tanh(cn), h_prev)
            c_sel = torch.where(alive, c_new, c_prev)
        else:
            ahn = [ah[i] * scale_h[l, i] + shift_h[l, i] for i in range(3)]
            r = torch.sigmoid(ax[:, 0] + ahn[0])
            z = torch.sigmoid(ax[:, 1] + ahn[1])
            gg = torch.tanh(ax[:, 2] + r * ahn[2])
            h_new = torch.where(alive, (1.0 - z) * h_prev + z * gg, h_prev)
            c_sel = c_prev
        h_out.append(h_new)
        c_out.append(c_sel)
        if l + 1 < L:
            ax = torch.stack(
                [packed_gemv_plain(h_new, codes_x[l, i], mode=mode)
                 * scale_x[l, i] + shift_x[l, i] for i in range(g)], dim=1)
    lg = rowwise_matmul(h_new, ws) + bs  # a row's logits: its own bits
    return torch.stack(h_out), torch.stack(c_out), lg, greedy_argmax(lg)


def fused_tick(ax0, h, c, live, codes_h, codes_x, scale_h, shift_h, scale_x,
               shift_x, scale_c, shift_c, ws, bs, *, cell: str, mode: str):
    """Padded-operand entry (see ops.fused_decode_tick for the public API).

    ax0 (Bp, g, Hp) layer-0 input preact, bias folded; h/c (L, Bp, Hp);
    live (Bp, Hp) fp32 0/1; codes_h (L, g, Hp/G, Hp) int32; codes_x
    (max(L-1, 1), g, Hp/G, Hp); scale_h/shift_h (L, g, Hp); scale_x/shift_x
    like codes_x's leading axes; scale_c/shift_c (L, 1, Hp); the head ws
    (Hp, Vp) and bs (1, Vp), at any Vp.

    Returns (h', c', logits (Bp, Vp), greedy (Bp,) int32).
    """
    group = pack_group(mode)
    L, g, kg, hp = codes_h.shape
    bp = ax0.shape[0]
    if hp % BN_TILE or kg * group != hp:
        raise ValueError(f"codes {tuple(codes_h.shape)} must be Hp/{group} x "
                         f"Hp with Hp % {BN_TILE} == 0")
    if tuple(h.shape) != (L, bp, hp) or tuple(live.shape) != (bp, hp):
        raise ValueError(f"state {tuple(h.shape)} / live {tuple(live.shape)} "
                         f"must match padded ({L}, {bp}, {hp})")
    if g != (4 if cell == "lstm" else 3):
        raise ValueError(f"{cell} needs {4 if cell == 'lstm' else 3} gates, "
                         f"codes carry {g}")
    args = (ax0, h, c, live, codes_h, codes_x, scale_h, shift_h, scale_x,
            shift_x, scale_c, shift_c, ws, bs)
    if not dispatch.on_card("fused_tick", *args):
        dispatch.count_plain("fused_tick")
        return fused_tick_plain(*args, cell=cell, mode=mode)

    rows = tick_rows(bp)
    lx = codes_x.shape[0]
    f32, i32 = torch.float32, torch.int32
    for name, t, dt, shape in (
            ("ax0", ax0, f32, (bp, g, hp)), ("h", h, f32, (L, bp, hp)),
            ("c", c, f32, (L, bp, hp)), ("live", live, f32, (bp, hp)),
            ("codes_h", codes_h, i32, (L, g, kg, hp)),
            ("codes_x", codes_x, i32, (lx, g, kg, hp)),
            ("scale_h", scale_h, f32, (L, g, hp)),
            ("shift_h", shift_h, f32, (L, g, hp)),
            ("scale_x", scale_x, f32, (lx, g, hp)),
            ("shift_x", shift_x, f32, (lx, g, hp)),
            ("scale_c", scale_c, f32, (L, 1, hp)),
            ("shift_c", shift_c, f32, (L, 1, hp)),
            ("ws", ws, f32, (hp, ws.shape[1])),
            ("bs", bs, f32, (1, ws.shape[1]))):
        dispatch.check(f"fused_tick {name}", t, dt, shape)
    vp = ws.shape[1]
    if vp % BN_TILE:
        raise ValueError(f"head width {vp} must be a multiple of {BN_TILE}")
    dev = h.device
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    grid_max = tick_grid_max(bp, hp, vp)
    late = tick_late_head(
        vp, torch.cuda.get_device_properties(dev).multi_processor_count)
    logits = torch.empty((bp, vp), dtype=f32, device=dev)
    greedy = torch.empty((bp,), dtype=i32, device=dev)
    # per-slice head partials (early head only) and per-8-column argmax
    # partials
    head_part = torch.empty((1,) if late else
                            (vp // 8, bp, hp // SLICE_COLS, 8), dtype=f32,
                            device=dev)
    part_val = torch.empty((bp, vp // 8), dtype=f32, device=dev)
    part_idx = torch.empty((bp, vp // 8), dtype=i32, device=dev)
    part_nan = torch.empty((bp, vp // 8), dtype=i32, device=dev)
    ticket = torch.empty((1,), dtype=i32, device=dev)  # the kernel zeroes it
    build.launch("fused_tick", dev, *(t.data_ptr() for t in args),
                 h_out.data_ptr(), c_out.data_ptr(), logits.data_ptr(),
                 greedy.data_ptr(), head_part.data_ptr(), part_val.data_ptr(),
                 part_idx.data_ptr(), part_nan.data_ptr(), ticket.data_ptr(),
                 L, bp, hp, vp, CELLS[cell], MODES[mode], rows, int(late),
                 grid_max)
    dispatch.count_launch("fused_tick")
    return h_out, c_out, logits, greedy
