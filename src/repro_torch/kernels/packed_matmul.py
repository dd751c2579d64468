"""Matmul against 2-bit (ternary) / 1-bit (binary) packed weights, ported
from `repro/kernels/packed_matmul.py`.

Three kernels, each with its plain PyTorch version beside it:

  * `packed_gemv`   — the multiply-free decode-shape GEMV (x has at most 8
                      rows): codes become plus/minus masks and each output
                      column is sum(select(plus, x)) - sum(select(minus, x)).
                      Kernel: csrc/packed_gemv.cu, launched as `gemv_plan`
                      says.
  * `packed_matmul` — the prefill GEMM: codes decode to -1/0/+1 and meet
                      x in an exact fp32 product (on the card: bf16 tensor
                      cores, x split exactly into three bf16 terms).
                      Kernel: csrc/packed_matmul.cu, launched as
                      `matmul_plan` says.
  * `quantize_pack` — paper Eqs. 4-6 stochastic sampling from an explicit
                      uniform-noise operand, fused with bit-packing:
                      (K, N) fp32 -> (K/G, N) words, bit-exact.
                      Kernel: csrc/quantize_pack.cu.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors (kernels/dispatch.py).  Codes are int32 bit-views of the
packed words; the kernels read them as uint32.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import (or_pack, decode_codes, divide,
                                       pack_group)
from repro_torch.kernels import build, dispatch

MODES = {"ternary": 0, "binary": 1}

SMS = 132          # streaming multiprocessors of an H100 SXM
GEMV_COLS = 32     # output columns a block of the GEMV owns (csrc kCols)
GEMM_COLS = 128    # output columns a block of the GEMM owns (csrc BN)
GEMM_ROWS = 16     # output rows a block of the GEMM owns: one mma tile
MAX_CLUSTER = 8    # the portable thread block cluster size


def code_masks(packed: torch.Tensor, *, mode: str):
    """Packed words (K/G, N) -> (plus, minus) boolean masks (K, N).
    Ternary: plus where the code is 0b01, minus where it is 0b11.  Binary:
    plus where the bit is 1, minus where it is 0 (so a zero pad word
    decodes to minus; pad activations are zero, so it adds nothing)."""
    codes = decode_codes(packed, mode)
    if mode == "ternary":
        return codes == 1, codes == 3
    plus = codes == 1
    return plus, ~plus


def packed_gemv_plain(x: torch.Tensor, codes: torch.Tensor, *,
                      mode: str) -> torch.Tensor:
    """Plain version of `packed_gemv`: select and sum, no weight multiply."""
    x = x.float()
    plus, minus = code_masks(codes, mode=mode)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    rows = [(torch.where(plus, xb[:, None], zero)
             - torch.where(minus, xb[:, None], zero)).sum(dim=0) for xb in x]
    return torch.stack(rows)


def packed_matmul_plain(x: torch.Tensor, codes: torch.Tensor, *,
                        mode: str) -> torch.Tensor:
    """Plain version of `packed_matmul`: decode to -1/0/+1 fp32, then an
    fp32 matmul."""
    c = decode_codes(codes, mode)
    if mode == "ternary":
        w = (c == 1).float() - (c == 3).float()
    else:
        w = c.float() * 2.0 - 1.0
    return x.float() @ w


def matmul_plan(M: int, K: int, N: int, *, mode: str) -> dict:
    """How `packed_matmul` launches for x (M, K): a grid of blocks of 16
    rows by 128 columns, times `cluster` blocks splitting K.  The split
    doubles, up to 8, while the grid stays within two blocks an SM and
    every block keeps at least two code words: at M = 16 and N = 4000, 32
    tiles become 256 blocks."""
    tiles = -(-N // GEMM_COLS) * -(-M // GEMM_ROWS)
    words = K // pack_group(mode)
    cluster = 1
    while (cluster < MAX_CLUSTER and tiles * (2 * cluster) <= 2 * SMS
           and 4 * cluster <= words):
        cluster *= 2
    return {"cluster": cluster, "blocks": tiles * cluster}


def gemv_plan(bp: int, K: int, N: int, *, mode: str) -> dict:
    """How `packed_gemv` launches for x (bp, K): the instance of `rows` >= bp
    (1, 2, 4 or 8), a grid of `tiles` blocks of 32 columns times `cluster`
    blocks splitting K, and `vec`, 16-byte code loads where N % 4 == 0 (the
    wrapper also needs the codes 16-byte aligned).  The split doubles, up
    to 8, while the grid is short of one block an SM and every block keeps
    at least one code word: at N = 4000, 125 tiles become 250 blocks in
    clusters of 2."""
    tiles = -(-N // GEMV_COLS)
    words = K // pack_group(mode)
    cluster = 1
    while (cluster < MAX_CLUSTER and tiles * cluster < SMS
           and 2 * cluster <= words):
        cluster *= 2
    rows = next(r for r in (1, 2, 4, 8) if r >= bp)
    return {"rows": rows, "cluster": cluster, "tiles": tiles,
            "blocks": tiles * cluster, "vec": N % 4 == 0}


def _checked(name: str, x: torch.Tensor, codes: torch.Tensor, mode: str):
    group = pack_group(mode)
    M, K = x.shape
    if codes.dim() != 2 or codes.shape[0] * group != K:
        raise ValueError(f"{name}: packed K mismatch: codes {tuple(codes.shape)}"
                         f" x {group} != K={K}")
    if dispatch.on_card(name, x, codes):
        dispatch.check(name, x, torch.float32, (M, K))
        dispatch.check(name, codes, torch.int32, tuple(codes.shape))
        return True
    return False


def packed_gemv(x: torch.Tensor, codes: torch.Tensor, *,
                mode: str) -> torch.Tensor:
    """x (bp <= 8, K) fp32, codes (K/G, N) int32 -> (bp, N) fp32, unscaled."""
    if x.shape[0] > 8:
        raise ValueError(f"packed_gemv takes at most 8 rows, got {x.shape[0]}")
    if not _checked("packed_gemv", x, codes, mode):
        dispatch.count_plain("packed_gemv")
        return packed_gemv_plain(x, codes, mode=mode)
    bp, K = x.shape
    N = codes.shape[1]
    plan = gemv_plan(bp, K, N, mode=mode)
    vec = plan["vec"] and codes.data_ptr() % 16 == 0
    out = torch.empty((bp, N), dtype=torch.float32, device=x.device)
    build.launch("packed_gemv", x.device, x.data_ptr(), codes.data_ptr(),
                 out.data_ptr(), bp, K, N, MODES[mode], plan["rows"],
                 plan["cluster"], plan["tiles"], int(vec))
    dispatch.count_launch("packed_gemv")
    return out


def packed_matmul(x: torch.Tensor, codes: torch.Tensor, *,
                  mode: str) -> torch.Tensor:
    """x (M, K) fp32, codes (K/G, N) int32 -> (M, N) fp32, unscaled."""
    if not _checked("packed_matmul", x, codes, mode):
        dispatch.count_plain("packed_matmul")
        return packed_matmul_plain(x, codes, mode=mode)
    M, K = x.shape
    N = codes.shape[1]
    plan = matmul_plan(M, K, N, mode=mode)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    build.launch("packed_matmul", x.device, x.data_ptr(), codes.data_ptr(),
                 out.data_ptr(), M, K, N, MODES[mode], plan["cluster"])
    dispatch.count_launch("packed_matmul")
    return out


def quantize_pack_plain(w: torch.Tensor, u: torch.Tensor, alpha: float, *,
                        mode: str) -> torch.Tensor:
    """Plain version of `quantize_pack`, step for step the JAX kernel's:
    wn = clip(w / alpha, -1, 1) (an IEEE division); ternary code 0b01 where
    u < |wn| and wn > 0, 0b11 where u < |wn| and wn < 0, else 0; binary bit
    1 where u < (wn + 1) * 0.5."""
    wn = torch.clamp(divide(w.float(), alpha), -1.0, 1.0)
    one = torch.ones((), dtype=torch.int32, device=w.device)
    if mode == "ternary":
        t = torch.where(u < wn.abs(), torch.sign(wn), 0.0)
        codes = torch.where(t > 0, one, torch.where(t < 0, 3 * one, 0 * one))
        return or_pack(codes, pack_group(mode), 2)
    return or_pack((u < (wn + 1.0) * 0.5).to(torch.int32), pack_group(mode), 1)


def quantize_pack(w: torch.Tensor, u: torch.Tensor, alpha: float, *,
                  mode: str) -> torch.Tensor:
    """w, u (K, N) fp32, K % G == 0 -> int32 words (K/G, N)."""
    group = pack_group(mode)
    K, N = w.shape
    if K % group:
        raise ValueError(f"quantize_pack: K={K} not a multiple of {group}")
    if tuple(u.shape) != (K, N):
        raise ValueError(f"quantize_pack: noise {tuple(u.shape)} != w {(K, N)}")
    if not dispatch.on_card("quantize_pack", w, u):
        dispatch.count_plain("quantize_pack")
        return quantize_pack_plain(w, u, alpha, mode=mode)
    dispatch.check("quantize_pack w", w, torch.float32, (K, N))
    dispatch.check("quantize_pack u", u, torch.float32, (K, N))
    out = torch.empty((K // group, N), dtype=torch.int32, device=w.device)
    build.launch("quantize_pack", w.device, w.data_ptr(), u.data_ptr(),
                 out.data_ptr(), float(alpha), K, N, MODES[mode])
    dispatch.count_launch("quantize_pack")
    return out
