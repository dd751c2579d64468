"""Matmul against 2-bit (ternary) / 1-bit (binary) packed weights, ported
from `repro/kernels/packed_matmul.py`.

Three kernels, each with its plain PyTorch version beside it:

  * `packed_gemv`   — the multiply-free GEMV, the step route (decode ticks,
                      verify, recurrent h-sides) at any number of rows:
                      codes become plus/minus masks and each output column
                      is sum(select(plus, x)) - sum(select(minus, x)), one
                      launch up to 8 rows and 8-row tiles above.
                      Kernel: csrc/packed_gemv.cu, launched as `gemv_plan`
                      says.
  * `packed_matmul` — the GEMM on the tensor cores, the sequence route
                      (every projection of a prompt chunk) at any number of
                      rows: x split exactly into three bf16 terms, wgmma
                      against the decoded codes, fp32 accumulate.  A row's
                      bits depend on (K, N, mode) alone, never on M (batch
                      invariance: a prompt's state does not depend on its
                      chunking); the plain version sums row by row, as the
                      GEMV's does.  Kernel: csrc/packed_matmul.cu, launched
                      as `matmul_plan` says.
  * `quantize_pack` — paper Eqs. 4-6 stochastic sampling from an explicit
                      uniform-noise operand, fused with bit-packing:
                      (K, N) fp32 -> (K/G, N) words, bit-exact.
                      Kernel: csrc/quantize_pack.cu.

A wrapper launches its kernel for CUDA tensors, runs the plain version
for CPU tensors and counts its work for meta tensors (kernels/dispatch.py:
2·M·K·N FLOPs a product, the codes never dequantized).  Codes are int32 bit-views of the
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
MAX_CLUSTER = 8    # the portable thread block cluster size
GEMM_ROWS = 64     # rows of a GEMM block: one wgmma m64 tile (csrc BM)
GEMM_COLS = 128    # its columns: wgmma n128 (csrc BN)
GEMM_K = 64        # k a pipeline stage holds (csrc BK)
GEMM_MIN_K_TILES = 4  # the fewest k-tiles a block of a K split keeps


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


def rowwise_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N), each row computed as the first row of a two-row
    product, so its bits come from one call shape whatever M is: on the
    CPU a product of one row goes to MKL's sgemv and one of several to
    sgemm, which sum in other orders, and a row's bits would depend on its
    neighbours.  The one place the port keeps a row's bits its own; the
    CPU engine tests hold it (a request served alone and among others)."""
    pair = torch.zeros((2, x.shape[1]), dtype=x.dtype, device=x.device)
    out = []
    for i in range(x.shape[0]):
        pair[0] = x[i]
        out.append((pair @ w)[:1])
    return torch.cat(out)


def packed_gemv_plain(x: torch.Tensor, codes: torch.Tensor, *,
                      mode: str) -> torch.Tensor:
    """Plain version of `packed_gemv`: x against the decoded -1/0/+1 weight
    (every product exact), row by row (`rowwise_matmul`).  A summation in
    an order of its own (a tree over k) would be closer to the exact sum,
    but leaves the Pallas kernel's, which sums as the library's dot does,
    by more than the parity tests' 1e-5 at K = 512."""
    plus, minus = code_masks(codes, mode=mode)
    return rowwise_matmul(x.float(), plus.float() - minus.float())


def packed_matmul_plain(x: torch.Tensor, codes: torch.Tensor, *,
                        mode: str) -> torch.Tensor:
    """Plain version of `packed_matmul`: `packed_gemv_plain` at any number
    of rows, so a row's bits depend neither on its neighbours nor on the
    GEMV/GEMM routing, and a prompt's state not on how it was chunked."""
    return packed_gemv_plain(x, codes, mode=mode)


def matmul_plan(K: int, N: int, *, mode: str) -> dict:
    """How `packed_matmul` launches against codes (K/G, N): blocks of 64
    rows and 128 columns (`tiles` of them across N), 64 k a stage, and
    `cluster` blocks splitting the `k_tiles`; `tma`, the codes by TMA
    where N % 4 == 0 (the wrapper also needs them 16-byte aligned), else
    the cp.async variant.  It takes no M: every choice that orders a row's
    sum is fixed by (K, N, mode), and only the number of 64-row tiles of
    blocks follows M, so a row's bits do not depend on the row count.  The
    split doubles, up to 8, while one row tile of blocks is short of one
    block an SM and every block keeps at least `GEMM_MIN_K_TILES` k-tiles
    (at qwen3's Wq, K = 1024, N = 2048: 16 tiles in clusters of 4).
    `blocks` counts one row tile's."""
    tiles = -(-N // GEMM_COLS)
    k_tiles = -(-K // GEMM_K)
    cluster = 1
    while (cluster < MAX_CLUSTER and tiles * cluster < SMS
           and k_tiles >= 2 * cluster * GEMM_MIN_K_TILES):
        cluster *= 2
    return {"rows": GEMM_ROWS, "cluster": cluster, "tiles": tiles,
            "k_tiles": k_tiles, "blocks": tiles * cluster, "tma": N % 4 == 0}


def gemv_plan(bp: int, K: int, N: int, *, mode: str) -> dict:
    """How `packed_gemv` launches for x (bp, K): the instance of `rows` >= bp
    (1, 2, 4 or 8; 8 above 8 rows, over `row_tiles` of 8 rows), a grid of
    `tiles` blocks of 32 columns times `cluster` blocks splitting K, and
    `vec`, 16-byte code loads where N % 4 == 0 (the wrapper also needs the
    codes 16-byte aligned).  The split doubles, up to 8, while the grid is
    short of one block an SM and every block keeps at least one code word:
    at N = 4000, 125 tiles become 250 blocks in clusters of 2.  The split
    reads K and N only, so a row's sum order is the same at any bp."""
    tiles = -(-N // GEMV_COLS)
    words = K // pack_group(mode)
    cluster = 1
    while (cluster < MAX_CLUSTER and tiles * cluster < SMS
           and 2 * cluster <= words):
        cluster *= 2
    rows = next((r for r in (1, 2, 4, 8) if r >= bp), 8)
    row_tiles = -(-bp // rows)
    return {"rows": rows, "cluster": cluster, "tiles": tiles,
            "row_tiles": row_tiles, "blocks": tiles * cluster * row_tiles,
            "vec": N % 4 == 0}


def _checked(name: str, x: torch.Tensor, codes: torch.Tensor, mode: str):
    group = pack_group(mode)
    M, K = x.shape
    if codes.dim() != 2 or codes.shape[0] * group != K:
        raise ValueError(f"{name}: packed K mismatch: codes {tuple(codes.shape)}"
                         f" x {group} != K={K}")
    if dispatch.on_meta(x, codes):
        return False
    if dispatch.on_card(name, x, codes):
        dispatch.check(name, x, torch.float32, (M, K))
        dispatch.check(name, codes, torch.int32, tuple(codes.shape))
        return True
    return False


def _meta_product(name: str, x: torch.Tensor,
                  codes: torch.Tensor) -> torch.Tensor:
    """A packed product on the meta device: 2·M·K·N FLOPs; x, the codes
    and y each moved once."""
    M, K = x.shape
    N = codes.shape[1]
    return dispatch.meta_launch(name, (M, N), 2 * M * K * N, x, codes)


def packed_gemv(x: torch.Tensor, codes: torch.Tensor, *,
                mode: str) -> torch.Tensor:
    """x (bp, K) fp32, codes (K/G, N) int32 -> (bp, N) fp32, unscaled."""
    if not _checked("packed_gemv", x, codes, mode):
        if dispatch.on_meta(x, codes):
            return _meta_product("packed_gemv", x, codes)
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
        if dispatch.on_meta(x, codes):
            return _meta_product("packed_matmul", x, codes)
        dispatch.count_plain("packed_matmul")
        return packed_matmul_plain(x, codes, mode=mode)
    M, K = x.shape
    N = codes.shape[1]
    plan = matmul_plan(K, N, mode=mode)
    if x.data_ptr() % 16:
        raise ValueError("packed_matmul: x must be 16-byte aligned (TMA)")
    tma = plan["tma"] and codes.data_ptr() % 16 == 0
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    build.launch("packed_matmul", x.device, x.data_ptr(), codes.data_ptr(),
                 out.data_ptr(), M, K, N, MODES[mode], plan["cluster"],
                 int(tma))
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
