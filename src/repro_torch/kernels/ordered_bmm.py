"""Serving products with a fixed summation order: `ordered_bmm`.

Not the port of a TPU kernel.  JAX's attention is two einsums that XLA
lowers; the port's cuBLAS products chose their algorithm, and with it the
order a row's terms were summed in, by the batch and row counts, so a
request's attention scores changed in their last bits with the batch it
decoded in and the chunks its prompt was cut into (PERF.md section 6,
`bisect_invariance.py`); so did the SSD step's readout and the norms'
means of squares over wide rows (`layers.mean_square`).  The kernel
(csrc/ordered_bmm.cu) sums every output's K terms in one blocked order, a
function of k alone: blocks of 32 consecutive k, each one chain of fused
multiply-adds in increasing k, the blocks' partials added in increasing
block order; so a row's bits are its own whatever the shapes around it,
and zero terms appended to K move none of them.

    route(N, M, K, P)   the kernel's route, from the shape alone: "row"
                        (P = 1, the norms), "small" (M <= 16: decode's
                        scores and values, the SSD readout), a tile of
                        64 x 64 or 128 x 64 outputs (prefill, the
                        encoder); every route sums in the one order
    plan(a, b)          the launch: fp32 operands read through their
                        strides (the attention's permuted keys and values
                        without a copy), the batch as two dims

    ordered_bmm(a, b)   a (..., M, K) @ b (..., K, P), batched over the
                        leading dims (b (K, P) is shared by all); the
                        card's result in fp32, cast to a's dtype
    model_bmm(a, b)     the models' call: `ordered_bmm` with autograd
                        off (serving), the library's `a @ b` where
                        autograd records (training: the kernel has no
                        backward, training makes no invariance promise,
                        and JAX's training forward is XLA's einsum)

The wrapper keeps the port's device policy: on the CPU the plain product
`a @ b` (counted), bit for bit what the attention computed before (the
CPU's library keeps a row's bits at any row count where a head group has
two rows or more); on the card the kernel, or an error; on the meta
device the plan, and the launch as one batched product's work
(`dispatch.meta_launch`).  `DTensor`s run
rank by rank on their shards (`_on_shards`), by the same policy.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import build, dispatch
from repro_torch.runtime import on_shards


def ordered_bmm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: the library's batched product."""
    return a @ b


def model_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A model's batched product: `ordered_bmm` in serving, the library's
    where autograd records (training; a model's DTensor training paths
    call it on each rank's shards, `runtime.on_shards`)."""
    if torch.is_grad_enabled():
        return a @ b
    return ordered_bmm(a, b)


# the routes of csrc/ordered_bmm.cu, by their launch code
ROUTES = {"row": 0, "small": 1, "tile64x64": 2, "tile128x64": 3}
SMALL_M = 16        # the most rows the small route takes


def route(N: int, M: int, K: int, P: int) -> str:
    """The kernel's route for a product of N (M, K) @ (K, P) matrices: a
    pure function of the shape.  Every route sums in the one order of
    csrc/ordered_bmm.cu, so the choice moves no bit, only the time (the
    tiles by PERF.md section 6's timings: 64-row tiles for a prompt
    chunk's rows, 128-row ones above)."""
    if P == 1:
        return "row"
    if M <= SMALL_M:
        return "small"
    return "tile64x64" if M <= 64 else "tile128x64"


def _batch_dims(lead, sa, sb):
    """The batch dims (sizes `lead`, strides `sa` of a and `sb` of b, 0
    where an operand broadcasts) merged where both operands allow, size-1
    dims dropped: [(size, stride of a, stride of b)], or None when more
    than two remain."""
    dims = []
    for n, x, y in zip(lead, sa, sb):
        if n == 1:
            continue
        if dims and dims[-1][1] == x * n and dims[-1][2] == y * n:
            dims[-1] = (dims[-1][0] * n, x, y)
        else:
            dims.append((n, x, y))
    return dims if len(dims) <= 2 else None


class Plan(NamedTuple):
    """One launch: the fp32 operands as the kernel reads them (views where
    the strides allow), the batch as N1 x N2, and each operand's element
    strides (batch 1, batch 2, rows, columns; 0 where a dim is 1)."""
    route: str
    a: torch.Tensor
    b: torch.Tensor
    lead: tuple
    N1: int
    N2: int
    M: int
    K: int
    P: int
    sa: tuple
    sb: tuple


def plan(a: torch.Tensor, b: torch.Tensor) -> Plan:
    """The launch of a (..., M, K) @ b (..., K, P): no copy where a and b
    already lie as fp32 whose batch dims merge into two (the attention's
    permuted keys and values do), a contiguous copy otherwise."""
    M, K, P = a.shape[-2], a.shape[-1], b.shape[-1]
    if b.shape[-2] != K:
        raise ValueError(f"ordered_bmm: a {tuple(a.shape)} @ b "
                         f"{tuple(b.shape)}")
    a, b = a.float(), b.float()
    if b.dim() == 2:
        # one b for every batch: a's rows stacked, one matrix product
        lead = a.shape[:-2]
        a = a.reshape(1, -1, K)
        b = b[None]
        M = a.shape[1]
    else:
        lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        a = a.expand(*lead, M, K)
        b = b.expand(*lead, K, P)
    n = len(a.shape) - 2
    dims = _batch_dims(a.shape[:-2], a.stride()[:-2], b.stride()[:-2])
    if dims is None:
        a = a.reshape(-1, M, K).contiguous()
        b = b.reshape(-1, K, P).contiguous()
        dims = _batch_dims(a.shape[:1], a.stride()[:1], b.stride()[:1])
        n = 1
    dims = [(1, 0, 0)] * (2 - len(dims)) + dims
    (N1, a1, b1), (N2, a2, b2) = dims
    own = lambda t, r, c: tuple(0 if t.shape[n + i] == 1 else t.stride()[n + i]
                                for i in (r, c))
    return Plan(route(N1 * N2, M, K, P), a, b, tuple(lead), N1, N2, M, K, P,
                (a1, a2) + own(a, 0, 1), (b1, b2) + own(b, 0, 1))


def launch(p: Plan) -> torch.Tensor:
    """Run a plan on the card: c (N1 * N2, M, P) in fp32."""
    if dispatch.on_meta(p.a, p.b):
        return dispatch.meta_launch(
            "ordered_bmm", (p.N1 * p.N2, p.M, p.P),
            2 * p.N1 * p.N2 * p.M * p.K * p.P, p.a, p.b)
    out = torch.empty((p.N1 * p.N2, p.M, p.P), dtype=torch.float32,
                      device=p.a.device)
    build.launch("ordered_bmm", p.a.device, p.a.data_ptr(), p.b.data_ptr(),
                 out.data_ptr(), ROUTES[p.route], p.N1, p.N2, p.M, p.K, p.P,
                 *p.sa, *p.sb)
    dispatch.count_launch("ordered_bmm")
    return out


def ordered_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, P) with every output's terms summed in
    the kernel's one blocked order on the card; the plain product on the
    CPU."""
    if isinstance(a, DTensor) or isinstance(b, DTensor):
        return _on_shards(a, b)
    if not dispatch.on_meta(a, b) and not dispatch.on_card("ordered_bmm",
                                                           a, b):
        dispatch.count_plain("ordered_bmm")
        return ordered_bmm_plain(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise ValueError("ordered_bmm: the kernel has no backward; a "
                         "product that carries a gradient is `model_bmm`'s "
                         "library product")
    M, P = a.shape[-2], b.shape[-1]
    p = plan(a, b)
    return launch(p).reshape(*p.lead, M, P).to(a.dtype)


def _label(t: DTensor, dim: int, contract: int, own: int, off: int):
    """A dim of operand t in the output's terms: "K" the contraction, "M"
    or "P" its own output dim, else a batch dim's index in the output."""
    if dim == contract:
        return "K"
    if dim == own:
        return "M" if own == t.dim() - 2 else "P"
    return dim + off


def _on_shards(a, b) -> DTensor:
    """`ordered_bmm` of DTensors, rank by rank: each rank
    multiplies its own shards and the result carries the placements that
    follow (`runtime.on_shards`, which carries gradients).  Per mesh
    dim: a split contraction dim is gathered first (a partial sum would
    add the ranks' shares in the collective's order, not in k's); a batch
    dim split in one operand is split alike in the other unless that one
    broadcasts it; a's rows split meet b's columns whole; a `Partial`
    operand is summed first."""
    mesh = (a if isinstance(a, DTensor) else b).device_mesh
    whole = [Replicate()] * mesh.ndim
    a, b = (t if isinstance(t, DTensor)
            else DTensor.from_local(t, mesh, whole, run_check=False)
            for t in (a, b))
    n = max(a.dim(), b.dim())
    oa, ob = n - a.dim(), n - b.dim()
    out_lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    shape = (*out_lead, a.shape[-2], b.shape[-1])

    def splits(t, L, off):
        # t splits batch dim L of the output (not a broadcast 1)
        return L - off >= 0 and t.shape[L - off] > 1

    pa, pb, po = [], [], []
    for qa, qb in zip(a.placements, b.placements):
        la = (_label(a, qa.dim, a.dim() - 1, a.dim() - 2, oa)
              if isinstance(qa, Shard) else None)
        lb = (_label(b, qb.dim, b.dim() - 2, b.dim() - 1, ob)
              if isinstance(qb, Shard) else None)
        la = None if la == "K" else la
        lb = None if lb == "K" else lb
        if la == "M":
            lb, lo = None, n - 2
        elif isinstance(la, int):
            lb, lo = (la if splits(b, la, ob) else None), la
        elif isinstance(lb, int):
            la, lo = (lb if splits(a, lb, oa) else None), lb
        elif lb == "P":
            lo = n - 1
        else:
            lo = None
        pa.append(Replicate() if la is None else
                  Shard(a.dim() - 2 if la == "M" else la - oa))
        pb.append(Replicate() if lb is None else
                  Shard(b.dim() - 1 if lb == "P" else lb - ob))
        po.append(Replicate() if lo is None else Shard(lo))
    return on_shards(ordered_bmm, mesh, (a, b), (pa, pb), po, shape)
