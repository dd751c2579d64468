"""Device policy and launch counters for the port's kernels.

The policy, one rule for every kernel wrapper:

    tensor on     runs
    ---------     ---------------------------------------------------
    cuda          the hand-written CUDA kernel; if it cannot run, raise
    cpu           the plain PyTorch version beside it
    meta          nothing: the kernel's output, empty, on the meta device,
                  and its work told to `META_LISTENERS` (`meta_launch`)

Nothing falls back to a plain version on CUDA.  The meta device stands in
for the card where work is counted and not done (`launch/dryrun.py`): a
model's code takes the card's branches there, and a kernel's work is its
FLOPs and each operand and output moved once, as PERF.md's bounds count
it.  Entry points resolve their
device with `resolve_device`: the card unless the caller asks for the CPU,
and an error when no card is present and none was asked for.

Two counters, plain ints by kernel name: `LAUNCHES` counts kernel launches
on the card, bumped by each wrapper where it launches its kernel and
nowhere else; `PLAIN_CALLS` counts the wrappers' plain-version calls on CPU
tensors, so the CPU tests can pin the routing (one fused tick per decode
step, GEMV versus GEMM) the card run pins with `LAUNCHES`.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

LAUNCHES: Counter = Counter()
PLAIN_CALLS: Counter = Counter()
# callables (name, flops, bytes, operands) told of every kernel call on
# meta tensors
META_LISTENERS: list = []


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def count_plain(name: str) -> None:
    PLAIN_CALLS[name] += 1


def reset_counts() -> None:
    LAUNCHES.clear()
    PLAIN_CALLS.clear()


def strict_fp32() -> None:
    """fp32 matmuls in full fp32 on the card: the reference is an exact fp32
    dot, and TF32 keeps about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller passes
    another; raises when no card is present and none was asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the plain versions")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        strict_fp32()
    return device


def nbytes(t: torch.Tensor) -> int:
    """The bytes of `t`'s distinct elements: a broadcast (stride-0) dim
    counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def on_meta(*tensors: torch.Tensor) -> bool:
    """True when every operand lies on the meta device."""
    return all(t.device.type == "meta" for t in tensors if t is not None)


def meta_launch(name: str, shape: tuple, flops: float,
                *operands: torch.Tensor) -> torch.Tensor:
    """Kernel `name` on meta operands: its fp32 output of `shape`, empty,
    and its work (`flops`, each operand read and the output written once)
    told to every listener."""
    out = torch.empty(shape, dtype=torch.float32, device="meta")
    moved = sum(nbytes(t) for t in (*operands, out))
    for listener in META_LISTENERS:
        listener(name, flops, moved, operands)
    return out


def on_card(name: str, *tensors: torch.Tensor) -> bool:
    """True when kernel `name` must launch (every operand on the card),
    False for the plain version (every operand on the CPU)."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cuda"}:
        return True
    if devs == {"cpu"}:
        return False
    raise ValueError(f"{name}: operands on mixed devices {sorted(devs)}")


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple):
    """Validate a kernel operand's dtype, shape and contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: operand must be contiguous")
