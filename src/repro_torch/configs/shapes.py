"""The assigned input-shape set and the decode cells' cache sizes, ported
from `repro/configs/shapes.py` (which imports JAX only for its input
stand-ins, so the port keeps its own copy of the rest).

`SHAPES` and `applicable` name the (arch x shape) cells; `whisper_dec_len`
and `decode_context` size a serving runtime's caches: the audio family's
decoder context and the cross-attention source length a context implies.

Not ported: `token_batch`, `prefill_inputs` and `decode_inputs`, which
give `jax.ShapeDtypeStruct` stand-ins to the dry-run's lowering (the
tooling, ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(is_applicable, reason-if-not).  long_500k needs sub-quadratic
    attention; pure full-attention archs skip it."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch — long_500k needs sub-quadratic attention"
    return True, ""


def whisper_dec_len(S: int) -> int:
    return min(448, max(64, S // 8))


def decode_context(cfg: ModelConfig, S: int) -> tuple[int, int]:
    """(self-attn context, cross source length) for a decode cell at context S."""
    if cfg.family == "audio":
        return whisper_dec_len(S), S  # decoder ctx, encoder frames in cross-KV
    src = cfg.n_img_tokens if cfg.family == "vlm" else 0
    return S, src
