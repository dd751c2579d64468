"""The assigned input-shape set, the per-(arch x shape) input stand-ins
and the decode cells' cache sizes, ported from `repro/configs/shapes.py`.

`SHAPES` and `applicable` name the (arch x shape) cells; `token_batch`,
`prefill_inputs` and `decode_inputs` give the inputs of a train, prefill
or decode step as tensors on the meta device (shape and dtype, no
storage), where JAX gives `jax.ShapeDtypeStruct`s; `whisper_dec_len` and
`decode_context` size a serving runtime's caches: the audio family's
decoder context and the cross-attention source length a context implies.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

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


def _spec(dtype: torch.dtype, *shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def token_batch(cfg: ModelConfig, B: int, S: int) -> dict:
    """Train-step inputs: tokens and targets, the audio family's frames
    (its decoder at `whisper_dec_len(S)`), the vlm family's image
    tokens."""
    i32 = lambda *s: _spec(torch.int32, *s)
    act = lambda *s: _spec(cfg.torch_dtype, *s)
    if cfg.family == "audio":
        d = whisper_dec_len(S)
        return {"tokens": i32(B, d), "targets": i32(B, d),
                "enc_frames": act(B, S, cfg.d_model)}
    batch = {"tokens": i32(B, S), "targets": i32(B, S)}
    if cfg.family == "vlm":
        batch["img"] = act(B, cfg.n_img_tokens, cfg.d_model)
    return batch


def prefill_inputs(cfg: ModelConfig, B: int, S: int) -> dict:
    """Prefill inputs: the prompt, and the audio or vlm family's source."""
    batch = token_batch(cfg, B, S)
    del batch["targets"]
    return batch


def decode_inputs(cfg: ModelConfig, B: int) -> dict:
    """Decode-step inputs: one token a row."""
    del cfg
    return {"token": _spec(torch.int32, B, 1)}


def decode_context(cfg: ModelConfig, S: int) -> tuple[int, int]:
    """(self-attn context, cross source length) for a decode cell at context S."""
    if cfg.family == "audio":
        return whisper_dec_len(S), S  # decoder ctx, encoder frames in cross-KV
    src = cfg.n_img_tokens if cfg.family == "vlm" else 0
    return S, src
