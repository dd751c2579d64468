"""Token sampling for the serving loop, ported from `repro/serve/sampler.py`
(`sample` only; the engine's per-slot and speculative samplers come with
the engine)."""
from __future__ import annotations

import torch


def sample(logits: torch.Tensor, generator: torch.Generator, *,
           temperature: float = 1.0, top_k: int = 0,
           vocab: int = 0) -> torch.Tensor:
    """logits (B, V) -> (B,) int32.  temperature <= 0 means greedy.

    Masking uses the dtype's own minimum.  The draw is Gumbel-max from
    `generator` (which must live on the logits' device): the same
    distribution as `jax.random.categorical`, not the same numbers."""
    neg = torch.finfo(logits.dtype).min
    V = logits.shape[-1]
    if vocab and V > vocab:
        keep = torch.arange(V, device=logits.device) < vocab
        logits = torch.where(keep, logits, neg)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits, neg)
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1).to(torch.int32)
