"""The transformer pool's dense family (llama3, qwen3, gemma3), ported
from `repro/models/transformer.py`: layer kinds `full`, `global` and
`local` (a sliding window over a ring cache).

Parameters keep the JAX tree: `embed`, `final_norm`, `head` (untied
only), `stack` (one dict per pattern position, every leaf stacked over
the pattern's repeats) and `tail` (the layers a partial last repeat
leaves), so `convert.from_numpy` carries a JAX tree across one to one.
Caches are stacked the same way.  JAX scans the repeats; here a Python
loop runs layer by layer over per-layer views.

The paper's technique enters once per call through `quantize_tree`; an
exported tree's packed `QTensor` leaves pass through it and every weight
matmul dispatches in `kernels.ops` (the packed GEMV for at most 8 rows,
the GEMM for more).  `_serve_quant` prepares a tree for serving once: the
masters quantized and cast to the compute dtype, the embedding cast (the
tied head reads it transposed), and per-layer views taken.  Handed a tree
it prepared, it returns it as it is, so a runtime casts once and every
step reads the prepared tree; the bits are those of JAX's per-call cast.

Other families and kinds (`moe`, `mamba`, `rwkv`, `cross`, `selfcross`,
`shared`) are refused by `check_dense`: they wait for ROADMAP Queue 1
item 9.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.qlinear import quantize_tree, winit
from repro_torch.core.qtensor import QTensor, is_qtensor, tree_map
from repro_torch.kernels.ops import serve_matmul
from repro_torch.models import layers as L
from repro_torch.serve.kvcache import (AttnCache, cache_init,
                                       cache_positions, cache_update)

DENSE_KINDS = ("full", "global", "local")
DECODE_MARGIN = 128  # extra cache slots beyond the spec'd context length


def check_dense(cfg) -> None:
    """Refuse a config outside the ported dense family."""
    pat, _, tail = expand_pattern(cfg)
    if (cfg.family != "dense" or cfg.n_experts > 0
            or set(pat + tail) - set(DENSE_KINDS)):
        raise NotImplementedError(
            f"{cfg.name} (the {cfg.family} family) waits for ROADMAP Queue "
            f"1 item 9; the port serves the dense family")


# ---------------------------------------------------------------------------
# pattern expansion
# ---------------------------------------------------------------------------


def expand_pattern(cfg) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """-> (pattern, repeats, tail_kinds).  n_layers counts pattern layers;
    for hybrids the shared-attention applications are extra."""
    if cfg.family == "hybrid" and cfg.attn_every > 0:
        pat = ("mamba",) * cfg.attn_every + ("shared",)
        rep = cfg.n_layers // cfg.attn_every
        tail = ("mamba",) * (cfg.n_layers % cfg.attn_every)
        return pat, rep, tail
    pat = cfg.block_pattern
    rep = cfg.n_layers // len(pat)
    tail = pat[: cfg.n_layers % len(pat)]
    return pat, rep, tail


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def block_init(gen: torch.Generator, cfg, kind: str) -> dict:
    """One dense block's parameters (every dense kind has the same)."""
    d, dev = cfg.d_model, gen.device
    return {"norm1": torch.zeros((d,), device=dev),
            "norm2": torch.zeros((d,), device=dev),
            "attn": L.attn_init(gen, cfg), "mlp": L.mlp_init(gen, cfg)}


def _stacked_init(gen: torch.Generator, cfg, kind: str, n: int) -> dict:
    blocks = [block_init(gen, cfg, kind) for _ in range(n)]
    return tree_map(lambda *ls: torch.stack(ls), blocks[0], *blocks[1:])


def model_init(gen: torch.Generator, cfg) -> dict:
    """Random parameters in the JAX tree's layout, drawn from `gen` on its
    device (the numbers differ from `jax.random`'s)."""
    check_dense(cfg)
    d, Vp, dev = cfg.d_model, cfg.padded_vocab, gen.device
    pat, rep, tail = expand_pattern(cfg)
    params: dict = {
        "embed": torch.randn((Vp, d), generator=gen, device=dev) * d ** -0.5,
        "final_norm": torch.zeros((d,), device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = winit(gen, (d, Vp))
    params["stack"] = tuple(_stacked_init(gen, cfg, k, rep) for k in pat)
    params["tail"] = tuple(block_init(gen, cfg, k) for k in tail)
    return params


# ---------------------------------------------------------------------------
# the serving tree
# ---------------------------------------------------------------------------


class ServeTree(dict):
    """A parameter tree `_serve_quant` prepared: matmul weights quantized
    and cast, the embedding (and an untied head) cast to the compute
    dtype, and `layers`, the per-layer (kind, params) views in run order."""
    layers: list


def _layer_view(tree, r: int):
    """Layer r of a stacked parameter subtree (QTensors sliced too)."""
    def one(leaf):
        if is_qtensor(leaf):
            return dataclasses.replace(
                leaf, codes=leaf.codes[r],
                scale=None if leaf.scale is None else leaf.scale[r])
        return leaf[r]
    return tree_map(one, tree)


def _serve_quant(params: dict, cfg) -> ServeTree:
    if isinstance(params, ServeTree):
        return params
    spec = dataclasses.replace(cfg.quant, stochastic=False)
    dt = cfg.torch_dtype
    q = ServeTree(quantize_tree(params, spec, compute_dtype=dt))
    q["embed"] = q["embed"].to(dt)
    if "head" in q and not is_qtensor(q["head"]):
        q["head"] = q["head"].to(dt)
    pat, rep, tail = expand_pattern(cfg)
    q.layers = [(k, _layer_view(q["stack"][i], r))
                for r in range(rep) for i, k in enumerate(pat)]
    q.layers += list(zip(tail, q["tail"]))
    return q


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _window(cfg, kind: str) -> int:
    return cfg.window if (kind == "local" or cfg.swa_all) else 0


def _attn_full(p: dict, x: torch.Tensor, cfg, kind: str,
               positions: torch.Tensor) -> torch.Tensor:
    """The uncached block (the eval forward)."""
    h = L.rms_norm(x, p["norm1"])
    x = x + L.attn_apply(p["attn"], h, cfg, kind=kind, positions=positions)
    h = L.rms_norm(x, p["norm2"])
    return x + L.mlp_apply(p["mlp"], h, cfg)


def _self_attn_cached(p_attn: dict, h: torch.Tensor, cfg, cache: AttnCache,
                      *, window: int, live=None):
    """h (B, S, d) new tokens attend over cache + new; returns (o, cache).
    `live` (B,) freezes dead rows' cache bytes and pos."""
    q = L.attn_q(p_attn, h, cfg)
    k_new, v_new = L.attn_kv(p_attn, h, cfg)
    S = h.shape[1]
    # scalar pos -> (S,); per-slot pos (B,) -> (B, S)
    ar = torch.arange(S, dtype=torch.int32, device=h.device)
    positions = cache.pos[:, None] + ar if cache.pos.dim() else cache.pos + ar
    q = L.rope(q, positions, cfg.rope_theta)
    k_new = L.rope(k_new, positions, cfg.rope_theta)
    cache = cache_update(cache, k_new, v_new, live)
    o = L.attention(q, cache.k, cache.v, causal=True, window=window,
                    q_offset=cache.pos - S, kv_pos=cache_positions(cache),
                    chunk=cfg.attn_chunk, softcap=cfg.attn_softcap)
    return o, cache


def _attn_cached(p: dict, x: torch.Tensor, cfg, kind: str, cache: AttnCache,
                 live=None):
    """The prefill/decode block; returns (x, new cache)."""
    h = L.rms_norm(x, p["norm1"])
    o, cache = _self_attn_cached(p["attn"], h, cfg, cache,
                                 window=_window(cfg, kind), live=live)
    x = x + L.attn_out(p["attn"], o, cfg)
    h = L.rms_norm(x, p["norm2"])
    return x + L.mlp_apply(p["mlp"], h, cfg), cache


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _kind_cache(cfg, kind: str, batch: int, cap: int, dtype, *,
                per_slot: bool = False, lead: tuple = (), device=None) -> dict:
    """The cache of one layer of `kind` ({"attn": AttnCache})."""
    if kind in ("full", "global"):
        c = cap if not cfg.swa_all else min(cfg.window + DECODE_MARGIN, cap)
        ring = cfg.swa_all
    elif kind == "local":
        c, ring = min(cfg.window + DECODE_MARGIN, cap), True
    else:
        raise ValueError(kind)
    return {"attn": cache_init(batch, c, cfg.n_kv, cfg.hd, dtype, ring=ring,
                               per_slot=per_slot, lead=lead, device=device)}


def init_caches(cfg, batch: int, context: int, *, dtype=None,
                per_slot: bool = False, device=None) -> dict:
    """Stacked cache tree matching the parameter tree.  With `per_slot`
    every position counter is per row (B,): the continuous-batching pool."""
    dtype = dtype or cfg.torch_dtype
    cap = context + DECODE_MARGIN
    pat, rep, tail = expand_pattern(cfg)
    return {
        "stack": tuple(_kind_cache(cfg, k, batch, cap, dtype,
                                   per_slot=per_slot, lead=(rep,),
                                   device=device) for k in pat),
        "tail": tuple(_kind_cache(cfg, k, batch, cap, dtype,
                                  per_slot=per_slot, device=device)
                      for k in tail),
    }


# ---------------------------------------------------------------------------
# embedding, head, the cached step
# ---------------------------------------------------------------------------


def _embed(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    return params["embed"][tokens].to(cfg.torch_dtype)


def _head(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = params["embed"].T.to(x.dtype)  # embed stays fp (gather path)
    else:
        w = params["head"]
        w = w if isinstance(w, QTensor) else w.to(x.dtype)
    logits = serve_matmul(x, w).float()
    if cfg.padded_vocab != cfg.vocab:
        real = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab
        logits = torch.where(real, logits,
                             torch.full((), -1e30, device=x.device))
    return logits


def _step_cached(qparams: ServeTree, x: torch.Tensor, caches: dict, cfg, *,
                 live=None) -> Tuple[torch.Tensor, dict]:
    """Run every layer over new tokens x (B, S, d) against the caches.
    k/v are written in place into the stacked caches; the new positions
    are stacked back.  `live` (B,) freezes dead rows."""
    pat, rep, tail = expand_pattern(cfg)
    it = iter(qparams.layers)
    stack_pos = [[] for _ in pat]
    for r in range(rep):
        for i, kind in enumerate(pat):
            _, p = next(it)
            c = caches["stack"][i]["attn"]
            one = c._replace(k=c.k[r], v=c.v[r], pos=c.pos[r])
            x, one = _attn_cached(p, x, cfg, kind, one, live)
            stack_pos[i].append(one.pos)
    new_stack = tuple(
        {"attn": caches["stack"][i]["attn"]._replace(
            pos=torch.stack(stack_pos[i]) if rep else
            caches["stack"][i]["attn"].pos)}
        for i in range(len(pat)))
    new_tail = []
    for c in caches["tail"]:
        kind, p = next(it)
        x, one = _attn_cached(p, x, cfg, kind, c["attn"], live)
        new_tail.append({"attn": one})
    return x, {"stack": new_stack, "tail": tuple(new_tail)}


def forward(params: dict, tokens: torch.Tensor, cfg, *,
            last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval forward over a whole sequence (no caches, deterministic
    quantization).  tokens (B, S) -> (logits (B, S, Vp), aux 0).  The
    training forward (stochastic quantization, remat) is not ported."""
    qparams = _serve_quant(params, cfg)
    x = _embed(qparams, tokens, cfg)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    for kind, p in qparams.layers:
        x = _attn_full(p, x, cfg, kind, positions)
    x = L.rms_norm(x, qparams["final_norm"])
    if last_only:
        x = x[:, -1:]
    return _head(qparams, x, cfg), torch.zeros((), device=x.device)


def prefill(params: dict, tokens: torch.Tensor, caches: dict,
            cfg) -> Tuple[torch.Tensor, dict]:
    """Process a prompt (or one prompt chunk) into the caches.  Returns the
    last token's logits (B, Vp) and the caches.  JAX's `n` (bucket padding
    rewound off the caches) has no counterpart: chunks run at their own
    length."""
    qparams = _serve_quant(params, cfg)
    x = _embed(qparams, tokens, cfg)
    x, caches = _step_cached(qparams, x, caches, cfg)
    x = L.rms_norm(x[:, -1:], qparams["final_norm"])
    return _head(qparams, x, cfg)[:, 0], caches


def verify_step(params: dict, tokens: torch.Tensor, caches: dict, cfg,
                live=None) -> Tuple[torch.Tensor, dict]:
    """Speculative verify: one multi-token decode over the candidate span.
    tokens (B, S) -> (logits (B, S, Vp), caches).  Each position's head runs
    at the decode step's (B, 1, d) shape, as JAX unrolls it, so a verified
    stream's rounding is plain decoding's where the head's is row-count
    dependent.  Rollback is the caller's (kvcache.cache_spec_commit)."""
    qparams = _serve_quant(params, cfg)
    x = _embed(qparams, tokens, cfg)
    x, caches = _step_cached(qparams, x, caches, cfg, live=live)
    x = L.rms_norm(x, qparams["final_norm"])
    logits = [_head(qparams, x[:, i:i + 1], cfg)[:, 0]
              for i in range(tokens.shape[1])]
    return torch.stack(logits, dim=1), caches


def decode_step(params: dict, token: torch.Tensor, caches: dict, cfg,
                live=None) -> Tuple[torch.Tensor, dict]:
    """One decode step.  token (B,) or (B, 1) -> (logits (B, Vp), caches).
    `live` (B,) is the engine's occupancy mask: dead rows' caches stay
    frozen bit for bit (their logits are garbage and never sampled)."""
    if token.dim() == 1:
        token = token[:, None]
    qparams = _serve_quant(params, cfg)
    x = _embed(qparams, token, cfg)
    x, caches = _step_cached(qparams, x, caches, cfg, live=live)
    x = L.rms_norm(x, qparams["final_norm"])
    return _head(qparams, x, cfg)[:, 0], caches
