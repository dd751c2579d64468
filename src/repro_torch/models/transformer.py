"""The transformer pool, every family, ported from
`repro/models/transformer.py`: layer kinds `full`, `global`, `self` (full
causal attention) and `local` (a sliding window over a ring cache) with a
SwiGLU MLP or a
mixture-of-experts FFN (`models/moe.py`: mixtral, qwen3-moe); the
attention-free `rwkv` kind (`models/rwkv6.py`), whose cache is an
`RWKVState`; zamba2's `mamba` kind (`models/mamba2.py`, an `SSMState`)
and its `shared` kind, one full-attention block (`params["shared"]`)
applied after every `attn_every` mamba layers, with a KV cache of its own
at each application; and whisper's encoder-decoder: `enc` layers
(bidirectional self-attention with RoPE, the GeLU MLP) over the frames
plus sinusoidal positions (`params["enc"]`), and `selfcross` decoder
layers (causal self-attention, then tanh-gated cross-attention over the
encoder's output, whose k/v a prefill encodes into a `CrossCache`); and
the VLM's `cross` kind (llama-3.2-vision): no self-attention, a
tanh(xgate)-gated cross-attention over the image tokens `img`, then the
MLP, its `CrossCache` filled by each prefill.

Parameters keep the JAX tree: `embed`, `final_norm`, `head` (untied
only), `stack` (one dict per pattern position, every leaf stacked over
the pattern's repeats; `{}` for the shared kind, which owns nothing
there), `tail` (the layers a partial last repeat leaves), `shared` and
`enc` where the family has them, so `convert.from_numpy` carries a JAX
tree across one to one.  Caches are stacked the same way.  JAX scans
the repeats; here a Python loop runs layer by layer over per-layer
views (a tensor's `unbind(0)`, so the backward stacks a leaf's gradient
once).

The paper's technique enters once per call through `quantize_tree`; an
exported tree's packed `QTensor` leaves pass through it and every weight
matmul dispatches in `kernels.ops` (the packed GEMV for at most 8 rows,
the GEMM for more; an MoE layer per expert).  `_serve_quant` prepares a
tree for serving once: the masters quantized and cast to the compute
dtype, the embedding cast (the tied head reads it transposed), and
per-layer views taken (an expert stack's view is (E, K/G, N); a shared
application's view is the shared block; the encoder's layers apart).
Handed a tree it prepared, it returns it as it is, so a runtime casts
once and every step reads the prepared tree; the bits are those of JAX's
per-call cast.

Training.  `forward(training=True, noise=...)` samples every quantizable
master stochastically with straight-through gradients (`_train_quant`:
`cfg.quant` as it is, the compute-dtype cast after the sample), before
the layer loop, so no recomputed region draws noise; the embedding and
an untied head stay fp32 masters, cast where they are read, as JAX's are.
With `cfg.remat` and gradients on, each repeat of the pattern (and each
encoder layer) is one non-reentrant `torch.utils.checkpoint`, as JAX
checkpoints its scan body; `remat_policy="dots"` keeps the weight
products' outputs (`aten.mm`, products without batch dims, as JAX's
`dots_with_no_batch_dims_saveable`).  `cfg.parallel_block` gives the
attention kinds PaLM's parallel block.  `lm_loss` is JAX's: the nll, plus
0.01 x the MoE aux loss, plus 1e-4 x mean(logz^2).  No `torch.autocast`:
the same tensors are cast as in JAX.

An MoE layer routes without drops (capacity = its token count) exactly
when the call carries one token a row (S = 1, a decode step), as JAX's
`no_drop=x.shape[1] == 1`.  A dead continuous-batching row's RWKV or
SSM state is frozen bit for bit under `live` (`_freeze_dead`).  The
cached step passes `decode` to the recurrent mixers explicitly, as JAX's
does: a prefill of one token takes the chunked scan, not the step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils import checkpoint as CP

from repro_torch.core.qlinear import quantize_tree, winit
from repro_torch.core.qtensor import (QTensor, export_packed, is_qtensor,
                                      tree_map)
from repro_torch.kernels.ops import product_role, serve_matmul
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R
from repro_torch.runtime import (DATA, constrain, on_shards, reduce_over,
                                 shard_extent, sum_over)
from repro_torch.serve.kvcache import (AttnCache, CrossCache, cache_init,
                                       cache_positions, cache_update,
                                       kv_pspec)

ATTN_KINDS = ("full", "global", "local")
SELF_KINDS = ATTN_KINDS + ("self",)  # causal self-attention kinds
DECODE_MARGIN = 128  # extra cache slots beyond the spec'd context length
# the layer kinds of each family
PORTED_KINDS = {"dense": set(ATTN_KINDS), "moe": set(ATTN_KINDS),
                "ssm": {"rwkv"}, "hybrid": {"mamba", "shared"},
                "audio": {"selfcross"}, "vlm": {"self", "cross"}}


def check_ported(cfg) -> None:
    """Refuse a config whose layer kinds its family does not run: dense
    and MoE over the attention kinds, the SSM family's rwkv kind, the
    hybrid family's mamba and shared kinds, the audio family's selfcross
    decoder and the vlm family's self and cross kinds."""
    pat, _, tail = expand_pattern(cfg)
    if not set(pat + tail) <= PORTED_KINDS.get(cfg.family, set()):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family does not run the kinds "
            f"{sorted(set(pat + tail))}")


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


def owns_params(kind: str) -> bool:
    """The shared kind's parameters live in `params["shared"]`, not in the
    stack."""
    return kind != "shared"


def block_init(gen: torch.Generator, cfg, kind: str) -> dict:
    """One block's parameters: a mamba or rwkv mixer, or attention (a
    cross-attention with its gate for the cross kind; a cross-attention
    after it for selfcross) and an MLP (`moe` in its place when the config
    has experts; GeLU in the audio family)."""
    d, dev = cfg.d_model, gen.device
    zeros = lambda: torch.zeros((d,), device=dev)
    if kind == "mamba":
        return {"norm": zeros(), "mixer": M.mamba2_init(gen, cfg)}
    if kind == "rwkv":
        return {"ln1": zeros(), "ln2": zeros(),
                "mix": R.rwkv6_init(gen, cfg)}
    p = {"norm1": zeros(), "norm2": zeros(),
         "attn": L.attn_init(gen, cfg, cross=kind == "cross")}
    if kind == "selfcross":
        p["normc"] = zeros()
        p["xattn"] = L.attn_init(gen, cfg, cross=True, kv_d=d)
    if cfg.n_experts > 0 and kind != "enc":
        p["moe"] = MOE.moe_init(gen, cfg)
    else:
        p["mlp"] = L.mlp_init(gen, cfg, kind="gelu" if cfg.family == "audio"
                              else None)
    return p


def _stack(*leaves):
    """Stack one leaf of every layer: tensors, or exported QTensors (whose
    scale is None) by their codes."""
    if not is_qtensor(leaves[0]):
        return torch.stack(leaves)
    return dataclasses.replace(leaves[0],
                               codes=torch.stack([q.codes for q in leaves]))


def _stacked_init(gen: torch.Generator, cfg, kind: str, n: int,
                  post=lambda block: block) -> dict:
    blocks = [post(block_init(gen, cfg, kind)) for _ in range(n)]
    return tree_map(_stack, blocks[0], *blocks[1:])


def model_init(gen: torch.Generator, cfg, *, packed: bool = False) -> dict:
    """Random parameters in the JAX tree's layout, drawn from `gen` on its
    device (the numbers differ from `jax.random`'s).  With `packed` every
    block is exported (`export_packed` under `cfg.quant`) as soon as it is
    drawn and the codes are stacked: the same tree as
    `export_packed(model_init(gen, cfg), cfg.quant)`, bit for bit, with one
    layer's fp32 masters alive at a time (a full-width MoE model's masters
    do not fit on one card).  A hybrid adds `shared` (one full-attention
    block), the audio family `enc` (the encoder's stack and final norm)."""
    check_ported(cfg)
    post = ((lambda tree: export_packed(tree, cfg.quant)) if packed
            else (lambda tree: tree))
    d, Vp, dev = cfg.d_model, cfg.padded_vocab, gen.device
    pat, rep, tail = expand_pattern(cfg)
    params: dict = {
        "embed": torch.randn((Vp, d), generator=gen, device=dev) * d ** -0.5,
        "final_norm": torch.zeros((d,), device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = winit(gen, (d, Vp))
    params["stack"] = tuple(_stacked_init(gen, cfg, k, rep, post)
                            if owns_params(k) else {} for k in pat)
    params["tail"] = tuple(post(block_init(gen, cfg, k))
                           if owns_params(k) else {} for k in tail)
    if cfg.family == "hybrid":
        params["shared"] = post(block_init(gen, cfg, "full"))
    if cfg.family == "audio":
        params["enc"] = {
            "stack": _stacked_init(gen, cfg, "enc", cfg.n_enc_layers, post),
            "final_norm": torch.zeros((d,), device=dev)}
    return post(params)


# ---------------------------------------------------------------------------
# the serving tree
# ---------------------------------------------------------------------------


class ServeTree(dict):
    """A parameter tree prepared for a forward: matmul weights quantized
    and cast (`_serve_quant` once for serving, `_train_quant` once per
    training forward), `layers`, the per-layer (kind, params) views in run
    order (the shared block at each shared application), and
    `enc_layers`, the encoder's per-layer views (empty outside the audio
    family)."""
    layers: list
    enc_layers: list


def _layer_view(tree, r: int):
    """Layer r of a stacked parameter subtree (QTensors sliced too)."""
    def one(leaf):
        if is_qtensor(leaf):
            return dataclasses.replace(
                leaf, codes=leaf.codes[r],
                scale=None if leaf.scale is None else leaf.scale[r])
        return leaf[r]
    return tree_map(one, tree)


def _split(tree, n: int) -> list:
    """The n per-layer views of a stacked parameter subtree: a tensor's
    `unbind(0)` (whose backward stacks the layers' gradients once), a
    QTensor's codes and scale sliced."""
    if isinstance(tree, dict):
        parts = {k: _split(v, n) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(n)]
    if is_qtensor(tree):
        return [_layer_view(tree, r) for r in range(n)]
    return list(tree.unbind(0))


def _prepare(q: ServeTree, cfg) -> ServeTree:
    """Attach the per-layer views to a quantized tree."""
    pat, rep, tail = expand_pattern(cfg)
    views = [_split(q["stack"][i], rep) if owns_params(k) else None
             for i, k in enumerate(pat)]
    q.layers = [(k, q["shared"] if k == "shared" else views[i][r])
                for r in range(rep) for i, k in enumerate(pat)]
    q.layers += [(k, q["shared"] if k == "shared" else p)
                 for k, p in zip(tail, q["tail"])]
    q.enc_layers = (_split(q["enc"]["stack"], cfg.n_enc_layers)
                    if "enc" in q else [])
    return q


def _serve_quant(params: dict, cfg) -> ServeTree:
    """The serving tree: deterministic quantization, the embedding (and an
    untied head) cast to the compute dtype once."""
    if isinstance(params, ServeTree):
        return params
    spec = dataclasses.replace(cfg.quant, stochastic=False)
    dt = cfg.torch_dtype
    q = ServeTree(quantize_tree(params, spec, compute_dtype=dt))
    q["embed"] = q["embed"].to(dt)
    if "head" in q and not is_qtensor(q["head"]):
        q["head"] = q["head"].to(dt)
    return _prepare(q, cfg)


def _train_quant(params: dict, cfg, noise) -> ServeTree:
    """The training forward's tree: `cfg.quant` as it is (stochastic
    binary/ternary samples from `noise`, straight-through gradients), cast
    to the compute dtype after the sample; the embedding and head stay
    the fp32 masters, cast where they are read, so their gradients round
    as JAX's do."""
    return _prepare(ServeTree(quantize_tree(
        params, cfg.quant, compute_dtype=cfg.torch_dtype, noise=noise)), cfg)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _window(cfg, kind: str) -> int:
    return cfg.window if (kind == "local" or cfg.swa_all) else 0


def _mlp_or_moe(p: dict, x: torch.Tensor, cfg, *,
                no_drop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    if "moe" in p:
        return MOE.moe_apply(p["moe"], x, cfg, no_drop=no_drop)
    return L.mlp_apply(p["mlp"], x, cfg), torch.zeros((), device=x.device)


def _attn_full(p: dict, x: torch.Tensor, cfg, kind: str,
               positions: torch.Tensor, xsrc: Optional[torch.Tensor] = None):
    """The uncached block (the training and eval forward, the encoder);
    returns (x, moe aux).  cross attends over the cross source `xsrc` in
    place of a self-attention, selfcross after its self-attention; enc's
    self-attention is not causal.  A parallel block's attention and MLP
    read one pre-norm."""
    h = L.rms_norm(x, p["norm1"])
    if cfg.parallel_block and kind in SELF_KINDS:
        o = L.attn_apply(p["attn"], h, cfg, kind=kind, positions=positions)
        y, aux = _mlp_or_moe(p, h, cfg)
        return x + o + y, aux
    if kind == "cross":
        x = x + L.attn_apply(p["attn"], h, cfg, kind="cross", kv_src=xsrc)
    elif kind == "selfcross":
        x = x + L.attn_apply(p["attn"], h, cfg, kind="full",
                             positions=positions)
        hc = L.rms_norm(x, p["normc"])
        x = x + L.attn_apply(p["xattn"], hc, cfg, kind="cross", kv_src=xsrc)
    else:
        x = x + L.attn_apply(p["attn"], h, cfg, kind=kind,
                             positions=positions,
                             causal=False if kind == "enc" else None)
    h = L.rms_norm(x, p["norm2"])
    y, aux = _mlp_or_moe(p, h, cfg)
    return x + y, aux


def _self_attn_cached(p_attn: dict, h: torch.Tensor, cfg, cache: AttnCache,
                      *, window: int, live=None):
    """h (B, S, d) new tokens attend over cache + new; returns (o, cache).
    `live` (B,) freezes dead rows' cache bytes and pos."""
    q = L.attn_q(p_attn, h, cfg)
    S = h.shape[1]
    # scalar pos -> (S,); per-slot pos (B,) -> (B, S)
    ar = torch.arange(S, dtype=torch.int32, device=h.device)
    positions = cache.pos[:, None] + ar if cache.pos.dim() else cache.pos + ar
    q = L.rope(q, positions, cfg.rope_theta)
    if L.kv_local_slots(cache.k, S):
        cache = L.kv_write_local(p_attn, h, cfg, cache, positions)
    else:
        k_new, v_new = L.attn_kv(p_attn, h, cfg)
        k_new = L.rope(k_new, positions, cfg.rope_theta)
        cache = cache_update(cache, k_new, v_new, live)
    # heads over 'model' where the cache's heads are (kv_pspec's layout),
    # so attention reads its shard of the cache in place
    spec = kv_pspec(*cache.k.shape[-4:-1])
    if len(spec) > 2 and spec[2] == "model":
        q = constrain(q, DATA, None, "model", None)
    o = L.attention(q, cache.k, cache.v, causal=True, window=window,
                    q_offset=cache.pos - S, kv_pos=cache_positions(cache),
                    chunk=cfg.attn_chunk, softcap=cfg.attn_softcap)
    return o, cache


def _cross_attn_cached(p_attn: dict, h: torch.Tensor, cfg,
                       xcache: CrossCache) -> torch.Tensor:
    """Gated cross-attention of h over a cross cache (not causal, no
    RoPE)."""
    q = L.attn_q(p_attn, h, cfg)
    o = L.attention(q, xcache.k, xcache.v, causal=False)
    return L.attn_out(p_attn, o, cfg, cross=True)


def _attn_cached(p: dict, x: torch.Tensor, cfg, kind: str,
                 cache: Optional[AttnCache],
                 xcache: Optional[CrossCache] = None, live=None):
    """The prefill/decode block; returns (x, new cache).  cross attends
    over the cross cache `xcache` in place of a self-attention (it has no
    kv cache: None in, None out); selfcross attends over it after its
    self-attention.  An MoE layer drops no token when the call carries one
    a row."""
    h = L.rms_norm(x, p["norm1"])
    no_drop = x.shape[1] == 1
    if cfg.parallel_block and kind in SELF_KINDS:
        o, cache = _self_attn_cached(p["attn"], h, cfg, cache,
                                     window=_window(cfg, kind), live=live)
        y, _ = _mlp_or_moe(p, h, cfg, no_drop=no_drop)
        return x + L.attn_out(p["attn"], o, cfg) + y, cache
    if kind == "cross":
        x = x + _cross_attn_cached(p["attn"], h, cfg, xcache)
    else:
        o, cache = _self_attn_cached(p["attn"], h, cfg, cache,
                                     window=_window(cfg, kind), live=live)
        x = x + L.attn_out(p["attn"], o, cfg)
    if kind == "selfcross":
        x = x + _cross_attn_cached(p["xattn"], L.rms_norm(x, p["normc"]),
                                   cfg, xcache)
    h = L.rms_norm(x, p["norm2"])
    y, _ = _mlp_or_moe(p, h, cfg, no_drop=no_drop)
    return x + y, cache


def _mamba_block(p: dict, x: torch.Tensor, cfg, state: Optional[M.SSMState],
                 decode: bool):
    """The mamba block (a pre-norm mixer and its residual); returns (x, new
    state), the state None when none was given (and not decoding)."""
    h = L.rms_norm(x, p["norm"])
    y, new_state = M.mamba2_apply(p["mixer"], h, cfg, state=state,
                                  decode=decode)
    return x + y.to(x.dtype), new_state


def _rwkv_block(p: dict, x: torch.Tensor, cfg, state: Optional[R.RWKVState],
                decode: bool):
    """The rwkv block (time mix, then channel mix); returns (x, new state),
    the state None when none was given."""
    h = L.rms_norm(x, p["ln1"])
    y, S, tm_last = R.rwkv6_time_mix(p["mix"], h, cfg, state=state,
                                     decode=decode)
    x = x + y.to(x.dtype)
    h = L.rms_norm(x, p["ln2"])
    y, cm_last = R.rwkv6_channel_mix(
        p["mix"], h, cfg, prev=state.cm_shift if state is not None else None)
    x = x + y.to(x.dtype)
    if state is None:
        return x, None
    return x, R.RWKVState(S=S, tm_shift=tm_last, cm_shift=cm_last,
                          pos=state.pos + h.shape[1])


def _freeze_dead(new, old, live: torch.Tensor):
    """Per row, the new recurrent state (an `RWKVState` or `SSMState`) or
    the old one: dead rows (live False) keep every leaf (wkv or SSD state,
    shifts or conv tail, pos) bit for bit.  The batch is axis 0 of every
    leaf (the state of one layer)."""
    def sel(n, o):
        return torch.where(live.reshape(live.shape + (1,) * (n.dim() - 1)),
                           n, o)
    return type(new)(*(sel(n, o) for n, o in zip(new, old)))


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _kind_cache(cfg, kind: str, batch: int, cap: int, src_len: int, dtype,
                *, per_slot: bool = False, lead: tuple = (),
                device=None) -> dict:
    """The cache of one layer of `kind`: {"attn": AttnCache} (a shared
    application's own), {"rwkv": RWKVState}, {"ssm": SSMState}, for cross
    {"cross": CrossCache of `src_len` zero rows}, for selfcross both."""
    if kind == "rwkv":
        return {"rwkv": R.state_init(cfg, batch, dtype, per_slot=per_slot,
                                     lead=lead, device=device)}
    if kind == "mamba":
        return {"ssm": M.state_init(cfg, batch, dtype, per_slot=per_slot,
                                    lead=lead, device=device)}
    shape = lead + (batch, src_len, cfg.n_kv, cfg.hd)
    cross = lambda: CrossCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device))
    if kind == "cross":
        return {"cross": cross()}
    if kind in ("full", "global", "self", "shared"):
        c = cap if not cfg.swa_all else min(cfg.window + DECODE_MARGIN, cap)
        ring = cfg.swa_all
    elif kind == "local":
        c, ring = min(cfg.window + DECODE_MARGIN, cap), True
    elif kind == "selfcross":
        c, ring = cap, False
    else:
        raise ValueError(kind)
    out = {"attn": cache_init(batch, c, cfg.n_kv, cfg.hd, dtype, ring=ring,
                              per_slot=per_slot, lead=lead, device=device)}
    if kind == "selfcross":
        out["cross"] = cross()
    return out


def init_caches(cfg, batch: int, context: int, *, src_len: int = 0,
                dtype=None, per_slot: bool = False, device=None) -> dict:
    """Stacked cache tree matching the parameter tree (`src_len` rows of
    cross source for the audio and vlm families).  With `per_slot` every
    position counter is per row (B,): the continuous-batching pool."""
    dtype = dtype or cfg.torch_dtype
    cap = context + DECODE_MARGIN
    pat, rep, tail = expand_pattern(cfg)
    return {
        "stack": tuple(_kind_cache(cfg, k, batch, cap, src_len, dtype,
                                   per_slot=per_slot, lead=(rep,),
                                   device=device) for k in pat),
        "tail": tuple(_kind_cache(cfg, k, batch, cap, src_len, dtype,
                                  per_slot=per_slot, device=device)
                      for k in tail),
    }


# ---------------------------------------------------------------------------
# embedding, head, the cached step
# ---------------------------------------------------------------------------


def _split_dims(t, dim: int) -> list:
    """The mesh dims splitting dim `dim` of DTensor `t`; [] for a plain
    tensor."""
    if not isinstance(t, DTensor):
        return []
    dim %= t.dim()
    return [d for d, p in enumerate(t.placements) if p.is_shard(dim)]


def _row_placements(like: DTensor) -> list:
    """Placements of a (B, ...) tensor split over the batch as `like` is,
    whole over every other mesh dim."""
    return [Shard(0) if p.is_shard(0) else Replicate()
            for p in like.placements]


def _embed(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """The rows of `tokens`, cast to the compute dtype.  `F.embedding`, a
    gather whose backward sums a row's gradients in a fixed order on the
    card: a training rerun there is bit-equal.  On a mesh whose 'model'
    axis splits the table's vocabulary, each rank looks up the tokens of
    its own range (zero rows elsewhere) in its shard, whole over the data
    axes (the FSDP gather of a weight), and one sum over 'model' gives the
    rows (`_vocab_lookup`), unless the sum would move more bytes than the
    table (a long prompt of a small vocabulary), which is then gathered
    whole.  The rows are laid over the data axes, as JAX's `constrain`."""
    table = params["embed"]
    if not _split_dims(table, 0) or 2 * _local_numel(tokens) * table.shape[
            1] * cfg.torch_dtype.itemsize >= table.numel() * \
            table.element_size():
        x = F.embedding(tokens, constrain(table, None, None))
        return constrain(x.to(cfg.torch_dtype), DATA, None, None)
    return constrain(_vocab_lookup(table, tokens, cfg.torch_dtype), DATA,
                     None, None)


def _local_numel(t: torch.Tensor) -> int:
    """Elements of this rank's shard of `t` (all of a plain tensor)."""
    return (t.to_local() if isinstance(t, DTensor) else t).numel()


def _vocab_lookup(table: DTensor, tokens: torch.Tensor, dtype) -> DTensor:
    """`_embed`'s lookup in a table split over its vocabulary: (B, S, d)
    rows, a partial sum over the vocabulary's mesh dims (exactly one rank
    adds a nonzero row), split over the batch as the tokens are."""
    mesh, vdims = table.device_mesh, _split_dims(table, 0)
    want = [p if d in vdims else Replicate()
            for d, p in enumerate(table.placements)]
    shape, off = shard_extent(table.shape, mesh, want)
    lo, n = off[0], shape[0]
    tok_pl = (_row_placements(tokens) if isinstance(tokens, DTensor)
              else [Replicate()] * mesh.ndim)

    def local(tab, tok):
        t = tok.long() - lo
        hit = ((t >= 0) & (t < n))[..., None]
        rows = F.embedding(t.clamp(0, n - 1), tab)
        return torch.where(hit, rows, torch.zeros((), dtype=rows.dtype,
                                                  device=rows.device)
                           ).to(dtype)

    out = [Partial() if d in vdims else p for d, p in enumerate(tok_pl)]
    return on_shards(local, mesh, (table, tokens), (want, tok_pl), out,
                     (*tokens.shape, table.shape[1]))


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
    return constrain(logits, DATA, None, "model")


_STATES = {"rwkv": R.RWKVState, "ssm": M.SSMState, "cross": CrossCache}


def _layer_cache(cache: dict, r: int) -> dict:
    """Layer r of a stacked cache: k/v views, its own pos and state."""
    out = {}
    for key, c in cache.items():
        if key == "attn":
            out[key] = c._replace(k=c.k[r], v=c.v[r], pos=c.pos[r])
        else:
            out[key] = _STATES[key](*(leaf[r] for leaf in c))
    return out


def _restack(cache: dict, layers: list) -> dict:
    """The stacked cache after a step: k/v were written in place, so the
    positions stack back, a recurrent state whole, and a cross cache where
    a prefill replaced it; a key the layers left out (the cross cache of a
    step that kept it) stays as it was."""
    if not layers:
        return cache
    out = {}
    for key, c in cache.items():
        if key not in layers[0]:
            out[key] = c
            continue
        new = [one[key] for one in layers]
        if key == "attn":
            out[key] = c._replace(pos=torch.stack([n.pos for n in new]))
        else:
            out[key] = _STATES[key](*(torch.stack(leaves)
                                      for leaves in zip(*new)))
    return out


def _apply_kind(p: dict, x: torch.Tensor, cfg, kind: str, cache: dict, *,
                decode: bool, live=None, xsrc=None):
    """One layer of `kind` against its cache; returns (x, new cache).  A
    shared application's `p` is the shared block, run as kind full.  A
    cross or selfcross prefill (not decoding, a source given) first
    encodes the source into a new cross cache, as JAX's does on every
    prefill; other steps read the cross cache and leave it out of what
    they return."""
    if kind in ("rwkv", "mamba"):
        key = "rwkv" if kind == "rwkv" else "ssm"
        block = _rwkv_block if kind == "rwkv" else _mamba_block
        x, st = block(p, x, cfg, cache[key], decode)
        if live is not None:
            st = _freeze_dead(st, cache[key], live)
        return x, {key: st}
    xc = cache.get("cross")
    fresh = xc is not None and not decode and xsrc is not None
    if fresh:
        xc = CrossCache(*L.attn_kv(
            p["xattn" if kind == "selfcross" else "attn"], xsrc, cfg))
    x, c = _attn_cached(p, x, cfg, "full" if kind == "shared" else kind,
                        cache.get("attn"), xc, live)
    out = {} if c is None else {"attn": c}
    if fresh:
        out["cross"] = xc
    return x, out


def _step_cached(qparams: ServeTree, x: torch.Tensor, caches: dict, cfg, *,
                 decode: bool, live=None,
                 xsrc: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, dict]:
    """Run every layer over new tokens x (B, S, d) against the caches.
    k/v are written in place into the stacked caches; the new positions,
    recurrent states and cross caches are stacked back.  `decode` runs the
    rwkv and mamba kinds' one-token recurrences instead of their chunked
    scans; `live` (B,) freezes dead rows; `xsrc` is the encoded cross
    source of a prefill."""
    pat, rep, tail = expand_pattern(cfg)
    it = iter(qparams.layers)
    done = [[] for _ in pat]
    for r in range(rep):
        for i, kind in enumerate(pat):
            _, p = next(it)
            x, one = _apply_kind(p, x, cfg, kind,
                                 _layer_cache(caches["stack"][i], r),
                                 decode=decode, live=live, xsrc=xsrc)
            done[i].append(one)
        x = constrain(x, DATA, None, None)
    new_stack = tuple(_restack(c, d) for c, d in zip(caches["stack"], done))
    new_tail = []
    for c in caches["tail"]:
        kind, p = next(it)
        x, one = _apply_kind(p, x, cfg, kind, c, decode=decode, live=live,
                             xsrc=xsrc)
        new_tail.append({**c, **one})
    return x, {"stack": new_stack, "tail": tuple(new_tail)}


def _save_dots():
    """The selective-checkpoint contexts of `remat_policy="dots"`: keep the
    outputs of the products without batch dims (the weight matmuls, which
    reach the dispatcher as `aten.mm`), recompute the rest."""
    keep = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        del ctx, args, kwargs
        return (CP.CheckpointPolicy.MUST_SAVE if op in keep
                else CP.CheckpointPolicy.PREFER_RECOMPUTE)
    return CP.create_selective_checkpoint_contexts(policy)


def _remat(cfg, fn, *args):
    """`fn(*args)`, recomputed in the backward instead of kept when
    `cfg.remat` and gradients are on (nothing inside draws random
    numbers: the noise was drawn before)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    kw = {"context_fn": _save_dots} if cfg.remat_policy == "dots" else {}
    return CP.checkpoint(fn, *args, use_reentrant=False,
                         preserve_rng_state=False, **kw)


def _run_encoder(qparams: ServeTree, frames: torch.Tensor,
                 cfg) -> torch.Tensor:
    """The audio encoder over precomputed frame embeddings (B, S_src, d):
    sinusoidal positions added, the bidirectional enc layers (each one
    recomputed region under remat), the final norm.  The conv/mel frontend
    is a stub, as in JAX."""
    x = frames.to(cfg.torch_dtype)
    S = frames.shape[1]
    x = x + L.sinusoidal_positions(S, cfg.d_model, x.device).to(x.dtype)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    for p in qparams.enc_layers:
        x, _ = _remat(cfg, _attn_full, p, x, cfg, "enc", positions)
    return L.rms_norm(x, qparams["enc"]["final_norm"])


def _cross_source(qparams: ServeTree, cfg, enc_frames, img):
    """The cross-attention source of a call: the encoded frames for the
    audio family, the image tokens in the compute dtype for the vlm
    family, None for the others."""
    if cfg.family == "vlm":
        if img is None:
            raise ValueError(f"{cfg.name} needs its image tokens (img)")
        return img.to(cfg.torch_dtype)
    if cfg.family != "audio":
        return None
    if enc_frames is None:
        raise ValueError(f"{cfg.name} needs its encoder frames (enc_frames)")
    return _run_encoder(qparams, enc_frames, cfg)


def _layers_full(x: torch.Tensor, aux: torch.Tensor, layers: list, cfg,
                 positions: torch.Tensor, xsrc):
    """Uncached layers over a whole sequence; returns (x, aux + their MoE
    aux)."""
    for kind, p in layers:
        if kind == "rwkv":
            x, _ = _rwkv_block(p, x, cfg, None, False)
        elif kind == "mamba":
            x, _ = _mamba_block(p, x, cfg, None, False)
        else:
            x, a = _attn_full(p, x, cfg, "full" if kind == "shared" else kind,
                              positions, xsrc)
            aux = aux + a
    return x, aux


def forward(params: dict, tokens: torch.Tensor, cfg, *,
            training: bool = False, noise=None,
            enc_frames: Optional[torch.Tensor] = None,
            img: Optional[torch.Tensor] = None,
            last_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward over a whole sequence (no caches).  tokens (B, S), for
    the audio family `enc_frames` (B, S_src, d), for the vlm family `img`
    (B, N_img, d) -> (logits (B, S, Vp) fp32, the MoE layers' summed aux
    loss).  `training` quantizes with `cfg.quant` as it is (stochastic
    samples from `noise`: {path: u} or `qlinear.step_noise`), otherwise
    deterministically (the serving tree).  Under remat each repeat of the
    pattern is one recomputed region; the tail layers are not, as in
    JAX."""
    qparams = (_train_quant(params, cfg, noise) if training
               else _serve_quant(params, cfg))
    xsrc = _cross_source(qparams, cfg, enc_frames, img)
    x = _embed(qparams, tokens, cfg)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    aux = torch.zeros((), device=x.device)
    pat, rep, _ = expand_pattern(cfg)
    n = len(pat)
    for r in range(rep):
        x, aux = _remat(cfg, _layers_full, x, aux,
                        qparams.layers[r * n:(r + 1) * n], cfg, positions,
                        xsrc)
        x = constrain(x, DATA, None, None)
    x, aux = _layers_full(x, aux, qparams.layers[rep * n:], cfg, positions,
                          xsrc)
    x = L.rms_norm(x, qparams["final_norm"])
    if last_only:
        x = x[:, -1:]
    return _head(qparams, x, cfg), aux


def _logz_and_target(logits: torch.Tensor, targets: torch.Tensor):
    """(logsumexp of `logits` (B, S, Vp) over the vocabulary, the
    targets' logits), each (B, S).  On a mesh whose 'model' axis splits
    the vocabulary, vocabulary-parallel (`_vocab_parallel`); elsewhere
    the library's `logsumexp` and a gather."""
    if _split_dims(logits, -1):
        return _vocab_parallel(logits, targets)
    logits = constrain(logits, DATA, None, None)
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return logz, tgt


def _vocab_parallel(logits: DTensor, targets: torch.Tensor):
    """`_logz_and_target` over logits split along the vocabulary, as XLA
    partitions JAX's `logsumexp` and `take_along_axis`: each rank's max,
    the max over the vocabulary's mesh dims, each rank's sum of
    exp(x - max), their sum; the target's logit each rank's masked pick,
    summed.  Only (B, S) values cross those dims, forward and backward:
    the gradient of each rank's logits is computed on its shard."""
    mesh, pl = logits.device_mesh, logits.placements
    vdims = _split_dims(logits, -1)
    groups = [mesh.get_group(d).group_name for d in vdims]
    shape, off = shard_extent(logits.shape, mesh, pl)
    lo, n = off[-1], shape[-1]

    def local(lg, tg):
        m = reduce_over(lg.detach().amax(dim=-1, keepdim=True), groups, "max")
        logz = m[..., 0] + torch.log(sum_over(torch.exp(lg - m).sum(dim=-1),
                                              groups))
        t = tg.long() - lo
        hit = (t >= 0) & (t < n)
        pick = torch.gather(lg, -1, t.clamp(0, n - 1)[..., None])[..., 0]
        zero = torch.zeros((), dtype=lg.dtype, device=lg.device)
        return logz, sum_over(torch.where(hit, pick, zero), groups)

    rows = _row_placements(logits)
    return on_shards(local, mesh, (logits, targets), (pl, rows),
                     (rows, rows), (logits.shape[:2], logits.shape[:2]))


def lm_loss(params: dict, batch: dict, cfg, *, training: bool = True,
            noise=None, aux_weight: float = 0.01, z_weight: float = 1e-4):
    """batch {'tokens': (B, S), 'targets': (B, S), and 'img' or
    'enc_frames' where the family reads one} -> (loss, {'nll', 'moe_aux'}):
    the mean nll, plus `aux_weight` x the MoE aux loss, plus `z_weight` x
    mean(logz^2).  On a tensor-parallel mesh the logits stay split over
    the vocabulary (`_logz_and_target`)."""
    logits, aux = forward(params, batch["tokens"], cfg, training=training,
                          noise=noise, img=batch.get("img"),
                          enc_frames=batch.get("enc_frames"))
    logz, tgt = _logz_and_target(logits, batch["targets"])
    nll = torch.mean(logz - tgt)
    loss = nll + aux_weight * aux + z_weight * torch.mean(torch.square(logz))
    return loss, {"nll": nll, "moe_aux": aux}


def prefill(params: dict, tokens: torch.Tensor, caches: dict, cfg, *,
            enc_frames: Optional[torch.Tensor] = None,
            img: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
    """Process a prompt (or one prompt chunk) into the caches.  Returns the
    last token's logits (B, Vp) and the caches.  The audio family encodes
    `enc_frames` (the vlm family casts `img`) on every call and replaces
    its cross caches with their k/v.  JAX's `n` (bucket padding rewound off
    the caches) has no counterpart: chunks run at their own length.  Its
    packed products take the sequence route (the GEMM) at any chunk
    length, so a prompt's rows sum alike whole and in chunks."""
    with product_role("sequence"):
        qparams = _serve_quant(params, cfg)
        xsrc = _cross_source(qparams, cfg, enc_frames, img)
        x = _embed(qparams, tokens, cfg)
        x, caches = _step_cached(qparams, x, caches, cfg, decode=False,
                                 xsrc=xsrc)
        x = L.rms_norm(x[:, -1:], qparams["final_norm"])
        return _head(qparams, x, cfg)[:, 0], caches


def verify_step(params: dict, tokens: torch.Tensor, caches: dict, cfg,
                live=None) -> Tuple[torch.Tensor, dict]:
    """Speculative verify: one multi-token decode over the candidate span.
    tokens (B, S) -> (logits (B, S, Vp), caches).  Each position's head runs
    at the decode step's (B, 1, d) shape, as JAX unrolls it, so a verified
    stream's rounding is plain decoding's where the head's is row-count
    dependent.  Rollback is the caller's (kvcache.cache_spec_commit).  Its
    packed products take the step route (the GEMV), as decode's do."""
    with product_role("step"):
        qparams = _serve_quant(params, cfg)
        x = _embed(qparams, tokens, cfg)
        x, caches = _step_cached(qparams, x, caches, cfg, decode=True,
                                 live=live)
        x = L.rms_norm(x, qparams["final_norm"])
        logits = [_head(qparams, x[:, i:i + 1], cfg)[:, 0]
                  for i in range(tokens.shape[1])]
        return torch.stack(logits, dim=1), caches


def decode_step(params: dict, token: torch.Tensor, caches: dict, cfg,
                live=None) -> Tuple[torch.Tensor, dict]:
    """One decode step.  token (B,) or (B, 1) -> (logits (B, Vp), caches).
    `live` (B,) is the engine's occupancy mask: dead rows' caches stay
    frozen bit for bit (their logits are garbage and never sampled).  Its
    packed products take the step route (the GEMV) at any batch."""
    if token.dim() == 1:
        token = token[:, None]
    with product_role("step"):
        qparams = _serve_quant(params, cfg)
        x = _embed(qparams, token, cfg)
        x, caches = _step_cached(qparams, x, caches, cfg, decode=True,
                                 live=live)
        x = L.rms_norm(x, qparams["final_norm"])
        return _head(qparams, x, cfg)[:, 0], caches
