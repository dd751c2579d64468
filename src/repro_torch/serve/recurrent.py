"""Serving runtimes, ported from `repro/serve/recurrent.py`: one stateful
prefill/decode interface over the paper's BN-LSTM/GRU and the transformer
pool's dense, MoE, RWKV6, hybrid (zamba2), audio (whisper) and vlm
(llama-3.2-vision) families.

    rt = serving_runtime(cfg, params)          # on the card by default
    state = rt.init_state(batch, context)
    logits, state = rt.prefill(tokens, state)  # (B, V) last-token logits
    logits, state = rt.decode_step(tok, state) # tok: (B,) int

`RNNRuntime` moves the variables to its device and builds the decode
tables once (frozen-BN affines, the BN-folded layer-0 row table, the
stacked whole-tick artifact), so a packed tree decodes through one
fused-kernel launch per tick.  `TransformerRuntime` holds the parameter
tree (fp masters or a packed export) and prepares its serving tree once
(`transformer._serve_quant`: quantized, cast to the compute dtype,
per-layer views), so no step re-casts a weight; its state is the stacked
kv caches (an `RWKVState` for rwkv layers, an `SSMState` for mamba ones,
a `CrossCache` beside a selfcross layer's kv cache), sized by
`configs.shapes.decode_context`.  `extras` are the keyword inputs every
prefill passes on (the audio family's `enc_frames`, the vlm family's
`img`); the engine refuses
a runtime that has them, as JAX's does.  Its `chunk_granularity` says
how the engine may split a prompt: "token" anywhere, "whole" (MoE, whose
tokens compete for capacity across the call, and rwkv and mamba, whose
chunked scans round by their chunk boundaries) as one chunk.
`drive_session` is the canonical prefill -> sample -> decode loop the
launchers and the chip smoke drive.

Both carry the continuous-batching engine's hooks (`serve/engine.py`):
`init_state(per_slot=True)`, `decode_fn` with a `live` mask,
`prefill_chunk`, and the speculative
`spec_snapshot`/`spec_emit`/`verify`/`spec_commit`.  JAX's `jit_prm` (the
weights threaded into the engine's jits as an argument, so XLA cannot fold
them) has no counterpart: PyTorch runs eagerly and folds nothing.
`speculative_draft` packs an fp target's own masters into a ternary/binary
draft runtime.

On a mesh (the engine's `mesh=`): `serve_prm_shardings(mesh)` gives the
weights' serving layouts, as JAX's does: the RNN replicates everything
(O(H^2) weights; its ticks are data-parallel only), the transformer
takes `sharding.serve_param_shardings` (tensor-parallel over 'model',
replicated over the data axes), a packed leaf's codes and scale projected
by `qtensor_pspecs`.  `on_mesh(mesh)` is the runtime whose weights lie so:
the RNN's, and any runtime's on a model axis of 1, is itself; a
transformer's on a model axis above 1 holds DTensors over the mesh's
'model' dims, and its steps then run inside `mesh_context()`.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.shapes import decode_context
from repro_torch.core import bnlstm as BL
from repro_torch.core.qtensor import (export_packed, is_qtensor, tree_leaves,
                                      tree_map, tree_nbytes, tree_to)
from repro_torch.core.quantize import QuantSpec
from repro_torch.kernels import dispatch
from repro_torch.launch import sharding as S
from repro_torch.models import transformer as T
from repro_torch.runtime import axis_sizes, use_mesh
from repro_torch.serve.kvcache import cache_spec_commit, cache_spec_snapshot
from repro_torch.serve.prefixcache import tree_bytes
from repro_torch.serve.sampler import SAMPLE, draw_batch, gumbel, sample


def state_nbytes(state: Any) -> int:
    """Bytes a session's state occupies (h/c vectors or kv caches)."""
    return tree_bytes(state)


class RNNRuntime:
    """BN-LSTM / BN-GRU serving session."""

    family = "rnn"
    # speculative decoding: verify is the decode step itself, rollback a
    # select over the per-step states
    spec_capable = True

    def __init__(self, cfg: BL.RNNConfig, variables: dict, *,
                 device: Optional[str | torch.device] = None):
        self.cfg = cfg
        self.device = dispatch.resolve_device(device)
        self.variables = tree_to(variables, self.device)
        self.tables = BL.rnn_decode_tables(self.variables, cfg)

    def init_state(self, batch: int, context: int = 0, *,
                   per_slot: bool = False) -> BL.RNNState:
        """A zero state; its size does not grow with the context."""
        del context
        return BL.rnn_state_init(self.cfg, batch, per_slot=per_slot,
                                 device=self.device)

    def prefill(self, tokens: torch.Tensor, state: BL.RNNState):
        """Run the prompt; returns the last token's logits (B, V) through
        the shared (B, 1, H) head, and the carried state."""
        _, state = BL._prefill_state(self.variables, tokens, self.cfg, state,
                                     self.tables)
        return BL.rnn_logits_last(self.variables, state, self.cfg), state

    def decode_step(self, tok: torch.Tensor, state: BL.RNNState):
        return BL.rnn_decode_step(self.variables, tok, self.cfg, state,
                                  tables=self.tables)

    # -- the engine's hooks ---------------------------------------------------

    def decode_fn(self, tok: torch.Tensor, state: BL.RNNState,
                  live: Optional[torch.Tensor] = None):
        """The engine's tick body: `live` (B,) freezes dead slots' h, c and
        pos bit for bit (inside the fused kernel on a packed tree)."""
        return BL.rnn_decode_step(self.variables, tok, self.cfg, state,
                                  tables=self.tables, live=live)

    def prefill_chunk(self, tokens: torch.Tensor, state: BL.RNNState):
        """One prompt chunk (B, T), carrying the state: the O(1) carry makes
        any split of a prompt exact.  Returns the first-token logits (B, V)
        and the state."""
        return BL.rnn_prefill_chunk(self.variables, tokens, self.cfg, state,
                                    tables=self.tables)

    # Rollback is the O(1) state again: each step of a draft or verify span
    # emits its (h, c), and committing n tokens selects from the stack, so
    # there is nothing to snapshot.

    def spec_snapshot(self, state: BL.RNNState, span: int):
        del state, span
        return ()

    def spec_emit(self, state: BL.RNNState):
        """The per-step rollback material of the engine's draft loop."""
        return (state.h, state.c)

    def verify(self, tokens: torch.Tensor, state: BL.RNNState,
               live: Optional[torch.Tensor] = None):
        """(B, T) tokens -> (logits (B, T, V), end state, per-step emits),
        each position bit-identical to that many decode steps."""
        return BL.rnn_verify(self.variables, tokens, self.cfg, state,
                             tables=self.tables, live=live)

    def spec_commit(self, state0: BL.RNNState, state_after: BL.RNNState,
                    snap, emits, n: torch.Tensor) -> BL.RNNState:
        del state_after, snap
        return BL.rnn_spec_commit(state0, emits, n)

    def param_nbytes(self) -> tuple[int, int]:
        return tree_nbytes(self.variables["params"])

    def serve_prm_shardings(self, mesh) -> Any:
        """Everything replicated (JAX's: the RNN's mesh engine is
        data-parallel only)."""
        return tree_map(lambda _: (), self.variables)

    def on_mesh(self, mesh) -> "RNNRuntime":
        return self

    def mesh_context(self):
        return contextlib.nullcontext()


class TransformerRuntime:
    """Serving session of the transformer pool's dense (llama3, qwen3,
    gemma3), MoE (mixtral, qwen3-moe), RWKV6, hybrid (zamba2), audio
    (whisper) and vlm (llama-3.2-vision) families.  `params` is the
    model's tree, fp masters or a packed export
    (`core.qtensor.export_packed`); the state is the stacked caches of
    `transformer.init_caches`.  `extras` (moved to the device) go to every
    prefill: whisper's `enc_frames` (B, S_src, d), the VLM's `img` (B,
    N_img, d)."""

    family = "transformer"

    def __init__(self, cfg, params: dict, *, extras: Optional[dict] = None,
                 device: Optional[str | torch.device] = None):
        T.check_ported(cfg)
        self.cfg = cfg
        self.device = dispatch.resolve_device(device)
        self.params = tree_to(params, self.device)
        self.extras = tree_to(dict(extras or {}), self.device)
        self.served = T._serve_quant(self.params, cfg)
        # An attention layer's math is per token given the cache, so any
        # split of a prompt into chunks is exact.  MoE capacity competition
        # spans the whole call and the rwkv and mamba scans re-chunk at
        # other boundaries, so those archs prefill a prompt as one in-slot
        # chunk.  Speculation needs a per-token-exact multi-token step and
        # non-ring caches: ring (sliding-window) caches recycle columns, so
        # neither a rejected span nor a prefix snapshot can be cut back out.
        pat, _, tail = T.expand_pattern(cfg)
        kinds = set(pat + tail)
        whole = bool(kinds & {"mamba", "rwkv"}) or cfg.n_experts > 0
        self.chunk_granularity = "whole" if whole else "token"
        self.ring_caches = cfg.swa_all or "local" in kinds
        self.spec_capable = not whole and not self.ring_caches

    def init_state(self, batch: int, context: int, *,
                   per_slot: bool = False) -> dict:
        """Zero caches for `context` tokens; the audio and vlm families'
        cross caches hold `decode_context`'s source length until a prefill
        replaces them."""
        _, src = decode_context(self.cfg, context)
        return T.init_caches(self.cfg, batch, context, src_len=src,
                             per_slot=per_slot, device=self.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, state: dict):
        return T.prefill(self.served, tokens.to(self.device), state,
                         self.cfg, **self.extras)

    @torch.no_grad()
    def decode_step(self, tok: torch.Tensor, state: dict):
        return T.decode_step(self.served, tok, state, self.cfg)

    # -- the engine's hooks ---------------------------------------------------

    @torch.no_grad()
    def decode_fn(self, tok: torch.Tensor, state: dict,
                  live: Optional[torch.Tensor] = None):
        """The engine's tick body: `live` (B,) freezes dead rows' cache
        bytes and pos bit for bit (a dead row may be mid-prefill)."""
        return T.decode_step(self.served, tok, state, self.cfg, live=live)

    @torch.no_grad()
    def prefill_chunk(self, tokens: torch.Tensor, state: dict):
        """One prompt chunk (B, T) against the carried caches; returns its
        last token's logits (B, V) and the caches."""
        return T.prefill(self.served, tokens, state, self.cfg)

    # Rollback is byte surgery on the caches: snapshot the span of k/v a
    # draft or verify is about to overwrite; commit restores the rejected
    # suffix and rewinds each slot's pos.

    def spec_snapshot(self, state: dict, span: int):
        return tree_map(lambda c: cache_spec_snapshot(c, span), state)

    def spec_emit(self, state: dict):
        del state  # the snapshot carries all rollback material
        return ()

    @torch.no_grad()
    def verify(self, tokens: torch.Tensor, state: dict,
               live: Optional[torch.Tensor] = None):
        """(B, T) tokens -> (logits (B, T, V), caches, ()): each position
        through the decode step's head shape."""
        logits, state = T.verify_step(self.served, tokens, state, self.cfg,
                                      live=live)
        return logits, state, ()

    def spec_commit(self, state0: dict, state_after: dict, snap, emits,
                    n: torch.Tensor) -> dict:
        del state0, emits
        return tree_map(lambda c, s: cache_spec_commit(c, s, n),
                        state_after, snap)

    def param_nbytes(self) -> tuple[int, int]:
        return tree_nbytes(self.params)

    # -- a mesh ---------------------------------------------------------------

    tp_mesh = None  # the 'model' submesh the weights are sharded over

    def serve_prm_shardings(self, mesh) -> Any:
        """`sharding.serve_param_shardings` of the parameter tree: TP over
        'model', replicated over the data axes; a QTensor of layouts for a
        packed leaf."""
        return S.serve_param_shardings(self.params, mesh)

    def on_mesh(self, mesh) -> "TransformerRuntime":
        """This runtime with its weights tensor-parallel over `mesh`'s
        'model' axis: the parameters DTensors in `serve_prm_shardings`'
        layouts over the model submesh (each rank keeps its shard) and the
        serving tree prepared from them; itself on a model axis of 1."""
        if axis_sizes(mesh).get("model", 1) == 1:
            return self
        rt = copy.copy(self)
        rt.tp_mesh = mesh["model"]
        rt.params = S.distribute(self.params, self.serve_prm_shardings(mesh),
                                 rt.tp_mesh)
        with rt.mesh_context():
            rt.served = T._serve_quant(rt.params, self.cfg)
        return rt

    def mesh_context(self):
        """Where a tensor-parallel runtime's steps run: the model submesh
        current (the model's `constrain` calls) and plain tensors (token
        ids, positions, masks) taken as replicated beside DTensors."""
        if self.tp_mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication
        stack = contextlib.ExitStack()
        stack.enter_context(use_mesh(self.tp_mesh))
        stack.enter_context(implicit_replication())
        return stack


def serving_runtime(cfg, params: dict, **kw):
    """The one constructor: an RNNConfig gives an `RNNRuntime` over the
    {'params', 'state'} variables, a ModelConfig a `TransformerRuntime`
    (every family of the pool)."""
    if isinstance(cfg, BL.RNNConfig):
        return RNNRuntime(cfg, params, **kw)
    return TransformerRuntime(cfg, params, **kw)


def speculative_draft(rt, mode: str = "ternary"):
    """Self-speculation: pack the fp target runtime's own masters into a
    binary/ternary draft runtime on the same device, sharing the target's
    config dims (and, for the RNN, its frozen BN statistics).  An RNN draft
    decodes through the fused tick, where JAX's `dense` switch could expand
    it into dense tables; a transformer draft's projections run the packed
    GEMV and GEMM, and it keeps the target's `extras`."""
    packed_msg = ("speculative pairing packs the target's fp masters; this "
                  "runtime already serves a packed tree: build the pair from "
                  "the master weights instead")
    if isinstance(rt, RNNRuntime):
        if is_qtensor(rt.variables["params"]["layers"][0]["wx"]):
            raise ValueError(packed_msg)
        dcfg = dataclasses.replace(rt.cfg, quant=QuantSpec(mode=mode,
                                                           norm="batch"))
        packed = BL.export_packed_rnn(rt.variables["params"], dcfg)
        return RNNRuntime(dcfg, {"params": packed,
                                 "state": rt.variables["state"]},
                          device=rt.device)
    if not isinstance(rt, TransformerRuntime):
        raise NotImplementedError(
            f"speculative pairing packs the target's fp masters into the "
            f"RNN's or the transformer pool's runtime, as JAX's does; a "
            f"{getattr(rt, 'family', type(rt))} runtime is neither")
    if any(is_qtensor(l) for l in tree_leaves(rt.params)):
        raise ValueError(packed_msg)
    dcfg = rt.cfg.with_quant(QuantSpec(mode=mode, norm="channel"))
    return TransformerRuntime(dcfg, export_packed(rt.params, dcfg.quant),
                              extras=dict(rt.extras), device=rt.device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive_session(rt, prompt: torch.Tensor, vocab: int, *,
                  gen: int, temperature: float = 0.8, top_k: int = 0,
                  seed: int = 0, warmup: bool = False,
                  context: Optional[int] = None):
    """The canonical prefill -> sample -> decode session, timed.

    Row b samples as a request of seed `seed + b`: token i draws from the
    counter-based stream (seed + b, i) (serve/sampler.py), the one the
    engine draws a request's token i from, so a request's stream is the
    same here and in the engine.  The session's noise is drawn at once,
    before its first step.  With `warmup` an untimed prefill and decode
    step run first on their own state.  `context` is the provisioned
    context (a transformer's cache capacity less its margin), S + gen by
    default: an engine parity check passes the engine's `max_context`, so
    both attend over caches of one size.  Returns (generated (B, gen) int
    numpy array, metrics with prefill/decode seconds, tok/s, the state
    bytes and `last_logits`, the logits the session ended on)."""
    dev = rt.device
    prompt = prompt.to(dev)
    B, S = prompt.shape
    context = context or (S + gen)
    seeds = seed + torch.arange(B, device=dev)

    def session_sampler(logits):
        if temperature <= 0.0:
            return lambda lg, i: sample(lg, seeds, i, temperature=0.0,
                                        vocab=vocab)
        noise = gumbel(seeds, 0, SAMPLE, (B, gen, logits.shape[-1]), dev)
        return lambda lg, i: draw_batch(lg, noise[:, i],
                                        temperature=temperature,
                                        top_k=top_k, vocab=vocab)

    if warmup:
        lg_w, st_w = rt.prefill(prompt, rt.init_state(B, context))
        nxt_w = session_sampler(lg_w)(lg_w, 0) if gen else None
        if nxt_w is not None:
            rt.decode_step(nxt_w, st_w)
        _sync(dev)
        del lg_w, st_w, nxt_w

    state = rt.init_state(B, context)
    _sync(dev)
    t0 = time.perf_counter()
    logits, state = rt.prefill(prompt, state)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    toks = []
    t0 = time.perf_counter()
    pick = session_sampler(logits) if gen else None
    for i in range(gen):
        nxt = pick(logits, i)
        toks.append(nxt)  # stays on the device: no host round-trip per step
        logits, state = rt.decode_step(nxt, state)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    out = torch.stack(toks, dim=1).cpu().numpy() if toks else \
        np.zeros((B, 0), np.int32)
    metrics = {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "prefill_tok_s": B * S / t_prefill,
        "decode_tok_s": B * gen / t_decode if gen else 0.0,
        "state_nbytes": state_nbytes(state),
        "last_logits": logits,
    }
    return out, metrics
