"""Recurrent serving runtime for the paper's BN-LSTM/GRU, ported from the
RNN half of `repro/serve/recurrent.py`:

    rt = RNNRuntime(cfg, variables)            # on the card by default
    state = rt.init_state(batch)
    logits, state = rt.prefill(tokens, state)  # (B, V) last-token logits
    logits, state = rt.decode_step(tok, state) # tok: (B,) int

The runtime moves the variables to its device and builds the decode tables
once (frozen-BN affines, the BN-folded layer-0 row table, the stacked
whole-tick artifact), so a packed tree decodes through one fused-kernel
launch per tick with no per-call preparation.  `drive_session` is the
canonical prefill -> sample -> decode loop the launcher and the chip smoke
drive.
"""
from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import bnlstm as BL
from repro_torch.core.qtensor import tree_leaves, tree_nbytes, tree_to
from repro_torch.kernels import dispatch
from repro_torch.serve.sampler import sample


def state_nbytes(state: Any) -> int:
    """Bytes a session's recurrent state occupies."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(state)
               if isinstance(t, torch.Tensor))


class RNNRuntime:
    """BN-LSTM / BN-GRU serving session."""

    family = "rnn"

    def __init__(self, cfg: BL.RNNConfig, variables: dict, *,
                 device: Optional[str | torch.device] = None):
        self.cfg = cfg
        self.device = dispatch.resolve_device(device)
        self.variables = tree_to(variables, self.device)
        self.tables = BL.rnn_decode_tables(self.variables, cfg)

    def init_state(self, batch: int) -> BL.RNNState:
        """A zero state; its size does not grow with the context."""
        return BL.rnn_state_init(self.cfg, batch, device=self.device)

    def prefill(self, tokens: torch.Tensor, state: BL.RNNState):
        """Run the prompt; returns the last token's logits (B, V) through
        the shared (B, 1, H) head, and the carried state."""
        _, state = BL._prefill_state(self.variables, tokens, self.cfg, state,
                                     self.tables)
        return BL.rnn_logits_last(self.variables, state, self.cfg), state

    def decode_step(self, tok: torch.Tensor, state: BL.RNNState):
        return BL.rnn_decode_step(self.variables, tok, self.cfg, state,
                                  tables=self.tables)

    def param_nbytes(self) -> tuple[int, int]:
        return tree_nbytes(self.variables["params"])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive_session(rt: RNNRuntime, prompt: torch.Tensor, vocab: int, *,
                  gen: int, temperature: float = 0.8, top_k: int = 0,
                  seed: int = 0, warmup: bool = False):
    """The canonical prefill -> sample -> decode session, timed.

    With `warmup` an untimed prefill and decode step run first on their own
    state.  Returns (generated (B, gen) int numpy array, metrics with
    prefill/decode seconds, tok/s, the state bytes and `last_logits`, the
    logits the session ended on)."""
    dev = rt.device
    prompt = prompt.to(dev)
    B, S = prompt.shape
    gen_rng = torch.Generator(device=dev)
    if warmup:
        gen_rng.manual_seed(seed)
        lg_w, st_w = rt.prefill(prompt, rt.init_state(B))
        nxt_w = sample(lg_w, gen_rng, temperature=temperature, top_k=top_k,
                       vocab=vocab)
        rt.decode_step(nxt_w, st_w)
        _sync(dev)
        del lg_w, st_w, nxt_w

    state = rt.init_state(B)
    gen_rng.manual_seed(seed)
    _sync(dev)
    t0 = time.perf_counter()
    logits, state = rt.prefill(prompt, state)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    toks = []
    t0 = time.perf_counter()
    for _ in range(gen):
        nxt = sample(logits, gen_rng, temperature=temperature, top_k=top_k,
                     vocab=vocab)
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
