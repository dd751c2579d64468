"""The paper's own experimental model configurations (Tables 1-6), ported
from `repro/configs/rnn_paper.py`.  Sizes follow Appendix C."""
from __future__ import annotations

import dataclasses

from repro_torch.core.bnlstm import RNNConfig
from repro_torch.core.quantize import QuantSpec


def _rnn(vocab, hidden, layers=1, cell="lstm", mode="ternary") -> RNNConfig:
    return RNNConfig(vocab=vocab, d_hidden=hidden, n_layers=layers, cell=cell,
                     quant=QuantSpec(mode=mode, norm="batch"))


# --- character-level LM (Tables 1, 2, 6) -------------------------------------
def char_ptb(cell="lstm", mode="ternary") -> RNNConfig:
    return _rnn(50, 1000, cell=cell, mode=mode)


def char_war_peace(cell="lstm", mode="ternary") -> RNNConfig:
    return _rnn(87, 512, cell=cell, mode=mode)


def char_linux(cell="lstm", mode="ternary") -> RNNConfig:
    return _rnn(101, 512, cell=cell, mode=mode)


def char_text8(mode="ternary") -> RNNConfig:
    return _rnn(27, 2000, mode=mode)


# --- word-level LM (Table 3) --------------------------------------------------
def word_ptb_small(mode="ternary") -> RNNConfig:
    return _rnn(10000, 300, mode=mode)


def word_ptb_medium(mode="ternary") -> RNNConfig:
    return _rnn(10000, 650, mode=mode)


def word_ptb_large(mode="ternary") -> RNNConfig:
    return _rnn(10000, 1500, layers=2, mode=mode)


# --- sequential MNIST (Table 4): 100 units, pixel by pixel --------------------
def seq_mnist(mode="ternary") -> RNNConfig:
    return _rnn(256, 100, mode=mode)


def reduced(cfg: RNNConfig, hidden: int = 64) -> RNNConfig:
    """CPU-scale variant of the same config (same code paths)."""
    return dataclasses.replace(cfg, d_hidden=hidden)
