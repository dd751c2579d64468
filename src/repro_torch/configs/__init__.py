"""Architecture registry of the port: the paper's own RNN model."""
from __future__ import annotations

RNN_ARCH_IDS = ("rnn-paper",)


def get_rnn_config(name: str):
    """RNNConfig for a paper arch at full scale (`rnn_paper.reduced`
    shrinks it): 'rnn-paper' is the char-PTB BN-LSTM, H = 1000, ternary."""
    if name not in RNN_ARCH_IDS:
        raise KeyError(f"unknown RNN arch {name!r}; known: {RNN_ARCH_IDS}")
    from repro_torch.configs import rnn_paper
    return rnn_paper.char_ptb()
