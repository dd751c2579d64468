"""Architecture registry of the port: every arch of the transformer pool
(`ARCH_IDS`, `get_config`) and the paper's own RNN model
(`RNN_ARCH_IDS`, `get_rnn_config`), as in `repro/configs/__init__.py`."""
from __future__ import annotations

from importlib import import_module

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "llama3-8b": "llama3_8b",
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen3-1.7b": "qwen3_1_7b",
    "gemma3-27b": "gemma3_27b",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-base": "whisper_base",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "zamba2-1.2b": "zamba2_1_2b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mixtral-8x7b": "mixtral_8x7b",
}

ARCH_IDS = tuple(_ARCH_MODULES)

# Kept out of ARCH_IDS, as in the JAX package: RNNConfig, not ModelConfig.
RNN_ARCH_IDS = ("rnn-paper",)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}").config()


def get_rnn_config(name: str):
    """RNNConfig for a paper arch at full scale (`rnn_paper.reduced`
    shrinks it): 'rnn-paper' is the char-PTB BN-LSTM, H = 1000, ternary."""
    if name not in RNN_ARCH_IDS:
        raise KeyError(f"unknown RNN arch {name!r}; known: {RNN_ARCH_IDS}")
    from repro_torch.configs import rnn_paper
    return rnn_paper.char_ptb()
