"""whisper-base [audio] — enc-dec backbone; the conv/mel frontend is a STUB
(input_specs supplies precomputed (B, S, 512) frame embeddings)
[arXiv:2212.04356].  seq_len shapes refer to encoder frames; decoder length
is min(448, max(64, S//8)) per DESIGN.md."""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantize import QuantSpec


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="audio",
        n_layers=6,          # decoder
        n_enc_layers=6,
        d_model=512,
        n_heads=8,
        n_kv=8,
        head_dim=64,
        d_ff=2048,
        vocab=51865,
        mlp="gelu",
        block_pattern=("selfcross",),
        max_target_len=448,
        quant=QuantSpec(mode="ternary", norm="channel"),
    )
