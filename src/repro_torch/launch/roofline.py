"""Roofline analysis of the dry-run's per-rank counts on the H100, ported
from `repro/launch/roofline.py`.

Terms (per rank, one rank a card, seconds) for an NVIDIA H100 SXM:

  compute    = FLOPs / PEAK_FLOPS          dense bf16 on the tensor cores
  memory     = bytes / HBM_BW              HBM3
  collective = wire_bytes / LINK_BW        the slowest link a group crosses

The dry-run (`launch/dryrun.py`) counts rank 0's FLOPs and bytes op by op
and records each collective it issues as (kind, result bytes on one rank,
group size).  `collective_wire_bytes` applies the ring-algorithm wire
factor for a group of g ranks to each record:

  all-reduce     2 * S * (g-1)/g     all-gather      S * (g-1)/g   (S = result)
  reduce-scatter S * (g-1)/g         all-to-all      S * (g-1)/g
  collective-permute  S

MODEL_FLOPS uses the 6ND (train) / 2ND (inference) convention with N =
active parameters; the ratio MODEL_FLOPS / counted FLOPs exposes remat
and dispatch overhead (a train step with full remat recomputes its
forward: 6ND of 8ND; MoE capacity slack and attention FLOPs push it
further down).

The card's peaks live here and nowhere else: `chip_smoke.py` and
`time_kernels.py` read them from this module.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W
# power limit (a card set below it runs slower under load).
PEAK_FLOPS = 989e12        # bf16 (and fp16) on the tensor cores
HBM_BW = 3.35e12           # bytes/s, HBM3
FP32_FLOP_S = 67e12        # fp32 on the CUDA cores (an FMA = 2 flop)
FP32_ADD_S = FP32_FLOP_S / 2  # an FADD issues at the FMA instruction rate
SM_CLOCK_HZ = 1.98e9       # boost clock (n cycles last >= n / this)
# bytes/s a rank: InfiniBand NDR, 400 Gb/s a GPU.  Every axis of the
# production meshes (16 ranks) spans at least two 8-GPU HGX H100 nodes, so
# each group crosses that link; NVLink 4's 450 GB/s a direction holds only
# inside a node.
LINK_BW = 50e9

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

Record = Tuple[str, float, int]  # (kind, result bytes on one rank, group size)


def collective_wire_bytes(records: Iterable[Record]) -> Dict[str, float]:
    """Per-rank wire bytes by collective kind, ring-algorithm accounting,
    from the dry-run's records; a group of one rank moves nothing."""
    out: Dict[str, float] = {}
    for op, size, g in records:
        if op not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {op!r}")
        if g <= 1:
            continue
        frac = (g - 1) / g
        if op == "all-reduce":
            wire = 2.0 * size * frac
        elif op == "collective-permute":
            wire = float(size)
        else:  # all-gather / reduce-scatter / all-to-all
            wire = size * frac
        out[op] = out.get(op, 0.0) + wire
    return out


@dataclasses.dataclass
class Roofline:
    flops: float              # per rank
    hbm_bytes: float          # per rank: the counted bytes (upper bound:
                              # fusion-blind, counts every intermediate)
    wire_bytes: float         # per rank
    collectives: Dict[str, float]
    model_flops: float        # per rank (6ND or 2ND / n_chips)
    hbm_bytes_model: float = 0.0  # analytic HBM traffic (analytic_hbm_bytes)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory_xla(self) -> float:
        """The counted bytes' term (JAX's name: XLA's `bytes accessed`)."""
        return self.hbm_bytes / HBM_BW

    @property
    def t_memory(self) -> float:
        """Analytic model when available (the counted bytes know no
        fusion and overstate HBM traffic several-fold)."""
        return (self.hbm_bytes_model or self.hbm_bytes) / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved IF the step runs at the
        bound: (model_flops / peak) / bound_time."""
        if self.bound_time == 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / self.bound_time

    def to_json(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "hbm_bytes_model_per_chip": self.hbm_bytes_model,
            "wire_bytes_per_chip": self.wire_bytes,
            "collectives": self.collectives,
            "model_flops_per_chip": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_memory_xla_s": self.t_memory_xla,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


# ---------------------------------------------------------------------------
# analytic parameter / FLOP counts per architecture
# ---------------------------------------------------------------------------


def param_counts(cfg) -> tuple[float, float]:
    """(total, active) parameter counts from the config (quantizable matmul
    weights + embeddings; norms/bias omitted — O(d) noise)."""
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    hd = cfg.hd
    attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv * hd + cfg.n_heads * hd * d
    if cfg.family == "ssm":  # rwkv6: 5 square tm + channel mix
        per_layer = 5 * d * d + (2 * d * ff + d * d)
        total = cfg.n_layers * per_layer
        active = total
    elif cfg.family == "hybrid":
        di = cfg.d_inner
        N = cfg.ssm_state
        H = cfg.ssm_heads
        mamba = d * (2 * di + 2 * N + H) + di * d
        shared = attn + 3 * d * ff
        total = cfg.n_layers * mamba + shared
        napp = cfg.n_layers // max(cfg.attn_every, 1)
        active = cfg.n_layers * mamba + napp * shared
    else:
        if cfg.n_experts > 0:
            moe = cfg.n_experts * 3 * d * ff
            act_moe = cfg.topk * 3 * d * ff
            total_layer = attn + moe
            active_layer = attn + act_moe
        elif cfg.mlp == "gelu":
            total_layer = active_layer = attn + 2 * d * ff
        else:
            total_layer = active_layer = attn + 3 * d * ff
        n_dec = cfg.n_layers
        total = n_dec * total_layer
        active = n_dec * active_layer
        if cfg.family == "audio":
            enc_layer = attn + 2 * d * ff
            total += cfg.n_enc_layers * enc_layer
            active += cfg.n_enc_layers * enc_layer
            total += n_dec * (attn + 2 * d * ff) - n_dec * 0  # cross attn per dec layer
            active += n_dec * attn  # xattn
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    return total + emb, active + emb


def analytic_hbm_bytes(cfg, shape, n_chips: int, *, weight_bits: float = 16,
                       act_bytes: int = 2) -> float:
    """Per-rank HBM traffic model.

    train  = 3 weight streams (fwd + bwd + remat recompute) of the ACTIVE
             bf16 compute weights, + optimizer sweep over the fp32 master/
             m/v shards (7 fp32 passes of TOTAL params, FSDP-sharded), +
             activation checkpoints (layer boundaries, write+read), + KV
             materialization (write+read per layer).
    prefill = 1 weight stream + KV write + causal KV re-reads (chunked:
             each of S/chunk chunks reads ~half the KV written so far).
    decode  = 1 weight-shard stream per token + full KV-cache shard read.

    `weight_bits` models the paper's packed-weight serving path (2 for
    ternary, 1 for binary, 16 for bf16): the decode weight stream shrinks
    by 8x/16x against bf16 weights.
    """
    total, active = param_counts(cfg)
    wbytes = active * weight_bits / 8.0
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    n_layers_eff = cfg.n_layers + (cfg.n_enc_layers or 0)

    if cfg.family == "audio":
        from repro_torch.configs.shapes import whisper_dec_len
        dec = whisper_dec_len(S)
        tokens, kv_tokens = B * dec, B * S
    else:
        tokens, kv_tokens = B * S, B * S

    kv_layer_bytes = 2 * cfg.n_kv * cfg.hd * act_bytes  # per token per layer

    if shape.kind == "train":
        w_stream = 3.0 * wbytes
        opt = 7.0 * total * 4.0
        act_ckpt = 2.0 * n_layers_eff * tokens * d * act_bytes
        kv = 2.0 * n_layers_eff * kv_tokens * kv_layer_bytes
        return (w_stream + opt + act_ckpt + kv) / n_chips
    if shape.kind == "prefill":
        n_chunks = max(S // max(cfg.attn_chunk, 1), 1)
        kv_write = n_layers_eff * kv_tokens * kv_layer_bytes
        kv_read = kv_write * n_chunks / 2.0
        act = n_layers_eff * tokens * d * act_bytes
        return (wbytes + kv_write + kv_read + act) / n_chips
    # decode: one token; window layers cap their cache reads
    kv_read = 0.0
    from repro_torch.models.transformer import expand_pattern
    pat, rep, tail = expand_pattern(cfg)
    kinds = list(pat) * rep + list(tail)
    for k in kinds:
        if k in ("mamba", "rwkv"):
            if cfg.family == "hybrid":
                di, N = cfg.d_inner, cfg.ssm_state
                kv_read += B * (di // cfg.ssm_headdim) * N * cfg.ssm_headdim * 4
            else:
                H = cfg.d_model // cfg.hd
                kv_read += B * H * cfg.hd * cfg.hd * 4
        elif k == "cross":
            kv_read += B * (cfg.n_img_tokens or S) * kv_layer_bytes
        else:
            ctx = min(cfg.window, S) if (k == "local" or cfg.swa_all) and \
                cfg.window else S
            if cfg.family == "audio":
                ctx = min(448, S)
                kv_read += B * S * kv_layer_bytes  # cross-KV over enc frames
            kv_read += B * ctx * kv_layer_bytes
    return (wbytes + kv_read) / n_chips


def model_flops(cfg, shape, n_chips: int) -> float:
    """Per-rank MODEL_FLOPS: 6·N_active·D train, 2·N_active·D inference."""
    _, active = param_counts(cfg)
    if shape.kind == "train":
        if cfg.family == "audio":
            from repro_torch.configs.shapes import whisper_dec_len
            D = shape.global_batch * whisper_dec_len(shape.seq_len)
        else:
            D = shape.global_batch * shape.seq_len
        return 6.0 * active * D / n_chips
    if shape.kind == "prefill":
        D = shape.global_batch * shape.seq_len
        return 2.0 * active * D / n_chips
    # decode: one token per sequence
    return 2.0 * active * shape.global_batch / n_chips


def build(cell: dict, cfg, shape, n_chips: int,
          weight_bits: float = 16) -> Roofline:
    colls = cell.get("collectives", {})
    return Roofline(
        flops=cell.get("flops", 0.0),
        hbm_bytes=cell.get("bytes_accessed", 0.0),
        wire_bytes=sum(colls.values()),
        collectives=colls,
        model_flops=model_flops(cfg, shape, n_chips),
        hbm_bytes_model=analytic_hbm_bytes(cfg, shape, n_chips,
                                           weight_bits=weight_bits),
    )
