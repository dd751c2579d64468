"""Serving launcher for the paper's BN-LSTM: prefill a prompt batch, decode
with sampling, in lockstep.  Ported from the `--arch rnn-paper` path of
`repro/launch/serve.py`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rnn-paper --full
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --gen 8

With --quant binary|ternary the master tree is exported once into packed
QTensors and every decode tick is one launch of the fused CUDA kernel;
prefill streams the packed codes through the GEMV (batch <= 8) or GEMM
kernel per timestep.  The weights are random, drawn from --seed.  The
continuous-batching engine (--traffic, --listen, --spec-k, --mesh) is not
ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import RNN_ARCH_IDS, get_rnn_config, rnn_paper
from repro_torch.core import bnlstm as BL
from repro_torch.core.quantize import QuantSpec
from repro_torch.serve.recurrent import RNNRuntime, drive_session


def build_rnn(args):
    """The paper's BN-LSTM, exported and behind the serving runtime."""
    cfg = get_rnn_config(args.arch)
    if args.reduced:
        cfg = rnn_paper.reduced(cfg)
    spec = (QuantSpec(mode=args.quant, norm="batch")
            if args.quant != "none" else QuantSpec(mode="none"))
    cfg = dataclasses.replace(cfg, quant=spec)
    gen = torch.Generator().manual_seed(args.seed)
    var = BL.rnn_lm_init(gen, cfg, device=args.device)
    params = var["params"]
    if args.quant != "none":
        params = BL.export_packed_rnn(params, cfg)
    rt = RNNRuntime(cfg, {"params": params, "state": var["state"]},
                    device=args.device)
    if args.quant != "none":
        fp, packed = rt.param_nbytes()
        print(f"model bytes: fp32 {fp/1e6:.1f} MB -> packed({args.quant}) "
              f"{packed/1e6:.1f} MB ({fp/packed:.1f}x smaller)")
    return cfg, rt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=RNN_ARCH_IDS, default="rnn-paper")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--quant", default="ternary",
                    choices=("none", "binary", "ternary"))
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu' for the plain "
                         "PyTorch versions of the kernels")
    args = ap.parse_args(argv)

    cfg, rt = build_rnn(args)
    B, S = args.batch, args.prompt_len
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    out, m = drive_session(rt, prompt, cfg.vocab, gen=args.gen,
                           temperature=args.temperature, top_k=args.top_k,
                           seed=args.seed + 1, warmup=True)
    print(f"session state: {m['state_nbytes']/1e6:.2f} MB "
          f"({rt.family} family, {rt.device})")
    print(f"prefill: {m['prefill_tok_s']:.0f} tok/s  "
          f"decode: {m['decode_tok_s']:.1f} tok/s")
    print(f"generated ids[0,:16]: {out[0, :16].tolist()}")
    return out


if __name__ == "__main__":
    main()
