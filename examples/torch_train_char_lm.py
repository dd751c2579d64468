"""End-to-end training on the PyTorch port: the PAPER's character-level
model (BN-LSTM with ternary recurrent weights, Appendix C hyperparameters
scaled down) for a few hundred steps on a real byte corpus (this
repository's source tree — the offline stand-in for Linux-Kernel), with
checkpointing and preemption handling.

  PYTHONPATH=src python examples/torch_train_char_lm.py          # the card
  PYTHONPATH=src python examples/torch_train_char_lm.py --device cpu
  PYTHONPATH=src python examples/torch_train_char_lm.py --hidden 1000 \
      --steps 400 --mode binary                                   # paper scale

Ctrl-C mid-run, then re-run with the same --ckpt-dir: training resumes
exactly (stateless step-indexed data + atomic checkpoints).  The
checkpoints are the JAX package's layout, so a run of
`examples/train_char_lm.py` resumes here (and back).  The counterpart of
`examples/train_char_lm.py`, line for line.
"""
import argparse
import sys
import time
from pathlib import Path

import torch

from repro_torch.core import bnlstm as BL
from repro_torch.core.quantize import QuantSpec
from repro_torch.data.loader import to_device
from repro_torch.data.text import ByteCorpus
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.train import checkpoint as CK
from repro_torch.train.fault_tolerance import (RESTART_EXIT_CODE,
                                               PreemptionHandler)
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (make_rnn_eval, make_rnn_train_step,
                                          train_state_init)

REPO = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="ternary",
                    choices=("ternary", "binary", "none", "binaryconnect"))
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=100)     # paper: 100
    ap.add_argument("--lr", type=float, default=2e-3)   # paper: 0.002, ADAM
    ap.add_argument("--data", default=str(REPO / "src"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="the card unless given (cpu: the plain versions)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    corpus = ByteCorpus.from_dir(Path(args.data))
    print(f"corpus: {corpus.data.size / 1e6:.1f}M chars, vocab {corpus.vocab}")

    quant = (QuantSpec(mode="none") if args.mode == "none"
             else QuantSpec(mode=args.mode, norm="batch"))
    cfg = BL.RNNConfig(vocab=corpus.vocab, d_hidden=args.hidden, quant=quant,
                       cell_norm=args.mode != "binaryconnect")
    var = BL.rnn_lm_init(torch.Generator().manual_seed(0), cfg, device=device)
    opt = OptConfig(kind="adamw", lr=args.lr)
    state = train_state_init(var["params"], opt, 1, bn_state=var["state"])
    step = make_rnn_train_step(cfg, opt)
    evaluate = make_rnn_eval(cfg)

    start = 0
    if args.ckpt_dir and CK.latest_step(args.ckpt_dir) is not None:
        start = CK.latest_step(args.ckpt_dir)
        state = CK.restore(state, args.ckpt_dir, start)
        print(f"resumed from step {start}")
    handler = PreemptionHandler()
    ckpt = CK.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None

    t0 = time.time()
    for i in range(start, args.steps):
        b = to_device(corpus.batch("train", i, args.batch, args.seq), device)
        state, m = step(state, b)
        if i % 20 == 0 or i == args.steps - 1:
            vb = to_device(corpus.batch("valid", 0, args.batch, args.seq),
                           device)
            val = evaluate(state, vb)
            print(f"step {i:4d}  train bpc {float(m['bpc']):.3f}  "
                  f"val bpc {float(val['bpc']):.3f}  "
                  f"({(i - start + 1) / (time.time() - t0):.2f} steps/s)",
                  flush=True)
        if ckpt and i and i % 50 == 0:
            ckpt.save_async(state, i)
        if handler.preempted:
            if ckpt:
                ckpt.wait()
                CK.save(state, args.ckpt_dir, i + 1)
            print("preempted — checkpointed, exit 43")
            sys.exit(RESTART_EXIT_CODE)
    if ckpt:
        ckpt.wait()
        CK.save(state, args.ckpt_dir, args.steps)

    # memory footprint at the paper's accounting (Table 1)
    n = corpus.vocab * 4 * args.hidden + args.hidden * 4 * args.hidden
    bits = {"ternary": 2, "binary": 1, "binaryconnect": 1, "none": 32}[args.mode]
    print(f"recurrent weights: fp32 {n * 4 / 1e3:.0f} KB -> "
          f"{args.mode} {n * bits / 8 / 1e3:.0f} KB")


if __name__ == "__main__":
    main()
