#!/usr/bin/env python3
"""Time the port's fused decode tick (`csrc/fused_tick.cu`) at the widths
of the paper's configurations, on one NVIDIA card.

    python3 time_tick.py [--src DIR] [--rows 4] [--out FILE]

For char-PTB (H = 1000, V = 50), word-PTB medium (H = 650, V = 10,000) and
word-PTB large (H = 1500, two layers, V = 10,000), all LSTM and ternary with
random weights from a seed, and B = 4 and 16 with every row live: one tick's
device time (torch.profiler) and wall time (CUDA events), its plain
version's, the kernel's max abs error against it on h, c and logits, and
the bound that `chip_smoke.tick_bound` counts.
`--src` times the `repro_torch` package of another checkout's `src` (an
earlier commit's kernel, built into that checkout's own `build/`), so two
versions of the kernel can be compared within one run on one card.  `--rows
4` makes the wrapper take row passes of 4 at every batch (the kernel's
other instantiation at B = 16).  Prints one JSON line per tick and writes
them all to `--out`.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import chip_smoke as CS

CONFIGS = (("char_ptb", 1000, 50, 1), ("word_ptb_medium", 650, 10000, 1),
           ("word_ptb_large", 1500, 10000, 2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(CS.ROOT / "src"))
    ap.add_argument("--rows", type=int, choices=(4, 8), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_tick: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import bnlstm as BL
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.kernels import decode_step as DK
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import ops as OPS
    if args.rows is not None:
        DK.tick_rows = lambda bp: args.rows
    dispatch.strict_fp32()
    card = CS.card_line()
    dev = torch.device("cuda")
    out = []
    for name, hidden, vocab, layers in CONFIGS:
        cfg = BL.RNNConfig(vocab=vocab, d_hidden=hidden, n_layers=layers,
                           cell="lstm",
                           quant=QuantSpec(mode="ternary", norm="batch"))
        g = torch.Generator().manual_seed(0)
        v = CS.off_init(BL.rnn_lm_init(g, cfg, device=dev), g)
        qv = {"params": BL.export_packed_rnn(v["params"], cfg),
              "state": v["state"]}
        tick = BL.rnn_decode_tables(qv, cfg)[0]["tick"]
        for B in (4, 16):
            h = torch.tanh(torch.randn(layers, B, hidden, generator=g)).to(dev)
            c = torch.randn(layers, B, hidden, generator=g).to(dev)
            tok = torch.randint(0, vocab, (B,), generator=g).to(dev)
            targs = OPS.tick_operands(tok, h, c, tick, None)
            got = DK.fused_tick(*targs, cell="lstm", mode="ternary")
            want = DK.fused_tick_plain(*targs, cell="lstm", mode="ternary")
            err = [(got[i] - want[i]).abs().max().item() for i in range(3)]
            k = CS.time_call(
                lambda: DK.fused_tick(*targs, cell="lstm", mode="ternary"), 100)
            p = CS.time_call(lambda: DK.fused_tick_plain(
                *targs, cell="lstm", mode="ternary"), 10)
            b_ms, b_by = CS.tick_bound(cfg, qv, B)
            row = dict(card=card, src=args.src, config=name, B=B,
                       bp=targs[0].shape[0], hp=targs[4].shape[-1],
                       vp=targs[12].shape[1], rows=args.rows,
                       err_h_c_logits=err, ms=k["ms"], wall_ms=k["wall_ms"],
                       plain_ms=p["ms"], plain_wall_ms=p["wall_ms"],
                       bound_ms=b_ms, bound_by=b_by)
            print(json.dumps(row), flush=True)
            out.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
