"""Training launcher for the paper's BN-LSTM, ported from the `run_rnn`
path of `repro/launch/train.py`: data -> prefetch -> train step ->
validation BPC -> checkpoint/restart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch rnn-paper --steps 300
  PYTHONPATH=src python -m repro_torch.launch.train --arch rnn-paper \\
      --reduced --device cpu --steps 20

Without --reduced the model runs at the config's full width (char-PTB:
H = 1000).  It runs on the card unless --device cpu is given.  Validation
BPC on a held-out split drives the paper's /4-on-plateau LR schedule; the
eval curve is journaled beside the checkpoints and replayed on restart, so
a resumed run derives the lr_scale the interrupted run was using.

Fault tolerance: SIGTERM or SIGINT => checkpoint + exit 43 (restart with
--resume auto); checkpoints are atomic; the data pipeline and the
quantization noise are functions of the step, so a restart is
sample-exact.  Checkpoint index == completed steps == the next step to run.

Not ported yet, and refused: --pipeline (train -> restart -> export ->
serve through the engine, with the engine slice), --compress-grads and
--mesh-model (mesh training, ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import RNN_ARCH_IDS, get_rnn_config, rnn_paper
from repro_torch.core import bnlstm as BL
from repro_torch.core.quantize import QuantSpec
from repro_torch.data.loader import Prefetcher, to_device
from repro_torch.data.synth import markov_bytes
from repro_torch.data.text import ByteCorpus
from repro_torch.kernels import dispatch
from repro_torch.train import checkpoint as CK
from repro_torch.train.fault_tolerance import (RESTART_EXIT_CODE,
                                               PreemptionHandler, StepTimer,
                                               StragglerMonitor)
from repro_torch.train.optimizer import OptConfig, PlateauLR
from repro_torch.train.train_step import (make_rnn_eval, make_rnn_train_step,
                                          train_state_init)

NOT_PORTED = {
    "pipeline": "--pipeline waits for the engine slice (ServeEngine, "
                "speculative decoding; ROADMAP 'Next')",
    "compress_grads": "--compress-grads waits for mesh training "
                      "(ROADMAP Queue 1 item 9)",
    "mesh_model": "--mesh-model waits for mesh training "
                  "(ROADMAP Queue 1 item 9)",
}


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=RNN_ARCH_IDS, default="rnn-paper")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--quant", default=None,
                    choices=("none", "binary", "ternary"),
                    help="override the config's weight quantization")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--opt", default=None, choices=("adamw", "sgd"),
                    help="optimizer (default: adamw)")
    ap.add_argument("--momentum", type=float, default=0.0,
                    help="SGD momentum (paper word-PTB uses plain SGD)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic' | path to a text file/dir")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="none", choices=("none", "auto"))
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--eval-every", type=int, default=50,
                    help="validation-BPC cadence; drives the plateau LR")
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--plateau-factor", type=float, default=0.25,
                    help="LR multiplier on val rise (paper: /4); 0 disables")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu' for the plain "
                         "PyTorch versions of the kernels")
    ap.add_argument("--pipeline", action="store_true", help=NOT_PORTED["pipeline"])
    ap.add_argument("--compress-grads", action="store_true",
                    help=NOT_PORTED["compress_grads"])
    ap.add_argument("--mesh-model", type=int, default=1,
                    help=NOT_PORTED["mesh_model"])
    return ap


def rnn_corpus(args) -> ByteCorpus:
    """Byte corpus with train/valid/test splits.  'synthetic' generates the
    order-2 Markov stand-in matched to char-PTB's ~50-symbol vocab."""
    if args.data == "synthetic":
        data = np.asarray(markov_bytes(120_000, vocab=50, seed=args.seed))
        return ByteCorpus.from_bytes(bytes(bytearray(data % 256)))
    p = Path(args.data)
    return ByteCorpus.from_dir(p) if p.is_dir() else ByteCorpus.from_files([p])


def rnn_cfg(args, corpus: ByteCorpus) -> BL.RNNConfig:
    cfg = get_rnn_config(args.arch)
    if args.reduced:
        cfg = rnn_paper.reduced(cfg)
    if args.quant is not None:
        spec = (QuantSpec(mode=args.quant, norm="batch")
                if args.quant != "none" else QuantSpec(mode="none"))
        cfg = dataclasses.replace(cfg, quant=spec)
    # the corpus' dense byte vocab is the model's vocab
    return dataclasses.replace(cfg, vocab=corpus.vocab)


def opt_config(args) -> OptConfig:
    return OptConfig(kind=args.opt or "adamw", lr=args.lr,
                     momentum=args.momentum, clip_norm=1.0,
                     warmup_steps=args.warmup)


def _read_curve(path: Path) -> list:
    if not path.exists():
        return []
    return [json.loads(l) for l in path.read_text().splitlines() if l.strip()]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rnn(args, handler=None):
    """Train the paper's BN-LSTM char-LM; returns the final TrainState.
    `handler` replaces the SIGTERM/SIGINT `PreemptionHandler`."""
    device = dispatch.resolve_device(args.device)
    corpus = rnn_corpus(args)
    cfg = rnn_cfg(args, corpus)
    print(f"rnn-paper: cell={cfg.cell} hidden={cfg.d_hidden} "
          f"vocab={cfg.vocab} quant={cfg.quant.mode} "
          f"corpus={len(corpus.data)} tokens device={device}", flush=True)

    opt_cfg = opt_config(args)
    var = BL.rnn_lm_init(torch.Generator().manual_seed(args.seed), cfg,
                         device=device)
    state = train_state_init(var["params"], opt_cfg, args.seed + 1,
                             bn_state=var["state"])
    step_fn = make_rnn_train_step(cfg, opt_cfg)
    evaluate = make_rnn_eval(cfg)

    def val_bpc(st) -> float:
        bpcs = [float(evaluate(st, to_device(corpus.batch(
            "valid", i, args.batch, args.seq), device))["bpc"])
            for i in range(args.eval_batches)]
        return float(np.mean(bpcs))

    plateau = PlateauLR(factor=args.plateau_factor or 0.25)
    start_step = 0
    ckpt = None
    curve_path = None
    if args.ckpt_dir:
        ckpt = CK.AsyncCheckpointer(args.ckpt_dir)
        Path(args.ckpt_dir).mkdir(parents=True, exist_ok=True)
        curve_path = Path(args.ckpt_dir) / "val_curve.jsonl"
        if args.resume == "auto" and CK.latest_step(args.ckpt_dir) is not None:
            start_step = CK.latest_step(args.ckpt_dir)
            state = CK.restore(state, args.ckpt_dir, start_step)
            # evals past the checkpoint (eval ran, save didn't) are dropped
            # so the resumed run re-derives them identically
            curve = [e for e in _read_curve(curve_path)
                     if e["step"] <= start_step]
            curve_path.write_text(
                "".join(json.dumps(e) + "\n" for e in curve))
            scale0 = plateau.replay([e["val_bpc"] for e in curve])
            print(f"resumed from step {start_step} "
                  f"(lr_scale {scale0} from {len(curve)} journaled evals)",
                  flush=True)

    own_handler = handler is None
    handler = handler or PreemptionHandler()
    monitor = StragglerMonitor(n_hosts=1)
    prefetch = Prefetcher(
        lambda s: corpus.batch("train", s, args.batch, args.seq),
        start_step, device)
    scale = plateau.scale
    t_start = time.time()
    try:
        for step, batch in prefetch:
            if step >= args.steps:
                break
            with StepTimer() as tm:
                state, metrics = step_fn(state, batch, scale)
                _sync(device)
            monitor.record(0, tm.dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:6d} loss {float(metrics['loss']):.4f} "
                      f"bpc {float(metrics['bpc']):.3f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"{tm.dt*1e3:.0f} ms", flush=True)
            done = step + 1
            if args.plateau_factor and (done % args.eval_every == 0
                                        or done == args.steps):
                v = val_bpc(state)
                scale = plateau.update(v)
                print(f"eval  step {done:6d} val_bpc {v:.4f} "
                      f"lr_scale {scale}", flush=True)
                if curve_path is not None:
                    with curve_path.open("a") as f:
                        f.write(json.dumps({"step": done, "val_bpc": v})
                                + "\n")
            if ckpt and done % args.ckpt_every == 0 and done < args.steps:
                ckpt.save_async(state, done)
            if handler.preempted:
                print("preempted: checkpointing and exiting 43", flush=True)
                if ckpt:
                    ckpt.wait()
                    CK.save(state, args.ckpt_dir, done)
                sys.exit(RESTART_EXIT_CODE)
    finally:
        prefetch.close()
        if own_handler:
            handler.restore()
    if ckpt:
        ckpt.wait()
        CK.save(state, args.ckpt_dir, args.steps)
    dt = time.time() - t_start
    print(f"done: {args.steps - start_step} steps in {dt:.1f}s "
          f"({(args.steps - start_step) / max(dt, 1e-9):.2f} steps/s)")
    return state


def main(argv=None, handler=None):
    args = build_argparser().parse_args(argv)
    asked = {"pipeline": args.pipeline, "compress_grads": args.compress_grads,
             "mesh_model": args.mesh_model != 1}
    for flag, on in asked.items():
        if on:
            raise SystemExit(f"not ported yet: {NOT_PORTED[flag]}")
    return run_rnn(args, handler)


if __name__ == "__main__":
    main()
