"""Training launcher for the paper's BN-LSTM and the transformer pool,
ported from `repro/launch/train.py` (its `run_rnn` and `run_transformer`
paths): data -> prefetch -> train step -> (validation BPC) ->
checkpoint/restart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch rnn-paper --steps 300
  PYTHONPATH=src python -m repro_torch.launch.train --arch rnn-paper \\
      --reduced --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --device cpu --steps 12
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --batch 8 --seq 512 --steps 20

A transformer arch (`run_transformer`) trains on the synthetic
`token_stream` or a `ByteCorpus` (--data PATH) with AdamW under a
warmup/cosine schedule over --steps and gradient clipping at 1.0, the
paper's stochastic binary/ternary quantization with straight-through
gradients (--quant overrides the config's, with channel scales), and the
master clip after each update; it logs JAX's line (`step N loss L lr R
gnorm G T ms`).  The vlm and audio families read image or audio inputs
that the token stream does not carry, and are refused here; their train
step takes a batch with them (`train_step.make_train_step`).

Without --reduced the model runs at the config's full width (char-PTB:
H = 1000).  It runs on the card unless --device cpu is given.  Validation
BPC on a held-out split drives the paper's /4-on-plateau LR schedule; the
eval curve is journaled beside the checkpoints and replayed on restart, so
a resumed run derives the lr_scale the interrupted run was using.

Fault tolerance: SIGTERM or SIGINT => checkpoint + exit 43 (restart with
--resume auto); checkpoints are atomic; the data pipeline and the
quantization noise are functions of the step, so a restart is
sample-exact.  Checkpoint index == completed steps == the next step to run.

--pipeline closes the paper's loop in one command (`run_rnn_pipeline`):
leg A trains in a child process `python -m repro_torch.launch.train`,
takes a real SIGTERM from this parent at a logged step, exits 43 and
resumes with --resume auto; leg B trains the same run uninterrupted; the
two final checkpoints must be bit-equal, leaf for leaf; the trained
masters are exported packed with frozen BN and served through the
`ServeEngine`, every stream byte-equal to `drive_session(B=1)`; and the
fp masters with their ternary draft measure the trained accept rate.
The children train on the parent's --device.  Results go to
`<--results-dir>/torch_train_rnn.json` (by default
`results/benchmarks/`, beside the JAX package's `train_rnn.json`, which
it never writes).  --quick: at most 60 steps, evals every 20.

  PYTHONPATH=src python -m repro_torch.launch.train --pipeline --quick \\
      --reduced --device cpu

Data parallelism runs one process a device (`launch/mesh.py`): under
`torchrun` (`python -m torch.distributed.run --nproc-per-node N -m
repro_torch.launch.train ...`) each rank trains on `cuda:LOCAL_RANK` (NCCL)
or the CPU (gloo), rank 0 logs and writes the checkpoints, and a SIGTERM
on any rank checkpoints and exits 43 on all.  --compress-grads ternarizes
each replica's gradient with error feedback before the data-parallel mean
(`train/compress.py`); the state then carries the residual.  As in JAX,
the rnn-paper run builds a data mesh over every rank for it, one rank
included (a group of one rank on a free local port), and trains its
uncompressed steps on the whole batch on each rank; a transformer arch
builds its mesh from `train/elastic.best_mesh_shape(world, --mesh-model,
--batch)` when there is more than one rank (JAX's `mesh: ...` banner;
ranks the plan drops leave), and at one rank trains the plain step with a
zero residual.  A plan with a model axis above 1 (--mesh-model) trains
the pool tensor-parallel: the state is DTensors in JAX's layouts
(`launch/sharding.py`), rank 0 writes whole tensors in JAX's checkpoint
layout; with --compress-grads the model ranks hold whole parameters and
the mean runs over the data axes, as JAX's shard_map step.  The RNN stays
data-only, as JAX's.  --pipeline is rnn-only, as in JAX, and passes
--compress-grads to its legs.

  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --device cpu --compress-grads --steps 4
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --device cpu --mesh-model 2 --steps 3 --batch 4 --seq 32
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, RNN_ARCH_IDS, get_config,
                                  get_rnn_config, rnn_paper)
from repro_torch.core import bnlstm as BL
from repro_torch.core.quantize import QuantSpec
from repro_torch.data.loader import Prefetcher, to_device
from repro_torch.data.synth import markov_bytes, token_stream
from repro_torch.data.text import ByteCorpus
from repro_torch.kernels import dispatch
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as CK
from repro_torch.train import compress as C
from repro_torch.train.elastic import best_mesh_shape, make_mesh_from_plan
from repro_torch.train.fault_tolerance import (RESTART_EXIT_CODE,
                                               PreemptionHandler, StepTimer,
                                               StragglerMonitor)
from repro_torch.train.optimizer import OptConfig, PlateauLR
from repro_torch.train.train_step import (make_rnn_eval, make_rnn_train_step,
                                          make_train_step, train_state_init)

SRC = Path(__file__).resolve().parents[2]
RESULTS = SRC.parent / "results" / "benchmarks"
RESULT_NAME = "torch_train_rnn.json"  # never JAX's train_rnn.json


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + RNN_ARCH_IDS,
                    default="rnn-paper")
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
    ap.add_argument("--pipeline", action="store_true",
                    help="train -> SIGTERM restart -> export -> serve, "
                         "asserted end to end (run_rnn_pipeline)")
    ap.add_argument("--quick", action="store_true",
                    help="CI scale for --pipeline (at most 60 steps)")
    ap.add_argument("--results-dir", default=str(RESULTS),
                    help=f"where --pipeline writes {RESULT_NAME}")
    ap.add_argument("--compress-grads", action="store_true",
                    help="ternary gradient compression with error feedback "
                         "before the data-parallel mean")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="the model axis the mesh plan keeps: above 1 the "
                         "pool trains tensor-parallel over DTensors")
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


LAUNCH_LINE = "kernel launches "


def _print_launches() -> None:
    """The run's kernel launches as a last log line: a parent (the
    pipeline) sums its children's from it."""
    print(LAUNCH_LINE + json.dumps(dict(sorted(dispatch.LAUNCHES.items()))),
          flush=True)


def _comp_line(params, replicas: int) -> None:
    full, packed = C.compressed_bytes(params)
    print(f"grad compression: {replicas} data replica(s); the mean moves "
          f"{full / 1e6:.2f} MB of fp32 a step, {packed / 1e6:.2f} MB as "
          f"2-bit codes ({full / packed:.1f}x)", flush=True)


def _preempted(handler, mesh) -> bool:
    """The preemption flag, agreed by every rank of the job's mesh."""
    return (handler.preempted if mesh is None
            else M.any_rank(handler.preempted, mesh))


def run_rnn(args, handler=None):
    """Train the paper's BN-LSTM char-LM; returns the final TrainState.
    `handler` replaces the SIGTERM/SIGINT `PreemptionHandler`."""
    device = M.local_device(args.device)
    corpus = rnn_corpus(args)
    cfg = rnn_cfg(args, corpus)
    print(f"rnn-paper: cell={cfg.cell} hidden={cfg.d_hidden} "
          f"vocab={cfg.vocab} quant={cfg.quant.mode} "
          f"corpus={len(corpus.data)} tokens device={device}", flush=True)

    # a data mesh over every rank: the compressed step's, and the job's
    # barrier; an uncompressed step keeps the whole batch on every rank
    made, job = False, None
    if args.compress_grads or M.world_size() > 1:
        made = M.init_group(device)
        job = M.make_host_mesh(device=device)
    mesh = job if args.compress_grads else None
    try:
        return _train_rnn(args, handler, device, corpus, cfg, job, mesh)
    finally:
        if made:
            dist.destroy_process_group()


def _train_rnn(args, handler, device, corpus, cfg, job, mesh):
    opt_cfg = opt_config(args)
    var = BL.rnn_lm_init(torch.Generator().manual_seed(args.seed), cfg,
                         device=device)
    state = train_state_init(var["params"], opt_cfg, args.seed + 1,
                             bn_state=var["state"],
                             compress=args.compress_grads)
    step_fn = make_rnn_train_step(cfg, opt_cfg, mesh=mesh,
                                  compress_grads=args.compress_grads)
    evaluate = make_rnn_eval(cfg)
    if mesh is not None:
        _comp_line(state.params, M.data_index(mesh)[1])

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
            if job is not None:  # every rank has read it
                M.barrier(job)
            if M.rank() == 0:
                curve_path.write_text(
                    "".join(json.dumps(e) + "\n" for e in curve))
            scale0 = plateau.replay([e["val_bpc"] for e in curve])
            print(f"resumed from step {start_step} "
                  f"(lr_scale {scale0} from {len(curve)} journaled evals)",
                  flush=True)

    own_handler = handler is None
    handler = handler or PreemptionHandler()
    monitor = StragglerMonitor(n_hosts=M.world_size())
    prefetch = Prefetcher(
        lambda s: corpus.batch("train", s, args.batch, args.seq),
        start_step, device, mesh=mesh)
    scale = plateau.scale
    t_start = time.time()
    try:
        for step, batch in prefetch:
            if step >= args.steps:
                break
            with StepTimer() as tm:
                state, metrics = step_fn(state, batch, scale)
                _sync(device)
            monitor.record(M.rank(), tm.dt)
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
                if curve_path is not None and M.rank() == 0:
                    with curve_path.open("a") as f:
                        f.write(json.dumps({"step": done, "val_bpc": v})
                                + "\n")
            if ckpt and done % args.ckpt_every == 0 and done < args.steps:
                ckpt.save_async(state, done)
            if _preempted(handler, job):
                print("preempted: checkpointing and exiting 43", flush=True)
                if ckpt:
                    ckpt.wait()
                    CK.save(state, args.ckpt_dir, done, mesh=job)
                _print_launches()
                sys.exit(RESTART_EXIT_CODE)
    finally:
        prefetch.close()
        if own_handler:
            handler.restore()
    if ckpt:
        ckpt.wait()
        CK.save(state, args.ckpt_dir, args.steps, mesh=job)
    dt = time.time() - t_start
    print(f"done: {args.steps - start_step} steps in {dt:.1f}s "
          f"({(args.steps - start_step) / max(dt, 1e-9):.2f} steps/s)")
    _print_launches()
    return state


# ---------------------------------------------------------------------------
# the transformer pool
# ---------------------------------------------------------------------------


def train_mesh(args, world: int, device: torch.device):
    """The transformer launcher's mesh, elastic as JAX's: none on one rank;
    on several, `best_mesh_shape(world, --mesh-model, --batch)` with JAX's
    banner, its model axis included; None on a rank the plan drops, which
    says so."""
    plan = best_mesh_shape(world, want_model=args.mesh_model,
                           global_batch=args.batch)
    print(f"mesh: {dict(zip(plan.axes, plan.shape))}, per-replica batch "
          f"{plan.per_replica_batch}, dropped {plan.dropped_devices} devices",
          flush=True)
    replicas = math.prod(plan.shape[:-1])
    if args.batch % replicas:
        raise SystemExit(f"--batch {args.batch} does not divide over "
                         f"{replicas} data replicas")
    mesh = make_mesh_from_plan(plan, device)
    if mesh is None:
        print(f"rank {M.rank()}: the plan uses the first {replicas} of "
              f"{world} ranks; this one leaves", file=sys.stderr, flush=True)
    return mesh


def run_transformer(args, handler=None):
    """Train a transformer-pool arch on tokens (--reduced to its smoke
    size, --quant overriding its quantization, with channel scales);
    returns the final TrainState (None on a rank the mesh plan drops).
    `handler` replaces the SIGTERM/SIGINT `PreemptionHandler`."""
    device = M.local_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.quant is not None:
        cfg = cfg.with_quant(QuantSpec(mode=args.quant, norm="channel")
                             if args.quant != "none"
                             else QuantSpec(mode="none"))
    if cfg.family in ("vlm", "audio"):
        extra = "img" if cfg.family == "vlm" else "enc_frames"
        raise SystemExit(f"--arch {args.arch}: the {cfg.family} family "
                         f"reads {extra} beside its tokens, which the token "
                         f"stream does not carry; train it through "
                         f"train_step.make_train_step with a batch that "
                         f"holds them")
    made, mesh = False, None
    world = M.world_size()
    try:
        if world > 1:
            made = M.init_group(device)
            mesh = train_mesh(args, world, device)
            if mesh is None:
                return None
        return _train_transformer(args, handler, device, cfg, mesh)
    finally:
        if made:
            dist.destroy_process_group()


def _train_transformer(args, handler, device, cfg, mesh):
    if args.data == "synthetic":
        make_batch = lambda s: token_stream(s, args.batch, args.seq,
                                            cfg.vocab, seed=args.seed)
    else:
        p = Path(args.data)
        corpus = (ByteCorpus.from_dir(p) if p.is_dir()
                  else ByteCorpus.from_files([p]))
        if corpus.vocab > cfg.vocab:
            raise SystemExit(f"corpus vocab {corpus.vocab} > model "
                             f"{cfg.vocab}")
        make_batch = lambda s: corpus.batch("train", s, args.batch, args.seq)
    print(f"{cfg.name}: {cfg.family} family, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab}, quant={cfg.quant.mode}, "
          f"{cfg.dtype}, remat={cfg.remat} device={device}", flush=True)

    opt_cfg = OptConfig(kind=args.opt or "adamw", lr=args.lr,
                        momentum=args.momentum, warmup_steps=args.warmup,
                        decay_steps=args.steps, clip_norm=1.0)
    params = T.model_init(torch.Generator(device).manual_seed(args.seed),
                          cfg)
    state = train_state_init(params, opt_cfg, args.seed + 1,
                             compress=args.compress_grads)
    step_fn = make_train_step(cfg, opt_cfg, mesh=mesh,
                              compress_grads=args.compress_grads)
    if mesh is not None and args.compress_grads:
        _comp_line(state.params, M.data_index(mesh)[1])

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CK.AsyncCheckpointer(args.ckpt_dir)
        if args.resume == "auto" and CK.latest_step(args.ckpt_dir) is not None:
            start_step = CK.latest_step(args.ckpt_dir)
            state = CK.restore(state, args.ckpt_dir, start_step)
            print(f"resumed from step {start_step}", flush=True)

    own_handler = handler is None
    handler = handler or PreemptionHandler()
    monitor = StragglerMonitor(n_hosts=M.world_size())
    prefetch = Prefetcher(make_batch, start_step, device, mesh=mesh)
    t_start = time.time()
    try:
        for step, batch in prefetch:
            if step >= args.steps:
                break
            with StepTimer() as tm:
                state, metrics = step_fn(state, batch)
                _sync(device)
            monitor.record(M.rank(), tm.dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:6d} loss {float(metrics['loss']):.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"{tm.dt*1e3:.0f} ms", flush=True)
            done = step + 1
            if ckpt and done % args.ckpt_every == 0 and done < args.steps:
                ckpt.save_async(state, done)
            if _preempted(handler, mesh):
                print("preempted: checkpointing and exiting 43", flush=True)
                if ckpt:
                    ckpt.wait()
                    CK.save(state, args.ckpt_dir, done, mesh=mesh)
                _print_launches()
                sys.exit(RESTART_EXIT_CODE)
    finally:
        prefetch.close()
        if own_handler:
            handler.restore()
    if ckpt:
        ckpt.wait()
        CK.save(state, args.ckpt_dir, args.steps, mesh=mesh)
    dt = time.time() - t_start
    print(f"done: {args.steps - start_step} steps in {dt:.1f}s "
          f"({(args.steps - start_step) / max(dt, 1e-9):.2f} steps/s)")
    _print_launches()
    return state


# ---------------------------------------------------------------------------
# the one-command pipeline: train -> SIGTERM/restart -> export -> serve
# ---------------------------------------------------------------------------


def _child_cmd(args, ckpt_dir: Path) -> list:
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", args.arch, "--steps", str(args.steps),
           "--batch", str(args.batch), "--seq", str(args.seq),
           "--lr", str(args.lr), "--warmup", str(args.warmup),
           "--momentum", str(args.momentum), "--seed", str(args.seed),
           "--data", args.data, "--ckpt-dir", str(ckpt_dir),
           "--ckpt-every", str(args.ckpt_every), "--resume", "auto",
           "--log-every", str(args.log_every),
           "--eval-every", str(args.eval_every),
           "--eval-batches", str(args.eval_batches),
           "--plateau-factor", str(args.plateau_factor)]
    if args.reduced:
        cmd.append("--reduced")
    if args.quant is not None:
        cmd += ["--quant", args.quant]
    if args.opt is not None:
        cmd += ["--opt", args.opt]
    if args.device is not None:
        cmd += ["--device", args.device]
    if args.compress_grads:
        cmd.append("--compress-grads")
    return cmd


def _run_leg(cmd: list, tag: str, kill_at_step: int | None = None,
             lines: list | None = None) -> dict:
    """Run one training leg as a child process (this package first on its
    path); with kill_at_step, send it a real SIGTERM once it logs that
    step, and expect exit 43.  Returns the child's kernel launches; its
    output lines are appended to `lines` when one is given."""
    env = os.environ.copy()
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    killed = False
    launches = {}
    pat = (re.compile(rf"^step\s+{kill_at_step}\b")
           if kill_at_step is not None else None)
    try:
        for line in proc.stdout:
            print(f"  [{tag}] {line}", end="", flush=True)
            if lines is not None:
                lines.append(line)
            if line.startswith(LAUNCH_LINE):
                launches = json.loads(line[len(LAUNCH_LINE):])
            if pat is not None and not killed and pat.match(line.strip()):
                proc.send_signal(signal.SIGTERM)
                killed = True
        rc = proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    want = RESTART_EXIT_CODE if kill_at_step is not None else 0
    if kill_at_step is not None and not killed:
        raise SystemExit(f"pipeline: never saw 'step {kill_at_step}' in "
                         f"{tag} output")
    if rc != want:
        raise SystemExit(f"pipeline: {tag} exited {rc}, expected {want}")
    return launches


def _ckpt_bit_equal(a: Path, b: Path) -> bool:
    """Leaf-for-leaf bitwise comparison of two step_<n> checkpoints."""
    ma = json.loads((a / "manifest.json").read_text())
    mb = json.loads((b / "manifest.json").read_text())
    if sorted(ma["leaves"]) != sorted(mb["leaves"]):
        return False
    for key in ma["leaves"]:
        xa = np.load(a / CK.SHARD / f"{key}.npy")
        xb = np.load(b / CK.SHARD / f"{key}.npy")
        if xa.dtype != xb.dtype or xa.shape != xb.shape:
            return False
        if xa.tobytes() != xb.tobytes():
            return False
    return True


def run_rnn_pipeline(args) -> list:
    """train -> checkpoint -> SIGTERM restart -> export -> serve, asserted
    (see the module docstring).  Returns the result rows."""
    from repro_torch.core.qtensor import tree_leaves, tree_nbytes
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.recurrent import (RNNRuntime, drive_session,
                                             speculative_draft)

    if args.quick:
        args.steps = min(args.steps, 60)
        args.eval_every = min(args.eval_every, 20)
        args.ckpt_every = min(args.ckpt_every, 10)
    args.log_every = min(args.log_every, 10)
    kill_at = max((args.steps // 2) // args.log_every, 1) * args.log_every
    device = dispatch.resolve_device(args.device)

    made_tmp = args.ckpt_dir is None
    base = Path(args.ckpt_dir) if args.ckpt_dir else Path(
        tempfile.mkdtemp(prefix="rnn_pipeline_"))
    dir_a, dir_b = base / "interrupted", base / "straight"
    rows = []
    try:
        # -- leg A: train, SIGTERM at kill_at, restart, finish -------------
        print(f"pipeline: leg A trains {args.steps} steps with SIGTERM at "
              f"step {kill_at}, then resumes", flush=True)
        cmd_a = _child_cmd(args, dir_a)
        t0 = time.time()
        legs = [_run_leg(cmd_a, "train-A", kill_at_step=kill_at)]
        resumed_from = CK.latest_step(dir_a)
        legs.append(_run_leg(cmd_a, "train-A-resume"))
        # -- leg B: the uninterrupted reference ----------------------------
        print("pipeline: leg B trains the same run uninterrupted", flush=True)
        legs.append(_run_leg(_child_cmd(args, dir_b), "train-B"))
        train_s = time.time() - t0
        child_launches = dict(sum(map(Counter, legs), Counter()))

        final = f"step_{args.steps:08d}"
        exact = _ckpt_bit_equal(dir_a / final, dir_b / final)
        curve = _read_curve(dir_b / "val_curve.jsonl")
        print(f"pipeline: resume bit-exact vs uninterrupted: {exact} "
              f"(restarted from step {resumed_from})", flush=True)
        if not exact:
            raise SystemExit("pipeline: resumed run diverged from the "
                             "uninterrupted reference")
        rows.append({
            "phase": "train+restart", "steps": args.steps,
            "sigterm_at_step": kill_at, "resumed_from_step": resumed_from,
            "restart_exit_code": RESTART_EXIT_CODE,
            "resume_bit_exact": exact,
            "val_bpc_curve": [{"step": e["step"], "val_bpc": e["val_bpc"]}
                              for e in curve],
            "final_val_bpc": curve[-1]["val_bpc"] if curve else None,
            "train_wall_s": train_s,
            "child_launches": child_launches,
        })

        # -- export the trained masters and serve them ---------------------
        corpus = rnn_corpus(args)
        cfg = rnn_cfg(args, corpus)
        opt_cfg = opt_config(args)
        var = BL.rnn_lm_init(torch.Generator().manual_seed(args.seed), cfg,
                             device=device)
        template = train_state_init(var["params"], opt_cfg, args.seed + 1,
                                    bn_state=var["state"],
                                    compress=args.compress_grads)
        trained = CK.restore(template, dir_b, args.steps)
        if trained.residual is not None:  # NaN or inf if any element is
            rows[0]["residual_abs_sum"] = float(sum(
                x.abs().sum() for x in tree_leaves(trained.residual)))

        mode = cfg.quant.mode if cfg.quant.mode != "none" else "ternary"
        qvar = BL.serving_variables(trained.params, trained.bn_state, cfg)
        fp_b, packed_b = tree_nbytes(qvar["params"])
        rt_packed = RNNRuntime(cfg, qvar, device=device)
        print(f"pipeline: exported packed {mode} weights "
              f"({fp_b/1e6:.2f} MB fp32 -> {packed_b/1e6:.2f} MB, "
              f"{fp_b/max(packed_b, 1):.1f}x), BN statistics frozen",
              flush=True)

        # byte parity: the engine's streams against drive_session(B=1)
        rng = np.random.default_rng(7)
        reqs = [Request(prompt=rng.integers(0, cfg.vocab,
                                            size=int(rng.integers(2, 10))),
                        max_tokens=int(rng.integers(2, 9)),
                        temperature=0.8, top_k=5, seed=100 + i, rid=i)
                for i in range(5)]
        eng = ServeEngine(rt_packed, cfg.vocab, slots=2, max_context=64,
                          prefill_chunk=4)
        comps, _ = eng.run([dataclasses.replace(r) for r in reqs],
                           realtime=False)
        by_rid = {c.rid: c for c in comps}
        for r in reqs:
            out, _ = drive_session(
                rt_packed, torch.as_tensor(np.asarray(r.prompt, np.int64))[None],
                cfg.vocab, gen=r.max_tokens, temperature=r.temperature,
                top_k=r.top_k, seed=r.seed)
            if by_rid[r.rid].tokens != out[0].tolist():
                raise SystemExit(f"pipeline: engine stream for request "
                                 f"{r.rid} diverged from drive_session(B=1)")
        print(f"pipeline: ServeEngine byte parity vs drive_session(B=1) over "
              f"{len(reqs)} requests", flush=True)
        rows.append({"phase": "export+serve", "quant": mode,
                     "fp32_mb": fp_b / 1e6, "packed_mb": packed_b / 1e6,
                     "engine_byte_parity": True,
                     "parity_requests": len(reqs)})

        # trained-master speculation: fp target, packed draft, greedy
        fp_cfg = dataclasses.replace(cfg, quant=QuantSpec(mode="none"))
        rt_fp = RNNRuntime(fp_cfg, {"params": trained.params,
                                    "state": trained.bn_state},
                           device=device)
        draft = speculative_draft(rt_fp, mode=mode)
        prompt_len, gen, spec_k = 6, 32 if args.quick else 48, 4
        greedy = [Request(prompt=rng.integers(0, cfg.vocab, size=prompt_len),
                          max_tokens=gen, temperature=0.0, top_k=0,
                          seed=500 + i, rid=i) for i in range(4)]
        ctx = prompt_len + gen
        plain = ServeEngine(rt_fp, cfg.vocab, slots=1, max_context=ctx,
                            prefill_chunk=8)
        spec = ServeEngine(rt_fp, cfg.vocab, slots=1, max_context=ctx,
                           prefill_chunk=8, draft=draft, spec_k=spec_k)
        plain.warm()
        spec.warm()
        pc, mp = plain.run([dataclasses.replace(r) for r in greedy],
                           realtime=False)
        sc, ms = spec.run([dataclasses.replace(r) for r in greedy],
                          realtime=False)
        pby = {c.rid: c.tokens for c in pc}
        if any(c.tokens != pby[c.rid] for c in sc):
            raise SystemExit("pipeline: speculative greedy streams differ "
                             "from plain greedy")
        print(f"pipeline: trained-master speculation k={spec_k} accept rate "
              f"{ms['accept_rate']:.3f}, {ms['agg_tok_s']:.0f} tok/s spec vs "
              f"{mp['agg_tok_s']:.0f} plain", flush=True)
        if not args.quick and ms["accept_rate"] <= 0.6:
            raise SystemExit(f"pipeline: trained accept rate "
                             f"{ms['accept_rate']:.3f} <= 0.6")
        rows.append({"phase": "speculation", "spec_k": spec_k,
                     "accept_rate": ms["accept_rate"],
                     "drafted_tokens": ms["drafted_tokens"],
                     "greedy_equal_plain": True,
                     "plain_tok_s": mp["agg_tok_s"],
                     "spec_tok_s": ms["agg_tok_s"],
                     "asserted": not args.quick})
    finally:
        if made_tmp:
            shutil.rmtree(base, ignore_errors=True)

    results = Path(args.results_dir)
    results.mkdir(parents=True, exist_ok=True)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    payload = {"meta": {"arch": args.arch, "reduced": args.reduced,
                        "hidden": cfg.d_hidden, "vocab": cfg.vocab,
                        "cell": cfg.cell, "quant": cfg.quant.mode,
                        "corpus": args.data, "steps": args.steps,
                        "batch": args.batch, "seq": args.seq,
                        "opt": opt_cfg.kind, "lr": args.lr,
                        "quick": args.quick, "device": kind,
                        "note": "synthetic corpus: relative claims only; "
                                "absolute BPC is not comparable to the "
                                "paper's tables"},
               "rows": rows}
    out = results / RESULT_NAME
    out.write_text(json.dumps(payload, indent=1))
    print(f"pipeline: wrote {out}", flush=True)
    return rows


def main(argv=None, handler=None):
    args = build_argparser().parse_args(argv)
    if args.pipeline:
        if args.arch not in RNN_ARCH_IDS:
            raise SystemExit("--pipeline is the rnn-paper train->serve "
                             "proof; run it with --arch rnn-paper")
        return run_rnn_pipeline(args)
    run = run_rnn if args.arch in RNN_ARCH_IDS else run_transformer
    if M.rank() == 0:  # rank 0 logs for the job: its ranks hold one state
        return run(args, handler)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        return run(args, handler)


if __name__ == "__main__":
    main()
