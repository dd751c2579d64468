"""The paper tables' shared harness, ported from `benchmarks/common.py`.

Every table runs at the JAX harness's REDUCED scale (its hidden sizes,
steps, batches and sequence lengths), while the 'size' columns are
computed at the paper's full dimensions (closed forms, exact).  The
corpora are JAX's stand-ins, byte for byte: order-2 Markov bytes
(`data.synth.markov_bytes`) with the paper's vocabulary sizes, and this
repository's own `src/` tree for "linux".  Relative claims (the
binary/ternary BN models near fp, BinaryConnect behind) carry over;
absolute BPC does not.

The runs are the same experiment as JAX's up to the random streams: the
initial weights come from `torch.Generator`s seeded as JAX's keys are
numbered, and the training noise from the port's step noise (a function of
the seed and the step, `train_step.step_noise`), so no row matches JAX's
bit for bit.  `seed` shifts every one of those seeds at once (0 is JAX's
numbering), which gives the spread a row is judged by.

Every entry point runs on the card unless the caller asks for the CPU
(`device="cpu"`); without a card it raises.
"""
from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.core import bnlstm as BL
from repro_torch.core.quantize import QuantSpec
from repro_torch.data.loader import to_device
from repro_torch.data.synth import markov_bytes
from repro_torch.data.text import ByteCorpus
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (make_rnn_eval, make_rnn_train_step,
                                          train_state_init)

REPO = Path(__file__).resolve().parents[3]
RESULTS = REPO / "results" / "torch_tables"
NOTES = ("reduced hidden",
         "synthetic corpus; absolute BPC not comparable to the paper's")
# the modes trained without BN on the cell state (the baselines' own form)
NO_CELL_NORM = ("binaryconnect", "twn", "dorefa3", "dorefa4")

_corpora: dict = {}


def corpus(name: str) -> ByteCorpus:
    """Matched-vocab stand-ins for the paper's corpora (JAX's, byte for
    byte)."""
    if name not in _corpora:
        if name == "linux":  # code corpus from this repo's own sources
            _corpora[name] = ByteCorpus.from_dir(REPO / "src",
                                                 limit_bytes=2_000_000)
        else:
            vocab, seed, n = {"ptb": (50, 0, 120_000),
                              "warpeace": (87, 1, 120_000),
                              "text8": (27, 2, 120_000),
                              "words": (255, 3, 200_000)}[name]
            data = np.asarray(markov_bytes(n, vocab=vocab, seed=seed)) % 256
            _corpora[name] = ByteCorpus.from_bytes(bytes(bytearray(data)))
    return _corpora[name]


def spec_for(mode: str) -> QuantSpec:
    if mode == "fp":
        return QuantSpec(mode="none")
    return QuantSpec(mode=mode, norm="batch")


def train_rnn(corpus_name: str, mode: str, *, hidden=128, steps=150,
              batch=16, seq=48, cell="lstm", lr=3e-3, seed=0,
              eval_batches=4, device=None) -> dict:
    """Train a reduced BN-LSTM/GRU with `mode` quantization; returns
    JAX's metrics (`val_bpc`, `train_curve_bpc`, `seconds`) and the trained
    `state` and `cfg`."""
    device = resolve_device(device)
    c = corpus(corpus_name)
    cfg = BL.RNNConfig(vocab=c.vocab, d_hidden=hidden, cell=cell,
                       quant=spec_for(mode),
                       cell_norm=mode not in NO_CELL_NORM)
    var = BL.rnn_lm_init(torch.Generator().manual_seed(seed), cfg,
                         device=device)
    opt = OptConfig(lr=lr)
    st = train_state_init(var["params"], opt, seed + 1, bn_state=var["state"])
    step = make_rnn_train_step(cfg, opt)
    t0 = time.perf_counter()
    curve = []
    for i in range(steps):
        st, m = step(st, to_device(c.batch("train", i, batch, seq), device))
        if i % max(steps // 10, 1) == 0:
            curve.append(round(float(m["bpc"]), 4))
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ev = make_rnn_eval(cfg)
    bpcs = [float(ev(st, to_device(c.batch("valid", i, batch, seq),
                                   device))["bpc"])
            for i in range(eval_batches)]
    return {"mode": mode, "corpus": corpus_name, "cell": cell,
            "val_bpc": round(float(np.mean(bpcs)), 4),
            "train_curve_bpc": curve, "steps": steps, "hidden": hidden,
            "seconds": round(dt, 1), "state": st, "cfg": cfg}


def rnn_size_kb(d_in: int, hidden: int, mode: str, layers: int = 1,
                layer2_in: Optional[int] = None) -> float:
    """Paper-style weight size (KByte = 1000 B) of the recurrent matrices."""
    bits = {"fp": 32, "binary": 1, "binaryconnect": 1, "ternary": 2,
            "twn": 2, "ttq": 2, "dorefa3": 3, "dorefa4": 4}[mode]
    n = d_in * 4 * hidden + hidden * 4 * hidden
    if layers == 2:
        n += (layer2_in or hidden) * 4 * hidden + hidden * 4 * hidden
    return round(n * bits / 8 / 1000, 1)


def card_line() -> Optional[str]:
    """`nvidia-smi`'s name and power limit of the card, or None where it
    cannot be read."""
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return got.stdout.strip().splitlines()[0] if got.returncode == 0 else None


def run_meta(device: torch.device, seed: int) -> dict:
    """Where and how a table ran: the device (and the card's name and
    power limit on the card), the torch version, the seed shift and JAX's
    notes."""
    return {"device": str(device),
            "card": card_line() if device.type == "cuda" else None,
            "torch": torch.__version__, "seed": seed, "notes": list(NOTES)}


def write(name: str, rows, *, device: torch.device, seed: int = 0,
          out: Optional[Path] = None, meta: Optional[dict] = None) -> dict:
    """`{"meta", "rows"}` into `out/<name>.json` (`RESULTS` by default)."""
    out = Path(out) if out is not None else RESULTS
    out.mkdir(parents=True, exist_ok=True)
    payload = {"meta": {**run_meta(device, seed), **(meta or {})},
               "rows": rows}
    (out / f"{name}.json").write_text(json.dumps(payload, indent=1,
                                                 default=str))
    return payload


def strip(rows):
    """Drop non-serializable training artifacts before writing."""
    return [{k: v for k, v in r.items() if k not in ("state", "cfg")}
            for r in rows]
