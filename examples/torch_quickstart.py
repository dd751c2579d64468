"""Quickstart on the PyTorch port: the paper's technique in five minutes.

  PYTHONPATH=src python examples/torch_quickstart.py                # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

1. Stochastically ternarize a weight matrix (Eq. 4-6) with straight-through
   gradients (Eq. 1).
2. Train a small BN-LSTM with ternary recurrent weights (Eq. 7 / Alg. 1) on a
   structured synthetic corpus, watching BPC fall.
3. Pack the trained weights to 2 bits and run the packed product
   (`kernels.ops.qmatmul`): on the card the hand-written kernels
   (`csrc/packed_gemv.cu` for a few rows, `csrc/packed_matmul.cu` for a
   prompt), on the CPU their plain versions.

The counterpart of `examples/quickstart.py`, line for line.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import bnlstm as BL
from repro_torch.core import quantize as Q
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quantize import QuantSpec
from repro_torch.data.loader import to_device
from repro_torch.data.synth import markov_bytes
from repro_torch.data.text import ByteCorpus
from repro_torch.kernels import ops
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import make_rnn_train_step, train_state_init

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="the card unless given (cpu: the plain versions)")
args = ap.parse_args()
device = resolve_device(args.device)

# --- 1. the quantizer --------------------------------------------------------
gen = torch.Generator().manual_seed(0)
w = (torch.randn((8, 8), generator=gen) * 0.05).to(device)
alpha = Q.glorot_alpha(8, 8)
u = torch.rand((8, 8), generator=gen).to(device)
q = Q.ternarize_stochastic(w, u, alpha)
print("master weights:\n", np.round(w[:2].cpu().numpy(), 3))
print("ternary sample (values in {-a, 0, +a}, a=%.4f):\n" % alpha,
      np.round(q[:2].cpu().numpy(), 4))

wg = w.clone().requires_grad_(True)
torch.sum(Q.quantize(wg, "ternary", alpha, u)).backward()
print("STE gradient is identity:", bool((wg.grad == 1.0).all()))

# --- 2. train a ternary BN-LSTM ----------------------------------------------
corpus = ByteCorpus.from_bytes(
    bytes(bytearray(np.asarray(markov_bytes(50_000, vocab=32, seed=0)) % 256)))
cfg = BL.RNNConfig(vocab=corpus.vocab, d_hidden=96,
                   quant=QuantSpec(mode="ternary", norm="batch"))
var = BL.rnn_lm_init(torch.Generator().manual_seed(0), cfg, device=device)
state = train_state_init(var["params"], OptConfig(lr=5e-3), 1,
                         bn_state=var["state"])
step = make_rnn_train_step(cfg, OptConfig(lr=5e-3))
for i in range(80):
    batch = to_device(corpus.batch("train", i, 16, 32), device)
    state, m = step(state, batch)
    if i % 20 == 0 or i == 79:
        print(f"step {i:3d}  bpc {float(m['bpc']):.3f}  "
              f"(uniform would be {np.log2(corpus.vocab):.2f})")

# --- 3. pack + MAC-free-style matmul ------------------------------------------
wh = state.params["layers"][0]["wh"]          # trained master weights
a = Q.glorot_alpha(*wh.shape)
qt = QTensor.from_master(wh, "ternary", a)    # the serving artifact
x = torch.randn((4, wh.shape[0]), generator=torch.Generator().manual_seed(2)
                ).to(device)
y_packed = ops.qmatmul(x, qt)                 # the packed kernel
y_ref = x @ Q.ternarize_deterministic(wh, a)
print(f"packed weights: {qt.nbytes / 1e3:.1f} KB "
      f"(fp32 would be {wh.numel() * 4 / 1e3:.1f} KB — "
      f"{wh.numel() * 4 / qt.nbytes:.0f}x smaller)")
print("packed-kernel matmul max err vs reference:",
      float(torch.max(torch.abs(y_packed - y_ref))))
