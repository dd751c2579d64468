"""Packed serving for the paper's BN-LSTM on the PyTorch port: train ->
export -> decode 2-bit.

  PYTHONPATH=src python examples/torch_serve_lstm.py               # the card
  PYTHONPATH=src python examples/torch_serve_lstm.py --device cpu
  PYTHONPATH=src python examples/torch_serve_lstm.py --mode binary --steps 60

The train->deploy handoff the paper is about, on its own model:

1. train a small BN-LSTM with stochastic ternary (or binary) recurrent
   weights for a few steps on a synthetic byte corpus,
2. `export_packed_rnn` the masters into packed `QTensor`s — 2-bit/1-bit
   codes, the artifact a deployment ships,
3. generate text STATEFULLY through the recurrent runtime
   (serve/recurrent.py): one `prefill` over the prompt, then one
   `decode_step` per token — on the card the WHOLE tick (every layer's
   accumulation-only GEMV + BN affine + gates, plus the logits head) is
   one launch of the fused kernel (`csrc/fused_tick.cu`); on the CPU the
   same packed artifact serves through the kernels' plain versions — with
   O(1) state instead of re-running the whole sequence,
4. verify the stepwise decode matches the full-sequence `rnn_lm_apply`
   against the same packed tree.

The counterpart of `examples/serve_lstm.py`, line for line.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import bnlstm as BL
from repro_torch.core.qtensor import is_qtensor, tree_leaves, tree_nbytes
from repro_torch.core.quantize import QuantSpec
from repro_torch.data.synth import markov_bytes
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.serve.recurrent import RNNRuntime, state_nbytes
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import make_rnn_train_step, train_state_init


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="ternary", choices=("ternary", "binary"))
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--device", default=None,
                    help="the card unless given (cpu: the plain versions)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    data = np.asarray(markov_bytes(200_000, vocab=64, seed=0))
    vocab = 64

    cfg = BL.RNNConfig(vocab=vocab, d_hidden=args.hidden,
                       quant=QuantSpec(mode=args.mode, norm="batch"))
    var = BL.rnn_lm_init(torch.Generator().manual_seed(0), cfg, device=device)
    state = train_state_init(var["params"], OptConfig(kind="adamw", lr=2e-3),
                             1, bn_state=var["state"])
    step = make_rnn_train_step(cfg, OptConfig(kind="adamw", lr=2e-3))
    ids = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                    device=device)

    # -- 1. train ------------------------------------------------------------
    rng = np.random.default_rng(0)
    for i in range(args.steps):
        starts = rng.integers(0, data.size - args.seq - 1, size=args.batch)
        toks = np.stack([data[s: s + args.seq + 1] for s in starts])
        batch = {"tokens": ids(toks[:, :-1]), "targets": ids(toks[:, 1:])}
        state, metrics = step(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  bpc {float(metrics['bpc']):.3f}")

    # -- 2. export: masters -> packed QTensors -------------------------------
    qparams = BL.export_packed_rnn(state.params, cfg)
    n_packed = sum(is_qtensor(l) for l in tree_leaves(qparams))
    fp, real = tree_nbytes(qparams)
    print(f"exported {n_packed} packed weights: fp32 {fp/1e3:.0f} KB -> "
          f"{args.mode} {real/1e3:.0f} KB ({fp/real:.1f}x smaller)")

    packed_vars = {"params": qparams, "state": state.bn_state}

    # -- 3. stateful decode against the packed tree ---------------------------
    # prefill once, then O(1)-state decode steps: each step is the fused
    # decode kernel, not a re-run of the growing sequence.
    rt = RNNRuntime(cfg, packed_vars, device=device)
    prompt = ids(data[: args.seq][None, :])
    st = rt.init_state(batch=1)
    logits, st = rt.prefill(prompt, st)
    print(f"session state: {state_nbytes(st) / 1e3:.1f} KB "
          f"(constant — no KV cache growth)")
    out = []
    for _ in range(args.gen):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(int(nxt[0]))
        logits, st = rt.decode_step(nxt, st)
    print(f"greedy continuation ids[:16]: {out[:16]}")

    # -- 4. parity: stepwise decode == full-sequence forward ------------------
    probe = ids(data[1000: 1000 + args.seq][None, :])
    with torch.no_grad():
        lg_full = BL.rnn_lm_apply(packed_vars, probe, cfg, training=False)
        lg_pre, st2 = BL.rnn_prefill(packed_vars, probe[:, :-1], cfg)
        lg_last, _ = BL.rnn_decode_step(packed_vars, probe[:, -1], cfg, st2)
    np.testing.assert_allclose(lg_pre.cpu().numpy(),
                               lg_full[:, :-1].cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lg_last.cpu().numpy(),
                               lg_full[:, -1].cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    print("stateful prefill/decode matches the full-sequence forward ✓")
    return out


if __name__ == "__main__":
    main()
