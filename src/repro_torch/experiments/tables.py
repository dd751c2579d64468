"""One experiment per paper table and figure, ported from
`benchmarks/tables.py` (reduced scale; exact-size columns).

Each function keeps JAX's settings (modes, hidden sizes, steps quick and
full, batch, sequence length, learning rate, seeds, corpora and the
'size at paper dims' columns), returns printable rows and writes
`<out>/<name>.json` (`results/torch_tables/` by default).  Keyword
arguments beyond JAX's `quick`: `device` (the card unless the caller
asks for the CPU), `out` and `seed` (a shift of every seed, 0 being
JAX's numbering; see `common`).

Tables 4 and 5 train a classifier on the BN-RNN's outputs; their steps
(`mnist_step`, `qa_step`) are built from a loss (`mnist_loss`,
`qa_loss`) by `classifier_step`: the gradients of the whole dict, the
classifier's group included, one AdamW update over all of it, then the
masters' clip on `layers` and `head` alone, as JAX's steps do.  The
stochastic weights come from `noise` (one `(ux, uh)` per layer, the
tests inject JAX's own draws) or from a generator `gen`.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import bnlstm as BL
from repro_torch.data.loader import to_device
from repro_torch.data.synth import seq_mnist_like
from repro_torch.experiments import common as C
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.launch import roofline as RF
from repro_torch.train.optimizer import OptConfig, opt_init, opt_update
from repro_torch.train.train_step import value_and_grad

LN2 = math.log(2.0)


# --- Table 1: char-level BPC, LSTM, quantized vs baselines -------------------

def table1_char_lm(quick=False, *, device=None, out=None, seed=0):
    device = resolve_device(device)
    steps = 60 if quick else 200
    modes = ["fp", "ternary", "binary", "binaryconnect"]
    extra = [] if quick else ["twn", "dorefa3"]
    rows = []
    for corpus, d_in, hid_full in (("ptb", 50, 1000), ("linux", None, 512)):
        vocab = C.corpus(corpus).vocab
        for mode in modes + (extra if corpus == "ptb" else []):
            r = C.train_rnn(corpus, mode, steps=steps, seed=seed,
                            device=device)
            r["size_kb_full"] = C.rnn_size_kb(vocab if d_in is None else d_in,
                                              hid_full, mode)
            rows.append(r)
    rows = C.strip(rows)
    C.write("table1_char_lm", rows, device=device, out=out, seed=seed,
            meta={"note": "reduced hidden=128; size column at paper dims"})
    return rows


# --- Table 1b: convergence-scale comparison ----------------------------------

def table1b_convergence(quick=False, *, device=None, out=None, seed=0):
    """Closer to the paper's operating point (seq 100, a wider LSTM,
    longer training): where BinaryConnect's missing output normalization
    may bite while BN-ternary tracks fp."""
    device = resolve_device(device)
    steps = 80 if quick else 500
    rows = []
    for mode in ("fp", "ternary", "binaryconnect"):
        r = C.train_rnn("ptb", mode, hidden=256, steps=steps, seq=100,
                        batch=16, lr=2e-3, seed=seed, device=device)
        r["size_kb_full"] = C.rnn_size_kb(50, 1000, mode)
        rows.append(r)
    rows = C.strip(rows)
    C.write("table1b_convergence", rows, device=device, out=out, seed=seed)
    return rows


# --- Table 2: Text8 (size-dominated) -----------------------------------------

def table2_text8(quick=False, *, device=None, out=None, seed=0):
    device = resolve_device(device)
    steps = 60 if quick else 150
    rows = []
    for mode in ("fp", "ternary", "binary"):
        r = C.train_rnn("text8", mode, steps=steps, seed=seed, device=device)
        n = 27 * 4 * 2000 + 2000 * 4 * 2000  # paper: LSTM-2000 on text8
        bits = {"fp": 32, "ternary": 2, "binary": 1}[mode]
        r["size_mb_full"] = round(n * bits / 8 / 1e6, 1)
        rows.append(r)
    rows = C.strip(rows)
    C.write("table2_text8", rows, device=device, out=out, seed=seed)
    return rows


# --- Table 3: word-level PTB (perplexity) ------------------------------------

def table3_word_lm(quick=False, *, device=None, out=None, seed=0):
    device = resolve_device(device)
    steps = 60 if quick else 180
    rows = []
    for name, hidden_red, hidden_full, layers in (("small", 96, 300, 1),
                                                  ("medium", 160, 650, 1)):
        for mode in ("fp", "ternary", "binary", "binaryconnect"):
            r = C.train_rnn("words", mode, hidden=hidden_red, steps=steps,
                            seq=35, seed=seed, device=device)
            r["model"] = name
            r["val_ppl"] = round(float(np.exp(r["val_bpc"] * np.log(2))), 2)
            r["size_kb_full"] = C.rnn_size_kb(10000, hidden_full, mode,
                                              layers=layers)
            rows.append(r)
    rows = C.strip(rows)
    C.write("table3_word_lm", rows, device=device, out=out, seed=seed,
            meta={"note": "byte-corpus stand-in for 10k-word PTB; ppl=2^bpc"})
    return rows


# --- Tables 4 and 5: a classifier on the BN-RNN's outputs --------------------

def _rnn_vars(params: dict, bn_state: dict) -> dict:
    return {"params": {"layers": params["layers"], "head": params["head"]},
            "state": bn_state}


def _nll(out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-mean(sum(log_softmax(out) * one_hot(labels))), as JAX writes it."""
    logp = F.log_softmax(out, dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def classifier_step(loss_fn: Callable, cfg: BL.RNNConfig,
                    opt_cfg: OptConfig, label: str) -> Callable:
    """step(params, opt, bn_state, batch, *, gen=None, noise=None) ->
    (params, opt, new BN state, loss, accuracy) for
    `loss_fn(params, bn_state, batch, cfg, gen=, noise=) -> (loss, (new BN
    state, class scores))`: AdamW over the whole dict (a zero gradient
    where the loss does not reach, as `jax.grad`), then `clip_masters` on
    `layers` and `head` alone."""

    def step(params, opt, bn_state, batch, *, gen=None, noise=None):
        loss, (new_bn, out), grads = value_and_grad(
            lambda p: loss_fn(p, bn_state, batch, cfg, gen=gen, noise=noise),
            params)
        params, opt, _ = opt_update(grads, opt, params, opt_cfg)
        params = {**params, **BL.clip_masters(
            {"layers": params["layers"], "head": params["head"]}, cfg)}
        acc = (out.argmax(-1) == batch[label]).float().mean()
        return params, opt, new_bn, loss, acc

    return step


def _train_classifier(step: Callable, params: dict, opt_cfg: OptConfig,
                      bn_state: dict, batches: Callable, steps: int,
                      noise_seed: int, device: torch.device) -> float:
    """`steps` of `step` from `params`, each on `batches(i)`, the weights
    sampled from one generator seeded `noise_seed`; the mean accuracy of
    the last 10 steps."""
    opt = opt_init(params, opt_cfg)
    gen = torch.Generator(device=device).manual_seed(noise_seed)
    accs = []
    for i in range(steps):
        params, opt, bn_state, _, acc = step(
            params, opt, bn_state, to_device(batches(i), device), gen=gen)
        accs.append(acc)
    return float(torch.stack(accs[-10:]).mean())


# Table 4: sequential MNIST (a reduced 16 x 16 'pixels'; paper 28 x 28)
MNIST_SIDE = 16
MNIST_BATCH = 32
MNIST_HIDDEN = 64
MNIST_OPT = OptConfig(lr=2e-3)


def mnist_config(mode: str, hidden: int = MNIST_HIDDEN) -> BL.RNNConfig:
    return BL.RNNConfig(vocab=2, d_hidden=hidden, quant=C.spec_for(mode),
                        cell_norm=mode != "binaryconnect")


def mnist_init(cfg: BL.RNNConfig, device, seed: int = 0) -> tuple:
    """(params with the classifier `cls` {W (H, 10), b}, BN state): JAX's
    keys 0 (the RNN) and 5 (`W` = 0.1 N(0, 1)), shifted by `seed`."""
    var = BL.rnn_lm_init(torch.Generator().manual_seed(seed), cfg,
                         device=device)
    w = 0.1 * torch.randn((cfg.d_hidden, 10), dtype=cfg.dtype,
                          generator=torch.Generator().manual_seed(seed + 5))
    params = {**var["params"], "cls": {
        "W": w.to(device), "b": torch.zeros(10, dtype=cfg.dtype,
                                           device=device)}}
    return params, var["state"]


def mnist_loss(params, bn_state, batch, cfg, *, gen=None, noise=None):
    """Cross entropy over 10 classes of the classifier on the LAST hidden
    state (paper: LSTM-100 + softmax over the final state); the pixels
    (B, T, 1) read as tokens `pixels > 0.5` of a vocabulary of 2."""
    tokens = (batch["pixels"][..., 0] > 0.5).to(torch.int32)
    hs, new_bn = BL.rnn_lm_apply(_rnn_vars(params, bn_state), tokens, cfg,
                                 training=True, gen=gen, noise=noise,
                                 return_state=True, features_only=True)
    out = hs[:, -1] @ params["cls"]["W"] + params["cls"]["b"]
    return _nll(out, batch["labels"]), (new_bn, out.detach())


def mnist_step(cfg: BL.RNNConfig) -> Callable:
    return classifier_step(mnist_loss, cfg, MNIST_OPT, "labels")


def table4_mnist(quick=False, *, device=None, out=None, seed=0):
    device = resolve_device(device)
    steps = 80 if quick else 300
    rows = []
    for mode in ("fp", "ternary", "binary", "binaryconnect"):
        cfg = mnist_config(mode)
        params, bn_state = mnist_init(cfg, device, seed)
        acc = _train_classifier(
            mnist_step(cfg), params, MNIST_OPT, bn_state,
            lambda i: seq_mnist_like(i, MNIST_BATCH, side=MNIST_SIDE), steps,
            seed + 1, device)
        n = 1 * 4 * 100 + 100 * 4 * 100  # paper dims: LSTM-100, 1-dim input
        bits = {"fp": 32, "ternary": 2, "binary": 1, "binaryconnect": 1}[mode]
        rows.append({"mode": mode,
                     "final_train_acc": round(acc, 3),
                     "size_kb_full": round(n * bits / 8 / 1000, 1),
                     "ops_kops_full": round(2 * n / 1000, 1)})
    C.write("table4_mnist", rows, device=device, out=out, seed=seed)
    return rows


# Table 5: question answering (an attentive-reader-lite cloze): the answer
# token follows a marker in the document; an attention readout over BN-GRU
# encodings has to find it
QA_VOCAB, QA_SEQ, QA_BATCH, QA_HIDDEN = 40, 24, 32, 48
QA_MARK = QA_VOCAB - 1
QA_OPT = OptConfig(lr=3e-3)


def qa_batch(step: int) -> dict:
    """JAX's `make_batch`: numpy, a function of the step."""
    rng = np.random.default_rng(1000 + step)
    doc = rng.integers(0, QA_VOCAB - 1, size=(QA_BATCH, QA_SEQ))
    pos = rng.integers(0, QA_SEQ - 1, size=QA_BATCH)
    ans = rng.integers(0, QA_VOCAB - 1, size=QA_BATCH)
    doc[np.arange(QA_BATCH), pos] = QA_MARK
    doc[np.arange(QA_BATCH), pos + 1] = ans
    return {"doc": doc.astype(np.int32), "ans": ans.astype(np.int32)}


def qa_config(mode: str, hidden: int = QA_HIDDEN,
              vocab: int = QA_VOCAB) -> BL.RNNConfig:
    return BL.RNNConfig(vocab=vocab, d_hidden=hidden, cell="gru",
                        quant=C.spec_for(mode), cell_norm=False)


def qa_init(cfg: BL.RNNConfig, device, seed: int = 0) -> tuple:
    """(params with the readout `qa` {Wm (V, H) zeros, w (H,) zeros, Wa
    (V, V) = 0.01 N(0, 1)}, BN state): JAX's keys 0 (the RNN) and 2
    (`Wa`), shifted by `seed`."""
    var = BL.rnn_lm_init(torch.Generator().manual_seed(seed), cfg,
                         device=device)
    V, H, dt = cfg.vocab, cfg.d_hidden, cfg.dtype
    wa = 0.01 * torch.randn((V, V), dtype=dt,
                            generator=torch.Generator().manual_seed(seed + 2))
    params = {**var["params"], "qa": {
        "Wm": torch.zeros((V, H), dtype=dt, device=device),  # logit space
        "w": torch.zeros(H, dtype=dt, device=device), "Wa": wa.to(device)}}
    return params, var["state"]


def qa_loss(params, bn_state, batch, cfg, *, gen=None, noise=None):
    """The readout over the GRU's logits as encodings `enc` (B, T, V):
    m = tanh(enc Wm), s = softmax_T(m w), r = sum_t s enc, out = r Wa."""
    enc, new_bn = BL.rnn_lm_apply(_rnn_vars(params, bn_state), batch["doc"],
                                  cfg, training=True, gen=gen, noise=noise,
                                  return_state=True)
    qa = params["qa"]
    m = torch.tanh(enc @ qa["Wm"])
    s = torch.softmax(m @ qa["w"], dim=-1)
    r = torch.einsum("bt,btv->bv", s, enc)
    out = r @ qa["Wa"]
    return _nll(out, batch["ans"]), (new_bn, out.detach())


def qa_step(cfg: BL.RNNConfig) -> Callable:
    return classifier_step(qa_loss, cfg, QA_OPT, "ans")


def table5_qa(quick=False, *, device=None, out=None, seed=0):
    """Exercises the paper's claim that the technique survives an
    attention readout over recurrent encoders."""
    device = resolve_device(device)
    steps = 80 if quick else 250
    rows = []
    for mode in ("fp", "ternary", "binary", "binaryconnect"):
        cfg = qa_config(mode)
        params, bn_state = qa_init(cfg, device, seed)
        acc = _train_classifier(qa_step(cfg), params, QA_OPT,
                                bn_state, qa_batch, steps, seed + 1, device)
        rows.append({"mode": mode,
                     "final_acc": round(acc, 3),
                     "size_mb_full": round(
                         (256 * 4 * 256 * 2 + 2 * 120000 * 256) *
                         {"fp": 32, "ternary": 2, "binary": 1,
                          "binaryconnect": 1}[mode] / 8 / 1e6, 1)})
    C.write("table5_qa", rows, device=device, out=out, seed=seed)
    return rows


# --- Table 6: GRU char-level -------------------------------------------------

def table6_gru(quick=False, *, device=None, out=None, seed=0):
    device = resolve_device(device)
    steps = 60 if quick else 200
    rows = []
    for mode in ("fp", "ternary", "binary"):
        r = C.train_rnn("ptb", mode, cell="gru", steps=steps, seed=seed,
                        device=device)
        n = 50 * 3 * 1000 + 1000 * 3 * 1000
        bits = {"fp": 32, "ternary": 2, "binary": 1}[mode]
        r["size_kb_full"] = round(n * bits / 8 / 1000, 1)
        rows.append(r)
    rows = C.strip(rows)
    C.write("table6_gru", rows, device=device, out=out, seed=seed)
    return rows


# --- Table 7: hardware (the paper's ASIC numbers + the H100 translation) -----

ASIC = [
    {"design": "low-power", "precision": "fp12", "mac": 100,
     "gops": 80, "area_mm2": 2.56, "power_mw": 336},
    {"design": "low-power", "precision": "binary", "mac": 100,
     "gops": 80, "area_mm2": 0.24, "power_mw": 37},
    {"design": "low-power", "precision": "ternary", "mac": 100,
     "gops": 80, "area_mm2": 0.42, "power_mw": 61},
    {"design": "high-speed", "precision": "fp12", "mac": 100,
     "gops": 80, "area_mm2": 2.56, "power_mw": 336},
    {"design": "high-speed", "precision": "binary", "mac": 1000,
     "gops": 800, "area_mm2": 2.54, "power_mw": 347},
    {"design": "high-speed", "precision": "ternary", "mac": 500,
     "gops": 400, "area_mm2": 2.16, "power_mw": 302},
]
# the weight bits of the translation's three decode streams
DECODE_BITS = (("bf16", 16), ("ternary_packed", 2), ("binary_packed", 1))


def decode_hbm_bytes() -> dict:
    """Per-token HBM bytes of qwen3-1.7b's decode (a 1024-token context,
    batch 1, one card) at 16, 2 and 1 weight bits: the analytic model of
    `launch.roofline`."""
    cfg = get_config("qwen3-1.7b")
    sh = ShapeSpec("decode", 1024, 1, "decode")
    return {name: RF.analytic_hbm_bytes(cfg, sh, 1, weight_bits=bits)
            for name, bits in DECODE_BITS}


def table7_hardware(quick=False, *, device=None, out=None, seed=0):
    """The paper's ASIC numbers (Table 7, the published reference) beside
    the H100 translation: the weight-stream bytes a decode token reads and
    the time they take at the card's HBM rate, a bound, not measured."""
    device = resolve_device(device)
    derived = {
        "speedup_binary": 800 / 80, "speedup_ternary": 400 / 80,
        "area_saving_binary": round(2.56 / 0.24, 1),
        "power_saving_binary": round(336 / 37, 1),
        "mem_bw_saving_binary": 32 * 12 / 32,   # 12-bit fp vs 1-bit
        "mem_bw_saving_ternary": 12 / 2,
    }
    hbm = decode_hbm_bytes()
    h100 = {"decode_hbm_bytes": {k: round(v / 1e6, 1) for k, v in hbm.items()},
            "bandwidth_amplification_ternary":
                round(hbm["bf16"] / hbm["ternary_packed"], 2),
            "bandwidth_amplification_binary":
                round(hbm["bf16"] / hbm["binary_packed"], 2),
            "decode_bound_us": {k: round(v / RF.HBM_BW * 1e6, 2)
                                for k, v in hbm.items()},
            "bound": f"H100 SXM bound at {RF.HBM_BW:.3g} B/s, not measured"}
    C.write("table7_hardware", ASIC, device=device, out=out, seed=seed,
            meta={"derived": derived, "h100": h100})
    return ASIC + [derived, h100]


# --- figures -----------------------------------------------------------------

def stochastic_bpcs(params, bn_state, cfg, batch: dict, n: int,
                    seed: int = 0) -> np.ndarray:
    """BPC of `batch` under `n` fresh samples of the stochastic weights
    (the training forward: batch statistics, each sample from a generator
    of its own, seeded seed, seed + 1, ...); each sample's new BN state is
    dropped, so none reaches the next."""
    dev = batch["tokens"].device
    out = []
    with torch.no_grad():
        for i in range(n):
            gen = torch.Generator(device=dev).manual_seed(seed + i)
            loss, _ = BL.lm_loss({"params": params, "state": bn_state},
                                 batch["tokens"], batch["targets"], cfg,
                                 training=True, gen=gen)
            out.append(loss / LN2)
    return torch.stack(out).double().cpu().numpy()


def fig1b_stochastic_variance(quick=False, *, device=None, out=None, seed=0):
    """Variance of prediction quality under STOCHASTIC ternary sampling
    (paper Fig. 1b: negligible)."""
    device = resolve_device(device)
    r = C.train_rnn("ptb", "ternary", steps=40 if quick else 150, seed=seed,
                    device=device)
    st, cfg = r["state"], r["cfg"]
    b = to_device(C.corpus("ptb").batch("valid", 0, 16, 48), device)
    n = 40 if quick else 200
    bpcs = stochastic_bpcs(st.params, st.bn_state, cfg, b, n, seed)
    rows = [{"mean_bpc": round(float(bpcs.mean()), 4),
             "std_bpc": round(float(bpcs.std()), 5),
             "deterministic_bpc": r["val_bpc"], "n_samples": n}]
    C.write("fig1b_variance", rows, device=device, out=out, seed=seed)
    return rows


def eval_bpc(params, bn_state, cfg, batch: dict) -> float:
    """Deterministic BPC of `batch` (inference weights, running BN
    statistics)."""
    with torch.no_grad():
        loss, _ = BL.lm_loss({"params": params, "state": bn_state},
                             batch["tokens"], batch["targets"], cfg,
                             training=False)
    return float(loss / LN2)


def fig2_generalization(quick=False, *, device=None, out=None, seed=0):
    """Eval BPC at sequence lengths beyond training (paper Fig. 2b)."""
    device = resolve_device(device)
    r = C.train_rnn("ptb", "ternary", steps=60 if quick else 200, seq=32,
                    seed=seed, device=device)
    st, cfg = r["state"], r["cfg"]
    c = C.corpus("ptb")
    rows = [{"seq": seq, "bpc": round(eval_bpc(
        st.params, st.bn_state, cfg,
        to_device(c.batch("valid", 0, 8, seq), device)), 4)}
        for seq in (32, 64, 128)]
    rows.append({"train_curve_bpc": r["train_curve_bpc"]})
    C.write("fig2_generalization", rows, device=device, out=out, seed=seed)
    return rows


def fig3_batch_size(quick=False, *, device=None, out=None, seed=0):
    """Prediction quality vs training batch size (paper Fig. 3: BN-quantized
    models need a non-trivial batch for stable statistics)."""
    device = resolve_device(device)
    steps = 60 if quick else 150
    rows = []
    for batch in (2, 8, 32):
        r = C.train_rnn("ptb", "ternary", steps=steps, batch=batch,
                        seed=seed, device=device)
        rows.append({"batch": batch, "val_bpc": r["val_bpc"]})
    C.write("fig3_batch_size", rows, device=device, out=out, seed=seed)
    return rows
