"""The paper's tables on the port (`repro_torch.experiments`) against the
JAX harness (`benchmarks/common.py`, `benchmarks/tables.py`), on the CPU.

The JAX harness is not imported: where a table's step or corpus is
written inside it, the JAX side is re-stated here from the JAX package's
own functions, with the lines it re-states cited.  The same numpy weights
go to both sides (`convert.from_numpy`), and the stochastic weights come
from JAX's own draws, rebuilt and injected into the port.

Tolerances, each with its reason:
  * Tables 4 and 5, one step: loss, every gradient leaf, the parameters
    after the AdamW step, its moments and the BN state within 1e-5
    relative L2 a leaf.  The two sides differ only in fp32 summation order
    and libm; an AdamW step moves a master by about lr whatever its
    gradient, so a leaf's relative L2 after the step stays near the
    forward's.
  * Fig. 2: deterministic BPC within 1e-5 (the forward's 1e-5, see
    `test_torch_train.py`).
  * Fig. 1b: the mean of 32 stochastic samples within 4 standard errors of
    JAX's 32: both sides draw from the same distribution, with different
    streams.
  * Corpora, size columns and Table 7's bytes: exact.

`python tests/test_torch_tables.py --tree DIR` is not a test: it runs the
`--quick` tables of both packages over seeds 0, 1 and 2 (`--seeds`,
`--only`) from DIR, a copy of this repository's tree (so that the JAX
harness writes nothing here), and writes every row to
`results/torch_tables/cpu_quick_seeds.json` (`--out`); `--summary JSON
[JSON ...]` prints, for each row and metric, both packages' mean, range
and spread over every seed of those files.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.core import bnlstm as JBL
from repro.core.quantize import QuantSpec as JQuantSpec
from repro.data import synth as JSYN
from repro.data import text as JTXT
from repro.launch import roofline as JRF
from repro.train import checkpoint as JCK
from repro.train import optimizer as JOPT
from repro_torch import convert
from repro_torch.core import bnlstm as BL
from repro_torch.experiments import common as C
from repro_torch.experiments import tables as T
from repro_torch.train import checkpoint as CK
from repro_torch.train import optimizer as OPT
from repro_torch.train.train_step import value_and_grad

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5
# XLA's CPU compile without its costly LLVM passes: the reference's
# programs are compiled once each and run a few times, so their compile
# was most of these tests' time (2.1 s of a Table 4 step case's 3.9 s
# with the passes on); the arithmetic they run is the same
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# one compiled init (its eager ops would each compile on their own)
_jinit = jax.jit(JBL.rnn_lm_init, static_argnums=1,
                 compiler_options=FAST_COMPILE)


@jax.jit
def _jax_noise(key, jparams):
    """The noise JAX's `_quantized_weights` draws from `key`."""
    out = []
    for l, lp in enumerate(jparams["layers"]):
        kx, kh = jax.random.split(jax.random.fold_in(key, l))
        out.append((jax.random.uniform(kx, lp["wx"].shape, lp["wx"].dtype),
                    jax.random.uniform(kh, lp["wh"].shape, lp["wh"].dtype)))
    return out


def _port_noise(jnoise):
    return [tuple(torch.from_numpy(np.asarray(u).copy()) for u in pair)
            for pair in jnoise]


def _rel_l2(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    d = np.linalg.norm(got - want)
    return float(d / np.linalg.norm(want)) if d else 0.0


def _assert_trees(jtree, ttree, tol=REL):
    """Leaf for leaf, by the dotted names both checkpoints use."""
    jflat, tflat = JCK._flatten(jtree), CK._flatten(ttree)
    assert list(jflat) == list(tflat)
    worst = {k: _rel_l2(tflat[k], jflat[k]) for k in jflat}
    bad = {k: v for k, v in worst.items() if v > tol}
    assert not bad, bad
    return max(worst.values())


def _jspec(mode):
    """`benchmarks/common.py:55-58` `spec_for`."""
    return (JQuantSpec(mode="none") if mode == "fp"
            else JQuantSpec(mode=mode, norm="batch"))


# --- corpora -----------------------------------------------------------------


def _jax_corpus(name):
    """`benchmarks/common.py:39-52` `corpus`, re-stated."""
    if name == "linux":
        return JTXT.ByteCorpus.from_dir(ROOT / "src", limit_bytes=2_000_000)
    vocab, seed, n = {"ptb": (50, 0, 120_000), "text8": (27, 2, 120_000),
                      "words": (255, 3, 200_000)}[name]
    data = np.asarray(JSYN.markov_bytes(n, vocab=vocab, seed=seed)) % 256
    return JTXT.ByteCorpus.from_bytes(bytes(bytearray(data)))


@pytest.mark.parametrize("name", ["ptb", "text8", "words", "linux"])
def test_corpus_batches_equal_jax(name):
    """The same corpus bytes, vocabulary and splits, and the same train and
    valid batches, as the JAX harness builds ("linux": the same sorted
    file list and 2 MB prefix of `src/`)."""
    want, got = _jax_corpus(name), C.corpus(name)
    assert got.vocab == want.vocab and got.splits == want.splits
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.itos, want.itos)
    for split, step, b, s in (("train", 0, 16, 48), ("train", 37, 16, 100),
                              ("valid", 3, 8, 128)):
        wb, gb = want.batch(split, step, b, s), got.batch(split, step, b, s)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(gb[k], wb[k])


# --- the size columns --------------------------------------------------------


def _jax_size_kb(d_in, hidden, mode, layers=1):
    """`benchmarks/common.py:95-104` `rnn_size_kb`, re-stated."""
    bits = {"fp": 32, "binary": 1, "binaryconnect": 1, "ternary": 2,
            "twn": 2, "ttq": 2, "dorefa3": 3, "dorefa4": 4}[mode]
    n = d_in * 4 * hidden + hidden * 4 * hidden
    if layers == 2:
        n += hidden * 4 * hidden + hidden * 4 * hidden
    return round(n * bits / 8 / 1000, 1)


def _bits(mode):
    return {"fp": 32, "ternary": 2, "binary": 1, "binaryconnect": 1}[mode]


def test_size_columns_equal_jax_closed_forms(monkeypatch, tmp_path):
    """Every table's 'size at paper dims' column, from the tables' own
    code with training stubbed out, against JAX's closed forms
    (`benchmarks/tables.py:33-34, 56, 70-72, 91-92, 151-156, 224-228,
    244-246`), and pinned literals."""
    assert C.rnn_size_kb(50, 1000, "fp") == 16800.0
    assert C.rnn_size_kb(50, 1000, "ternary") == 1050.0
    for mode in ("fp", "binary", "ternary", "twn", "dorefa3", "dorefa4"):
        for args in ((50, 1000), (205, 512), (10000, 650), (300, 300, 2)):
            assert C.rnn_size_kb(*args[:2], mode, *args[2:]) == \
                _jax_size_kb(*args[:2], mode, *args[2:])

    monkeypatch.setattr(C, "train_rnn", lambda corpus, mode, **kw: {
        "mode": mode, "corpus": corpus, "val_bpc": 1.0})
    monkeypatch.setattr(T, "_train_classifier", lambda *a, **kw: 0.5)
    run = dict(quick=False, device="cpu", out=tmp_path)
    t1 = T.table1_char_lm(**run)
    linux = C.corpus("linux").vocab
    assert [(r["corpus"], r["mode"], r["size_kb_full"]) for r in t1] == \
        [("ptb", m, _jax_size_kb(50, 1000, m)) for m in
         ("fp", "ternary", "binary", "binaryconnect", "twn", "dorefa3")] + \
        [("linux", m, _jax_size_kb(linux, 512, m)) for m in
         ("fp", "ternary", "binary", "binaryconnect")]
    assert [r["size_kb_full"] for r in T.table1b_convergence(**run)] == \
        [16800.0, 1050.0, 525.0]
    n2 = 27 * 4 * 2000 + 2000 * 4 * 2000
    assert [r["size_mb_full"] for r in T.table2_text8(**run)] == \
        [round(n2 * _bits(m) / 8 / 1e6, 1)
         for m in ("fp", "ternary", "binary")]
    t3 = T.table3_word_lm(**run)
    assert [(r["model"], r["size_kb_full"], r["val_ppl"]) for r in t3] == \
        [(name, _jax_size_kb(10000, h, m), 2.0)
         for name, h in (("small", 300), ("medium", 650))
         for m in ("fp", "ternary", "binary", "binaryconnect")]
    n4 = 1 * 4 * 100 + 100 * 4 * 100
    assert T.table4_mnist(**run) == [
        {"mode": m, "final_train_acc": 0.5,
         "size_kb_full": round(n4 * _bits(m) / 8 / 1000, 1),
         "ops_kops_full": round(2 * n4 / 1000, 1)}
        for m in ("fp", "ternary", "binary", "binaryconnect")]
    n5 = 256 * 4 * 256 * 2 + 2 * 120000 * 256
    assert T.table5_qa(**run) == [
        {"mode": m, "final_acc": 0.5,
         "size_mb_full": round(n5 * _bits(m) / 8 / 1e6, 1)}
        for m in ("fp", "ternary", "binary", "binaryconnect")]
    n6 = 50 * 3 * 1000 + 1000 * 3 * 1000
    assert [r["size_kb_full"] for r in T.table6_gru(**run)] == \
        [round(n6 * _bits(m) / 8 / 1000, 1)
         for m in ("fp", "ternary", "binary")]
    meta = json.loads((tmp_path / "table1_char_lm.json").read_text())["meta"]
    assert meta["device"] == "cpu" and meta["card"] is None
    assert meta["torch"] == torch.__version__
    assert meta["notes"] == list(C.NOTES)


# --- Tables 4 and 5: one step against JAX's ---------------------------------


def _jax_one_step(jcfg, opt_cfg, lf, init, batch):
    """JAX's side of one step, in one compiled call: the weights from
    `init()`, JAX's noise of key 11, then the step of
    `benchmarks/tables.py:131-139` (Table 4) and :208-215 (Table 5):
    value_and_grad of the whole dict, `opt_update` over it from
    `opt_init`, `clip_masters` on layers/head.  Returns (params, BN
    state, noise, loss, new BN state, grads, params after, opt after) so
    that each can be compared."""

    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def run(batch):
        params, bn_state = init()
        key = jax.random.PRNGKey(11)
        (l, (new_bn, _)), g = jax.value_and_grad(lf, has_aux=True)(
            params, bn_state, batch, key)
        after, opt, _ = JOPT.opt_update(
            g, JOPT.opt_init(params, opt_cfg), params, opt_cfg)
        after = dict(after)
        after.update(JBL.clip_masters({"layers": after["layers"],
                                       "head": after["head"]}, jcfg))
        return (params, bn_state, _jax_noise(key, params), l, new_bn, g,
                after, opt)

    return run({k: jnp.asarray(v) for k, v in batch.items()})


def _jax_mnist_lf(jcfg):
    """`benchmarks/tables.py:121-129`, with the BN state and key as
    arguments."""
    def lf(p, bn_state, batch, rng):
        tokens = (batch["pixels"][..., 0] > 0.5).astype(jnp.int32)
        hs, new_bn = JBL.rnn_lm_apply(
            {"params": {"layers": p["layers"], "head": p["head"]},
             "state": bn_state}, tokens, jcfg, training=True, rng=rng,
            return_state=True, features_only=True)
        out = hs[:, -1] @ p["cls"]["W"] + p["cls"]["b"]
        onehot = jax.nn.one_hot(batch["labels"], 10)
        l = -jnp.mean(jnp.sum(jax.nn.log_softmax(out) * onehot, -1))
        return l, (new_bn, out)
    return lf


def _jax_qa_lf(jcfg):
    """`benchmarks/tables.py:195-206`, with the BN state and key as
    arguments."""
    vocab = jcfg.vocab

    def lf(p, bn_state, batch, rng):
        enc, new_bn = JBL.rnn_lm_apply(
            {"params": {"layers": p["layers"], "head": p["head"]},
             "state": bn_state}, batch["doc"], jcfg, training=True,
            rng=rng, return_state=True)
        m = jnp.tanh(enc @ p["qa"]["Wm"])
        s = jax.nn.softmax(m @ p["qa"]["w"], axis=-1)
        r = jnp.einsum("bt,btv->bv", s, enc)
        out = r @ p["qa"]["Wa"]
        onehot = jax.nn.one_hot(batch["ans"], vocab)
        l = -jnp.mean(jnp.sum(jax.nn.log_softmax(out) * onehot, -1))
        return l, (new_bn, out)
    return lf


def _one_step_parity(jcfg, tcfg, init, batch, jlf, jopt, tloss, tstep,
                     mode):
    """Loss, gradients, new BN state, params and AdamW moments after one
    step: JAX's re-stated step against the port's, from one set of
    weights, JAX's noise injected, every leaf within REL."""
    jparams, jbn, jnoise, jl, jnew_bn, jg, jp, jo = _jax_one_step(
        jcfg, jopt, jlf, init, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tparams = convert.from_numpy(_np(jparams), device="cpu")
    tbn = convert.from_numpy(_np(jbn), device="cpu")
    noise = _port_noise(jnoise) if mode in ("ternary", "binary") else None
    tl, (tnew_bn, _), tg = value_and_grad(
        lambda p: tloss(p, tbn, tb, tcfg, noise=noise), tparams)
    assert _rel_l2(tl, jl) <= REL
    _assert_trees(jg, tg)
    tp, to, tnew_bn2, tl2, _ = tstep(
        tparams, OPT.opt_init(tparams, OPT.OptConfig()), tbn, tb,
        noise=noise)
    assert float(tl2) == float(tl)
    _assert_trees(jnew_bn, tnew_bn)
    _assert_trees(jnew_bn, tnew_bn2)
    _assert_trees(jp, tp)
    _assert_trees({"m": jo.m, "v": jo.v}, {"m": to.m, "v": to.v})
    assert int(to.step) == int(jo.step) == 1


STEP_MODES = ["ternary", "binary", "fp"]


@pytest.mark.parametrize("mode", STEP_MODES)
def test_mnist_step_matches_jax(mode):
    """Table 4's step at side 4 (T = 16) and H = 8, from JAX's weights."""
    with jax.enable_x64(True):
        jcfg = JBL.RNNConfig(vocab=2, d_hidden=8, quant=_jspec(mode),
                             cell_norm=mode != "binaryconnect",
                             dtype=jnp.float64)

        def init():
            var = JBL.rnn_lm_init(jax.random.PRNGKey(0), jcfg)
            params = dict(var["params"])
            params["cls"] = {"W": 0.1 * jax.random.normal(
                jax.random.PRNGKey(5), (8, 10), jcfg.dtype),
                "b": jnp.zeros((10,), jcfg.dtype)}
            return params, var["state"]

        tcfg = dataclasses.replace(T.mnist_config(mode, hidden=8),
                                   dtype=torch.float64)
        _one_step_parity(jcfg, tcfg, init, JSYN.seq_mnist_like(3, 16, side=4),
                         _jax_mnist_lf(jcfg), JOPT.OptConfig(lr=2e-3),
                         T.mnist_loss, T.mnist_step(tcfg), mode)


@pytest.mark.parametrize("mode", STEP_MODES)
def test_qa_step_matches_jax(mode):
    """Table 5's step at H = 8 over its own batch (B = 32, T = 24, V =
    40), from JAX's weights (`Wa` drawn from key 2, carried across)."""
    with jax.enable_x64(True):
        jcfg = JBL.RNNConfig(vocab=T.QA_VOCAB, d_hidden=8, cell="gru",
                             quant=_jspec(mode), cell_norm=False,
                             dtype=jnp.float64)
        V = T.QA_VOCAB

        def init():
            var = JBL.rnn_lm_init(jax.random.PRNGKey(0), jcfg)
            params = dict(var["params"])
            params["qa"] = {"Wm": jnp.zeros((V, 8), jcfg.dtype),
                            "w": jnp.zeros((8,), jcfg.dtype),
                            "Wa": 0.01 * jax.random.normal(
                                jax.random.PRNGKey(2), (V, V), jcfg.dtype)}
            return params, var["state"]

        tcfg = dataclasses.replace(T.qa_config(mode, hidden=8),
                                   dtype=torch.float64)
        _one_step_parity(jcfg, tcfg, init, T.qa_batch(4), _jax_qa_lf(jcfg),
                         JOPT.OptConfig(lr=3e-3), T.qa_loss, T.qa_step(tcfg),
                         mode)


def test_classifier_inits_carry_jax_layout():
    """The port's Table 4/5 parameter trees have JAX's groups and shapes
    (the classifier's `W` 0.1 N(0, 1), the readout's `Wm`/`w` zeros)."""
    p4, _ = T.mnist_init(T.mnist_config("ternary"), "cpu")
    assert sorted(p4) == ["cls", "head", "layers"]
    assert p4["cls"]["W"].shape == (T.MNIST_HIDDEN, 10)
    assert 0.05 < float(p4["cls"]["W"].std()) < 0.15
    p5, _ = T.qa_init(T.qa_config("ternary"), "cpu")
    assert sorted(p5["qa"]) == ["Wa", "Wm", "w"]
    assert not p5["qa"]["Wm"].any() and not p5["qa"]["w"].any()
    assert p5["qa"]["Wa"].shape == (T.QA_VOCAB, T.QA_VOCAB)


# --- Figs. 1b and 2 ----------------------------------------------------------


def _fig_model():
    """Ternary BN-LSTM at H = 16 on the ptb corpus, JAX's weights, with
    running BN statistics moved off their initial values."""
    c = C.corpus("ptb")
    jcfg = JBL.RNNConfig(vocab=c.vocab, d_hidden=16, quant=_jspec("ternary"))
    var = _np(_jinit(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(0)
    state = jax.tree.map(lambda a: (a + 0.1 * rng.normal(size=a.shape) ** 2)
                         .astype(a.dtype), var["state"])
    tcfg = BL.RNNConfig(vocab=c.vocab, d_hidden=16,
                        quant=C.spec_for("ternary"))
    return c, jcfg, {"params": var["params"], "state": state}, tcfg


def test_fig2_eval_bpc_matches_jax():
    """Deterministic BPC (inference weights, running statistics) at two
    lengths, against JAX's `lm_loss(training=False) / log 2`."""
    c, jcfg, var, tcfg = _fig_model()
    tvar = convert.from_numpy(var, device="cpu")
    jbpc = jax.jit(lambda v, tok, tgt: JBL.lm_loss(
        v, tok, tgt, jcfg, training=False)[0] / jnp.log(2.0),
        compiler_options=FAST_COMPILE)
    for seq in (16, 48):
        b = c.batch("valid", 0, 8, seq)
        want = jbpc(jax.tree.map(jnp.asarray, var), jnp.asarray(b["tokens"]),
                    jnp.asarray(b["targets"]))
        got = T.eval_bpc(tvar["params"], tvar["state"], tcfg,
                         {k: torch.from_numpy(v) for k, v in b.items()})
        assert abs(got - float(want)) <= REL


def test_fig1b_stochastic_mean_within_4_se_of_jax():
    """32 stochastic samples each side (batch statistics, fresh weights
    each sample): the port's mean within 4 standard errors of JAX's, and
    the BN state handed in unchanged."""
    c, jcfg, var, tcfg = _fig_model()
    b = c.batch("valid", 0, 16, 48)
    jv = jax.tree.map(jnp.asarray, var)
    f = jax.jit(lambda key: JBL.lm_loss(
        jv, jnp.asarray(b["tokens"]), jnp.asarray(b["targets"]), jcfg,
        training=True, rng=key)[0] / jnp.log(2.0),
        compiler_options=FAST_COMPILE)
    want = np.array([float(f(jax.random.PRNGKey(i))) for i in range(32)])
    tvar = convert.from_numpy(var, device="cpu")
    before = [x.clone() for x in jax.tree.leaves(
        tvar["state"], is_leaf=lambda x: isinstance(x, torch.Tensor))]
    got = T.stochastic_bpcs(tvar["params"], tvar["state"], tcfg,
                            {k: torch.from_numpy(v) for k, v in b.items()},
                            32)
    after = jax.tree.leaves(tvar["state"],
                            is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert got.shape == (32,) and got.std() > 0
    se = math.sqrt(got.var() / 32 + want.var() / 32)
    assert abs(got.mean() - want.mean()) <= 4 * se, (got.mean(), want.mean(),
                                                     se)


# --- Table 7 and the CLI -----------------------------------------------------


def test_table7_bytes_equal_jax(tmp_path):
    """qwen3-1.7b's decode bytes at 16, 2 and 1 weight bits equal JAX's
    `analytic_hbm_bytes` exactly; the amplification ratios and the ASIC
    reference are JAX's; the bound is bytes over the card's HBM rate."""
    jcfg = j_get_config("qwen3-1.7b")
    sh = JShapeSpec("decode", 1024, 1, "decode")
    got = T.decode_hbm_bytes()
    for name, bits in T.DECODE_BITS:
        assert got[name] == JRF.analytic_hbm_bytes(jcfg, sh, 1,
                                                   weight_bits=bits)
    rows = T.table7_hardware(device="cpu", out=tmp_path)
    asic, derived, h100 = rows[:6], rows[6], rows[7]
    assert asic == T.ASIC and derived["speedup_binary"] == 10.0
    assert derived["area_saving_binary"] == 10.7
    assert h100["bandwidth_amplification_ternary"] == \
        round(got["bf16"] / got["ternary_packed"], 2)
    assert h100["decode_bound_us"]["bf16"] == \
        round(got["bf16"] / 3.35e12 * 1e6, 2)
    assert "not measured" in h100["bound"]


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.experiments.run", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)


def test_run_cli_writes_table7_and_roofline_or_raises(tmp_path):
    """`--device cpu` writes both JSONs and exits 0; with no `--device`
    and no card it raises before running anything (both at once)."""
    cpu, card = tmp_path / "cpu", tmp_path / "card"
    argv = ["--only", "table7_hardware", "roofline", "--out"]
    procs = [_cli(*argv, str(cpu), "--device", "cpu"), _cli(*argv, str(card))]
    (_, cpu_err), (_, card_err) = [p.communicate(timeout=120) for p in procs]
    assert procs[1].returncode != 0 and "no CUDA device" in card_err
    assert not card.exists()
    assert procs[0].returncode == 0, cpu_err[-2000:]
    t7 = json.loads((cpu / "table7_hardware.json").read_text())
    assert t7["meta"]["device"] == "cpu" and "h100" in t7["meta"]
    roof = json.loads((cpu / "roofline_report.json").read_text())
    assert roof and {"arch", "shape", "mesh", "dominant"} <= set(roof[0])


# --- the --quick tables of both packages over three seeds (not a test) -------


JAX_CHILD = """
import json, sys
import jax
shift, quick = int(sys.argv[1]), sys.argv[2] == "quick"
key = jax.random.PRNGKey
jax.random.PRNGKey = lambda s, *a, **k: key(s + shift, *a, **k)
from benchmarks import run
rows = {}
for name in sys.argv[3:]:
    rows[name] = run.BENCHES[name](quick=quick)
    print(name, flush=True)
json.dump(rows, open("rows.json", "w"), default=str)
"""


QUICK_TABLES = ["table1_char_lm", "table1b_convergence", "table2_text8",
                "table3_word_lm", "table4_mnist", "table5_qa", "table6_gru",
                "fig1b_variance", "fig2_generalization", "fig3_batch_size"]


def _quick_seeds(tree: Path, seeds=(0, 1, 2), names=QUICK_TABLES,
                 quick=True) -> dict:
    """The tables `names` of both packages (at --quick settings unless
    `quick` is False) at each seed shift, all in child processes started
    at once from `tree`: JAX's harness with its keys shifted
    (`jax.random.PRNGKey(s)` -> `PRNGKey(s + shift)`), the port's with
    `--seed`."""
    env = dict(os.environ, PYTHONPATH=str(tree / "src") + os.pathsep
               + str(tree), OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               CUDA_VISIBLE_DEVICES="")
    procs = {}
    for s in seeds:
        # this process's own directories: several may share `tree`
        jdir = tree / f"jax_seed{s}_{os.getpid()}"
        tdir = tree / f"torch_seed{s}_{os.getpid()}"
        jdir.mkdir(exist_ok=True)
        procs[("jax", s)] = subprocess.Popen(
            [sys.executable, "-c", JAX_CHILD, str(s),
             "quick" if quick else "full", *names], cwd=jdir,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        procs[("torch", s)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.experiments.run",
             *(["--quick"] if quick else []), "--device", "cpu", "--seed",
             str(s), "--out", str(tdir), "--only", *names], cwd=tree,
            env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {"jax": {}, "torch": {}}
    for (side, s), p in procs.items():
        log, _ = p.communicate(timeout=7200)
        if p.returncode != 0:
            raise SystemExit(f"{side} seed {s}: exit {p.returncode}\n"
                             f"{log[-3000:]}")
        if side == "jax":
            got = json.loads((tree / f"jax_seed{s}_{os.getpid()}" /
                              "rows.json").read_text())
        else:
            got = {n: json.loads((tree / f"torch_seed{s}_{os.getpid()}" /
                                  f"{n}.json").read_text())["rows"]
                   for n in names}
        out[side][s] = got
    return out


METRICS = ("val_bpc", "final_train_acc", "final_acc", "bpc", "mean_bpc",
           "std_bpc", "deterministic_bpc")
ROW_KEYS = ("model", "corpus", "cell", "mode", "seq", "batch")


def _summary(paths) -> list:
    """One line a (table, row, metric) over every seed of the JSONs at
    `paths`: each package's mean, range and standard deviation, whether
    the two ranges overlap, and the gap of the means in standard errors
    (Welch)."""
    vals: dict = {}
    for path in paths:
        rows = json.loads(Path(path).read_text())["rows"]
        for side, by_seed in rows.items():
            for tables in by_seed.values():
                for name, rs in tables.items():
                    for r in rs:
                        key = tuple(f"{k}={r[k]}" for k in ROW_KEYS if k in r)
                        for m in METRICS:
                            if m in r:
                                vals.setdefault((name, key, m), {}).setdefault(
                                    side, []).append(r[m])
    lines = []
    for (name, key, m), v in vals.items():
        j, t = np.array(v["jax"], float), np.array(v["torch"], float)
        line = (f"{name} {' '.join(key)} {m}: JAX {j.mean():.4f} "
                f"[{j.min():.4f}, {j.max():.4f}] | port {t.mean():.4f} "
                f"[{t.min():.4f}, {t.max():.4f}] | n {len(j)}/{len(t)}")
        if min(len(j), len(t)) > 1:
            sd = (j.std(ddof=1), t.std(ddof=1))
            se = math.sqrt(sd[0] ** 2 / len(j) + sd[1] ** 2 / len(t))
            overlap = t.min() <= j.max() and j.min() <= t.max()
            line += (f" | sd {sd[0]:.4f}/{sd[1]:.4f} | "
                     f"{'overlap' if overlap else 'GAP'} "
                     f"{(t.mean() - j.mean()) / se if se else 0.0:+.2f} se")
        lines.append(line)
    return lines


if __name__ == "__main__":
    import argparse
    import time
    ap = argparse.ArgumentParser()
    ap.add_argument("--summary", type=Path, nargs="+",
                    help="print the comparison of these JSONs and stop")
    ap.add_argument("--tree", type=Path,
                    help="a copy of this repository's tree, outside it")
    ap.add_argument("--out", type=Path, default=ROOT / "results" /
                    "torch_tables" / "cpu_quick_seeds.json")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--only", nargs="+", default=QUICK_TABLES,
                    choices=QUICK_TABLES)
    ap.add_argument("--full", action="store_true",
                    help="the tables' full settings instead of --quick")
    a = ap.parse_args()
    if a.summary:
        print("\n".join(_summary(a.summary)))
        raise SystemExit(0)
    if a.tree is None:
        ap.error("--tree is required to run the tables")
    t0 = time.time()
    rows = _quick_seeds(a.tree.resolve(), a.seeds, a.only, not a.full)
    a.out.parent.mkdir(parents=True, exist_ok=True)
    a.out.write_text(json.dumps({
        "meta": {"device": "cpu", "torch": torch.__version__,
                 "jax": jax.__version__, "quick": not a.full,
                 "seeds": a.seeds,
                 "seconds": round(time.time() - t0, 1),
                 "notes": list(C.NOTES)},
        "rows": rows}, indent=1, default=str))
    print(f"wrote {a.out} in {time.time() - t0:.0f} s")
