"""Parity of the port's training slice with the JAX package, on the CPU:
the baseline quantizers, the training forward and its gradients, the
optimizer, the train step, and the data pipeline.

The same numpy inputs go to both packages.  Randomness goes through
injected noise: the tests rebuild the very uniform arrays the JAX step
draws (`split(fold_in(key, layer))`, then `uniform` of `wx`'s and `wh`'s
shapes) and hand them to the port.

Tolerances, each with its reason:
  * forward (logits, loss, new BN state): 1e-5 absolute.  The two sides
    differ only in fp32 summation order and libm sigmoid/tanh/rsqrt;
    measured worst 7.2e-7 over the four cell x mode cases.
  * gradients of every leaf: rtol 1e-4, atol 1e-6.  Backward sums run over
    the batch and the time loop in other orders, through BN's mean
    subtraction; measured worst 3.9e-6 on gradients up to 4.7.
  * three train steps: 1e-5 absolute on params, optimizer state and BN
    state.  Adam divides by sqrt(v) + eps, so where a gradient is near
    eps its rounding reaches the update at up to lr x 1e-2: the steps run
    the launcher's own rate (1e-3 with 20 warmup steps).  Measured worst
    8.1e-7 (AdamW) and 3.6e-6 (SGD, momentum buffer).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bnlstm as JBL
from repro.core import quantize as JQ
from repro.data import synth as JSYN
from repro.data import text as JTXT
from repro.train import checkpoint as JCK
from repro.train import optimizer as JOPT
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.core import bnlstm as BL
from repro_torch.core import quantize as Q
from repro_torch.data import loader as LD
from repro_torch.data import synth as SYN
from repro_torch.data import text as TXT
from repro_torch.kernels import dispatch
from repro_torch.train import checkpoint as CK
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

torch.set_num_threads(1)
FWD = 1e-5
GRAD = dict(rtol=1e-4, atol=1e-6)


def _cfgs(cell, mode, hidden=32, layers=2, vocab=23):
    kw = dict(vocab=vocab, d_hidden=hidden, n_layers=layers, cell=cell)
    return (JBL.RNNConfig(quant=JQ.QuantSpec(mode=mode, norm="batch"), **kw),
            BL.RNNConfig(quant=Q.QuantSpec(mode=mode, norm="batch"), **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


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


def _tokens(seed, B, T, vocab):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(B, T + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _assert_trees(jtree, ttree, **tol):
    """Leaf for leaf, by the dotted names both checkpoints use."""
    jflat, tflat = JCK._flatten(jtree), CK._flatten(ttree)
    assert list(jflat) == list(tflat)
    for k in jflat:
        np.testing.assert_allclose(np.asarray(tflat[k].detach()),
                                   np.asarray(jflat[k]), err_msg=k, **tol)


# --- quantizers --------------------------------------------------------------


@pytest.mark.parametrize("mode", ["binary", "ternary", "binaryconnect", "twn",
                                  "dorefa2", "dorefa3", "dorefa4", "none"])
def test_apply_quant_matches_jax_with_its_ste_gradient(mode):
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(24, 40)) * 0.1).astype(np.float32)
    u = rng.random((24, 40), dtype=np.float32)
    r = rng.normal(size=(24, 40)).astype(np.float32)
    alpha = JQ.glorot_alpha(24, 40)
    jspec, tspec = JQ.QuantSpec(mode=mode), Q.QuantSpec(mode=mode)
    jloss = lambda w_: jnp.sum(JQ.apply_quant(w_, jspec, alpha,
                                              jnp.asarray(u)) * r)
    jq = JQ.apply_quant(jnp.asarray(w), jspec, alpha, jnp.asarray(u))
    jg = jax.grad(jloss)(jnp.asarray(w))
    tw = torch.from_numpy(w.copy()).requires_grad_(True)
    tq = Q.apply_quant(tw, tspec, alpha, torch.from_numpy(u.copy()))
    (tq * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg), rtol=1e-6)
    assert tspec.weight_bits == jspec.weight_bits


def test_ttq_values_and_scale_gradients_match_jax():
    rng = np.random.default_rng(4)
    w = (rng.normal(size=(16, 24)) * 0.1).astype(np.float32)
    r = rng.normal(size=(16, 24)).astype(np.float32)
    jf = lambda w_, ap, an: jnp.sum(JQ.ttq(w_, ap, an) * r)
    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(w), 0.7, 0.4)
    tw = torch.from_numpy(w.copy()).requires_grad_(True)
    ap = torch.tensor(0.7, requires_grad=True)
    an = torch.tensor(0.4, requires_grad=True)
    q = Q.ttq(tw, ap, an)
    np.testing.assert_allclose(q.detach().numpy(),
                               np.asarray(JQ.ttq(jnp.asarray(w), 0.7, 0.4)),
                               rtol=1e-6)
    (q * torch.from_numpy(r)).sum().backward()
    for got, want in zip((tw.grad, ap.grad, an.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_clip_master_matches_jax():
    w = np.linspace(-0.3, 0.3, 41, dtype=np.float32).reshape(1, 41)
    np.testing.assert_array_equal(
        Q.clip_master(torch.from_numpy(w), 0.1).numpy(),
        np.asarray(JQ.clip_master(jnp.asarray(w), 0.1)))


# --- the training forward and its gradients ----------------------------------


@pytest.mark.parametrize("mode", ["ternary", "binary"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_lm_apply_training_matches_jax(cell, mode):
    """Logits, loss and new BN state within 1e-5; every leaf's gradient
    within rtol 1e-4, atol 1e-6 (measured worst: see the module
    docstring)."""
    jcfg, tcfg = _cfgs(cell, mode)
    var = JBL.rnn_lm_init(jax.random.PRNGKey(7), jcfg)
    key = jax.random.PRNGKey(11)
    tokens, targets = _tokens(1, 6, 10, jcfg.vocab)
    tvar = convert.from_numpy(_np(var), device="cpu")
    noise = _port_noise(_jax_noise(key, var["params"]))

    jlogits = jax.jit(lambda v, t: JBL.rnn_lm_apply(
        v, t, jcfg, training=True, rng=key))(var, jnp.asarray(tokens))
    tlogits = BL.rnn_lm_apply(tvar, torch.from_numpy(tokens), tcfg,
                              training=True, noise=noise)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               atol=FWD)

    def jloss(params):
        return JBL.lm_loss({"params": params, "state": var["state"]},
                           jnp.asarray(tokens), jnp.asarray(targets), jcfg,
                           training=True, rng=key)

    (jl, jbn), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        var["params"])
    batch = {"tokens": torch.from_numpy(tokens),
             "targets": torch.from_numpy(targets)}
    tl, tbn, tg = TS.loss_and_grads(tvar["params"], tvar["state"], batch,
                                    tcfg, noise)
    assert abs(float(tl) - float(jl)) <= FWD
    _assert_trees(jbn, tbn, atol=FWD)
    _assert_trees(jg, tg, **GRAD)
    # the gate BNs' additive terms are fixed: zero gradients, as jax.grad
    lg = tg["layers"][0]
    assert not lg["bn_x"].gamma.any() and not lg["bn_h"].gamma.any()


@pytest.mark.parametrize("batch,route", [(8, "packed_gemv"),
                                         (32, "packed_matmul")])
def test_rnn_lm_apply_eval_fp_and_packed_match_jax(batch, route):
    """Deterministic eval on fp masters and on the exported packed tree;
    the packed h-side takes the GEMV at B <= 8 and the GEMM above, one
    call per layer and timestep (layer 1's x-side is one GEMM over B*T
    rows)."""
    jcfg, tcfg = _cfgs("lstm", "ternary", hidden=24, vocab=19)
    var = JBL.rnn_lm_init(jax.random.PRNGKey(2), jcfg)
    T = 6
    tokens, targets = _tokens(5, batch, T, jcfg.vocab)
    jl, _ = JBL.lm_loss(var, jnp.asarray(tokens), jnp.asarray(targets), jcfg,
                        training=False)
    tvar = convert.from_numpy(_np(var), device="cpu")
    tok, tgt = torch.from_numpy(tokens), torch.from_numpy(targets)
    with torch.no_grad():
        tl, _ = BL.lm_loss(tvar, tok, tgt, tcfg, training=False)
        packed = BL.serving_variables(tvar["params"], tvar["state"], tcfg)
        dispatch.reset_counts()
        pl, _ = BL.lm_loss(packed, tok, tgt, tcfg, training=False)
    assert abs(float(tl) - float(jl)) <= FWD
    assert abs(float(pl) - float(tl)) <= FWD
    want = {route: 2 * T}
    want["packed_matmul"] = want.get("packed_matmul", 0) + 1
    assert dict(dispatch.PLAIN_CALLS) == want
    jpacked = JBL.serving_variables(var["params"], var["state"], jcfg)
    jpl, _ = JBL.lm_loss(jpacked, jnp.asarray(tokens), jnp.asarray(targets),
                         jcfg, training=False)
    assert abs(float(pl) - float(jpl)) <= FWD


def test_features_only_and_generator_noise():
    jcfg, tcfg = _cfgs("gru", "ternary", hidden=16, layers=1)
    tvar = convert.from_numpy(_np(JBL.rnn_lm_init(jax.random.PRNGKey(0),
                                                  jcfg)), device="cpu")
    tok = torch.from_numpy(_tokens(0, 3, 5, jcfg.vocab)[0])
    feats = BL.rnn_lm_apply(tvar, tok, tcfg, training=False,
                            features_only=True)
    assert feats.shape == (3, 5, 16)
    a = BL.rnn_lm_apply(tvar, tok, tcfg, training=True,
                        gen=torch.Generator().manual_seed(4))
    b = BL.rnn_lm_apply(tvar, tok, tcfg, training=True,
                        noise=BL.draw_noise(tvar["params"],
                                            torch.Generator().manual_seed(4)))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="needs noise"):
        BL.rnn_lm_apply(tvar, tok, tcfg, training=True)


def test_clip_masters_uses_each_matrix_alpha():
    jcfg, tcfg = _cfgs("lstm", "binary", hidden=16)
    var = _np(JBL.rnn_lm_init(jax.random.PRNGKey(1), jcfg))
    big = jax.tree.map(lambda a: a * 50.0, var["params"])
    got = BL.clip_masters(convert.from_numpy(big, device="cpu"), tcfg)
    _assert_trees(JBL.clip_masters(big, jcfg), got, rtol=0, atol=0)


# --- optimizer -----------------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": [rng.normal(size=(4,)).astype(np.float32)]}


@pytest.mark.parametrize("cfg", [
    dict(kind="adamw", lr=0.01, weight_decay=0.01, clip_norm=1.0,
         warmup_steps=2, decay_steps=5),
    dict(kind="sgd", lr=0.1, momentum=0.9, clip_norm=0.5)])
def test_opt_update_matches_jax(cfg):
    jc, tc = JOPT.OptConfig(**cfg), OPT.OptConfig(**cfg)
    p = _tree(0)
    jp, js = jax.tree.map(jnp.asarray, p), None
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p)
    js, ts = JOPT.opt_init(jp, jc), OPT.opt_init(tp, tc)
    for i in range(4):
        g = _tree(10 + i)
        jp, js, jm = JOPT.opt_update(jax.tree.map(jnp.asarray, g), js, jp, jc,
                                     0.5)
        tp, ts, tm = OPT.opt_update(
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), g), ts, tp, tc,
            0.5)
        for k in ("lr", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    for got, want in ((tp, jp), (ts.m, js.m)):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    assert int(ts.step) == int(js.step) == 4


def test_adamw_reduces_quadratic():
    cfg = OPT.OptConfig(kind="adamw", lr=0.1)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = OPT.opt_init(params, cfg)
    for _ in range(200):
        params, state, _ = OPT.opt_update({"w": 2 * params["w"]}, state,
                                          params, cfg)
    assert float(params["w"].abs().max()) < 0.05


def test_schedule_warmup_cosine():
    cfg = OPT.OptConfig(lr=1.0, warmup_steps=10, decay_steps=100,
                        min_lr_frac=0.1)
    jcfg = JOPT.OptConfig(lr=1.0, warmup_steps=10, decay_steps=100,
                          min_lr_frac=0.1)
    for s in (0, 9, 37, 1000):
        got = float(OPT.schedule(torch.tensor(s), cfg))
        assert got == float(JOPT.schedule(jnp.asarray(s), jcfg))
    assert float(OPT.schedule(torch.tensor(0), cfg)) == pytest.approx(0.1)
    assert float(OPT.schedule(torch.tensor(9), cfg)) == pytest.approx(1.0)
    assert float(OPT.schedule(torch.tensor(1000), cfg)) == pytest.approx(0.1)


def test_clip_by_global_norm():
    clipped, norm = OPT.clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0,
                                                                   rel=1e-4)


def test_sgd_momentum_honored():
    cfg = OPT.OptConfig(kind="sgd", lr=0.1, momentum=0.9)
    params, g = {"w": torch.tensor([1.0])}, {"w": torch.tensor([1.0])}
    p1, s1, _ = OPT.opt_update(g, OPT.opt_init(params, cfg), params, cfg)
    assert float(p1["w"][0]) == pytest.approx(1.0 - 0.1)
    p2, _, _ = OPT.opt_update(g, s1, p1, cfg)
    assert float(p2["w"][0]) == pytest.approx(0.9 - 0.1 * 1.9)


def test_plateau_lr_against_previous_eval_and_replay():
    hist = [100.0, 90.0, 95.0, 93.0, 91.0, 92.0]
    p, j = OPT.PlateauLR(), JOPT.PlateauLR()
    got = [p.update(v) for v in hist]
    assert got == [j.update(v) for v in hist]
    assert got == [1.0, 1.0, 0.25, 0.25, 0.25, 0.0625]
    assert p.best == 90.0
    q = OPT.PlateauLR()
    assert q.replay(hist) == p.scale
    assert (q.prev, q.best) == (p.prev, p.best)


# --- the train step ----------------------------------------------------------


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_three_train_steps_match_jax(kind):
    """Three `make_rnn_train_step` steps from one start, the JAX step's own
    noise injected: params, optimizer state and BN state within 1e-5."""
    jcfg, tcfg = _cfgs("lstm", "ternary", hidden=24)
    # the launcher's settings (lr 1e-3, 20 warmup steps, clip 1.0); SGD at
    # a rate of the same order as the paper's word-PTB SGD runs
    opt = (dict(kind="adamw", lr=1e-3, clip_norm=1.0, warmup_steps=20)
           if kind == "adamw" else
           dict(kind="sgd", lr=0.05, momentum=0.9, clip_norm=1.0))
    var = JBL.rnn_lm_init(jax.random.PRNGKey(3), jcfg)
    jst = JTS.train_state_init(var["params"], JOPT.OptConfig(**opt),
                               jax.random.PRNGKey(4), bn_state=var["state"])
    tst = convert.from_numpy(_np(jst), device="cpu")
    jstep = jax.jit(JTS.make_rnn_train_step(jcfg, JOPT.OptConfig(**opt)))
    tstep = TS.make_rnn_train_step(tcfg, OPT.OptConfig(**opt))
    for i in range(3):
        tokens, targets = _tokens(20 + i, 4, 10, jcfg.vocab)
        _, sub = jax.random.split(jst.rng)
        noise = _port_noise(_jax_noise(sub, jst.params))
        jst, jm = jstep(jst, {"tokens": jnp.asarray(tokens),
                              "targets": jnp.asarray(targets)})
        tst, tm = tstep(tst, {"tokens": torch.from_numpy(tokens),
                              "targets": torch.from_numpy(targets)},
                        noise=noise)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), abs=FWD)
    jstate = {"params": jst.params, "opt": jst.opt, "bn_state": jst.bn_state}
    tstate = {"params": tst.params, "opt": tst.opt, "bn_state": tst.bn_state}
    _assert_trees(jstate, tstate, atol=FWD)


def test_step_noise_is_a_function_of_seed_and_step():
    _, tcfg = _cfgs("lstm", "ternary", hidden=16, layers=1)
    var = BL.rnn_lm_init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    st = TS.train_state_init(var["params"], OPT.OptConfig(), 9,
                             bn_state=var["state"])
    a, b = TS.step_noise(st), TS.step_noise(st)
    assert all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    later = st._replace(opt=st.opt._replace(step=st.opt.step + 1))
    other = st._replace(noise_seed=st.noise_seed + 1)
    for s in (later, other):
        assert not torch.equal(TS.step_noise(s)[0][1], a[0][1])


def test_jax_train_state_converts_and_back():
    """A JAX RNN TrainState carries across and back, its gradient
    compression residual too (None when compression is off)."""
    jcfg, _ = _cfgs("gru", "binary", hidden=16, layers=1)
    var = JBL.rnn_lm_init(jax.random.PRNGKey(0), jcfg)
    jst = JTS.train_state_init(var["params"], JOPT.OptConfig(kind="sgd"),
                               jax.random.PRNGKey(1), bn_state=var["state"])
    tst = convert.from_numpy(_np(jst), device="cpu", noise_seed=5)
    assert int(tst.noise_seed) == 5 and tst.opt.v is None
    assert tst.residual is None and tst.opt.step.shape == ()
    back = convert.to_numpy(tst)
    assert back["residual"] is None
    again = jst._replace(params=back["params"], opt=JOPT.OptState(*back["opt"]),
                         bn_state=back["bn_state"])
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jres = jst._replace(residual=jax.tree.map(lambda x: 0.01 * x,
                                              var["params"]))
    tst = convert.from_numpy(_np(jres), device="cpu")
    _assert_trees(jres.residual, tst.residual, rtol=0, atol=0)
    back = convert.to_numpy(tst)
    _assert_trees(jres.residual, convert.from_numpy(back["residual"], "cpu"),
                  rtol=0, atol=0)
    for a, b in zip(jax.tree.leaves(back["residual"]),
                    jax.tree.leaves(jres.residual)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- data ----------------------------------------------------------------------


def test_corpus_and_synthetic_data_are_the_jax_bytes():
    a = SYN.markov_bytes(5000, vocab=50, seed=3)
    np.testing.assert_array_equal(a, JSYN.markov_bytes(5000, vocab=50, seed=3))
    tc = TXT.ByteCorpus.from_bytes(bytes(bytearray(a % 256)))
    jc = JTXT.ByteCorpus.from_bytes(bytes(bytearray(a % 256)))
    assert (tc.vocab, tc.splits) == (jc.vocab, jc.splits)
    for split, step in (("train", 0), ("train", 77), ("valid", 3)):
        tb, jb = tc.batch(split, step, 8, 32), jc.batch(split, step, 8, 32)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(tb[k], jb[k])
    for k, v in SYN.token_stream(4, 3, 9, 50, seed=2).items():
        np.testing.assert_array_equal(v, JSYN.token_stream(4, 3, 9, 50,
                                                           seed=2)[k])
    np.testing.assert_array_equal(SYN.seq_mnist_like(2, 4)["pixels"],
                                  JSYN.seq_mnist_like(2, 4)["pixels"])


def test_prefetcher_yields_steps_in_order_on_the_device():
    corpus = TXT.ByteCorpus.from_bytes(bytes(range(40)) * 50)
    pf = LD.Prefetcher(lambda s: corpus.batch("train", s, 4, 8), 5,
                       torch.device("cpu"))
    try:
        for want in (5, 6, 7, 8):
            step, b = next(pf)
            assert step == want and b["tokens"].dtype == torch.int64
            np.testing.assert_array_equal(
                b["tokens"].numpy(), corpus.batch("train", want, 4, 8)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()
