"""Parity of the port's quantization core with the JAX package, on the CPU.

Same seeded numpy inputs through `repro` and `repro_torch`:
  * pack/unpack and `QTensor.from_master` codes are WORD-equal (the port
    carries the uint32 words as int32 bit-views);
  * the quantizers agree exactly for the same noise `u` (both are a clip, a
    compare and a select in fp32, so there is nothing to round differently);
  * recurrent BN in train and eval mode agrees to 1e-6 (fp32 mean and
    population variance over a batch of 16, summed in another order);
  * sizes, policies, the STE gradient and `convert` round trips.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bnlstm as JBL
from repro.core import qtensor as JQT
from repro.core import quantize as JQ
from repro.core import recurrent_bn as JBN
from repro_torch import convert
from repro_torch.core import bnlstm as BL
from repro_torch.core import qtensor as QT
from repro_torch.core import quantize as Q
from repro_torch.core import recurrent_bn as BN

torch.set_num_threads(1)


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _jax_to_numpy(tree):
    """A JAX tree as numpy, packed leaves as the dicts `convert` takes."""
    def leaf(l):
        if JQT.is_qtensor(l):
            return {"codes": np.asarray(l.codes), "k": l.k, "mode": l.mode,
                    "alpha": l.alpha, "scale": None}
        return np.asarray(l)
    return jax.tree.map(leaf, tree, is_leaf=JQT.is_qtensor)


@pytest.mark.parametrize("mode,group", [("ternary", 16), ("binary", 32)])
def test_pack_unpack_word_equal(mode, group):
    rng = np.random.default_rng(0)
    vals = (rng.integers(-1, 2, (4 * group, 24)) if mode == "ternary"
            else rng.choice([-1, 1], (4 * group, 24))).astype(np.float32)
    jpack, jun = ((JQ.pack_ternary, JQ.unpack_ternary) if mode == "ternary"
                  else (JQ.pack_binary, JQ.unpack_binary))
    pack, unpack = ((Q.pack_ternary, Q.unpack_ternary) if mode == "ternary"
                    else (Q.pack_binary, Q.unpack_binary))
    jw = np.asarray(jpack(jnp.asarray(vals)))
    tw = pack(torch.from_numpy(vals))
    assert jw.dtype == np.uint32 and tw.dtype == torch.int32
    np.testing.assert_array_equal(_words(tw), jw)
    # the top code of the word (bit 31) is set somewhere: the sign bit of
    # the int32 view must survive the shift/mask decode
    assert (jw >> 31).any()
    np.testing.assert_array_equal(unpack(tw, 4 * group).numpy(),
                                  np.asarray(jun(jnp.asarray(jw), 4 * group)))
    np.testing.assert_array_equal(unpack(tw, 4 * group).numpy(), vals)


def test_ternary_unused_code_two_decodes_to_zero():
    words = np.array([[0b10 | (0b01 << 2) | (0b11 << 4)]], np.uint32)
    t = Q.unpack_ternary(torch.from_numpy(words.view(np.int32)), 16)
    j = JQ.unpack_ternary(jnp.asarray(words), 16)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t[:3, 0].tolist() == [0.0, 1.0, -1.0]


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("mode", ["ternary", "binary"])
def test_quantizers_agree_for_same_u(mode, stochastic):
    rng = np.random.default_rng(1)
    alpha = 0.07
    w = (rng.normal(size=(64, 48)) * 0.06).astype(np.float32)
    w[0, :4] = [0.0, alpha / 2, -alpha / 2, 1.5 * alpha]  # ties and clips
    u = rng.uniform(size=w.shape).astype(np.float32)
    j = JQ.quantize(jnp.asarray(w), mode, alpha, jnp.asarray(u),
                    stochastic=stochastic)
    t = Q.quantize(torch.from_numpy(w), mode, alpha, torch.from_numpy(u),
                   stochastic=stochastic)
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))


def test_rounding_is_half_to_even_and_sign_zero_is_plus():
    alpha = 0.5
    w = torch.tensor([[0.25, -0.25, 0.75, 0.0]]).T.contiguous()  # w/alpha = ±.5
    assert Q.ternarize_deterministic(w, alpha)[:, 0].tolist() == \
        [0.0, -0.0, 0.5, 0.0]
    assert Q.binarize_deterministic(w, alpha)[:, 0].tolist()[-1] == 0.5


def test_ste_gradient_is_identity_to_master():
    w = torch.randn(8, 8, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    c = torch.randn(8, 8, generator=torch.Generator().manual_seed(1))
    q = Q.quantize(w, "ternary", 0.5, stochastic=False)
    (q * c).sum().backward()
    jg = jax.grad(lambda a: jnp.sum(
        JQ.quantize(a, "ternary", 0.5, stochastic=False) * c.numpy()))(
            jnp.asarray(w.detach().numpy()))
    np.testing.assert_array_equal(w.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(w.grad.numpy(), c.numpy())


@pytest.mark.parametrize("shape", [(64, 40), (40, 160), (3, 136, 96)])
@pytest.mark.parametrize("mode", ["ternary", "binary"])
def test_qtensor_from_master_word_equal(mode, shape):
    rng = np.random.default_rng(2)
    alpha = JQ.leaf_alpha(shape)
    w = rng.uniform(-alpha, alpha, shape).astype(np.float32)
    jqt = JQT.QTensor.from_master(jnp.asarray(w), mode)
    tqt = QT.QTensor.from_master(torch.from_numpy(w), mode)
    assert tqt.alpha == jqt.alpha and tqt.k == jqt.k
    assert tqt.shape == tuple(jqt.shape) and tqt.nbytes == jqt.nbytes
    np.testing.assert_array_equal(_words(tqt.codes), np.asarray(jqt.codes))
    np.testing.assert_array_equal(tqt.dequantize().numpy(),
                                  np.asarray(jqt.dequantize()))
    assert QT.analytic_nbytes(shape, mode) == JQT.analytic_nbytes(shape, mode)
    assert Q.packed_nbytes(shape, mode) == JQ.packed_nbytes(shape, mode)


@pytest.mark.parametrize("mode", ["ternary", "binary"])
def test_export_packed_rnn_word_equal(mode):
    """The same masters exported by both packages give the same words, and
    carrying the JAX export across with `convert` gives them again."""
    jcfg = JBL.RNNConfig(vocab=50, d_hidden=40, n_layers=2,
                         quant=JQ.QuantSpec(mode=mode, norm="batch"))
    tcfg = BL.RNNConfig(vocab=50, d_hidden=40, n_layers=2,
                        quant=Q.QuantSpec(mode=mode, norm="batch"))
    jvar = JBL.rnn_lm_init(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jvar["params"])
    tparams = convert.from_numpy(np_params, "cpu")
    jexp = JBL.export_packed_rnn(jvar["params"], jcfg)
    texp = BL.export_packed_rnn(tparams, tcfg)
    carried = convert.from_numpy(_jax_to_numpy(jexp), "cpu")
    for l in range(2):
        for name in ("wx", "wh"):
            jw = np.asarray(jexp["layers"][l][name].codes)
            np.testing.assert_array_equal(_words(texp["layers"][l][name].codes), jw)
            np.testing.assert_array_equal(
                _words(carried["layers"][l][name].codes), jw)
        assert isinstance(texp["layers"][l]["bn_h"], BN.BNParams)
    assert not QT.is_qtensor(texp["head"]["ws"])
    assert QT.tree_nbytes(texp) == JQT.tree_nbytes(jexp)
    # the train -> serve handoff: packed masters plus the BN running stats
    tstate = convert.from_numpy(jax.tree.map(np.asarray, jvar["state"]), "cpu")
    served = BL.serving_variables(tparams, tstate, tcfg)
    assert served["state"] is tstate
    np.testing.assert_array_equal(
        _words(served["params"]["layers"][0]["wx"].codes),
        np.asarray(jexp["layers"][0]["wx"].codes))
    assert isinstance(served["state"]["layers"][1]["bn_c"], BN.BNState)
    np.testing.assert_array_equal(
        convert.to_numpy(texp)["layers"][1]["wh"]["codes"],
        np.asarray(jexp["layers"][1]["wh"].codes))


@pytest.mark.parametrize("training", [True, False])
def test_bn_apply_matches(training):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 24)).astype(np.float32) * 3 + 1
    phi = rng.uniform(0.05, 0.2, 24).astype(np.float32)
    gamma = rng.normal(size=24).astype(np.float32) * 0.1
    mean = rng.normal(size=24).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 24).astype(np.float32)
    jy, js = JBN.bn_apply(jnp.asarray(x), JBN.BNParams(jnp.asarray(phi), jnp.asarray(gamma)),
                          JBN.BNState(jnp.asarray(mean), jnp.asarray(var), jnp.float32(3)),
                          training=training)
    t = lambda a: torch.from_numpy(a)
    ty, ts = BN.bn_apply(t(x), BN.BNParams(t(phi), t(gamma)),
                         BN.BNState(t(mean), t(var), torch.tensor(3.0)),
                         training=training)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    p, s = BN.bn_init(5)
    jp, jst = JBN.bn_init(5)
    np.testing.assert_array_equal(p.phi.numpy(), np.asarray(jp.phi))
    np.testing.assert_array_equal(s.var.numpy(), np.asarray(jst.var))


def test_quant_policy_and_spec_match():
    pairs = [("wx", "layers/0/wx", 2), ("wh", "layers/0/wh", 2),
             ("ws", "head/ws", 2), ("b", "layers/0/b", 1), ("Wq", "a/Wq", 2),
             ("embed", "embed", 2)]
    for inc, exc, extra in [(("wx", "wh"), (), ()), (("W*",), ("Wq",), ()),
                            (("W*",), (), ("embed",)), (("*/ws",), (), ())]:
        jp = JQ.QuantPolicy(include=inc, exclude=exc, extra=extra)
        tp = Q.QuantPolicy(include=inc, exclude=exc, extra=extra)
        for name, path, nd in pairs:
            assert tp.matches_name(name, path, nd) == \
                jp.matches_name(name, path, nd), (inc, name)
    for mode in ("none", "binary", "ternary"):
        assert Q.QuantSpec(mode=mode).weight_bits == \
            JQ.QuantSpec(mode=mode).weight_bits
    assert Q.glorot_alpha(1000, 4000) == JQ.glorot_alpha(1000, 4000)
    assert Q.leaf_alpha((7,)) == JQ.leaf_alpha((7,))
