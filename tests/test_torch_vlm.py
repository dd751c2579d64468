"""The port's vlm family (llama-3.2-vision: four causal `self` layers,
then a `cross` layer that attends over the image tokens through a
tanh(xgate)-gated cross-attention in place of a self-attention) against
the JAX package on the CPU, its serving runtime and launcher, and the
input stand-ins of `configs/shapes.py`.

llama-3.2-vision-90b at `reduced()` size: one repeat of 4 self layers and
1 cross layer, d_model 64, 4 heads of 16, 2 KV heads, d_ff 128, vocab 256,
16 image tokens, fp32 (the vision tower is a stub in both packages: the
image tokens are random embeddings).  JAX's weights are carried across
with `repro_torch.convert`, the norms, channel scales and `xgate` walked
off init (at init tanh(xgate) = 0 and the cross layer would add nothing).
Four trees: the fp masters, the masters quantized on the fly (ternary),
and the ternary and binary packed exports.

Tolerances, the dense tests': logits rtol and atol 1e-4; caches (self
and cross k/v) within 1e-5 of their largest magnitude, positions equal;
greedy ids equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import shapes as JS
from repro.core import qtensor as JQT
from repro.core import quantize as JQ
from repro.models import transformer as JT
from repro.serve import recurrent as JR
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs import shapes as S
from repro_torch.core import quantize as Q
from repro_torch.core.qtensor import QTensor, export_packed, tree_paths
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as T
from repro_torch.serve import recurrent as R
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import CrossCache

from test_torch_transformer import _close, _np, _tokens

torch.set_num_threads(1)
ARCH = "llama-3.2-vision-90b"
TREES = ("fp", "masters", "ternary", "binary")
N_IMG = 16
# packed calls a decode step: Wq, Wk, Wv, Wo, Wgate, Wup, Wdown a self
# layer; the cross layer's Wq, Wo and its MLP's three (the head stays fp)
DECODE_PACKED = 4 * 7 + 5
# and attention's two products a layer (`ordered_bmm`), self and cross
DECODE_ORDERED = 2 * 5


def _cfgs(tree: str):
    mode = {"fp": "none", "masters": "ternary"}.get(tree, tree)
    jcfg, tcfg = j_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    if mode == "none":
        return (jcfg.with_quant(JQ.QuantSpec(mode="none")),
                tcfg.with_quant(Q.QuantSpec(mode="none")))
    return (jcfg.with_quant(JQ.QuantSpec(mode=mode, norm="channel")),
            tcfg.with_quant(Q.QuantSpec(mode=mode, norm="channel")))


_MASTERS = []


def _masters():
    """JAX VLM reduced masters, norms, scales and xgate off init, made
    once."""
    if not _MASTERS:
        rng = np.random.default_rng(1)

        def walk(path, a):
            name = getattr(path[-1], "key", "")
            if name == "xgate":
                return a + 0.5 + 0.2 * rng.standard_normal(a.shape).astype(
                    np.float32)
            if "norm" in name or name.startswith("s"):
                return a + 0.2 * rng.standard_normal(a.shape).astype(
                    np.float32)
            return a
        p = JT.model_init(jax.random.PRNGKey(0), _cfgs("masters")[0])
        _MASTERS.append(jax.tree_util.tree_map_with_path(walk, p))
    return _MASTERS[0]


def _pair(tree: str):
    jcfg, tcfg = _cfgs(tree)
    jp = _masters()
    if tree in ("ternary", "binary"):
        jp = JQT.export_packed(jp, jcfg.quant)
    return jp, convert.from_numpy(_np(jp), "cpu"), jcfg, tcfg


def _img(B=2, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (B, N_IMG, 64)).astype(np.float32)


def _caches_close(tc, jc):
    """Self k/v and the cross caches within 1e-5 of their largest
    magnitude; positions equal."""
    for c, j in zip(tc["stack"] + tc["tail"], jc["stack"] + jc["tail"]):
        assert set(c) == set(j)
        pairs = []
        if "attn" in c:
            pairs += [(c["attn"].k, j["attn"].k), (c["attn"].v, j["attn"].v)]
            assert np.array_equal(c["attn"].pos.numpy(),
                                  np.asarray(j["attn"].pos))
        if "cross" in c:
            pairs += [(c["cross"].k, j["cross"].k),
                      (c["cross"].v, j["cross"].v)]
        for got, want in pairs:
            want = np.asarray(want)
            err = np.abs(got.numpy() - want).max()
            assert err <= 1e-5 * max(1.0, np.abs(want).max()), err


def test_pattern_params_and_caches_have_jax_layout():
    """The port's VLM tree and caches have JAX's paths and shapes: 4 self
    layers with a kv cache each, a cross layer with xgate and a cross
    cache of the image tokens' length."""
    jcfg, tcfg = _cfgs("masters")
    assert T.expand_pattern(tcfg) == (("self",) * 4 + ("cross",), 1, ())
    T.check_ported(tcfg)
    jp = JT.model_init(jax.random.PRNGKey(0), jcfg)
    tp = T.model_init(torch.Generator().manual_seed(0), tcfg)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = tree_paths(tp)
    assert [JQ.path_str(p) for p, _ in jl] == ["/".join(p) for p, _ in tl]
    for (_, j), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == tuple(j.shape)
    assert "xgate" in tp["stack"][4]["attn"] and float(
        tp["stack"][4]["attn"]["xgate"].abs().sum()) == 0
    jc = JT.init_caches(jcfg, 2, 16, src_len=N_IMG)
    tc = T.init_caches(tcfg, 2, 16, src_len=N_IMG)
    assert set(tc["stack"][4]) == {"cross"}
    assert tc["stack"][4]["cross"].k.shape == (1, 2, N_IMG, 2, 16)
    for c, j in zip(tc["stack"], jc["stack"]):
        assert set(c) == set(j)
        for key, cache in c.items():
            for name in ("k", "v"):
                assert (tuple(getattr(cache, name).shape)
                        == tuple(getattr(j[key], name).shape))


@pytest.mark.parametrize("tree", TREES)
def test_forward_matches_jax(tree):
    jp, tp, jcfg, tcfg = _pair(tree)
    toks, img = _tokens(jcfg.vocab, (2, 12)), _img()
    jl, _ = JT.forward(jp, jnp.asarray(toks), jcfg, img=jnp.asarray(img))
    with torch.no_grad():
        tl, _ = T.forward(tp, torch.from_numpy(toks), tcfg,
                          img=torch.from_numpy(img))
    _close(tl, jl)
    with pytest.raises(ValueError, match="image tokens"):
        T.forward(tp, torch.from_numpy(toks), tcfg)


@pytest.mark.parametrize("tree", TREES)
def test_prefill_then_decode_matches_jax(tree):
    """A prefill fills the cross caches from the image tokens once; decode
    steps read them; logits, caches and greedy ids against JAX's."""
    jp, tp, jcfg, tcfg = _pair(tree)
    prompt, img = _tokens(jcfg.vocab, (2, 7)), _img()
    jc = JT.init_caches(jcfg, 2, 16, src_len=N_IMG)
    tc = T.init_caches(tcfg, 2, 16, src_len=N_IMG)
    jl, jc = JT.prefill(jp, jnp.asarray(prompt), jc, jcfg,
                        img=jnp.asarray(img))
    with torch.no_grad():
        tl, tc = T.prefill(tp, torch.from_numpy(prompt), tc, tcfg,
                           img=torch.from_numpy(img))
        _close(tl, jl)
        _caches_close(tc, jc)
        cross = tc["stack"][4]["cross"]
        for _ in range(3):
            nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            assert np.array_equal(torch.argmax(tl, -1).numpy(), nxt)
            jl, jc = JT.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
            tl, tc = T.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
            _close(tl, jl)
        _caches_close(tc, jc)
        assert tc["stack"][4]["cross"] is cross  # decode keeps it


def test_packed_model_init_equals_export_of_masters():
    """`model_init(packed=True)` builds the VLM a layer at a time: the same
    tree as `export_packed(model_init(...))`, bit for bit."""
    _, tcfg = _cfgs("ternary")
    full = export_packed(T.model_init(torch.Generator().manual_seed(3), tcfg),
                         tcfg.quant)
    layered = T.model_init(torch.Generator().manual_seed(3), tcfg,
                           packed=True)
    a, b = tree_paths(full), tree_paths(layered)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (_, x), (_, y) in zip(a, b):
        if isinstance(x, QTensor):
            assert torch.equal(x.codes, y.codes) and x.alpha == y.alpha
        else:
            assert torch.equal(x, y)


def test_convert_carries_the_cross_caches():
    """A JAX VLM cache tree after a prefill becomes the port's, and
    decoding from it matches JAX's."""
    jp, tp, jcfg, tcfg = _pair("ternary")
    jc = JT.init_caches(jcfg, 2, 16, src_len=N_IMG)
    _, jc = JT.prefill(jp, jnp.asarray(_tokens(jcfg.vocab, (2, 5))), jc,
                       jcfg, img=jnp.asarray(_img()))
    tc = convert.from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    assert isinstance(tc["stack"][4]["cross"], CrossCache)
    nxt = np.array([3, 7], np.int32)
    jl, _ = JT.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
    with torch.no_grad():
        tl, _ = T.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
    _close(tl, jl)


def _runtime(tree="ternary"):
    _, tp, _, tcfg = _pair(tree)
    return R.serving_runtime(tcfg, tp, extras={"img": torch.from_numpy(
        _img())}, device="cpu")


def test_runtime_matches_jax_and_counts_packed_calls():
    """The serving runtime with the image tokens as its `extras`: prefill
    and decode logits against JAX's runtime, one packed call a projection
    a decode step, and the engine's refusal of a runtime with extras,
    with JAX's reason."""
    jp, _, jcfg, _ = _pair("ternary")
    rt = _runtime()
    assert rt.init_state(2, 24)["stack"][4]["cross"].k.shape[2] == N_IMG
    jrt = JR.TransformerRuntime(jcfg, jp,
                                extras={"img": jnp.asarray(_img())})
    toks = _tokens(jcfg.vocab, (2, 6))
    with torch.no_grad():
        lg, st = rt.prefill(torch.from_numpy(toks), rt.init_state(2, 24))
        jlg, jst = jrt.prefill(jnp.asarray(toks), jrt.init_state(2, 24))
        _close(lg, jlg)
        nxt = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
        dispatch.reset_counts()
        lg, _ = rt.decode_step(torch.from_numpy(nxt), st)
        jlg, _ = jrt.decode_step(jnp.asarray(nxt), jst)
    _close(lg, jlg)
    assert dict(dispatch.PLAIN_CALLS) == {"packed_gemv": DECODE_PACKED,
                                          "ordered_bmm": DECODE_ORDERED}
    with pytest.raises(NotImplementedError,
                       match="needs per-request source encodings"):
        ServeEngine(rt, rt.cfg.vocab, slots=2, max_context=16)


def test_lockstep_session_and_draft_keep_extras():
    rt = _runtime("fp")
    out, m = R.drive_session(rt, torch.from_numpy(_tokens(256, (2, 6))),
                             rt.cfg.vocab, gen=5, temperature=0.0)
    assert out.shape == (2, 5) and m["state_nbytes"] > 0
    draft = R.speculative_draft(rt)
    assert draft.extras["img"] is rt.extras["img"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_stand_ins_match_jax(arch):
    """token_batch, prefill_inputs and decode_inputs: JAX's keys, shapes
    and dtypes, as tensors on the meta device."""
    assert ARCH_IDS == J_ARCH_IDS
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for j, t in ((JS.token_batch(jcfg, 2, 4096), S.token_batch(tcfg, 2, 4096)),
                 (JS.prefill_inputs(jcfg, 1, 2048),
                  S.prefill_inputs(tcfg, 1, 2048)),
                 (JS.decode_inputs(jcfg, 8), S.decode_inputs(tcfg, 8))):
        assert set(j) == set(t)
        for k in j:
            assert t[k].device.type == "meta"
            assert tuple(t[k].shape) == tuple(j[k].shape)
            assert str(t[k].dtype).split(".")[-1] == str(j[k].dtype)


def test_launcher_serves_the_vlm_reduced(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--gen", "4", "--prompt-len", "8", "--batch", "2"])
    assert out.shape == (2, 4)
    text = capsys.readouterr().out
    assert "transformer family, cpu" in text and "packed(ternary)" in text
    with pytest.raises(NotImplementedError,
                       match="needs per-request source encodings"):
        serve.main(["--arch", ARCH, "--device", "cpu", "--traffic",
                    "--requests", "2"])
