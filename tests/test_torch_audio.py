"""The port's audio family (whisper-base: an encoder over frame
embeddings, and decoder layers of self-attention, tanh-gated
cross-attention and a GeLU MLP) against the JAX package on the CPU, its
serving runtime and launcher, and the input-shape set of
`configs/shapes.py`.

whisper-base at `reduced()` size: 2 encoder and 2 decoder layers, d_model
64, 4 heads of 16, d_ff 128, vocab 256, fp32, over 40 encoder frames (the
frontend is a stub in both packages: the frames are random embeddings).
JAX's weights are carried across with `repro_torch.convert`, with the
norms, the channel scales, the MLP biases (`bfc1`, `bfc2`) and the
cross-attention gate `xgate` walked off init: at init xgate is 0 and
tanh(0) = 0, so an init tree's cross-attention adds nothing and would go
untested.  Four trees: the fp masters, the masters quantized on the fly
(ternary), and the ternary and binary packed exports.

Tolerances, the dense tests': logits rtol and atol 1e-4; caches (self
and cross k/v) within 1e-5 of their largest magnitude, positions equal;
greedy ids equal; building blocks within 1e-5.
"""
import dataclasses

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
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro.serve import recurrent as JR
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs import shapes as S
from repro_torch.core import quantize as Q
from repro_torch.kernels import dispatch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import recurrent as R
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.kvcache import CrossCache

from test_torch_transformer import _close, _np, _tokens

torch.set_num_threads(1)
TREES = ("fp", "masters", "ternary", "binary")
FRAMES = 40
OFF_INIT = ("xgate", "bfc1", "bfc2")
# packed calls a decode step a decoder layer: Wq, Wk, Wv, Wo; the cross
# attention's Wq and Wo; Wfc1, Wfc2 (the untied head stays fp)
PER_LAYER = 8


def _cfgs(tree: str):
    mode = {"fp": "none", "masters": "ternary"}.get(tree, tree)
    jcfg, tcfg = (j_get_config("whisper-base").reduced(),
                  get_config("whisper-base").reduced())
    if mode == "none":
        return (jcfg.with_quant(JQ.QuantSpec(mode="none")),
                tcfg.with_quant(Q.QuantSpec(mode="none")))
    return (jcfg.with_quant(JQ.QuantSpec(mode=mode, norm="channel")),
            tcfg.with_quant(Q.QuantSpec(mode=mode, norm="channel")))


_MASTERS = []


def _masters():
    """JAX whisper reduced masters, norms, scales, biases and xgate off
    init, made once."""
    if not _MASTERS:
        rng = np.random.default_rng(1)

        def walk(path, a):
            name = getattr(path[-1], "key", "")
            if name == "xgate":
                return a + 0.5 + 0.2 * rng.standard_normal(a.shape).astype(
                    np.float32)
            if name in OFF_INIT or "norm" in name or name.startswith("s"):
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


def _frames(B=2, n=FRAMES, seed=4):
    return (np.random.default_rng(seed).standard_normal((B, n, 64))
            .astype(np.float32))


def _caches_close(tc, jc):
    """Self and cross k/v within 1e-5 of their largest magnitude, positions
    equal."""
    for t, j in zip(tc["stack"] + tc["tail"], jc["stack"] + jc["tail"]):
        pairs = [(t["attn"].k, j["attn"].k), (t["attn"].v, j["attn"].v),
                 (t["cross"].k, j["cross"].k), (t["cross"].v, j["cross"].v)]
        for got, want in pairs:
            want = np.asarray(want)
            assert tuple(got.shape) == want.shape
            err = np.abs(got.numpy() - want).max()
            assert err <= 1e-5 * max(1.0, np.abs(want).max()), err
        assert np.array_equal(t["attn"].pos.numpy(), np.asarray(j["attn"].pos))


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------


def test_shapes_match_jax():
    assert S.SHAPES == {k: S.ShapeSpec(**dataclasses.asdict(v))
                        for k, v in JS.SHAPES.items()}
    for n in (1, 100, 512, 3000, 4096, 32768):
        assert S.whisper_dec_len(n) == JS.whisper_dec_len(n)
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS:
        t, j = get_config(arch), j_get_config(arch)
        for name in S.SHAPES:
            assert S.applicable(t, S.SHAPES[name]) == JS.applicable(
                j, JS.SHAPES[name])
        for n in (16, 1500, 32768):
            assert S.decode_context(t, n) == JS.decode_context(j, n), arch
    assert S.decode_context(get_config("whisper-base"), 1500) == (187, 1500)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def test_sinusoidal_positions_match_jax():
    for seq, d in ((7, 64), (40, 512)):
        _close(L.sinusoidal_positions(seq, d),
               JL.sinusoidal_positions(seq, d), 1e-5)


@pytest.mark.parametrize("tree", ["fp", "ternary"])
def test_gelu_mlp_and_cross_attention_match_jax(tree):
    """Decoder layer 0's GeLU MLP (biases off init; the tanh approximation,
    not torch's exact default) and its cross-attention over a source
    (xgate off init), against JAX's."""
    jp, tp, jcfg, tcfg = _pair(tree)
    jl = jax.tree.map(lambda a: a[0] if not JQT.is_qtensor(a) else
                      JQT.QTensor(codes=a.codes[0], scale=None, k=a.k,
                                  mode=a.mode, alpha=a.alpha),
                      jp["stack"][0], is_leaf=JQT.is_qtensor)
    tl = T._layer_view(tp["stack"][0], 0)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    src = rng.standard_normal((2, 9, 64)).astype(np.float32)
    tm = L.mlp_apply(tl["mlp"], torch.from_numpy(x), tcfg)
    _close(tm, JL.mlp_apply(jl["mlp"], jnp.asarray(x), jcfg), 1e-5)
    assert tl["mlp"]["bfc1"].abs().sum() > 0
    # the two GeLUs differ by up to 5e-4 here, past the 1e-5 held above
    t = torch.linspace(-3.0, 3.0, 13)
    assert (torch.nn.functional.gelu(t) - torch.nn.functional.gelu(
        t, approximate="tanh")).abs().max() > 1e-4
    tx = L.attn_apply(tl["xattn"], torch.from_numpy(x), tcfg, kind="cross",
                      kv_src=torch.from_numpy(src))
    jx = JL.attn_apply(jl["xattn"], jnp.asarray(x), jcfg, kind="cross",
                       kv_src=jnp.asarray(src))
    _close(tx, jx, 1e-5)
    assert float(torch.tanh(tl["xattn"]["xgate"])) != 0.0
    assert tx.abs().max() > 1e-3


@pytest.mark.parametrize("tree", ["fp", "binary"])
def test_run_encoder_matches_jax(tree):
    """The encoder over 40 frames: sinusoidal positions, bidirectional
    self-attention with RoPE, the GeLU MLP, the final norm."""
    jp, tp, jcfg, tcfg = _pair(tree)
    fr = _frames()
    je = JT._run_encoder(JT._serve_quant(jp, jcfg), jnp.asarray(fr), jcfg)
    te = T._run_encoder(T._serve_quant(tp, tcfg), torch.from_numpy(fr), tcfg)
    _close(te, je)
    # not causal: the first frame's output depends on the last frame
    fr2 = fr.copy()
    fr2[:, -1] += 1.0
    te2 = T._run_encoder(T._serve_quant(tp, tcfg), torch.from_numpy(fr2),
                         tcfg)
    assert not torch.equal(te[:, 0], te2[:, 0])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tree", TREES)
def test_forward_matches_jax(tree):
    jp, tp, jcfg, tcfg = _pair(tree)
    toks, fr = _tokens(jcfg.vocab, (2, 12)), _frames()
    jl, _ = JT.forward(jp, jnp.asarray(toks), jcfg, enc_frames=jnp.asarray(fr))
    tl, aux = T.forward(tp, torch.from_numpy(toks), tcfg,
                        enc_frames=torch.from_numpy(fr))
    _close(tl, jl)
    assert float(aux) == 0.0


@pytest.mark.parametrize("tree", TREES)
def test_prefill_then_decode_matches_jax(tree):
    """prefill (the encoder, the cross caches replaced by its k/v at the
    frames' length, 12 decoder tokens) then 4 greedy decode steps over the
    cross caches; caches against JAX's."""
    jp, tp, jcfg, tcfg = _pair(tree)
    toks, fr = _tokens(jcfg.vocab, (2, 12)), _frames()
    jc = JT.init_caches(jcfg, 2, 32, src_len=32)
    tc = T.init_caches(tcfg, 2, 32, src_len=32)
    assert tc["stack"][0]["cross"].k.shape == (2, 2, 32, 4, 16)
    jl, jc = JT.prefill(jp, jnp.asarray(toks), jc, jcfg,
                        enc_frames=jnp.asarray(fr))
    tl, tc = T.prefill(tp, torch.from_numpy(toks), tc, tcfg,
                       enc_frames=torch.from_numpy(fr))
    _close(tl, jl)
    _caches_close(tc, jc)
    assert tc["stack"][0]["cross"].k.shape == (2, 2, FRAMES, 4, 16)
    cross = tc["stack"][0]["cross"]
    dispatch.reset_counts()
    for _ in range(4):
        nxt = np.argmax(np.asarray(jl)[:, :jcfg.vocab], -1).astype(np.int32)
        assert np.array_equal(nxt, tl[:, :tcfg.vocab].argmax(-1).numpy())
        jl, jc = JT.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
        tl, tc = T.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
        _close(tl, jl)
    _caches_close(tc, jc)
    # a decode step reads the cross cache and leaves it where it was
    assert tc["stack"][0]["cross"] is cross
    if tree in ("ternary", "binary"):
        assert dict(dispatch.PLAIN_CALLS) == {
            "packed_gemv": 4 * PER_LAYER * tcfg.n_layers}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _runtime(tree="ternary", B=2):
    _, tp, _, tcfg = _pair(tree)
    return R.serving_runtime(tcfg, tp, device="cpu",
                             extras={"enc_frames": torch.from_numpy(
                                 _frames(B))})


def test_runtime_replaces_the_cross_cache_and_matches_jax():
    """`init_state` sizes the zero cross cache from `decode_context` (the
    context's length); every prefill runs the encoder and replaces the
    cache with k/v at the frames' length, never writing into the zero
    buffer; a session through the runtime matches JAX's runtime."""
    rt = _runtime()
    st = rt.init_state(2, 24)
    zero = st["stack"][0]["cross"]
    assert zero.k.shape == (2, 2, 24, 4, 16)
    toks = _tokens(rt.cfg.vocab, (2, 6))
    lg, st = rt.prefill(torch.from_numpy(toks), st)
    assert st["stack"][0]["cross"].k.shape == (2, 2, FRAMES, 4, 16)
    assert not zero.k.any() and not zero.v.any()
    again = st["stack"][0]["cross"].k.clone()
    lg2, st = rt.prefill(torch.from_numpy(toks[:, :1]), st)
    assert torch.equal(st["stack"][0]["cross"].k, again)
    jp, _, jcfg, _ = _pair("ternary")
    jrt = JR.TransformerRuntime(jcfg, jp, extras={
        "enc_frames": jnp.asarray(_frames(2))})
    jst = jrt.init_state(2, 24)
    jlg, jst = jrt.prefill(jnp.asarray(toks), jst)
    _close(lg, jlg)
    jlg2, _ = jrt.prefill(jnp.asarray(toks[:, :1]), jst)
    _close(lg2, jlg2)


def test_lockstep_session_and_draft_keep_extras():
    rt = _runtime("fp")
    out, m = R.drive_session(rt, torch.from_numpy(_tokens(256, (2, 6))),
                             rt.cfg.vocab, gen=5, temperature=0.0)
    assert out.shape == (2, 5) and m["state_nbytes"] > 0
    draft = R.speculative_draft(rt)
    assert draft.extras["enc_frames"] is rt.extras["enc_frames"]
    assert draft.cfg.quant.mode == "ternary"


def test_engine_refuses_extras_with_jax_reason():
    """Both engines refuse a runtime with a cross-attention source: the
    continuous-batching pool would need per-request encodings."""
    rt = _runtime()
    with pytest.raises(NotImplementedError,
                       match="needs per-request source encodings"):
        ServeEngine(rt, rt.cfg.vocab, slots=2, max_context=16)
    jp, _, jcfg, _ = _pair("ternary")
    jrt = JR.TransformerRuntime(jcfg, jp, extras={"enc_frames": None})
    with pytest.raises(NotImplementedError,
                       match="needs per-request source encodings"):
        JE.ServeEngine(jrt, jcfg.vocab, slots=2, max_context=16)


def test_convert_carries_cross_cache():
    """A JAX whisper cache tree (self `AttnCache`s and `CrossCache`s after a
    prefill) becomes the port's, and decoding from it matches JAX's."""
    jp, tp, jcfg, tcfg = _pair("ternary")
    jc = JT.init_caches(jcfg, 2, 16, src_len=16)
    _, jc = JT.prefill(jp, jnp.asarray(_tokens(jcfg.vocab, (2, 5))), jc,
                       jcfg, enc_frames=jnp.asarray(_frames()))
    tc = convert.from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    assert isinstance(tc["stack"][0]["cross"], CrossCache)
    assert tc["stack"][0]["cross"].k.shape == (2, 2, FRAMES, 4, 16)
    nxt = np.array([3, 7], np.int32)
    jl, _ = JT.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
    tl, _ = T.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
    _close(tl, jl)


def test_launcher_serves_whisper_reduced(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "whisper-base", "--reduced", "--device",
                      "cpu", "--gen", "4", "--prompt-len", "8", "--batch",
                      "2"])
    assert out.shape == (2, 4)
    assert "transformer family, cpu" in capsys.readouterr().out
    with pytest.raises(NotImplementedError,
                       match="needs per-request source encodings"):
        serve.main(["--arch", "whisper-base", "--device", "cpu",
                    "--traffic", "--requests", "2"])


def test_vlm_is_still_refused():
    """The VLM is ported now (`model_init`, its runtime, lockstep serving);
    what is still refused, as for whisper, is its engine: a runtime with
    a cross-attention source, with JAX's reason."""
    from repro_torch.launch import serve
    cfg = get_config("llama-3.2-vision-90b").reduced()
    T.check_ported(cfg)
    params = T.model_init(torch.Generator().manual_seed(0), cfg)
    img = torch.randn((2, cfg.n_img_tokens, cfg.d_model))
    rt = R.serving_runtime(cfg, params, extras={"img": img}, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="needs per-request source encodings"):
        ServeEngine(rt, cfg.vocab, slots=2, max_context=16)
    with pytest.raises(NotImplementedError,
                       match="needs per-request source encodings"):
        serve.main(["--arch", "llama-3.2-vision-90b", "--device", "cpu",
                    "--traffic", "--requests", "2"])
