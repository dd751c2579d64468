"""The port's dense transformer family against the JAX package on the CPU.

The same numpy inputs and weights go through `repro.models.transformer`
and `repro_torch.models.transformer` at `reduced()` size (d_model 64,
4 heads of 16, 2 KV heads, vocab 256, fp32) for the four dense archs:
qwen3-0.6b, qwen3-1.7b, llama3-8b and gemma3-27b (its 5:1 local:global
pattern over ring caches, window 16).  JAX's weights are carried across
with `repro_torch.convert`, the norm scales and the channel-scale
companions walked off init so that they matter.  Four trees each: the fp
masters (quant none), the masters quantized on the fly (ternary), and the
ternary and binary packed exports; JAX runs its packed leaves through its
CPU dequantize fallback, the port through the packed kernels' plain
versions.

Tolerances: logits rtol 1e-4 and atol 1e-4; caches within 1e-5 of their
largest magnitude (k/v reach about 3); greedy ids equal.  The gaps are
fp32 summation in another order (the port's attention and dequantized
products in torch's library calls, JAX's in XLA's): about 1e-6 a layer, and a deep layer's k/v carry the error of the layers
below it, up to 1.7e-5 absolute at gemma3's sixth layer, binary.  Building blocks (rms_norm, rope, attention)
within 1e-5.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.core import qlinear as JQL
from repro.core import qtensor as JQT
from repro.core import quantize as JQ
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import qlinear as QL
from repro_torch.core import quantize as Q
from repro_torch.core.qtensor import QTensor, export_packed
from repro_torch.kernels import dispatch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

torch.set_num_threads(1)
DENSE = ("qwen3-0.6b", "qwen3-1.7b", "llama3-8b", "gemma3-27b")
TREES = ("fp", "masters", "ternary", "binary")


def _np(tree):
    """A JAX tree as numpy, packed leaves as `convert`'s dicts."""
    def leaf(l):
        if JQT.is_qtensor(l):
            return {"codes": np.asarray(l.codes), "k": l.k, "mode": l.mode,
                    "alpha": l.alpha,
                    "scale": None if l.scale is None else np.asarray(l.scale)}
        return np.asarray(l)
    return jax.tree.map(leaf, tree, is_leaf=JQT.is_qtensor)


def _cfgs(arch: str, tree: str):
    """(JAX cfg, port cfg) at reduced size for one of TREES."""
    mode = {"fp": "none", "masters": "ternary"}.get(tree, tree)
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    if mode == "none":
        return (jcfg.with_quant(JQ.QuantSpec(mode="none")),
                tcfg.with_quant(Q.QuantSpec(mode="none")))
    return (jcfg.with_quant(JQ.QuantSpec(mode=mode, norm="channel")),
            tcfg.with_quant(Q.QuantSpec(mode=mode, norm="channel")))


_MASTERS = {}


def _masters(arch: str):
    """JAX masters (channel-scaled, off init), made once per arch."""
    if arch not in _MASTERS:
        jcfg, _ = _cfgs(arch, "masters")
        p = JT.model_init(jax.random.PRNGKey(0), jcfg)
        rng = np.random.default_rng(1)

        def walk(path, a):  # norm scales and s<W> companions off init
            name = getattr(path[-1], "key", "")
            if "norm" in name or name.startswith("s"):
                return a + 0.2 * rng.standard_normal(a.shape).astype(np.float32)
            return a
        _MASTERS[arch] = jax.tree_util.tree_map_with_path(walk, p)
    return _MASTERS[arch]


def _pair(arch: str, tree: str):
    """(JAX params, port params, JAX cfg, port cfg) for one tree."""
    jcfg, tcfg = _cfgs(arch, tree)
    jp = _masters(arch)
    if tree in ("ternary", "binary"):
        jp = JQT.export_packed(jp, jcfg.quant)
    return jp, convert.from_numpy(_np(jp), "cpu"), jcfg, tcfg


def _tokens(vocab, shape, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(
        np.int32)


def _close(t, j, tol=1e-4):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol,
                               atol=tol)


def _caches_close(tc, jc):
    """Every k/v within 1e-5 of the cache's largest magnitude (at least 1);
    positions and ring flags equal."""
    for i, c in enumerate(tc["stack"] + tc["tail"]):
        j = (jc["stack"] + jc["tail"])[i]["attn"]
        for got, want in ((c["attn"].k, j.k), (c["attn"].v, j.v)):
            want = np.asarray(want)
            err = np.abs(got.numpy() - want).max()
            assert err <= 1e-5 * max(1.0, np.abs(want).max()), err
        assert np.array_equal(c["attn"].pos.numpy(), np.asarray(j.pos))
        assert c["attn"].ring == j.ring


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_every_arch_config_matches_jax():
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS:
        for t, j in ((get_config(arch), j_get_config(arch)),
                     (get_config(arch).reduced(), j_get_config(arch).reduced())):
            tj, jj = dataclasses.asdict(t), dataclasses.asdict(j)
            for k, v in tj.items():
                if k == "quant":
                    assert v["mode"] == jj[k]["mode"] and v["norm"] == jj[k]["norm"]
                else:
                    assert v == jj[k], (arch, k)
            assert (t.hd, t.padded_vocab) == (j.hd, j.padded_vocab)


def test_qwen3_0_6b_is_the_published_width():
    c = get_config("qwen3-0.6b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv, c.hd, c.d_ff, c.vocab,
            c.qk_norm, c.rope_theta, c.tie_embeddings, c.quant.mode,
            c.quant.norm, c.torch_dtype) == (
        28, 1024, 16, 8, 128, 3072, 151936, True, 1e6, True, "ternary",
        "channel", torch.bfloat16)


# ---------------------------------------------------------------------------
# qlinear and export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["none", "ternary", "binary", "twn"])
def test_quantize_tree_serving_branch_matches_jax(mode):
    jp = _masters("qwen3-0.6b")
    tp = convert.from_numpy(_np(jp), "cpu")
    jspec = JQ.QuantSpec(mode=mode, norm="channel", stochastic=False)
    tspec = Q.QuantSpec(mode=mode, norm="channel", stochastic=False)
    jq = JQL.quantize_tree(jp, jspec, None)
    tq = QL.quantize_tree(tp, tspec)
    jl = jax.tree_util.tree_leaves_with_path(jq)
    from repro_torch.core.qtensor import tree_paths
    tl = tree_paths(tq)
    assert len(jl) == len(tl)
    for (_, j), (_, t) in zip(jl, tl):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    bf = QL.quantize_tree(tp, tspec, compute_dtype=torch.bfloat16)
    assert bf["stack"][0]["attn"]["Wq"].dtype == torch.bfloat16
    assert bf["stack"][0]["attn"]["sq"].dtype == torch.float32
    # the training branch: a stochastic spec samples with the noise JAX
    # folds in per leaf (crc32 of its path), to JAX's values and dtype
    key = jax.random.PRNGKey(4)
    noise = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        name = JQ.path_str(path)
        if jspec.policy().matches(path, leaf):
            k = jax.random.fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)
            noise[name] = torch.from_numpy(np.array(
                jax.random.uniform(k, leaf.shape, leaf.dtype)))
    js = JQL.quantize_tree(jp, dataclasses.replace(jspec, stochastic=True),
                           key, compute_dtype=jnp.bfloat16)
    ts = QL.quantize_tree(tp, dataclasses.replace(tspec, stochastic=True),
                          compute_dtype=torch.bfloat16, noise=noise)
    for (_, j), (_, t) in zip(jax.tree_util.tree_leaves_with_path(js),
                              tree_paths(ts)):
        assert np.array_equal(t.float().numpy(),
                              np.asarray(j).astype(np.float32))
        assert str(t.dtype).split(".")[-1] == str(j.dtype)


def test_stacked_leaves_export_like_jax():
    """A stacked (L, K, N) master packs to codes (L, K/G, N) word for word,
    alpha from its last two axes; `embed` stays fp; the `s<W>` companions
    pass through to `scaled`."""
    jp = _masters("qwen3-0.6b")
    tp = convert.from_numpy(_np(jp), "cpu")
    for mode in ("ternary", "binary"):
        jx = JQT.export_packed(jp, JQ.QuantSpec(mode=mode, norm="channel"))
        tx = export_packed(tp, Q.QuantSpec(mode=mode, norm="channel"))
        for name in ("Wq", "Wk", "Wo"):
            j, t = jx["stack"][0]["attn"][name], tx["stack"][0]["attn"][name]
            assert isinstance(t, QTensor) and t.codes.dim() == 3
            assert np.array_equal(t.codes.numpy().view(np.uint32),
                                  np.asarray(j.codes))
            assert (t.k, t.alpha, t.mode) == (j.k, j.alpha, j.mode)
            assert t.alpha == Q.leaf_alpha(tp["stack"][0]["attn"][name].shape)
        assert not isinstance(tx["embed"], QTensor)
        assert torch.equal(tx["stack"][0]["attn"]["sq"],
                           tp["stack"][0]["attn"]["sq"])
    y = torch.ones(2, 3)
    spec = Q.QuantSpec(mode="ternary", norm="channel")
    assert torch.equal(QL.scaled(y, {"sq": torch.full((3,), 2.0)}, "Wq", spec),
                       2 * y)


def test_init_helpers_are_seeded_and_scaled():
    cfg = get_config("qwen3-0.6b").reduced()
    a = T.model_init(torch.Generator().manual_seed(3), cfg)
    b = T.model_init(torch.Generator().manual_seed(3), cfg)
    wq = a["stack"][0]["attn"]["Wq"]
    assert torch.equal(wq, b["stack"][0]["attn"]["Wq"])
    assert wq.shape == (2, 64, 64) and wq.abs().max() <= Q.leaf_alpha(wq.shape)
    assert torch.equal(a["stack"][0]["attn"]["sq"], torch.ones(2, 64))
    assert "head" not in a and a["embed"].shape == (cfg.padded_vocab, 64)
    jp = JT.model_init(jax.random.PRNGKey(0), j_get_config("qwen3-0.6b").reduced())
    assert jax.tree.structure(jax.tree.map(lambda x: 0, jp)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, convert.to_numpy(a)))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    s = rng.standard_normal(16).astype(np.float32) * 0.3
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(s)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(s)), 1e-5)
    for pos in (np.arange(7, dtype=np.int32),
                rng.integers(0, 500, size=(2, 7)).astype(np.int32)):
        _close(L.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
               JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-5)


@pytest.mark.parametrize("case", ["causal", "chunked", "window-chunked",
                                  "per-slot", "softcap"])
def test_attention_matches_jax(case):
    rng = np.random.default_rng(5)
    B, Sq, Skv = 2, 8, 24
    kw = dict(causal=True, window=0, chunk=1024, softcap=0.0)
    q_offset, kv_pos = 16, None
    if case == "chunked":
        Sq, Skv, q_offset, kw["chunk"] = 16, 16, 0, 4
    elif case == "window-chunked":
        Sq, Skv, q_offset, kw["chunk"], kw["window"] = 16, 16, 0, 4, 3
    elif case == "per-slot":
        q_offset = np.array([3, 16], np.int32)
        kv_pos = np.where(np.arange(Skv)[None] < np.array([[11], [24]]),
                          np.arange(Skv)[None], -1).astype(np.int32)
        kw["window"] = 6
    elif case == "softcap":
        kw["softcap"] = 2.0
    q = rng.standard_normal((B, Sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((B, Skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((B, Skv, 2, 16)).astype(np.float32)
    t = L.attention(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v),
                    q_offset=torch.as_tensor(q_offset),
                    kv_pos=None if kv_pos is None else torch.from_numpy(kv_pos),
                    **kw)
    j = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     q_offset=jnp.asarray(q_offset),
                     kv_pos=None if kv_pos is None else jnp.asarray(kv_pos),
                     **kw)
    _close(t, j, 1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch, tree):
    jp, tp, jcfg, tcfg = _pair(arch, tree)
    toks = _tokens(jcfg.vocab, (2, 20))
    jl, _ = JT.forward(jp, jnp.asarray(toks), jcfg)
    tl, aux = T.forward(tp, torch.from_numpy(toks), tcfg)
    _close(tl, jl)
    assert float(aux) == 0.0


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_matches_jax(arch, tree):
    """prefill then 4 greedy decode steps; gemma3's prompt of 20 and four
    steps wrap no ring (capacity window + 128), the per-slot ring case is
    tests/test_torch_kvcache.py's."""
    jp, tp, jcfg, tcfg = _pair(arch, tree)
    toks = _tokens(jcfg.vocab, (2, 20))
    jc, tc = JT.init_caches(jcfg, 2, 32), T.init_caches(tcfg, 2, 32)
    jl, jc = JT.prefill(jp, jnp.asarray(toks), jc, jcfg)
    tl, tc = T.prefill(tp, torch.from_numpy(toks), tc, tcfg)
    _close(tl, jl)
    _caches_close(tc, jc)
    dispatch.reset_counts()
    for _ in range(4):
        nxt = np.argmax(np.asarray(jl)[:, :jcfg.vocab], -1).astype(np.int32)
        assert np.array_equal(nxt, tl[:, :tcfg.vocab].argmax(-1).numpy())
        jl, jc = JT.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
        tl, tc = T.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
        _close(tl, jl)
    _caches_close(tc, jc)
    if tree in ("ternary", "binary"):
        # seven packed projections a layer, every one a GEMV at 2 rows
        assert dict(dispatch.PLAIN_CALLS) == {
            "packed_gemv": 4 * 7 * tcfg.n_layers}


@pytest.mark.parametrize("tree", ["fp", "ternary"])
@pytest.mark.parametrize("arch", DENSE)
def test_per_slot_decode_with_live_mask_matches_jax(arch, tree):
    """A continuous-batching pool: rows at their own depths, a dead row
    frozen bit for bit."""
    jp, tp, jcfg, tcfg = _pair(arch, tree)
    jc = JT.init_caches(jcfg, 3, 24, per_slot=True)
    tc = T.init_caches(tcfg, 3, 24, per_slot=True)
    toks = _tokens(jcfg.vocab, (3, 5))
    live = np.array([True, False, True])
    for i in range(5):
        step_live = live if i % 2 else np.array([True, True, True])
        jl, jc = JT.decode_step(jp, jnp.asarray(toks[:, i]), jc, jcfg,
                                live=jnp.asarray(step_live))
        before = [c["attn"].k.clone() for c in tc["stack"]]
        tl, tc = T.decode_step(tp, torch.from_numpy(toks[:, i]), tc, tcfg,
                               live=torch.from_numpy(step_live))
        rows = np.flatnonzero(step_live)
        _close(tl[rows], np.asarray(jl)[rows])
        for b, c in zip(before, tc["stack"]):
            dead = np.flatnonzero(~step_live)
            assert torch.equal(b[:, dead], c["attn"].k[:, dead])
    _caches_close(tc, jc)


@pytest.mark.parametrize("tree", ["fp", "ternary"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama3-8b"])
def test_verify_step_matches_jax_and_decode_steps(arch, tree):
    jp, tp, jcfg, tcfg = _pair(arch, tree)
    prompt = _tokens(jcfg.vocab, (2, 6))
    span = _tokens(jcfg.vocab, (2, 4), seed=3)
    jc = JT.init_caches(jcfg, 2, 16, per_slot=True)
    _, jc = JT.prefill(jp, jnp.asarray(prompt), jc, jcfg)
    jv, jc = JT.verify_step(jp, jnp.asarray(span), jc, jcfg)
    outs = []
    for _ in range(2):
        tc = T.init_caches(tcfg, 2, 16, per_slot=True)
        _, tc = T.prefill(tp, torch.from_numpy(prompt), tc, tcfg)
        outs.append(tc)
    tv, tc = T.verify_step(tp, torch.from_numpy(span), outs[0], tcfg)
    _close(tv, jv)
    _caches_close(tc, jc)
    sc = outs[1]
    for i in range(span.shape[1]):
        lg, sc = T.decode_step(tp, torch.from_numpy(span[:, i]), sc, tcfg)
        assert torch.equal(lg, tv[:, i])
    for a, b in zip(sc["stack"], tc["stack"]):
        assert torch.equal(a["attn"].k, b["attn"].k)


def test_other_kinds_are_refused():
    """Every family's config is ported now (the vlm's self and cross kinds
    included: `model_init` builds it); a config whose pattern holds kinds
    its family does not run is still refused."""
    for arch in ARCH_IDS:
        T.check_ported(get_config(arch).reduced())
    cfg = get_config("llama-3.2-vision-90b").reduced()
    tree = T.model_init(torch.Generator().manual_seed(0), cfg)
    assert "xgate" in tree["stack"][4]["attn"]
    odd = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              block_pattern=("full", "cross"))
    for fn in (T.check_ported,
               lambda c: T.model_init(torch.Generator().manual_seed(0), c)):
        with pytest.raises(NotImplementedError, match="does not run"):
            fn(odd)
