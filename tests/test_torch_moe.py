"""The port's mixture-of-experts layer and MoE models against the JAX
package on the CPU.

The same numpy inputs and weights go through `repro.models.moe` /
`repro.models.transformer` and their `repro_torch` counterparts at
`reduced()` size (d_model 64, 4 heads of 16, 2 KV heads, 4 experts of
d_ff 128, top-2, vocab 256, fp32) for mixtral-8x7b (sliding-window ring
caches on every layer) and qwen3-moe-30b-a3b (qk_norm).  JAX's weights are
carried across with `repro_torch.convert`, the norm scales and the
channel-scale companions walked off init so that they matter.  Four trees
each: the fp masters (quant none), the masters quantized on the fly
(ternary), and the ternary and binary packed exports; JAX runs its packed
leaves through its CPU dequantize fallback, the port through the packed
kernels' plain versions.

Tolerances, those of the dense family's tests: logits rtol and atol 1e-4;
caches within 1e-5 of their largest magnitude; greedy ids equal; the
router's dispatch equal and its combine weights and aux within 1e-6 (two
softmaxes in fp32).  The gaps
are fp32 summation in other orders (the combine sums a token's k choices
where JAX's einsum sums over every expert slot; the packed products
dequantize-then-multiply in JAX).  The port's expert loop that skips
experts without a kept row is held bit-equal to the loop over all E
experts and their capacity slots.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import qtensor as JQT
from repro.core import quantize as JQ
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import quantize as Q
from repro_torch.core.qtensor import QTensor, export_packed
from repro_torch.kernels import dispatch
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T

from test_torch_cuda import all_experts
from test_torch_transformer import _caches_close, _close, _np, _tokens

torch.set_num_threads(1)
MOE_ARCHS = ("mixtral-8x7b", "qwen3-moe-30b-a3b")
TREES = ("fp", "masters", "ternary", "binary")


def _cfgs(arch: str, tree: str, **over):
    """(JAX cfg, port cfg) at reduced size for one of TREES."""
    mode = {"fp": "none", "masters": "ternary"}.get(tree, tree)
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), **over)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **over)
    if mode == "none":
        return (jcfg.with_quant(JQ.QuantSpec(mode="none")),
                tcfg.with_quant(Q.QuantSpec(mode="none")))
    return (jcfg.with_quant(JQ.QuantSpec(mode=mode, norm="channel")),
            tcfg.with_quant(Q.QuantSpec(mode=mode, norm="channel")))


def _off_init(tree, seed=1):
    """Norm scales and s<W> companions walked off init."""
    rng = np.random.default_rng(seed)

    def walk(path, a):
        name = getattr(path[-1], "key", "")
        if "norm" in name or name.startswith("s"):
            return a + 0.2 * rng.standard_normal(a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(walk, tree)


_MASTERS = {}


def _pair(arch: str, tree: str, **over):
    """(JAX params, port params, JAX cfg, port cfg) for one tree."""
    jcfg, tcfg = _cfgs(arch, tree, **over)
    key = (arch, tuple(sorted(over.items())))
    if key not in _MASTERS:
        mcfg = _cfgs(arch, "masters", **over)[0]
        _MASTERS[key] = _off_init(JT.model_init(jax.random.PRNGKey(0), mcfg))
    jp = _MASTERS[key]
    if tree in ("ternary", "binary"):
        jp = JQT.export_packed(jp, jcfg.quant)
    return jp, convert.from_numpy(_np(jp), "cpu"), jcfg, tcfg


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_capacity_and_top_k_match_jax():
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b", "fp")
    for n in (1, 3, 8, 40, 512, 4096):
        for align in (1, 128):
            assert MOE.capacity(n, tcfg, align) == JMOE.capacity(n, jcfg, align)
    full_j, full_t = j_get_config("qwen3-moe-30b-a3b"), get_config(
        "qwen3-moe-30b-a3b")
    assert MOE.capacity(512, full_t) == JMOE.capacity(512, full_j) == 40
    logits = np.array([[1.0, 3.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0],
                       [0.0, -1.0, 5.0, 5.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(logits), 3)
    tv, ti = MOE.top_k(torch.from_numpy(logits), 3)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert ti.tolist() == [[1, 2, 0], [0, 1, 2], [2, 3, 0]]


@pytest.mark.parametrize("case", ["random", "tie", "drops"])
def test_route_matches_jax(case):
    """dispatch equal and combine and aux within 1e-6, with ties broken to
    the lower expert and (case drops) a capacity that drops choices."""
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b", "fp")
    rng = np.random.default_rng(7)
    T_, E = 12, jcfg.n_experts
    logits = rng.standard_normal((T_, E)).astype(np.float32)
    cap = MOE.capacity(T_, tcfg)
    if case == "tie":
        logits[:4] = 1.5              # every expert tied
        logits[4:8, 1:3] = 9.0        # two tied winners
    elif case == "drops":
        logits[:, 2] += 6.0           # everyone's first choice
        cap = 3
    jd, jc, ja = JMOE.route(jnp.asarray(logits), jcfg, cap)
    td, tc, ta = MOE.route(torch.from_numpy(logits), tcfg, cap)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    if case == "drops":
        assert td.sum() < T_ * tcfg.topk  # some choices were dropped
        assert td[:, 2].sum() == cap


def _layer(arch, tree, seed=0):
    """One MoE layer's JAX params (channel scales off init) and the port's."""
    jcfg, tcfg = _cfgs(arch, tree)
    mcfg = _cfgs(arch, "ternary")[0]
    p = _off_init(JMOE.moe_init(jax.random.PRNGKey(seed), mcfg))
    if tree == "fp":
        p = {k: v for k, v in p.items() if not k.startswith("s")}
    if tree in ("ternary", "binary"):
        p = JQT.export_packed(p, jcfg.quant)
    return p, convert.from_numpy(_np(p), "cpu"), jcfg, tcfg


@pytest.mark.parametrize("tree", ["fp", "ternary", "binary"])
@pytest.mark.parametrize("no_drop", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax(arch, no_drop, tree):
    """x (2, 12, d) one group; and (4, 8, d) in four groups of 8, whose
    capacity drops choices unless no_drop."""
    jp, tp, jcfg, tcfg = _layer(arch, tree)
    rng = np.random.default_rng(3)
    for shape, gs in (((2, 12, 64), MOE.GROUP_SIZE), ((4, 8, 64), 8)):
        x = rng.standard_normal(shape).astype(np.float32)
        jy, ja = JMOE.moe_apply(jp, jnp.asarray(x), jcfg, no_drop=no_drop,
                                group_size=gs)
        ty, ta = MOE.moe_apply(tp, torch.from_numpy(x), tcfg,
                               no_drop=no_drop, group_size=gs)
        _close(ty, jy, 1e-5)
        np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


@pytest.mark.parametrize("mode", ["ternary", "binary"])
@pytest.mark.parametrize("no_drop", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_skipping_is_bit_equal_to_all_experts(arch, no_drop, mode,
                                                     monkeypatch):
    """The packed loop over the experts with kept rows, each on those rows,
    gives the bits of the loop over all E experts and their capacity slots
    (zero rows included), in fewer kernel calls: rows are independent in
    the kernels, and a skipped expert's output would meet a combine weight
    of 0.  Skewed routing leaves experts empty."""
    _, tp, _, tcfg = _layer(arch, mode)
    tp = dict(tp, router=tp["router"].clone())
    tp["router"][:, 0] += 3.0   # most tokens' first choice is expert 0
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 5, 64)).astype(np.float32))
    for gs in (MOE.GROUP_SIZE, 5):
        dispatch.reset_counts()
        with monkeypatch.context() as m:
            m.setattr(MOE, "_kept_experts", all_experts)
            y_all, a_all = MOE.moe_apply(tp, x, tcfg, no_drop=no_drop,
                                         group_size=gs)
        calls_all = sum(dispatch.PLAIN_CALLS.values())
        dispatch.reset_counts()
        y_skip, a_skip = MOE.moe_apply(tp, x, tcfg, no_drop=no_drop,
                                       group_size=gs)
        calls_skip = sum(dispatch.PLAIN_CALLS.values())
        assert torch.equal(y_all, y_skip) and torch.equal(a_all, a_skip)
        assert calls_all == 3 * tcfg.n_experts
        assert calls_skip % 3 == 0 and calls_skip <= calls_all


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_slices_are_contiguous_and_aligned(arch):
    """A layer view of a stacked expert leaf is (E, K/G, N), and each
    expert's slice of it is contiguous and 16-byte aligned, so the GEMV
    keeps its vector loads."""
    _, tcfg = _cfgs(arch, "ternary")
    tree = T._serve_quant(T.model_init(torch.Generator().manual_seed(0), tcfg,
                                       packed=True), tcfg)
    for kind, p in tree.layers:
        for name in ("Wgate", "Wup", "Wdown"):
            w = p["moe"][name]
            assert isinstance(w, QTensor) and w.codes.dim() == 3
            assert w.codes.shape[0] == tcfg.n_experts
            for e in range(tcfg.n_experts):
                c = MOE._expert(w, e).codes
                assert c.is_contiguous() and c.data_ptr() % 16 == 0


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_jax(arch, tree):
    jp, tp, jcfg, tcfg = _pair(arch, tree)
    toks = _tokens(jcfg.vocab, (2, 20))
    jl, ja = JT.forward(jp, jnp.asarray(toks), jcfg)
    tl, ta = T.forward(tp, torch.from_numpy(toks), tcfg)
    _close(tl, jl)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_then_decode_matches_jax(arch, tree):
    """prefill (capacity drops possible) then 4 greedy decode steps (no
    drops); caches and logits against JAX's."""
    jp, tp, jcfg, tcfg = _pair(arch, tree)
    toks = _tokens(jcfg.vocab, (2, 20))
    jc, tc = JT.init_caches(jcfg, 2, 32), T.init_caches(tcfg, 2, 32)
    jl, jc = JT.prefill(jp, jnp.asarray(toks), jc, jcfg)
    tl, tc = T.prefill(tp, torch.from_numpy(toks), tc, tcfg)
    _close(tl, jl)
    _caches_close(tc, jc)
    for _ in range(4):
        nxt = np.argmax(np.asarray(jl)[:, :jcfg.vocab], -1).astype(np.int32)
        assert np.array_equal(nxt, tl[:, :tcfg.vocab].argmax(-1).numpy())
        jl, jc = JT.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
        tl, tc = T.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
        _close(tl, jl)
    _caches_close(tc, jc)


@pytest.mark.parametrize("tree", ["fp", "ternary"])
def test_mixtral_ring_caches_at_eight_experts(tree):
    """mixtral at E = 8, top-2 with its sliding window on every layer: a
    150-token prompt wraps the ring (window 16 + 128 columns) inside the
    prefill, then three decode steps."""
    jp, tp, jcfg, tcfg = _pair("mixtral-8x7b", tree, n_experts=8)
    assert tcfg.swa_all and (tcfg.n_experts, tcfg.topk) == (8, 2)
    toks = _tokens(jcfg.vocab, (1, 150))
    jc, tc = JT.init_caches(jcfg, 1, 160), T.init_caches(tcfg, 1, 160)
    assert tc["stack"][0]["attn"].ring and tc["stack"][0]["attn"].k.shape[2] == 144
    jl, jc = JT.prefill(jp, jnp.asarray(toks), jc, jcfg)
    tl, tc = T.prefill(tp, torch.from_numpy(toks), tc, tcfg)
    _close(tl, jl)
    for _ in range(3):
        nxt = np.argmax(np.asarray(jl)[:, :jcfg.vocab], -1).astype(np.int32)
        jl, jc = JT.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
        tl, tc = T.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
        _close(tl, jl)
    _caches_close(tc, jc)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_per_slot_decode_with_live_mask_matches_jax(arch):
    """A continuous-batching pool over packed experts: rows at their own
    depths, a dead row's cache frozen bit for bit."""
    jp, tp, jcfg, tcfg = _pair(arch, "ternary")
    jc = JT.init_caches(jcfg, 3, 24, per_slot=True)
    tc = T.init_caches(tcfg, 3, 24, per_slot=True)
    toks = _tokens(jcfg.vocab, (3, 5))
    for i in range(5):
        live = np.array([True, i % 2 == 0, True])
        jl, jc = JT.decode_step(jp, jnp.asarray(toks[:, i]), jc, jcfg,
                                live=jnp.asarray(live))
        before = [c["attn"].k.clone() for c in tc["stack"]]
        tl, tc = T.decode_step(tp, torch.from_numpy(toks[:, i]), tc, tcfg,
                               live=torch.from_numpy(live))
        rows = np.flatnonzero(live)
        _close(tl[rows], np.asarray(jl)[rows])
        for b, c in zip(before, tc["stack"]):
            dead = np.flatnonzero(~live)
            assert torch.equal(b[:, dead], c["attn"].k[:, dead])
    _caches_close(tc, jc)


def test_moe_init_layout_matches_jax():
    """The port's init draws JAX's tree: the router fp32 (d, E), expert
    stacks (E, d, f) and (E, f, d), channel scales per layer, and a packed
    export keeps the router fp and packs each expert stack with its layer
    and expert axes."""
    jcfg, tcfg = _cfgs("qwen3-moe-30b-a3b", "ternary")
    jp = JT.model_init(jax.random.PRNGKey(0), jcfg)
    tp = T.model_init(torch.Generator().manual_seed(0), tcfg)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, jp)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, convert.to_numpy(tp)))
    moe = tp["stack"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["Wgate"].shape == (2, 4, 64, 128)
    assert moe["Wdown"].shape == (2, 4, 128, 64)
    assert moe["sgate"].shape == (2, 128) and moe["sdown"].shape == (2, 64)
    x = export_packed(tp, tcfg.quant)["stack"][0]["moe"]
    assert not isinstance(x["router"], QTensor)
    assert x["Wgate"].codes.shape == (2, 4, 4, 128)
    assert x["Wdown"].codes.shape == (2, 4, 8, 64)
