"""The port's hybrid family (zamba2-1.2b: Mamba2 layers and one shared
full-attention block) against the JAX package on the CPU, and its serving
path: the runtime, the continuous-batching engine and the launcher.

zamba2-1.2b at `reduced()` size: 7 mamba layers as 3 repeats of (mamba,
mamba, shared) and a tail mamba layer, d_model 64, d_inner 128, 8 SSD
heads of 16, state 16, chunk 8, the shared block at 4 heads of 16 with
d_ff 128, vocab 256, fp32.  JAX's weights (SSM dynamics, norms and
channel scales off init, `test_torch_mamba2.masters`) are carried across
with `repro_torch.convert`.
Four trees: the fp masters, the masters quantized on the fly (ternary),
and the ternary and binary packed exports.

Tolerances, the dense tests': logits and states rtol and atol 1e-4, KV
caches within 1e-5 of their largest magnitude, positions equal, greedy
ids equal.  Within the port everything is bit for bit: the dead-row
freeze keeps every pool leaf of a dead slot, and every engine stream
equals `drive_session(B=1)` on its request.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qtensor as JQT
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.core.qtensor import export_packed, tree_leaves, tree_paths
from repro_torch.kernels import dispatch
from repro_torch.launch.serve import synth_traffic
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.serve import recurrent as R
from repro_torch.serve.engine import ServeEngine, tree_gather_slot
from repro_torch.serve.kvcache import AttnCache
from repro_torch.serve.prefixcache import PrefixCache

from test_torch_mamba2 import _cfgs, masters
from test_torch_transformer import _close, _np, _tokens

torch.set_num_threads(1)
TREES = ("fp", "masters", "ternary", "binary")
# packed calls a decode step: Win and Wout a mamba layer (7), seven
# projections a shared application (3); the untied head stays fp
LAUNCHES = 2 * 7 + 7 * 3
# and in serving `ordered_bmm`'s: the SSD step's readout a mamba layer,
# attention's two products a shared application
ORDERED = 7 + 2 * 3


def _pair(tree: str):
    """(JAX params, port params, JAX cfg, port cfg) for one tree."""
    mode = {"fp": "none", "masters": "ternary"}.get(tree, tree)
    jcfg, tcfg = _cfgs(mode)
    jp = masters()
    if tree in ("ternary", "binary"):
        jp = JQT.export_packed(jp, jcfg.quant)
    return jp, convert.from_numpy(_np(jp), "cpu"), jcfg, tcfg


def _flat(tree) -> list:
    """[(path, tensor)] of a state tree, an `AttnCache` as its k, v, pos."""
    out = []
    for path, leaf in tree_paths(tree):
        if isinstance(leaf, AttnCache):
            out += [(path + (n,), getattr(leaf, n)) for n in ("k", "v", "pos")]
        else:
            out.append((path, leaf))
    return out


def _row(tree, slot: int) -> list:
    """Copies of every pool leaf's row `slot`."""
    return [t.clone() for _, t in _flat(tree_gather_slot(tree, slot))]


def _caches_close(tc, jc):
    """SSM states within 1e-4, the shared applications' k/v within 1e-5 of
    their largest magnitude, every position equal."""
    for t, j in zip(tc["stack"] + tc["tail"], jc["stack"] + jc["tail"]):
        if "ssm" in t:
            for name in ("h", "conv"):
                _close(getattr(t["ssm"], name), getattr(j["ssm"], name))
            assert np.array_equal(t["ssm"].pos.numpy(),
                                  np.asarray(j["ssm"].pos))
            continue
        for got, want in ((t["attn"].k, j["attn"].k),
                          (t["attn"].v, j["attn"].v)):
            want = np.asarray(want)
            err = np.abs(got.numpy() - want).max()
            assert err <= 1e-5 * max(1.0, np.abs(want).max()), err
        assert np.array_equal(t["attn"].pos.numpy(), np.asarray(j["attn"].pos))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_pattern_params_and_caches_have_jax_layout():
    jp, tp, jcfg, tcfg = _pair("ternary")
    assert T.expand_pattern(tcfg) == (("mamba", "mamba", "shared"), 3,
                                      ("mamba",))
    assert tp["stack"][2] == {} and not T.owns_params("shared")
    assert set(tp["shared"]) == {"norm1", "norm2", "attn", "mlp"}
    q = T._serve_quant(tp, tcfg)
    kinds = [k for k, _ in q.layers]
    assert kinds == ["mamba", "mamba", "shared"] * 3 + ["mamba"]
    # every shared application is the shared block itself, not the {}
    assert all(p is q["shared"] for k, p in q.layers if k == "shared")
    tc, jc = T.init_caches(tcfg, 2, 16), JT.init_caches(jcfg, 2, 16)
    tl, jl = _flat(tc), jax.tree_util.tree_leaves(jc)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t[1].shape) == np.asarray(j).shape, t[0]
    assert isinstance(tc["stack"][0]["ssm"], M.SSMState)
    assert tc["stack"][2]["attn"].k.shape == (3, 2, 144, 4, 16)


@pytest.mark.parametrize("tree", TREES)
def test_forward_matches_jax(tree):
    jp, tp, jcfg, tcfg = _pair(tree)
    toks = _tokens(jcfg.vocab, (2, 20))
    jl, _ = JT.forward(jp, jnp.asarray(toks), jcfg)
    tl, aux = T.forward(tp, torch.from_numpy(toks), tcfg)
    _close(tl, jl)
    assert float(aux) == 0.0


@pytest.mark.parametrize("tree", TREES)
def test_prefill_then_decode_matches_jax(tree):
    """prefill (the chunked scan over 20 tokens, chunk 8; the shared block
    writing its own cache at each application) then 4 greedy decode steps
    (`ssd_step`); states and caches against JAX's."""
    jp, tp, jcfg, tcfg = _pair(tree)
    toks = _tokens(jcfg.vocab, (2, 20))
    jc, tc = JT.init_caches(jcfg, 2, 32), T.init_caches(tcfg, 2, 32)
    jl, jc = JT.prefill(jp, jnp.asarray(toks), jc, jcfg)
    tl, tc = T.prefill(tp, torch.from_numpy(toks), tc, tcfg)
    _close(tl, jl)
    _caches_close(tc, jc)
    # the three shared applications wrote caches of their own
    k = tc["stack"][2]["attn"].k
    assert not (torch.equal(k[0], k[1]) or torch.equal(k[1], k[2]))
    dispatch.reset_counts()
    for _ in range(4):
        nxt = np.argmax(np.asarray(jl)[:, :jcfg.vocab], -1).astype(np.int32)
        assert np.array_equal(nxt, tl[:, :tcfg.vocab].argmax(-1).numpy())
        jl, jc = JT.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
        tl, tc = T.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
        _close(tl, jl)
    _caches_close(tc, jc)
    if tree in ("ternary", "binary"):
        # Win and Wout a mamba layer, seven projections a shared
        # application, every one a GEMV at 2 rows (the head stays fp)
        assert dict(dispatch.PLAIN_CALLS) == {"packed_gemv": 4 * LAUNCHES}


def test_one_token_prefill_matches_jax():
    """A 1-token prompt (chunk) prefills through the chunked scan, as JAX's
    cached step passes decode=False, not the step."""
    jp, tp, jcfg, tcfg = _pair("ternary")
    toks = _tokens(jcfg.vocab, (2, 5))
    jc, tc = JT.init_caches(jcfg, 2, 16), T.init_caches(tcfg, 2, 16)
    for i in range(toks.shape[1]):
        jl, jc = JT.prefill(jp, jnp.asarray(toks[:, i:i + 1]), jc, jcfg)
        tl, tc = T.prefill(tp, torch.from_numpy(toks[:, i:i + 1]), tc, tcfg)
        _close(tl, jl)
    _caches_close(tc, jc)


@pytest.mark.parametrize("tree", ["fp", "ternary"])
def test_per_slot_decode_with_live_mask_matches_jax(tree):
    """A continuous-batching pool: rows at their own depths, a dead row's
    every pool leaf (SSD state, conv tail, pos; the shared applications'
    k, v and pos) frozen bit for bit (`_freeze_dead`, the live-masked
    cache write)."""
    jp, tp, jcfg, tcfg = _pair(tree)
    jc = JT.init_caches(jcfg, 3, 24, per_slot=True)
    tc = T.init_caches(tcfg, 3, 24, per_slot=True)
    assert tc["stack"][0]["ssm"].pos.shape == (3, 3)
    toks = _tokens(jcfg.vocab, (3, 5))
    for i in range(5):
        live = np.array([True, i % 2 == 0, True])
        jl, jc = JT.decode_step(jp, jnp.asarray(toks[:, i]), jc, jcfg,
                                live=jnp.asarray(live))
        before = _row(tc, 1)
        tl, tc = T.decode_step(tp, torch.from_numpy(toks[:, i]), tc, tcfg,
                               live=torch.from_numpy(live))
        after = _row(tc, 1)
        rows = np.flatnonzero(live)
        _close(tl[rows], np.asarray(jl)[rows])
        assert all(torch.equal(b, a) for b, a in zip(before, after)) \
            != live[1]
    _caches_close(tc, jc)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ternary", "binary"])
def test_packed_codes_equal_jax_export(mode):
    """The port's export of the same masters holds JAX's codes bit for bit
    (the mixers' Win and Wout, the shared block's projections, the head),
    and `model_init(packed=True)` equals exporting `model_init`."""
    jcfg, tcfg = _cfgs(mode)
    jx = JQT.export_packed(masters(), jcfg.quant)
    tx = export_packed(convert.from_numpy(_np(masters()), "cpu"), tcfg.quant)
    jl = jax.tree_util.tree_leaves(jx, is_leaf=JQT.is_qtensor)
    tl = tree_leaves(tx)
    assert len(jl) == len(tl)
    n = 0
    for j, t in zip(jl, tl):
        if JQT.is_qtensor(j):
            n += 1
            assert np.array_equal(t.codes.numpy().view(np.uint32),
                                  np.asarray(j.codes))
            assert t.alpha == pytest.approx(j.alpha, rel=1e-6)
    # stacked Win, Wout at 2 pattern positions; the shared block; the tail
    assert n == 2 * 2 + 7 + 2
    a = T.model_init(torch.Generator().manual_seed(3), tcfg, packed=True)
    b = export_packed(T.model_init(torch.Generator().manual_seed(3), tcfg),
                      tcfg.quant)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = (getattr(v, "codes", v) for v in (x, y))
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _runtime(mode="ternary", seed=0):
    _, tcfg = _cfgs(mode)
    params = T.model_init(torch.Generator().manual_seed(seed), tcfg,
                          packed=mode != "none")
    return R.serving_runtime(tcfg, params, device="cpu")


def test_runtime_prefills_whole_and_refuses_speculation_and_prefix_cache():
    """mamba joins rwkv in JAX's rule: a prompt is one chunk, and the
    engine refuses speculative pairing and a prefix cache, as JAX's."""
    rt = _runtime("none")
    assert rt.chunk_granularity == "whole" and not rt.spec_capable
    assert not rt.ring_caches and rt.extras == {}
    with pytest.raises(NotImplementedError,
                       match="MoE and rwkv/mamba runtimes do not"):
        ServeEngine(rt, rt.cfg.vocab, slots=2, max_context=16,
                    draft=R.speculative_draft(rt), spec_k=2)
    with pytest.raises(NotImplementedError, match="token-granularity"):
        ServeEngine(rt, rt.cfg.vocab, slots=2, max_context=16,
                    prefix_cache=PrefixCache(1 << 20))


def test_engine_dead_row_freeze_is_bit_exact_on_every_pool_leaf():
    """The port of JAX's test_engine_matches_sequential_hybrid_ssm, first
    half: after a prefill, a decode tick with row 0 dead leaves every leaf
    of row 0 (SSD state, conv tail, pos, the shared k/v and pos) as it
    was, and moves row 1."""
    rt = _runtime("ternary")
    st = rt.init_state(2, 16, per_slot=True)
    toks = torch.from_numpy(_tokens(rt.cfg.vocab, (2, 3), seed=1)).long()
    _, st = rt.prefill(toks, st)
    before = [_row(st, s) for s in (0, 1)]
    _, st2 = rt.decode_fn(torch.tensor([1, 2]), st,
                          torch.tensor([False, True]))
    for s, live in ((0, False), (1, True)):
        after = _row(st2, s)
        same = [torch.equal(b, a) for b, a in zip(before[s], after)]
        assert all(same) if not live else not all(same)


@pytest.mark.parametrize("mode", ["ternary", "none"])
def test_engine_matches_sequential_hybrid_ssm(mode):
    """The engine over zamba2, seven mixed requests at 3 slots: one prefill
    chunk a prompt (at its own length, whatever `prefill_chunk` says), at
    most one chunk between ticks, and every stream byte-equal to the
    request run alone (sampled at temperature 0.8, top-k 5, one greedy)."""
    rt = _runtime(mode)
    ctx = 24 + 10
    reqs = synth_traffic(rt.cfg.vocab, requests=7, rate=1e3, prompt_len=24,
                         gen=10, temperature=0.8, top_k=5, seed=3)
    reqs[1] = dataclasses.replace(reqs[1], temperature=0.0, top_k=0)
    eng = ServeEngine(rt, rt.cfg.vocab, slots=3, max_context=ctx,
                      prefill_chunk=4)
    comps, m = eng.run([dataclasses.replace(r) for r in reqs],
                       realtime=False)
    assert m["requests"] == 7 and m["max_decode_stall_ticks"] <= 1
    assert eng.prefill_chunks == 7
    by = {c.rid: c.tokens for c in comps}
    for r in reqs:
        out, _ = R.drive_session(
            rt, torch.as_tensor(np.asarray(r.prompt, np.int64))[None],
            rt.cfg.vocab, gen=r.max_tokens, temperature=r.temperature,
            top_k=r.top_k, seed=r.seed, context=ctx)
        assert by[r.rid] == out[0].tolist(), r.rid
    if mode == "ternary":
        assert eng.tick_launches == LAUNCHES + ORDERED
    # a freed slot reads like a fresh one: recurrent leaves zero, cache pos 0
    for path, leaf in _flat(eng.pool):
        if path[-1] in ("h", "conv", "pos"):
            assert not leaf.any(), path


def test_convert_carries_ssm_state_and_attn_cache():
    """A JAX zamba2 cache tree (stacked `SSMState`s and the shared
    applications' `AttnCache`s) becomes the port's, and decoding from it
    matches JAX's decoding from the original."""
    jp, tp, jcfg, tcfg = _pair("ternary")
    toks = _tokens(jcfg.vocab, (2, 9))
    jc = JT.init_caches(jcfg, 2, 16)
    _, jc = JT.prefill(jp, jnp.asarray(toks), jc, jcfg)
    tc = convert.from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    st = tc["stack"][0]["ssm"]
    assert isinstance(st, M.SSMState) and st.h.shape == (3, 2, 8, 16, 16)
    assert isinstance(tc["stack"][2]["attn"], AttnCache)
    nxt = np.array([3, 7], np.int32)
    jl, _ = JT.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
    tl, _ = T.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
    _close(tl, jl)
    assert np.array_equal(convert.to_numpy(st).h,
                          np.asarray(jc["stack"][0]["ssm"].h))


def test_launcher_serves_zamba2_reduced(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "zamba2-1.2b", "--reduced", "--device",
                      "cpu", "--gen", "4", "--prompt-len", "8", "--batch",
                      "2"])
    assert out.shape == (2, 4)
    m = serve.main(["--arch", "zamba2-1.2b", "--device", "cpu", "--traffic",
                    "--requests", "4", "--slots", "2", "--rate", "100",
                    "--prompt-len", "12", "--gen", "6"])
    assert m["requests"] == 4 and m["tick_launches"] == LAUNCHES + ORDERED
    assert "transformer family, cpu" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="rwkv/mamba"):
        serve.main(["--arch", "zamba2-1.2b", "--device", "cpu", "--traffic",
                    "--spec-k", "2", "--requests", "2"])
