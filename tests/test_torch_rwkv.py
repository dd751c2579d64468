"""The port's RWKV6 mixer and rwkv6-7b against the JAX package on the CPU.

The same numpy inputs and weights go through `repro.models.rwkv6` /
`repro.models.transformer` and their `repro_torch` counterparts at
`reduced()` size (d_model 64, 4 heads of 16, d_ff 128, vocab 256, chunk 8,
fp32).  JAX's weights are carried across with `repro_torch.convert`, with
the leaves that are zero or constant at init (the LoRA up-projections, the
u bonus, the shift mixes, the norm and channel scales) walked off it so
that they matter.  Four trees: the fp masters (quant none), the masters
quantized on the fly (ternary), and the ternary and binary packed exports;
JAX runs its packed leaves through its CPU dequantize fallback, the port
through the packed kernels' plain versions.

Tolerances, those of the dense family's tests: logits rtol and atol 1e-4;
recurrent states (S and the two token shifts) within 1e-5 of their
largest magnitude, positions equal; greedy ids equal.  The chunked WKV and its one-token recurrence
within 1e-5 of each other and of JAX's (JAX's own test holds its pair to
1e-4); the port's chunked form takes the intra-chunk decay relative to
each sub-chunk's start and, inside a sub-chunk, as a pairwise difference
where JAX factors it through exp(-L_j): the same sum in another rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import qtensor as JQT
from repro.core import quantize as JQ
from repro.models import rwkv6 as JR
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import quantize as Q
from repro_torch.kernels import dispatch
from repro_torch.models import rwkv6 as R
from repro_torch.models import transformer as T

from test_torch_transformer import _close, _np, _tokens

torch.set_num_threads(1)
TREES = ("fp", "masters", "ternary", "binary")
OFF_INIT = ("lora_B", "wB", "u", "mu_x", "mu_ck", "mu_cr", "ln_x", "ln1",
            "ln2", "final_norm", "w0")


def _cfgs(tree: str):
    mode = {"fp": "none", "masters": "ternary"}.get(tree, tree)
    jcfg, tcfg = j_get_config("rwkv6-7b").reduced(), get_config(
        "rwkv6-7b").reduced()
    if mode == "none":
        return (jcfg.with_quant(JQ.QuantSpec(mode="none")),
                tcfg.with_quant(Q.QuantSpec(mode="none")))
    return (jcfg.with_quant(JQ.QuantSpec(mode=mode, norm="channel")),
            tcfg.with_quant(Q.QuantSpec(mode=mode, norm="channel")))


def _off_init(tree, seed=1):
    rng = np.random.default_rng(seed)

    def walk(path, a):
        name = getattr(path[-1], "key", "")
        if name in OFF_INIT or name.startswith("s"):
            scale = 0.5 if name in ("lora_B", "wB") else 0.2
            return a + scale * rng.standard_normal(a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(walk, tree)


_MASTERS = []


def _pair(tree: str):
    jcfg, tcfg = _cfgs(tree)
    if not _MASTERS:
        _MASTERS.append(_off_init(JT.model_init(jax.random.PRNGKey(0),
                                                _cfgs("masters")[0])))
    jp = _MASTERS[0]
    if tree in ("ternary", "binary"):
        jp = JQT.export_packed(jp, jcfg.quant)
    return jp, convert.from_numpy(_np(jp), "cpu"), jcfg, tcfg


def _state_close(t: R.RWKVState, j):
    for name in ("S", "tm_shift", "cm_shift"):
        got, want = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        err = np.abs(got - want).max()
        assert err <= 1e-5 * max(1.0, np.abs(want).max()), (name, err)
    assert np.array_equal(t.pos.numpy(), np.asarray(j.pos))


def _states_close(tc, jc):
    for t, j in zip(tc["stack"] + tc["tail"], jc["stack"] + jc["tail"]):
        _state_close(t["rwkv"], j["rwkv"])


# ---------------------------------------------------------------------------
# the WKV recurrence
# ---------------------------------------------------------------------------


def _wkv_inputs(seed, B=2, T_=13, H=2, N=4):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=0.5: (rng.standard_normal(s) * sc).astype(np.float32)
    r, k, v = f(B, T_, H, N), f(B, T_, H, N), f(B, T_, H, N)
    logw = -np.exp(f(B, T_, H, N, sc=0.3) - 1.0).astype(np.float32)
    return r, k, v, logw, f(H, N, sc=0.3), f(B, H, N, N, sc=0.2)


def _unrolled(step, r, k, v, logw, u, S):
    ys = []
    for t in range(r.shape[1]):
        y, S = step(r[:, t], k[:, t], v[:, t], logw[:, t], u, S)
        ys.append(y)
    return ys, S


@pytest.mark.parametrize("T_,chunk", [(13, 4), (16, 8), (5, 8), (1, 8),
                                      (40, 64), (100, 64)])
@pytest.mark.parametrize("seed", [0, 1])
def test_wkv6_chunked_matches_step_unrolled_and_jax(seed, T_, chunk):
    r, k, v, logw, u, S0 = _wkv_inputs(seed, T_=T_)
    tt = [torch.from_numpy(a) for a in (r, k, v, logw, u, S0)]
    jj = [jnp.asarray(a) for a in (r, k, v, logw, u, S0)]
    y_c, S_c = R.wkv6_chunked(*tt[:5], chunk, tt[5])
    ys, S_s = _unrolled(R.wkv6_step, *tt)
    y_s = torch.stack(ys, dim=1)
    for got, want in ((y_c, y_s), (S_c, S_s)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    jy_c, jS_c = JR.wkv6_chunked(*jj[:5], chunk, jj[5])
    jys, jS_s = _unrolled(JR.wkv6_step, *jj)
    _close(y_c, jy_c, 1e-5)
    _close(S_c, jS_c, 1e-5)
    _close(y_s, jnp.stack(jys, axis=1), 1e-5)
    _close(S_s, jS_s, 1e-5)
    # no initial state: zeros
    y0, S0c = R.wkv6_chunked(*tt[:5], chunk)
    jy0, jS0 = JR.wkv6_chunked(*jj[:5], chunk)
    _close(y0, jy0, 1e-5)
    _close(S0c, jS0, 1e-5)


def test_wkv6_chunked_stays_finite_at_strong_decay():
    """A decay as strong as the clip allows (logw = -e^5 a token) over a
    64-token chunk: every exponent argument of the port is <= 0, so the
    output and state stay finite (a positive exp(-L) would reach 1e4000)."""
    r, k, v, logw, u, S0 = _wkv_inputs(2, T_=64)
    logw = np.full_like(logw, -np.exp(5.0))
    y, S = R.wkv6_chunked(*(torch.from_numpy(a) for a in (r, k, v, logw, u)),
                          64, torch.from_numpy(S0))
    ys, S_s = _unrolled(R.wkv6_step, *(torch.from_numpy(a)
                                       for a in (r, k, v, logw, u, S0)))
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    torch.testing.assert_close(y, torch.stack(ys, 1), rtol=1e-5, atol=1e-5)


def test_wkv6_chunked_memory_stays_a_multiple_of_its_inputs():
    """A long prompt (256 tokens, chunk 64): no intermediate of the chunked
    scan holds more than Q / WKV_SUB = 4 times an input's elements (a
    pairwise (Q, Q, N) decay would hold Q = 64 times), and the result
    still equals the unrolled step."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor):
                    self.numel = max(self.numel, t.numel())
            return out

    r, k, v, logw, u, S0 = (torch.from_numpy(a) for a in
                            _wkv_inputs(3, B=1, T_=256, H=2, N=16))
    with Largest() as m:
        y, S = R.wkv6_chunked(r, k, v, logw, u, 64, S0)
    assert m.numel <= (64 // R.WKV_SUB) * r.numel(), (m.numel, r.numel())
    ys, S_s = _unrolled(R.wkv6_step, r, k, v, logw, u, S0)
    torch.testing.assert_close(y, torch.stack(ys, 1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(S, S_s, rtol=1e-5, atol=1e-5)


def test_group_norm_and_state_init_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    _close(R._group_norm(torch.from_numpy(x), torch.from_numpy(s), 4),
           JR._group_norm(jnp.asarray(x), jnp.asarray(s), 4), 1e-5)
    jcfg, tcfg = _cfgs("fp")
    for per_slot in (False, True):
        j = JR.state_init(jcfg, 3, per_slot=per_slot)
        t = R.state_init(tcfg, 3, per_slot=per_slot)
        for name in R.RWKVState._fields:
            a, b = getattr(t, name), np.asarray(getattr(j, name))
            assert a.shape == b.shape and str(a.dtype)[6:] == str(b.dtype)


@pytest.mark.parametrize("tree", ["fp", "ternary"])
def test_time_and_channel_mix_match_jax(tree):
    """One layer's mixers on layer 0's weights, without a state and then
    carrying one (the chunked scan, and one decode token)."""
    jp, tp, jcfg, tcfg = _pair(tree)
    jl = jax.tree.map(lambda a: a[0] if not JQT.is_qtensor(a) else
                      JQT.QTensor(codes=a.codes[0], scale=None, k=a.k,
                                  mode=a.mode, alpha=a.alpha),
                      jp["stack"][0]["mix"], is_leaf=JQT.is_qtensor)
    tl = T._layer_view(tp["stack"][0]["mix"], 0)
    x = np.random.default_rng(6).standard_normal((2, 11, 64)).astype(
        np.float32)
    jo, jS, jlast = JR.rwkv6_time_mix(jl, jnp.asarray(x), jcfg)
    to, tS, tlast = R.rwkv6_time_mix(tl, torch.from_numpy(x), tcfg)
    _close(to, jo)
    _close(tS, jS, 1e-5)
    assert torch.equal(tlast, torch.from_numpy(x[:, -1]))
    jst = JR.RWKVState(S=jS, tm_shift=jlast, cm_shift=jlast,
                       pos=jnp.asarray(11, jnp.int32))
    tst = R.RWKVState(S=tS, tm_shift=tlast, cm_shift=tlast,
                      pos=torch.tensor(11, dtype=torch.int32))
    x1 = x[:, :1] * 0.5
    jo, jS, _ = JR.rwkv6_time_mix(jl, jnp.asarray(x1), jcfg, state=jst)
    to, tS, _ = R.rwkv6_time_mix(tl, torch.from_numpy(x1), tcfg, state=tst)
    _close(to, jo)
    _close(tS, jS, 1e-5)
    jc, jcl = JR.rwkv6_channel_mix(jl, jnp.asarray(x), jcfg,
                                   prev=jnp.asarray(x[:, 3]))
    tc, tcl = R.rwkv6_channel_mix(tl, torch.from_numpy(x), tcfg,
                                  prev=torch.from_numpy(x[:, 3]))
    _close(tc, jc)
    assert torch.equal(tcl, torch.from_numpy(x[:, -1]))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


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
    """prefill (the chunked scan over 20 tokens, chunk 8) then 4 greedy
    decode steps (the one-token recurrence); states against JAX's."""
    jp, tp, jcfg, tcfg = _pair(tree)
    toks = _tokens(jcfg.vocab, (2, 20))
    jc, tc = JT.init_caches(jcfg, 2, 32), T.init_caches(tcfg, 2, 32)
    jl, jc = JT.prefill(jp, jnp.asarray(toks), jc, jcfg)
    tl, tc = T.prefill(tp, torch.from_numpy(toks), tc, tcfg)
    _close(tl, jl)
    _states_close(tc, jc)
    dispatch.reset_counts()
    for _ in range(4):
        nxt = np.argmax(np.asarray(jl)[:, :jcfg.vocab], -1).astype(np.int32)
        assert np.array_equal(nxt, tl[:, :tcfg.vocab].argmax(-1).numpy())
        jl, jc = JT.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
        tl, tc = T.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
        _close(tl, jl)
    _states_close(tc, jc)
    if tree in ("ternary", "binary"):
        # eight packed projections a layer, every one a GEMV at 2 rows
        assert dict(dispatch.PLAIN_CALLS) == {
            "packed_gemv": 4 * 8 * tcfg.n_layers}


@pytest.mark.parametrize("tree", ["fp", "ternary"])
def test_per_slot_decode_with_live_mask_matches_jax(tree):
    """A continuous-batching pool: rows at their own depths, a dead row's
    state (S, shifts, pos) frozen bit for bit (`_freeze_dead`)."""
    jp, tp, jcfg, tcfg = _pair(tree)
    jc = JT.init_caches(jcfg, 3, 24, per_slot=True)
    tc = T.init_caches(tcfg, 3, 24, per_slot=True)
    assert tc["stack"][0]["rwkv"].pos.shape == (2, 3)
    toks = _tokens(jcfg.vocab, (3, 5))
    for i in range(5):
        live = np.array([True, i % 2 == 0, True])
        jl, jc = JT.decode_step(jp, jnp.asarray(toks[:, i]), jc, jcfg,
                                live=jnp.asarray(live))
        before = [leaf.clone() for leaf in tc["stack"][0]["rwkv"]]
        tl, tc = T.decode_step(tp, torch.from_numpy(toks[:, i]), tc, tcfg,
                               live=torch.from_numpy(live))
        rows = np.flatnonzero(live)
        _close(tl[rows], np.asarray(jl)[rows])
        for b, a in zip(before, tc["stack"][0]["rwkv"]):
            dead = np.flatnonzero(~live)
            assert torch.equal(b[:, dead], a[:, dead])
    _states_close(tc, jc)


def test_convert_carries_rwkv_state_and_params():
    """A JAX rwkv cache tree (stacked `RWKVState`s) becomes the port's, and
    decoding from it matches JAX's decoding from the original."""
    jp, tp, jcfg, tcfg = _pair("ternary")
    toks = _tokens(jcfg.vocab, (2, 9))
    jc = JT.init_caches(jcfg, 2, 16)
    _, jc = JT.prefill(jp, jnp.asarray(toks), jc, jcfg)
    tc = convert.from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    st = tc["stack"][0]["rwkv"]
    assert isinstance(st, R.RWKVState) and st.S.shape == (2, 2, 4, 16, 16)
    nxt = np.array([3, 7], np.int32)
    jl, _ = JT.decode_step(jp, jnp.asarray(nxt), jc, jcfg)
    tl, _ = T.decode_step(tp, torch.from_numpy(nxt), tc, tcfg)
    _close(tl, jl)
    assert np.array_equal(convert.to_numpy(st).S, np.asarray(
        jc["stack"][0]["rwkv"].S))
