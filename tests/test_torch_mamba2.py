"""The port's Mamba2 (SSD) mixer against the JAX package on the CPU.

The same numpy inputs go through `repro.models.mamba2` and
`repro_torch.models.mamba2`: the chunked SSD scan (several seeds, chunks of
4 and 8, lengths that are not a multiple of the chunk, with and without an
initial state) and its one-token recurrence unrolled, the causal conv with
a carried tail, and the whole mixer at zamba2-1.2b's `reduced()` size
(d_model 64, d_inner 128, 8 SSD heads of 16, state 16, conv 4, chunk 8,
fp32) on layer 0's weights of a JAX tree carried across with
`repro_torch.convert`, its SSM dynamics (dt bias, conv bias, D, the gated
norm) and channel scales walked off init.  Two trees: the fp masters and
the ternary packed export (JAX through its CPU dequantize fallback, the
port through the packed kernels' plain versions).

Tolerances: the scan, the step and the conv within 1e-5 (rtol and atol),
the same sums in another order; the mixer's output and state within the
dense tests' 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import qtensor as JQT
from repro.core import quantize as JQ
from repro.models import mamba2 as JM
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import quantize as Q
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T

from test_torch_transformer import _close, _np

torch.set_num_threads(1)
OFF_INIT = ("dt_bias", "conv_b", "D", "norm", "norm1", "norm2", "final_norm")


def _cfgs(mode: str):
    """(JAX cfg, port cfg) of zamba2-1.2b reduced, quant `mode`."""
    jcfg, tcfg = (j_get_config("zamba2-1.2b").reduced(),
                  get_config("zamba2-1.2b").reduced())
    if mode == "none":
        return (jcfg.with_quant(JQ.QuantSpec(mode="none")),
                tcfg.with_quant(Q.QuantSpec(mode="none")))
    return (jcfg.with_quant(JQ.QuantSpec(mode=mode, norm="channel")),
            tcfg.with_quant(Q.QuantSpec(mode=mode, norm="channel")))


def off_init(tree, seed=1):
    """The SSM dynamics, the norms and the channel scales walked off init."""
    rng = np.random.default_rng(seed)

    def walk(path, a):
        name = getattr(path[-1], "key", "")
        if name in OFF_INIT or name.startswith("s"):
            return a + 0.2 * rng.standard_normal(a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(walk, tree)


_MASTERS = []


def masters():
    """JAX zamba2 reduced masters (channel-scaled, off init), made once."""
    if not _MASTERS:
        _MASTERS.append(off_init(JT.model_init(jax.random.PRNGKey(0),
                                               _cfgs("ternary")[0])))
    return _MASTERS[0]


def _mixer(tree: str):
    """Layer 0's mixer params in both packages, and the configs."""
    jcfg, tcfg = _cfgs("none" if tree == "fp" else tree)
    jp = masters()
    if tree != "fp":
        jp = JQT.export_packed(jp, jcfg.quant)
    tp = convert.from_numpy(_np(jp), "cpu")
    jl = jax.tree.map(lambda a: a[0] if not JQT.is_qtensor(a) else
                      JQT.QTensor(codes=a.codes[0], scale=None, k=a.k,
                                  mode=a.mode, alpha=a.alpha),
                      jp["stack"][0]["mixer"], is_leaf=JQT.is_qtensor)
    return jl, T._layer_view(tp["stack"][0]["mixer"], 0), jcfg, tcfg


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, B=2, S=13, H=3, P=4, N=5):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=0.5: (rng.standard_normal(s) * sc).astype(np.float32)
    x = f(B, S, H, P)
    dt = np.log1p(np.exp(f(B, S, H, sc=1.0))).astype(np.float32)  # > 0
    A = -np.exp(f(H, sc=0.5)).astype(np.float32)
    return x, dt, A, f(B, S, N), f(B, S, N), f(B, H, N, P, sc=0.3)


def _unrolled(step, x, dt, A, Bm, Cm, h):
    ys = []
    for t in range(x.shape[1]):
        y, h = step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], h)
        ys.append(y)
    return ys, h


@pytest.mark.parametrize("S,chunk", [(13, 4), (16, 8), (5, 8), (1, 8),
                                     (21, 8)])
@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_chunked_matches_step_unrolled_and_jax(seed, S, chunk):
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(seed, S=S)
    tt = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, h0)]
    jj = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm, h0)]
    y_c, h_c = M.ssd_chunked(*tt[:5], chunk, tt[5])
    ys, h_s = _unrolled(M.ssd_step, *tt)
    y_s = torch.stack(ys, dim=1)
    for got, want in ((y_c, y_s), (h_c, h_s)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    jy_c, jh_c = JM.ssd_chunked(*jj[:5], chunk, jj[5])
    jys, jh_s = _unrolled(JM.ssd_step, *jj)
    _close(y_c, jy_c, 1e-5)
    _close(h_c, jh_c, 1e-5)
    _close(y_s, jnp.stack(jys, axis=1), 1e-5)
    _close(h_s, jh_s, 1e-5)
    # no initial state: zeros
    y0, h0c = M.ssd_chunked(*tt[:5], chunk)
    jy0, jh0 = JM.ssd_chunked(*jj[:5], chunk)
    _close(y0, jy0, 1e-5)
    _close(h0c, jh0, 1e-5)


def test_ssd_chunked_stays_finite_at_strong_decay():
    """dt A of about -80 a token over a 16-token chunk: the masked entries'
    exponents (up to +1200) are filled with -inf before the exp, so no inf
    is made; the result still equals the unrolled step and JAX's."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(2, S=16)
    dt = np.full_like(dt, 5.0)
    A = np.full_like(A, -16.0)
    tt = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, h0)]
    y, h = M.ssd_chunked(*tt[:5], 16, tt[5])
    ys, h_s = _unrolled(M.ssd_step, *tt)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    torch.testing.assert_close(y, torch.stack(ys, 1), rtol=1e-5, atol=1e-5)
    jy, _ = JM.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                           16, jnp.asarray(h0))
    _close(y, jy, 1e-5)


def test_causal_conv_with_tail_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    tail = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for t in (None, tail):
        ty, tt = M._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)),
                                None if t is None else torch.from_numpy(t))
        jy, jt = JM._causal_conv(*(jnp.asarray(a) for a in (x, w, b)),
                                 None if t is None else jnp.asarray(t))
        _close(ty, jy, 1e-5)
        assert np.array_equal(tt.numpy(), np.asarray(jt))
    # the conv over a whole sequence == over two pieces carrying the tail
    # (to the SiLU's rounding, whose vector and scalar paths differ)
    y, _ = M._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    y1, t1 = M._causal_conv(*(torch.from_numpy(a) for a in (x[:, :3], w, b)))
    y2, _ = M._causal_conv(*(torch.from_numpy(a) for a in (x[:, 3:], w, b)),
                           t1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------


def _state_close(t: M.SSMState, j, tol=1e-4):
    _close(t.h, j.h, tol)
    _close(t.conv, j.conv, tol)
    assert np.array_equal(t.pos.numpy(), np.asarray(j.pos))


@pytest.mark.parametrize("tree", ["fp", "ternary"])
def test_mamba2_apply_prefill_and_decode_matches_jax(tree):
    """Layer 0's mixer without a state, then carrying one: a 11-token
    prefill (the chunked scan over chunks of 8) and two decode tokens
    (`ssd_step`, by decode=True and by decode=None's choice)."""
    jl, tl, jcfg, tcfg = _mixer(tree)
    x = np.random.default_rng(6).standard_normal((2, 11, 64)).astype(
        np.float32)
    jo, jst = JM.mamba2_apply(jl, jnp.asarray(x), jcfg)
    to, tst = M.mamba2_apply(tl, torch.from_numpy(x), tcfg)
    assert jst is None and tst is None
    _close(to, jo)
    j0, t0 = (JM.state_init(jcfg, 2), M.state_init(tcfg, 2))
    jo, jst = JM.mamba2_apply(jl, jnp.asarray(x), jcfg, state=j0,
                              decode=False)
    to, tst = M.mamba2_apply(tl, torch.from_numpy(x), tcfg, state=t0,
                             decode=False)
    _close(to, jo)
    _state_close(tst, jst)
    for decode in (True, None):
        x1 = x[:, :1] * 0.5
        jo, jst = JM.mamba2_apply(jl, jnp.asarray(x1), jcfg, state=jst,
                                  decode=decode)
        to, tst = M.mamba2_apply(tl, torch.from_numpy(x1), tcfg, state=tst,
                                 decode=decode)
        _close(to, jo)
        _state_close(tst, jst)
    assert int(tst.pos) == 13


def test_one_token_prefill_is_the_chunked_scan_not_the_step():
    """decode=False at one token runs `ssd_chunked` at Q = 1, as JAX's
    cached step passes it; the state still equals JAX's."""
    jl, tl, jcfg, tcfg = _mixer("fp")
    x = np.random.default_rng(7).standard_normal((2, 1, 64)).astype(
        np.float32)
    jo, jst = JM.mamba2_apply(jl, jnp.asarray(x), jcfg,
                              state=JM.state_init(jcfg, 2), decode=False)
    to, tst = M.mamba2_apply(tl, torch.from_numpy(x), tcfg,
                             state=M.state_init(tcfg, 2), decode=False)
    _close(to, jo)
    _state_close(tst, jst)


def test_init_and_state_init_match_jax():
    jcfg, tcfg = _cfgs("ternary")
    jp = JM.mamba2_init(jax.random.PRNGKey(0), jcfg)
    tp = M.mamba2_init(torch.Generator().manual_seed(0), tcfg)
    assert set(tp) == set(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
    # the fixed leaves are the same numbers
    for k in ("A_log", "D", "norm", "conv_b", "sin", "sout"):
        _close(tp[k], jp[k], 1e-6)
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert ((dt >= 1e-3 - 1e-6) & (dt <= 0.1 + 1e-6)).all()
    for per_slot in (False, True):
        j = JM.state_init(jcfg, 3, per_slot=per_slot)
        t = M.state_init(tcfg, 3, per_slot=per_slot)
        for name in M.SSMState._fields:
            a, b = getattr(t, name), np.asarray(getattr(j, name))
            assert a.shape == b.shape and str(a.dtype)[6:] == str(b.dtype)
    lead = M.state_init(tcfg, 3, per_slot=True, lead=(2,))
    assert lead.h.shape == (2, 3, 8, 16, 16) and lead.pos.shape == (2, 3)
