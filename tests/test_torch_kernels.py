"""Parity of the port's kernel modules with the JAX package's Pallas
kernels, on the CPU, where each wrapper runs its plain PyTorch version.

The JAX side runs the Pallas kernels in interpret mode, as its own tests do.
quantize_pack is compared word for word: its codes are bit-exact.
Tolerances: the packed GEMV/GEMM products are exact (weights are -1/0/+1)
and only the fp32 summation order differs, so 1e-5 abs/rel, the JAX
package's own kernel tolerance.  The fused tick adds sigmoid/tanh from two
libms and BN affines on top: 1e-5 abs on h, c and logits, again the JAX
package's own fused-vs-unfused tolerance.  Dead rows are compared BIT-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bnlstm as JBL
from repro.core import qtensor as JQT
from repro.core import quantize as JQ
from repro.kernels import ops as JOPS
from repro.kernels import packed_matmul as JPK
from repro.kernels import ref as JREF
from repro_torch.core import qtensor as QT
from repro_torch.core import quantize as Q
from repro_torch.kernels import decode_step as DK
from repro_torch.kernels import dispatch
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import packed_matmul as PK
from repro_torch.kernels import ref as REF

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _codes(rng, kw, n):
    return rng.integers(0, 2**32, (kw, n), dtype=np.uint64).astype(np.uint32)


# --- packed GEMV / GEMM ------------------------------------------------------


@pytest.mark.parametrize("bp", [1, 4, 8])
@pytest.mark.parametrize("mode,group", [("ternary", 16), ("binary", 32)])
def test_packed_gemv_plain_matches_pallas(mode, group, bp):
    rng = np.random.default_rng(bp)
    K, N = 256, 256
    x = rng.normal(size=(bp, K)).astype(np.float32)
    wp = _codes(rng, K // group, N)
    j = JPK.packed_gemv(jnp.asarray(x), jnp.asarray(wp), K, mode=mode,
                        interpret=True)
    t = PK.packed_gemv(_t(x), _t(wp), mode=mode)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    plus, minus = PK.code_masks(_t(wp), mode=mode)
    jplus, jminus = JPK.code_masks(jnp.asarray(wp), mode=mode)
    np.testing.assert_array_equal(plus.numpy(), np.asarray(jplus))
    np.testing.assert_array_equal(minus.numpy(), np.asarray(jminus))


@pytest.mark.parametrize("mode,group", [("ternary", 16), ("binary", 32)])
def test_packed_matmul_plain_matches_pallas(mode, group):
    rng = np.random.default_rng(5)
    M, K, N = 16, 512, 256
    x = rng.normal(size=(M, K)).astype(np.float32)
    wp = _codes(rng, K // group, N)
    j = JPK.packed_matmul(jnp.asarray(x), jnp.asarray(wp), K, mode=mode,
                          block=(8, 128, 256), interpret=True)
    t = PK.packed_matmul(_t(x), _t(wp), mode=mode)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("mode,group", [("ternary", 16), ("binary", 32)])
def test_matmul_oracles_match_jax_and_the_plain_kernels(mode, group):
    rng = np.random.default_rng(11)
    M, K, N, alpha = 12, 96, 40, 0.3
    x = rng.normal(size=(M, K)).astype(np.float32)
    wp = _codes(rng, K // group, N)
    name = f"{mode}_matmul_ref"
    j = getattr(JREF, name)(jnp.asarray(x), jnp.asarray(wp), K, alpha)
    t = getattr(REF, name)(_t(x), _t(wp), K, alpha)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    # the plain versions of both kernels compute the same unscaled product
    gemm = PK.packed_matmul_plain(_t(x), _t(wp), mode=mode) * alpha
    gemv = PK.packed_gemv_plain(_t(x[:8]), _t(wp), mode=mode) * alpha
    np.testing.assert_allclose(gemm.numpy(), t.numpy(), **TOL)
    np.testing.assert_allclose(gemv.numpy(), t[:8].numpy(), **TOL)


# --- quantize_pack -----------------------------------------------------------


@pytest.mark.parametrize("shape", [(256, 128), (64, 40), (1024, 96)])
@pytest.mark.parametrize("mode", ["ternary", "binary"])
def test_quantize_pack_plain_matches_pallas_word_for_word(mode, shape):
    """w spans past +-alpha (the clip) and has exact zeros and |w| ==
    alpha; u holds 0 and values equal to |wn| and (wn + 1) / 2."""
    rng = np.random.default_rng(shape[0] + shape[1])
    alpha = 0.05
    w = (rng.normal(size=shape) * 0.04).astype(np.float32)
    w.flat[::7] = 0.0
    w.flat[1::11] = alpha
    w.flat[2::13] = -alpha
    u = rng.random(shape, dtype=np.float32)
    u.flat[::5] = 0.0
    wn = np.clip(w / np.float32(alpha), -1, 1)
    u.flat[3::17] = np.abs(wn).flat[3::17]
    u.flat[4::19] = ((wn + 1) * np.float32(0.5)).flat[4::19]
    j = JOPS.quantize_pack(jnp.asarray(w), jnp.asarray(u), alpha, mode=mode,
                           interpret=True)
    dispatch.reset_counts()
    t = OPS.quantize_pack(_t(w), _t(u), alpha, mode=mode)
    assert dict(dispatch.PLAIN_CALLS) == {"quantize_pack": 1}
    assert not dispatch.LAUNCHES
    np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(j))
    ref = getattr(REF, f"quantize_pack_{mode}_ref")(_t(w), _t(u), alpha)
    np.testing.assert_array_equal(ref.numpy(), t.numpy())
    jref = getattr(JREF, f"quantize_pack_{mode}_ref")(jnp.asarray(w),
                                                      jnp.asarray(u), alpha)
    np.testing.assert_array_equal(np.asarray(jref), np.asarray(j))


@pytest.mark.parametrize("mode", ["ternary", "binary"])
def test_quantize_pack_fused_equals_two_step(mode):
    """Fused == (stochastic quantize, then pack), as the JAX test holds
    its kernel (tests/test_kernels.py)."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy((rng.normal(size=(256, 128)) * 0.03).astype(np.float32))
    u = torch.from_numpy(rng.random((256, 128), dtype=np.float32))
    a = 0.04
    fused = OPS.quantize_pack(w, u, a, mode=mode)
    if mode == "ternary":
        two = Q.pack_ternary(Q.ternarize_stochastic(w, u, a) / a)
    else:
        two = Q.pack_binary(Q.binarize_stochastic(w, u, a) / a)
    assert torch.equal(fused, two)


@pytest.mark.parametrize("mode", ["ternary", "binary"])
def test_quantize_pack_ragged_k_pads_to_the_qtensor_layout(mode):
    """A ragged K padded with w = 0 and u = 1.0 gives zero pad codes, the
    layout `QTensor.from_master` pads to."""
    rng = np.random.default_rng(6)
    K, N = 50, 24
    w = torch.from_numpy(rng.uniform(-0.3, 0.3, (K, N)).astype(np.float32))
    u = torch.from_numpy(rng.random((K, N), dtype=np.float32))
    kp = QT.QTensor.from_master(w, mode).codes.shape[0] * Q.pack_group(mode)
    pad = torch.nn.functional.pad
    codes = OPS.quantize_pack(pad(w, (0, 0, 0, kp - K)),
                              pad(u, (0, 0, 0, kp - K), value=1.0), 0.2,
                              mode=mode)
    dense = pad(Q.quantize(w, mode, 0.2, u, with_ste=False) / 0.2,
                (0, 0, 0, kp - K))
    pack = Q.pack_ternary if mode == "ternary" else Q.pack_binary
    assert torch.equal(codes, pack(dense))
    vals = Q.decode_codes(codes, mode)[K:]
    assert not vals.any()
    with pytest.raises(ValueError, match="multiple of"):
        OPS.quantize_pack(w, u, 0.2, mode=mode)
    with pytest.raises(ValueError, match="noise"):
        OPS.quantize_pack(w[:32], u[:16], 0.2, mode=mode)


@pytest.mark.parametrize("shape,xlead", [((136, 96), (3,)), ((136, 96), (8,)),
                                         ((136, 96), (9,)), ((40, 160), (4, 10)),
                                         ((3, 136, 96), (3, 5))])
@pytest.mark.parametrize("mode", ["ternary", "binary"])
def test_qmatmul_matches_pallas_and_routes(mode, shape, xlead):
    """Ragged K (not a pack-group multiple), leading dims, stacked
    QTensors; M <= 8 rows take the GEMV, more rows the GEMM."""
    rng = np.random.default_rng(len(xlead) + shape[-1])
    w = rng.uniform(-0.2, 0.2, shape).astype(np.float32)
    x = rng.normal(size=xlead + (shape[-2],)).astype(np.float32)
    jqt = JQT.QTensor.from_master(jnp.asarray(w), mode)
    tqt = QT.QTensor.from_master(torch.from_numpy(w), mode)
    j = JOPS.qmatmul(jnp.asarray(x), jqt, interpret=True)
    dispatch.reset_counts()
    t = OPS.qmatmul(torch.from_numpy(x), tqt)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    mats = shape[0] if len(shape) == 3 else 1
    rows = int(np.prod(xlead)) // mats
    route = "packed_gemv" if rows <= 8 else "packed_matmul"
    assert dict(dispatch.PLAIN_CALLS) == {route: mats}
    assert not dispatch.LAUNCHES


@pytest.mark.parametrize("rows", [1, 3, 8, 9, 20])
@pytest.mark.parametrize("role", [None, "sequence", "step"])
def test_product_role_picks_the_route(role, rows):
    """The product's role picks its kernel at any row count: "sequence" the
    GEMM, "step" the GEMV; with no role stated, JAX's rule (M <= 8 the
    GEMV).  Both routes compute the same function as JAX's qmatmul; the
    role comes back on leaving the context, also on an error."""
    rng = np.random.default_rng(rows)
    w = rng.uniform(-0.2, 0.2, (96, 40)).astype(np.float32)
    x = rng.normal(size=(rows, 96)).astype(np.float32)
    want = JOPS.qmatmul(jnp.asarray(x), JQT.QTensor.from_master(
        jnp.asarray(w), "ternary"), interpret=True)
    tqt = QT.QTensor.from_master(torch.from_numpy(w), "ternary")
    dispatch.reset_counts()
    with OPS.product_role(role):
        assert OPS.current_role() == role
        t = OPS.qmatmul(torch.from_numpy(x), tqt)
    assert OPS.current_role() is None
    np.testing.assert_allclose(t.numpy(), np.asarray(want), **TOL)
    gemv = role == "step" or (role is None and rows <= OPS.GEMV_MAX_ROWS)
    route = "packed_gemv" if gemv else "packed_matmul"
    assert dict(dispatch.PLAIN_CALLS) == {route: 1}
    with pytest.raises(ValueError, match="unknown product role"):
        with OPS.product_role("prefill"):
            pass
    with pytest.raises(RuntimeError):
        with OPS.product_role("step"):
            with OPS.product_role("sequence"):
                raise RuntimeError("inside")
    assert OPS.current_role() is None


@pytest.mark.parametrize("mode", ["ternary", "binary"])
def test_qmatmul_channel_scale_and_alpha_match_pallas(mode):
    rng = np.random.default_rng(12)
    w = rng.uniform(-0.3, 0.3, (72, 48)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 48).astype(np.float32)
    x = rng.normal(size=(5, 72)).astype(np.float32)
    jqt = JQT.QTensor.from_master(jnp.asarray(w), mode, 0.25, jnp.asarray(scale))
    tqt = QT.QTensor.from_master(torch.from_numpy(w), mode, 0.25,
                                 torch.from_numpy(scale))
    j = JOPS.qmatmul(jnp.asarray(x), jqt, interpret=True)
    t = OPS.qmatmul(torch.from_numpy(x), tqt)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    np.testing.assert_allclose(tqt.dequantize().numpy(),
                               np.asarray(jqt.dequantize()), **TOL)


def test_wrappers_refuse_mixed_devices_and_resolve_device(monkeypatch):
    with pytest.raises(ValueError, match="mixed devices"):
        dispatch.on_card("packed_gemv", torch.zeros(1, device="cpu"),
                         torch.zeros(1, device="meta"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatch.resolve_device(None)
    assert dispatch.resolve_device("cpu") == torch.device("cpu")


# --- the fused tick ----------------------------------------------------------


def _jax_packed(cell, mode, hidden=40, layers=2, vocab=50, seed=0):
    cfg = JBL.RNNConfig(vocab=vocab, d_hidden=hidden, n_layers=layers,
                        cell=cell, quant=JQ.QuantSpec(mode=mode, norm="batch"))
    var = JBL.rnn_lm_init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    # walk the BN stats off init so the folded affines are non-trivial
    var["state"] = jax.tree.map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        var["state"])
    qvar = {"params": JBL.export_packed_rnn(var["params"], cfg),
            "state": var["state"]}
    tables = JBL.rnn_decode_tables(qvar, cfg, dense=False)
    return cfg, tables[0]["tick"]


def _state(cfg, B, seed=3):
    rng = np.random.default_rng(seed)
    shp = (cfg.n_layers, B, cfg.d_hidden)
    return (np.tanh(rng.normal(size=shp)).astype(np.float32),
            rng.normal(size=shp).astype(np.float32))


def _both_ticks(cfg, tick, tok, h, c, live=None):
    jout = JOPS.fused_decode_tick(
        jnp.asarray(tok), jnp.asarray(h), jnp.asarray(c), tick, cell=cfg.cell,
        mode=cfg.quant.mode, vocab=cfg.vocab,
        live=None if live is None else jnp.asarray(live), interpret=True)
    ttick = {k: _t(v) for k, v in tick.items()}
    dispatch.reset_counts()
    tout = OPS.fused_decode_tick(
        torch.from_numpy(tok), torch.from_numpy(h), torch.from_numpy(c),
        ttick, cell=cfg.cell, mode=cfg.quant.mode, vocab=cfg.vocab,
        live=None if live is None else torch.from_numpy(live))
    assert dict(dispatch.PLAIN_CALLS) == {"fused_tick": 1}
    return [np.asarray(a) for a in jout], [a.numpy() for a in tout]


@pytest.mark.parametrize("B", [1, 4, 5])
@pytest.mark.parametrize("mode", ["ternary", "binary"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_fused_tick_plain_matches_pallas(cell, mode, B):
    cfg, tick = _jax_packed(cell, mode)
    h, c = _state(cfg, B)
    tok = np.arange(B, dtype=np.int32) * 7 % cfg.vocab
    (jl, jh, jc, jg), (tl, th, tc, tg) = _both_ticks(cfg, tick, tok, h, c)
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    np.testing.assert_allclose(th, jh, atol=1e-5)
    np.testing.assert_allclose(tc, jc, atol=1e-5)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tg, np.argmax(tl, axis=-1))


@pytest.mark.parametrize("B,bp", [(1, 4), (4, 4), (5, 8)])
def test_tick_operands_pad_the_batch_to_four(B, bp):
    """The port pads the batch to a multiple of 4 (the CUDA kernel's
    smallest row pass), the JAX kernel to 8: pad rows hold zero state and
    are dead, and the tick still matches the JAX kernel on the real rows."""
    cfg, tick = _jax_packed("lstm", "ternary", layers=2)
    h, c = _state(cfg, B)
    live = np.ones(B, bool)
    live[-1] = B == 1
    tok = np.arange(B, dtype=np.int32) * 3 % cfg.vocab
    ttick = {k: _t(v) for k, v in tick.items()}
    ops = OPS.tick_operands(torch.from_numpy(tok), torch.from_numpy(h),
                            torch.from_numpy(c), ttick,
                            torch.from_numpy(live))
    ax0, hp_, cp_, live_m = ops[:4]
    assert ax0.shape[0] == hp_.shape[1] == cp_.shape[1] == live_m.shape[0] == bp
    assert not ax0[B:].any() and not hp_[:, B:].any() and not cp_[:, B:].any()
    assert not live_m[B:].any()
    assert DK.tick_rows(bp) == (8 if bp % 8 == 0 else 4)
    (jl, jh, jc, jg), (tl, th, tc, tg) = _both_ticks(cfg, tick, tok, h, c,
                                                     live)
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    np.testing.assert_allclose(th, jh, atol=1e-5)
    np.testing.assert_allclose(tc, jc, atol=1e-5)
    np.testing.assert_array_equal(tg, jg)


@pytest.mark.parametrize("bp,rows", [(4, 4), (8, 8), (12, 4), (16, 8),
                                     (6, None), (0, None)])
def test_tick_rows_follow_the_padded_batch(bp, rows):
    """The row pass: 8 rows where 8 divide the padded batch, else 4; a
    batch not padded to 4 is refused."""
    if rows is None:
        with pytest.raises(ValueError, match="padded to 4"):
            DK.tick_rows(bp)
    else:
        assert DK.tick_rows(bp) == rows


def test_tick_grid_covers_the_slices_and_the_head():
    """rnn-paper decode (Hp 1024, Vp 128): one block per 8-column slice;
    a 10,000-word head at Hp 128 gets a block per 8 of its logits."""
    assert DK.tick_grid_max(4, 1024, 128) == 128
    assert DK.tick_grid_max(16, 1024, 128) == 256
    assert DK.tick_grid_max(16, 128, 10112) == 16 * 10112 // 8


@pytest.mark.parametrize("vp,n_sm,late", [
    (128, 132, False),     # rnn-paper: Vp 128, early partials on every block
    (2048, 132, False),    # 16 columns an SM
    (4224, 132, True),     # 32 columns an SM: 33 units of 128
    (10112, 132, True),    # word-PTB: 79 units of 128
    (10112, 400, False),
    (4160, 130, False),    # not a whole number of 128-column units
])
def test_tick_late_head_needs_a_unit_an_sm(vp, n_sm, late):
    """The head runs after the barrier only where it has 32 columns an SM
    or more, in whole 128-column units; a narrower head keeps the early
    per-slice partials."""
    assert DK.tick_late_head(vp, n_sm) is late


# the GEMM shapes of PERF.md section 6: (K, N) of the codes, the mode, and
# the cluster matmul_plan picks
GEMM_SHAPES = [
    (1008, 4000, "ternary", 4),    # rnn-paper h-side, K = 1000 padded
    (1024, 4000, "binary", 4),
    (1024, 2048, "ternary", 4),    # qwen3 Wq
    (3072, 1024, "ternary", 8),    # qwen3 Wdown
    (2048, 768, "ternary", 8),     # qwen3-moe expert Wgate
    (768, 2048, "ternary", 2),     # qwen3-moe expert Wdown: 12 k-tiles
    (2048, 4096, "ternary", 8),    # qwen3-moe Wq
    (2048, 512, "ternary", 8),     # qwen3-moe Wk
    (4096, 14336, "ternary", 2),   # mixtral expert Wgate, rwkv6 Wck
    (14336, 4096, "ternary", 8),   # mixtral expert Wdown, rwkv6 Wcv
    (4096, 4096, "ternary", 8),    # rwkv6 Wr
    (2048, 8384, "ternary", 2),    # zamba2 Win
    (4096, 2048, "ternary", 8),    # zamba2 Wout
    (2048, 2048, "ternary", 8),    # zamba2 shared Wq
    (2048, 8192, "ternary", 4),    # zamba2 shared Wgate
    (8192, 2048, "ternary", 8),    # zamba2 shared Wdown
    (512, 512, "ternary", 2),      # whisper Wq: 8 k-tiles, 4 column tiles
    (512, 2048, "ternary", 2),     # whisper Wfc1
    (2048, 512, "binary", 8),      # whisper Wfc2, binary
    (8192, 8192, "ternary", 4),    # vlm Wq
    (8192, 1024, "ternary", 8),    # vlm Wk, self and cross
    (8192, 28672, "ternary", 1),   # vlm Wgate: 224 column tiles
    (28672, 8192, "ternary", 4),   # vlm Wdown
    (64, 33, "ternary", 1),        # N % 4 != 0: the cp.async variant
]


@pytest.mark.parametrize("K,N,mode,cluster", GEMM_SHAPES)
def test_matmul_plan_does_not_follow_m(K, N, mode, cluster, monkeypatch):
    """The GEMM's plan fixes every choice that orders a row's sum (tile,
    k-tiles, the K split) from (K, N, mode) alone: `matmul_plan` takes no
    M, and the wrapper launches with the same arguments but M at every M
    from 1 to 4096 (captured here in place of the launch), so a row's bits
    do not follow the row count.  The split doubles while one 64-row tile
    of blocks is short of one an SM and every block keeps 4 k-tiles; the
    codes go by TMA where N % 4 == 0."""
    import inspect
    assert "M" not in inspect.signature(PK.matmul_plan).parameters
    plan = PK.matmul_plan(K, N, mode=mode)
    assert plan["cluster"] == cluster
    assert plan["tiles"] == -(-N // PK.GEMM_COLS)
    assert plan["k_tiles"] == -(-K // PK.GEMM_K)
    assert plan["k_tiles"] >= cluster * PK.GEMM_MIN_K_TILES or cluster == 1
    assert plan["blocks"] == plan["tiles"] * cluster
    assert plan["tma"] is (N % 4 == 0)
    seen = []
    monkeypatch.setattr(PK.dispatch, "on_card", lambda *a: True)
    monkeypatch.setattr(PK.build, "launch",
                        lambda name, dev, x, c, o, *args: seen.append(args))
    monkeypatch.setattr(PK.dispatch, "check", lambda *a: None)
    codes = torch.zeros((K // Q.pack_group(mode), N), dtype=torch.int32)
    row = torch.zeros((1, K))
    for M in range(1, 4097):
        # one row's storage seen as M rows; the output is allocated and
        # never written
        PK.packed_matmul(row.expand(M, K), codes, mode=mode)
    want = (K, N, PK.MODES[mode], cluster, int(plan["tma"]))
    assert [a[0] for a in seen] == list(range(1, 4097))
    assert all(a[1:] == want for a in seen)


@pytest.mark.parametrize("bp,K,N,mode,cluster,rows", [
    (4, 1008, 4000, "ternary", 2, 4),   # B = 4 prefill, h-side GEMV
    (1, 1008, 4000, "ternary", 2, 1),
    (8, 1024, 4000, "binary", 2, 8),
    (3, 1008, 4000, "ternary", 2, 4),
    (4, 656, 2600, "ternary", 2, 4),    # word-PTB medium
    (4, 1504, 6000, "ternary", 1, 4),   # word-PTB large: 188 tiles
    (4, 2000, 8000, "ternary", 1, 4),   # char-text8: 250 tiles
    (4, 64, 256, "ternary", 4, 4),      # 4 code words: one a block
    (5, 32, 33, "ternary", 2, 8),       # 2 code words: split once
    (2, 16, 4000, "ternary", 1, 2),     # 1 code word: no split
])
def test_gemv_plan_fills_the_card(bp, K, N, mode, cluster, rows):
    """At the main path's shapes the GEMV's grid holds at least as many
    blocks as an H100 has SMs (132): 32-column tiles, K split by a
    cluster of at most 8 blocks, each keeping at least 1 code word; the
    instance is the least of 1, 2, 4, 8 rows that holds bp; N % 4 != 0
    takes the scalar path."""
    plan = PK.gemv_plan(bp, K, N, mode=mode)
    words = K // Q.pack_group(mode)
    assert (plan["cluster"], plan["rows"]) == (cluster, rows)
    assert 1 <= plan["cluster"] <= PK.MAX_CLUSTER
    assert words // plan["cluster"] >= 1
    assert plan["tiles"] == -(-N // 32)
    assert plan["blocks"] == plan["tiles"] * plan["cluster"]
    if words >= 8 and N >= 2600:
        assert plan["blocks"] >= PK.SMS
    assert plan["vec"] is (N % 4 == 0)


@pytest.mark.parametrize("hidden", [40, 136])
def test_fused_tick_ragged_hidden_binary_pad_codes(hidden):
    """H neither a 128-tile nor a pack-group multiple, binary (pad code
    decodes to -1): pad lanes must contribute nothing across layers."""
    cfg, tick = _jax_packed("lstm", "binary", hidden=hidden)
    h, c = _state(cfg, 2)
    tok = np.array([5, 11], np.int32)
    (jl, jh, _, _), (tl, th, _, _) = _both_ticks(cfg, tick, tok, h, c)
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    np.testing.assert_allclose(th, jh, atol=1e-5)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_fused_tick_dead_rows_freeze_bit_exact(cell):
    cfg, tick = _jax_packed(cell, "ternary")
    h, c = _state(cfg, 4)
    h[:, 1] = np.nan        # dead-row garbage may be non-finite
    c[:, 3] = np.inf
    live = np.array([True, False, True, False])
    tok = np.array([3, 7, 1, 9], np.int32)
    (jl, jh, jc, _), (tl, th, tc, _) = _both_ticks(cfg, tick, tok, h, c, live)
    for dead in (1, 3):
        np.testing.assert_array_equal(th[:, dead], h[:, dead])
        np.testing.assert_array_equal(tc[:, dead], c[:, dead])
    for alive in (0, 2):
        np.testing.assert_allclose(th[:, alive], jh[:, alive], atol=1e-5)
        np.testing.assert_allclose(tc[:, alive], jc[:, alive], atol=1e-5)
        np.testing.assert_allclose(tl[alive], jl[alive], atol=1e-5)


def test_fused_tick_head_outside_the_launch():
    """A vocab whose padded head passes the JAX kernel's 4 MiB VMEM budget:
    JAX runs the head outside its launch, the port keeps it inside (the
    CUDA kernel streams the head at any width); the results agree."""
    cfg, tick = _jax_packed("lstm", "ternary", hidden=40, layers=1,
                            vocab=7300)
    hp, vp = tick["ws"].shape
    assert (hp * vp + 2 * 8 * vp) * 4 > JOPS.HEAD_VMEM_BYTES
    h, c = _state(cfg, 3)
    tok = np.array([0, 4000, 7299], np.int32)
    (jl, jh, _, jg), (tl, th, _, tg) = _both_ticks(cfg, tick, tok, h, c)
    np.testing.assert_allclose(tl, jl, atol=1e-5)
    np.testing.assert_allclose(th, jh, atol=1e-5)
    np.testing.assert_array_equal(tg, jg)


def test_greedy_argmax_ties_and_nan_follow_the_jax_kernel():
    lg = np.array([[1.0, 3.0, 3.0, -1.0],
                   [np.nan, 1.0, 2.0, 0.0],
                   [-np.inf, -np.inf, -np.inf, -np.inf],
                   [0.0, np.inf, 5.0, np.inf]], np.float32)
    jl = jnp.asarray(lg)
    mx = jnp.max(jl, axis=-1, keepdims=True)
    col = jax.lax.broadcasted_iota(jnp.int32, jl.shape, 1)
    want = jnp.min(jnp.where(jl == mx, col, lg.shape[1]), axis=-1)
    got = DK.greedy_argmax(torch.from_numpy(lg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [1, 4, 0, 1]


def test_prepare_gate_codes_matches():
    rng = np.random.default_rng(9)
    w = rng.uniform(-0.1, 0.1, (136, 3 * 136)).astype(np.float32)
    for mode in ("ternary", "binary"):
        j = JOPS.prepare_gate_codes(JQT.QTensor.from_master(jnp.asarray(w), mode), 3)
        t = OPS.prepare_gate_codes(QT.QTensor.from_master(torch.from_numpy(w), mode), 3)
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(j))
