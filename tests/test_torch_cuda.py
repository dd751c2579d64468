"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and skips without one.  They import
neither JAX nor the JAX package, so they run where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py configures JAX.)  The CPU tests
(tests/test_torch_*.py) hold the plain versions against the JAX package;
these hold the kernels against the plain versions at shapes the main path
does not reach: every GEMV row count, codes not 16-byte aligned, every
GEMM row tiling with and without a K split, ragged column counts, batches
that take several row passes of the fused tick (4 and 8 rows a pass),
three layers, heads wider than the main path's (vocab 7300 and 10,000),
and non-finite logits.  The GEMV, the GEMM and the tick are also launched
twice and must repeat bit for bit.

Tolerances: the packed products are exact (weights are -1/0/+1), so the
GEMV and GEMM differ from the exact sum only by fp32 summation error, which
grows with the sum of the magnitudes added, not with the result: both the
kernel and the plain version are held to the fp64 product within
1e-5 * (|x| @ |w|), about 5 * sqrt(K) * eps32 at K ~ 1000.  The fused tick
adds libm sigmoid/tanh and fused multiply-adds: 1e-5 absolute on h and c,
1e-4 on logits.  Dead rows are compared bit for bit.  quantize_pack's codes
are compared word for word, on the card and against the CPU.  A full-width
train step on the card is held to the same step on the CPU within 1e-4:
cuBLAS and the CPU sum the products in other orders, about 1e-6 of the
loss, and the launcher's learning rate keeps Adam's sign-like update on
near-zero gradients small.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bnlstm as BL
from repro_torch.core.qtensor import QTensor
from repro_torch.core.quantize import QuantSpec
from repro_torch.core.recurrent_bn import BNState
from repro_torch.kernels import decode_step as DK
from repro_torch.kernels import dispatch
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import packed_matmul as PK
from repro_torch.core import quantize as Q
from repro_torch.core.qtensor import tree_leaves, tree_to
from repro_torch.serve.recurrent import RNNRuntime
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    dispatch.strict_fp32()
    dispatch.reset_counts()
    return torch.device("cuda")


def _codes(rng, kw, n):
    words = rng.integers(0, 2**32, (kw, n), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32).copy())


def _assert_summation_close(got, want, x, codes, mode):
    """Kernel and plain version against the exact (fp64) product, within
    1e-5 of the summed magnitudes (see the module docstring)."""
    w = PK.packed_matmul_plain(torch.eye(x.shape[1], device=x.device), codes,
                               mode=mode).double()
    exact = x.double() @ w
    tol = 1e-5 * (x.double().abs() @ w.abs())
    for out in (got, want):
        assert ((out.double() - exact).abs() <= tol).all(), \
            (out.double() - exact).abs().max().item()


def _unaligned(codes):
    """A contiguous view of `codes` whose data pointer is 4 bytes past a
    16-byte boundary: the GEMV must take its scalar code loads."""
    flat = torch.empty(codes.numel() + 4, dtype=codes.dtype,
                       device=codes.device)
    view = flat[1:1 + codes.numel()].view(codes.shape)
    view.copy_(codes)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("layout", ["own", "unaligned"])
@pytest.mark.parametrize("bp", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("mode,group", [("ternary", 16), ("binary", 32)])
@pytest.mark.parametrize("K,N", [(1024, 4000), (2080, 100), (32, 33),
                                 (16384, 200)])
def test_packed_gemv_matches_plain(card, mode, group, bp, K, N, layout):
    """Every row count (instances of 1, 2, 4 and 8 rows), 16-byte code
    loads (N % 4 == 0) and scalar ones (N = 33, or codes not 16-byte
    aligned), K split over a cluster or not, and K long enough to take
    several passes a block."""
    rng = np.random.default_rng(bp * N)
    x = torch.from_numpy(rng.normal(size=(bp, K)).astype(np.float32)).to(card)
    codes = _codes(rng, K // group, N).to(card)
    if layout == "unaligned":
        codes = _unaligned(codes)
    got = PK.packed_gemv(x, codes, mode=mode)
    want = PK.packed_gemv_plain(x, codes, mode=mode)
    torch.cuda.synchronize()
    _assert_summation_close(got, want, x, codes, mode)
    assert dispatch.LAUNCHES["packed_gemv"] == 1


@pytest.mark.parametrize("mode,group,bp", [("ternary", 16, 4),
                                           ("binary", 32, 8)])
def test_packed_gemv_repeats_bit_for_bit(card, mode, group, bp):
    """Two launches at the main path's shape give the same bits: the K
    split sums its partials in a fixed order, with no atomics."""
    rng = np.random.default_rng(bp)
    K = 1024 if mode == "binary" else 1008
    x = np.tanh(rng.normal(size=(bp, K))).astype(np.float32)
    x[:, 1000:] = 0.0
    x = torch.from_numpy(x).to(card)
    codes = _codes(rng, K // group, 4000).to(card)
    got = PK.packed_gemv(x, codes, mode=mode)
    again = PK.packed_gemv(x, codes, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _assert_summation_close(got, PK.packed_gemv_plain(x, codes, mode=mode),
                            x, codes, mode)
    assert dispatch.LAUNCHES["packed_gemv"] == 2


@pytest.mark.parametrize("M", [1, 5, 8])
@pytest.mark.parametrize("mode", ["ternary", "binary"])
def test_qmatmul_stacked_on_the_card_matches_the_cpu(card, mode, M):
    """A stacked QTensor (L = 2) applies one GEMV a matrix on the card (the
    second matrix's codes are a view into the stack) and matches the plain
    versions on the CPU."""
    rng = np.random.default_rng(M)
    w = rng.uniform(-0.2, 0.2, (2, 136, 4000)).astype(np.float32)
    x = rng.normal(size=(2, M, 136)).astype(np.float32)
    qt = QTensor.from_master(torch.from_numpy(w), mode)
    want = OPS.qmatmul(torch.from_numpy(x), qt)
    got = OPS.qmatmul(torch.from_numpy(x).to(card), qt.to(card))
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["packed_gemv"] == 2
    assert not dispatch.LAUNCHES["packed_matmul"]
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("M", [9, 16, 70, 130])
@pytest.mark.parametrize("mode,group", [("ternary", 16), ("binary", 32)])
@pytest.mark.parametrize("K,N", [(1024, 4000), (96, 65)])
def test_packed_matmul_matches_plain(card, mode, group, M, K, N):
    rng = np.random.default_rng(M * N)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(card)
    codes = _codes(rng, K // group, N).to(card)
    got = PK.packed_matmul(x, codes, mode=mode)
    want = PK.packed_matmul_plain(x, codes, mode=mode)
    torch.cuda.synchronize()
    _assert_summation_close(got, want, x, codes, mode)
    assert dispatch.LAUNCHES["packed_matmul"] == 1


@pytest.mark.parametrize("M", [9, 15, 16, 17, 31, 32, 33, 130, 3200])
@pytest.mark.parametrize("mode,group", [("ternary", 16), ("binary", 32)])
@pytest.mark.parametrize("K,N", [(1024, 4000), (16384, 200), (160, 33)])
def test_packed_matmul_tiles_clusters_and_repeats(card, mode, group, M, K,
                                                  N):
    """Every row tiling (one 16-row tile, two, ragged last tiles, many),
    K split across a cluster and not, K up to 16,384, ragged N.  x is zero
    past the true K and the last code words are zero: binary decodes them
    to -1, so only the zero activations keep them out.  Two launches on the
    same inputs give the same bits."""
    rng = np.random.default_rng(M + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    x[:, K - group - 3:] = 0.0
    x = torch.from_numpy(x).to(card)
    codes = _codes(rng, K // group, N)
    codes[-1] = 0
    codes = codes.to(card)
    got = PK.packed_matmul(x, codes, mode=mode)
    again = PK.packed_matmul(x, codes, mode=mode)
    want = PK.packed_matmul_plain(x, codes, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _assert_summation_close(got, want, x, codes, mode)
    assert dispatch.LAUNCHES["packed_matmul"] == 2


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    codes = torch.zeros((4, 64), dtype=torch.int32, device=card)
    x = torch.zeros((2, 64), device=card)
    with pytest.raises(TypeError):
        PK.packed_gemv(x.double(), codes, mode="ternary")
    with pytest.raises(ValueError, match="contiguous"):
        PK.packed_gemv(torch.zeros((64, 2), device=card).T, codes,
                       mode="ternary")
    with pytest.raises(ValueError, match="at most 8 rows"):
        PK.packed_gemv(torch.zeros((9, 64), device=card), codes, mode="ternary")
    with pytest.raises(ValueError, match="mixed devices"):
        PK.packed_matmul(x.cpu(), codes, mode="ternary")
    assert not dispatch.LAUNCHES and not dispatch.PLAIN_CALLS


def _tick(card, cell, mode, hidden, layers, vocab, seed=0):
    cfg = BL.RNNConfig(vocab=vocab, d_hidden=hidden, n_layers=layers,
                       cell=cell, quant=QuantSpec(mode=mode, norm="batch"))
    g = torch.Generator().manual_seed(seed)
    var = BL.rnn_lm_init(g, cfg, device=card)
    var["state"]["layers"] = [
        {k: BNState(s.mean + 0.1 * torch.randn(s.mean.shape, generator=g).to(card),
                    s.var * (1 + 0.5 * torch.rand(s.var.shape, generator=g).to(card)),
                    s.count) for k, s in st.items()}
        for st in var["state"]["layers"]]
    var["params"]["head"]["bs"] = 0.1 * torch.randn(vocab, generator=g).to(card)
    qv = {"params": BL.export_packed_rnn(var["params"], cfg),
          "state": var["state"]}
    return cfg, qv, g


@pytest.mark.parametrize("B", [1, 8, 13])
@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("mode", ["ternary", "binary"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_fused_tick_matches_plain(card, cell, mode, layers, B):
    """Ragged H (136: neither a 128 tile nor a binary pack group), three
    layers (x-side GEMVs in the launch), B = 13 (two row passes), dead
    rows holding NaN and inf."""
    cfg, qv, g = _tick(card, cell, mode, hidden=136, layers=layers, vocab=50)
    tick = BL.rnn_decode_tables(qv, cfg)[0]["tick"]
    h = torch.tanh(torch.randn(layers, B, 136, generator=g)).to(card)
    c = torch.randn(layers, B, 136, generator=g).to(card)
    live = torch.rand(B, generator=g).to(card) > 0.3
    live[0] = True
    dead = (~live).nonzero()[:, 0].tolist()
    for r in dead:
        h[:, r] = float("nan")
        c[:, r] = float("inf")
    tok = torch.randint(0, 50, (B,), generator=g).to(card)
    args = OPS.tick_operands(tok, h, c, tick, live)
    got = DK.fused_tick(*args, cell=cell, mode=mode)
    want = DK.fused_tick_plain(*args, cell=cell, mode=mode)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["fused_tick"] == 1
    alive = live.nonzero()[:, 0]
    torch.testing.assert_close(got[0][:, alive], want[0][:, alive],
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(got[1][:, alive], want[1][:, alive],
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2][alive], want[2][alive], rtol=0, atol=1e-4)
    for r in dead:
        for out, inp in ((got[0], args[1]), (got[1], args[2])):
            assert torch.equal(out[:, r].view(torch.int32),
                               inp[:, r].view(torch.int32))
    # greedy is the argmax of the kernel's own logits
    torch.testing.assert_close(got[3][alive], DK.greedy_argmax(got[2][alive]))
    # pad lanes stay exactly zero across layers
    assert not got[0][..., 136:].any() and not got[1][..., 136:].any()


@pytest.mark.parametrize("B", [1, 3, 4, 5, 8, 13, 16])
@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_fused_tick_row_passes_layers_and_a_wide_head(card, cell, layers, B):
    """Both row passes (4 and 8 rows: B = 5 pads to 8, 13 to 16), one to
    three layers, a 10,000-word head (Vp 10,112: its partial products and
    the argmax spread over every block), ternary at even B and binary at
    odd, dead rows holding NaN and inf, a live row whose state is NaN (its
    logits are NaN, so greedy gives it Vp), and a bitwise repeat."""
    mode = "binary" if B % 2 else "ternary"
    cfg, qv, g = _tick(card, cell, mode, hidden=136, layers=layers,
                       vocab=10000)
    tick = BL.rnn_decode_tables(qv, cfg)[0]["tick"]
    h = torch.tanh(torch.randn(layers, B, 136, generator=g)).to(card)
    c = torch.randn(layers, B, 136, generator=g).to(card)
    live = torch.ones(B, dtype=torch.bool, device=card)
    dead = [r for r in (1, 4, 11) if r < B]
    nan_row = 2 if B > 2 else None
    for r in dead:
        live[r] = False
        h[:, r] = float("nan")
        c[:, r] = float("inf")
    if nan_row is not None:
        h[:, nan_row] = float("nan")
    tok = torch.randint(0, 10000, (B,), generator=g).to(card)
    args = OPS.tick_operands(tok, h, c, tick, live)
    vp = args[12].shape[1]
    got = DK.fused_tick(*args, cell=cell, mode=mode)
    again = DK.fused_tick(*args, cell=cell, mode=mode)
    want = DK.fused_tick_plain(*args, cell=cell, mode=mode)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["fused_tick"] == 2
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    ok = [r for r in range(B) if r not in dead and r != nan_row]
    torch.testing.assert_close(got[0][:, ok], want[0][:, ok], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[1][:, ok], want[1][:, ok], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2][ok], want[2][ok], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[3][ok], DK.greedy_argmax(got[2][ok]))
    for r in dead:
        for out, inp in ((got[0], args[1]), (got[1], args[2])):
            assert torch.equal(out[:, r].view(torch.int32),
                               inp[:, r].view(torch.int32))
    if nan_row is not None:
        assert torch.isnan(got[2][nan_row]).any()
        assert got[3][nan_row].item() == want[3][nan_row].item() == vp


@pytest.mark.parametrize("rows", [4, 8])
@pytest.mark.parametrize("layers", [1, 2])
def test_fused_tick_row_pass_choice(card, rows, layers):
    """The wrapper's row pass: B = 12 runs three passes of 4 rows, B = 16
    two of 8; both match the plain version, dead rows included."""
    B = 12 if rows == 4 else 16
    assert DK.tick_rows(B) == rows
    cfg, qv, g = _tick(card, "lstm", "ternary", hidden=136, layers=layers,
                       vocab=50)
    tick = BL.rnn_decode_tables(qv, cfg)[0]["tick"]
    h = torch.tanh(torch.randn(layers, B, 136, generator=g)).to(card)
    c = torch.randn(layers, B, 136, generator=g).to(card)
    live = torch.arange(B, device=card) % 5 != 2
    tok = torch.randint(0, 50, (B,), generator=g).to(card)
    args = OPS.tick_operands(tok, h, c, tick, live)
    got = DK.fused_tick(*args, cell="lstm", mode="ternary")
    want = DK.fused_tick_plain(*args, cell="lstm", mode="ternary")
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-4)
    assert torch.equal(got[3], DK.greedy_argmax(got[2]))


@pytest.mark.parametrize("B", [4, 16])
@pytest.mark.parametrize("vocab", [2000, 10000])
def test_fused_tick_early_and_late_heads(card, vocab, B):
    """Both heads at Hp 1024: vocab 2000 (Vp 2048, 16 columns an SM of an
    H100) sums the slices' early partial products, vocab 10,000 runs the
    head after the barrier in 128-column units; at B = 16 the late head
    stages two row passes.  Both match the plain version and repeat bit for
    bit."""
    n_sm = torch.cuda.get_device_properties(card).multi_processor_count
    cfg, qv, g = _tick(card, "lstm", "ternary", hidden=1000, layers=1,
                       vocab=vocab)
    tick = BL.rnn_decode_tables(qv, cfg)[0]["tick"]
    vp = tick["ws"].shape[1]
    assert DK.tick_late_head(vp, n_sm) == (vocab == 10000)
    h = torch.tanh(torch.randn(1, B, 1000, generator=g)).to(card)
    c = torch.randn(1, B, 1000, generator=g).to(card)
    tok = torch.randint(0, vocab, (B,), generator=g).to(card)
    args = OPS.tick_operands(tok, h, c, tick, None)
    got = DK.fused_tick(*args, cell="lstm", mode="ternary")
    again = DK.fused_tick(*args, cell="lstm", mode="ternary")
    want = DK.fused_tick_plain(*args, cell="lstm", mode="ternary")
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-4)
    assert torch.equal(got[3], DK.greedy_argmax(got[2]))


def test_fused_tick_greedy_nan_row_gets_vp(card):
    """A row whose logits hold a NaN matches no column in the JAX kernel's
    max/== pair and gets Vp; the CUDA reduction follows it."""
    cfg, qv, g = _tick(card, "lstm", "ternary", hidden=128, layers=1, vocab=50)
    tick = dict(BL.rnn_decode_tables(qv, cfg)[0]["tick"])
    tick["bs"] = tick["bs"].clone()
    tick["bs"][0, 7] = float("nan")
    h = torch.zeros(1, 2, 128, device=card)
    args = OPS.tick_operands(torch.tensor([1, 2], device=card), h, h.clone(),
                             tick, None)
    got = DK.fused_tick(*args, cell="lstm", mode="ternary")
    want = DK.fused_tick_plain(*args, cell="lstm", mode="ternary")
    assert got[3][:2].tolist() == want[3][:2].tolist() == [128, 128]


@pytest.mark.parametrize("B", [3, 16])
def test_runtime_on_the_card_matches_the_cpu(card, B):
    """Prefill, then decode with a wide head (vocab 7300: 58 times as many
    padded head columns as hidden ones) and the main path's (vocab 50),
    both in the launch: the card's kernels against the CPU's plain
    versions, same weights."""
    for vocab in (50, 7300):
        cfg, qv, g = _tick(card, "lstm", "binary", hidden=96, layers=2,
                           vocab=vocab)
        cpu_v = {"params": qv["params"], "state": qv["state"]}
        rt_card = RNNRuntime(cfg, qv, device="cuda")
        rt_cpu = RNNRuntime(cfg, cpu_v, device="cpu")
        prompt = torch.randint(0, vocab, (B, 6), generator=g)
        lc, sc = rt_card.prefill(prompt.to(card), rt_card.init_state(B))
        lp, sp = rt_cpu.prefill(prompt, rt_cpu.init_state(B))
        torch.testing.assert_close(lc.cpu(), lp, rtol=0, atol=1e-4)
        for i in range(4):
            tok = torch.randint(0, vocab, (B,), generator=g)
            lc, sc = rt_card.decode_step(tok.to(card), sc)
            lp, sp = rt_cpu.decode_step(tok, sp)
            torch.testing.assert_close(lc.cpu(), lp, rtol=0, atol=1e-4)
            torch.testing.assert_close(sc.h.cpu(), sp.h, rtol=0, atol=1e-5)
    prefill = "packed_gemv" if B <= 8 else "packed_matmul"
    assert dispatch.LAUNCHES["fused_tick"] == 8
    assert dispatch.LAUNCHES[prefill] >= 12


def test_gate_codes_stay_word_equal_on_the_card(card):
    w = torch.rand(136, 4 * 136, generator=torch.Generator().manual_seed(3))
    w = (w - 0.5) * 0.2
    for mode in ("ternary", "binary"):
        on_card = QTensor.from_master(w.to(card), mode)
        on_cpu = QTensor.from_master(w, mode)
        assert torch.equal(on_card.codes.cpu(), on_cpu.codes)
        assert torch.equal(OPS.prepare_gate_codes(on_card, 4).cpu(),
                           OPS.prepare_gate_codes(on_cpu, 4))


@pytest.mark.parametrize("mode,group", [("ternary", 16), ("binary", 32)])
@pytest.mark.parametrize("kw,N", [(1, 1), (2, 33), (63, 4000), (4, 130),
                                  (300, 257)])
@pytest.mark.parametrize("alpha", [0.05, 1.0, 3e-4])
def test_quantize_pack_matches_plain_word_for_word(card, mode, group, kw, N,
                                                   alpha):
    """K = kw * G (16 k and 32 k), ragged N; w reaches past +-alpha and
    holds exact 0, alpha and -alpha; u holds 0 and the sampling
    thresholds themselves."""
    K = kw * group
    rng = np.random.default_rng(K * N)
    w = (rng.normal(size=(K, N)) * alpha).astype(np.float32)
    w.flat[::7] = 0.0
    w.flat[1::11] = alpha
    w.flat[2::13] = -alpha
    u = rng.random((K, N), dtype=np.float32)
    u.flat[::5] = 0.0
    w_t, u_t = torch.from_numpy(w), torch.from_numpy(u)
    wn = torch.clamp(Q.divide(w_t, alpha), -1.0, 1.0)
    u_t.view(-1)[3::17] = wn.abs().view(-1)[3::17]
    u_t.view(-1)[4::19] = ((wn + 1.0) * 0.5).view(-1)[4::19]
    got = PK.quantize_pack(w_t.to(card), u_t.to(card), alpha, mode=mode)
    want = PK.quantize_pack_plain(w_t.to(card), u_t.to(card), alpha,
                                  mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), PK.quantize_pack_plain(w_t, u_t, alpha,
                                                         mode=mode))
    assert dispatch.LAUNCHES["quantize_pack"] == 1


def test_quantize_pack_refuses_what_the_kernel_does_not_take(card):
    w = torch.zeros((32, 8), device=card)
    with pytest.raises(TypeError):
        PK.quantize_pack(w.double(), w.double(), 0.1, mode="ternary")
    with pytest.raises(ValueError, match="contiguous"):
        PK.quantize_pack(torch.zeros((8, 32), device=card).T, w, 0.1,
                         mode="ternary")
    with pytest.raises(ValueError, match="mixed devices"):
        PK.quantize_pack(w, w.cpu(), 0.1, mode="binary")
    assert not dispatch.LAUNCHES and not dispatch.PLAIN_CALLS


def test_full_width_train_step_on_the_card_matches_the_cpu(card):
    """rnn-paper at H = 1000 (vocab 50, ternary), one step of the
    launcher's optimizer from one init, with the same injected noise."""
    from repro_torch.configs import get_rnn_config
    cfg = get_rnn_config("rnn-paper")
    opt = OPT.OptConfig(lr=1e-3, clip_norm=1.0, warmup_steps=20)
    var = BL.rnn_lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    st = TS.train_state_init(var["params"], opt, 1, bn_state=var["state"])
    noise = BL.draw_noise(st.params, torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (4, 9), generator=g)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    step = TS.make_rnn_train_step(cfg, opt)
    cpu, m_cpu = step(st, batch, noise=noise)
    dev, m_dev = step(tree_to(st, card), tree_to(batch, card),
                      noise=tree_to(noise, card))
    assert abs(float(m_dev["loss"]) - float(m_cpu["loss"])) <= 1e-4
    for a, b in zip(tree_leaves(dev), tree_leaves(cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)
