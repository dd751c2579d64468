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
and non-finite logits; and the MoE path's per-expert shapes (qwen3-moe's
2048 <-> 768, mixtral's 4096 <-> 14336) on an expert's slice of stacked
codes, with one MoE layer and one rwkv layer against their CPU run; and
the hybrid and audio paths' shapes (zamba2's Win at N = 8384, whisper's
K = 512 and its encoder's M = 6000) with reduced zamba2 and whisper
runtimes against their CPU run; and the vlm's (d 8192 and d_ff 28,672
at decode rows and M = 512, its cross K/V at M = 6400), with one training
step of every reduced arch against its CPU step; and gradient compression
on the card against the CPU, bit for bit, with one compressed step of
each family over an NCCL group of one rank.  The GEMV, the GEMM and
the tick are also launched twice and must repeat bit for bit.
`ordered_bmm` is held across its routes (`chip_smoke.bmm_crossings`): a
row's bits the same alone, on the small route, in a 256-row tile and as
column 0 of P = 1, 2 and 160, with K zero-padded and through the keys'
and values' permuted views, at K up to 8192 and the SSD readout's shape.

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
    """Every row tiling (one 64-row tile, two, ragged last tiles, many),
    K split across a cluster and not, K up to 16,384, ragged N (N = 33:
    the cp.async variant for the codes).  x is zero
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


@pytest.mark.parametrize("mode,group", [("ternary", 16), ("binary", 32)])
@pytest.mark.parametrize("K,N", [(1024, 4000), (16384, 200), (160, 33),
                                 (1024, 2048), (3072, 1024)])
def test_packed_row_bits_do_not_follow_the_row_count(card, mode, group, K, N):
    """Batch invariance within each route: a row of x gets the same bits
    from the GEMM (the sequence route) at any row count, its plan being
    fixed by (K, N, mode), and from the GEMV (the step route) at any row
    count, one launch up to 8 rows or 8-row tiles above; so a prompt's
    state does not depend on how it was chunked nor a request's on its
    batch.  The two routes sum in different orders, so their bits are not
    compared with each other: a product's role, not its row count, keeps
    a row on one route."""
    rng = np.random.default_rng(K + N)
    x = torch.from_numpy(rng.normal(size=(130, K)).astype(np.float32)
                         ).to(card)
    codes = _codes(rng, K // group, N).to(card)
    bits = lambda t: t.view(torch.int32)
    for fn, parts in ((PK.packed_matmul, ((0, 9), (0, 16), (5, 38),
                                          (97, 130), (0, 1), (64, 65),
                                          (129, 130))),
                      (PK.packed_gemv, ((0, 8), (40, 43), (129, 130),
                                        (64, 65), (3, 17)))):
        full = fn(x, codes, mode=mode)
        for lo, hi in parts:
            part = fn(x[lo:hi].contiguous(), codes, mode=mode)
            assert torch.equal(bits(part), bits(full[lo:hi])), \
                (fn.__name__, lo, hi)


@pytest.mark.parametrize("M", [1, 4, 9, 16, 63, 65, 512, 6000])
@pytest.mark.parametrize("mode,group", [("ternary", 16), ("binary", 32)])
@pytest.mark.parametrize("K,N", [(1024, 4000), (2080, 100), (160, 33)])
def test_packed_matmul_on_the_tensor_cores(card, mode, group, K, N, M):
    """The GEMM (three bf16 terms of x on the tensor cores) within 1e-5 of
    |x| @ |w| of the fp64 product at every row count from 1 to 6000, with
    K not a multiple of the 64-k stage (2080) and N = 33 (no TMA for the
    codes: the cp.async variant); two launches bit-equal, and every row
    the bits of the same row in a 6000-row launch."""
    rng = np.random.default_rng(K + N)
    xs = torch.from_numpy(np.tanh(rng.normal(size=(6000, K))).astype(
        np.float32)).to(card)
    codes = _codes(rng, K // group, N).to(card)
    full = PK.packed_matmul(xs, codes, mode=mode)
    x = xs[:M]
    got = PK.packed_matmul(x, codes, mode=mode)
    again = PK.packed_matmul(x, codes, mode=mode)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["packed_matmul"] == 3
    bits = lambda t: t.view(torch.int32)
    assert torch.equal(bits(got), bits(again))
    assert torch.equal(bits(got), bits(full[:M]))
    _assert_summation_close(got, PK.packed_matmul_plain(x, codes, mode=mode),
                            x, codes, mode)


def test_two_layer_rnn_chunked_prefill_is_bit_equal(card):
    """The RNN at L = 2, H = 256: layer 1's x side takes a chunk in the
    engine and the whole prompt in `drive_session`, both on the GEMM (the
    sequence route) at any chunk length; the carried state is the same
    bits either way."""
    import dataclasses
    from repro_torch.configs import get_rnn_config
    cfg = dataclasses.replace(get_rnn_config("rnn-paper"), d_hidden=256,
                              n_layers=2)
    gen = torch.Generator().manual_seed(1)
    var = BL.rnn_lm_init(gen, cfg, device=card)
    rt = RNNRuntime(cfg, {"params": BL.export_packed_rnn(var["params"], cfg),
                          "state": var["state"]}, device=card)
    for S in (5, 12, 33, 40):
        toks = torch.randint(0, cfg.vocab, (1, S), generator=gen).to(card)
        _, whole = rt.prefill(toks, rt.init_state(1, per_slot=True))
        for chunk in (8, 32):
            st = rt.init_state(1, per_slot=True)
            for lo in range(0, S, chunk):
                _, st = rt.prefill_chunk(toks[:, lo:lo + chunk], st)
            for a, b in ((st.h, whole.h), (st.c, whole.c)):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                    (S, chunk)


def _crossings(a, b, got):
    """chip_smoke.bmm_crossings: `got` against the same product on every
    route and layout, bit for bit (it lives beside phase 3's rows, which
    hold every `ordered_bmm` shape of the main path to it)."""
    import chip_smoke
    return chip_smoke.bmm_crossings(a, b, got)


@pytest.mark.parametrize("N,M,K,P", [(32, 2, 128, 160), (8, 33, 64, 70),
                                     (3, 256, 256, 128), (1, 1, 16, 1),
                                     (4, 1, 64, 4096), (2, 3, 8192, 40),
                                     (32, 8, 128, 160), (2, 300, 70, 131)])
def test_ordered_bmm_matches_plain_and_keeps_row_bits(card, N, M, K, P):
    """Attention's products: within 1e-5 of |a| @ |b| of the fp64 product,
    two launches bit-equal, and a row's bits the same whatever the batch
    and row counts around it (a pair alone, a row alone, a slice); and on
    every route and layout (`_crossings`: a row alone, on the small route,
    in a 256-row tile, column 0 of P = 1, 2 and 160, K zero-padded, the
    keys' and values' views)."""
    from repro_torch.kernels import ordered_bmm as OB
    g = torch.Generator().manual_seed(N * M + K)
    a = torch.randn(N, M, K, generator=g).to(card)
    b = torch.randn(N, K, P, generator=g).to(card)
    got = OB.ordered_bmm(a, b)
    exact = a.double() @ b.double()
    tol = 1e-5 * (a.double().abs() @ b.double().abs())
    assert ((got.double() - exact).abs() <= tol).all()
    bits = lambda t: t.contiguous().view(torch.int32)
    assert torch.equal(bits(got), bits(OB.ordered_bmm(a, b)))
    assert torch.equal(bits(OB.ordered_bmm(a[-1:], b[-1:])), bits(got[-1:]))
    assert torch.equal(bits(OB.ordered_bmm(a[:, -1:].contiguous(), b)),
                       bits(got[:, -1:]))
    assert torch.equal(bits(OB.ordered_bmm(a[:, :(M + 1) // 2].contiguous(),
                                           b)), bits(got[:, :(M + 1) // 2]))
    assert dispatch.LAUNCHES["ordered_bmm"] == 5
    routes = _crossings(a, b, got)
    assert OB.route(N, M, K, P) in routes and len(routes) >= 2


@pytest.mark.parametrize("rows,K", [(4, 1024), (33, 4096), (1, 7),
                                    (4, 8192), (512, 1024), (64, 128),
                                    (3, 8195)])
def test_ordered_bmm_dot_path_keeps_the_tiled_bits(card, rows, K):
    """The norms' row sums (P = 1) take the kernel's row route: its bits
    are the other routes' (the same column twice: the small route up to 16
    rows, a tile above; and `_crossings`), whatever the row count, and
    `layers.mean_square` serves through it with autograd off."""
    from repro_torch.kernels import ordered_bmm as OB
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(rows + K)
    x = torch.randn(rows, K, generator=g).to(card)
    a, b = x * x, torch.ones(K, 1, device=card)
    bits = lambda t: t.contiguous().view(torch.int32)
    got = OB.ordered_bmm(a, b)
    assert torch.equal(bits(got),
                       bits(OB.ordered_bmm(a, torch.cat([b, b], -1))[:, :1]))
    assert torch.equal(bits(OB.ordered_bmm(a[-1:], b)), bits(got[-1:]))
    exact = a.double() @ b.double()
    assert ((got.double() - exact).abs() <= 1e-5 * exact).all()
    with torch.no_grad():
        assert torch.equal(bits(L.mean_square(x)), bits(got / K))
    assert dispatch.LAUNCHES["ordered_bmm"] == 4
    assert OB.route(1, rows, K, 1) == "row"
    assert len(_crossings(a[None], b[None], got[None])) >= 3


@pytest.mark.parametrize("arch,dtype", [
    ("qwen3-0.6b", "float32"), ("qwen3-0.6b", "bfloat16"),
    ("qwen3-moe-30b-a3b", "bfloat16"), ("rwkv6-7b", "bfloat16"),
    ("zamba2-1.2b", "bfloat16")])
def test_qwen3_engine_streams_equal_drive_session_on_the_card(card, arch,
                                                              dtype):
    """Batch invariance of the transformer pool's serving path on the
    card: a reduced packed arch's engine (8 slots, chunks of 4 or whole
    prompts, sampled and greedy) gives every request the stream it gets
    alone through `drive_session(B=1)`, byte for byte."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import export_packed
    from repro_torch.launch.serve import synth_traffic
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.recurrent import TransformerRuntime, drive_session
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    params = T.model_init(torch.Generator(card).manual_seed(0), cfg)
    rt = TransformerRuntime(cfg, export_packed(params, cfg.quant),
                            device=card)
    reqs = synth_traffic(cfg.vocab, requests=12, rate=1e3, prompt_len=24,
                         gen=12, temperature=0.8, top_k=5, seed=3)
    for greedy in (False, True):
        if greedy:
            reqs = [dataclasses.replace(r, temperature=0.0, top_k=0)
                    for r in reqs]
        eng = ServeEngine(rt, cfg.vocab, slots=8, max_context=40,
                          prefill_chunk=4)
        comps, _ = eng.run([dataclasses.replace(r) for r in reqs],
                           realtime=False)
        by = {c.rid: c.tokens for c in comps}
        for r in reqs:
            alone = drive_session(
                rt, torch.as_tensor(np.asarray(r.prompt, np.int64))[None],
                cfg.vocab, gen=r.max_tokens, temperature=r.temperature,
                top_k=r.top_k, seed=r.seed, context=40)[0][0].tolist()
            assert by[r.rid] == alone, (greedy, r.rid)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    codes = torch.zeros((4, 64), dtype=torch.int32, device=card)
    x = torch.zeros((2, 64), device=card)
    with pytest.raises(TypeError):
        PK.packed_gemv(x.double(), codes, mode="ternary")
    with pytest.raises(ValueError, match="contiguous"):
        PK.packed_gemv(torch.zeros((64, 2), device=card).T, codes,
                       mode="ternary")
    # the GEMM's x goes by TMA: 16-byte aligned or refused
    flat = torch.zeros(2 * 64 + 1, device=card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        PK.packed_matmul(flat[1:].view(2, 64), codes, mode="ternary")
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
    # the h-side is a step product (the GEMV) at any batch, layer 1's
    # x-side over the prompt a sequence product (the GEMM)
    assert dispatch.LAUNCHES["fused_tick"] == 8
    assert dispatch.LAUNCHES["packed_gemv"] >= 12
    assert dispatch.LAUNCHES["packed_matmul"] >= 1


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


# --- the engine's traffic on the card -------------------------------------------


@pytest.mark.parametrize("cell,layers,hidden,vocab", [
    ("lstm", 1, 1000, 50),      # rnn-paper: the early head
    ("gru", 2, 136, 50),        # the x-side GEMV inside the launch
    ("lstm", 2, 136, 10000)])   # the late head
def test_fused_tick_row_bits_do_not_depend_on_the_batch(card, cell, layers,
                                                        hidden, vocab):
    """One row's h, c, logits and greedy id are the same bits at B = 1, 4,
    12 and 16 (one pass of 4, three of 4, two of 8), at the first, middle
    and last place, beside other neighbours and other live patterns.  The
    engine ticks every slot in one launch and drive_session a request
    alone, so a stream's bytes rest on this."""
    cfg, qv, g = _tick(card, cell, "ternary", hidden=hidden, layers=layers,
                       vocab=vocab)
    tick = BL.rnn_decode_tables(qv, cfg)[0]["tick"]
    h0 = torch.tanh(torch.randn(layers, hidden, generator=g)).to(card)
    c0 = torch.randn(layers, hidden, generator=g).to(card)
    ref = None
    for B in (1, 4, 12, 16):
        for at in sorted({0, B // 2, B - 1}):
            h = torch.tanh(torch.randn(layers, B, hidden, generator=g)).to(card)
            c = torch.randn(layers, B, hidden, generator=g).to(card)
            h[:, at], c[:, at] = h0, c0
            tok = torch.randint(0, vocab, (B,), generator=g).to(card)
            tok[at] = 7
            live = (torch.rand(B, generator=g) > 0.4).to(card)
            live[at] = True
            hn, cn, lg, gr = DK.fused_tick(
                *OPS.tick_operands(tok, h, c, tick, live), cell=cell,
                mode="ternary")
            row = [hn[:, at, :hidden], cn[:, at, :hidden], lg[at, :vocab],
                   gr[at:at + 1]]
            if ref is None:
                ref = [t.clone() for t in row]
                continue
            for name, a, b in zip(("h", "c", "logits", "greedy"), row, ref):
                assert torch.equal(a.reshape(-1).view(torch.int32),
                                   b.reshape(-1).view(torch.int32)), \
                    f"B={B}, row {at}: {name} differs from B=1"


def _engine_vs_alone(card, layers, chunk, seed):
    """A packed-ternary LSTM (H = 256) engine at slots 16 over 24 requests
    of `synth_traffic` (prompts U[1, 40], generation U[1, 16], T 0.8,
    top-k 5), and each request alone through drive_session: the rids whose
    streams differ."""
    import numpy as np
    from repro_torch.launch.serve import synth_traffic
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.recurrent import drive_session
    cfg, qv, _ = _tick(card, "lstm", "ternary", hidden=256, layers=layers,
                       vocab=50, seed=seed)
    rt = RNNRuntime(cfg, qv, device=card)
    reqs = synth_traffic(50, requests=24, rate=100.0, prompt_len=40, gen=16,
                         temperature=0.8, top_k=5, seed=seed)
    eng = ServeEngine(rt, 50, slots=16, max_context=56, prefill_chunk=chunk)
    comps, m = eng.run(reqs, realtime=False)
    assert m["tick_launches"] == 1 and len(comps) == 24
    by_rid = {c.rid: c.tokens for c in comps}
    differ = []
    for r in reqs:
        prompt = torch.as_tensor(np.asarray(r.prompt, np.int64))[None]
        out, _ = drive_session(rt, prompt, 50, gen=r.max_tokens,
                               temperature=r.temperature, top_k=r.top_k,
                               seed=r.seed)
        if by_rid[r.rid] != out[0].tolist():
            differ.append(r.rid)
    return differ


@pytest.mark.parametrize("chunk", [8, 32])
def test_engine_streams_equal_drive_session_on_the_card(card, chunk):
    """One layer, as rnn-paper: the x side is a gather, the h-side GEMV
    runs at one row in both prefills, and the tick's row bits do not
    depend on the batch, so every stream is drive_session's byte for
    byte."""
    assert _engine_vs_alone(card, 1, chunk, seed=1) == []


@pytest.mark.parametrize("chunk", [8, 32])
def test_two_layer_engine_on_the_card(card, chunk):
    """Two layers: layer 1's x-side projection takes a whole chunk at once
    (M = the chunk length) in the engine and the whole prompt in
    drive_session, so a prompt past 8 tokens meets the GEMM whole and the
    GEMV in chunks of 8, or a 32-token chunk's GEMM and its tail's GEMV:
    kernels that sum in other orders.  On an H100 the carried
    state then differed in its last bits (at most 6e-8, `chip_smoke.py`'s
    two-layer check) and none of the 24 streams differed.  So the state
    is held to 1e-5, not bit for bit, and the streams byte for byte on
    this workload; the kernels are not re-routed for it."""
    cfg, qv, g = _tick(card, "lstm", "ternary", hidden=256, layers=2,
                       vocab=50, seed=1)
    rt = RNNRuntime(cfg, qv, device=card)
    for S in (12, 40):
        toks = torch.randint(0, 50, (1, S), generator=g).to(card)
        _, whole = rt.prefill(toks, rt.init_state(1, per_slot=True))
        st = rt.init_state(1, per_slot=True)
        for lo in range(0, S, chunk):
            _, st = rt.prefill_chunk(toks[:, lo:lo + chunk], st)
        torch.testing.assert_close(st.h, whole.h, rtol=0, atol=1e-5)
        torch.testing.assert_close(st.c, whole.c, rtol=0, atol=1e-5)
    assert _engine_vs_alone(card, 2, chunk, seed=1) == []


# ---------------------------------------------------------------------------
# the transformer pool's dense serving path (qwen3-0.6B's projections)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 4, 8, 512])
@pytest.mark.parametrize("K,N", [(1024, 2048), (1024, 1024), (2048, 1024),
                                 (1024, 3072), (3072, 1024)])
def test_qwen3_projection_shapes_match_plain(card, K, N, rows):
    """qwen3-0.6B's seven projections (Wq 1024->2048, Wk/Wv 1024->1024,
    Wo 2048->1024, Wgate/Wup 1024->3072, Wdown 3072->1024) at decode rows
    (the GEMV) and a B = 4, prompt-128 prefill (the GEMM, M = 512), with
    the codes a layer's slice of stacked (L, K/16, N) codes, as the
    transformer serves them: held to the fp64 product, two launches bit
    for bit."""
    rng = np.random.default_rng(K + N + rows)
    stacked = _codes(rng, 3 * (K // 16), N).reshape(3, K // 16, N).to(card)
    codes = stacked[1]
    assert codes.is_contiguous() and codes.data_ptr() % 16 == 0
    x = torch.from_numpy(np.tanh(rng.normal(size=(rows, K))).astype(
        np.float32)).to(card)
    fn = PK.packed_gemv if rows <= 8 else PK.packed_matmul
    got = fn(x, codes, mode="ternary")
    again = fn(x, codes, mode="ternary")
    want = PK.packed_matmul_plain(x, codes, mode="ternary")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _assert_summation_close(got, want, x, codes, "ternary")
    assert dispatch.LAUNCHES[fn.__name__] == 2


def _qwen_runtime(device, mode="ternary", dtype="bfloat16"):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import export_packed
    from repro_torch.models import transformer as T
    from repro_torch.serve.recurrent import TransformerRuntime
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), dtype=dtype)
    cfg = cfg.with_quant(QuantSpec(mode=mode, norm="channel"))
    params = export_packed(T.model_init(torch.Generator().manual_seed(0),
                                        cfg), cfg.quant)
    return TransformerRuntime(cfg, params, device=device)


def test_transformer_runtime_on_the_card_matches_the_cpu(card):
    """A reduced qwen3 in fp32 compute: the card's logits (packed kernels,
    cuBLAS attention) against the CPU's plain versions within 1e-4, one
    GEMM a projection for a 24-row prefill and one GEMV a projection for a
    2-row decode step."""
    from repro_torch.serve.recurrent import drive_session
    on_card = _qwen_runtime(card, dtype="float32")
    on_cpu = _qwen_runtime("cpu", dtype="float32")
    prompt = torch.randint(0, 256, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    a, sa = on_card.prefill(prompt, on_card.init_state(2, 16))
    b, sb = on_cpu.prefill(prompt, on_cpu.init_state(2, 16))
    L = on_card.cfg.n_layers
    assert dispatch.LAUNCHES["packed_matmul"] == 7 * L
    torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    tok = torch.argmax(b[:, :256], -1)
    a, _ = on_card.decode_step(tok.to(card), sa)
    b, _ = on_cpu.decode_step(tok, sb)
    torch.cuda.synchronize()
    assert dispatch.LAUNCHES["packed_gemv"] == 7 * L
    torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    out, m = drive_session(on_card, prompt, 256, gen=4, temperature=0.0)
    assert out.shape == (2, 4) and torch.isfinite(m["last_logits"]).all()


def test_transformer_engine_on_the_card(card):
    """The engine over a packed bf16 qwen3 (reduced): every tick is one
    GEMV a projection and six ordered_bmm a layer (attention's two
    products, four norms) and the final norm's, the run completes, and
    every stream equals drive_session(B=1): the packed products,
    attention and the norms sum a row in one order at any batch and row
    count."""
    import dataclasses
    from repro_torch.launch.serve import synth_traffic
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.recurrent import drive_session
    rt = _qwen_runtime(card)
    reqs = synth_traffic(256, requests=8, rate=1e3, prompt_len=40, gen=8,
                         temperature=0.8, top_k=5, seed=2)
    eng = ServeEngine(rt, 256, slots=4, max_context=48, prefill_chunk=16)
    comps, m = eng.run([dataclasses.replace(r) for r in reqs],
                       realtime=False)
    assert m["requests"] == 8 and \
        m["tick_launches"] == 13 * rt.cfg.n_layers + 1
    by = {c.rid: c.tokens for c in comps}
    equal = sum(by[r.rid] == drive_session(
        rt, torch.as_tensor(np.asarray(r.prompt, np.int64))[None], 256,
        gen=r.max_tokens, temperature=r.temperature, top_k=r.top_k,
        seed=r.seed, context=48)[0][0].tolist() for r in reqs)
    assert equal == 8


# ---------------------------------------------------------------------------
# the MoE and RWKV6 serving paths (per-expert shapes, one layer each)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 4, 8, 40])
@pytest.mark.parametrize("K,N", [(2048, 768), (768, 2048), (4096, 14336),
                                 (14336, 4096)])
def test_expert_shapes_match_plain(card, K, N, rows):
    """qwen3-moe-30b-a3b's experts (2048 -> 768, 768 -> 2048) and
    mixtral-8x7b's (4096 -> 14336, 14336 -> 4096) at decode rows (the
    GEMV) and 40 kept rows (the GEMM: qwen3-moe's prefill capacity), the
    codes an expert's slice of stacked (E, K/16, N) codes as an MoE layer
    serves them: contiguous and 16-byte aligned, held to the fp64 product
    within 1e-5 of |x| @ |w|, two launches bit for bit."""
    rng = np.random.default_rng(K + N + rows)
    stacked = _codes(rng, 3 * (K // 16), N).reshape(3, K // 16, N).to(card)
    codes = stacked[2]
    assert codes.is_contiguous() and codes.data_ptr() % 16 == 0
    x = torch.from_numpy(np.tanh(rng.normal(size=(rows, K))).astype(
        np.float32)).to(card)
    fn = PK.packed_gemv if rows <= 8 else PK.packed_matmul
    got = fn(x, codes, mode="ternary")
    again = fn(x, codes, mode="ternary")
    want = PK.packed_matmul_plain(x, codes, mode="ternary")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    plus, minus = PK.code_masks(codes, mode="ternary")
    w = plus.double() - minus.double()
    exact = x.double() @ w
    tol = 1e-5 * (x.double().abs() @ w.abs())
    for out in (got, want):
        assert ((out.double() - exact).abs() <= tol).all()
    assert dispatch.LAUNCHES[fn.__name__] == 2


def all_experts(p, rows, expert, cfg):
    """JAX's expert loop over a packed tree, the reference of
    `moe._kept_experts`: every one of the E experts runs over a buffer as
    long as all kept rows, its own rows in front and zeros behind (JAX's
    capacity slots), and its rows' outputs are read back."""
    from repro_torch.models import moe as MOE
    out = None
    for e in range(cfg.n_experts):
        mine = expert == e
        n = int(mine.sum())
        buf = torch.zeros_like(rows)
        buf[:n] = rows[mine]
        y = MOE._ffn(p, buf, cfg, lambda x, name: OPS.qmatmul(
            x, MOE._expert(p[name], e)))
        if out is None:
            out = y.new_empty((rows.shape[0], y.shape[1]))
        out[mine] = y[:n]
    return out


def _reduced_layer(arch, device):
    """Layer 0 of a reduced packed ternary arch in fp32 compute, served."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    cfg = cfg.with_quant(QuantSpec(mode="ternary", norm="channel"))
    params = T.model_init(torch.Generator().manual_seed(0), cfg, packed=True)
    served = T._serve_quant(tree_to(params, device), cfg)
    return cfg, served.layers[0][1]


@pytest.mark.parametrize("no_drop", [False, True])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-30b-a3b"])
def test_moe_layer_on_the_card_matches_the_cpu(card, arch, no_drop,
                                               monkeypatch):
    """One MoE layer (router in fp32 without TF32, packed experts with kept
    rows only) on the card against its plain run on the CPU within 1e-5,
    and against every expert over its capacity slots on the card (the GEMV
    and the GEMM may meet one row, so within 1e-5, not bit for bit)."""
    from repro_torch.models import moe as MOE
    cfg, p_card = _reduced_layer(arch, card)
    _, p_cpu = _reduced_layer(arch, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32))
    y_cpu, a_cpu = MOE.moe_apply(p_cpu["moe"], x, cfg, no_drop=no_drop)
    y, a = MOE.moe_apply(p_card["moe"], x.to(card), cfg, no_drop=no_drop)
    monkeypatch.setattr(MOE, "_kept_experts", all_experts)
    y_all, _ = MOE.moe_apply(p_card["moe"], x.to(card), cfg, no_drop=no_drop)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a.cpu(), a_cpu, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(y_all, y, rtol=1e-5, atol=1e-5)
    assert dispatch.LAUNCHES["packed_matmul"] + \
        dispatch.LAUNCHES["packed_gemv"] > 0


def test_rwkv_layer_on_the_card_matches_the_cpu(card):
    """One rwkv layer (packed projections, the chunked scan over a 20-token
    prompt, then two one-token steps) on the card against the CPU within
    1e-5 of each tensor's size."""
    from repro_torch.models import rwkv6 as R
    from repro_torch.models import transformer as T
    cfg, p_card = _reduced_layer("rwkv6-7b", card)
    _, p_cpu = _reduced_layer("rwkv6-7b", "cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32))
    outs = []
    for p, dev in ((p_cpu, "cpu"), (p_card, card)):
        st = R.state_init(cfg, 2, torch.float32, device=dev)
        y, st = T._rwkv_block(p, x.to(dev), cfg, st, decode=False)
        ys = [y]
        for i in range(2):
            y, st = T._rwkv_block(p, x[:, i:i + 1].to(dev), cfg, st,
                                  decode=True)
            ys.append(y)
        outs.append([t.cpu() for t in ys + list(st)])
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        scale = max(1.0, b.abs().max().item()) if b.is_floating_point() else 0
        assert (a.double() - b.double()).abs().max() <= 1e-5 * scale
    assert dispatch.LAUNCHES["packed_matmul"] == 8 * 1
    assert dispatch.LAUNCHES["packed_gemv"] == 8 * 2


# ---------------------------------------------------------------------------
# the hybrid and audio serving paths (zamba2's ragged N, whisper's K = 512
# and its encoder's M = 6000)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,N,rows", [
    *((2048, 8384, r) for r in (1, 4, 8, 512)),   # zamba2 Win
    *((4096, 2048, r) for r in (1, 4, 8, 512)),   # zamba2 Wout
    *((512, 512, r) for r in (1, 4, 8, 6000)),    # whisper Wq/Wk/Wv/Wo
    *((512, 2048, r) for r in (1, 4, 8, 6000)),   # whisper Wfc1
    *((2048, 512, r) for r in (1, 4, 8, 6000))])  # whisper Wfc2
def test_hybrid_and_audio_shapes_match_plain(card, K, N, rows):
    """zamba2-1.2b's Win (N = 8384: 65 full 128-column GEMM tiles and one
    of 64; 262 32-column GEMV tiles) and Wout at decode rows and its
    B = 4, prompt-128 prefill (M = 512), and whisper-base's K = 512 and
    2048 projections at decode rows and over the encoder's 4 x 1500 frames
    (M = 6000), the codes a layer's slice of stacked codes: held to the
    fp64 product within 1e-5 of |x| @ |w|, two launches bit for bit."""
    rng = np.random.default_rng(K + N + rows)
    stacked = _codes(rng, 2 * (K // 16), N).reshape(2, K // 16, N).to(card)
    codes = stacked[1]
    assert codes.is_contiguous() and codes.data_ptr() % 16 == 0
    x = torch.from_numpy(np.tanh(rng.normal(size=(rows, K))).astype(
        np.float32)).to(card)
    fn = PK.packed_gemv if rows <= 8 else PK.packed_matmul
    got = fn(x, codes, mode="ternary")
    again = fn(x, codes, mode="ternary")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    if rows <= 512:
        want = PK.packed_matmul_plain(x, codes, mode="ternary")
    else:  # the plain version row by row takes seconds at 6000 rows
        want = torch.cat([PK.packed_matmul_plain(x[i:i + 500], codes,
                                                 mode="ternary")
                          for i in (0, rows - 500)])
        got = torch.cat([got[:500], got[-500:]])
        x = torch.cat([x[:500], x[-500:]])
    _assert_summation_close(got, want, x, codes, "ternary")
    assert dispatch.LAUNCHES[fn.__name__] == 2


def _pool_runtime(arch, device, dtype, seed=0):
    """A reduced packed ternary arch (channel scales, the audio family's
    xgate and MLP biases off init) behind its runtime, whisper with 24
    random encoder frames for a batch of 2."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import tree_map_with_path
    from repro_torch.models import transformer as T
    from repro_torch.serve.recurrent import TransformerRuntime
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    cfg = cfg.with_quant(QuantSpec(mode="ternary", norm="channel"))
    g = torch.Generator().manual_seed(seed)
    params = T.model_init(g, cfg, packed=True)
    moved = ("xgate", "bfc1", "bfc2", "dt_bias", "conv_b", "D")
    params = tree_map_with_path(
        lambda path, l: l + 0.3 * torch.randn(l.shape, generator=g)
        if isinstance(l, torch.Tensor) and (path[-1] in moved
                                            or path[-1].startswith("s"))
        else l, params)
    extras = {}
    if cfg.family == "audio":
        extras["enc_frames"] = torch.randn((2, 24, cfg.d_model), generator=g)
    return TransformerRuntime(cfg, params, extras=extras, device=device)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-base"])
def test_hybrid_and_audio_runtimes_on_the_card_match_the_cpu(card, arch):
    """A reduced zamba2 and whisper (packed ternary): in fp32 compute the
    card's prefill and decode logits against the CPU's within 1e-4 (the
    packed kernels, cuBLAS attention and SSD products against the plain
    versions: fp32 sums in other orders); in bf16, the serving dtype,
    within 2 % of their largest magnitude (the dense tests' bf16 rule).
    Every projection of a decode step is a GEMV."""
    for dtype, tol in (("float32", 1e-4), ("bfloat16", None)):
        on_card = _pool_runtime(arch, card, dtype)
        on_cpu = _pool_runtime(arch, "cpu", dtype)
        prompt = torch.randint(0, 256, (2, 12),
                               generator=torch.Generator().manual_seed(1))
        a, sa = on_card.prefill(prompt, on_card.init_state(2, 16))
        b, sb = on_cpu.prefill(prompt, on_cpu.init_state(2, 16))
        tok = torch.argmax(b[:, :256].float(), -1)
        dispatch.reset_counts()
        a2, _ = on_card.decode_step(tok.to(card), sa)
        b2, _ = on_cpu.decode_step(tok, sb)
        torch.cuda.synchronize()
        assert dispatch.LAUNCHES["packed_gemv"] > 0
        assert dispatch.LAUNCHES["packed_matmul"] == 0
        for got, want in ((a, b), (a2, b2)):
            got, want = got[:, :256].float().cpu(), want[:, :256].float()
            if tol is not None:
                torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            else:
                assert (got - want).abs().max() <= 0.02 * want.abs().max()


# ---------------------------------------------------------------------------
# the vlm serving path (d 8192, d_ff 28,672, the cross K/V over 4 x 1600
# image tokens) and the pool's training step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,N,rows", [
    *((8192, 8192, r) for r in (1, 4, 8, 512)),     # vlm Wq, Wo
    *((8192, 1024, r) for r in (1, 4, 8, 512)),     # vlm self Wk, Wv
    *((8192, 28672, r) for r in (1, 4, 8, 512)),    # vlm Wgate, Wup
    *((28672, 8192, r) for r in (1, 4, 8, 512)),    # vlm Wdown
    (8192, 1024, 6400)])                            # the cross layer's Wk
def test_vlm_shapes_match_plain(card, K, N, rows):
    """llama-3.2-vision-90b's projections at decode rows and its B = 4,
    prompt-128 prefill (M = 512), and its cross K/V over 4 x 1600 image
    tokens (M = 6400), the codes a layer's slice of stacked codes: held to
    the fp64 product within 1e-5 of |x| @ |w| (the dense weight decoded
    directly: the identity trick would take K rows of the plain version),
    two launches bit for bit."""
    rng = np.random.default_rng(K + N + rows)
    stacked = _codes(rng, 2 * (K // 16), N).reshape(2, K // 16, N).to(card)
    codes = stacked[1]
    x = torch.from_numpy(np.tanh(rng.normal(size=(rows, K))).astype(
        np.float32)).to(card)
    fn = PK.packed_gemv if rows <= 8 else PK.packed_matmul
    got = fn(x, codes, mode="ternary")
    again = fn(x, codes, mode="ternary")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    if rows > 512:  # the plain version runs row by row: its ends
        got, x = torch.cat([got[:500], got[-500:]]), torch.cat([x[:500],
                                                                x[-500:]])
    want = PK.packed_matmul_plain(x, codes, mode="ternary")
    w = Q.unpack_ternary(codes, K).double()
    exact = x.double() @ w
    tol = 1e-5 * (x.double().abs() @ w.abs())
    for out in (got, want):
        assert ((out.double() - exact).abs() <= tol).all()
    assert dispatch.LAUNCHES[fn.__name__] == 2


@pytest.mark.parametrize("arch", [
    "qwen3-0.6b", "qwen3-1.7b", "llama3-8b", "gemma3-27b", "mixtral-8x7b",
    "qwen3-moe-30b-a3b", "rwkv6-7b", "zamba2-1.2b", "whisper-base",
    "llama-3.2-vision-90b"])
def test_reduced_train_step_on_the_card_matches_the_cpu(card, arch):
    """One training step of a reduced arch (fp32, channel scales and
    zero-init leaves moved off init) on the card against the CPU, on one
    state, batch and injected noise: every leaf's gradient within 1e-4
    relative L2 (zero where the CPU's is), the step's loss and gradient
    norm within 1e-4 relative, the new masters within 1e-4 (cuBLAS and
    the CPU sum in other orders; the MoE's gather backward is a
    scatter-add of its own order on the card).  No kernel launches: the
    training forward multiplies by the sampled fp weights."""
    from repro_torch.configs import get_config
    from repro_torch.core import qlinear as QL
    from repro_torch.core.qtensor import tree_paths
    from repro_torch.models import transformer as T
    cfg = get_config(arch).reduced()
    g = torch.Generator().manual_seed(0)
    params = T.model_init(g, cfg)
    for path, leaf in tree_paths(params):
        if (path[-1] in ("xgate", "bfc1", "bfc2", "lora_B", "wB", "u",
                         "conv_b") or "norm" in path[-1]
                or path[-1].startswith(("s", "ln"))):
            leaf.add_(0.2 * torch.randn(leaf.shape, generator=g))
    pol, draw = cfg.quant.policy(), QL.step_noise(1, 0)
    noise = {"/".join(p): draw("/".join(p), l) for p, l in tree_paths(params)
             if pol.matches_name(p[-1], "/".join(p), l.dim())}
    n = 16 if cfg.family == "audio" else 32
    batch = {k: torch.randint(0, cfg.vocab, (2, n), generator=g)
             for k in ("tokens", "targets")}
    if cfg.family == "audio":
        batch["enc_frames"] = torch.randn((2, 32, cfg.d_model), generator=g)
    if cfg.family == "vlm":
        batch["img"] = torch.randn((2, cfg.n_img_tokens, cfg.d_model),
                                   generator=g)
    grads = [TS.value_and_grad(lambda leaves: T.lm_loss(
        leaves, b, cfg, training=True, noise=noise), p)[2]
        for p, b in ((params, batch),
                     (tree_to(params, card), tree_to(batch, card)))]
    for (path, c), d in zip(tree_paths(grads[0]), tree_leaves(grads[1])):
        d = d.cpu()
        if not torch.any(c):
            assert not torch.any(d), path
            continue
        rel = ((d - c).norm() / c.norm()).item()
        assert rel <= 1e-4, (path, rel)
    # SGD: an update proportional to the gradient (AdamW's first step is
    # +-lr on an element whose gradient is rounding, whatever its size)
    opt = OPT.OptConfig(kind="sgd", lr=1e-2, clip_norm=1.0)
    step = TS.make_train_step(cfg, opt)
    cpu, mc = step(TS.train_state_init(params, opt, 1), batch, noise=noise)
    dev, md = step(TS.train_state_init(tree_to(params, card), opt, 1),
                   tree_to(batch, card), noise=noise)
    torch.cuda.synchronize()
    for k in ("loss", "grad_norm"):
        assert abs(float(md[k]) - float(mc[k])) <= 1e-4 * abs(float(mc[k])), k
    for a, b in zip(tree_leaves(dev.params), tree_leaves(cpu.params)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    assert not dispatch.LAUNCHES


# --- compressed data parallelism ---------------------------------------------


@pytest.fixture
def no_group():
    """A test's process groups are gone after it (each side of a card
    against CPU comparison makes its own: NCCL on the card, gloo on the
    CPU)."""
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_compression_on_the_card_equals_the_cpu(card):
    """`ternary_compress` and `compress_tree` on CUDA tensors, bit for bit
    the CPU's for the same u: a max, one IEEE division by a same-device
    tensor, a strict compare and a multiply, all exact or rounded alike."""
    from repro_torch.train import compress as C
    g = torch.Generator().manual_seed(0)
    grads = {"wh": 0.1 * torch.randn((1000, 4000), generator=g),
             "b": 0.01 * torch.randn(4000, generator=g),
             "zero": torch.zeros(64)}
    res = {k: 1e-3 * torch.randn(v.shape, generator=g)
           for k, v in grads.items()}
    u = list(C.step_noise(grads, 1, 7, 0))
    cpu = C.compress_tree(grads, u, res)
    dev = C.compress_tree(tree_to(grads, card), tree_to(u, card),
                          tree_to(res, card))
    for a, b in zip(tree_leaves(cpu), tree_leaves(dev)):
        assert torch.equal(a.view(torch.int32), b.cpu().view(torch.int32))
    drawn = list(C.step_noise(tree_to(grads, card), 1, 7, 0))
    assert all(d.device.type == "cuda" for d in drawn)


@pytest.mark.parametrize("kind", ["rnn", "pool"])
def test_compressed_step_in_an_nccl_group_of_one(card, kind, no_group):
    """One compressed step over a data mesh of one rank, NCCL on the card
    and gloo on the CPU, the model noise and the compression draws
    injected: params and BN state within 1e-5 relative L2 a leaf (the
    compressed values are 0 or +-max|g|, so the update barely feels the
    gradients' fp32 sums in other orders); the residual, g - t, carries
    g's own summation error, and is held as this file holds a gradient,
    within 1e-4 (1.8e-5 measured on an RNN bias, a sum over the batch and
    the time steps that nearly cancels); and non-zero."""
    import torch.distributed as dist
    from repro_torch.configs import get_config, get_rnn_config, rnn_paper
    from repro_torch.core import qlinear as QL
    from repro_torch.core.qtensor import tree_paths
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.train import compress as C
    opt = OPT.OptConfig(lr=1e-3, warmup_steps=20, clip_norm=1.0)
    g = torch.Generator().manual_seed(0)
    if kind == "rnn":
        cfg = rnn_paper.reduced(get_rnn_config("rnn-paper"))
        var = BL.rnn_lm_init(g, cfg, device="cpu")
        state = TS.train_state_init(var["params"], opt, 1,
                                    bn_state=var["state"], compress=True)
        noise, make = TS.step_noise(state), TS.make_rnn_train_step
    else:
        cfg = get_config("qwen3-0.6b").reduced()
        state = TS.train_state_init(T.model_init(g, cfg), opt, 1,
                                    compress=True)
        pol, draw = cfg.quant.policy(), QL.step_noise(1, 0)
        noise = {"/".join(p): draw("/".join(p), l)
                 for p, l in tree_paths(state.params)
                 if pol.matches_name(p[-1], "/".join(p), l.dim())}
        make = TS.make_train_step
    toks = torch.randint(0, cfg.vocab, (4, 33), generator=g)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    comp = list(C.step_noise(state.params, 1, 0, 0))
    got = {}
    for dev in ("cpu", card):
        mesh = M.make_host_mesh(device=dev)
        got[str(dev)] = make(cfg, opt, mesh=mesh, compress_grads=True)(
            tree_to(state, dev), tree_to(batch, dev),
            noise=tree_to(noise, dev), comp_noise=tree_to(comp, dev))[0]
        dist.destroy_process_group()
    cpu, dev = got["cpu"], got[str(card)]
    assert sum(float(x.abs().sum()) for x in tree_leaves(dev.residual)) > 0
    for f, tol in (("params", 1e-5), ("residual", 1e-4), ("bn_state", 1e-5)):
        for (path, a), b in zip(tree_paths(getattr(cpu, f)),
                                tree_leaves(getattr(dev, f))):
            rel = (b.cpu() - a).norm().item() / max(a.norm().item(), 1e-30)
            assert rel <= tol, (f, path, rel)
