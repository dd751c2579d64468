"""Parity of the port's serving slice with the JAX package, on the CPU.

The JAX model is initialised, its BN statistics walked off init, exported
to packed codes and carried across with `repro_torch.convert`; then the
same numpy prompts go through JAX's `RNNRuntime(dense_tables=False,
interpret=True)` (the fused Pallas tick in interpret mode) and the port's
`RNNRuntime(device="cpu")` (the plain versions of the CUDA kernels).

Tolerance: 1e-5 abs on logits and state.  Every packed product is exact
and the two sides differ only in fp32 summation order and libm
sigmoid/tanh, about 1e-7 a step; the 5 prefill + 6 decode steps here stay
well inside 1e-5, the JAX package's own fused-vs-unfused tolerance.
Greedy streams are compared by token while the top-2 logit margin exceeds
that tolerance; sampled streams only by distribution, since `jax.random`
and the port's counter-based draws give different numbers.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_rnn_config as j_get_rnn_config
from repro.core import bnlstm as JBL
from repro.core import qtensor as JQT
from repro.core import quantize as JQ
from repro.serve import recurrent as JR
from repro_torch import convert
from repro_torch.configs import get_rnn_config
from repro_torch.core import bnlstm as BL
from repro_torch.core import quantize as Q
from repro_torch.kernels import dispatch
from repro_torch.serve import recurrent as R
from repro_torch.serve.sampler import sample

torch.set_num_threads(1)
ATOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _jax_to_numpy(tree):
    def leaf(l):
        if JQT.is_qtensor(l):
            return {"codes": np.asarray(l.codes), "k": l.k, "mode": l.mode,
                    "alpha": l.alpha, "scale": None}
        return np.asarray(l)
    return jax.tree.map(leaf, tree, is_leaf=JQT.is_qtensor)


def _pair(cell="lstm", mode="ternary", hidden=40, layers=2, vocab=50, seed=0):
    """(JAX runtime, port runtime, port cfg) over the same packed weights."""
    jcfg = JBL.RNNConfig(vocab=vocab, d_hidden=hidden, n_layers=layers,
                         cell=cell, quant=JQ.QuantSpec(mode=mode, norm="batch"))
    tcfg = BL.RNNConfig(vocab=vocab, d_hidden=hidden, n_layers=layers,
                        cell=cell, quant=Q.QuantSpec(mode=mode, norm="batch"))
    var = JBL.rnn_lm_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 1)
    var["state"] = jax.tree.map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        var["state"])
    var["params"]["head"]["bs"] = jnp.asarray(
        rng.normal(size=vocab).astype(np.float32) * 0.1)
    qvar = {"params": JBL.export_packed_rnn(var["params"], jcfg),
            "state": var["state"]}
    jrt = JR.RNNRuntime(jcfg, qvar, dense_tables=False, interpret=True)
    trt = R.RNNRuntime(tcfg, convert.from_numpy(_jax_to_numpy(qvar), "cpu"),
                       device="cpu")
    return jrt, trt, tcfg


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["ternary", "binary"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_prefill_and_decode_match_jax(cell, mode):
    jrt, trt, tcfg = _pair(cell, mode)
    B, T = 4, 5
    prompt = np.random.default_rng(2).integers(0, 50, (B, T)).astype(np.int32)
    jl, js = jrt.prefill(jnp.asarray(prompt), jrt.init_state(B))
    dispatch.reset_counts()
    tl, ts = trt.prefill(torch.from_numpy(prompt), trt.init_state(B))
    # h-side GEMV per step per layer; layer 1's x-side over all B*T rows
    assert dict(dispatch.PLAIN_CALLS) == {"packed_gemv": 2 * T,
                                          "packed_matmul": 1}
    _close(tl, jl)
    _close(ts.h, js.h)
    _close(ts.c, js.c)
    assert int(ts.pos) == int(js.pos) == T

    toks = np.random.default_rng(3).integers(0, 50, (6, B)).astype(np.int32)
    tu = ts
    for i in range(6):
        jl, js = jrt.decode_step(jnp.asarray(toks[i]), js)
        dispatch.reset_counts()
        tl, ts = trt.decode_step(torch.from_numpy(toks[i]), ts)
        assert dict(dispatch.PLAIN_CALLS) == {"fused_tick": 1}
        ul, tu = BL.rnn_decode_step(trt.variables, torch.from_numpy(toks[i]),
                                    tcfg, tu, tables=trt.tables, fused=False)
        for got in (tl, ul):
            _close(got, jl)
        _close(ts.h, js.h)
        _close(tu.h, js.h)
        _close(ts.c, js.c)
    assert int(ts.pos) == T + 6


def _batch16_prefill_matches_jax(layers: int, calls: dict):
    jrt, trt, _ = _pair("lstm", "ternary", hidden=136, layers=layers)
    B, T = 16, 4
    prompt = np.random.default_rng(4).integers(0, 50, (B, T)).astype(np.int32)
    jl, js = jrt.prefill(jnp.asarray(prompt), jrt.init_state(B))
    dispatch.reset_counts()
    tl, ts = trt.prefill(torch.from_numpy(prompt), trt.init_state(B))
    assert dict(dispatch.PLAIN_CALLS) == {
        k: v(T) for k, v in calls.items()}
    _close(tl, jl)
    _close(ts.h, js.h)
    tok = np.arange(B, dtype=np.int32) * 3 % 50
    jl, js = jrt.decode_step(jnp.asarray(tok), js)
    tl, ts = trt.decode_step(torch.from_numpy(tok), ts)
    _close(tl, jl)
    _close(ts.c, js.c)


def test_batch16_prefill_takes_the_gemm_and_matches_jax():
    """At B = 16, two layers: layer 1's x-side over the prompt's B * T rows
    takes the GEMM (a sequence product), each h-side the GEMV a token."""
    _batch16_prefill_matches_jax(2, {"packed_gemv": lambda T: 2 * T,
                                     "packed_matmul": lambda T: 1})


def test_batch16_prefill_h_side_takes_the_gemv_and_matches_jax():
    """At B = 16 the recurrent h-side takes the GEMV, one a token: its role
    (a step) picks the route, not its 16 rows (JAX's rule would send them
    to the GEMM)."""
    _batch16_prefill_matches_jax(1, {"packed_gemv": lambda T: T})


@pytest.mark.parametrize("mode", ["ternary", "binary"])
def test_prefill_chunk_routes_by_role_and_matches_jax(mode):
    """A 2-row chunk (one request, 2 tokens) of a two-layer model: each
    h-side step takes the GEMV (a step product), layer 1's x-side over the
    chunk the GEMM (a sequence product), though JAX's row-count rule would
    send its 2 rows to the GEMV; the state matches JAX's prefill."""
    jrt, trt, tcfg = _pair("lstm", mode)
    prompt = np.random.default_rng(7).integers(0, 50, (1, 2)).astype(np.int32)
    jl, js = jrt.prefill(jnp.asarray(prompt), jrt.init_state(1))
    dispatch.reset_counts()
    tl, ts = BL.rnn_prefill_chunk(trt.variables, torch.from_numpy(prompt),
                                  tcfg, trt.init_state(1), tables=trt.tables)
    assert dict(dispatch.PLAIN_CALLS) == {"packed_gemv": 2 * 2,
                                          "packed_matmul": 1}
    _close(tl, jl)
    _close(ts.h, js.h)
    _close(ts.c, js.c)


def test_full_prompt_logits_and_dense_tables_match_jax():
    jrt, trt, tcfg = _pair("gru", "binary", layers=1)
    prompt = np.random.default_rng(5).integers(0, 50, (2, 6)).astype(np.int32)
    jl, _ = JBL.rnn_prefill(jrt.variables, jnp.asarray(prompt), jrt.cfg,
                            tables=jrt.tables)
    tl, _ = BL.rnn_prefill(trt.variables, torch.from_numpy(prompt), tcfg,
                           tables=trt.tables)
    _close(tl, jl)
    dense = BL.rnn_decode_tables(trt.variables, tcfg, dense=True)
    assert "tick" not in dense[0]
    dispatch.reset_counts()
    dl, _ = BL.rnn_prefill(trt.variables, torch.from_numpy(prompt), tcfg,
                           tables=dense)
    assert not dispatch.PLAIN_CALLS and not dispatch.LAUNCHES
    _close(dl, jl)


def test_live_mask_freezes_dead_rows_like_jax():
    """`live` on a decode step, fused and unfused: live rows step as JAX's
    do, dead rows keep h, c and pos bit for bit."""
    jrt, trt, tcfg = _pair("lstm", "binary")
    B, T = 4, 3
    prompt = np.random.default_rng(8).integers(0, 50, (B, T)).astype(np.int32)
    _, js = jrt.prefill(jnp.asarray(prompt), jrt.init_state(B))
    _, ts = trt.prefill(torch.from_numpy(prompt), trt.init_state(B))
    live = np.array([True, False, True, False])
    tok = np.array([4, 9, 16, 25], np.int32)
    jl, js1 = JBL.rnn_decode_step(jrt.variables, jnp.asarray(tok), jrt.cfg, js,
                                  tables=jrt.tables, live=jnp.asarray(live),
                                  interpret=True)
    for fused in (True, False):
        tl, ts1 = BL.rnn_decode_step(trt.variables, torch.from_numpy(tok), tcfg,
                                     ts, tables=trt.tables, fused=fused,
                                     live=torch.from_numpy(live))
        _close(tl[live], np.asarray(jl)[live])
        _close(ts1.h, js1.h)
        _close(ts1.c, js1.c)
        for dead in (1, 3):
            assert torch.equal(ts1.h[:, dead], ts.h[:, dead])
            assert torch.equal(ts1.c[:, dead], ts.c[:, dead])
        assert ts1.pos.tolist() == np.asarray(js1.pos).tolist() == [4, 3, 4, 3]


@pytest.mark.parametrize("mode", ["none", "ternary"])
def test_unexported_masters_serve_like_jax(mode):
    """fp masters: 'none' serves them as they are, 'ternary' quantizes them
    deterministically when the tables are built.  Neither builds a fused
    tick, so both packages decode unfused, through plain matmuls only."""
    jcfg = JBL.RNNConfig(vocab=50, d_hidden=40, n_layers=2,
                         quant=JQ.QuantSpec(mode=mode, norm="batch"))
    tcfg = BL.RNNConfig(vocab=50, d_hidden=40, n_layers=2,
                        quant=Q.QuantSpec(mode=mode, norm="batch"))
    var = JBL.rnn_lm_init(jax.random.PRNGKey(3), jcfg)
    jrt = JR.RNNRuntime(jcfg, var, dense_tables=False, interpret=True)
    trt = R.RNNRuntime(tcfg, convert.from_numpy(jax.tree.map(np.asarray, var),
                                                "cpu"), device="cpu")
    assert "tick" not in trt.tables[0]
    prompt = np.random.default_rng(9).integers(0, 50, (2, 4)).astype(np.int32)
    jl, js = jrt.prefill(jnp.asarray(prompt), jrt.init_state(2))
    dispatch.reset_counts()
    tl, ts = trt.prefill(torch.from_numpy(prompt), trt.init_state(2))
    _close(tl, jl)
    for tok in ([1, 2], [30, 49]):
        jl, js = jrt.decode_step(jnp.asarray(tok, jnp.int32), js)
        tl, ts = trt.decode_step(torch.tensor(tok), ts)
        _close(tl, jl)
        _close(ts.h, js.h)
    assert not dispatch.PLAIN_CALLS and not dispatch.LAUNCHES


def test_greedy_stream_matches_jax_by_token():
    jrt, trt, _ = _pair("lstm", "ternary")
    B, S, gen = 3, 4, 8
    prompt = np.random.default_rng(6).integers(0, 50, (B, S)).astype(np.int32)
    j_out, _ = JR.drive_session(jrt, jnp.asarray(prompt), 50, gen=gen,
                                temperature=0.0)
    t_out, m = R.drive_session(trt, torch.from_numpy(prompt), 50, gen=gen,
                               temperature=0.0, warmup=True)
    assert t_out.shape == (B, gen) and m["state_nbytes"] > 0
    # margins of the JAX logits each token was picked from
    lg, st = jrt.prefill(jnp.asarray(prompt), jrt.init_state(B))
    margins = []
    for i in range(gen):
        top2 = np.sort(np.asarray(lg), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        lg, st = jrt.decode_step(jnp.asarray(j_out[:, i]), st)
    margins = np.stack(margins, axis=1)
    compared = 0
    for b in range(B):
        ties = np.flatnonzero(margins[b] <= ATOL)
        upto = ties[0] if ties.size else gen
        np.testing.assert_array_equal(t_out[b, :upto], j_out[b, :upto])
        compared += upto
    assert compared >= B * gen // 2


def test_sampler_matches_jax_distribution():
    """temperature > 0: the port's draws follow the distribution JAX's
    `sample` draws from (filtered softmax), within 4 standard errors."""
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(1, 64)).astype(np.float32) * 2
    temperature, top_k, vocab, n = 0.8, 5, 50, 20000
    jl = jnp.asarray(logits)
    jl = jnp.where(jnp.arange(64) < vocab, jl, jnp.finfo(jnp.float32).min)
    jl = jl / temperature
    kth = jax.lax.top_k(jl, top_k)[0][..., -1:]
    probs = np.asarray(jax.nn.softmax(jnp.where(jl >= kth, jl, -jnp.inf)))[0]
    # n rows, each a request of its own seed: n independent counter-based
    # draws
    draws = sample(torch.from_numpy(np.repeat(logits, n, axis=0)),
                   torch.arange(n), 0, temperature=temperature, top_k=top_k,
                   vocab=vocab)
    freq = np.bincount(draws.numpy(), minlength=64) / n
    assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(probs))
    se = np.sqrt(probs * (1 - probs) / n)
    assert np.all(np.abs(freq - probs) <= 4 * se + 1e-12)
    greedy = sample(torch.from_numpy(logits), 0, temperature=0.0, vocab=vocab)
    assert greedy.item() == int(np.argmax(logits[0, :vocab]))


def test_runtime_sizes_match_jax_and_device_is_required(monkeypatch):
    jrt, trt, tcfg = _pair("lstm", "binary", layers=1)
    assert trt.param_nbytes() == jrt.param_nbytes()
    st = trt.init_state(5)
    assert R.state_nbytes(st) == JR.state_nbytes(jrt.init_state(5))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.RNNRuntime(tcfg, trt.variables)


def test_rnn_paper_config_matches_jax():
    t, j = get_rnn_config("rnn-paper"), j_get_rnn_config("rnn-paper")
    for f in ("vocab", "d_hidden", "n_layers", "cell", "cell_norm", "eps"):
        assert getattr(t, f) == getattr(j, f)
    assert (t.quant.mode, t.quant.norm) == (j.quant.mode, j.quant.norm)
    assert (t.d_hidden, t.vocab, t.quant.mode) == (1000, 50, "ternary")


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "3",
                      "--gen", "3", "--quant", "binary"])
    assert out.shape == (2, 3) and out.max() < 50
    assert "decode:" in capsys.readouterr().out


def test_init_draws_are_seeded_and_device_resolved():
    cfg = dataclasses.replace(get_rnn_config("rnn-paper"), d_hidden=16)
    a = BL.rnn_lm_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    b = BL.rnn_lm_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    assert torch.equal(a["params"]["layers"][0]["wh"],
                       b["params"]["layers"][0]["wh"])
    alpha = Q.glorot_alpha(16, 64)
    assert a["params"]["layers"][0]["wh"].abs().max() <= alpha


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    names = {str(f.relative_to(ROOT / "src" / "repro_torch")) for f in files}
    assert {"core/bnlstm.py", "kernels/packed_matmul.py", "train/optimizer.py",
            "train/train_step.py", "train/checkpoint.py",
            "train/fault_tolerance.py", "data/synth.py", "data/text.py",
            "data/loader.py", "launch/train.py", "convert.py",
            "configs/base.py", "core/qlinear.py", "models/layers.py",
            "models/transformer.py", "serve/kvcache.py", "models/moe.py",
            "models/rwkv6.py"} <= names
    files += [ROOT / "chip_smoke.py", ROOT / "time_kernels.py"]
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: imports {mod}"
