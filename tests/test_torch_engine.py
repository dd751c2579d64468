"""The port's continuous-batching engine on the CPU: its hooks against the
JAX package, and its streams against the port's own `drive_session`.

Sizes mirror tests/test_serve_engine.py: vocab 24, H = 48, two layers,
LSTM and GRU, packed (ternary, binary) and fp.  JAX's weights are carried
across with `repro_torch.convert`, BN statistics walked off init so the
logits are not all about 1e-3.

Tolerances: the engine hooks (`rnn_prefill_chunk`, `rnn_verify`,
`rnn_spec_commit`, `rnn_write_slots`, the reset) match JAX within 1e-5
abs, the tolerance tests/test_torch_serve.py states (fp32 summation order
and libm sigmoid/tanh, about 1e-7 a step).  Within the port everything is
bit for bit: chunked prefill equals whole prefill, and every request's
engine stream equals `drive_session(B=1)` on that request at temperature
0.8, top-k 5, since the draws are counter-based (serve/sampler.py) and the
serving matmuls keep a row's bits independent of the rows beside it on
the CPU (`ops.serve_matmul`, `packed_matmul_plain`).  Against JAX's
engine the streams are compared by token at temperature 0 only, while the
top-2 logit margin exceeds 1e-5.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bnlstm as JBL
from repro.core import qtensor as JQT
from repro.core import quantize as JQ
from repro.serve import engine as JE
from repro.serve import recurrent as JR
from repro_torch import convert
from repro_torch.core import bnlstm as BL
from repro_torch.core import quantize as Q
from repro_torch.kernels import dispatch
from repro_torch.serve import recurrent as R
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.sampler import (draw, draw_batch, gumbel, sample,
                                       sample_slots, uniforms)

torch.set_num_threads(1)
ATOL = 1e-5
VOCAB, HIDDEN, LAYERS = 24, 48, 2
_CACHE: dict = {}


def _jax_to_numpy(tree):
    def leaf(l):
        if JQT.is_qtensor(l):
            return {"codes": np.asarray(l.codes), "k": l.k, "mode": l.mode,
                    "alpha": l.alpha, "scale": None}
        return np.asarray(l)
    return jax.tree.map(leaf, tree, is_leaf=JQT.is_qtensor)


def _pair(cell="lstm", mode="ternary", seed=0):
    """(JAX runtime, port runtime, port cfg) over the same weights; `mode`
    'none' serves the fp masters.  Cached: the runtimes are read-only."""
    key = (cell, mode, seed)
    if key not in _CACHE:
        jcfg = JBL.RNNConfig(vocab=VOCAB, d_hidden=HIDDEN, n_layers=LAYERS,
                             cell=cell,
                             quant=JQ.QuantSpec(mode=mode, norm="batch"))
        tcfg = BL.RNNConfig(vocab=VOCAB, d_hidden=HIDDEN, n_layers=LAYERS,
                            cell=cell,
                            quant=Q.QuantSpec(mode=mode, norm="batch"))
        var = JBL.rnn_lm_init(jax.random.PRNGKey(seed), jcfg)
        rng = np.random.default_rng(seed + 1)
        var["state"] = jax.tree.map(
            lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
            var["state"])
        var["params"]["head"]["bs"] = jnp.asarray(
            rng.normal(size=VOCAB).astype(np.float32) * 0.5)
        params = var["params"]
        if mode != "none":
            params = JBL.export_packed_rnn(params, jcfg)
        qvar = {"params": params, "state": var["state"]}
        jrt = JR.RNNRuntime(jcfg, qvar, dense_tables=False, interpret=True)
        trt = R.RNNRuntime(tcfg, convert.from_numpy(_jax_to_numpy(qvar),
                                                    "cpu"), device="cpu")
        _CACHE[key] = (jrt, trt, tcfg)
    return _CACHE[key]


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


def _bits_equal(a, b):
    return torch.equal(a.reshape(-1).view(torch.int32),
                       b.reshape(-1).view(torch.int32))


def _requests(n, *, rng_seed=0, max_prompt=10, max_gen=8, temperature=0.8,
              top_k=5):
    rng = np.random.default_rng(rng_seed)
    return [Request(prompt=rng.integers(0, VOCAB,
                                        size=int(rng.integers(2, max_prompt))),
                    max_tokens=int(rng.integers(1, max_gen)),
                    temperature=temperature, top_k=top_k, seed=100 + i, rid=i)
            for i in range(n)]


def _alone(rt, req):
    """The oracle: the request alone through the port's drive_session."""
    prompt = torch.as_tensor(np.asarray(req.prompt, np.int64))[None]
    out, _ = R.drive_session(rt, prompt, VOCAB, gen=req.max_tokens,
                             temperature=req.temperature, top_k=req.top_k,
                             seed=req.seed)
    return out[0].tolist()


# --- the engine hooks against JAX ---------------------------------------------


def test_per_slot_state_write_and_reset_match_jax():
    _, trt, cfg = _pair()
    pool = BL.rnn_state_init(cfg, 4, per_slot=True, device="cpu")
    jpool = JBL.rnn_state_init(_pair()[0].cfg, 4, per_slot=True)
    assert tuple(pool.pos.shape) == tuple(jpool.pos.shape) == (4,)
    rng = np.random.default_rng(1)
    h = rng.normal(size=(LAYERS, 2, HIDDEN)).astype(np.float32)
    c = rng.normal(size=(LAYERS, 2, HIDDEN)).astype(np.float32)
    pos = np.array([7, 3], np.int32)
    sub = BL.RNNState(torch.from_numpy(h), torch.from_numpy(c),
                      torch.from_numpy(pos))
    jsub = JBL.RNNState(jnp.asarray(h), jnp.asarray(c), jnp.asarray(pos))
    out = BL.rnn_write_slots(pool, sub, [2, 0])
    jout = JBL.rnn_write_slots(jpool, jsub, jnp.asarray([2, 0]))
    assert out is pool  # in place
    for a, b in zip(out, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    one = BL.RNNState(sub.h[:, :1], sub.c[:, :1], torch.tensor(5))
    BL.rnn_write_slots(pool, one, 3)  # a scalar pos broadcasts
    assert pool.pos.tolist() == [3, 0, 7, 5]
    row = BL.rnn_gather_slot(pool, 2)
    assert torch.equal(row.h, sub.h[:, :1]) and row.pos.tolist() == [7]
    # the retire scrub: h, c and pos of the freed rows to zero, others kept
    jreset = JE.tree_reset_slots(jout, JBL.rnn_state_init(
        _pair()[0].cfg, 1, per_slot=True), jnp.asarray([True, False, False,
                                                         False]))
    BL.rnn_reset_slots(pool, [0, 3])
    np.testing.assert_array_equal(pool.h[:, :3].numpy(),
                                  np.asarray(jreset.h[:, :3]))
    assert float(pool.h[:, [0, 3]].abs().max()) == 0.0
    assert float(pool.c[:, [0, 3]].abs().max()) == 0.0
    assert pool.pos.tolist() == [0, 0, 7, 0]


@pytest.mark.parametrize("cell,mode", [("lstm", "ternary"), ("lstm", "none"),
                                       ("gru", "binary")])
def test_prefill_chunk_matches_jax(cell, mode):
    """Three chunks (4, 4 and 3 tokens) on a per-slot state, against JAX's
    `rnn_prefill_chunk` on the same tokens, whose last chunk JAX pads to
    its bucket of 4 (the port runs every chunk at its own length)."""
    jrt, trt, cfg = _pair(cell, mode)
    toks = np.random.default_rng(2).integers(0, VOCAB, (1, 11)).astype(np.int32)
    st = trt.init_state(1, per_slot=True)
    js = jrt.init_state(1, per_slot=True)
    for lo, hi in ((0, 4), (4, 8), (8, 11)):
        pad = np.zeros((1, 4), np.int32)
        pad[:, :hi - lo] = toks[:, lo:hi]
        lg, st = trt.prefill_chunk(
            torch.from_numpy(toks[:, lo:hi]).long(), st)
        jl, js = jrt.prefill_chunk(jnp.asarray(pad), js, jnp.int32(hi - lo))
        _close(lg, jl)
        _close(st.h, js.h)
        _close(st.c, js.c)
    assert st.pos.tolist() == np.asarray(js.pos).tolist() == [11]


@pytest.mark.parametrize("cell,mode", [("lstm", "ternary"), ("gru", "none")])
def test_verify_and_spec_commit_match_jax(cell, mode):
    """`rnn_verify` over K tokens and `rnn_spec_commit` at every n in
    [0, K] against JAX; n = 0 keeps the pre-verify row bit for bit, and n =
    j equals j decode steps bit for bit."""
    jrt, trt, cfg = _pair(cell, mode)
    B, K = 3, 4
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, VOCAB, (B, 3)).astype(np.int32)
    toks = rng.integers(0, VOCAB, (B, K)).astype(np.int32)
    _, st0 = trt.prefill(torch.from_numpy(prompt).long(),
                         trt.init_state(B, per_slot=True))
    _, js0 = jrt.prefill(jnp.asarray(prompt), jrt.init_state(B, per_slot=True))
    lgs, end, emits = trt.verify(torch.from_numpy(toks).long(), st0)
    jlgs, jend, jemits = JBL.rnn_verify(jrt.variables, jnp.asarray(toks),
                                        jrt.cfg, js0, tables=jrt.tables,
                                        interpret=True)
    _close(lgs, jlgs)
    for a, b in zip(emits, jemits):
        _close(a, b)
    st = st0
    for i in range(K):
        lg, st = trt.decode_step(torch.from_numpy(toks[:, i]).long(), st)
        assert _bits_equal(lg, lgs[:, i])
    assert _bits_equal(end.h, st.h) and _bits_equal(end.c, st.c)
    n = np.array([0, 2, K], np.int32)
    com = trt.spec_commit(st0, end, (), emits, torch.from_numpy(n))
    jcom = JBL.rnn_spec_commit(js0, jemits, jnp.asarray(n))
    _close(com.h, jcom.h)
    _close(com.c, jcom.c)
    assert com.pos.tolist() == np.asarray(jcom.pos).tolist()
    assert _bits_equal(com.h[:, 0], st0.h[:, 0])   # n = 0: restored
    assert _bits_equal(com.c[:, 0], st0.c[:, 0])
    assert _bits_equal(com.h[:, 2], end.h[:, 2])   # n = K: the end state
    two = st0
    for i in range(2):
        _, two = trt.decode_step(torch.from_numpy(toks[:, i]).long(), two)
    assert _bits_equal(com.h[:, 1], two.h[:, 1])


# --- within the port: bit for bit --------------------------------------------


@pytest.mark.parametrize("cell,mode", [("lstm", "ternary"), ("lstm", "none"),
                                       ("gru", "binary"), ("gru", "none")])
def test_chunked_prefill_equals_whole_prefill_bitwise(cell, mode):
    """Chunks of 4, 4 and 3 tokens and a whole 11-token prompt leave the
    same state and first-token logits, bit for bit: layer 1's x-side
    projection runs at 4 rows against 11, and the plain versions sum a
    row in an order of its own."""
    _, trt, cfg = _pair(cell, mode)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, VOCAB, (1, 11))).long()
    lg_ref, st_ref = trt.prefill(toks, trt.init_state(1, per_slot=True))
    st = trt.init_state(1, per_slot=True)
    for lo in (0, 4, 8):
        lg, st = trt.prefill_chunk(toks[:, lo:lo + 4], st)
    assert _bits_equal(st.h, st_ref.h) and _bits_equal(st.c, st_ref.c)
    assert _bits_equal(lg, lg_ref)
    assert st.pos.tolist() == st_ref.pos.tolist() == [11]


def test_sample_slots_row_is_its_request_alone():
    """A row's draw depends on its own logits, seed, counter and settings:
    the same at B = 6 as at B = 1, on any neighbours."""
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(6, 33, generator=g)
    temps = torch.tensor([0.8, 0.0, 1.3, 0.5, 2.0, 0.8])
    topks = torch.tensor([4, 0, 0, 7, 2, 33])
    seeds = torch.tensor([5, 6, 7, 8, 2**40 + 9, 5])
    ctrs = torch.tensor([0, 3, 9, 1, 2, 0])
    vec = sample_slots(logits, seeds, ctrs, temperature=temps, top_k=topks,
                       vocab=30)
    for i in range(6):
        ref = sample(logits[i:i + 1], int(seeds[i]), int(ctrs[i]),
                     temperature=float(temps[i]), top_k=int(topks[i]),
                     vocab=30)
        assert int(ref) == int(vec[i])
    assert int(vec[1]) == int(torch.argmax(logits[1, :30]))
    # the uniforms: a pure function of (seed, counter, stream, column)
    u = uniforms(seeds, ctrs, 0, (6, 33), "cpu")
    assert torch.equal(u[0], u[5]) and not torch.equal(u[0], u[1])
    assert torch.equal(u[2], uniforms(7, 9, 0, (1, 33), "cpu")[0])
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    assert not torch.equal(u, uniforms(seeds, ctrs, 1, (6, 33), "cpu"))


@pytest.mark.parametrize("temperature,top_k,vocab",
                         [(0.8, 0, 0), (0.8, 5, 30), (1.3, 1, 0),
                          (0.5, 33, 30), (2.0, 40, 0)])
def test_draw_batch_is_draw_with_broadcast_settings(temperature, top_k, vocab):
    """`drive_session`'s filter for one temperature and top-k (`draw_batch`:
    topk and a scalar division) gives the bits of the engine's per-row
    filter (`draw`: a sort and a per-row division), ties included, so a
    request streams the same bytes through either."""
    g = torch.Generator().manual_seed(6)
    logits = torch.randn(8, 33, generator=g)
    logits[:, 4] = logits[:, 9]          # tied values around the k-th
    logits[2] = torch.round(logits[2])   # a row of many ties
    noise = gumbel(torch.arange(8), 3, 0, logits.shape, "cpu")
    want = draw(logits, noise,
                temperature=torch.full((8,), temperature),
                top_k=torch.full((8,), top_k, dtype=torch.int64),
                vocab=vocab)
    got = draw_batch(logits, noise, temperature=temperature, top_k=top_k,
                     vocab=vocab)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cell,mode", [("lstm", "ternary"), ("lstm", "none"),
                                       ("gru", "ternary"), ("gru", "none")])
def test_engine_matches_drive_session(cell, mode):
    """7 requests through slots=3 with prefill_chunk=4 (multi-chunk
    prompts, padded tails, neighbours coming and going): every stream is
    byte-identical to the request alone through drive_session."""
    _, trt, cfg = _pair(cell, mode)
    reqs = _requests(7, rng_seed=3)
    eng = ServeEngine(trt, VOCAB, slots=3, max_context=64, prefill_chunk=4)
    comps, m = eng.run([dataclasses.replace(r) for r in reqs],
                       realtime=False)
    assert m["requests"] == len(reqs) and m["max_decode_stall_ticks"] <= 1
    by_rid = {c.rid: c for c in comps}
    for r in reqs:
        assert by_rid[r.rid].tokens == _alone(trt, r)
    # one fused tick a decode step on the packed tree; none on fp masters
    assert eng.tick_launches == (1 if mode != "none" else 0)


def _scenario(seed):
    """One deterministic mixed-traffic scenario, as test_engine_fuzz.py
    draws them."""
    rng = random.Random(seed)
    n = rng.randint(3, 6)
    reqs = [Request(
        prompt=np.array([rng.randrange(VOCAB)
                         for _ in range(rng.randint(1, 12))], np.int32),
        max_tokens=rng.randint(1, 8),
        temperature=rng.choice([0.0, 0.5, 0.8, 1.3]),
        top_k=rng.choice([0, 3, 7]), seed=rng.randrange(10_000),
        arrival_s=round(rng.random() * 0.05, 4), rid=i) for i in range(n)]
    eos = rng.randrange(VOCAB) if rng.random() < 0.5 else None
    return reqs, eos, rng.choice([1, 2, 3]), rng.choice([2, 4])


_ENGINES: dict = {}
FUZZ = ([("lstm", "ternary", s) for s in range(100, 106)]
        + [("lstm", "none", s) for s in range(200, 205)]
        + [("gru", "binary", s) for s in range(300, 303)])


@pytest.mark.parametrize("cell,mode,seed", FUZZ,
                         ids=[f"{c}-{m}-{s}" for c, m, s in FUZZ])
def test_engine_fuzz_parity(cell, mode, seed):
    """Seeded scenarios (prompt lengths, arrival order, max tokens, per-
    request temperature and top-k, slot count, chunk size, EOS ids that
    collide with real streams) on engines reused across scenarios: every
    stream equals drive_session's, truncated at the first EOS."""
    _, trt, _ = _pair(cell, mode)
    reqs, eos, slots, chunk = _scenario(seed)
    key = (cell, mode, slots, chunk)
    if key not in _ENGINES:
        _ENGINES[key] = ServeEngine(trt, VOCAB, slots=slots, max_context=32,
                                    prefill_chunk=chunk)
    eng = _ENGINES[key]
    eng.eos_id = eos
    comps, m = eng.run([dataclasses.replace(r) for r in reqs],
                       realtime=False)
    assert m["max_decode_stall_ticks"] <= 1
    by_rid = {c.rid: c for c in comps}
    assert sorted(by_rid) == [r.rid for r in reqs]
    for r in reqs:
        exp = _alone(trt, r)
        if eos is not None and eos in exp:
            exp = exp[:exp.index(eos) + 1]
        c = by_rid[r.rid]
        assert c.tokens == exp, f"rid {r.rid} diverged (seed {seed})"
        if eos is not None and c.tokens[-1] == eos:
            assert c.finished == "eos"
        else:
            assert c.finished == "length" and len(c.tokens) == r.max_tokens
        assert c.t_admit <= c.t_first <= c.t_done
    assert not eng._live_host.any() and not eng._prefill_q


def test_greedy_engine_streams_match_jax_engine():
    """Temperature 0: the port's engine and JAX's (dense tables) emit the
    same tokens while the JAX logits' top-2 margin exceeds 1e-5."""
    jrt, trt, cfg = _pair("lstm", "ternary")
    reqs = _requests(5, rng_seed=9, temperature=0.0, top_k=0)
    jdense = JR.RNNRuntime(jrt.cfg, jrt.variables)
    jeng = JE.ServeEngine(jdense, VOCAB, slots=3, max_context=64,
                          prefill_chunk=4)
    jcomps, _ = jeng.run([JE.Request(**dataclasses.asdict(r)) for r in reqs],
                         realtime=False)
    eng = ServeEngine(trt, VOCAB, slots=3, max_context=64, prefill_chunk=4)
    comps, _ = eng.run([dataclasses.replace(r) for r in reqs],
                       realtime=False)
    jby = {c.rid: c.tokens for c in jcomps}
    compared = 0
    for c in comps:
        r = reqs[c.rid]
        lg, st = jdense.prefill(jnp.asarray(np.asarray(r.prompt,
                                                       np.int32))[None],
                                jdense.init_state(1))
        for i, tok in enumerate(jby[c.rid]):
            top2 = np.sort(np.asarray(lg)[0])[-2:]
            if top2[1] - top2[0] <= ATOL:
                break
            assert c.tokens[i] == tok, f"rid {c.rid} token {i}"
            compared += 1
            lg, st = jdense.decode_step(jnp.asarray([tok], jnp.int32), st)
    assert compared >= sum(r.max_tokens for r in reqs) // 2


# --- scheduling: EOS, cancel, priority, stats ---------------------------------


def test_eos_retires_and_eos_on_the_first_token():
    _, trt, _ = _pair()
    req = Request(prompt=np.zeros(3, np.int32), max_tokens=6,
                  temperature=0.8, top_k=0, seed=42)
    stream = _alone(trt, req)
    eos = stream[2]
    eng = ServeEngine(trt, VOCAB, slots=2, max_context=64, eos_id=eos)
    comps, _ = eng.run([dataclasses.replace(req)], realtime=False)
    assert comps[0].finished == "eos"
    assert comps[0].tokens == stream[:stream.index(eos) + 1]
    # EOS as the very first token: done at prefill, never decoded
    eng = ServeEngine(trt, VOCAB, slots=2, max_context=64, eos_id=stream[0],
                      prefill_chunk=2)
    comps, _ = eng.run([dataclasses.replace(req)], realtime=False)
    assert comps[0].tokens == [stream[0]] and eng.ticks == 0
    assert comps[0].t_first == comps[0].t_done and eng._free_slot() == 0


def _drain(eng):
    streams, comps = {}, []
    while eng.has_work():
        events, cs = eng.step()
        for rid, toks in events:
            streams.setdefault(rid, []).extend(toks)
        comps.extend(cs)
    return streams, comps


def test_cancel_mid_prefill_and_mid_decode():
    """A request cancelled while its prompt is still in chunks, and one
    cancelled while decoding: the survivors' streams and the next
    occupants of the freed slots are oracle-exact."""
    _, trt, _ = _pair()
    eng = ServeEngine(trt, VOCAB, slots=2, max_context=48, prefill_chunk=2)
    long = Request(prompt=np.arange(12) % VOCAB, max_tokens=30,
                   temperature=0.0, seed=1)
    short = _requests(1, rng_seed=31)[0]
    rid_l = eng.submit(dataclasses.replace(long))
    rid_s = eng.submit(dataclasses.replace(short))
    eng.step()  # admits both, one chunk of the long prompt
    assert eng._active[0] is not None and eng._active[0].chunks
    comp = eng.cancel(rid_l)
    assert comp.finished == "cancelled" and comp.tokens == []
    assert eng._active[0] is None and 0 not in eng._prefill_q
    assert float(eng.pool.h[:, 0].abs().max()) == 0.0   # scrubbed
    streams, comps = _drain(eng)
    assert [c.rid for c in comps] == [rid_s]
    assert streams[rid_s] == _alone(trt, short)

    a = Request(prompt=np.arange(5) % VOCAB, max_tokens=30, temperature=0.8,
                top_k=5, seed=7)
    rid_a = eng.submit(dataclasses.replace(a))
    got = []
    for _ in range(6):
        for rid, toks in eng.step()[0]:
            got.extend(toks)
    slot = next(s for s, x in enumerate(eng._active) if x is not None)
    assert eng._live_host[slot] and len(got) >= 2
    comp = eng.cancel(rid_a)
    assert comp.tokens == got == _alone(trt, a)[:len(got)]
    b = _requests(1, rng_seed=51)[0]
    rid_b = eng.submit(dataclasses.replace(b))
    streams, comps = _drain(eng)
    assert comps[0].slot == slot and streams[rid_b] == _alone(trt, b)
    # a queued request is dropped before it touches a slot
    one = ServeEngine(trt, VOCAB, slots=1, max_context=48)
    x, y = _requests(2, rng_seed=41)
    rid_x, rid_y = one.submit(x), one.submit(y)
    one.step()
    comp = one.cancel(rid_y)
    assert comp.slot == -1 and comp.tokens == []
    streams, comps = _drain(one)
    assert [c.rid for c in comps] == [rid_x] and one.cancel(rid_y) is None


def test_priority_orders_admission_and_stats():
    _, trt, _ = _pair()
    eng = ServeEngine(trt, VOCAB, slots=1, max_context=48, prefill_chunk=4)
    reqs = [Request(prompt=np.arange(3) % VOCAB, max_tokens=3,
                    temperature=0.0, seed=60 + i, priority=p, slo=s)
            for i, (p, s) in enumerate([(5, "batch"), (0, "realtime"),
                                        (2, "standard")])]
    rids = [eng.submit(dataclasses.replace(r)) for r in reqs]
    first, _ = eng.step()
    mid = eng.stats()
    assert mid["active"] == 1 and mid["queued"] == mid["queue_depth"] == 2
    assert mid["shards"] == [{"shard": 0, "slots": 1, "active": 1,
                              "occupancy": 1.0}]
    streams, comps = _drain(eng)
    streams[rids[1]] = [t for _, ts in first for t in ts] + streams[rids[1]]
    assert [c.rid for c in comps] == [rids[1], rids[2], rids[0]]
    assert [c.slo for c in comps] == ["realtime", "standard", "batch"]
    for rid, req in zip(rids, reqs):
        assert streams[rid] == _alone(trt, req)
    s = eng.stats()
    assert s["active"] == 0 and s["gen_tokens"] == 9 and s["ticks"] == 6
    assert s["tick_launches"] == 1 and s["prefill_chunks"] == 3
    assert s["prefill_steps"] == 9  # three 3-token prompts, no padding


def test_tick_is_one_fused_call_and_prefill_counts_every_step():
    """On the packed tree a plain tick is one fused-tick call whatever the
    occupancy, and a prefill chunk runs one h-side GEMV a prompt token a
    layer (the step route), plus layer 1's x-side projection of the chunk,
    which takes the GEMM (the sequence route) at any chunk length."""
    _, trt, _ = _pair()
    eng = ServeEngine(trt, VOCAB, slots=3, max_context=64, prefill_chunk=4)
    eng.warm()
    steps0, chunks0 = eng.prefill_steps, eng.prefill_chunks
    dispatch.reset_counts()
    comps, m = eng.run(_requests(5, rng_seed=13), realtime=False)
    calls = dict(dispatch.PLAIN_CALLS)
    assert not dispatch.LAUNCHES
    assert calls["fused_tick"] == m["ticks"] and m["tick_launches"] == 1
    steps = eng.prefill_steps - steps0
    chunks = eng.prefill_chunks - chunks0
    assert steps == sum(c.prompt_len for c in comps)  # no pad steps
    assert calls["packed_gemv"] == LAYERS * steps
    assert calls["packed_matmul"] == chunks
    assert set(calls) == {"fused_tick", "packed_gemv", "packed_matmul"}


def test_pool_keeps_its_shape_and_staggered_arrivals_change_no_token():
    _, trt, _ = _pair("gru", "binary")
    reqs = _requests(6, rng_seed=11)
    for i, r in enumerate(reqs):
        r.arrival_s = 0.01 * (len(reqs) - i)   # reversed admission order
    eng = ServeEngine(trt, VOCAB, slots=2, max_context=64)
    shapes = [tuple(t.shape) for t in eng.pool]
    a, _ = eng.run([dataclasses.replace(r) for r in reqs], realtime=False)
    assert [tuple(t.shape) for t in eng.pool] == shapes
    for r in reqs:
        r.arrival_s = 0.0
    b, _ = ServeEngine(trt, VOCAB, slots=3, max_context=64).run(
        [dataclasses.replace(r) for r in reqs], realtime=False)
    assert {c.rid: c.tokens for c in a} == {c.rid: c.tokens for c in b}


def test_realtime_timestamps_are_ordered():
    _, trt, _ = _pair()
    reqs = _requests(6, rng_seed=13, max_prompt=12)
    for i, r in enumerate(reqs):
        r.arrival_s = 0.002 * i
    eng = ServeEngine(trt, VOCAB, slots=2, max_context=64, prefill_chunk=4)
    comps, m = eng.run(reqs, realtime=True)
    assert len(comps) == len(reqs) and m["agg_tok_s"] > 0
    for c in comps:
        assert c.t_submit <= c.t_admit <= c.t_first <= c.t_done
    long = [c for c in comps if c.prompt_len > 4]
    assert long and all(c.t_first > c.t_admit for c in long)
    assert set(m["ttft_by_class"]) == {"default"}


def test_engine_refuses_bad_requests_and_unported_modes():
    _, trt, _ = _pair()
    eng = ServeEngine(trt, VOCAB, slots=2, max_context=8)
    with pytest.raises(ValueError, match="max_tokens"):
        eng.run([Request(prompt=np.zeros(2, np.int32), max_tokens=0)])
    with pytest.raises(ValueError, match="max_context"):
        eng.run([Request(prompt=np.zeros(6, np.int32), max_tokens=8)])
    with pytest.raises(ValueError, match="token ids"):
        eng.submit(Request(prompt=np.array([1, VOCAB]), max_tokens=2))
    r = Request(prompt=np.zeros(2, np.int32), max_tokens=2)
    comps, _ = eng.run([r], realtime=False)
    assert r.rid is None and comps[0].rid == 0
    # a mesh is served (its refusal is gone): a data mesh of one rank is
    # one shard, and so is a prefix cache beside it
    from repro_torch.launch import mesh as M
    from repro_torch.serve.prefixcache import PrefixCache
    try:
        mesh = M.make_serve_mesh("data=1", device="cpu")
        meng = ServeEngine(trt, VOCAB, slots=2, max_context=8, mesh=mesh)
        mcomps, _ = meng.run([Request(prompt=np.zeros(2, np.int32),
                                      max_tokens=2)], realtime=False)
        assert mcomps[0].tokens == comps[0].tokens
        assert meng.stats()["mesh"] == {"data": 1, "model": 1}
        assert meng.tick_collectives() == 0
        peng = ServeEngine(trt, VOCAB, slots=2, max_context=8, mesh=mesh,
                           prefix_cache=PrefixCache(1 << 20))
        pcomps, _ = peng.run([Request(prompt=np.zeros(2, np.int32),
                                      max_tokens=2)], realtime=False)
        assert pcomps[0].tokens == comps[0].tokens
    finally:
        torch.distributed.destroy_process_group()

    class CrossAttention:  # a transformer with a cross-attention source
        family, extras = "transformer", {"img": None}
    with pytest.raises(NotImplementedError,
                       match="needs per-request source encodings"):
        ServeEngine(CrossAttention(), VOCAB, slots=2, max_context=8)

    class Hybrid:  # a family the engine does not schedule
        family = "hybrid"
    with pytest.raises(NotImplementedError,
                       match="hybrid runtime has none of their slot hooks"):
        ServeEngine(Hybrid(), VOCAB, slots=2, max_context=8)
    with pytest.raises(ValueError, match="BOTH"):
        ServeEngine(trt, VOCAB, slots=2, max_context=8, spec_k=2)


def test_launcher_traffic_and_refusals(capsys, monkeypatch):
    from repro_torch.launch import serve
    m = serve.main(["--device", "cpu", "--traffic", "--requests", "8",
                    "--slots", "3", "--rate", "50"])
    out = capsys.readouterr().out
    assert m["requests"] == 8 and "aggregate decode" in out
    assert m["tick_launches"] == 1 and m["max_decode_stall_ticks"] <= 1
    m = serve.main(["--device", "cpu", "--traffic", "--requests", "8",
                    "--slots", "3", "--rate", "50", "--spec-k", "4"])
    assert "speculative: k=4" in capsys.readouterr().out
    assert m["requests"] == 8 and m["tick_launches"] == 5
    # --mesh serves the engine on a mesh (its refusal is gone): without
    # --traffic it is refused, a mesh larger than the job raises, and a
    # mesh of one rank serves with JAX's banner
    with pytest.raises(SystemExit, match="run it with --traffic"):
        serve.main(["--device", "cpu", "--mesh", "data=4"])
    try:
        with pytest.raises(ValueError, match="nproc-per-node 4"):
            serve.main(["--device", "cpu", "--mesh", "data=4", "--traffic"])
        m = serve.main(["--device", "cpu", "--traffic", "--requests", "4",
                        "--slots", "2", "--rate", "50", "--mesh", "data=1"])
        out = capsys.readouterr().out
        assert "mesh: data=1,model=1 over 1 device(s)" in out
        assert m["requests"] == 4
    finally:
        torch.distributed.destroy_process_group()
    # the vlm family serves in lockstep; its engine is refused with JAX's
    # reason (a runtime with a cross-attention source)
    with pytest.raises(NotImplementedError,
                       match="needs per-request source encodings"):
        serve.main(["--device", "cpu", "--arch", "llama-3.2-vision-90b",
                    "--traffic", "--requests", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--traffic", "--requests", "2"])
