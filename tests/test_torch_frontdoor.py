"""The port's prefix-state cache and HTTP/SSE front door, on the CPU, for
the RNN family (mirroring tests/test_prefixcache.py and
tests/test_frontdoor.py).

The contract is the engine's: scheduling is invisible.  A request whose
prompt prefix is spliced from the cache, one driven through `step()`, one
streamed over HTTP/SSE, and the survivors of a client hanging up all
stream the bytes `drive_session` streams for the request alone.  Plus the
cache's own guarantees (LRU under a byte budget, longest boundary prefix,
a digest collision never splices foreign state) and the front door's
(bad requests refused, a hangup cancels, the stats route).
"""
import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import bnlstm as JBL
from repro.core import quantize as JQ
from repro_torch import convert
from repro_torch.core import bnlstm as BL
from repro_torch.core import quantize as Q
from repro_torch.serve import frontdoor as FD
from repro_torch.serve import recurrent as R
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.prefixcache import PrefixCache, tree_bytes

torch.set_num_threads(1)
VOCAB, CTX = 24, 48
_RT: dict = {}


def _runtime(family):
    """'lstm-packed' (ternary) or 'lstm-fp', vocab 24, H = 48, L = 2, from
    JAX's init."""
    if family not in _RT:
        mode = "ternary" if family == "lstm-packed" else "none"
        jcfg = JBL.RNNConfig(vocab=VOCAB, d_hidden=48, n_layers=2,
                             quant=JQ.QuantSpec(mode=mode, norm="batch"))
        cfg = BL.RNNConfig(vocab=VOCAB, d_hidden=48, n_layers=2,
                           quant=Q.QuantSpec(mode=mode, norm="batch"))
        var = convert.from_numpy(jax.tree.map(
            np.asarray, JBL.rnn_lm_init(jax.random.PRNGKey(0), jcfg)), "cpu")
        if mode != "none":
            var["params"] = BL.export_packed_rnn(var["params"], cfg)
        _RT[family] = R.RNNRuntime(cfg, var, device="cpu")
    return _RT[family]


def _expected(family, req):
    prompt = torch.as_tensor(np.asarray(req.prompt, np.int64))[None]
    out, _ = R.drive_session(_runtime(family), prompt, VOCAB,
                             gen=req.max_tokens, temperature=req.temperature,
                             top_k=req.top_k, seed=req.seed)
    return out[0].tolist()


def _reqs(n, *, seed=0, max_prompt=12, max_gen=10):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, VOCAB,
                                        size=int(rng.integers(2, max_prompt))),
                    max_tokens=int(rng.integers(2, max_gen)),
                    temperature=0.8, top_k=5, seed=500 + i)
            for i in range(n)]


def _drain(eng):
    streams, comps = {}, []
    while eng.has_work():
        events, cs = eng.step()
        for rid, toks in events:
            streams.setdefault(rid, []).extend(toks)
        comps.extend(cs)
    return streams, comps


# --- the cache data structure --------------------------------------------------


def _entry(nbytes):
    return np.zeros(nbytes, np.int8)


def test_lru_eviction_under_byte_budget():
    c = PrefixCache(100)
    c.bind(4)
    t = lambda i: np.full(4, i, np.int32)
    assert c.insert(t(1), _entry(40)) and c.insert(t(2), _entry(40))
    assert len(c) == 2 and c.bytes == 80
    c.lookup(np.concatenate([t(1), t(9)]))   # touch 1: now 2 is the LRU
    assert c.insert(t(3), _entry(40))        # evicts 2, not 1
    s = c.stats()
    assert s["entries"] == 2 and s["bytes"] == 80 and s["evictions"] == 1
    assert c.lookup(np.concatenate([t(1), t(9)]))[0] == 4
    assert c.lookup(np.concatenate([t(2), t(9)]))[0] == 0
    assert not c.insert(t(4), _entry(101))   # bigger than the budget
    assert c.stats()["entries"] == 2
    st = BL.RNNState(torch.zeros(2, 1, 48), torch.zeros(2, 1, 48),
                     torch.zeros(1, dtype=torch.int32))
    assert tree_bytes(st) == 2 * 2 * 48 * 4 + 4 and tree_bytes(None) == 0


def test_longest_boundary_prefix_wins_and_the_last_chunk_always_runs():
    c = PrefixCache(1 << 20)
    c.bind(4)
    p = np.arange(12, dtype=np.int32)
    c.insert(p[:4], _entry(8))
    c.insert(p[:8], _entry(8))
    assert c.lookup(p)[0] == 8
    assert c.lookup(p[:9])[0] == 8
    assert c.lookup(p[:8])[0] == 4     # capped at size-1
    assert c.lookup(p[:4])[0] == 0
    assert c.contains(p[:8]) and not c.contains(p[:9])
    with pytest.raises(ValueError):
        c.bind(8)


def test_poisoned_prefix_guard(monkeypatch):
    c = PrefixCache(1 << 20)
    c.bind(4)
    monkeypatch.setattr(PrefixCache, "_key",
                        staticmethod(lambda tokens: "collide"))
    c.insert(np.arange(4, dtype=np.int32), _entry(8))
    c.insert(np.arange(4, dtype=np.int32) + 50, _entry(8))
    assert len(c) == 1
    assert c.lookup(np.array([9, 9, 9, 9, 1], np.int32)) == (0, None)
    assert c.stats()["collisions"] >= 1


# --- the cache in the engine: a hit streams the cold bytes ---------------------


def test_prefix_hit_resume_is_bit_exact():
    """Request 1 (cold) leaves its chunk-boundary states; a repeat and a
    fork of its prompt splice the longest boundary (8 tokens) and every
    stream is the request alone, bit for bit."""
    rt = _runtime("lstm-packed")
    eng = ServeEngine(rt, VOCAB, slots=2, max_context=CTX, prefill_chunk=4,
                      prefix_cache=PrefixCache(1 << 24))
    rng = np.random.default_rng(5)
    system = rng.integers(0, VOCAB, size=9).astype(np.int32)
    mk = lambda tail, seed: Request(
        prompt=np.concatenate([system, tail]).astype(np.int32),
        max_tokens=6, temperature=0.8, top_k=5, seed=seed)
    cold = mk(rng.integers(0, VOCAB, size=3), 11)
    fork = mk(rng.integers(0, VOCAB, size=5), 13)
    c1, _ = eng.run([dataclasses.replace(cold)], realtime=False)
    assert c1[0].cached_tokens == 0 and eng.prefix_cache.stats()["misses"] == 1
    assert eng.prefix_cache.stats()["insertions"] >= 2
    c2, m2 = eng.run([dataclasses.replace(cold)], realtime=False)
    c3, _ = eng.run([fork], realtime=False)
    assert c2[0].cached_tokens == 8 and c3[0].cached_tokens == 8
    exp = _expected("lstm-packed", cold)
    assert c1[0].tokens == exp and c2[0].tokens == exp
    assert c3[0].tokens == _expected("lstm-packed", fork)
    s = eng.prefix_cache.stats()
    assert s["hits"] == 2 and s["hit_tokens"] == 16 and s["collisions"] == 0
    assert m2["prefix_cache"]["hits"] == 1


def test_prefix_hit_under_speculative_decoding():
    """A spec engine caches both pools' rows, so a splice leaves the draft
    in step with the target."""
    rt = _runtime("lstm-fp")
    eng = ServeEngine(rt, VOCAB, slots=2, max_context=CTX, prefill_chunk=4,
                      prefix_cache=PrefixCache(1 << 24),
                      draft=R.speculative_draft(rt), spec_k=3)
    rng = np.random.default_rng(6)
    system = rng.integers(0, VOCAB, size=10).astype(np.int32)
    mk = lambda tail, seed: Request(
        prompt=np.concatenate([system, tail]).astype(np.int32),
        max_tokens=8, temperature=0.0, top_k=0, seed=seed)
    a = mk(rng.integers(0, VOCAB, size=2), 21)
    b = mk(rng.integers(0, VOCAB, size=4), 22)
    ca, _ = eng.run([a], realtime=False)
    cb, _ = eng.run([b], realtime=False)
    assert cb[0].cached_tokens == 8
    assert ca[0].tokens == _expected("lstm-fp", a)
    assert cb[0].tokens == _expected("lstm-fp", b)
    e = next(iter(eng.prefix_cache._entries.values()))
    assert e.draft_state is not None


def test_eviction_keeps_streams_exact():
    rt = _runtime("lstm-packed")
    one = tree_bytes(rt.init_state(1, per_slot=True))
    eng = ServeEngine(rt, VOCAB, slots=2, max_context=CTX, prefill_chunk=4,
                      prefix_cache=PrefixCache(2 * one))
    rng = np.random.default_rng(7)
    reqs = [Request(prompt=rng.integers(0, VOCAB, size=9).astype(np.int32),
                    max_tokens=5, temperature=0.8, top_k=5, seed=30 + i,
                    rid=i) for i in range(4)]
    comps, _ = eng.run([dataclasses.replace(r) for r in reqs],
                       realtime=False)
    s = eng.prefix_cache.stats()
    assert s["evictions"] >= 1 and s["bytes"] <= 2 * one
    for c in comps:
        assert c.tokens == _expected("lstm-packed", reqs[c.rid])


def test_an_engine_of_another_chunk_size_is_refused_the_shared_cache():
    """Two engines may share a cache only at one chunk size: an entry is
    the state at a chunk boundary of the engine that stored it."""
    rt = _runtime("lstm-packed")
    cache = PrefixCache(1 << 20)
    ServeEngine(rt, VOCAB, slots=1, max_context=CTX, prefill_chunk=4,
                prefix_cache=cache)
    ServeEngine(rt, VOCAB, slots=2, max_context=CTX, prefill_chunk=4,
                prefix_cache=cache)
    with pytest.raises(ValueError, match="bound to chunk=4"):
        ServeEngine(rt, VOCAB, slots=1, max_context=CTX, prefill_chunk=8,
                    prefix_cache=cache)


# --- the resumable step API and HTTP/SSE ---------------------------------------


@pytest.mark.parametrize("family", ["lstm-packed", "lstm-fp"])
def test_step_api_streams_match_drive_session(family):
    eng = ServeEngine(_runtime(family), VOCAB, slots=2, max_context=CTX,
                      prefill_chunk=4)
    reqs = _reqs(4, seed=11)
    rids = [eng.submit(dataclasses.replace(r)) for r in reqs]
    streams, comps = _drain(eng)
    assert sorted(streams) == sorted(rids) and len(comps) == len(reqs)
    for rid, req in zip(rids, reqs):
        assert streams[rid] == _expected(family, req)
    for c in comps:
        assert c.tokens == streams[c.rid]


def _sse_roundtrip(eng, payloads, hangup_after=None):
    hangup_after = hangup_after or {}

    async def go():
        fd = FD.FrontDoor(eng, port=0)
        await fd.start()
        try:
            outs = []
            for i, p in enumerate(payloads):
                outs.append(await FD._post_stream(
                    fd.host, fd.port, p, hangup_after=hangup_after.get(i)))
                await asyncio.sleep(0.05)  # let a hangup cancel first
            stats = await FD._get_json(fd.host, fd.port, "/v1/stats")
            return outs, stats
        finally:
            await fd.close()

    return asyncio.run(go())


@pytest.mark.parametrize("family", ["lstm-packed", "lstm-fp"])
def test_sse_streams_are_oracle_exact_and_a_hangup_cancels(family):
    eng = ServeEngine(_runtime(family), VOCAB, slots=2, max_context=CTX,
                      prefill_chunk=4)
    reqs = _reqs(3, seed=83)
    payloads = [{"prompt": np.asarray(r.prompt).tolist(),
                 "max_tokens": r.max_tokens, "temperature": r.temperature,
                 "top_k": r.top_k, "seed": r.seed} for r in reqs]
    payloads[1]["max_tokens"] = 20   # a mid-stream to hang up in
    outs, stats = _sse_roundtrip(eng, payloads, hangup_after={1: 1})
    for i in (0, 2):
        toks, done = outs[i]
        assert done is not None and done["finished"] in ("eos", "length")
        assert toks == _expected(family, reqs[i]) and done["n_tokens"] == \
            len(toks)
    cut, _ = outs[1]
    exp1 = _expected(family, dataclasses.replace(reqs[1], max_tokens=20))
    assert cut == exp1[:len(cut)] and len(cut) < 20
    assert stats["active"] == 0 and stats["queued"] == 0
    assert stats["queue_depth"] == 0 and stats["shards"][0]["active"] == 0
    assert stats["tick_launches"] == (1 if family == "lstm-packed" else 0)


def test_http_bad_requests_are_refused():
    eng = ServeEngine(_runtime("lstm-packed"), VOCAB, slots=2,
                      max_context=CTX, prefill_chunk=4)

    async def post(fd, body):
        r, w = await asyncio.open_connection(fd.host, fd.port)
        w.write(b"POST /v1/generate HTTP/1.1\r\nContent-Length: "
                + str(len(body)).encode() + b"\r\n\r\n" + body)
        await w.drain()
        resp = await r.read()
        w.close()
        return resp

    async def go():
        fd = FD.FrontDoor(eng, port=0)
        await fd.start()
        try:
            bad_budget = await post(fd, b'{"prompt": [1, 2], "max_tokens": 0}')
            bad_id = await post(fd, b'{"prompt": [1, 99], "max_tokens": 2}')
            bad_json = await post(fd, b'{"prompt": [1, 2]')
            nf = await FD._get_json(fd.host, fd.port, "/nope")
            return bad_budget, bad_id, bad_json, nf
        finally:
            await fd.close()

    bad_budget, bad_id, bad_json, nf = asyncio.run(go())
    assert b"400 Bad Request" in bad_budget and b"max_tokens" in bad_budget
    assert b"400 Bad Request" in bad_id and b"token ids" in bad_id
    assert b"400 Bad Request" in bad_json
    assert "error" in nf and not eng.has_work()


def test_cancel_between_spec_rounds_keeps_survivors_exact():
    rt = _runtime("lstm-fp")
    eng = ServeEngine(rt, VOCAB, slots=2, max_context=CTX, prefill_chunk=4,
                      draft=R.speculative_draft(rt), spec_k=3)
    a = Request(prompt=np.arange(4) % VOCAB, max_tokens=24, temperature=0.0,
                seed=3)
    b = Request(prompt=(np.arange(6) * 5) % VOCAB, max_tokens=10,
                temperature=0.0, seed=4)
    rid_a, rid_b = eng.submit(dataclasses.replace(a)), eng.submit(
        dataclasses.replace(b))
    got = {rid_a: [], rid_b: []}
    while not (eng._live_host[0] and eng._live_host[1]):
        for rid, toks in eng.step()[0]:
            got[rid].extend(toks)
    for rid, toks in eng.step()[0]:
        got[rid].extend(toks)
    comp_a = eng.cancel(rid_a)
    assert comp_a.finished == "cancelled" and comp_a.tokens == got[rid_a]
    assert comp_a.tokens == _expected("lstm-fp", a)[:len(comp_a.tokens)]
    assert float(eng.draft_pool.h[:, 0].abs().max()) == 0.0  # both scrubbed
    streams, comps = _drain(eng)
    assert [c.rid for c in comps] == [rid_b]
    assert got[rid_b] + streams.get(rid_b, []) == comps[0].tokens
    assert comps[0].tokens == _expected("lstm-fp", b)


def test_front_door_smoke_runs_on_the_cpu(capsys):
    assert FD.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "front-door smoke: OK" in out and "FAIL" not in out
