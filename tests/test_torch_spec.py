"""Speculative decoding in the port, on the CPU: the samplers against the
JAX package, the accept rule's distribution, and the engine's streams.

  * `filtered_probs`, `residual_probs` and `spec_accept` against JAX:
    greedy results exactly, probability rows within 1e-6 (softmax of the
    same fp32 logits; the two libms' exp differ by an ulp or so);
  * the Leviathan identity q·min(1, p/q) + P(reject)·residual == p over
    seeded random (p, q) pairs (a `random.Random` loop, as
    tests/test_spec_decode.py runs it), and a Monte Carlo of `spec_accept`
    whose first emitted token follows the target, within 0.04 over 4000
    slots (about 5 standard errors);
  * the engine: a draft that is its own target accepts everything; at
    temperature 0 a packed-ternary draft proposing for the fp target
    streams the plain engine's bytes and `drive_session`'s; at temperature
    0.8 the streams are the same at any slot count (the draws are
    counter-based); after every round a live slot's draft row is the draft
    run alone over its committed tokens, bit for bit; unsupported pairings
    are refused.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bnlstm as JBL
from repro.core import quantize as JQ
from repro.serve import sampler as JS
from repro_torch import convert
from repro_torch.core import bnlstm as BL
from repro_torch.core import quantize as Q
from repro_torch.serve import recurrent as R
from repro_torch.serve import sampler as S
from repro_torch.serve.engine import Request, ServeEngine

torch.set_num_threads(1)
VOCAB, CTX = 24, 32
_RT: dict = {}


def _runtime(mode="none"):
    """The port's LSTM (vocab 24, H = 48, L = 2) from JAX's init, BN walked
    off init; 'none' serves the fp masters."""
    if mode not in _RT:
        jcfg = JBL.RNNConfig(vocab=VOCAB, d_hidden=48, n_layers=2,
                             quant=JQ.QuantSpec(mode=mode, norm="batch"))
        cfg = BL.RNNConfig(vocab=VOCAB, d_hidden=48, n_layers=2,
                           quant=Q.QuantSpec(mode=mode, norm="batch"))
        var = jax.tree.map(np.asarray,
                           JBL.rnn_lm_init(jax.random.PRNGKey(0), jcfg))
        rng = np.random.default_rng(1)
        var["state"] = jax.tree.map(
            lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
            var["state"])
        var["params"]["head"]["bs"] = rng.normal(size=VOCAB).astype(
            np.float32) * 0.5
        var = convert.from_numpy(var, "cpu")
        if mode != "none":
            var["params"] = BL.export_packed_rnn(var["params"], cfg)
        _RT[mode] = R.RNNRuntime(cfg, var, device="cpu")
    return _RT[mode]


def _alone(rt, req):
    prompt = torch.as_tensor(np.asarray(req.prompt, np.int64))[None]
    out, _ = R.drive_session(rt, prompt, VOCAB, gen=req.max_tokens,
                             temperature=req.temperature, top_k=req.top_k,
                             seed=req.seed)
    return out[0].tolist()


# --- the samplers against JAX -------------------------------------------------


def test_filtered_probs_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 9)).astype(np.float32) * 2
    temps = np.array([0.0, 1.0, 0.7, 2.0], np.float32)
    topks = np.array([0, 0, 3, 9], np.int32)
    P = S.filtered_probs(torch.from_numpy(logits), torch.from_numpy(temps),
                         torch.from_numpy(topks), vocab=7).numpy()
    J = np.asarray(JS.filtered_probs(jnp.asarray(logits), jnp.asarray(temps),
                                     jnp.asarray(topks), vocab=7))
    np.testing.assert_array_equal(P[0], J[0])         # greedy: exact one-hot
    assert P[0, int(np.argmax(logits[0, :7]))] == 1.0
    np.testing.assert_allclose(P, J, atol=1e-6, rtol=0)
    assert float(P[:, 7:].max()) == 0.0 and int((P[2] > 0).sum()) == 3
    np.testing.assert_allclose(P.sum(-1), 1.0, atol=1e-6)


def test_residual_probs_match_jax_and_the_identity():
    """The rejection-sampling identity, the reason speculative output is
    the target distribution, over 40 seeded (p, q) pairs: near-equal,
    near-disjoint and unrelated."""
    rng = random.Random(1234)
    for case in range(40):
        V = rng.randint(2, 12)
        logp = np.array([rng.gauss(0, 2) for _ in range(V)])
        if case % 4 == 0:
            logq = logp + np.array([rng.gauss(0, 1e-3) for _ in range(V)])
        elif case % 4 == 1:
            logq = np.roll(logp, 1) + np.array(
                [rng.gauss(0, 3) for _ in range(V)])
        else:
            logq = np.array([rng.gauss(0, 2) for _ in range(V)])
        p = (np.exp(logp) / np.exp(logp).sum()).astype(np.float32)
        q = (np.exp(logq) / np.exp(logq).sum()).astype(np.float32)
        r = S.residual_probs(torch.from_numpy(p)[None],
                             torch.from_numpy(q)[None])[0].numpy()
        j = np.asarray(JS.residual_probs(jnp.asarray(p)[None],
                                         jnp.asarray(q)[None]))[0]
        np.testing.assert_allclose(r, j, atol=1e-6, rtol=0)
        acc = q * np.minimum(1.0, p / q)
        np.testing.assert_allclose(acc + (1.0 - acc.sum()) * r, p,
                                   atol=1e-6, err_msg=f"case {case}")
        assert r.min() >= 0 and abs(r.sum() - 1.0) < 1e-6
    p = torch.tensor([[0.25, 0.75]])
    assert torch.equal(S.residual_probs(p, p), p)  # no mass: p itself


def test_spec_accept_greedy_matches_jax():
    """temperature 0: whatever the drafts, accepted count and emitted
    tokens equal JAX's, and the emitted prefix is the target's argmax
    chain."""
    rng = np.random.default_rng(2)
    B, K, V = 6, 3, 6
    p = rng.normal(size=(B, K + 1, V)).astype(np.float32)
    q = rng.normal(size=(B, K, V)).astype(np.float32)
    greedy = p.argmax(-1)
    drafts = rng.integers(0, V, (B, K)).astype(np.int32)
    drafts[:3, :2] = greedy[:3, :2]       # some accepted prefixes
    drafts[0, 2] = greedy[0, 2]           # and one full acceptance
    zero_t, zero_k = np.zeros(B, np.float32), np.zeros(B, np.int32)
    n, out = S.spec_accept(torch.from_numpy(p), torch.from_numpy(q),
                           torch.from_numpy(drafts), torch.arange(B), 5,
                           temperature=torch.from_numpy(zero_t),
                           top_k=torch.from_numpy(zero_k), vocab=V)
    keys = jnp.stack([jax.random.PRNGKey(i) for i in range(B)])
    jn, jout = JS.spec_accept(jnp.asarray(p), jnp.asarray(q),
                              jnp.asarray(drafts), keys,
                              temperature=jnp.asarray(zero_t),
                              top_k=jnp.asarray(zero_k), vocab=V)
    assert n.tolist() == np.asarray(jn).tolist()
    assert n.tolist()[0] == K + 1 and min(n.tolist()) >= 1
    for b in range(B):
        k = int(n[b])
        assert out[b, :k].tolist() == np.asarray(jout)[b, :k].tolist()
        assert out[b, :k].tolist() == greedy[b, :k].tolist()


def _accept_batch(n, seed=0, *, equal=False, K=2, V=5):
    """spec_accept over n identical (p, q) slots with distinct request
    seeds: the batch is a Monte Carlo harness."""
    g = torch.Generator().manual_seed(seed)
    p = torch.randn(K + 1, V, generator=g).expand(n, K + 1, V)
    q = p[:, :K] if equal else torch.randn(K, V, generator=g).expand(n, K, V)
    temp, topk = torch.ones(n), torch.zeros(n, dtype=torch.int64)
    seeds = torch.arange(n)
    drafts = torch.stack(
        [S.sample_slots(q[:, i], seeds, i, temperature=temp, top_k=topk,
                        vocab=V, stream=S.DRAFT) for i in range(K)], dim=1)
    n_acc, out = S.spec_accept(p, q, drafts, seeds, 0, temperature=temp,
                               top_k=topk, vocab=V)
    return p[0].numpy(), n_acc.numpy(), out.numpy()


def test_spec_accept_follows_the_target_distribution():
    """The first emitted token of every slot (the draft if accepted, else
    the residual draw) is distributed as the target's position-0
    distribution, never the draft's."""
    p, n_acc, out = _accept_batch(4000, seed=3)
    target = torch.softmax(torch.from_numpy(p[0]), -1).numpy()
    freq = np.bincount(out[:, 0], minlength=5) / len(out)
    np.testing.assert_allclose(freq, target, atol=0.04)
    assert n_acc.min() >= 1 and n_acc.max() <= 3
    _, n_eq, _ = _accept_batch(500, seed=5, equal=True)
    assert (n_eq == 3).all()   # p == q: every draft accepted, plus a bonus


def test_sample_slots_draws_follow_filtered_probs():
    logits = torch.randn(9, generator=torch.Generator().manual_seed(4))
    N = 4000
    draws = S.sample_slots(logits.expand(N, 9), torch.arange(N), 0,
                           temperature=torch.full((N,), 0.7),
                           top_k=torch.full((N,), 3), vocab=7).numpy()
    P = S.filtered_probs(logits[None], torch.tensor([0.7]),
                         torch.tensor([3]), vocab=7)[0].numpy()
    np.testing.assert_allclose(np.bincount(draws, minlength=9) / N, P,
                               atol=0.04)


# --- the speculative engine ---------------------------------------------------


def test_self_draft_greedy_accepts_everything():
    """draft == target: every proposal is the target's own argmax, so at
    temperature 0 every draft is accepted."""
    rt = _runtime()
    eng = ServeEngine(rt, VOCAB, slots=2, max_context=64, prefill_chunk=4,
                      draft=rt, spec_k=3)
    req = Request(prompt=np.arange(5) % VOCAB, max_tokens=9,
                  temperature=0.0, top_k=0, seed=7, rid=0)
    comps, m = eng.run([req], realtime=False)
    assert m["accept_rate"] == 1.0 and m["spec_rounds"] == 2
    assert comps[0].tokens == _alone(rt, req)


def _scenario(seed):
    rng = random.Random(seed)
    n = rng.randint(3, 6)
    reqs = [Request(
        prompt=np.array([rng.randrange(VOCAB)
                         for _ in range(rng.randint(1, 12))], np.int32),
        max_tokens=rng.randint(1, 8), temperature=0.0, top_k=0,
        seed=rng.randrange(10_000), arrival_s=round(rng.random() * 0.05, 4),
        rid=i) for i in range(n)]
    eos = rng.randrange(VOCAB) if rng.random() < 0.5 else None
    slots, chunk = rng.choice([1, 2, 3]), rng.choice([2, 4])
    return reqs, eos, slots, chunk, random.Random(seed + 1).choice([2, 3])


@pytest.mark.parametrize("seed", range(400, 405))
def test_spec_fuzz_matches_plain_engine_and_drive_session(seed):
    """Seeded temperature-0 scenarios through a spec engine (packed-ternary
    draft, fp target) and a plain engine: byte-identical to each other and
    to the requests alone, EOS truncation included."""
    rt = _runtime()
    draft = R.speculative_draft(rt, mode="ternary")
    reqs, eos, slots, chunk, k = _scenario(seed)
    plain = ServeEngine(rt, VOCAB, slots=slots, max_context=CTX,
                        prefill_chunk=chunk, eos_id=eos)
    spec = ServeEngine(rt, VOCAB, slots=slots, max_context=CTX,
                       prefill_chunk=chunk, eos_id=eos, draft=draft,
                       spec_k=k)
    p_comps, _ = plain.run([dataclasses.replace(r) for r in reqs],
                           realtime=False)
    s_comps, sm = spec.run([dataclasses.replace(r) for r in reqs],
                           realtime=False)
    assert sm["max_decode_stall_ticks"] <= 1
    assert 0.0 <= sm["accept_rate"] <= 1.0 and sm["tick_launches"] == k + 1
    p_by = {c.rid: c.tokens for c in p_comps}
    for c in s_comps:
        exp = _alone(rt, reqs[c.rid])
        if eos is not None and eos in exp:
            exp = exp[:exp.index(eos) + 1]
        assert c.tokens == p_by[c.rid] == exp, f"rid {c.rid} (seed {seed})"
    assert not spec._live_host.any() and not spec._prefill_q


def test_sampled_spec_streams_do_not_depend_on_the_batch():
    """temperature 0.8: a spec stream follows the target only in
    distribution, but its draws are counter-based, so a request streams
    the same bytes at one slot and among three."""
    rt = _runtime()
    draft = R.speculative_draft(rt, mode="binary")
    rng = np.random.default_rng(8)
    reqs = [Request(prompt=rng.integers(0, VOCAB, size=int(rng.integers(2, 9))),
                    max_tokens=10, temperature=0.8, top_k=5, seed=40 + i,
                    rid=i) for i in range(4)]
    runs = []
    for slots in (1, 3):
        eng = ServeEngine(rt, VOCAB, slots=slots, max_context=CTX,
                          prefill_chunk=4, draft=draft, spec_k=3)
        comps, m = eng.run([dataclasses.replace(r) for r in reqs],
                           realtime=False)
        runs.append({c.rid: c.tokens for c in comps})
        assert m["drafted_tokens"] > 0
    assert runs[0] == runs[1]
    assert all(len(t) == 10 and max(t) < VOCAB for t in runs[0].values())


def _lively_runtime():
    """`_runtime()`'s fp masters with BN scales phi from [0.5, 1.5) and a
    unit-normal head, so the hidden state moves the logits."""
    if "lively" not in _RT:
        from repro_torch.core.recurrent_bn import BNParams
        rng = np.random.default_rng(2)
        var = _runtime().variables
        layers = [dict(lp, **{k: BNParams(
            phi=torch.from_numpy(0.5 + rng.random(lp[k].phi.shape).astype(
                np.float32)), gamma=lp[k].gamma)
            for k in ("bn_x", "bn_h", "bn_c")})
            for lp in var["params"]["layers"]]
        ws = var["params"]["head"]["ws"]
        head = dict(var["params"]["head"], ws=torch.from_numpy(
            rng.normal(size=tuple(ws.shape)).astype(np.float32)))
        _RT["lively"] = R.RNNRuntime(
            _runtime().cfg, {"params": dict(var["params"], layers=layers,
                                            head=head),
                             "state": var["state"]}, device="cpu")
    return _RT["lively"]


@pytest.mark.parametrize("mode,temperature", [("binary", 0.0),
                                              ("binary", 0.8),
                                              ("ternary", 0.8)])
def test_draft_rows_after_every_round_are_the_draft_alone(mode, temperature):
    """The draft pool's rollback, which the streams cannot show (the target
    decides every token, so a wrong draft row only lowers the acceptance):
    after every round, each live slot's draft row is the draft run alone
    over its prompt (in the engine's chunks) and the tokens it committed,
    bit for bit.  The target's BN scales and head are off init, so that
    rounds reject (at init h is about 1e-4 and the head bias decides every
    token, so every draft is accepted): the greedy binary draft is
    rejected at its first proposal, the sampled ones part way along."""
    rt = _lively_runtime()
    draft = R.speculative_draft(rt, mode=mode)
    rng = np.random.default_rng(9)
    eng = ServeEngine(rt, VOCAB, slots=3, max_context=CTX, prefill_chunk=4,
                      draft=draft, spec_k=3)
    for i in range(5):
        eng.submit(Request(prompt=rng.integers(0, VOCAB,
                                               size=int(rng.integers(1, 10))),
                           max_tokens=12, temperature=temperature, top_k=5,
                           seed=60 + i, rid=i))
    alone, compared = {}, 0
    while eng.has_work():
        eng.step()
        for slot in np.flatnonzero(eng._live_host):
            act = eng._active[slot]
            st = draft.init_state(1, per_slot=True)
            prompt = torch.as_tensor(act.prompt.astype(np.int64))[None]
            for lo in range(0, prompt.shape[1], 4):
                _, st = draft.prefill_chunk(prompt[:, lo:lo + 4], st)
            for tok in act.tokens[:-1]:          # the last one is pending
                _, st = draft.decode_step(torch.tensor([tok]), st)
            row = eng.draft_pool
            assert torch.equal(st.h[:, 0], row.h[:, slot])
            assert torch.equal(st.c[:, 0], row.c[:, slot])
            assert int(st.pos[0]) == int(row.pos[slot])
            alone[act.rid] = len(act.tokens)
            compared += 1
    s = eng.stats()
    assert s["drafted_tokens"] - s["accepted_drafts"] >= 5  # rollbacks ran
    assert compared >= 10 and len(alone) == 5


def test_unsupported_pairings_are_refused():
    rt, packed = _runtime(), _runtime("ternary")
    with pytest.raises(ValueError, match="fp masters"):
        R.speculative_draft(packed)
    draft = R.speculative_draft(rt)
    assert draft.cfg.quant.mode == "ternary" and draft.device == rt.device

    class Other:
        family, spec_capable, device = "transformer", True, rt.device
    with pytest.raises(ValueError, match="same serving family"):
        ServeEngine(rt, VOCAB, slots=2, max_context=CTX, draft=Other(),
                    spec_k=2)

    class NoRollback:
        family, spec_capable, device = "rnn", False, rt.device
    with pytest.raises(NotImplementedError, match="rollbackable"):
        ServeEngine(rt, VOCAB, slots=2, max_context=CTX,
                    draft=NoRollback(), spec_k=2)
    with pytest.raises(ValueError, match="64"):
        ServeEngine(rt, VOCAB, slots=2, max_context=CTX, draft=draft,
                    spec_k=65)
    with pytest.raises(NotImplementedError,
                       match="speculative pairing packs the target's fp"):
        R.speculative_draft(Other())
