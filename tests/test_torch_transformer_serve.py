"""The port's dense transformer serving path on the CPU: `TransformerRuntime`,
the continuous-batching engine over it, speculative decoding, the prefix
cache and the launcher, at `reduced()` size.

Within the port everything is bit for bit: every request's engine stream
equals `drive_session(B=1)` on that request (sampled at temperature 0.8,
top-k 5, and greedy), however it was batched, chunked or spliced.  That
holds on the CPU because every serving matmul keeps a row's bits its own
(`ops.serve_matmul`, the packed kernels' plain versions), and attention's
products have at least two rows a head group, where the CPU's library
rounds a row alike at any row count.  `drive_session` gets the engine's
`max_context`, so both attend over caches of one capacity.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.qtensor import export_packed
from repro_torch.core.quantize import QuantSpec
from repro_torch.kernels import dispatch
from repro_torch.launch.serve import synth_traffic
from repro_torch.models import transformer as T
from repro_torch.serve import recurrent as R
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.prefixcache import PrefixCache

torch.set_num_threads(1)


def _runtime(arch="qwen3-0.6b", mode="ternary", seed=0, dtype=None):
    cfg = get_config(arch).reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    spec = (QuantSpec(mode=mode, norm="channel") if mode != "none"
            else QuantSpec(mode="none"))
    cfg = cfg.with_quant(spec)
    params = T.model_init(torch.Generator().manual_seed(seed), cfg)
    if mode != "none":
        params = export_packed(params, spec)
    return R.serving_runtime(cfg, params, device="cpu")


def _alone(rt, r, ctx):
    out, _ = R.drive_session(
        rt, torch.as_tensor(np.asarray(r.prompt, np.int64))[None],
        rt.cfg.vocab, gen=r.max_tokens, temperature=r.temperature,
        top_k=r.top_k, seed=r.seed, context=ctx)
    return out[0].tolist()


def _streams_equal_alone(rt, reqs, comps, ctx):
    by = {c.rid: c.tokens for c in comps}
    assert sorted(by) == sorted(r.rid for r in reqs)
    for r in reqs:
        assert by[r.rid] == _alone(rt, r, ctx), r.rid


@pytest.mark.parametrize("arch,mode,prompt_len", [
    ("qwen3-0.6b", "ternary", 24), ("qwen3-0.6b", "none", 24),
    ("llama3-8b", "binary", 24),
    # prompts past the local layers' ring capacity (window 16 + 128): the
    # ring wraps inside a prefill chunk and across decode steps
    ("gemma3-27b", "ternary", 150)])
def test_engine_streams_equal_drive_session(arch, mode, prompt_len):
    rt = _runtime(arch, mode)
    ctx = prompt_len + 12
    reqs = synth_traffic(rt.cfg.vocab, requests=7, rate=1e3,
                         prompt_len=prompt_len, gen=12, temperature=0.8,
                         top_k=5, seed=3)
    reqs[1] = dataclasses.replace(reqs[1], temperature=0.0, top_k=0)
    eng = ServeEngine(rt, rt.cfg.vocab, slots=3, max_context=ctx,
                      prefill_chunk=8)
    dispatch.reset_counts()
    comps, m = eng.run([dataclasses.replace(r) for r in reqs],
                       realtime=False)
    assert m["max_decode_stall_ticks"] <= 1 and m["requests"] == 7
    # attention's two products a layer a tick (`ordered_bmm`); packed, one
    # GEMV a projection too (the step route), and every prompt chunk's
    # projections take the GEMM (the sequence route) at any chunk length
    if mode != "none":
        assert m["tick_launches"] == (7 + 2) * rt.cfg.n_layers
        assert set(dispatch.PLAIN_CALLS) == {"packed_gemv", "packed_matmul",
                                             "ordered_bmm"}
    else:
        assert m["tick_launches"] == 2 * rt.cfg.n_layers
        assert set(dispatch.PLAIN_CALLS) == {"ordered_bmm"}
    _streams_equal_alone(rt, reqs, comps, ctx)


@pytest.mark.parametrize("chunk", [1, 3])
def test_prefill_chunks_take_the_gemm_and_steps_the_gemv(chunk):
    """Routing by role: a prompt chunk's projections take the GEMM (the
    sequence route) at 1 and 3 tokens, where JAX's row-count rule would
    take the GEMV; a decode step and a speculative verify over 16 rows
    take the GEMV (the step route), where the rule would take the GEMM.
    So a row never changes kernel between a stream and its
    drive_session(B=1) reference."""
    rt = _runtime()
    L = rt.cfg.n_layers
    st = rt.init_state(1, 32)
    dispatch.reset_counts()
    lg, st = rt.prefill_chunk(torch.arange(chunk)[None] + 5, st)
    assert dict(dispatch.PLAIN_CALLS) == {"packed_matmul": 7 * L,
                                          "ordered_bmm": 2 * L}
    st = rt.init_state(16, 32)
    lg, st = rt.prefill(torch.arange(16 * 4).reshape(16, 4) % 50, st)
    dispatch.reset_counts()
    lg, st = rt.decode_step(lg[:, :rt.cfg.vocab].argmax(-1), st)
    assert dict(dispatch.PLAIN_CALLS) == {"packed_gemv": 7 * L,
                                          "ordered_bmm": 2 * L}
    dispatch.reset_counts()
    lg, st, _ = rt.verify(torch.arange(16)[:, None] % 50, st)
    assert dict(dispatch.PLAIN_CALLS) == {"packed_gemv": 7 * L,
                                          "ordered_bmm": 2 * L}


def test_runtime_prepares_its_serving_tree_once():
    rt = _runtime(dtype="bfloat16")
    assert T._serve_quant(rt.served, rt.cfg) is rt.served
    assert rt.served["embed"].dtype == torch.bfloat16
    assert rt.params["embed"].dtype == torch.float32
    st = rt.init_state(2, 16)
    lg, st = rt.prefill(torch.zeros(2, 5, dtype=torch.long), st)
    lg, st = rt.decode_step(lg[:, :rt.cfg.vocab].argmax(-1), st)
    assert lg.dtype == torch.float32 and torch.isfinite(lg).all()
    assert st["stack"][0]["attn"].k.dtype == torch.bfloat16
    fp, packed = rt.param_nbytes()
    assert packed < fp
    assert R.state_nbytes(st) == sum(
        2 * c["attn"].k.numel() * 2 + c["attn"].pos.numel() * 4
        for c in st["stack"] + st["tail"])


def test_packed_decode_matches_the_dequantized_tree_in_bf16():
    """The bf16 path the card serves: x bf16 -> fp32 kernel input -> alpha
    -> bf16 -> channel scale.  Packed decode logits against the same
    weights dequantized into an fp tree, within 2 % of their largest
    magnitude (bf16 keeps 8 bits of mantissa; the two trees round the
    weights' products at different places)."""
    packed = _runtime(dtype="bfloat16")
    from repro_torch.core.qtensor import QTensor, tree_map
    fp = tree_map(lambda l: l.dequantize() if isinstance(l, QTensor) else l,
                  packed.params)
    # the init's channel scales are ones, so the fp tree needs no `scaled`
    fp_rt = R.TransformerRuntime(packed.cfg.with_quant(QuantSpec(mode="none")),
                                 fp, device="cpu")
    prompt = torch.randint(0, packed.cfg.vocab, (2, 6),
                           generator=torch.Generator().manual_seed(1))
    a, _ = packed.prefill(prompt, packed.init_state(2, 12))
    b, _ = fp_rt.prefill(prompt, fp_rt.init_state(2, 12))
    v = packed.cfg.vocab
    assert (a[:, :v] - b[:, :v]).abs().max() <= 0.02 * b[:, :v].abs().max()


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_speculative_engine(temperature):
    """fp target + its ternary draft, spec_k 3: at temperature 0 the
    streams equal the plain fp engine's; sampled, every stream still
    equals the target's own drive_session only in distribution, so the
    round runs and accounts its drafts."""
    rt = _runtime(mode="none")
    draft = R.speculative_draft(rt)
    assert draft.cfg.quant.mode == "ternary" and draft.device == rt.device
    reqs = synth_traffic(rt.cfg.vocab, requests=6, rate=1e3, prompt_len=20,
                         gen=10, temperature=temperature, top_k=0, seed=4)
    ctx = 32
    spec = ServeEngine(rt, rt.cfg.vocab, slots=3, max_context=ctx,
                       prefill_chunk=8, draft=draft, spec_k=3)
    sc, sm = spec.run([dataclasses.replace(r) for r in reqs], realtime=False)
    assert 0.0 <= sm["accept_rate"] <= 1.0 and sm["drafted_tokens"] > 0
    assert sm["tick_launches"] == 4 * (7 + 2) * rt.cfg.n_layers
    if temperature == 0.0:
        plain = ServeEngine(rt, rt.cfg.vocab, slots=3, max_context=ctx,
                            prefill_chunk=8)
        pc, _ = plain.run([dataclasses.replace(r) for r in reqs],
                          realtime=False)
        pby = {c.rid: c.tokens for c in pc}
        assert all(c.tokens == pby[c.rid] for c in sc)
        _streams_equal_alone(rt, reqs, sc, ctx)
    else:
        assert all(len(c.tokens) == r.max_tokens
                   for c, r in zip(sorted(sc, key=lambda c: c.rid), reqs))
    with pytest.raises(ValueError, match="fp masters"):
        R.speculative_draft(draft)


def test_speculative_rollback_restores_the_rejected_span():
    """After every round, each slot live through it holds, past its new
    position, the bytes it held before the round, in both pools: a
    rolled-back cache is bit-identical to one that never saw the rejected
    drafts (JAX's rollback tests assert the same tree equality)."""
    rt = _runtime(mode="none")
    eng = ServeEngine(rt, rt.cfg.vocab, slots=3, max_context=32,
                      prefill_chunk=8, draft=R.speculative_draft(rt),
                      spec_k=3)
    for r in synth_traffic(rt.cfg.vocab, requests=5, rate=1e3, prompt_len=12,
                           gen=12, temperature=0.8, top_k=0, seed=6):
        eng.submit(r)
    checked = 0
    caches = lambda pool: [c["attn"] for c in pool["stack"] + pool["tail"]]
    while eng.has_work():
        live = eng._live_host.copy()
        before = [[(c.k.clone(), c.v.clone()) for c in caches(pool)]
                  for pool in (eng.pool, eng.draft_pool)]
        eng.step()
        for pool, old in zip((eng.pool, eng.draft_pool), before):
            for c, (k0, v0) in zip(caches(pool), old):
                for s in np.flatnonzero(live & eng._live_host):
                    p = int(c.pos[0, s])
                    assert torch.equal(c.k[:, s, p:], k0[:, s, p:])
                    assert torch.equal(c.v[:, s, p:], v0[:, s, p:])
                    checked += 1
    st = eng.stats()
    assert checked > 0 and 0 < st["accepted_drafts"] < st["drafted_tokens"]


def test_prefix_cache_hit_streams_like_a_cold_prefill():
    rt = _runtime()
    rng = np.random.default_rng(5)
    system = rng.integers(0, rt.cfg.vocab, size=16)
    reqs = [Request(prompt=np.concatenate(
        [system, rng.integers(0, rt.cfg.vocab, size=int(rng.integers(1, 9)))]),
        max_tokens=6, temperature=0.8, top_k=5, seed=700 + i, rid=i)
        for i in range(5)]
    cache = PrefixCache(1 << 20)
    hot = ServeEngine(rt, rt.cfg.vocab, slots=2, max_context=32,
                      prefill_chunk=8, prefix_cache=cache)
    comps = hot.run([reqs[0]], realtime=False)[0]
    comps += hot.run(reqs[1:], realtime=False)[0]
    st = cache.stats()
    assert st["hits"] >= 4 and sum(c.cached_tokens for c in comps) >= 64
    # an entry holds only the written history (8 or 16 of 160 kv columns)
    for e in cache._entries.values():
        assert e.state["stack"][0]["attn"].k.shape[2] == e.tokens.size
    cold = ServeEngine(rt, rt.cfg.vocab, slots=2, max_context=32,
                       prefill_chunk=8)
    cc, _ = cold.run(reqs, realtime=False)
    cby = {c.rid: c.tokens for c in cc}
    assert all(c.tokens == cby[c.rid] for c in comps)
    _streams_equal_alone(rt, reqs, comps, 32)


def test_ring_caches_refuse_rollback_and_prefix_snapshots():
    rt = _runtime("gemma3-27b", "none")
    assert rt.ring_caches and not rt.spec_capable
    with pytest.raises(ValueError, match="non-ring"):
        ServeEngine(rt, rt.cfg.vocab, slots=2, max_context=16,
                    prefix_cache=PrefixCache(1 << 20))
    with pytest.raises(NotImplementedError, match="rollbackable"):
        ServeEngine(rt, rt.cfg.vocab, slots=2, max_context=16,
                    draft=R.speculative_draft(rt), spec_k=2)


def test_serving_runtime_refuses_other_families():
    """The vlm family serves (its image tokens as the runtime's `extras`);
    a config whose kinds its family does not run is refused."""
    cfg = get_config("llama-3.2-vision-90b").reduced()
    params = T.model_init(torch.Generator().manual_seed(0), cfg)
    img = torch.randn((2, cfg.n_img_tokens, cfg.d_model),
                      generator=torch.Generator().manual_seed(1))
    rt = R.serving_runtime(cfg, params, extras={"img": img}, device="cpu")
    out, _ = R.drive_session(rt, torch.zeros((2, 3), dtype=torch.int64),
                             cfg.vocab, gen=2, temperature=0.0)
    assert out.shape == (2, 2)
    odd = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              block_pattern=("cross",))
    with pytest.raises(NotImplementedError, match="does not run"):
        R.serving_runtime(odd, {}, device="cpu")


def test_launcher_serves_qwen3_reduced(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                      "--gen", "4", "--prompt-len", "8", "--batch", "2"])
    assert out.shape == (2, 4)
    m = serve.main(["--arch", "qwen3-0.6b", "--device", "cpu", "--traffic",
                    "--requests", "4", "--slots", "2", "--rate", "100",
                    "--prompt-len", "12", "--gen", "6"])
    assert m["requests"] == 4 and m["tick_launches"] == (7 + 2) * 2
    m = serve.main(["--arch", "qwen3-0.6b", "--device", "cpu", "--traffic",
                    "--requests", "3", "--slots", "2", "--rate", "100",
                    "--prompt-len", "12", "--gen", "6", "--spec-k", "2"])
    assert m["spec_k"] == 2 and 0.0 <= m["accept_rate"] <= 1.0
    text = capsys.readouterr().out
    assert "transformer family, cpu" in text and "speculative: k=2" in text
    out = serve.main(["--arch", "llama-3.2-vision-90b", "--reduced",
                      "--device", "cpu", "--gen", "3", "--prompt-len", "5",
                      "--batch", "2"])
    assert out.shape == (2, 3)
