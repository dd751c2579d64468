"""The port's MoE and RWKV6 serving paths on the CPU: `TransformerRuntime`
over mixtral-8x7b, qwen3-moe-30b-a3b and rwkv6-7b at `reduced()` size,
the continuous-batching engine's whole-prompt prefill over it, the
refusals JAX's engine makes for such runtimes, the launcher, and the
layer-at-a-time packed build.

Within the port everything is bit for bit: every engine stream equals
`drive_session(B=1)` on its request (sampled at temperature 0.8, top-k 5,
and greedy).  A "whole" runtime prefills a prompt as one chunk, so an
engine prompt meets the MoE capacity and the rwkv chunked scan exactly as
a prompt run alone does; decode steps route without drops; every serving
matmul keeps a row's bits its own on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.qtensor import (export_packed, is_qtensor, tree_map,
                                      tree_paths)
from repro_torch.core.quantize import QuantSpec
from repro_torch.kernels import dispatch
from repro_torch.launch.serve import synth_traffic
from repro_torch.models import transformer as T
from repro_torch.serve import recurrent as R
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.prefixcache import PrefixCache

torch.set_num_threads(1)
WHOLE = ("mixtral-8x7b", "qwen3-moe-30b-a3b", "rwkv6-7b")


def _runtime(arch, mode="ternary", seed=0):
    cfg = get_config(arch).reduced()
    spec = (QuantSpec(mode=mode, norm="channel") if mode != "none"
            else QuantSpec(mode="none"))
    cfg = cfg.with_quant(spec)
    params = T.model_init(torch.Generator().manual_seed(seed), cfg,
                          packed=mode != "none")
    return R.serving_runtime(cfg, params, device="cpu")


def _alone(rt, r, ctx):
    out, _ = R.drive_session(
        rt, torch.as_tensor(np.asarray(r.prompt, np.int64))[None],
        rt.cfg.vocab, gen=r.max_tokens, temperature=r.temperature,
        top_k=r.top_k, seed=r.seed, context=ctx)
    return out[0].tolist()


@pytest.mark.parametrize("arch", WHOLE)
def test_runtimes_prefill_whole_prompts(arch):
    rt = _runtime(arch)
    assert rt.chunk_granularity == "whole" and not rt.spec_capable
    dense = _runtime("qwen3-0.6b")
    assert dense.chunk_granularity == "token" and dense.spec_capable


@pytest.mark.parametrize("arch,mode", [
    ("mixtral-8x7b", "ternary"), ("qwen3-moe-30b-a3b", "ternary"),
    ("qwen3-moe-30b-a3b", "none"), ("rwkv6-7b", "binary"),
    ("rwkv6-7b", "none")])
def test_engine_streams_equal_drive_session(arch, mode):
    """Seven mixed requests at 3 slots: one prefill chunk a prompt (at its
    own length, whatever `prefill_chunk` says), at most one chunk between
    ticks, and every stream byte-equal to the request run alone."""
    rt = _runtime(arch, mode)
    ctx = 24 + 10
    reqs = synth_traffic(rt.cfg.vocab, requests=7, rate=1e3, prompt_len=24,
                         gen=10, temperature=0.8, top_k=5, seed=3)
    reqs[1] = dataclasses.replace(reqs[1], temperature=0.0, top_k=0)
    eng = ServeEngine(rt, rt.cfg.vocab, slots=3, max_context=ctx,
                      prefill_chunk=4)
    comps, m = eng.run([dataclasses.replace(r) for r in reqs],
                       realtime=False)
    assert m["requests"] == 7 and m["max_decode_stall_ticks"] <= 1
    assert eng.prefill_chunks == 7
    assert eng.prefill_steps == sum(np.asarray(r.prompt).size for r in reqs)
    by = {c.rid: c.tokens for c in comps}
    for r in reqs:
        assert by[r.rid] == _alone(rt, r, ctx), r.rid


def test_engine_scrubs_rwkv_slots_and_runs_packed_kernels():
    """A freed rwkv slot reads like a fresh one (state, shifts and pos
    zeroed), a tick runs every packed projection through the GEMV, and
    mixtral's MoE layers launch a GEMV per expert with kept rows."""
    rt = _runtime("rwkv6-7b")
    eng = ServeEngine(rt, rt.cfg.vocab, slots=2, max_context=16)
    reqs = synth_traffic(rt.cfg.vocab, requests=3, rate=1e3, prompt_len=6,
                         gen=3, temperature=0.8, top_k=5, seed=1)
    dispatch.reset_counts()
    eng.run(reqs, realtime=False)
    assert eng.tick_launches == 8 * rt.cfg.n_layers
    for leaf in tree_paths(eng.pool):
        assert not leaf[1].any(), leaf[0]
    moe = _runtime("mixtral-8x7b")
    eng = ServeEngine(moe, moe.cfg.vocab, slots=2, max_context=16)
    eng.run(reqs, realtime=False)
    # 4 attention projections, attention's 2 products and 3 a run expert
    # (top-2 of 4 at 2 rows)
    per_layer = eng.tick_launches / moe.cfg.n_layers - 4 - 2
    assert per_layer % 3 == 0 and 2 <= per_layer // 3 <= 4


@pytest.mark.parametrize("arch", WHOLE)
def test_speculation_and_prefix_cache_are_refused(arch):
    rt = _runtime(arch, "none")
    with pytest.raises(NotImplementedError,
                       match="MoE and rwkv/mamba runtimes do not"):
        ServeEngine(rt, rt.cfg.vocab, slots=2, max_context=16,
                    draft=R.speculative_draft(rt), spec_k=2)
    with pytest.raises(NotImplementedError, match="token-granularity"):
        ServeEngine(rt, rt.cfg.vocab, slots=2, max_context=16,
                    prefix_cache=PrefixCache(1 << 20))


@pytest.mark.parametrize("arch,mode", [
    ("qwen3-moe-30b-a3b", "ternary"), ("qwen3-moe-30b-a3b", "binary"),
    ("mixtral-8x7b", "ternary"), ("rwkv6-7b", "ternary"),
    ("rwkv6-7b", "binary"), ("qwen3-0.6b", "ternary")])
def test_layer_at_a_time_packed_build_equals_the_export(arch, mode):
    """`model_init(packed=True)` (each block exported as it is drawn, the
    codes stacked) gives `export_packed(model_init(...))`'s tree: the same
    paths, codes word for word, the same k, alpha and mode, fp leaves
    equal."""
    cfg = get_config(arch).reduced().with_quant(
        QuantSpec(mode=mode, norm="channel"))
    a = export_packed(T.model_init(torch.Generator().manual_seed(3), cfg),
                      cfg.quant)
    b = T.model_init(torch.Generator().manual_seed(3), cfg, packed=True)
    pa, pb = tree_paths(a), tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    n_packed = 0
    for (path, x), (_, y) in zip(pa, pb):
        if is_qtensor(x):
            n_packed += 1
            assert is_qtensor(y) and torch.equal(x.codes, y.codes), path
            assert (x.k, x.alpha, x.mode, x.scale, y.scale) == (
                y.k, y.alpha, y.mode, None, None), path
        else:
            assert torch.equal(x, y), path
    # a block's W* leaves: rwkv's eight; four attention projections and
    # three MLP or expert stacks (the head and router stay fp)
    assert n_packed == (8 if arch == "rwkv6-7b" else 7)


@pytest.mark.parametrize("arch", WHOLE)
def test_launcher_serves_whole_archs_reduced(arch, capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--gen", "3", "--prompt-len", "6", "--batch", "2"])
    assert out.shape == (2, 3)
    m = serve.main(["--arch", arch, "--device", "cpu", "--traffic",
                    "--requests", "3", "--slots", "2", "--rate", "100",
                    "--prompt-len", "8", "--gen", "4"])
    assert m["requests"] == 3 and m["max_decode_stall_ticks"] <= 1
    assert "transformer family, cpu" in capsys.readouterr().out


def test_launcher_refuses_full_moe_before_allocating(monkeypatch):
    """At full width with --quant none the fp32 expert masters (qwen3-moe
    116 GB, mixtral 180 GB) are checked against the device's memory before
    any draw; packed, the tree is drawn and exported a layer at a time."""
    from repro_torch.launch import serve
    assert serve.expert_master_bytes(get_config("qwen3-moe-30b-a3b")) == \
        4 * 3 * 48 * 128 * 2048 * 768
    assert round(serve.expert_master_bytes(
        get_config("mixtral-8x7b")) / 1e9) == 180
    assert serve.expert_master_bytes(get_config("rwkv6-7b")) == 0
    monkeypatch.setattr(serve, "device_memory", lambda device: 80 * 10 ** 9)
    monkeypatch.setattr(T, "model_init", lambda *a, **k: pytest.fail(
        "allocated before refusing"))
    for arch, gb in (("qwen3-moe-30b-a3b", 116), ("mixtral-8x7b", 180)):
        with pytest.raises(SystemExit, match=f"{gb} GB"):
            serve.main(["--arch", arch, "--full", "--device", "cpu",
                        "--quant", "none"])

    class Drawn(Exception):
        pass

    def model_init(gen, cfg, *, packed=False):
        assert packed and cfg.quant.mode == "ternary"
        raise Drawn
    monkeypatch.setattr(T, "model_init", model_init)
    with pytest.raises(Drawn):
        serve.main(["--arch", "qwen3-moe-30b-a3b", "--full", "--device",
                    "cpu", "--quant", "ternary"])


def test_slot_helpers_walk_rwkv_states():
    """The engine's tree helpers over an rwkv pool: a gathered row is an
    `RWKVState` of views on the slot axis (1 under "stack", after the
    layer axis; 0 in "tail"), writing it back is the identity, writing
    another row copies it in, and a scrub zeroes the row's S, shifts and
    pos and nothing else."""
    from repro_torch.models import rwkv6 as RW
    from repro_torch.serve.engine import (tree_gather_slot, tree_reset_slots,
                                          tree_write_slot)
    cfg = get_config("rwkv6-7b").reduced()
    pool = {"stack": ({"rwkv": RW.state_init(cfg, 3, per_slot=True,
                                             lead=(2,))},),
            "tail": ({"rwkv": RW.state_init(cfg, 3, per_slot=True)},)}
    g = torch.Generator().manual_seed(0)
    for leaf in tree_paths(pool):
        leaf[1].copy_(torch.randint(1, 9, leaf[1].shape, generator=g))
    st, tail = pool["stack"][0]["rwkv"], pool["tail"][0]["rwkv"]
    assert st.S.shape[:2] == (2, 3) and tail.S.shape[0] == 3
    row = tree_gather_slot(pool, 1)
    assert isinstance(row["stack"][0]["rwkv"], RW.RWKVState)
    assert row["stack"][0]["rwkv"].S.shape[:2] == (2, 1)
    assert torch.equal(row["tail"][0]["rwkv"].pos, tail.pos[1:2])
    before = [l.clone() for _, l in tree_paths(pool)]
    tree_write_slot(pool, row, 1)
    assert all(torch.equal(a, b) for a, (_, b) in zip(before,
                                                     tree_paths(pool)))
    other = tree_map(lambda l: l.clone(), tree_gather_slot(pool, 0))
    tree_write_slot(pool, other, 2)
    assert torch.equal(st.S[:, 2], st.S[:, 0])
    assert torch.equal(tail.tm_shift[2], tail.tm_shift[0])
    tree_reset_slots(pool, [1])
    for (path, a), b in zip(tree_paths(pool), before):
        ax = 1 if path[0] == "stack" else 0
        assert not a.narrow(ax, 1, 1).any(), path
        assert torch.equal(a.narrow(ax, 0, 1), b.narrow(ax, 0, 1)), path
