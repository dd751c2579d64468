"""The port's mesh `ServeEngine` over gloo ranks on the CPU, held to the
contract of JAX's mesh suite (tests/test_mesh_engine.py): sharding is
invisible.  A data-sharded engine's per-request streams are byte-equal to
the single-device engine's on the same workload, and its decode tick
issues no collective (`tick_collectives() == 0`, the counterpart of
JAX's assertion on the tick's HLO).

Workloads are the fuzz harness's seeded scenarios (tests/test_engine_fuzz
._scenario) of the lstm-packed and qwen3 families, with 8 slots and
chunks of 4 so that the data axis divides the pool, over JAX's weights
(`convert`).  Byte parity is checked twice:

  * every stream against the port's own single-device engine (sampled
    and greedy), which tier-1 holds to `drive_session(B=1)`;
  * the greedy streams (every request of a scenario at temperature 0)
    against JAX's single-device engine.  Sampled streams cannot be
    compared with JAX's: the port samples from counter hashes of (seed,
    token index), JAX from its own PRNG (ROADMAP, parity traps).

Each rank is a child process (a file store, a timeout for each); the
meshes are built over the first D * M of 4 ranks, the rest wait.  A
packed qwen3 at data = 2, model = 2 drains with its codes sharded per
`qtensor_pspecs`, its streams the mesh=None engine's (tensor parallelism
sums over shards in another order, 2e-7 of the logits here), and so
does a packed qwen3-moe (`moe._moe_packed_mesh`, its layer within 1e-5
of mesh=None's); a prefix cache on a data mesh splices an entry built on
one data shard into a slot of another, every stream the mesh=None
engine's with and without the cache; `slots % D` raises, `stats()`
reports the shards, and `launch.serve --mesh` runs under `torchrun`, with
--traffic and with --listen (two requests over HTTP, one behind the
other's prefix, streamed what --listen without a mesh streams).
"""
import dataclasses
import os
import pickle
import random
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import bnlstm as JBL
from repro.core.qtensor import export_packed as j_export_packed
from repro.core.qtensor import is_qtensor as is_jqt
from repro.core.quantize import QuantSpec as JQuantSpec
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro.serve import recurrent as JR
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import bnlstm as BL
from repro_torch.core.qtensor import is_qtensor, tree_leaves
from repro_torch.core.quantize import QuantSpec
from repro_torch.serve import recurrent as R
from repro_torch.serve.engine import Request, ServeEngine

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
CHILD_TIMEOUT = 240
CTX, SLOTS, CHUNK = 32, 8, 4
SEEDS = {"lstm-packed": (100, 101, 103), "qwen3": (300, 302)}
SPECS = ("data=2", "data=4")
_ARCH = {"qwen3": "qwen3-0.6b", "qwen3-packed": "qwen3-0.6b",
         "moe-packed": "qwen3-moe-30b-a3b"}
MOE_SEEDS = (300, 301)
MOE_REL = 1e-5


def prefix_workload(vocab: int) -> list:
    """Two phases over one engine: request 0 alone (admitted to slot 0, on
    data shard 0, its chunk boundaries cached), then requests 1 and 2
    behind the same 8-token prefix (the balancer puts 2 on another data
    shard), each phase a list of requests; greedy and sampled."""
    rng = np.random.default_rng(11)
    system = rng.integers(0, vocab, size=8)
    tail = lambda n: np.concatenate([system, rng.integers(0, vocab, size=n)])
    return [[Request(prompt=tail(3), max_tokens=5, temperature=0.0, seed=1,
                     rid=0)],
            [Request(prompt=tail(2), max_tokens=6, temperature=0.8,
                     top_k=5, seed=2, rid=1),
             Request(prompt=tail(5), max_tokens=4, temperature=0.0, seed=3,
                     rid=2)]]


def drain_phases(eng, phases) -> dict:
    """Each phase drained in turn on one engine: {rid: (tokens, finished,
    slot, cached tokens)}."""
    out = {}
    for reqs in phases:
        comps, _ = eng.run([dataclasses.replace(r) for r in reqs],
                           realtime=False)
        out.update({c.rid: (c.tokens, c.finished, c.slot, c.cached_tokens)
                    for c in comps})
    return out


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(TESTS)]
        + [p for p in [env.get("PYTHONPATH")] if p])
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env["TORCH_CPP_LOG_LEVEL"] = "ERROR"
    return env


def _run_children(cmds: list, env: dict, cwd=None) -> list:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=cwd) for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT)
            outs.append((out, err))
            assert p.returncode == 0, f"child exited {p.returncode}:\n{err}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


# --- the families, over JAX's weights ----------------------------------------


def jax_variables(family: str):
    """JAX's runtime tree for a family."""
    if family == "lstm-packed":
        cfg = JBL.RNNConfig(vocab=24, d_hidden=48, n_layers=2, cell="lstm",
                            quant=JQuantSpec(mode="ternary", norm="batch"))
        var = JBL.rnn_lm_init(jax.random.PRNGKey(0), cfg)
        return {"params": JBL.export_packed_rnn(var["params"], cfg),
                "state": var["state"]}
    cfg = j_get_config(_ARCH[family]).reduced()
    if family.endswith("-packed"):
        cfg = cfg.with_quant(JQuantSpec(mode="ternary", norm="channel"))
        return j_export_packed(JT.model_init(jax.random.PRNGKey(0), cfg),
                               cfg.quant)
    return JT.model_init(jax.random.PRNGKey(0), cfg)


def _numpy(tree):
    """A JAX tree as numpy, packed leaves as `convert`'s dicts."""
    def leaf(l):
        if is_jqt(l):
            return {"codes": np.asarray(l.codes), "k": l.k, "mode": l.mode,
                    "alpha": l.alpha, "scale": None if l.scale is None
                    else np.asarray(l.scale)}
        return np.asarray(l)
    return jax.tree.map(leaf, tree, is_leaf=is_jqt)


def port_runtime(family: str, tree):
    if family == "lstm-packed":
        cfg = BL.RNNConfig(vocab=24, d_hidden=48, n_layers=2, cell="lstm",
                           quant=QuantSpec(mode="ternary", norm="batch"))
        return R.RNNRuntime(cfg, convert.from_numpy(tree, "cpu"),
                            device="cpu"), cfg.vocab
    cfg = get_config(_ARCH[family]).reduced()
    if family.endswith("-packed"):
        cfg = cfg.with_quant(QuantSpec(mode="ternary", norm="channel"))
    return R.TransformerRuntime(cfg, convert.from_numpy(tree, "cpu"),
                                device="cpu"), cfg.vocab


def scenario(seed: int, vocab: int, greedy: bool = False) -> list:
    import test_engine_fuzz as fuzz
    reqs, _eos, _slots, _chunk = fuzz._scenario(seed, vocab)
    reqs = [Request(**{f.name: getattr(r, f.name)
                       for f in dataclasses.fields(Request)}) for r in reqs]
    if greedy:
        reqs = [dataclasses.replace(r, temperature=0.0, top_k=0)
                for r in reqs]
    return reqs


def drain(eng, reqs) -> dict:
    comps, _ = eng.run([dataclasses.replace(r) for r in reqs],
                       realtime=False)
    return {c.rid: (c.tokens, c.finished) for c in comps}


# --- the ranks ---------------------------------------------------------------

MESH_WORKER = textwrap.dedent('''
    import pickle, sys
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, job, out = sys.argv[1:]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    import test_torch_mesh_engine as D
    with open(job, "rb") as f:
        job = pickle.load(f)
    got = D.rank_runs(rank, job)
    with open(out.format(rank), "wb") as f:
        pickle.dump(got, f)
    dist.destroy_process_group()
''')


def rank_runs(rank: int, trees: dict) -> dict:
    """Everything the mesh tests read, on one rank: streams of each family
    over each mesh and scenario (sampled and greedy) with the tick's
    collectives; the packed qwen3 at data = 2, model = 2 with its code
    layouts; the slot-divisibility refusal; a stats snapshot mid-flight."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as S
    from repro_torch.runtime import placements
    out = {"streams": {}, "collectives": {}}
    for family, seeds in SEEDS.items():
        rt, vocab = port_runtime(family, trees[family])
        for spec in SPECS:
            mesh = M.make_serve_mesh(spec, "cpu")
            if mesh.get_coordinate() is None:
                continue
            eng = ServeEngine(rt, vocab, slots=SLOTS, max_context=CTX,
                              prefill_chunk=CHUNK, mesh=mesh)
            for seed in seeds:
                for greedy in (False, True):
                    key = (family, spec, seed, greedy)
                    out["streams"][key] = drain(
                        eng, scenario(seed, vocab, greedy))
                    out["collectives"][key] = eng.tick_collectives()
    # tensor parallelism: a packed qwen3 over data = 2, model = 2
    rt, vocab = port_runtime("qwen3-packed", trees["qwen3-packed"])
    mesh = M.make_serve_mesh("data=2,model=2", "cpu")
    eng = ServeEngine(rt, vocab, slots=SLOTS, max_context=CTX,
                      prefill_chunk=CHUNK, mesh=mesh)
    got = drain(eng, scenario(301, vocab))
    want = S.serve_param_shardings(rt.params, mesh)
    layouts = []
    for q, lay in zip(
            [l for l in tree_leaves(eng.rt.params) if is_qtensor(l)],
            [l for l in tree_leaves(want) if is_qtensor(l)]):
        layouts.append((lay.codes, tuple(q.codes.placements) == placements(
            lay.codes, mesh["model"]), isinstance(
                q.codes, torch.distributed.tensor.DTensor)))
    out["tp"] = {"streams": got, "layouts": layouts,
                 "collectives": eng.tick_collectives(),
                 "stats": eng.stats()}
    # a packed MoE layer on data = 2, model = 2: the experts split over
    # 'model', each rank's on its local codes
    rt, vocab = port_runtime("moe-packed", trees["moe-packed"])
    mesh = M.make_serve_mesh("data=2,model=2", "cpu")
    eng = ServeEngine(rt, vocab, slots=SLOTS, max_context=CTX,
                      prefill_chunk=CHUNK, mesh=mesh)
    out["moe"] = {seed: drain(eng, scenario(seed, vocab))
                  for seed in MOE_SEEDS}
    x = torch.randn((3, 5, rt.cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    from repro_torch.models.moe import moe_apply
    from torch.distributed.tensor import DTensor, Replicate
    with torch.no_grad():
        want = moe_apply(rt.served.layers[0][1]["moe"], x, rt.cfg)[0]
        with eng.rt.mesh_context():
            got = moe_apply(eng.rt.served.layers[0][1]["moe"],
                            DTensor.from_local(x, eng.rt.tp_mesh,
                                               [Replicate()]), rt.cfg)[0]
    out["moe_apply"] = (S.full(got), want)
    # a prefix cache on a data mesh: entries broadcast from the owning shard
    from repro_torch.serve.prefixcache import PrefixCache
    rt, vocab = port_runtime("qwen3", trees["qwen3"])
    mesh = M.make_serve_mesh("data=2", "cpu")
    if mesh.get_coordinate() is not None:
        cache = PrefixCache(1 << 22)
        eng = ServeEngine(rt, vocab, slots=SLOTS, max_context=CTX,
                          prefill_chunk=CHUNK, mesh=mesh, prefix_cache=cache)
        out["prefix"] = {"streams": drain_phases(eng,
                                                 prefix_workload(vocab)),
                         "stats": cache.stats()}
    # slots must split over the data shards
    mesh = M.make_serve_mesh("data=4", "cpu")
    rt, vocab = port_runtime("lstm-packed", trees["lstm-packed"])
    try:
        ServeEngine(rt, vocab, slots=6, max_context=CTX,
                    prefill_chunk=CHUNK, mesh=mesh)
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    # three requests in flight over four shards, then drained
    eng = ServeEngine(rt, vocab, slots=SLOTS, max_context=CTX,
                      prefill_chunk=CHUNK, mesh=mesh)
    rng = random.Random(7)
    for i in range(3):
        eng.submit(Request(prompt=np.array([rng.randrange(vocab)], np.int32),
                           max_tokens=4, temperature=0.0, top_k=0, seed=i))
    for _ in range(2):
        eng.step()
    out["stats"] = eng.stats()
    while eng.has_work():
        eng.step()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    jtrees = {f: jax_variables(f) for f in ("lstm-packed", "qwen3",
                                            "qwen3-packed", "moe-packed")}
    trees = {f: _numpy(t) for f, t in jtrees.items()}
    job = tmp / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump(trees, f)
    out = str(tmp / "out{}.pkl")
    _run_children([[sys.executable, "-c", MESH_WORKER, str(r), "4",
                    str(tmp / "store"), str(job), out] for r in range(4)],
                  _env())
    got = []
    for r in range(4):
        with open(out.format(r), "rb") as f:
            got.append(pickle.load(f))
    return trees, jtrees, got


_REFS: dict = {}


def _cached(key, fn):
    if key not in _REFS:
        _REFS[key] = fn()
    return _REFS[key]


def _single_device(family, tree, seed, greedy) -> dict:
    rt, vocab = port_runtime(family, tree)
    eng = ServeEngine(rt, vocab, slots=SLOTS, max_context=CTX,
                      prefill_chunk=CHUNK)
    return drain(eng, scenario(seed, vocab, greedy))


def _jax_single_device(family, tree, seeds) -> dict:
    """JAX's single-device engine, greedy, on each seed's scenario."""
    if family == "lstm-packed":
        cfg = JBL.RNNConfig(vocab=24, d_hidden=48, n_layers=2, cell="lstm",
                            quant=JQuantSpec(mode="ternary", norm="batch"))
        rt = JR.RNNRuntime(cfg, tree, dense_tables=False, interpret=True)
    else:
        cfg = j_get_config("qwen3-0.6b").reduced()
        rt = JR.TransformerRuntime(cfg, tree)
    eng = JE.ServeEngine(rt, cfg.vocab, slots=SLOTS, max_context=CTX,
                         prefill_chunk=CHUNK)
    out = {}
    for seed in seeds:
        reqs = [JE.Request(**dataclasses.asdict(r))
                for r in scenario(seed, cfg.vocab, greedy=True)]
        comps, _ = eng.run(reqs, realtime=False)
        out[seed] = {c.rid: (c.tokens, c.finished) for c in comps}
    return out


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("family", list(SEEDS))
def test_data_sharded_streams_are_the_single_device_engines(ranks, family,
                                                            spec):
    """Every request's stream on a data mesh equals the single-device
    engine's, sampled and greedy, on every rank of the mesh; the greedy
    ones equal JAX's single-device engine's too; and the decode tick
    issued no collective."""
    trees, jtrees, got = ranks
    jax_greedy = _cached(("jax", family), lambda: _jax_single_device(
        family, jtrees[family], SEEDS[family]))
    D = int(spec.split("=")[1])
    for seed in SEEDS[family]:
        for greedy in (False, True):
            key = (family, spec, seed, greedy)
            on = [g for g in got if key in g["streams"]]
            assert len(on) == D
            want = _cached((family, seed, greedy), lambda: _single_device(
                family, trees[family], seed, greedy))
            for g in on:
                assert g["streams"][key] == want, (key, g["streams"][key])
                assert g["collectives"][key] == 0
            if greedy:
                assert want == jax_greedy[seed], (key, jax_greedy[seed])


def test_packed_qwen3_drains_with_codes_sharded_over_model(ranks):
    """data = 2, model = 2 over a packed qwen3: the workload drains on
    every rank alike, its streams the mesh=None engine's, every packed
    leaf's codes are a DTensor in `qtensor_pspecs`' layout over the model
    axis, some sharded along 'model' (columns of the up-projections,
    packed rows of the down); the tensor-parallel tick reduces over
    'model'."""
    trees, _, got = ranks
    runs = [g["tp"] for g in got]
    rt, vocab = port_runtime("qwen3-packed", trees["qwen3-packed"])
    reqs = scenario(301, vocab)
    want = drain(ServeEngine(rt, vocab, slots=SLOTS, max_context=CTX,
                             prefill_chunk=CHUNK), reqs)
    for r in runs:
        assert r["streams"] == runs[0]["streams"] == want
        assert sorted(r["streams"]) == [q.rid for q in reqs]
        for q in reqs:
            toks, fin = r["streams"][q.rid]
            assert 1 <= len(toks) <= q.max_tokens
        assert r["layouts"] and all(ok and dt for _, ok, dt in r["layouts"])
        assert any("model" in str(spec) for spec, _, _ in r["layouts"])
        assert r["collectives"] > 0
        assert r["stats"]["mesh"] == {"data": 2, "model": 2}


def test_packed_moe_on_a_mesh_is_the_single_device_engines(ranks):
    """A packed qwen3-moe at data = 2, model = 2 (4 experts over 'model',
    each rank's through `qmatmul` on its local codes): every stream, on
    every rank, is the mesh=None engine's, and the layer's output is
    within 1e-5 of mesh=None's."""
    trees, _, got = ranks
    rt, vocab = port_runtime("moe-packed", trees["moe-packed"])
    for seed in MOE_SEEDS:
        eng = ServeEngine(rt, vocab, slots=SLOTS, max_context=CTX,
                          prefill_chunk=CHUNK)
        want = drain(eng, scenario(seed, vocab))
        for g in got:
            assert g["moe"][seed] == want, (seed, g["moe"][seed], want)
    for g in got:
        mesh_y, plain_y = g["moe_apply"]
        err = float((mesh_y - plain_y).abs().max() / plain_y.abs().max())
        assert err <= MOE_REL, err


def test_prefix_cache_on_a_mesh_is_the_single_device_engines(ranks):
    """A prefix cache on a data = 2 mesh: every rank's streams equal the
    mesh=None engine's with the cache and without it; the shared prefix
    hits, and the entry built from request 0's slot on data shard 0 is
    spliced into request 2's slot on shard 1."""
    from repro_torch.serve.prefixcache import PrefixCache
    trees, _, got = ranks
    rt, vocab = port_runtime("qwen3", trees["qwen3"])
    phases = prefix_workload(vocab)
    stream = lambda d: {rid: v[:2] for rid, v in d.items()}
    cached = ServeEngine(rt, vocab, slots=SLOTS, max_context=CTX,
                         prefill_chunk=CHUNK,
                         prefix_cache=PrefixCache(1 << 22))
    want = drain_phases(cached, phases)
    cold = drain_phases(ServeEngine(rt, vocab, slots=SLOTS, max_context=CTX,
                                    prefill_chunk=CHUNK), phases)
    assert stream(want) == stream(cold)
    on = [g for g in got if "prefix" in g]
    assert len(on) == 2
    for g in on:
        mine = g["prefix"]["streams"]
        assert stream(mine) == stream(want), (mine, want)
        assert g["prefix"]["stats"]["hits"] > 0
        assert mine[0][2] < SLOTS // 2 <= mine[2][2]  # shard 0, then 1
        assert mine[2][3] > 0 and mine[1][3] > 0


def test_slots_must_split_over_the_data_shards(ranks):
    _, _, got = ranks
    for g in got:
        assert "split evenly" in g["refusal"]


def test_stats_report_per_shard_occupancy(ranks):
    """Three requests in flight over four data shards: the admissions
    spread over three shards (JAX's balancer), `stats()` reports the mesh,
    each shard and the engine's tick collectives."""
    _, _, got = ranks
    for g in got:
        s = g["stats"]
        assert s["mesh"] == {"data": 4, "model": 1}
        assert len(s["shards"]) == 4 and all(sh["slots"] == 2
                                             for sh in s["shards"])
        assert sum(sh["active"] for sh in s["shards"]) == s["active"] == 3
        assert sum(sh["active"] > 0 for sh in s["shards"]) == 3
        assert s["queue_depth"] == s["queued"]
        assert s["tick_collectives"] == 0


def test_serve_mesh_under_torchrun(tmp_path):
    """`torchrun --nproc-per-node 4` of `launch.serve --mesh
    data=2,model=2 --traffic` over a reduced qwen3 (fp masters): JAX's
    banner once (rank 0 prints) and the traffic report."""
    (out, err), = _run_children([[
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc-per-node", "4", "-m", "repro_torch.launch.serve",
        "--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--quant",
        "none", "--traffic", "--requests", "6", "--slots", "4", "--rate",
        "100", "--gen", "6", "--prompt-len", "8", "--mesh",
        "data=2,model=2"]], _env(), cwd=tmp_path)
    assert out.count("mesh: data=2,model=2 over 4 device(s) — slot pool "
                     "sharded along 'data', weights tensor-parallel along "
                     "'model'") == 1, out
    assert "traffic: 6 requests" in out and "aggregate decode" in out, out


LISTEN_ARGS = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
               "--quant", "none", "--listen", "--port", "0", "--slots", "4",
               "--prefill-chunk", "4", "--prompt-len", "16", "--gen", "8",
               "--prefix-cache-mb", "8"]


def _listening(proc, deadline: float) -> int:
    """The port a launcher's front door reports it listens on."""
    import re
    import time
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        m = re.search(r"front door listening on http://[\d.]+:(\d+)", line)
        if m:
            return int(m.group(1))
    raise AssertionError(f"no front door: exit {proc.poll()}, "
                         f"{proc.stderr.read()[-3000:]}")


def test_listen_on_a_mesh_under_torchrun(tmp_path):
    """`torchrun --nproc-per-node 2` of `launch.serve --listen --mesh
    data=2` beside `--listen` without a mesh: two requests over HTTP, the
    second behind the first's 8-token prefix, get the same tokens from
    both; on the mesh the second is served from the prefix cache."""
    import asyncio
    import signal
    import time
    from repro_torch.serve.frontdoor import _post_stream
    env = _env()
    env["PYTHONUNBUFFERED"] = "1"
    cmds = {"mesh": [sys.executable, "-m", "torch.distributed.run",
                     "--standalone", "--nproc-per-node", "2", "-m",
                     "repro_torch.launch.serve", *LISTEN_ARGS, "--mesh",
                     "data=2"],
            "plain": [sys.executable, "-m", "repro_torch.launch.serve",
                      *LISTEN_ARGS]}
    procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env,
                                 cwd=tmp_path, start_new_session=True)
             for k, c in cmds.items()}
    rng = np.random.default_rng(3)
    system = rng.integers(0, 256, size=8).tolist()
    bodies = [{"prompt": system + rng.integers(0, 256, size=6).tolist(),
               "max_tokens": 6, "temperature": 0.8, "top_k": 5, "seed": 1},
              {"prompt": system + rng.integers(0, 256, size=3).tolist(),
               "max_tokens": 5, "temperature": 0.0, "seed": 2}]
    got = {}
    try:
        deadline = time.time() + CHILD_TIMEOUT
        for k, p in procs.items():
            port = _listening(p, deadline)

            async def client():
                return [await asyncio.wait_for(_post_stream(
                    "127.0.0.1", port, b), timeout=CHILD_TIMEOUT)
                    for b in bodies]
            got[k] = asyncio.run(client())
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGINT)
        for p in procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for (toks, done), (want, wdone) in zip(got["mesh"], got["plain"]):
        assert done is not None and toks == want, (toks, want)
        assert done["n_tokens"] == wdone["n_tokens"] == len(toks)
    assert got["mesh"][1][1]["cached_tokens"] >= 8
    assert got["plain"][1][1]["cached_tokens"] >= 8
