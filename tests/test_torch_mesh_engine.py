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
`qtensor_pspecs` (a liveness and layout proof: tensor parallelism sums
over shards in another order, as JAX's test says), `slots % D` raises,
`stats()` reports the shards, and `launch.serve --mesh` runs under
`torchrun`.
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
    cfg = j_get_config("qwen3-0.6b").reduced()
    if family == "qwen3-packed":
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
    cfg = get_config("qwen3-0.6b").reduced()
    if family == "qwen3-packed":
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
                                            "qwen3-packed")}
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
    every rank alike, every packed leaf's codes are a DTensor in
    `qtensor_pspecs`' layout over the model axis, some sharded along
    'model' (columns of the up-projections, packed rows of the down);
    the tensor-parallel tick reduces over 'model'."""
    trees, _, got = ranks
    runs = [g["tp"] for g in got]
    rt, vocab = port_runtime("qwen3-packed", trees["qwen3-packed"])
    reqs = scenario(301, vocab)
    for r in runs:
        assert r["streams"] == runs[0]["streams"]
        assert sorted(r["streams"]) == [q.rid for q in reqs]
        for q in reqs:
            toks, fin = r["streams"][q.rid]
            assert 1 <= len(toks) <= q.max_tokens
        assert r["layouts"] and all(ok and dt for _, ok, dt in r["layouts"])
        assert any("model" in str(spec) for spec, _, _ in r["layouts"])
        assert r["collectives"] > 0
        assert r["stats"]["mesh"] == {"data": 2, "model": 2}


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
