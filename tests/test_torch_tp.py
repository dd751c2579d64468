"""The port's tensor-parallel training (a mesh with a 'model' axis above
1) against the JAX package's SPMD step on the CPU.

JAX runs one controller over 4 forced host devices, in a child process of
its own: `make_train_step` jitted with `state_shardings` and
`batch_shardings` under `use_mesh(mesh, param_rules=param_pspec)`, as its
launcher runs it.  The port runs one gloo rank a device, each a child
process (a file store in the test's directory, a timeout for each):
the state as DTensors in the same layouts, each rank fed its data block,
the collectives issued by eager DTensor ops.  Both sides are reduced
qwen3-0.6b and qwen3-moe-30b-a3b at (data, model) = (2, 2) and (1, 2), two
steps, plain and with --compress-grads (JAX's shard_map branch: whole
parameters on every model rank, the mean over the data axes).

Randomness is JAX's, injected: the model noise from `sub =
split(state.rng)[1]` (plain) or `split(sub)[0]` (compressed), and replica
r's compression draws from `fold_in(split(sub)[1], r)`.

Tolerances: the loss within 1e-6 relative; every state leaf within 2e-5
relative L2, eager fp32 sums against XLA's in other orders and over other
shard boundaries (tests/test_torch_dp.py, whose tolerances these are).
The ranks' `full_tensor()` of every leaf are bit-equal.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import quantize as JQ
from repro.launch import sharding as JS
from repro.models import transformer as JT
from repro.runtime import use_mesh
from repro.train import checkpoint as JCK
from repro.train import optimizer as JOPT
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.qtensor import tree_leaves, tree_map
from repro_torch.data import loader as LD
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S
from repro_torch.train import checkpoint as CK
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
CHILD_TIMEOUT = 300
REL = 1e-6
STATE_REL = 2e-5
OPT_KW = dict(lr=1e-3, clip_norm=1.0, warmup_steps=20)  # the launcher's
ARCHS = ("qwen3-0.6b", "qwen3-moe-30b-a3b")
SHAPES = ((2, 2), (1, 2))
RUNS = [(a, s, c) for a in ARCHS for s in SHAPES for c in (False, True)]
B, T_SEQ, STEPS = 4, 16, 2


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
    """Start every command at once and wait for each within the timeout;
    on a timeout or a failure kill them all and fail."""
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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _batch(cfg, step: int) -> dict:
    rng = np.random.default_rng(70 + step)
    toks = rng.integers(0, cfg.vocab, size=(B, T_SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _init(arch: str, compress: bool):
    cfg = j_get_config(arch).reduced()
    params = JT.model_init(jax.random.PRNGKey(0), cfg)
    return JTS.train_state_init(params, JOPT.OptConfig(**OPT_KW),
                                jax.random.PRNGKey(7), compress=compress)


def _model_noise(cfg, key, params) -> dict:
    """The noise JAX's training forward draws from `key`, {path: u}."""
    out, pol = {}, cfg.quant.policy()

    def f(path, leaf):
        if pol.matches(path, leaf):
            name = JQ.path_str(path)
            k = jax.random.fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)
            out[name] = torch.from_numpy(np.array(
                jax.random.uniform(k, leaf.shape, leaf.dtype)))
        return leaf
    jax.tree_util.tree_map_with_path(f, params)
    return out


def jax_draws(arch: str, shape: tuple, compress: bool) -> list:
    """Every step's batch, model noise and each data replica's compression
    draws, as JAX's step draws them from its state's key (the key of step
    s + 1 is `split(key of step s)[0]`, whatever the parameters hold)."""
    cfg = j_get_config(arch).reduced()
    jst = _init(arch, compress)
    rng, rec = jst.rng, []
    leaves = jax.tree.leaves(jst.params)
    for s in range(STEPS):
        rng, sub = jax.random.split(rng)
        comp = []
        if compress:
            k_model, k_comp = jax.random.split(sub)
            for r in range(shape[0]):
                keys = jax.random.split(jax.random.fold_in(k_comp, r),
                                        len(leaves))
                comp.append([torch.from_numpy(np.array(
                    jax.random.uniform(k, l.shape, jnp.float32)))
                    for k, l in zip(keys, leaves)])
        else:
            k_model = sub
        rec.append({"batch": _batch(cfg, s), "comp": comp,
                    "noise": _model_noise(cfg, k_model, jst.params)})
    return rec


def jax_tp_run(arch: str, shape: tuple, compress: bool) -> dict:
    """JAX's SPMD step on a (data, model) mesh of forced host devices,
    jitted with the launcher's mesh and shardings: its losses and final
    state."""
    n = shape[0] * shape[1]  # the launcher's mesh (train/elastic.py)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                             ("data", "model"))
    cfg = j_get_config(arch).reduced()
    jst = _init(arch, compress)
    fn = JTS.make_train_step(cfg, JOPT.OptConfig(**OPT_KW), mesh=mesh,
                             compress_grads=compress)
    st_sh = JS.state_shardings(jst, mesh)
    b_sh = JS.batch_shardings({k: jnp.asarray(v) for k, v in
                               _batch(cfg, 0).items()}, mesh)
    step = jax.jit(fn, in_shardings=(st_sh, b_sh), out_shardings=(st_sh,
                                                                   None))
    losses = []
    with use_mesh(mesh, param_rules=JS.param_pspec):
        for s in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in _batch(cfg, s).items()}
            jst, m = step(jst, batch)
            losses.append(float(m["loss"]))
    return {"losses": losses, "final": _np(jst)}


def jax_runs(arch: str) -> dict:
    assert len(jax.devices()) >= 4
    return {run: jax_tp_run(*run) for run in RUNS if run[0] == arch}


TP_WORKER = textwrap.dedent('''
    import pickle, sys
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, job, out = sys.argv[1:]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    import test_torch_tp as D
    with open(job, "rb") as f:
        job = pickle.load(f)
    got = job["run"](rank, **job["kw"])
    with open(out.format(rank), "wb") as f:
        pickle.dump(got, f)
    dist.destroy_process_group()
''')


def port_runs(rank: int, draws: dict, ckpt: str) -> dict:
    """Every run of RUNS on this rank: the mesh over the first d * m ranks
    (the others take part in making it and wait), JAX's initial state,
    JAX's batches and draws; the final state gathered whole (every rank of
    the mesh joins each leaf's `full_tensor()`) and the losses.  The plain
    qwen3 run at (2, 2) also writes a checkpoint."""
    out = {}
    for run in RUNS:
        arch, shape, compress = run
        mesh = M.first_ranks_mesh("cpu", shape, ("data", "model"))
        if mesh.get_coordinate() is None:
            continue
        tcfg = get_config(arch).reduced()
        state = convert.from_numpy(_np(_init(arch, compress)), "cpu")
        step = TS.make_train_step(tcfg, OPT.OptConfig(**OPT_KW), mesh=mesh,
                                  compress_grads=compress)
        r = M.data_index(mesh)[0]
        losses = []
        for s in draws[run]:
            batch = {k: torch.from_numpy(v) for k, v in
                     LD.data_block(s["batch"], mesh).items()}
            state, m = step(state, batch, noise=s["noise"],
                            comp_noise=s["comp"][r] if compress else None)
            losses.append(float(m["loss"]))
        dtensors = isinstance(tree_leaves(state.params)[0],
                              torch.distributed.tensor.DTensor)
        if run == ("qwen3-0.6b", (2, 2), False):
            CK.save(state, ckpt, 2, mesh=mesh)
        out[run] = {"losses": losses, "dtensors": dtensors,
                    "state": tree_map(S.full, state)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs (a child an arch, on 4 forced host devices) and the
    port's (4 gloo ranks, fed the draws JAX's key gives), all at once."""
    tmp = tmp_path_factory.mktemp("tp")
    draws = {run: jax_draws(*run) for run in RUNS}
    job = tmp / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump({"run": port_runs,
                     "kw": {"draws": draws, "ckpt": str(tmp / "ckpt")}}, f)
    out = str(tmp / "out{}.pkl")
    port = [[sys.executable, "-c", TP_WORKER, str(r), "4",
             str(tmp / "store"), str(job), out] for r in range(4)]
    code = ("import pickle, sys, test_torch_tp as D; "
            "pickle.dump(D.jax_runs(sys.argv[1]), open(sys.argv[2], 'wb'))")
    ref = [[sys.executable, "-c", code, a, str(tmp / f"jax{i}.pkl")]
           for i, a in enumerate(ARCHS)]
    env = _env()  # XLA on one thread a child: the ranks share the cores
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false")
    _run_children(port + ref, env)
    want = {}
    for i in range(len(ARCHS)):
        with open(tmp / f"jax{i}.pkl", "rb") as f:
            want.update(pickle.load(f))
    got = []
    for r in range(4):
        with open(out.format(r), "rb") as f:
            got.append(pickle.load(f))
    return want, got, tmp / "ckpt"


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_jax_spmd(runs, arch, shape, compress):
    """Two steps at (data, model) against JAX's: losses within 1e-6,
    params, moments and residual within 2e-5 a leaf, the ranks' whole
    tensors bit-equal; the plain step's state is DTensors, the compressed
    step's plain tensors (whole parameters on every model rank)."""
    want, got, _ = runs
    run = (arch, shape, compress)
    w = want[run]
    ranks = [g[run] for g in got if run in g]
    assert len(ranks) == shape[0] * shape[1]
    for g in ranks:
        assert g["dtensors"] is (not compress)
        for l, jl in zip(g["losses"], w["losses"]):
            assert abs(l - jl) <= REL * abs(jl), (l, jl)
    jflat = JCK._flatten({f: getattr(w["final"], f) for f in
                          ("params", "opt", "residual")})
    tflat = CK._flatten({f: getattr(ranks[0]["state"], f) for f in
                         ("params", "opt", "residual")})
    assert list(jflat) == list(tflat)
    bad = {k: _rel(tflat[k].numpy(), jflat[k]) for k in jflat
           if not _rel(tflat[k].numpy(), jflat[k]) <= STATE_REL}
    assert not bad, bad
    for other in ranks[1:]:
        for a, b in zip(tree_leaves(ranks[0]["state"]),
                        tree_leaves(other["state"])):
            assert torch.equal(a, b)


def test_tp_checkpoint_restores_at_one_device_and_in_jax(runs):
    """The (2, 2) plain qwen3 checkpoint, written by rank 0 from the
    DTensors' whole tensors in JAX's layout: restored at (1, 1) into a
    plain template it is the run's final state bit for bit, and JAX's
    `checkpoint.restore` reads it to the same arrays."""
    _, got, ckpt = runs
    run = ("qwen3-0.6b", (2, 2), False)
    final = got[0][run]["state"]
    template = convert.from_numpy(_np(_init("qwen3-0.6b", False)), "cpu")
    back = CK.restore(template, ckpt, 2)
    for a, b in zip(tree_leaves(back), tree_leaves(final)):
        assert torch.equal(a, b)
    jback = JCK.restore(_init("qwen3-0.6b", False)._replace(rng=None),
                        ckpt, 2)
    jflat = JCK._flatten({f: getattr(jback, f) for f in ("params", "opt")})
    tflat = CK._flatten({f: getattr(final, f) for f in ("params", "opt")})
    for k in jflat:
        np.testing.assert_array_equal(np.asarray(jflat[k]),
                                      tflat[k].numpy())


TORCHRUN_CHECK = textwrap.dedent('''
    import sys
    import torch
    from repro_torch.core.qtensor import tree_leaves
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as S
    from repro_torch.launch import train as LT
    from repro_torch.train import checkpoint as CK
    ckpt, argv = sys.argv[1], sys.argv[2:]
    rank = M.rank()
    state = LT.main(argv + ["--ckpt-dir", ckpt])
    dt = isinstance(tree_leaves(state.params)[0],
                    torch.distributed.tensor.DTensor)
    print(f"rank {rank} dtensors: {dt}", file=sys.stderr)
''')


def test_torchrun_mesh_model_2_trains(tmp_path):
    """`torchrun --nproc-per-node 4` of the launcher with --mesh-model 2
    (--reduced, the CPU, 3 steps): JAX's banner for a (2, 2) mesh, finite
    losses, the state DTensors on every rank, and rank 0's checkpoint."""
    script = tmp_path / "check.py"
    script.write_text(TORCHRUN_CHECK)
    argv = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
            "--mesh-model", "2", "--steps", "3", "--batch", "4", "--seq",
            "16", "--log-every", "1"]
    (out, err), = _run_children([[
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc-per-node", "4", str(script), str(tmp_path / "ckpt"),
        *argv]], _env(), cwd=tmp_path)
    assert "mesh: {'data': 2, 'model': 2}, per-replica batch 2, dropped 0 " \
           "devices" in out, out
    losses = [float(l.split()[3]) for l in out.splitlines()
              if l.startswith("step ")]
    assert len(losses) == 3 and np.isfinite(losses).all(), out
    for r in range(4):
        assert f"rank {r} dtensors: True" in err, err
    assert CK.latest_step(tmp_path / "ckpt") == 3
