"""The port's data-parallel training against the JAX package on the CPU:
elastic mesh planning (`train/elastic.py`), mesh construction
(`launch/mesh.py`), the compressed-DP steps of both families, the pool's
uncompressed step across ranks, the residual in checkpoints and
`convert`, and the launcher under `torchrun`.

JAX runs one controller over a mesh of devices; the port one process a
rank over gloo.  A port step at data = 1 runs in this process over a group
of one rank; at data = 2 each rank is a child process (a file store in the
test's directory, so no port is taken) fed its block of the global batch
and its replica's draws, and JAX runs in a child process of its own under
`XLA_FLAGS=--xla_force_host_platform_device_count=2`.  Every child has a
timeout of its own, so a hung rendezvous fails one test.

Randomness is JAX's, injected: the model noise from `k_model =
split(sub)[0]` and replica r's compression draws from `fold_in(split(sub)
[1], r)`, one split a leaf in flatten order, where `sub =
split(state.rng)[1]` (`train_step._dp_step_keys`, `compress.compress_tree`).

Tolerances: the loss within 1e-6 relative; params, optimizer moments,
BN statistics and residual within 2e-5 relative L2 a leaf.  The
compressed gradient is 0 or +-max|g| an element, so the packages differ
only by the fp32 sums the backward runs in other orders (eager against
XLA, as the uncompressed steps' 3.9e-6 in tests/test_torch_train.py),
which reach max|g|, a BN statistic and most of all the residual, g - t,
where g and t nearly cancel: measured worst at data = 1, 8.7e-6 (the RNN's
residual), 5.5e-6 (its Adam v), 1.5e-6 (params), 1.1e-6 (BN means); the
pool's 1.2e-6.  A draw that fell between the two sides' p would flip an
element; none does in these runs.  The pool's world-2 step against its
world-1 step: 1e-6 relative, the same global-batch mean in two summation
orders.  Ranks are held bit-equal to one another.
"""
import dataclasses
import itertools
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as j_get_config
from repro.core import bnlstm as JBL
from repro.core import quantize as JQ
from repro.launch import mesh as JM
from repro.models import transformer as JT
from repro.runtime import use_mesh
from repro.train import checkpoint as JCK
from repro.train import elastic as JEL
from repro.train import optimizer as JOPT
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import bnlstm as BL
from repro_torch.core import quantize as Q
from repro_torch.core.qtensor import tree_leaves
from repro_torch.data import loader as LD
from repro_torch.launch import mesh as M
from repro_torch.train import checkpoint as CK
from repro_torch.train import elastic as EL
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
CHILD_TIMEOUT = 180
REL = 1e-6        # losses; the pool across world sizes
STATE_REL = 2e-5  # a state leaf against JAX's (the module docstring)
OPT_KW = dict(lr=1e-3, clip_norm=1.0, warmup_steps=20)  # the launcher's
SGD_KW = dict(kind="sgd", lr=1e-2, momentum=0.9, clip_norm=1.0)
RNN = dict(vocab=23, d_hidden=24, n_layers=2, cell="lstm")
T_RNN, T_POOL = 10, 16


@pytest.fixture
def group():
    """Whatever process group a test makes is gone after it."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(TESTS)]
        + [p for p in [env.get("PYTHONPATH")] if p])
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_children(cmds: list, env: dict, cwd=None) -> list:
    """Start every command at once and wait for each within the timeout;
    on a timeout or a failure kill them all and fail.  Returns their
    (stdout, stderr)."""
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


def _assert_state(jstate, tstate, rel=STATE_REL):
    """params, opt, bn_state and residual, leaf for leaf by the
    checkpoints' dotted names, within `rel` relative L2."""
    jflat = JCK._flatten({f: getattr(jstate, f) for f in
                          ("params", "opt", "bn_state", "residual")})
    tflat = CK._flatten({f: getattr(tstate, f) for f in
                         ("params", "opt", "bn_state", "residual")})
    assert list(jflat) == list(tflat)
    worst = {k: _rel(tflat[k].detach().numpy(), jflat[k]) for k in jflat}
    bad = {k: v for k, v in worst.items() if not v <= rel}
    assert not bad, bad


# --- elastic planning and meshes ---------------------------------------------


def _plan_or_error(mod, *a, **kw):
    try:
        return dataclasses.astuple(mod.best_mesh_shape(*a, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("want_model", [1, 2, 3, 4, 16])
def test_best_mesh_shape_equals_jax(pods, want_model):
    seen_error = 0
    for n, batch in itertools.product(
            [1, 2, 3, 4, 5, 6, 7, 8, 11, 12, 16, 31, 32, 64, 248, 256, 512],
            [1, 2, 3, 4, 8, 12, 17, 256]):
        kw = dict(want_model=want_model, global_batch=batch, pods=pods)
        want = _plan_or_error(JEL, n, **kw)
        assert _plan_or_error(EL, n, **kw) == want, (n, kw)
        seen_error += want[0] == "ValueError"
    assert pods == 1 or seen_error  # the grid reaches the raising case


def test_best_mesh_shape_jax_cases():
    """JAX's own cases (tests/test_train.py)."""
    plan = EL.best_mesh_shape(248, want_model=16, global_batch=256)
    assert plan.shape == (15, 16) and plan.per_replica_batch == 17
    plan = EL.best_mesh_shape(512, want_model=16, global_batch=256, pods=2)
    assert plan.shape == (2, 16, 16) and plan.axes == ("pod", "data",
                                                       "model")


@pytest.mark.parametrize("spec", ["data=4,model=2", "model=2", "", " data=3 ",
                                  "pod=2", "data:4", "data=0", "data=x"])
def test_parse_mesh_spec_as_jax(spec):
    def run(f):
        try:
            return f(spec)
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(M.parse_mesh_spec) == run(JM.parse_mesh_spec)


def test_make_host_mesh_and_its_errors_as_jax(group):
    n = len(jax.devices())
    assert n == 1 and M.world_size() == 1
    for model in (3, 0):
        with pytest.raises(ValueError) as want:
            JM.make_host_mesh(model=model)
        with pytest.raises(ValueError) as got:
            M.make_host_mesh(model=model, device="cpu")
        assert str(got.value) == str(want.value)
    mesh = M.make_host_mesh(device="cpu")
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == dict(
        JM.make_host_mesh().shape)
    assert M.data_index(mesh) == (0, 1)
    with pytest.raises(RuntimeError, match="need 256 devices"):
        M.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        M.make_serve_mesh("data=2", device="cpu")
    plan = EL.best_mesh_shape(1, want_model=2, global_batch=8)
    assert plan.shape == (1, 1)
    mesh = EL.make_mesh_from_plan(plan, "cpu")
    assert mesh.mesh_dim_names == ("data", "model")


def test_data_block_is_the_rank_block(group):
    mesh = M.make_host_mesh(device="cpu")
    b = {"tokens": np.arange(12).reshape(6, 2)}
    np.testing.assert_array_equal(LD.data_block(b, mesh)["tokens"],
                                  b["tokens"])

    class Two:  # replica 1 of 2: what NamedSharding(P('data')) gives it
        mesh_dim_names = ("data",)
        shape = (2,)

        def get_coordinate(self):
            return (1,)

        def size(self, dim):
            return 2
    np.testing.assert_array_equal(LD.data_block(b, Two())["tokens"],
                                  b["tokens"][3:])
    with pytest.raises(ValueError, match="does not divide"):
        LD.data_block({"tokens": np.zeros((5, 2))}, Two())


# --- JAX's compressed steps and their draws ----------------------------------


def _rnn_cfgs():
    q = dict(mode="ternary", norm="batch")
    return (JBL.RNNConfig(quant=JQ.QuantSpec(**q), **RNN),
            BL.RNNConfig(quant=Q.QuantSpec(**q), **RNN))


def _pool_cfgs():
    return (j_get_config("qwen3-0.6b").reduced(),
            get_config("qwen3-0.6b").reduced())


def _batch(kind: str, step: int, B: int) -> dict:
    rng = np.random.default_rng(40 + step)
    vocab = RNN["vocab"] if kind == "rnn" else _pool_cfgs()[0].vocab
    T = T_RNN if kind == "rnn" else T_POOL
    toks = rng.integers(0, vocab, size=(B, T + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _init(kind: str, compress: bool = True, opt_kw=OPT_KW):
    """The JAX TrainState both packages start from."""
    jopt = JOPT.OptConfig(**opt_kw)
    if kind == "rnn":
        var = JBL.rnn_lm_init(jax.random.PRNGKey(3), _rnn_cfgs()[0])
        return JTS.train_state_init(var["params"], jopt,
                                    jax.random.PRNGKey(4),
                                    bn_state=var["state"], compress=compress)
    params = JT.model_init(jax.random.PRNGKey(0), _pool_cfgs()[0])
    return JTS.train_state_init(params, jopt, jax.random.PRNGKey(7),
                                compress=compress)


def _model_noise(kind: str, key, params):
    """The noise JAX's training forward draws from `key`, in the port's
    form: (ux, uh) a layer (the RNN), {path: u} (the pool)."""
    if kind == "rnn":
        out = []
        for l, lp in enumerate(params["layers"]):
            kx, kh = jax.random.split(jax.random.fold_in(key, l))
            out.append(tuple(torch.from_numpy(np.array(jax.random.uniform(
                k, lp[w].shape, lp[w].dtype))) for k, w in
                ((kx, "wx"), (kh, "wh"))))
        return out
    import zlib
    out, pol = {}, _pool_cfgs()[0].quant.policy()

    def f(path, leaf):
        if pol.matches(path, leaf):
            name = JQ.path_str(path)
            k = jax.random.fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)
            out[name] = torch.from_numpy(np.array(
                jax.random.uniform(k, leaf.shape, leaf.dtype)))
        return leaf
    jax.tree_util.tree_map_with_path(f, params)
    return out


def jax_compressed_run(kind: str, n_dev: int, steps: int = 2) -> dict:
    """`steps` of JAX's compressed step on a `n_dev`-device data mesh
    (jitted, as the launcher runs it): each step's global batch, model
    noise and every replica's compression draws, losses, and the final
    state, as numpy and torch tensors."""
    assert len(jax.devices()) >= n_dev
    mesh = jax.make_mesh((n_dev,), ("data",))
    jst = _init(kind)
    jopt = JOPT.OptConfig(**OPT_KW)
    make = JTS.make_rnn_train_step if kind == "rnn" else JTS.make_train_step
    cfg = _rnn_cfgs()[0] if kind == "rnn" else _pool_cfgs()[0]
    step = jax.jit(make(cfg, jopt, mesh=mesh, compress_grads=True))
    rec = []
    with use_mesh(mesh):
        for s in range(steps):
            batch = _batch(kind, s, 4 * n_dev)
            sub = jax.random.split(jst.rng)[1]
            k_model, k_comp = jax.random.split(sub)
            leaves = jax.tree.leaves(jst.params)
            comp = []
            for r in range(n_dev):
                keys = jax.random.split(jax.random.fold_in(k_comp, r),
                                        len(leaves))
                comp.append([torch.from_numpy(np.array(jax.random.uniform(
                    k, l.shape, jnp.float32))) for k, l in zip(keys, leaves)])
            noise = _model_noise(kind, k_model, jst.params)
            jst, m = step(jst, {k: jnp.asarray(v) for k, v in batch.items()})
            rec.append({"batch": batch, "noise": noise, "comp": comp,
                        "loss": float(m["loss"])})
    return {"steps": rec, "final": _np(jst)}


def _port_steps(kind, tcfg, topt, state, rec, mesh, rank=0):
    make = TS.make_rnn_train_step if kind == "rnn" else TS.make_train_step
    step = make(tcfg, topt, mesh=mesh, compress_grads=True)
    losses = []
    for s in rec:
        batch = {k: torch.from_numpy(v) for k, v in
                 LD.data_block(s["batch"], mesh).items()}
        state, m = step(state, batch, noise=s["noise"],
                        comp_noise=s["comp"][rank])
        losses.append(float(m["loss"]))
    return state, losses


@pytest.mark.parametrize("kind", ["rnn", "pool"])
def test_compressed_step_at_data_1_matches_jax(kind, group):
    """Two compressed steps over a data mesh of one rank against JAX's on
    `jax.make_mesh((1,), ("data",))`."""
    want = jax_compressed_run(kind, 1)
    tcfg = _rnn_cfgs()[1] if kind == "rnn" else _pool_cfgs()[1]
    state = convert.from_numpy(_np(_init(kind)), "cpu")
    assert state.residual is not None
    mesh = M.make_host_mesh(device="cpu")
    state, losses = _port_steps(kind, tcfg, OPT.OptConfig(**OPT_KW), state,
                                want["steps"], mesh)
    for got, s in zip(losses, want["steps"]):
        assert abs(got - s["loss"]) <= REL * abs(s["loss"])
    _assert_state(want["final"], state)
    assert sum(float(x.abs().sum()) for x in tree_leaves(state.residual)) > 0


DP_WORKER = textwrap.dedent('''
    import pickle, sys
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, store, job, out = sys.argv[1:]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world)
    from repro_torch.launch import mesh as M
    import test_torch_dp as D
    with open(job, "rb") as f:
        job = pickle.load(f)
    mesh = M.make_host_mesh(device="cpu")
    assert M.data_index(mesh) == (rank, world)
    state, losses = job["run"](mesh, rank, **job["kw"])
    with open(out.format(rank), "wb") as f:
        pickle.dump({"state": state, "losses": losses}, f)
    dist.destroy_process_group()
''')


def _ranks(tmp_path: Path, world: int, run, **kw) -> list:
    """`run(mesh, rank, **kw)` on `world` gloo ranks, each a child
    process: [(state, losses)] by rank."""
    job = tmp_path / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump({"run": run, "kw": kw}, f)
    out = str(tmp_path / "out{}.pkl")
    store = tmp_path / "store"
    _run_children([[sys.executable, "-c", DP_WORKER, str(r), str(world),
                    str(store), str(job), out] for r in range(world)],
                  _env())
    got = []
    for r in range(world):
        with open(out.format(r), "rb") as f:
            d = pickle.load(f)
        got.append((d["state"], d["losses"]))
    return got


def rnn_rank_steps(mesh, rank, state, rec):
    return _port_steps("rnn", _rnn_cfgs()[1], OPT.OptConfig(**OPT_KW),
                       state, rec, mesh, rank)


def _assert_ranks_bit_equal(states):
    for other in states[1:]:
        for a, b in zip(tree_leaves(states[0]), tree_leaves(other)):
            assert torch.equal(a, b)


def test_compressed_rnn_step_at_data_2_matches_jax(tmp_path):
    """JAX on two forced host devices (a child process) against two gloo
    ranks, each fed its block of the batch and its replica's draws: every
    rank holds JAX's state after two steps, bit-equal across ranks."""
    code = ("import pickle, sys, test_torch_dp as D; "
            "pickle.dump(D.jax_compressed_run('rnn', 2), "
            "open(sys.argv[1], 'wb'))")
    env = _env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    _run_children([[sys.executable, "-c", code, str(tmp_path / "jax.pkl")]],
                  env)
    with open(tmp_path / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    state = convert.from_numpy(_np(_init("rnn")), "cpu")
    got = _ranks(tmp_path, 2, rnn_rank_steps, state=state,
                 rec=want["steps"])
    _assert_ranks_bit_equal([s for s, _ in got])
    for (state, losses) in got:
        for l, s in zip(losses, want["steps"]):
            assert abs(l - s["loss"]) <= REL * abs(s["loss"])
        _assert_state(want["final"], state)


def pool_rank_steps(mesh, rank, state, batches):
    tcfg = _pool_cfgs()[1]
    step = TS.make_train_step(tcfg, OPT.OptConfig(**SGD_KW), mesh=mesh)
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in
                                LD.data_block(b, mesh).items()})
        losses.append(float(m["loss"]))
    return state, losses


def test_pool_step_at_world_2_equals_world_1(tmp_path):
    """The pool's uncompressed step over two gloo ranks (each its half of
    the global batch, gradients averaged) against one process on the whole
    batch, two SGD steps: JAX's SPMD step computes the global-batch
    gradient either way."""
    state = convert.from_numpy(_np(_init("pool", compress=False,
                                         opt_kw=SGD_KW)), "cpu")
    batches = [_batch("pool", s, 4) for s in range(2)]
    got = _ranks(tmp_path, 2, pool_rank_steps, state=state, batches=batches)
    _assert_ranks_bit_equal([s for s, _ in got])
    step = TS.make_train_step(_pool_cfgs()[1], OPT.OptConfig(**SGD_KW))
    for b, l in zip(batches, got[0][1]):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert abs(l - float(m["loss"])) <= REL * abs(float(m["loss"]))
    for a, b in zip(tree_leaves(got[0][0]), tree_leaves(state)):
        assert _rel(a.numpy(), b.numpy()) <= REL


# --- the residual in checkpoints ---------------------------------------------


def test_residual_checkpoints_read_both_ways(tmp_path, group):
    """A JAX state with a residual (two compressed steps), saved by JAX,
    restores into the port's template; the port's, saved by the port,
    restores into JAX's; `residual.*` keys in both."""
    mesh = jax.make_mesh((1,), ("data",))
    cfg = _rnn_cfgs()[0]
    step = jax.jit(JTS.make_rnn_train_step(cfg, JOPT.OptConfig(**OPT_KW),
                                           mesh=mesh, compress_grads=True))
    jst = _init("rnn")
    with use_mesh(mesh):
        for s in range(2):
            jst, _ = step(jst, {k: jnp.asarray(v) for k, v in
                                _batch("rnn", s, 4).items()})
    JCK.save(jst, tmp_path / "jax", 2)
    template = convert.from_numpy(_np(_init("rnn")), "cpu")
    port = CK.restore(template, tmp_path / "jax", 2)
    _assert_state(jst, port, rel=0.0)
    assert any(k.startswith("residual.") for k in CK._flatten(port))

    tstep = TS.make_rnn_train_step(_rnn_cfgs()[1], OPT.OptConfig(**OPT_KW),
                                   mesh=M.make_host_mesh(device="cpu"),
                                   compress_grads=True)
    port, _ = tstep(port, {k: torch.from_numpy(v) for k, v in
                           _batch("rnn", 2, 4).items()})
    CK.save(port, tmp_path / "port", 3)
    back = JCK.restore(_init("rnn")._replace(rng=None), tmp_path / "port", 3)
    _assert_state(back, port, rel=0.0)


# --- the launcher under torchrun ---------------------------------------------


TORCHRUN_CHECK = textwrap.dedent('''
    import sys
    import torch
    from repro_torch.core.qtensor import tree_leaves
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as LT
    from repro_torch.train import checkpoint as CK
    ckpt, argv = sys.argv[1], sys.argv[2:]
    rank = M.rank()
    state = LT.main(argv + ["--ckpt-dir", ckpt])
    back = CK.restore(state, ckpt, CK.latest_step(ckpt))
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(state),
                                                 tree_leaves(back)))
    print(f"rank {rank} final state == checkpoint: {same}", file=sys.stderr)
''')


@pytest.mark.parametrize("arch", ["rnn-paper", "qwen3-0.6b"])
def test_torchrun_two_ranks_compressed(arch, tmp_path):
    """`torchrun --nproc-per-node 2` of the launcher with --compress-grads
    (--reduced, the CPU, 4 steps): rank 0 logs finite losses and the mesh,
    and each rank's final state equals the checkpoint rank 0 wrote."""
    script = tmp_path / "check.py"
    script.write_text(TORCHRUN_CHECK)
    argv = ["--arch", arch, "--reduced", "--device", "cpu",
            "--compress-grads", "--steps", "4", "--batch", "4", "--seq", "16",
            "--log-every", "1", "--eval-every", "2", "--eval-batches", "1"]
    (out, err), = _run_children([[
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc-per-node", "2", str(script), str(tmp_path / "ckpt"),
        *argv]], _env(), cwd=tmp_path)
    losses = [float(l.split()[3]) for l in out.splitlines()
              if l.startswith("step ")]
    assert len(losses) == 4 and np.isfinite(losses).all(), out
    assert "grad compression: 2 data replica(s)" in out
    if arch != "rnn-paper":
        assert "mesh: {'data': 2, 'model': 1}" in out
    for r in (0, 1):
        assert f"rank {r} final state == checkpoint: True" in err, err
    assert CK.latest_step(tmp_path / "ckpt") == 4
    assert any(p.name.startswith("residual.") for p in
               (tmp_path / "ckpt" / "step_00000004" / CK.SHARD).iterdir())
