"""The port's checkpoints, restart and training launcher, on the CPU.

Checkpoints have the JAX package's layout and key names, so each package
restores what the other wrote; a restored state evaluates to the same
validation BPC in both (1e-5: the two evals differ only in fp32 summation
order and libm).  A preempted launcher run exits 43 and, resumed, ends
bit-equal to an uninterrupted run: data and quantization noise are
functions of the step, and the journaled eval curve rebuilds the plateau
schedule.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bnlstm as JBL
from repro.core import quantize as JQ
from repro.data.synth import token_stream
from repro.train import checkpoint as JCK
from repro.train import optimizer as JOPT
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.core import bnlstm as BL
from repro_torch.core import quantize as Q
from repro_torch.core.qtensor import tree_leaves
from repro_torch.launch import train as LT
from repro_torch.train import checkpoint as CK
from repro_torch.train import fault_tolerance as FT
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

torch.set_num_threads(1)
CFG = dict(vocab=24, d_hidden=32, n_layers=1, cell="lstm")


def _jax_state():
    cfg = JBL.RNNConfig(quant=JQ.QuantSpec(mode="ternary"), **CFG)
    var = JBL.rnn_lm_init(jax.random.PRNGKey(0), cfg)
    st = JTS.train_state_init(var["params"], JOPT.OptConfig(lr=1e-3),
                              jax.random.PRNGKey(1), bn_state=var["state"])
    return cfg, st


def _port_state(seed=0):
    cfg = BL.RNNConfig(quant=Q.QuantSpec(mode="ternary"), **CFG)
    var = BL.rnn_lm_init(torch.Generator().manual_seed(seed), cfg,
                         device="cpu")
    st = TS.train_state_init(var["params"], OPT.OptConfig(lr=1e-3), seed + 1,
                             bn_state=var["state"])
    return cfg, st


def _batch(i, to_torch):
    b = token_stream(i, 4, 12, CFG["vocab"])
    if to_torch:
        return {k: torch.from_numpy(v) for k, v in b.items()}
    return {k: jnp.asarray(v) for k, v in b.items()}


def test_leaf_names_are_the_jax_names():
    """44 leaves for one layer, named as JAX's `_flatten` names them; the
    port's `noise_seed` stands where JAX keeps `rng`."""
    _, jst = _jax_state()
    _, tst = _port_state()
    jkeys = list(JCK._flatten(jst))
    tkeys = list(CK._flatten(tst))
    assert len(jkeys) == len(tkeys) == 44
    assert [k if k != "rng" else "noise_seed" for k in jkeys] == tkeys
    assert {"params.layers.0.wx", "opt.step", "opt.m.layers.0.wx",
            "bn_state.layers.0.bn_x.mean"} <= set(tkeys)


def test_jax_checkpoint_restores_into_the_port_with_the_same_bpc(tmp_path):
    jcfg, jst = _jax_state()
    jstep = jax.jit(JTS.make_rnn_train_step(jcfg, JOPT.OptConfig(lr=1e-3)))
    for i in range(2):
        jst, _ = jstep(jst, _batch(i, False))
    JCK.save(jst, tmp_path, 2)
    tcfg, template = _port_state(seed=5)
    tst = CK.restore(template, tmp_path)
    assert int(tst.opt.step) == 2
    assert torch.equal(tst.noise_seed, template.noise_seed)  # rng ignored
    for k, v in JCK._flatten(jst).items():
        if k != "rng":
            np.testing.assert_array_equal(CK._flatten(tst)[k].numpy(),
                                          np.asarray(v), err_msg=k)
    for i in range(3):
        jb = JTS.make_rnn_eval(jcfg)(jst, _batch(100 + i, False))["bpc"]
        tb = TS.make_rnn_eval(tcfg)(tst, _batch(100 + i, True))["bpc"]
        assert float(tb) == pytest.approx(float(jb), abs=1e-5)


def test_port_checkpoint_restores_into_the_jax_template(tmp_path):
    tcfg, tst = _port_state()
    step = TS.make_rnn_train_step(tcfg, OPT.OptConfig(lr=1e-3))
    for i in range(2):
        tst, _ = step(tst, _batch(i, True))
    CK.save(tst, tmp_path, 2)
    jcfg, jtemplate = _jax_state()
    jst = JCK.restore(jtemplate._replace(rng=None), tmp_path)
    jst = jst._replace(rng=jax.random.PRNGKey(3))
    fields = convert.to_numpy(tst)
    for a, b in zip(jax.tree.leaves(jst.params), jax.tree.leaves(
            fields["params"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(jst.opt.step) == 2
    jb = JTS.make_rnn_eval(jcfg)(jst, _batch(50, False))["bpc"]
    tb = TS.make_rnn_eval(tcfg)(tst, _batch(50, True))["bpc"]
    assert float(tb) == pytest.approx(float(jb), abs=1e-5)


def test_saves_are_atomic_and_old_ones_collected(tmp_path):
    _, st = _port_state()
    (tmp_path / "step_00000009.tmp-deadbeef").mkdir()   # a cut-off write
    (tmp_path / "step_00000008").mkdir()                # no manifest
    assert CK.latest_step(tmp_path) is None
    for s in (1, 2, 3, 4):
        CK.save(st, tmp_path, s, keep=2)
    assert CK.latest_step(tmp_path) == 4
    assert not list(tmp_path.glob("*.tmp-*"))
    done = sorted(p.name for p in tmp_path.glob("step_*")
                  if (p / "manifest.json").exists())
    assert done == ["step_00000003", "step_00000004"]
    manifest = json.loads((tmp_path / "step_00000004" / "manifest.json")
                          .read_text())
    assert manifest["step"] == 4 and len(manifest["leaves"]) == 44


def test_async_checkpointer_writes_and_reraises(tmp_path):
    _, st = _port_state()
    ck = CK.AsyncCheckpointer(tmp_path / "ok")
    ck.save_async(st, 7)
    ck.wait()
    back = CK.restore(_port_state(seed=9)[1], tmp_path / "ok", 7)
    for a, b in zip(tree_leaves(back), tree_leaves(st)):
        assert torch.equal(a, b)
    blocker = tmp_path / "file"
    blocker.write_text("")
    bad = CK.AsyncCheckpointer(blocker / "sub")
    bad.save_async(st, 1)
    with pytest.raises(OSError):
        bad.wait()


def test_restore_refuses_missing_and_misshapen_leaves(tmp_path):
    _, st = _port_state()
    CK.save(st, tmp_path, 1)
    (tmp_path / "step_00000001" / "shard_00000" / "opt.step.npy").unlink()
    m = tmp_path / "step_00000001" / "manifest.json"
    man = json.loads(m.read_text())
    del man["leaves"]["opt.step"]
    m.write_text(json.dumps(man))
    with pytest.raises(KeyError, match="opt.step"):
        CK.restore(st, tmp_path)
    CK.save(st, tmp_path, 2)
    wide = st._replace(params={**st.params, "head": {
        **st.params["head"], "bs": torch.zeros(CFG["vocab"] + 1)}})
    with pytest.raises(ValueError, match="params.head.bs"):
        CK.restore(wide, tmp_path, 2)


def test_resume_is_sample_exact(tmp_path):
    """Interrupt at 3 + save/restore == six straight steps, bit for bit:
    the step draws its noise from (noise_seed, step), and the checkpoint
    holds noise_seed."""
    cfg, st0 = _port_state()
    step = TS.make_rnn_train_step(cfg, OPT.OptConfig(lr=1e-3))

    def run(state, s0, s1):
        for i in range(s0, s1):
            state, m = step(state, _batch(i, True))
        return state, float(m["loss"])

    straight, loss_straight = run(st0, 0, 6)
    half, _ = run(_port_state()[1], 0, 3)
    CK.save(half, tmp_path, 3)
    resumed = CK.restore(_port_state(seed=4)[1], tmp_path, 3)
    resumed, loss_resumed = run(resumed, 3, 6)
    assert loss_resumed == loss_straight
    for a, b in zip(tree_leaves(straight), tree_leaves(resumed)):
        assert torch.equal(a, b)


# --- the launcher --------------------------------------------------------------


ARGS = ["--arch", "rnn-paper", "--reduced", "--device", "cpu", "--batch", "4",
        "--seq", "16", "--eval-batches", "1", "--log-every", "1"]


def test_launcher_trains_on_the_cpu(capsys):
    st = LT.main(ARGS + ["--steps", "4", "--eval-every", "2"])
    assert int(st.opt.step) == 4
    out = capsys.readouterr().out
    assert "hidden=64" in out and "device=cpu" in out
    assert out.count("eval  step") == 2 and "done: 4 steps" in out
    losses = [float(l.split()[3]) for l in out.splitlines()
              if l.startswith("step ")]
    assert len(losses) == 4 and np.isfinite(losses).all()


@pytest.mark.parametrize("flag", [
    ["--pipeline", "--quick", "--compress-grads", "--steps", "6"],
    ["--compress-grads", "--steps", "4", "--eval-every", "2"],
    ["--arch", "qwen3-0.6b", "--mesh-model", "2", "--steps", "2"]])
def test_launcher_runs_what_it_refused(flag, tmp_path, capsys):
    """--compress-grads, --pipeline --compress-grads (its legs carry the
    flag) and --mesh-model 2 were refused until compressed DP was ported;
    at one rank each now trains.  The RNN builds its data mesh of one rank
    and carries a residual; the pool trains the plain step with a zero
    residual, and a model axis of 2 on one rank plans (1, 1), as JAX's
    launcher runs on one device."""
    got = LT.main(ARGS + flag + ["--ckpt-dir", str(tmp_path / "ckpt"),
                                 "--results-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert not torch.distributed.is_initialized()  # its group is gone
    if "--pipeline" in flag:
        train = got[0]
        assert "--compress-grads" in LT._child_cmd(
            LT.build_argparser().parse_args(ARGS + flag), tmp_path)
        assert train["resume_bit_exact"] and train["restart_exit_code"] == 43
        assert 0 < train["residual_abs_sum"] < float("inf")
        ckpt = tmp_path / "ckpt" / "straight" / "step_00000006" / CK.SHARD
        assert any(p.name.startswith("residual.") for p in ckpt.iterdir())
    elif "--compress-grads" in flag:
        assert int(got.opt.step) == 4
        assert "grad compression: 1 data replica(s)" in out
        assert sum(float(x.abs().sum()) for x in tree_leaves(got.residual)) > 0
    else:
        assert int(got.opt.step) == 2 and got.residual is None
        assert "mesh:" not in out  # one rank: no plan, as in JAX


@pytest.mark.parametrize("world,model,batch,why", [
    (2, 2, 8, (1, 2)), (8, 4, 8, (2, 4)), (2, 1, 3, "does not divide")])
def test_launcher_refuses_a_model_axis(world, model, batch, why, capsys,
                                       monkeypatch):
    """A mesh plan with a model axis above 1 is built, after JAX's banner
    (tensor parallelism is ported: the plan goes to `make_mesh_from_plan`
    as it is); a global batch the plan's replicas do not divide is still
    refused.  Neither makes a process group here."""
    args = LT.build_argparser().parse_args(
        ["--arch", "qwen3-0.6b", "--mesh-model", str(model), "--batch",
         str(batch)])
    monkeypatch.setattr(LT, "make_mesh_from_plan",
                        lambda plan, device: plan.shape)
    if isinstance(why, str):
        with pytest.raises(SystemExit, match=why):
            LT.train_mesh(args, world, torch.device("cpu"))
    else:
        assert LT.train_mesh(args, world, torch.device("cpu")) == why
    out = capsys.readouterr().out
    assert "per-replica batch" in out
    if not isinstance(why, str):
        assert f"'model': {model}" in out
    assert not torch.distributed.is_initialized()


def test_launcher_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LT.main(["--reduced", "--steps", "1"])


class _PreemptAfter(FT.PreemptionHandler):
    """Preempted when the launcher asks the `n`-th time, after step n-1
    (it asks once a step)."""

    def __init__(self, n):
        super().__init__(signals=())
        self.n = n

    @property
    def preempted(self):
        self.n -= 1
        if self.n == 0:
            self.simulate()
        return super().preempted


def test_preemption_exits_43_and_the_resumed_run_is_bitwise(tmp_path):
    common = ARGS + ["--steps", "6", "--eval-every", "2", "--ckpt-every", "2",
                     "--resume", "auto", "--plateau-factor", "0.5"]
    straight = LT.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    with pytest.raises(SystemExit) as exc:
        LT.main(common + ["--ckpt-dir", str(tmp_path / "b")],
                handler=_PreemptAfter(3))
    assert exc.value.code == FT.RESTART_EXIT_CODE == 43
    assert CK.latest_step(tmp_path / "b") == 3
    resumed = LT.main(common + ["--ckpt-dir", str(tmp_path / "b")])
    for a, b in zip(tree_leaves(straight), tree_leaves(resumed)):
        assert torch.equal(a, b)
    curve = lambda d: (tmp_path / d / "val_curve.jsonl").read_text()
    assert curve("a") == curve("b")
