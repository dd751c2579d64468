"""The port's examples (`examples/torch_*.py`) on the CPU at tiny sizes,
each in a child process with its own timeout, all started at once: each
exits 0 with `--device cpu` and raises without it where there is no
card; the packed serving example's self-check passes; the quickstart's
packed product is within 1e-5 of the dequantized one and its bytes are
JAX's for the same shape; a checkpoint written by JAX's
`examples/train_char_lm.py` is resumed by the port's, and the port's
evaluation of its weights is JAX's to 1e-5 in BPC."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EX = ROOT / "examples"
TIMEOUT = 120
HIDDEN, STEPS, BATCH, SEQ = 32, 3, 4, 16
CHAR_LM = ["--hidden", str(HIDDEN), "--steps", str(STEPS), "--batch",
           str(BATCH), "--seq", str(SEQ)]


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="2", **extra)
    return env


def _start(argv, **env):
    return subprocess.Popen([sys.executable, *map(str, argv)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env(**env), cwd=ROOT)


def _wait(p):
    try:
        so, se = p.communicate(timeout=TIMEOUT)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    return {"rc": p.returncode, "out": so, "err": se}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: {'rc', 'out', 'err'}} of every example run, and the paths."""
    tmp = tmp_path_factory.mktemp("examples")
    data = tmp / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    (data / "a.md").write_bytes(bytes(rng.integers(32, 127, 6000).tolist()))
    (data / "b.py").write_bytes(bytes(rng.integers(32, 100, 4000).tolist()))
    jax_ck, port_ck = tmp / "jax_ckpt", tmp / "port_ckpt"
    cpu = ["--device", "cpu"]
    procs = {
        "jax_char_lm": _start([EX / "train_char_lm.py", *CHAR_LM, "--data",
                               data, "--ckpt-dir", jax_ck],
                              JAX_PLATFORMS="cpu"),
        "quickstart": _start([EX / "torch_quickstart.py", *cpu]),
        "serve_lstm": _start([EX / "torch_serve_lstm.py", *cpu, "--steps",
                              str(STEPS), "--hidden", str(HIDDEN), "--batch",
                              str(BATCH), "--seq", str(SEQ), "--gen", "8"]),
        "serve_generate": _start([EX / "torch_serve_generate.py", *cpu,
                                  "--arch", "qwen3-0.6b", "--reduced",
                                  "--quant", "ternary", "--prompt-len", "8",
                                  "--gen", "4", "--batch", "2"]),
        "multipod_dryrun": _start([EX / "torch_multipod_dryrun.py",
                                   "whisper-base", "decode_32k", *cpu,
                                   "--out", tmp / "dryrun"]),
        "no_device": _start([EX / "torch_quickstart.py"]),
    }
    out = {}
    try:
        out["jax_char_lm"] = _wait(procs["jax_char_lm"])
        shutil.copytree(jax_ck, port_ck)  # the port re-saves its last step
        procs["train_char_lm"] = _start([EX / "torch_train_char_lm.py", *cpu,
                                         *CHAR_LM, "--data", data,
                                         "--ckpt-dir", port_ck])
        for k, p in procs.items():
            if k not in out:
                out[k] = _wait(p)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out, {"data": data, "jax_ckpt": jax_ck, "dryrun": tmp / "dryrun"}


@pytest.mark.parametrize("name", ["quickstart", "serve_lstm", "serve_generate",
                                  "multipod_dryrun", "train_char_lm"])
def test_example_exits_0_on_the_cpu(runs, name):
    got = runs[0][name]
    assert got["rc"] == 0, got["err"][-3000:]


def test_no_example_imports_jax_or_the_reference():
    pat = re.compile(r"^\s*(import|from) (jax|repro)\b", re.M)
    for f in EX.glob("torch_*.py"):
        assert not pat.search(f.read_text()), f


def test_without_device_it_raises_when_there_is_no_card(runs):
    got = runs[0]["no_device"]
    if torch.cuda.is_available():
        assert got["rc"] == 0, got["err"][-3000:]
        return
    assert got["rc"] != 0
    assert "no CUDA device is available" in got["err"]
    assert "step" not in got["out"]


def test_serve_lstm_parity_check_passes(runs):
    out = runs[0]["serve_lstm"]["out"]
    assert "stateful prefill/decode matches the full-sequence forward ✓" in out
    assert "exported 2 packed weights" in out


def test_quickstart_packed_product_and_bytes_are_jax_s(runs):
    """The packed product within 1e-5 of x @ the dequantized weight; the
    packed and fp32 bytes printed as JAX's QTensor gives them for the
    trained `wh` of the same shape."""
    import jax
    from repro.core import bnlstm as JBL
    from repro.core import quantize as JQ
    from repro.core.qtensor import QTensor
    from repro.core.quantize import QuantSpec
    from repro.data.synth import markov_bytes
    from repro.data.text import ByteCorpus

    out = runs[0]["quickstart"]["out"]
    err = float(re.search(r"max err vs reference: (\S+)", out).group(1))
    assert err < 1e-5
    corpus = ByteCorpus.from_bytes(bytes(bytearray(
        np.asarray(markov_bytes(50_000, vocab=32, seed=0)) % 256)))
    cfg = JBL.RNNConfig(vocab=corpus.vocab, d_hidden=96,
                        quant=QuantSpec(mode="ternary", norm="batch"))
    wh = JBL.rnn_lm_init(jax.random.PRNGKey(0), cfg)["params"]["layers"][0][
        "wh"]
    qt = QTensor.from_master(wh, "ternary", JQ.glorot_alpha(*wh.shape))
    want = (f"packed weights: {qt.nbytes / 1e3:.1f} KB "
            f"(fp32 would be {wh.size * 4 / 1e3:.1f} KB — "
            f"{wh.size * 4 / qt.nbytes:.0f}x smaller)")
    assert want in out, (want, out)


def test_port_resumes_a_jax_checkpoint_and_evaluates_it_as_jax(runs):
    """JAX's example writes step 3; the port's resumes from it, and the
    port's `make_rnn_eval` of the restored weights on the first
    validation batch is JAX's BPC to 1e-5."""
    import jax
    import jax.numpy as jnp
    from repro.core import bnlstm as JBL
    from repro.core.quantize import QuantSpec as JQuant
    from repro.data.text import ByteCorpus as JCorpus
    from repro.train import checkpoint as JCK
    from repro.train.optimizer import OptConfig as JOpt
    from repro.train.train_step import make_rnn_eval as jax_eval
    from repro.train.train_step import train_state_init as jax_init

    from repro_torch.core import bnlstm as BL
    from repro_torch.core.quantize import QuantSpec
    from repro_torch.data.loader import to_device
    from repro_torch.data.text import ByteCorpus
    from repro_torch.train import checkpoint as CK
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import make_rnn_eval, train_state_init

    got, paths = runs
    assert got["jax_char_lm"]["rc"] == 0, got["jax_char_lm"]["err"][-3000:]
    assert f"resumed from step {STEPS}" in got["train_char_lm"]["out"]
    data, ck = paths["data"], paths["jax_ckpt"]

    jc = JCorpus.from_dir(data)
    jcfg = JBL.RNNConfig(vocab=jc.vocab, d_hidden=HIDDEN,
                         quant=JQuant(mode="ternary", norm="batch"))
    jvar = JBL.rnn_lm_init(jax.random.PRNGKey(0), jcfg)
    jst = jax_init(jvar["params"], JOpt(kind="adamw", lr=2e-3),
                   jax.random.PRNGKey(1), bn_state=jvar["state"])
    jst = JCK.restore(jst, ck, STEPS)
    vb = {k: jnp.asarray(v) for k, v in
          jc.batch("valid", 0, BATCH, SEQ).items()}
    want = float(jax_eval(jcfg)(jst, vb)["bpc"])

    corpus = ByteCorpus.from_dir(data)
    assert corpus.vocab == jc.vocab
    cfg = BL.RNNConfig(vocab=corpus.vocab, d_hidden=HIDDEN,
                       quant=QuantSpec(mode="ternary", norm="batch"))
    var = BL.rnn_lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    st = train_state_init(var["params"], OptConfig(kind="adamw", lr=2e-3), 1,
                          bn_state=var["state"])
    st = CK.restore(st, ck, STEPS)
    batch = to_device(corpus.batch("valid", 0, BATCH, SEQ),
                      torch.device("cpu"))
    bpc = float(make_rnn_eval(cfg)(st, batch)["bpc"])
    print(f"eval bpc of JAX's step {STEPS}: JAX {want:.7f} port {bpc:.7f}")
    assert abs(bpc - want) <= 1e-5


def test_multipod_dryrun_writes_its_cell_where_asked(runs):
    got, paths = runs
    cell = json.loads((paths["dryrun"] /
                       "whisper-base__decode_32k__multi.json").read_text())
    assert cell["status"] == "ok" and cell["n_chips"] == 512
    assert cell["mesh"] == "multi"
    assert '"n_chips": 512' in got["multipod_dryrun"]["out"]
