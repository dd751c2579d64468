"""`python -m repro_torch.launch.train --pipeline --quick --reduced --device
cpu`: train -> real SIGTERM -> exit 43 -> resume, the bit-equal
checkpoints of the interrupted and the uninterrupted legs, the packed
export served through the engine byte for byte like drive_session(B=1),
and the trained accept rate, in well under a minute on the CPU."""
import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch.launch import train as LT

ROOT = Path(__file__).resolve().parents[1]


def test_pipeline_quick_on_the_cpu(tmp_path, capsys):
    jax_result = ROOT / "results" / "benchmarks" / "train_rnn.json"
    before = jax_result.read_bytes() if jax_result.exists() else None
    rows = LT.main(["--pipeline", "--quick", "--reduced", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path / "ckpt"),
                    "--results-dir", str(tmp_path / "results")])
    out = capsys.readouterr().out
    assert "pipeline: resume bit-exact vs uninterrupted: True" in out
    assert "preempted: checkpointing and exiting 43" in out
    assert "byte parity vs drive_session(B=1) over 5 requests" in out
    train, serve, spec = rows
    assert train["steps"] == 60 and train["sigterm_at_step"] == 30
    assert train["resume_bit_exact"] and train["restart_exit_code"] == 43
    assert 30 <= train["resumed_from_step"] < 60
    assert [e["step"] for e in train["val_bpc_curve"]] == [20, 40, 60]
    assert serve["engine_byte_parity"] and serve["packed_mb"] < serve["fp32_mb"]
    assert spec["greedy_equal_plain"] and 0.0 <= spec["accept_rate"] <= 1.0
    # the children left both legs' checkpoints, each ending at step 60
    for leg in ("interrupted", "straight"):
        assert (tmp_path / "ckpt" / leg / "step_00000060").is_dir()
    written = json.loads((tmp_path / "results" / LT.RESULT_NAME).read_text())
    assert written["rows"][0]["resume_bit_exact"] and written["meta"]["quick"]
    assert written["meta"]["device"] == "cpu"
    # the default lands beside, never over, the JAX package's result
    assert LT.RESULT_NAME == "torch_train_rnn.json"
    assert LT.RESULTS == ROOT / "results" / "benchmarks"
    after = jax_result.read_bytes() if jax_result.exists() else None
    assert after == before


def test_pipeline_helpers(tmp_path):
    from repro_torch.train import checkpoint as CK
    args = LT.build_argparser().parse_args(
        ["--pipeline", "--reduced", "--device", "cuda", "--quant", "binary"])
    cmd = LT._child_cmd(args, tmp_path)
    assert cmd[1:3] == ["-m", "repro_torch.launch.train"]
    assert cmd[cmd.index("--device") + 1] == "cuda"
    assert "--reduced" in cmd and "--pipeline" not in cmd
    assert cmd[cmd.index("--resume") + 1] == "auto"
    a = CK.save({"w": np.arange(4, dtype=np.float32)}, tmp_path / "a", 1)
    b = CK.save({"w": np.arange(4, dtype=np.float32)}, tmp_path / "b", 1)
    assert LT._ckpt_bit_equal(a, b)
    c = CK.save({"w": np.arange(4, dtype=np.float32) + 1e-7}, tmp_path / "c", 1)
    assert not LT._ckpt_bit_equal(a, c)
    with pytest.raises(SystemExit, match="expected 0"):
        LT._run_leg(["python", "-c", "raise SystemExit(3)"], "t")
