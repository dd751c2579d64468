"""The port's build and launch plumbing on the CPU: what `chip_smoke.py`
reads from a compiler log, what `build.build_all` hands back for a library
built before, and the GEMV plan against the checks its C entry point makes.
None of these needs a compiler or a card."""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.core import quantize as Q
from repro_torch.kernels import build
from repro_torch.kernels import packed_matmul as PK

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__388b7016_14_packed_gemv_cu_ca7254b218packed_gemv_kernelILi0ELi4ELb1EEEvPKfPKjPfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__388b7016_14_packed_gemv_cu_ca7254b218packed_gemv_kernelILi0ELi4ELb1EEEvPKfPKjPfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 25088 bytes smem, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__9e81d3b4_16_packed_matmul_cu_fdcceb1d20packed_matmul_kernelILi1EEEvPKfPKjPfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__9e81d3b4_16_packed_matmul_cu_fdcceb1d20packed_matmul_kernelILi1EEEvPKfPKjPfiii
    24 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 115 registers, used 1 barriers, 41344 bytes smem, 392 bytes cmem[0]
"""


def test_ptxas_usage_names_every_instance_and_its_spills():
    """Integer and bool template arguments both name the instance, and the
    spill bytes (stores + loads) belong to the function they follow."""
    assert _chip_smoke().ptxas_usage(PTXAS_LOG) == [
        ("packed_gemv_kernel<0,4,1>", 64, 0),
        ("packed_matmul_kernel<1>", 115, 24)]


def test_build_all_gives_a_cached_library_the_log_of_its_build(
        tmp_path, monkeypatch):
    """A library built before is not compiled again, and its compiler log
    still reaches the no-spill check."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    so = build.so_path("packed_gemv")
    so.write_bytes(b"")
    (path, secs, log) = build.build_all(("packed_gemv",))["packed_gemv"]
    assert (path, secs, log) == (so, 0.0, "cached")
    so.with_suffix(".log").write_text(PTXAS_LOG)
    assert build.build_all(("packed_gemv",))["packed_gemv"][2] == PTXAS_LOG


@pytest.mark.parametrize("N", [1, 31, 32, 33, 100, 2600, 4000, 8000, 70000])
@pytest.mark.parametrize("mode,K", [
    ("ternary", 16), ("ternary", 64), ("ternary", 656), ("ternary", 1008),
    ("ternary", 16384), ("binary", 32), ("binary", 64), ("binary", 1024),
    ("binary", 2080)])
def test_gemv_plan_meets_the_launch_checks(mode, K, N):
    """Every plan passes the checks of `packed_gemv_launch`: the instance
    holds bp rows, the cluster is 1..8 and no larger than the code words,
    and the tiles cover N with none left empty."""
    G = Q.pack_group(mode)
    assert K % G == 0
    for bp in range(1, 9):
        plan = PK.gemv_plan(bp, K, N, mode=mode)
        assert plan["rows"] in (1, 2, 4, 8) and plan["rows"] >= bp
        assert 1 <= plan["cluster"] <= PK.MAX_CLUSTER
        assert plan["cluster"] <= K // G
        cols = PK.GEMV_COLS
        assert plan["tiles"] * cols >= N > (plan["tiles"] - 1) * cols
        assert plan["blocks"] == plan["tiles"] * plan["cluster"]
