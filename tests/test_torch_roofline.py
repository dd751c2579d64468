"""The port's roofline arithmetic (`repro_torch/launch/roofline.py`)
against the JAX package's on the CPU.

`param_counts`, `analytic_hbm_bytes` and `model_flops` are pure
arithmetic over a config: they must equal JAX's to the last bit for every
arch, shape and packed-weight width.  The terms are the H100's peaks'
quotients, and the wire bytes JAX's ring factors, applied to the records
the dry-run's counter collects where JAX parses HLO text.
"""
import pytest

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.launch import roofline as JR
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import roofline as R


def test_arch_and_shape_sets_are_jax_s():
    assert tuple(ARCH_IDS) == tuple(J_ARCH_IDS)
    assert tuple(SHAPES) == tuple(J_SHAPES)


@pytest.mark.parametrize("weight_bits", [16, 2, 1])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_counts_equal_jax(arch, weight_bits):
    """Bit for bit, at both production meshes' rank counts."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert R.param_counts(cfg) == JR.param_counts(jcfg)
    for name in SHAPES:
        for n in (256, 512):
            assert R.model_flops(cfg, SHAPES[name], n) == JR.model_flops(
                jcfg, J_SHAPES[name], n)
            assert R.analytic_hbm_bytes(
                cfg, SHAPES[name], n, weight_bits=weight_bits) == \
                JR.analytic_hbm_bytes(jcfg, J_SHAPES[name], n,
                                      weight_bits=weight_bits)


def test_terms_are_the_h100_quotients():
    rf = R.Roofline(flops=3.0e12, hbm_bytes=5.0e11, wire_bytes=2.0e9,
                    collectives={"all-gather": 2.0e9}, model_flops=1.5e12,
                    hbm_bytes_model=4.0e10)
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert rf.t_compute == 3.0e12 / 989e12
    assert rf.t_memory == 4.0e10 / 3.35e12          # the analytic bytes
    assert rf.t_memory_xla == 5.0e11 / 3.35e12      # the counted bytes
    assert rf.t_collective == 2.0e9 / 50e9
    assert rf.dominant == "collective"
    assert rf.bound_time == rf.t_collective
    assert rf.useful_flop_ratio == 0.5
    assert rf.roofline_fraction == (1.5e12 / 989e12) / rf.t_collective
    j = rf.to_json()
    assert set(j) == set(JR.Roofline(1.0, 1.0, 0.0, {}, 1.0).to_json())
    assert R.Roofline(1.0, 0.0, 0.0, {}, 0.0,
                      hbm_bytes_model=0.0).t_memory == 0.0


def test_wire_bytes_are_jax_s_on_its_synthetic_hlo():
    """The records of the three lines of JAX's parser test (the `-done`
    half of an async pair issues no record) give its numbers."""
    hlo = """
  %all-reduce.1 = f32[128,1024]{1,0} all-reduce(%dot), replica_groups=[2,4]<=[8]
  %ag = bf16[64,64]{1,0} all-gather(%x), replica_groups=[16,16]<=[256]
  %all-reduce-done.1 = f32[128,1024]{1,0} all-reduce-done(%ar)
"""
    records = [("all-reduce", 128 * 1024 * 4, 4), ("all-gather", 64 * 64 * 2, 16)]
    assert R.collective_wire_bytes(records) == JR.collective_wire_bytes(hlo)


def test_wire_factors_for_every_kind():
    got = R.collective_wire_bytes([
        ("all-reduce", 800.0, 8), ("all-gather", 800.0, 8),
        ("reduce-scatter", 800.0, 8), ("all-to-all", 800.0, 8),
        ("collective-permute", 800.0, 8), ("all-reduce", 800.0, 1)])
    assert got == {"all-reduce": 1400.0, "all-gather": 700.0,
                   "reduce-scatter": 700.0, "all-to-all": 700.0,
                   "collective-permute": 800.0}
    assert R.collective_wire_bytes([("all-gather", 64.0, 1)]) == {}
    with pytest.raises(ValueError, match="unknown collective kind"):
        R.collective_wire_bytes([("broadcast", 8.0, 2)])


def test_build_takes_a_cell_s_counts():
    cfg = get_config("qwen3-0.6b")
    shape = SHAPES["decode_32k"]
    cell = {"flops": 2.0e9, "bytes_accessed": 4.0e9,
            "collectives": {"all-gather": 1.0e8, "all-reduce": 3.0e8}}
    rf = R.build(cell, cfg, shape, 256, weight_bits=2)
    assert rf.wire_bytes == 4.0e8
    assert rf.model_flops == R.model_flops(cfg, shape, 256)
    assert rf.hbm_bytes_model == R.analytic_hbm_bytes(cfg, shape, 256,
                                                      weight_bits=2)
