"""Roofline accounting (femo_tpu_torch/utils/roofline.py) against the JAX
package's femo_tpu/utils/roofline.py: on the same inputs, `roofline`,
`bt_factor_cost` and `bt_sweep_cost` return exactly what the JAX
functions return, across tests/test_roofline.py's cases; `chip_spec` is
None on the CPU and the H100 entry for the H100's device name;
`compiled_cost` counts a matmul's 2 m n k flops and gives no bytes."""

import pytest
import torch

from femo_tpu.utils import roofline as jax_roofline

from femo_tpu_torch.utils import roofline

# tests/test_roofline.py's spec, and the H100 entry
SPECS = [dict(chip="TPU v5e", peak_flops=197e12, hbm_bw=819e9,
              hbm_bytes=16e9),
         dict(roofline.CHIP_SPECS["H100 80GB HBM3"], peak_flops=34e12)]
# tests/test_roofline.py's cases: (time_s, flops, bytes, critical_steps)
CASES = [(1.0, 197e12, 1e9, None), (1.0, 1e9, 819e9, None),
         (10.0, 1e9, 1e9, 7000), (10.0, 1e9, 1e9, None),
         (1.0, None, 1e9, None), (0.0, 1e9, 1e9, None),
         (2.5e-3, 3.1e10, 4.2e8, 147)]


@pytest.mark.parametrize("case", CASES)
def test_roofline_matches_jax(case):
    t, flops, nbytes, steps = case
    for spec in SPECS:
        assert roofline.roofline(t, flops, nbytes, spec, steps) == \
            jax_roofline.roofline(t, flops, nbytes, spec, steps)


@pytest.mark.parametrize("args", [(100, 128), (200, 128), (100, 256),
                                  (100, 128, False), (147, 512, True, 8, 8)])
def test_bt_factor_cost_matches_jax(args):
    assert roofline.bt_factor_cost(*args) == \
        jax_roofline.bt_factor_cost(*args)


@pytest.mark.parametrize("args", [(100, 128), (100, 256), (39, 128, 4),
                                  (289, 512, 1, 8, 1)])
def test_bt_sweep_cost_matches_jax(args):
    assert roofline.bt_sweep_cost(*args) == jax_roofline.bt_sweep_cost(*args)


def test_chip_spec(monkeypatch):
    """None on the CPU and on an unknown card; the H100 entry, its peak
    that of the dtype asked for, for the H100's device name."""
    assert roofline.chip_spec() is None
    assert roofline.chip_spec("cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    spec = roofline.chip_spec("cuda:0", torch.float64)
    assert (spec["chip"], spec["hbm_bw"], spec["hbm_bytes"],
            spec["peak_flops"]) == ("NVIDIA H100 SXM", 3.35e12, 80e9, 34e12)
    assert roofline.chip_spec("cuda:0", torch.float32)["peak_flops"] == 67e12
    assert roofline.chip_spec("cuda:0", torch.bfloat16) is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    assert roofline.chip_spec("cuda:0") is None


def test_compiled_cost_counts_a_matmul():
    a, b = torch.ones(64, 48, dtype=torch.float64), torch.ones(
        48, 32, dtype=torch.float64)
    assert roofline.compiled_cost(lambda x, y: (x @ y).sum(), a, b) == \
        (2 * 64 * 48 * 32, None)
    assert roofline.compiled_cost(lambda: 1 / 0) == (None, None)
