"""The port's shell thickness optimization script
(femo_tpu_torch/examples/run_shell_thickness_opt.py) on the CPU against
the JAX package's script (oracles/examples_oracle.npz), f64.

The script has no arguments, and its 25 SLSQP iterations take minutes
here (each evaluation runs the host Newton loop of the RM shell a few
times).  This test stops SLSQP at its first evaluation
(example_parity.first_evaluation): the objective there is held to the
JAX run's first evaluation (1e-8) and its gradient too (1e-6), with the
script's initial mass.
"""

import pytest
import torch

import femo_tpu_torch
import femo_tpu_torch.examples.run_shell_thickness_opt as script
from femo_tpu_torch.tools.example_parity import (
    check_prefix, first_evaluation, load_oracle, run_example)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(femo_tpu_torch.config, "device", "cpu")
    monkeypatch.chdir(tmp_path)


def test_shell_thickness_first_evaluation():
    oracle = load_oracle()
    key = "shell_thickness"
    with first_evaluation(script):
        res, calls = run_example(oracle, key)
    check_prefix(oracle, key, calls)
    # the objective is 0.1 x the mass
    want = float(oracle[f"{key}_f"][0])
    assert abs(res["initial"]["mass"] * 0.1 - want) <= 1e-8 * want
