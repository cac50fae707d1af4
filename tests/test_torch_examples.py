"""The port's run scripts (femo_tpu_torch/examples/) on the CPU against the
JAX package's scripts at the same arguments (oracles/examples_oracle.npz,
written by oracles/examples_oracle.py), f64.

Each script's `main(argv)` runs with `config.device = "cpu"` in a
temporary directory.  Where a script optimizes, every scipy.optimize
evaluation is recorded on both sides (femo_tpu_torch/tools/
minimize_log.py): the evaluation count must be equal, every objective
value within 1e-8 and the final design within 1e-6 (relative, 2-norm).
The values a script returns are held to the JAX script's at 1e-8
(scalars) and 1e-6 (vectors): femo_tpu_torch/tools/example_parity.py,
which chip_smoke.py shares.
"""

import pytest
import torch

import femo_tpu_torch
from femo_tpu_torch.tools.example_parity import (
    check_example, load_oracle, run_example)

torch.set_num_threads(1)

# every script but the eager motor (on the card, at refine 1) and the
# shell thickness optimization (tests/test_torch_examples_shell.py)
KEYS = ["poisson", "nonlinear_poisson", "topo", "beam", "shell_modal",
        "roof", "aero_static", "aero_dynamic", "aero_vpm", "motor_jit_r05"]


@pytest.fixture(scope="module")
def oracle():
    return load_oracle()


@pytest.fixture(autouse=True)
def cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(femo_tpu_torch.config, "device", "cpu")
    monkeypatch.chdir(tmp_path)


@pytest.mark.parametrize("key", KEYS)
def test_script_matches_jax(oracle, key):
    res, calls = run_example(oracle, key)
    check_example(oracle, key, res, calls)
