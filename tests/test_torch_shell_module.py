"""The port's ShellModule (femo_tpu_torch/models/shell_module.py) through
the graph API, on CPU tensors in f64, against the JAX package's values in
oracles/shell_oracle.npz (entry module_small: the (4, 6) plate under a 3 x
4 grid of aero loads, `Simulator.run`, then `objective_gradient` of
compliance and of the p-norm stress with respect to thickness).  Each
output and gradient (relative L2) is held within 10 times the JAX
package's own spread between its jit_bt module and its jit_dense one for
that key (`module_small_dense_*`), at least f64 rounding (1e-12: the mass,
and the objective values, which both packages' solvers agree on to
~1e-14): the thin shell's conditioning lets two correct solves differ by
~1e-8, the JAX package's two solvers included
(femo_tpu_torch/tools/shell_parity.py)."""

import json
import os

import numpy as np
import pytest
import torch

from femo_tpu_torch.graph.simulator import Simulator
from femo_tpu_torch.models.shell_module import plate_module
from femo_tpu_torch.tools.shell_parity import module_bars, rel_l2

torch.set_num_threads(1)

ORACLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "oracles", "shell_oracle.npz")
SMALL = dict(n_shell=[4, 6], span=4.0, chord=1.0, E=7e10, nu=0.3,
             thickness=0.01, n_aero=[3, 4], force_z=-80.0)
OUTPUTS = ("mass", "compliance", "elastic_energy", "pnorm_stress",
           "nodal_displacements", "von_mises")
KEYS = OUTPUTS + tuple(f"{of}_{k}" for of in ("compliance", "pnorm_stress")
                       for k in ("value", "grad"))


@pytest.fixture(scope="module")
def oracle():
    o = np.load(ORACLE)
    assert json.loads(str(o["module_small_config"])) == SMALL
    return o


@pytest.fixture(scope="module")
def bar(oracle):
    """Per key: 10x the JAX package's jit_bt vs jit_dense spread, at
    least 1e-12."""
    return module_bars(oracle, "module_small", KEYS)


@pytest.fixture(scope="module")
def run():
    mod, F = plate_module(**SMALL, device="cpu")
    sim = Simulator(mod)
    sim["nodal_forces"] = F
    out = {k: v.clone() for k, v in sim.run().items()}
    x_run = mod.state.current().clone()
    grads = {of: sim.objective_gradient(of, ["thickness"])
             for of in ("compliance", "pnorm_stress")}
    return mod, sim, out, x_run, grads


@pytest.mark.parametrize("name", OUTPUTS)
def test_outputs_match_jax(oracle, bar, run, name):
    _, _, out, _, _ = run
    assert rel_l2(out[name].numpy(),
                  oracle[f"module_small_{name}"]) <= bar[name]


@pytest.mark.parametrize("of", ["compliance", "pnorm_stress"])
def test_objective_gradients_match_jax(oracle, bar, run, of):
    _, _, _, _, grads = run
    val, g, _ = grads[of]
    assert rel_l2(val.numpy(),
                  oracle[f"module_small_{of}_value"]) <= bar[f"{of}_value"]
    assert rel_l2(g["thickness"].numpy(),
                  oracle[f"module_small_{of}_grad"]) <= bar[f"{of}_grad"]


def test_state_pushed_by_run_only(run):
    """run() writes the solved (u, theta) into the shell's fields;
    objective_gradient (pure mode) leaves them as they were, bit for
    bit."""
    mod, _, out, x_run, _ = run
    assert torch.equal(mod.state.current(), x_run)
    assert torch.equal(mod.shell.u.array, out["u"])
    assert torch.equal(mod.shell.theta.array, out["theta"])


def test_physics(run):
    """Mass, Clapeyron (compliance = 2 x elastic energy), downward aero
    displacements and a von Mises field that peaks at the clamped root."""
    mod, _, out, _, _ = run
    assert float(out["mass"]) == pytest.approx(0.01 * 4.0 * 1.0, rel=1e-12)
    np.testing.assert_allclose(float(out["compliance"]),
                               2 * float(out["elastic_energy"]), rtol=1e-8)
    assert (out["nodal_displacements"][:, 2] < 0).all()
    vm = out["von_mises"].numpy()
    coords = mod.shell.mesh.coords
    root = np.isclose(coords[:, 1], 0.0)
    assert vm.shape == (mod.shell.mesh.n_nodes,) and np.isfinite(vm).all()
    assert vm[root].max() > 2 * vm[~root].mean()


def test_mass_gradient(run):
    """compute_totals of the mass: rho times each cell's area."""
    mod, sim, _, _, _ = run
    tot = sim.compute_totals("mass", "thickness")[("mass", "thickness")]
    np.testing.assert_allclose(tot.numpy(), mod.shell.mesh.cell_volumes(),
                               rtol=1e-12)
