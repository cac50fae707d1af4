"""The port's motor optimization step, end to end, against the JAX package
(the whole slice): refine 0.5, f64, CPU, in the configuration of the f64
oracle experiments/motor_latency_oracle.json (3 EM load steps, 3+3 Newton
iterations, block Thomas, 8 PCG iterations, edge-delta design space) and
in the other configurations of `build_motor_jit_step`: bench.py's
Shamanskii factor reuse (`refactor_every=3`, with and without
`freeze_operator`), the dense-LU branch, the 2-dof basis design space and
another block size.

Both packages run the same mesh (one module-scoped copy) and inputs; the
JAX side of the reuse and LU configurations is its values in
oracles/motor_oracle.npz.  Loss: 1e-10 relative between them and to the
oracle; gradient (g_dv, g_iq): 1e-8 relative L2.
"""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from femo_tpu.models.motor.model import build_motor_jit_step as jax_build

from femo_tpu_torch.convert import mesh_from_jax, step_inputs
from femo_tpu_torch.models.motor.model import (
    boundary_displacement_basis, build_motor_jit_step,
    edge_delta_design_space)
from femo_tpu_torch.ops import bt_sweeps

# the port's CPU path is dispatch-bound: extra intra-op threads only
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE_R05 = 28.349221547988982  # experiments/motor_latency_oracle.json
# the JAX package's values of further configurations (oracles/motor_oracle.py)
MOTOR_ORACLE = np.load(os.path.join(REPO, "oracles", "motor_oracle.npz"))
MOTOR_ORACLE_CONFIGS = json.loads(str(MOTOR_ORACLE["configs"]))
CFG = dict(em_load_steps=3, mm_newton_iters=3, em_newton_iters=3,
           factorization="block_thomas", pcg_iters=8,
           design_space="edge_deltas")


@pytest.fixture(scope="module")
def steps():
    jstep, (jdv0, jiq0), jinfo = jax_build(refine=0.5, **CFG)
    tstep, (tdv0, tiq0), tinfo = build_motor_jit_step(
        mesh=mesh_from_jax(jinfo["mesh"]), device="cpu", **CFG)
    out = dict(jstep=jstep, jdv0=jdv0, jiq0=jiq0, jinfo=jinfo,
               tstep=tstep, tdv0=tdv0, tiq0=tiq0, tinfo=tinfo)
    out["at_dv0"] = _both(out, np.asarray(jdv0), np.asarray(jiq0))
    return out


def _both(steps, dv, iq):
    jl, (jg, jgi) = steps["jstep"](jnp.asarray(dv), jnp.asarray(iq))
    before = dict(bt_sweeps.launches)
    tl, (tg, tgi) = steps["tstep"](*step_inputs(dv, iq, device="cpu"))
    assert bt_sweeps.launches == before  # CPU tensors: plain sweeps
    jgrad = np.concatenate([np.asarray(jg), [float(jgi)]])
    tgrad = np.concatenate([tg.numpy(), [float(tgi)]])
    return float(jl), float(tl), jgrad, tgrad


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_step_setup_matches(steps):
    assert steps["tinfo"]["bt"] == steps["jinfo"]["bt"]
    assert steps["tinfo"]["bt"]["mm"]["nb"] == 11
    assert steps["tinfo"]["bt"]["em"]["nb"] == 6
    np.testing.assert_array_equal(steps["tdv0"].numpy(),
                                  np.asarray(steps["jdv0"]))
    assert steps["tdv0"].shape == (288,)
    assert float(steps["tiq0"]) == float(steps["jiq0"])


def test_step_matches_jax_and_oracle(steps):
    jl, tl, jgrad, tgrad = steps["at_dv0"]
    assert abs(tl - jl) <= 1e-10 * abs(jl)
    assert abs(tl - ORACLE_R05) <= 1e-10 * ORACLE_R05
    assert abs(jl - ORACLE_R05) <= 1e-10 * ORACLE_R05
    assert np.all(np.isfinite(tgrad)) and np.abs(tgrad).max() > 0
    assert _rel(tgrad, jgrad) <= 1e-8


def test_step_matches_jax_at_seeded_inputs(steps):
    rng = np.random.default_rng(3)
    dv = np.asarray(steps["jdv0"]) * (1.0 + 0.2 * rng.standard_normal(288))
    iq = 1e5 * (1.0 + 0.1 * rng.standard_normal())
    jl, tl, jgrad, tgrad = _both(steps, dv, iq)
    assert abs(tl - jl) <= 1e-10 * abs(jl)
    assert _rel(tgrad, jgrad) <= 1e-8


def test_dv0_is_the_basis_displacement_on_the_interface(steps):
    """The edge-delta scatter of dv0 is the radial/tangential boundary
    displacement basis @ (5e-4, 3e-4): equal on every dof."""
    info = steps["tinfo"]
    scatter, n_dv, _, _ = edge_delta_design_space(info["mesh"], info["Vmm"])
    basis = boundary_displacement_basis(info["mesh"], info["Vmm"])
    assert n_dv == 288
    want = basis.numpy() @ np.array([5e-4, 3e-4])
    np.testing.assert_array_equal(scatter(steps["tdv0"]).numpy(), want)


@pytest.mark.parametrize("name, kw", [
    ("r05_re3", dict(refactor_every=3)),
    ("r05_re3_freeze", dict(refactor_every=3, freeze_operator=True)),
    ("r05_lu", dict(factorization="lu")),
], ids=["refactor3", "freeze3", "lu"])
def test_configured_step_matches_jax(steps, name, kw):
    """bench.py's factor reuse, the frozen operator and dense LU, at fixed
    counts, against the JAX package's step in the same configuration on
    the same mesh: round-off.  The JAX values are `<name>_*` of
    oracles/motor_oracle.npz (oracles/motor_oracle.py), since compiling
    three more JAX steps here would triple this file's time.  The reuse
    steps precondition with the stale factor's own L: a fresh L beside
    the stale Sinv is another iteration and misses these bars."""
    cfg = dict(CFG, **kw)
    assert MOTOR_ORACLE_CONFIGS[name] == {**CFG, "refactor_every": 1,
                                          "refine": 0.5, **kw}
    tstep, (tdv0, tiq0), tinfo = build_motor_jit_step(
        mesh=steps["tinfo"]["mesh"], device="cpu", **cfg)
    assert tinfo["bt"] == ({} if name == "r05_lu" else steps["tinfo"]["bt"])
    tl, (tg, tgi) = tstep(tdv0, tiq0)
    jl = float(MOTOR_ORACLE[f"{name}_loss"])
    jgrad = np.concatenate([MOTOR_ORACLE[f"{name}_g_dv"],
                            [float(MOTOR_ORACLE[f"{name}_g_iq"])]])
    tgrad = np.concatenate([tg.numpy(), [float(tgi)]])
    assert abs(float(tl) - jl) <= 1e-10 * abs(jl)
    assert _rel(tgrad, jgrad) <= 1e-8
    if name == "r05_lu":  # the same Newton counts reach the oracle's state
        assert abs(float(tl) - ORACLE_R05) <= 1e-10 * ORACLE_R05


def test_basis_step_matches_jax(steps):
    """The 2-dof design space at dv0 = (5e-4, 3e-4) prescribes the boundary
    displacement that the edge-delta dv0 does, so it gives the JAX
    edge-delta step's loss and, through the basis rows of the interface
    dofs, its gradient: g_basis = basis[iface]^T g_edge."""
    tstep, (tdv0, tiq0), tinfo = build_motor_jit_step(
        mesh=steps["tinfo"]["mesh"], device="cpu",
        **dict(CFG, design_space="basis"))
    np.testing.assert_array_equal(tdv0.numpy(), [5e-4, 3e-4])
    tl, (tg, tgi) = tstep(tdv0, tiq0)
    jl, _, jgrad, _ = steps["at_dv0"]
    _, _, _, iface = edge_delta_design_space(tinfo["mesh"], tinfo["Vmm"])
    basis = boundary_displacement_basis(tinfo["mesh"], tinfo["Vmm"]).numpy()
    want = np.concatenate([basis[iface.numpy()].T @ jgrad[:-1],
                           jgrad[-1:]])
    assert abs(float(tl) - jl) <= 1e-10 * abs(jl)
    assert _rel(np.concatenate([tg.numpy(), [float(tgi)]]), want) <= 1e-8


def test_block_size_option(steps):
    """block_size sets the template's blocks as in the JAX package; the
    step's loss does not depend on it beyond round-off."""
    cfg = dict(CFG, block_size=256)
    _, _, jinfo = jax_build(mesh=steps["jinfo"]["mesh"], **cfg)
    tstep, (tdv0, tiq0), tinfo = build_motor_jit_step(
        mesh=steps["tinfo"]["mesh"], device="cpu", **cfg)
    assert tinfo["bt"] == jinfo["bt"]
    assert tinfo["bt"]["mm"]["B"] == tinfo["bt"]["em"]["B"] == 256
    tl, _ = tstep(tdv0, tiq0)
    assert abs(float(tl) - ORACLE_R05) <= 1e-10 * ORACLE_R05


def test_defaults_are_the_jax_packages():
    """The same call gives the same computation in both packages."""
    def defaults(fn):
        # the port has no `sweeps` switch (K1/K2 are the sweeps on CUDA
        # tensors) and adds `device`
        return {k: p.default for k, p in inspect.signature(
            fn).parameters.items() if k not in ("device", "sweeps")}

    assert defaults(build_motor_jit_step) == defaults(jax_build)
    assert defaults(build_motor_jit_step)["factorization"] == "lu"
    assert defaults(build_motor_jit_step)["design_space"] == "basis"


@pytest.mark.parametrize("design_space", ["ffd"])
def test_unported_design_space_raises(design_space):
    with pytest.raises(ValueError, match="unknown design_space"):
        build_motor_jit_step(refine=0.5, design_space=design_space,
                             device="cpu")
    with pytest.raises(ValueError, match="unknown design_space"):
        jax_build(refine=0.5, design_space=design_space)


def test_unported_options_raise():
    # sharded assembly takes a RankMesh (tests/test_torch_sharding.py)
    with pytest.raises(TypeError, match="device_mesh"):
        build_motor_jit_step(refine=0.5, device_mesh=object(),
                             device="cpu")
    # the JAX package's guard: reuse needs block Thomas
    with pytest.raises(ValueError, match="refactor_every"):
        build_motor_jit_step(refine=0.5, refactor_every=3, device="cpu")
    with pytest.raises(ValueError, match="refactor_every"):
        build_motor_jit_step(refine=0.5, refactor_every=3,
                             factorization="block_thomas",
                             device_mesh=object(), device="cpu")


def _run(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    res = _run(
        "import sys\n"
        "import femo_tpu_torch.models.motor.model\n"
        "import femo_tpu_torch.models.motor.unstructured\n"
        "import femo_tpu_torch.mesh.gmsh_io\n"
        "import femo_tpu_torch.fea.project\n"
        "import femo_tpu_torch.convert\n"
        "import femo_tpu_torch.models.vlm\n"
        "import femo_tpu_torch.graph.fixed_point\n"
        "import femo_tpu_torch.models.fsi\n"
        "import femo_tpu_torch.tools.profile_step\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'femo_tpu.')) or m == 'femo_tpu']\n"
        "assert not bad, bad\n")
    assert res.returncode == 0, res.stderr


def test_chip_smoke_fails_without_cuda():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
