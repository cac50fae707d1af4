"""The port's eager graph-API motor model (femo_tpu_torch/models/motor/
model.py::build_motor_model), its shape layers and continuation solvers,
and the imported-mesh path (the copies of mesh/gmsh_io.py and
models/motor/unstructured.py), against the JAX package, f64, CPU.

The eager model runs at refine 0.5 with 2 EM load steps and shape_dv =
(5e-4, 3e-4) (the fixture of tests/test_motor.py), on the mesh of the JAX
package: Newton to the reference's tolerance in every continuation step,
then the IFT gradient.  Its JAX values, with LinearSolver("scipy"), are
`eager_r05_*` of oracles/motor_oracle.npz (oracles/motor_oracle.py; the
JAX eager model takes longer to run than this file's time allows).
Outputs (loss, torque, areas) 1e-10 relative, the |B| field 1e-10
relative L2, the gradient 1e-8 relative L2; with the port's "scipy", and
with its "block_thomas" (both solve to round-off).  The shape layers
agree to 1e-14; the copied mesh code gives equal arrays.
"""

import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from femo_tpu.fea import FunctionSpace as JSpace
from femo_tpu.io.xdmf import XDMFWriter
from femo_tpu.mesh.generators import create_unit_square_mesh as jsquare
from femo_tpu.mesh.gmsh_io import import_mesh as jimport_mesh
from femo_tpu.models.motor import model as jmodel
from femo_tpu.models.motor.mesh import create_motor_mesh as jmotor_mesh
from femo_tpu.models.motor.unstructured import (
    generate_motor_mesh_arrays as jgenerate)

from femo_tpu_torch.convert import mesh_from_jax
from femo_tpu_torch.fea.space import FunctionSpace
from femo_tpu_torch.graph.simulator import Simulator
from femo_tpu_torch.mesh.gmsh_io import (
    import_mesh, read_association_table, read_xdmf_mesh)
from femo_tpu_torch.models.motor.mesh import create_motor_mesh
from femo_tpu_torch.models.motor.model import (
    build_motor_model, ffd_shape_parameter_layer,
    make_incremental_em_solver, make_incremental_mm_solver, make_min_detF)
from femo_tpu_torch.models.motor.unstructured import (
    generate_motor_mesh_arrays, region_names, write_motor_msh)
from femo_tpu_torch.ops import bt_sweeps
from femo_tpu_torch.solvers.linear import LinearSolver
from femo_tpu_torch.solvers.newton import NewtonInfo

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = np.load(os.path.join(REPO, "oracles", "motor_oracle.npz"))
DV = np.array([5e-4, 3e-4])
SCALARS = ("loss_sum", "torque", "magnet_area", "winding_area",
           "steel_area", "eddy_current_loss", "hysteresis_loss")


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def jmesh():
    return jmotor_mesh(0.5)


@pytest.mark.parametrize("method", ["scipy", "block_thomas"])
def test_eager_model_matches_jax(jmesh, method):
    assert json.loads(str(ORACLE["configs"]))["eager_r05"] == dict(
        refine=0.5, em_load_steps=2, linear_solver="scipy",
        shape_dv=DV.tolist())
    model, d = build_motor_model(
        refine=0.5, em_load_steps=2, device="cpu",
        mesh=mesh_from_jax(jmesh),
        linear_solver=LinearSolver(method=method))
    assert [op.name for op in model.operations[:2]] == [
        "boundary_input_model", "source_tables_model"]
    sim = Simulator(model)
    sim["shape_dv"] = DV
    before = dict(bt_sweeps.launches)
    out = sim.run()
    val, grads, _ = sim.objective_gradient("loss_sum", ["shape_dv", "iq"])
    assert bt_sweeps.launches == before  # CPU tensors: plain sweeps
    for k in SCALARS:
        want = float(ORACLE[f"eager_r05_{k}"])
        assert abs(float(out[k]) - want) <= 1e-10 * abs(want), k
    want = ORACLE["eager_r05_B_magnitude"]
    assert out["B_magnitude"].shape == want.shape
    assert _rel(out["B_magnitude"].numpy(), want) <= 1e-10
    # the field output persisted on its Function, as in the JAX package
    fo = d["fea_em"].outputs_field_dict["B_magnitude"]["func"]
    np.testing.assert_array_equal(fo.array.numpy(),
                                  out["B_magnitude"].numpy())
    jval = float(ORACLE["eager_r05_loss"])
    assert abs(float(val) - jval) <= 1e-10 * jval
    grad = np.concatenate([grads["shape_dv"].numpy(), [float(grads["iq"])]])
    jgrad = np.concatenate([ORACLE["eager_r05_g_dv"],
                            [float(ORACLE["eager_r05_g_iq"])]])
    assert _rel(grad, jgrad) <= 1e-8


def test_ffd_layer_and_min_detF_match_jax(jmesh):
    jVmm = JSpace(jmesh, ("CG", 1), ncomp=2)
    mesh = mesh_from_jax(jmesh)
    Vmm = FunctionSpace(mesh, ("CG", 1), ncomp=2, device="cpu")
    rng = np.random.default_rng(11)
    for k in (1, 4):
        jto, jn = jmodel.ffd_shape_parameter_layer(jmesh, jVmm, k)
        to, n = ffd_shape_parameter_layer(mesh, Vmm, k)
        assert n == jn == 2 * (2 * k + 1)
        p = 1e-4 * rng.standard_normal(n)
        want = np.asarray(jto(jnp.asarray(p)))
        assert np.abs(to(torch.as_tensor(p)).numpy() - want).max() <= \
            1e-14 * np.abs(want).max()
    u = 0.05 * mesh.min_cell_size() * rng.standard_normal(Vmm.n_dofs)
    jmin = float(jmodel.make_min_detF(jmesh, jVmm)(jnp.asarray(u)))
    tmin = float(make_min_detF(mesh, Vmm)(torch.as_tensor(u)))
    assert abs(tmin - jmin) <= 1e-14 and 0 < jmin < 1


def test_eager_model_with_ffd_layer(jmesh):
    """design_space="edge_deltas" with ffd_harmonics: the dv goes through
    the Fourier layer, then the edge-delta scatter."""
    model, _ = build_motor_model(
        refine=0.5, design_space="edge_deltas", ffd_harmonics=2,
        mesh=mesh_from_jax(jmesh), device="cpu")
    assert [op.name for op in model.operations[:3]] == [
        "ffd_model", "boundary_input_model", "source_tables_model"]
    assert model.defaults["shape_dv"].shape == (10,)


class _Op:
    """Stands in for an ImplicitSolveOp: each Newton call returns the next
    of the given states with the given convergence."""

    def __init__(self, states, converged):
        self.states, self.converged, self.calls = list(states), converged, []

    def newton(self, inputs, u, **kw):
        self.calls.append((inputs, kw))
        info = NewtonInfo(3, 1.0 if not self.converged else 0.0, 1.0,
                          self.converged)
        return self.states.pop(0), None, info


def test_incremental_solvers_steps_and_warnings():
    mesh = create_motor_mesh(0.5)
    Vmm = FunctionSpace(mesh, ("CG", 1), ncomp=2, device="cpu")
    h = mesh.min_cell_size()
    g = torch.zeros(Vmm.n_dofs, dtype=torch.float64)
    g[0] = 1.5 * h  # STEPS = max(2, ceil(4 * 1.5)) = 6
    ok = torch.zeros(Vmm.n_dofs, dtype=torch.float64)
    solve = make_incremental_mm_solver(h, make_min_detF(mesh, Vmm))
    op = _Op([ok] * 6, converged=True)
    with warnings_as_list() as w:
        solve(op, {"uhat_bc": g}, ok)
    assert not w and len(op.calls) == 6
    assert torch.equal(op.calls[-1][0]["uhat_bc"], g)
    assert op.calls[0][1] == {"line_search": "bt"}
    # an unconverged step and an inverting displacement each warn
    crush = torch.zeros(Vmm.n_dofs, dtype=torch.float64)
    crush[0::2] = -2.0 * torch.as_tensor(Vmm.scalar_dof_coords[:, 0])
    op = _Op([ok] * 5 + [crush], converged=False)
    with pytest.warns(UserWarning) as rec:
        solve(op, {"uhat_bc": g}, ok)
    msgs = " ".join(str(r.message) for r in rec)
    assert "did not converge" in msgs and "inverted elements" in msgs

    em = make_incremental_em_solver(3, damping=0.8)
    tables = {"Htable": torch.ones(2, dtype=torch.float64),
              "Jtable": torch.ones(3, dtype=torch.float64),
              "uhat": ok}
    op = _Op([ok] * 3, converged=False)
    with pytest.warns(UserWarning, match="EM load step"):
        em(op, tables, ok)
    assert [float(c[0]["Jtable"][0]) for c in op.calls] == [1 / 3, 2 / 3,
                                                            1.0]
    assert op.calls[0][1] == {"damping": 0.8, "line_search": "bt"}


class warnings_as_list:
    def __enter__(self):
        import warnings
        self._cm = warnings.catch_warnings(record=True)
        out = self._cm.__enter__()
        warnings.simplefilter("always")
        return out

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


def test_record_raises():
    """record=True no longer raises: the model carries the XDMF Recorder
    of the JAX package's model (records_motor, the |B| field recorded);
    tests/test_torch_optimizer_drivers.py runs it against the JAX files."""
    from femo_tpu_torch.io.xdmf import Recorder

    model, d = build_motor_model(refine=0.5, record=True, device="cpu")
    assert isinstance(model.recorder, Recorder)
    assert model.recorder.path == "records_motor"
    assert d["fea_em"].outputs_field_dict["B_magnitude"]["record"]


def test_unstructured_generator_equals_jax():
    got = generate_motor_mesh_arrays(refine=0.5, seed=0)
    want = jgenerate(refine=0.5, seed=0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert len(got[3]) == len(want[3])
    for (ta, a), (tb, b) in zip(got[3], want[3]):
        assert ta == tb
        np.testing.assert_array_equal(a, b)


def test_msh_round_trip(tmp_path):
    """write_motor_msh -> import_mesh -> read_association_table, and the
    same file read by the JAX package's reader."""
    path = str(tmp_path / "motor_u.msh")
    ini = write_motor_msh(path, refine=0.5, seed=0)
    assert os.path.exists(ini)
    mesh, jmesh = import_mesh(path), jimport_mesh(path)
    coords, tris, tags, _ = generate_motor_mesh_arrays(refine=0.5, seed=0)
    np.testing.assert_array_equal(mesh.coords, coords)
    np.testing.assert_array_equal(mesh.cells, tris)
    np.testing.assert_array_equal(mesh.cell_tags, tags)
    for k in ("coords", "cells", "cell_tags", "facet_tags"):
        np.testing.assert_array_equal(getattr(mesh, k), getattr(jmesh, k))
    assert mesh.region_names == jmesh.region_names
    assert read_association_table(ini) == region_names()


def test_xdmf_mesh_read(tmp_path):
    """The copied XDMF reader reads what the JAX package's writer writes."""
    jm = jsquare(3)
    fn = str(tmp_path / "m.xdmf")
    XDMFWriter(fn, jm).close()
    for m in (read_xdmf_mesh(fn), import_mesh(fn)):
        assert m.cell_type == "triangle"
        np.testing.assert_allclose(m.coords, jm.coords)
        np.testing.assert_array_equal(m.cells, jm.cells)
