"""Parity of the port's W3 Hermite beam (models/beam.py; Hermite spaces
in fea/space.py; Hessian tables, derivative-dof scaling and point facets
in fea/assemble.py) with the JAX package, f64, CPU:

* the Hermite dofmap and dof coordinates, equal;
* the beam's residual vector and stiffness (Hessian tables) at nel=8,
  at seeded dofs and thicknesses: 1e-13;
* the tip deflection against the closed form P L^3 / (3 EI), which
  Hermite cubics represent exactly;
* compliance and its adjoint gradient at seeded thicknesses against the
  JAX package: 1e-12 and 1e-10.
"""

import numpy as np
import jax.numpy as jnp
import torch

from femo_tpu.fea.assemble import compile_form as jcompile
from femo_tpu.graph.model import FEAModel as JFEAModel
from femo_tpu.graph.simulator import Simulator as JSimulator
from femo_tpu.models.beam import build_beam_problem as jbuild_beam

from femo_tpu_torch.fea.assemble import compile_form
from femo_tpu_torch.graph.model import FEAModel
from femo_tpu_torch.graph.simulator import Simulator
from femo_tpu_torch.models.beam import OPENMDAO_THICK_REF, build_beam_problem

torch.set_num_threads(1)

NEL = 8


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def test_hermite_dofmap_matches_jax():
    _, d = build_beam_problem(nel=NEL, device="cpu")
    _, jd = jbuild_beam(nel=NEL)
    V, jV = d["V"], jd["V"]
    assert V.n_dofs == jV.n_dofs == 2 * (NEL + 1)
    np.testing.assert_array_equal(V.dofmap, np.asarray(jV.dofmap))
    np.testing.assert_array_equal(V.scalar_dof_coords, jV.scalar_dof_coords)
    np.testing.assert_array_equal(V.scalar_dof_kind, jV.scalar_dof_kind)
    np.testing.assert_array_equal(OPENMDAO_THICK_REF.shape, (50,))


def test_hessian_assembly_matches_jax():
    fea, d = build_beam_problem(nel=NEL, device="cpu")
    jfea, jd = jbuild_beam(nel=NEL)
    rng = np.random.default_rng(4)
    u = rng.standard_normal(d["V"].n_dofs)
    t = 0.1 + 0.05 * rng.uniform(size=NEL)
    form = fea.states_dict["displacements"]["residual_form"]
    jform = jfea.states_dict["displacements"]["residual_form"]
    cf, jcf = compile_form(form), jcompile(jform)
    vals = {"displacements": torch.as_tensor(u),
            "thickness": torch.as_tensor(t)}
    jvals = {"displacements": jnp.asarray(u), "thickness": jnp.asarray(t)}
    r = cf.vector(vals).numpy()
    jr = np.asarray(jcf.vector_jit()(jvals))
    assert np.abs(r - jr).max() <= 1e-13 * np.abs(jr).max()
    K = cf.matrix(vals, "displacements").to_dense().numpy()
    jK = np.zeros_like(K)
    for A, rows, cols in jcf.matrix_blocks_jit("displacements")(jvals):
        np.add.at(jK, (np.asarray(rows)[:, :, None],
                       np.asarray(cols)[:, None]), np.asarray(A))
    assert np.abs(K - jK).max() <= 1e-13 * np.abs(jK).max()


def test_tip_deflection_closed_form():
    fea, d = build_beam_problem(nel=10, device="cpu")
    fea.solve("displacements")
    E, b, h, L, P = 1.0, 0.1, 0.1, 1.0, -1.0
    tip = d["u"].array.numpy()[0::2][-1]
    np.testing.assert_allclose(tip, P * L**3 / (3 * E * b * h**3 / 12),
                               rtol=1e-9)


def test_adjoint_matches_jax():
    t = 0.1 + 0.04 * np.random.default_rng(6).uniform(-1, 1, NEL)
    out = []
    for build, FM, Sim, kw in ((build_beam_problem, FEAModel, Simulator,
                                {"device": "cpu"}),
                               (jbuild_beam, JFEAModel, JSimulator, {})):
        fea, d = build(nel=NEL, **kw)
        model = FM(fea=[fea])
        model.create_input("thickness", shape=NEL, val=0.1)
        model.add_design_variable("thickness")
        model.add_objective("compliance")
        sim = Sim(model)
        sim["thickness"] = t
        sim.run()
        val, grads, _ = sim.objective_gradient("compliance", ["thickness"])
        out.append((float(val), np.asarray(grads["thickness"])))
    (c, g), (jc, jg) = out
    assert abs(c - jc) <= 1e-12 * abs(jc)
    assert _rel(g, jg) <= 1e-10
