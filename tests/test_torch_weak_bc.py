"""Parity of the port's weak (Nitsche) boundary conditions with the JAX
package, f64, CPU, through the graph API (FEAModel, Simulator.run,
objective_gradient):

* W1 with weak_bc=True (models/poisson.py::build_fea), symmetric and
  nonsymmetric Nitsche, at nel=8 on the dense path, and symmetric with
  the port's LinearSolver("bicgstab_bt"): loss 1e-12, gradient 1e-10
  relative.
* W2, nonlinear Poisson -lap u + u^3 = f with Nitsche terms and
  PDE_SOLVER="SNES" (Newton with backtracking), built in both packages
  as tests/test_nonlinear_poisson.py builds it, symmetric and
  nonsymmetric, at nel=8: the same gates.

Both packages solve the same dense systems to the same Newton
tolerance, so the states agree to rounding.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from femo_tpu.fea import (
    FEA as JFEA, FormDef as JFormDef, Function as JFunction,
    FunctionSpace as JSpace, create_unit_square_mesh as jsquare,
    dot as jdot, ds as jds, dx as jdx, grad as jgrad)
from femo_tpu.graph.model import FEAModel as JFEAModel
from femo_tpu.graph.simulator import Simulator as JSimulator
from femo_tpu.models.poisson import build_fea as jbuild_fea

from femo_tpu_torch.fea.fea import FEA
from femo_tpu_torch.fea.forms import FormDef, dot, ds, dx, grad
from femo_tpu_torch.fea.space import Function, FunctionSpace
from femo_tpu_torch.graph.model import FEAModel
from femo_tpu_torch.graph.simulator import Simulator
from femo_tpu_torch.mesh.generators import create_unit_square_mesh
from femo_tpu_torch.models.poisson import build_fea
from femo_tpu_torch.solvers.linear import LinearSolver

torch.set_num_threads(1)

PI = np.pi
NEL = 8
BETA = 10.0  # W2's Nitsche penalty


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _w2(mod, nel, sym, **kw):
    """W2 in one package: tests/test_nonlinear_poisson.py's `build`."""
    J = mod == "jax"
    mesh = (jsquare if J else create_unit_square_mesh)(nel)
    mesh.mark_boundary_facets(1)
    Sp, Fn, FD, Fea = ((JSpace, JFunction, JFormDef, JFEA) if J else
                       (FunctionSpace, Function, FormDef, FEA))
    d_, g_, dx_, ds_ = ((jdot, jgrad, jdx, jds) if J else
                        (dot, grad, dx, ds))
    sin = jnp.sin if J else torch.sin
    V = Sp(mesh, ("CG", 1), **kw)
    W = Sp(mesh, ("DG", 0), **kw)
    u, f = Fn(V, "u"), Fn(W, "f")
    sgn = 1.0 if sym else -1.0

    def interior(w, g):
        return d_(g_(w.u), g_(w.v)) + w.u**3 * w.v - w.f * w.v

    def boundary(w, g):
        ue = sin(2 * PI * g.x[0]) * sin(PI * g.x[1])
        r = (-d_(g_(w.u), g.n) * w.v
             + sgn * (ue - w.u) * d_(g_(w.v), g.n))
        if sym:
            r = r + BETA / g.h * (w.u - ue) * w.v
        return r

    residual = FD([dx_(interior), ds_(boundary, tag=1)], coeffs=[u, f],
                  test=V)
    u_ex = Fn(V, "u_ex").interpolate(
        lambda x: np.sin(2 * PI * x[0]) * np.sin(PI * x[1]))
    obj = FD([dx_(lambda w, g: 0.5 * (w.u - w.u_ex) ** 2 + 3e-7 * w.f**2)],
             coeffs=[u, u_ex, f])
    fea = Fea(mesh)
    fea.PDE_SOLVER = "SNES"
    fea.add_input("f", f)
    fea.add_state("u", u, residual, ["f"])
    fea.add_output("J", "scalar", obj, ["u", "f"])
    return fea, W


def _run(fea, W, FM, Sim, of, f0):
    model = FM(fea=[fea])
    model.create_input("f", shape=W.n_dofs, val=f0)
    model.add_design_variable("f")
    model.add_objective(of)
    sim = Sim(model)
    sim.run()
    val, grads, _ = sim.objective_gradient(of, ["f"])
    return float(val), np.asarray(grads["f"])


@pytest.mark.parametrize("sym, method", [(True, None), (False, None),
                                         (True, "bicgstab_bt")])
def test_w1_weak_bc_matches_jax(sym, method):
    """The dense path in both packages; and the port's BiCGStab
    preconditioned by the block-Thomas factor, the solver chip_smoke.py
    runs at nel=260 (there BiCGStab + Jacobi does not converge on this
    system), against the JAX package's dense solve."""
    fea, d = build_fea(nel=NEL, weak_bc=True, sym=sym, device="cpu")
    jfea, jd = jbuild_fea(nel=NEL, weak_bc=True, sym=sym)
    if method is not None:
        fea.linear_solver = LinearSolver(method)
    assert fea.bc == [] and len(fea.states_dict["u"]["residual_form"]
                                .integrals) == 2
    v, g = _run(fea, d["W"], FEAModel, Simulator, "l2_functional", 0.5)
    jv, jg = _run(jfea, jd["W"], JFEAModel, JSimulator, "l2_functional",
                  0.5)
    assert abs(v - jv) <= 1e-12 * abs(jv)
    assert _rel(g, jg) <= 1e-10
    # and the states themselves
    np.testing.assert_allclose(d["u"].array.numpy(),
                               np.asarray(jd["u"].array), rtol=0,
                               atol=1e-12 * np.abs(jd["u"].array).max())


@pytest.mark.parametrize("sym", [True, False])
def test_w2_nitsche_snes_matches_jax(sym):
    fea, W = _w2("torch", NEL, sym, device="cpu")
    jfea, jW = _w2("jax", NEL, sym)
    v, g = _run(fea, W, FEAModel, Simulator, "J", 1.0)
    jv, jg = _run(jfea, jW, JFEAModel, JSimulator, "J", 1.0)
    assert abs(v - jv) <= 1e-12 * abs(jv)
    assert _rel(g, jg) <= 1e-10
    assert fea._state_op("u").newton_opts["line_search"] == "bt"
