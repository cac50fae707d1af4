"""Nonlinear Poisson source-control optimization with Nitsche weak BCs
(W2; port of examples/run_nonlinear_poisson_opt.py: u^3 nonlinearity,
symmetric Nitsche boundary residual, manufactured solution).

python -m femo_tpu_torch.examples.run_nonlinear_poisson_opt --nel 16
"""

import argparse

import numpy as np
import torch

from femo_tpu_torch.fea import (
    FEA, FunctionSpace, Function, FormDef, dx, ds, grad, dot,
    create_unit_square_mesh, errorNorm,
)
from femo_tpu_torch.graph.model import FEAModel
from femo_tpu_torch.graph.optimizer import OptimizationProblem, SLSQP
from femo_tpu_torch.graph.simulator import Simulator

PI = np.pi
BETA = 10.0  # Nitsche penalty (reference beta_value=1e1)


def u_exact_np(x):
    return np.sin(2 * PI * x[0]) * np.sin(PI * x[1])


def f_exact_np(x):
    return 5 * PI**2 * np.sin(2 * PI * x[0]) * np.sin(PI * x[1]) \
        + u_exact_np(x) ** 3


def build(nel):
    mesh = create_unit_square_mesh(nel)
    mesh.mark_boundary_facets(1)
    V = FunctionSpace(mesh, ("CG", 1))
    W = FunctionSpace(mesh, ("DG", 0))
    u, f = Function(V, "u"), Function(W, "f")

    def u_exact_t(x):
        return torch.sin(2 * PI * x[0]) * torch.sin(PI * x[1])

    def interior(w, g):
        return dot(grad(w.u), grad(w.v)) + w.u**3 * w.v - w.f * w.v

    def boundary(w, g):
        # symmetric Nitsche: consistency + adjoint-consistency + penalty
        ue = u_exact_t(g.x)
        return (-dot(grad(w.u), g.n) * w.v
                + (ue - w.u) * dot(grad(w.v), g.n)
                + BETA / g.h * (w.u - ue) * w.v)

    residual = FormDef([dx(interior), ds(boundary, tag=1)],
                       coeffs=[u, f], test=V)
    u_ex = Function(V, "u_ex").interpolate(u_exact_np)
    obj = FormDef(
        [dx(lambda w, g: 0.5 * (w.u - w.u_ex) ** 2 + 3e-7 * w.f**2)],
        coeffs=[u, u_ex, f])

    fea = FEA(mesh)
    fea.PDE_SOLVER = "SNES"  # backtracking line search
    fea.add_input("f", f)
    fea.add_state("u", u, residual, ["f"])
    fea.add_output("J", "scalar", obj, ["u", "f"])
    return fea, dict(mesh=mesh, V=V, W=W, u=u, f=f, u_ex=u_ex)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nel", type=int, default=16)
    p.add_argument("--maxiter", type=int, default=100)
    p.add_argument("--record", action="store_true")
    args = p.parse_args(argv)

    fea, d = build(args.nel)
    model = FEAModel(fea=[fea])
    model.create_input("f", shape=d["W"].n_dofs, val=1.0)
    model.add_design_variable("f")
    model.add_objective("J", scaler=1e3)
    sim = Simulator(model)
    sim.run()

    prob = OptimizationProblem(sim, "nonlinear_poisson_opt")
    SLSQP(prob, ftol=1e-13, maxiter=args.maxiter).solve()

    obj = sim["J"]
    print("=" * 40)
    print("Objective value:", obj)
    d["f"].array = sim.values["f"]
    f_ex = Function(d["W"], "f_ex").interpolate(f_exact_np)
    e_f = errorNorm(f_ex, d["f"])
    e_u = errorNorm(d["u_ex"], d["u"])
    print("Error in controls:", e_f)
    print("Error in states:  ", e_u)
    if args.record:
        from femo_tpu_torch.io.xdmf import XDMFWriter

        with XDMFWriter("solutions/nlp_state_u.xdmf", d["mesh"]) as x:
            x.write_function(d["u"])
    return {"objective": float(obj), "error_controls": e_f,
            "error_states": e_u}


if __name__ == "__main__":
    main()
