"""Poisson source-control model, workload W1 (port of
femo_tpu/models/poisson.py).

-lap(u) = f on the unit square with u = 0 on the boundary, a CG1 state
u and a DG0 control f; the objective is L2 tracking of the manufactured
state plus Tikhonov regularization of f.  The boundary condition is
strong, or weak (`weak_bc=True`: symmetric or nonsymmetric Nitsche
terms on the boundary facets).

* `build_fea` — the problem in the named FEA registry (graph API path).
* `build_jit_opt_step` — the opt step f -> (J, dJ/df) as one function:
  matrix-free Newton-Krylov forward (`implicit_solve_jit`) or a dense-LU
  Newton step (`implicit_solve_dense`), each with its IFT adjoint.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config, get_device
from ..fea.assemble import compile_form
from ..fea.bc import DirichletBC, bc_arrays
from ..fea.fea import FEA
from ..fea.forms import FormDef, dot, ds, dx, grad
from ..fea.space import Function, FunctionSpace
from ..graph.implicit import implicit_solve_dense, implicit_solve_jit
from ..mesh.generators import create_unit_square_mesh

PI = np.pi
ALPHA = 1e-6


def interior_residual(w, g):
    """inner(grad u, grad v) - f v."""
    return dot(grad(w.u), grad(w.v)) - w.f * w.v


def nitsche_boundary_residual(u_exact_fn, sym=True, beta=0.1):
    """Nitsche weak-BC boundary term: consistency, (anti)symmetry and a
    beta / h penalty toward u_exact_fn(g.x)."""
    sgn = 1.0 if sym else -1.0

    def bdry(w, g):
        ue = u_exact_fn(g.x)
        return (
            sgn * (ue - w.u) * dot(grad(w.v), g.n)
            - dot(grad(w.u), g.n) * w.v
            + beta / g.h * (w.u - ue) * w.v
        )

    return bdry


def u_exact(x):
    """The manufactured state sin(pi x) sin(pi y) / (2 pi^2) at a point
    (a tensor, inside integrands)."""
    return torch.sin(PI * x[0]) * torch.sin(PI * x[1]) / (2 * PI**2)


def tracking_objective(w, g):
    return 0.5 * (w.u - w.u_ex) ** 2 + ALPHA / 2 * w.f ** 2


def on_boundary(x):
    return (np.isclose(x[0], 0) | np.isclose(x[0], 1)
            | np.isclose(x[1], 0) | np.isclose(x[1], 1))


def build_fea(nel: int = 16, weak_bc: bool = False, sym: bool = True,
              device=None):
    """The W1 FEA problem (named registry) on an nel x nel unit square,
    on `device` (default `config.device`, the card); weak_bc: Nitsche
    boundary terms (symmetric with sym=True) on the boundary facets
    (tag 1) instead of the strong BC.  Returns (fea, dict(u, f, u_ex,
    f_ex, V, W, mesh))."""
    device = get_device(device)
    mesh = create_unit_square_mesh(nel)
    V = FunctionSpace(mesh, ("CG", 1), device=device)
    W = FunctionSpace(mesh, ("DG", 0), device=device)
    u, f = Function(V, "u"), Function(W, "f")
    u_ex = Function(V, "u_ex").interpolate(
        lambda x: 1 / (2 * PI**2) * np.sin(PI * x[0]) * np.sin(PI * x[1]))
    f_ex = Function(W, "f_ex").interpolate(
        lambda x: 1 / (1 + ALPHA * 4 * PI**4)
        * np.sin(PI * x[0]) * np.sin(PI * x[1]))

    integrals = [dx(interior_residual)]
    fea = FEA(mesh)
    if weak_bc:
        mesh.mark_boundary_facets(1)
        integrals.append(
            ds(nitsche_boundary_residual(u_exact, sym=sym), tag=1))
    else:
        fea.add_strong_bc(0.0, [on_boundary], V)
    residual = FormDef(integrals, coeffs=[u, f], test=V)
    objective = FormDef([dx(tracking_objective)], coeffs=[u, f, u_ex])

    fea.add_input("f", f)
    fea.add_state("u", u, residual, ["f"])
    fea.add_output("l2_functional", "scalar", objective, ["f", "u"])
    return fea, dict(u=u, f=f, u_ex=u_ex, f_ex=f_ex, V=V, W=W, mesh=mesh)


def build_jit_opt_step(nel: int = 64, device_mesh=None, solver: str = "cg",
                       device=None):
    """The W1 opt step f -> (J, dJ/df) as one function, on `device`.

    solver "cg": matrix-free Newton-Krylov (at most 3 Newton iterations,
    CG to 1e-12 in f64) with the CG transpose adjoint; "dense": one
    dense-LU Newton step.  device_mesh (sharded assembly) is not ported:
    distribution is a later slice.  Returns (step, f0), step(f) ->
    (J, dJ/df) as tensors.
    """
    if device_mesh is not None:
        raise NotImplementedError(
            "device_mesh (sharded assembly) is not ported")
    if solver not in ("cg", "dense"):
        raise ValueError(f"solver={solver!r}: 'cg' or 'dense'")
    device = get_device(device)
    mesh = create_unit_square_mesh(nel)
    V = FunctionSpace(mesh, ("CG", 1), device=device)
    W = FunctionSpace(mesh, ("DG", 0), device=device)
    u, f = Function(V, "u"), Function(W, "f")
    u_ex = Function(V, "u_ex").interpolate(
        lambda x: 1 / (2 * PI**2) * np.sin(PI * x[0]) * np.sin(PI * x[1]))

    residual = FormDef([dx(interior_residual)], coeffs=[u, f], test=V)
    objective = FormDef([dx(tracking_objective)], coeffs=[u, f, u_ex])
    rcf, jcf = compile_form(residual), compile_form(objective)
    bc = DirichletBC(V, 0.0, where=on_boundary)
    free, bvals = bc_arrays([bc], V.n_dofs, device)

    def rfn(uu, p):
        return rcf.vector({"u": uu, "f": p["f"]})

    f64 = config.dtype == torch.float64
    if solver == "dense":
        solve = implicit_solve_dense(
            rfn, lambda uu, p: rcf.matrix({"u": uu, "f": p["f"]},
                                          "u").to_dense(),
            free, bvals, newton_iters=1)
    else:
        solve = implicit_solve_jit(
            rfn, free, bvals,
            newton_opts={"maxiter": 3,
                         "rtol": 1e-10 if f64 else 1e-5,
                         "atol": 1e-12 if f64 else 1e-7,
                         "krylov_rtol": 1e-12 if f64 else 1e-6,
                         "krylov_maxiter": 3000})

    def step(farr):
        farr = farr.detach().requires_grad_(True)
        with torch.enable_grad():
            uu = solve({"f": farr}, torch.zeros(V.n_dofs, dtype=config.dtype,
                                                device=device))
            J = jcf.scalar({"u": uu, "f": farr, "u_ex": u_ex.array})
            (g,) = torch.autograd.grad(J, farr)
        return J.detach(), g

    f0 = torch.full((W.n_dofs,), 0.5, dtype=config.dtype, device=device)
    return step, f0
