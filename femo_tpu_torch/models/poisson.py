"""Poisson source-control model, workload W1 (port of
femo_tpu/models/poisson.py::build_fea).

-lap(u) = f on the unit square with u = 0 on the boundary (strong BC), a
CG1 state u and a DG0 control f; the objective is L2 tracking of the
manufactured state plus Tikhonov regularization of f.  The weak-BC
(Nitsche) variant and the jitted opt step (`build_jit_opt_step`) are not
ported and raise.
"""

from __future__ import annotations

import numpy as np

from ..config import get_device
from ..fea.fea import FEA
from ..fea.forms import FormDef, dot, dx, grad
from ..fea.space import Function, FunctionSpace
from ..mesh.generators import create_unit_square_mesh

PI = np.pi
ALPHA = 1e-6


def interior_residual(w, g):
    """inner(grad u, grad v) - f v."""
    return dot(grad(w.u), grad(w.v)) - w.f * w.v


def tracking_objective(w, g):
    return 0.5 * (w.u - w.u_ex) ** 2 + ALPHA / 2 * w.f ** 2


def on_boundary(x):
    return (np.isclose(x[0], 0) | np.isclose(x[0], 1)
            | np.isclose(x[1], 0) | np.isclose(x[1], 1))


def build_fea(nel: int = 16, weak_bc: bool = False, sym: bool = True,
              device=None):
    """The W1 FEA problem (named registry) on an nel x nel unit square,
    on `device` (default `config.device`, the card).  Returns (fea,
    dict(u, f, u_ex, f_ex, V, W, mesh))."""
    if weak_bc:
        raise NotImplementedError(
            "weak_bc=True (the Nitsche boundary terms) is not ported")
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

    fea = FEA(mesh)
    fea.add_strong_bc(0.0, [on_boundary], V)
    residual = FormDef([dx(interior_residual)], coeffs=[u, f], test=V)
    objective = FormDef([dx(tracking_objective)], coeffs=[u, f, u_ex])

    fea.add_input("f", f)
    fea.add_state("u", u, residual, ["f"])
    fea.add_output("l2_functional", "scalar", objective, ["f", "u"])
    return fea, dict(u=u, f=f, u_ex=u_ex, f_ex=f_ex, V=V, W=W, mesh=mesh)
