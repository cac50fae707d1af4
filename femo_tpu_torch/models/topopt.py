"""SIMP/RAMP topology optimization of a 2D cantilever, workload W4 (port
of femo_tpu/models/topopt.py).

Linear elasticity on quads with density-penalized stiffness (SIMP rho^3
or RAMP rho / (1 + 8 (1 - rho))), a traction on the tagged mid-right
boundary facets, a DG0 density design field smoothed by the hat-kernel
density filter, the compliance objective and an average-density
constraint.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config, get_device
from ..fea.fea import FEA
from ..fea.forms import FormDef, Identity, dot, ds, dx, grad, inner, sym, tr
from ..fea.space import Function, FunctionSpace
from ..graph.filters import DensityFilter
from ..graph.model import FEAModel, Operation
from ..mesh.generators import create_rectangle_mesh

TRACTION_TAG = 100


def stiffness_interpolation(rho, method: str = "SIMP"):
    if method == "SIMP":
        return rho ** 3
    # RAMP
    return rho / (1.0 + 8.0 * (1.0 - rho))


def build_topopt_problem(num_el_x: int = 40, num_el_y: int = 20,
                         length_x: float = 160.0, length_y: float = 80.0,
                         method: str = "SIMP", nu: float = 0.3,
                         traction=(0.0, -0.25), cell_type: str = "quad",
                         vol_frac: float = 0.4, filter_beta: float = 2.0,
                         device=None):
    """The W4 FEA problem and its density filter on `device` (default
    `config.device`, the card).  Returns (fea, dict(mesh, V, W, u, rho,
    filter, vol_frac))."""
    device = get_device(device)
    mesh = create_rectangle_mesh(num_el_x, num_el_y, 0.0, 0.0,
                                 length_x, length_y, cell_type=cell_type)
    # traction strip: right edge, centered band one element tall
    band = length_y / num_el_y + 1e-9
    mesh.mark_boundary_facets(
        TRACTION_TAG,
        lambda x: (np.abs(x[1] - length_y / 2) < band)
        & np.isclose(x[0], length_x))

    V = FunctionSpace(mesh, ("CG", 1), ncomp=2, device=device)
    W = FunctionSpace(mesh, ("DG", 0), device=device)
    u = Function(V, "displacements")
    rho = Function(W, "density")
    tvec = torch.as_tensor(traction, dtype=config.dtype, device=device)

    def elasticity(w, g):
        C = stiffness_interpolation(w.density, method)
        E = 1.0 * C
        lam = E * nu / (1 + nu) / (1 - 2 * nu)
        mu = E / 2 / (1 + nu)
        eps_u = sym(grad(w.displacements))
        eps_v = sym(grad(w.v))
        sig = lam * tr(eps_u) * Identity(2) + 2 * mu * eps_u
        return inner(sig, eps_v)

    def load(w, g):
        return -dot(tvec, w.v)

    residual = FormDef([dx(elasticity), ds(load, tag=TRACTION_TAG)],
                       coeffs=[u, rho], test=V)

    compliance = FormDef(
        [ds(lambda w, g: dot(tvec, w.displacements), tag=TRACTION_TAG)],
        coeffs=[u])
    domain_vol = length_x * length_y
    avg_density = FormDef(
        [dx(lambda w, g: w.density / domain_vol)], coeffs=[rho])

    fea = FEA(mesh)
    fea.linear_problem = True
    fea.add_input("density", rho, init_val=vol_frac)
    fea.add_state("displacements", u, residual, ["density"])
    fea.add_output("compliance", "scalar", compliance,
                   ["density", "displacements"])
    fea.add_output("avg_density", "scalar", avg_density, ["density"])
    # clamp the left edge
    fea.add_strong_bc(0.0, [lambda x: np.isclose(x[0], 0.0)], V)

    # density filter over the element centroids (a pre-processor op)
    cents = mesh.coords[mesh.cells].mean(axis=1)
    h_avg = float(mesh.cell_sizes().mean())
    filt = DensityFilter(cents, beta=filter_beta, h_avg=h_avg,
                         device=device)

    return fea, dict(mesh=mesh, V=V, W=W, u=u, rho=rho, filter=filt,
                     vol_frac=vol_frac)


def build_topopt_model(num_el_x: int = 40, num_el_y: int = 20, **kw):
    """FEAModel with the filter chained in front: density_unfiltered
    (the design variable) -> filter -> density (the PDE input).
    Returns (model, fea, d)."""
    fea, d = build_topopt_problem(num_el_x, num_el_y, **kw)
    model = FEAModel(fea=[fea])
    filt = d["filter"]
    model.operations.insert(0, Operation(
        "density_filter_model", lambda x: filt(x),
        ["density_unfiltered"], ["density"]))
    nel = d["W"].n_dofs
    model.create_input("density_unfiltered", shape=nel, val=d["vol_frac"])
    model.add_design_variable("density_unfiltered", lower=1e-3, upper=1.0)
    model.add_objective("compliance")
    model.add_constraint("avg_density", upper=d["vol_frac"], scaler=1.0)
    return model, fea, d
