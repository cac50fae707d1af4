"""Euler-Bernoulli cantilever beam with Hermite cubic elements, workload
W3 (port of femo_tpu/models/beam.py).

4th-order PDE (EI(t) u'')'' = 0 with a point load at the tip; the
thickness t is a DG0 design field; compliance objective and a volume
constraint.
"""

from __future__ import annotations

import numpy as np

from ..config import get_device
from ..elements.element import Element
from ..fea.fea import FEA
from ..fea.forms import FormDef, ds, dx, hess
from ..fea.space import Function, FunctionSpace
from ..mesh.generators import create_interval_mesh

# OpenMDAO's optimum at 50 elements (openmdao.org beam_optimization
# example), the correctness oracle of the thickness optimization
OPENMDAO_THICK_REF = np.array([
    0.14915754, 0.14764328, 0.14611321, 0.14456715, 0.14300421, 0.14142417,
    0.13982611, 0.13820976, 0.13657406, 0.13491866, 0.13324268, 0.13154528,
    0.12982575, 0.12808305, 0.12631658, 0.12452477, 0.12270701, 0.12086183,
    0.11898809, 0.11708424, 0.11514904, 0.11318072, 0.11117762, 0.10913764,
    0.10705891, 0.10493903, 0.10277539, 0.10056526, 0.09830546, 0.09599246,
    0.09362243, 0.09119084, 0.08869265, 0.08612198, 0.08347229, 0.08073573,
    0.07790323, 0.07496382, 0.07190453, 0.06870925, 0.0653583, 0.06182632,
    0.05808044, 0.05407658, 0.04975295, 0.0450185, 0.03972912, 0.03363155,
    0.02620192, 0.01610863,
])


def build_beam_problem(nel: int = 50, E: float = 1.0, L: float = 1.0,
                       b: float = 0.1, h0: float = 0.1,
                       tip_load: float = -1.0, device=None):
    """The W3 FEA problem on `device` (default `config.device`, the
    card).  Returns (fea, dict(u, t, V, W, mesh, b, L, h0))."""
    device = get_device(device)
    mesh = create_interval_mesh(nel, 0.0, L)
    mesh.mark_boundary_facets(100, lambda x: np.isclose(x[0], L))

    V = FunctionSpace(mesh, Element("interval", "Hermite", 3),
                      device=device)
    W = FunctionSpace(mesh, ("DG", 0), device=device)
    u = Function(V, "displacements")
    t = Function(W, "thickness")
    t.set(h0)

    def interior(w, g):
        # EI(t) u'' v''  with  EI = E b t^3 / 12
        EI = E * b * w.thickness ** 3 / 12.0
        upp = hess(w.displacements)[0, 0]
        vpp = hess(w.v)[0, 0]
        return vpp * (EI * upp)

    def tip(w, g):
        return -tip_load * w.v

    residual = FormDef([dx(interior), ds(tip, tag=100)],
                       coeffs=[u, t], test=V)

    compliance = FormDef(
        [ds(lambda w, g: tip_load * w.displacements, tag=100)],
        coeffs=[u])
    volume = FormDef([dx(lambda w, g: w.thickness * b * L)], coeffs=[t])

    fea = FEA(mesh)
    fea.add_input("thickness", t, init_val=h0)
    fea.add_state("displacements", u, residual, ["thickness"])
    fea.add_output("compliance", "scalar", compliance,
                   ["thickness", "displacements"])
    fea.add_output("volume", "scalar", volume, ["thickness"])

    # clamp the value and derivative dofs at x = 0
    fea.add_strong_bc(0.0, [lambda x: np.isclose(x[0], 0.0)], V)
    return fea, dict(u=u, t=t, V=V, W=W, mesh=mesh, b=b, L=L, h0=h0)
