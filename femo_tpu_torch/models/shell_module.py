"""ShellModule: named-operation composition around the RM shell (port of
femo_tpu/models/shell_module.py).

Aero nodal forces at arbitrary points map onto the shell, the shell
solves, and nodal displacements, stresses, mass and compliance are named
model variables: operations on the generic Model graph, differentiable
end to end through the composite state's IFT adjoint.
"""

from __future__ import annotations

import numpy as np

from ..fea.assemble import compile_form
from ..fea.bc import DirichletBC
from ..fea.composite import composite_implicit_op
from ..fea.project import lumped_mass, project_form
from ..fea.space import FunctionSpace
from ..graph.model import Model
from ..solvers.linear import LinearSolver
from .coupling import NodalMap, force_map_mass_weighted
from .shell import RMShellModel


class ShellModule(Model):
    """Model with shell operations wired by name, on the shell's device.

    Variables:
      thickness (DG0)  [input/design]
      <prefix>nodal_forces (n_aero_pts, 3)  [input]
      -> shell traction 'force', state solve,
      <prefix>nodal_displacements (n_aero_pts, 3),
      mass, compliance, elastic_energy, pnorm_stress, von_mises (CG1)

    solve_mode "jit_bt" (default: the block-Thomas factor, K1/K2 on CUDA
    tensors; the shell is linear, so one Newton step is exact),
    "jit_dense", or "eager" (host Newton with scipy's sparse LU).  The
    solve op writes the solved state back into the shell's fields except
    while the Simulator evaluates derivatives (`Model.pure`), as the JAX
    package's PURE_MODE does.
    """

    def __init__(self, shell: RMShellModel, bcs: list[DirichletBC],
                 aero_points: np.ndarray, pnorm_p: float = 8.0,
                 pnorm_m: float = 1.0, prefix: str = "",
                 solve_mode: str = "jit_bt"):
        super().__init__(device=shell.Vu.device)
        self.shell = shell
        mesh = shell.mesh
        state = shell.make_state(bcs)
        self.state = state
        if solve_mode in ("jit_bt", "jit_dense"):
            op = composite_implicit_op(
                state, ["thickness", "force"],
                newton_opts={"jit_newton_iters": 1}, mode=solve_mode)
        else:
            op = composite_implicit_op(
                state, ["thickness", "force"],
                linear_solver=LinearSolver(method="scipy"),
                newton_opts={"maxiter": 6})
        self.op = op

        shell_pts = mesh.coords
        dev = self.device
        # one RBF map serves both transfers (the JAX package builds two
        # equal ones)
        nmap = NodalMap(shell_pts, np.asarray(aero_points), device=dev)
        area = lumped_mass(shell.Vf)[0::3]
        fmap = force_map_mass_weighted(nmap, area)

        # operation: aero forces -> shell traction field
        self.add_op(f"{prefix}rm_shell_forces",
                    lambda F: fmap(F).reshape(-1),
                    [f"{prefix}nodal_forces"], ["force"])

        # operation: solve the shell
        def solve_op(tarr, farr):
            x = op({"thickness": tarr, "force": farr},
                   state.current().detach())
            if not self.pure:
                state.push(x.detach())
            parts = state.split(x)
            return parts["u"], parts["theta"]

        self.add_op(f"{prefix}rm_shell", solve_op,
                    ["thickness", "force"], ["u", "theta"])

        # operation: displacements at the aero points
        nv = mesh.n_nodes

        def nodal_disp(u):
            return nmap.map_displacements(u.reshape(-1, 3)[:nv])

        self.add_op(f"{prefix}rm_shell_nodal_displacements", nodal_disp,
                    ["u"], [f"{prefix}nodal_displacements"])

        # scalar outputs
        ccf = compile_form(shell.compliance_form)
        mcf = compile_form(shell.mass_form)
        ecf = compile_form(shell.energy_form)
        pcf = compile_form(shell.pnorm_stress_form(p=pnorm_p, m=pnorm_m))

        self.add_op("compliance_op",
                    lambda u, f: ccf.scalar({"u": u, "force": f}),
                    ["u", "force"], ["compliance"])
        self.add_op("mass_op", lambda t: mcf.scalar({"thickness": t}),
                    ["thickness"], ["mass"])
        self.add_op(
            "energy_op",
            lambda u, th, t, f: ecf.scalar(
                {"u": u, "theta": th, "thickness": t, "force": f}),
            ["u", "theta", "thickness", "force"], ["elastic_energy"])
        self.add_op(
            "pnorm_stress_op",
            lambda u, th, t, f: pnorm_m * pcf.scalar(
                {"u": u, "theta": th, "thickness": t,
                 "force": f}) ** (1.0 / pnorm_p),
            ["u", "theta", "thickness", "force"], ["pnorm_stress"])

        # von Mises CG1 field
        Vcg1 = FunctionSpace(mesh, ("CG", 1), device=dev)
        vmform = shell.von_mises_field_form(Vcg1)

        def vm_field(u, th, t):
            return project_form(
                vmform, Vcg1, {"u": u, "theta": th, "thickness": t})

        self.add_op("rm_shell_nodal_stress", vm_field,
                    ["u", "theta", "thickness"], ["von_mises"])

        # defaults
        self.create_input("thickness", shape=shell.Vt.n_dofs,
                          val=float(shell.thickness.array[0]))
        self.create_input(f"{prefix}nodal_forces",
                          val=np.zeros((len(aero_points), 3)))


def extract_cg2_vertex_displacements(Vu_cg2, u_array, n_vertices):
    """CG2 -> CG1 nodal displacements: the CG2 vertex dofs are the leading
    block of the dofmap (vertex, then edge dofs), so the extraction is a
    slice.  The vertex-leading layout is checked against the space's own
    scalar-dof coordinates, so a changed layout raises instead of
    returning the wrong values."""
    el = Vu_cg2.element
    if el.family == "DG" or el.entity_dofs[0] != 1:
        raise ValueError("extract_cg2_vertex_displacements requires a "
                         "Lagrange space with one scalar dof per vertex")
    if not (Vu_cg2.n_scalar_dofs >= n_vertices and np.array_equal(
            Vu_cg2.scalar_dof_coords[:n_vertices], Vu_cg2.mesh.coords)):
        raise ValueError("dof ordering is not vertex-leading; rebuild the "
                         "extraction map")
    return u_array.reshape(-1, el.ncomp)[:n_vertices]


def plate_module(n_shell=(16, 24), span=4.0, chord=1.0, E=7e10, nu=0.3,
                 thickness=0.01, n_aero=(8, 12), force_z=-80.0,
                 solve_mode="jit_bt", device=None):
    """A ShellModule on the compliance step's clamped plate
    (models/shell.py::plate_shell) with an n_aero[0] x n_aero[1] grid of
    aero points over 5-95% of chord and span, and the (n_aero, 3) nodal
    forces of a uniform vertical load `force_z` per point.  Returns
    (module, forces)."""
    from .shell import plate_shell

    shell, bcs = plate_shell(n_shell, span, chord, E, nu, thickness, device)
    xs = np.linspace(0.05, 0.95, n_aero[0]) * chord
    ys = np.linspace(0.05, 0.95, n_aero[1]) * span
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], axis=1)
    F = np.zeros((len(pts), 3))
    F[:, 2] = force_z
    return ShellModule(shell, bcs, pts, solve_mode=solve_mode), F
