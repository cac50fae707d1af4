"""Motor optimization step: shape dv + current -> mesh motion ->
magnetostatics -> losses, with the IFT gradient (port of
femo_tpu/models/motor/model.py, the block-Thomas branch of
`build_motor_jit_step`).
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import config, get_device
from ...fea.assemble import compile_form
from ...fea.bc import DirichletBC, bc_arrays
from ...fea.forms import GlobalCoefficient
from ...fea.space import Function, FunctionSpace
from ...graph.implicit import implicit_solve_bt
from ...ops.block_tridiag import BlockTridiagTemplate
from .mesh import RADII, create_motor_mesh
from .pde import (
    NTAGS, b_power_form, em_residual_form, mesh_motion_residual_form,
    power_losses, source_tables,
)
from .permeability import PiecewiseBHCurve


def _on_iface(Vmm):
    r = np.linalg.norm(Vmm.scalar_dof_coords, axis=1)
    return (np.isclose(r, RADII["r2"], atol=1e-9)
            | np.isclose(r, RADII["r3"], atol=1e-9))


def boundary_displacement_basis(mesh, Vmm):
    """Two displacement basis fields on the magnet-ring interface nodes:
    radial expansion and tangential shift, as an (n_dofs, 2) tensor."""
    coords = Vmm.scalar_dof_coords
    r = np.linalg.norm(coords, axis=1)
    on_iface = _on_iface(Vmm)
    rad = np.zeros((Vmm.n_dofs,))
    tan = np.zeros((Vmm.n_dofs,))
    rr = np.where(r > 0, r, 1.0)
    nx, ny = coords[:, 0] / rr, coords[:, 1] / rr
    rad[0::2] = np.where(on_iface, nx, 0.0)
    rad[1::2] = np.where(on_iface, ny, 0.0)
    tan[0::2] = np.where(on_iface, -ny, 0.0)
    tan[1::2] = np.where(on_iface, nx, 0.0)
    return torch.as_tensor(np.stack([rad, tan], axis=1), dtype=config.dtype,
                           device=Vmm.device)


def edge_delta_design_space(mesh, Vmm):
    """Per-interface-node design space: dv is the flat vector of (x, y)
    displacement deltas of every magnet-ring interface node, scattered
    into the full CG1 uhat_bc vector.

    Returns (scatter_fn, n_dv, iface_nodes, dofs): scatter_fn(dv) ->
    uhat_bc (Vmm.n_dofs,) out of place (differentiable); dv layout is
    [dx_0, dy_0, dx_1, dy_1, ...] over interface nodes in index order and
    `dofs` the matching interleaved dof index tensor."""
    iface_nodes = np.nonzero(_on_iface(Vmm))[0]
    dofs = np.stack([2 * iface_nodes, 2 * iface_nodes + 1],
                    axis=1).reshape(-1)
    dofs_t = torch.as_tensor(dofs, device=Vmm.device)
    n_dofs = Vmm.n_dofs

    def scatter(dv):
        zeros = torch.zeros(n_dofs, dtype=dv.dtype, device=dv.device)
        return zeros.index_put((dofs_t,), dv)

    return scatter, int(dofs.size), iface_nodes, dofs_t


def build_motor_jit_step(refine: float = 1, em_load_steps: int = 3,
                         mm_newton_iters: int = 3, em_newton_iters: int = 3,
                         frequency: float = 300.0,
                         factorization: str = "block_thomas",
                         pcg_iters: int = 8,
                         factor_method: str = "thomas",
                         refactor_every: int = 1,
                         device_mesh=None,
                         design_space: str = "edge_deltas", mesh=None,
                         device=None):
    """The motor opt iteration: (shape_dv, iq) -> (loss, (g_dv, g_iq)).

    Both implicit solves use the block-Thomas factorization with the CUDA
    sweep kernels (CPU tensors take the plain sweeps).  Returns
    (step, (dv0, iq0), info); info carries the mesh, the spaces,
    `bt = {"mm": {nb, B, bw}, "em": {nb, B, bw}}` and, for checks of the
    factors the step works with, `jac = {"mm"|"em": (template,
    jac_blocks(u, inputs))}`.

    The design space is "edge_deltas": one (dx, dy) per magnet-ring
    interface node.  Only factorization="block_thomas" without
    device_mesh is ported.  `device` defaults to `config.device` (the
    card).
    """
    if design_space != "edge_deltas":
        raise ValueError(f"design_space={design_space!r}: only "
                         "'edge_deltas' is ported")
    if factorization != "block_thomas":
        raise ValueError(f"factorization={factorization!r}: only "
                         "'block_thomas' is ported")
    if device_mesh is not None:
        raise ValueError("device_mesh (sharded assembly) is not ported")
    device = get_device(device)
    dt = config.dtype
    if mesh is None:
        mesh = create_motor_mesh(refine)
    Vmm = FunctionSpace(mesh, ("CG", 1), ncomp=2, device=device)
    Vem = FunctionSpace(mesh, ("CG", 1), device=device)
    uhat = Function(Vmm, "uhat")
    uhat_bc = Function(Vmm, "uhat_bc")
    A_z = Function(Vem, "A_z")
    Htable = GlobalCoefficient("Htable", np.zeros((NTAGS, 2)), device)
    Jtable = GlobalCoefficient("Jtable", np.zeros(NTAGS), device)
    bh = PiecewiseBHCurve()

    mm_cf = compile_form(mesh_motion_residual_form(uhat, uhat_bc))
    em_cf = compile_form(em_residual_form(A_z, uhat, Htable, Jtable, bh))
    eddy_cf = compile_form(b_power_form(A_z, uhat, 2.0, (1, 2)))
    hyst_cf = compile_form(b_power_form(A_z, uhat, 1.76835, (1, 2)))

    on_rim = lambda x: (
        np.isclose(np.hypot(x[0], x[1]), RADII["r0"], atol=1e-9)
        | np.isclose(np.hypot(x[0], x[1]), RADII["r6"], atol=1e-9))
    free_mm, bv_mm = bc_arrays(
        [DirichletBC(Vmm, 0.0, where=on_rim)], Vmm.n_dofs, device)
    free_em, bv_em = bc_arrays(
        [DirichletBC(Vem, 0.0, where=on_rim)], Vem.n_dofs, device)

    # dv0: the radial/tangential boundary displacement (5e-4, 3e-4) at the
    # interface nodes, on the host as the JAX package computes it
    basis = boundary_displacement_basis(mesh, Vmm)
    to_bc, _, _, iface_dofs = edge_delta_design_space(mesh, Vmm)
    dv0 = torch.as_tensor(
        (basis.cpu().numpy() @ np.array([5e-4, 3e-4]))[
            iface_dofs.cpu().numpy()], dtype=dt, device=device)

    bt_info = {}
    tpl_mm = BlockTridiagTemplate(mm_cf.matrix_pattern("uhat"),
                                  free=free_mm.cpu().numpy(), device=device)
    bt_info["mm"] = dict(nb=tpl_mm.nb, B=tpl_mm.B, bw=tpl_mm.bw)

    def mm_vals(u, p):
        return {"uhat": u, "uhat_bc": p["uhat_bc"]}

    def mm_jac(u, p):
        return [(b.A, b.rows, b.cols)
                for b in mm_cf.matrix(mm_vals(u, p), "uhat").blocks]

    solve_mm = implicit_solve_bt(
        lambda u, p: mm_cf.vector(mm_vals(u, p)), mm_jac,
        tpl_mm, free_mm, bv_mm, newton_iters=mm_newton_iters, load_steps=2,
        pcg_iters=pcg_iters, factor_method=factor_method,
        refactor_every=refactor_every)

    def em_vals(u, p):
        return {"A_z": u, "uhat": p["uhat"], "Htable": p["Htable"],
                "Jtable": p["Jtable"]}

    def em_scale(p, s):
        return {"uhat": p["uhat"], "Htable": p["Htable"] * s,
                "Jtable": p["Jtable"] * s}

    def em_jac(u, p):
        return [(b.A, b.rows, b.cols)
                for b in em_cf.matrix(em_vals(u, p), "A_z").blocks]

    tpl_em = BlockTridiagTemplate(em_cf.matrix_pattern("A_z"),
                                  free=free_em.cpu().numpy(), device=device)
    bt_info["em"] = dict(nb=tpl_em.nb, B=tpl_em.B, bw=tpl_em.bw)
    solve_em = implicit_solve_bt(
        lambda u, p: em_cf.vector(em_vals(u, p)), em_jac,
        tpl_em, free_em, bv_em, newton_iters=em_newton_iters,
        load_steps=em_load_steps, scale_inputs=em_scale,
        pcg_iters=pcg_iters, factor_method=factor_method,
        refactor_every=refactor_every)

    def loss_of(dv, iq):
        uh = solve_mm({"uhat_bc": to_bc(dv)},
                      torch.zeros(Vmm.n_dofs, dtype=dt, device=device))
        Ht, Jt = source_tables(iq, torch.zeros((), dtype=dt, device=device))
        az = solve_em({"uhat": uh, "Htable": Ht, "Jtable": Jt},
                      torch.zeros(Vem.n_dofs, dtype=dt, device=device))
        be = eddy_cf.scalar({"A_z": az, "uhat": uh})
        bhy = hyst_cf.scalar({"A_z": az, "uhat": uh})
        eddy, hyst = power_losses(be, bhy, frequency=frequency)
        return eddy + hyst

    def step(dv, iq):
        dv = dv.detach().requires_grad_(True)
        iq = iq.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_of(dv, iq)
            g_dv, g_iq = torch.autograd.grad(loss, (dv, iq))
        return loss.detach(), (g_dv, g_iq)

    iq0 = torch.as_tensor(1e5, dtype=dt, device=device)
    return step, (dv0, iq0), dict(
        mesh=mesh, Vmm=Vmm, Vem=Vem, bt=bt_info,
        jac={"mm": (tpl_mm, mm_jac), "em": (tpl_em, em_jac)})
