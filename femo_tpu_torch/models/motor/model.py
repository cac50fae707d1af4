"""Chained motor optimization model: shape dv + current -> mesh motion ->
magnetostatics -> losses, with the IFT gradient (port of
femo_tpu/models/motor/model.py).

* `build_motor_jit_step` — the fixed-count optimization step (shape_dv,
  iq) -> (loss, grads): both implicit solves through block Thomas
  (`implicit_solve_bt`, with Shamanskii factor reuse) or dense LU
  (`implicit_solve_dense`), on the procedural or an imported mesh.
* `build_motor_model` — the eager graph model (FEA registry, FEAModel):
  boundary_input_model (shape dv -> [ffd ->] uhat_bc) -> the mesh-motion
  state (displacement-stepped continuation) -> source_tables_model ->
  the EM state (load-stepped continuation) -> B-influence, area, torque
  and |B| field outputs -> power_loss_model -> loss_sum.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ...config import config, get_device
from ...fea.assemble import compile_form
from ...fea.bc import DirichletBC, bc_arrays
from ...fea.fea import FEA
from ...fea.forms import GlobalCoefficient
from ...fea.space import Function, FunctionSpace
from ...graph.implicit import implicit_solve_bt, implicit_solve_dense
from ...graph.model import FEAModel, Operation
from ...ops.block_tridiag import BlockTridiagTemplate
from ...solvers.linear import LinearSolver
from .mesh import RADII, MotorTags, create_motor_mesh
from .pde import (
    NTAGS, area_form, b_field_output_form, b_power_form, em_residual_form,
    mesh_motion_residual_form, power_losses, source_tables, torque_form,
)
from .permeability import PiecewiseBHCurve

T = MotorTags


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


def ffd_shape_parameter_layer(mesh, Vmm, n_harmonics: int = 4):
    """A small smooth shape-parameter layer in front of the edge deltas:
    radial Fourier coefficients per interface ring, delta_r(theta) =
    sum_k a_k cos(k theta) + b_k sin(k theta) along the node normal.
    Returns (to_deltas, n_params), to_deltas(params) -> the edge-delta
    vector of edge_delta_design_space."""
    coords = Vmm.scalar_dof_coords
    r = np.linalg.norm(coords, axis=1)
    _, n_dv, iface_nodes, _ = edge_delta_design_space(mesh, Vmm)
    ci = coords[iface_nodes]
    ri = r[iface_nodes]
    th = np.arctan2(ci[:, 1], ci[:, 0])
    ring = np.isclose(ri, RADII["r3"], atol=1e-9).astype(int)  # 0=r2, 1=r3
    # per-ring Fourier design matrix: (n_iface, 2 rings x (2K + 1))
    cols = []
    for rg in (0, 1):
        mask = (ring == rg).astype(float)
        cols.append(mask)
        for k in range(1, n_harmonics + 1):
            cols.append(mask * np.cos(k * th))
            cols.append(mask * np.sin(k * th))
    B = np.stack(cols, axis=1)
    nx, ny = ci[:, 0] / ri, ci[:, 1] / ri
    # the radial direction per node, interleaved into the dv layout
    Bd = np.zeros((n_dv, B.shape[1]))
    Bd[0::2] = B * nx[:, None]
    Bd[1::2] = B * ny[:, None]
    Bd = torch.as_tensor(Bd, dtype=config.dtype, device=Vmm.device)

    def to_deltas(params):
        return Bd @ params

    return to_deltas, int(B.shape[1])


def make_min_detF(mesh, Vmm):
    """min over cells of det(F(uhat)), the element-inversion detector (P1
    gradients are cell-constant: one gather and one einsum)."""
    pts = mesh.coords[mesh.cells]  # (nc, 3, 2)
    e1 = pts[:, 1] - pts[:, 0]
    e2 = pts[:, 2] - pts[:, 0]
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    gx = np.stack([e2[:, 1], -e1[:, 1]], axis=1) / det[:, None]
    gy = np.stack([-e2[:, 0], e1[:, 0]], axis=1) / det[:, None]
    g12 = np.stack([gx, gy], axis=2)  # (nc, 2, 2): rows = ref. basis 1, 2
    g0 = -g12.sum(axis=1)
    # physical gradients of the three P1 basis functions (nc, 3, 2)
    gradN = torch.as_tensor(np.concatenate([g0[:, None, :], g12], axis=1),
                            dtype=config.dtype, device=Vmm.device)
    dofmap = torch.as_tensor(np.asarray(Vmm.dofmap, np.int64),
                             device=Vmm.device)

    def min_detF(uhat_arr):
        ue = uhat_arr[dofmap].reshape(-1, 3, 2)  # (nc, 3 nodes, 2 comps)
        G = torch.einsum("cak,cai->cik", ue, gradN)  # grad uhat (nc, 2, 2)
        detF = (1.0 + G[:, 0, 0]) * (1.0 + G[:, 1, 1]) \
            - G[:, 0, 1] * G[:, 1, 0]
        return torch.min(detF)

    return min_detF


def make_incremental_mm_solver(min_cell: float, min_detF_fn=None):
    """Displacement-stepped continuation of the mesh motion: STEPS =
    max(2, ceil(4 max|uhat_bc| / min_cell)), Newton with backtracking in
    each; warns on a step that does not converge and on inverted cells."""

    def solve_incremental(op, inputs, u0):
        g = inputs["uhat_bc"]
        gmax = float(torch.max(torch.abs(g.detach())))
        steps = max(2, int(np.ceil(4.0 * gmax / min_cell)))
        u = u0
        for k in range(steps):
            scaled = dict(inputs)
            scaled["uhat_bc"] = g * ((k + 1) / steps)
            u, _, info = op.newton(scaled, u, line_search="bt")
            if not info.converged and info.resnorm > 1e-6 * max(
                    info.resnorm0, 1.0):
                warnings.warn(
                    f"mesh-motion continuation step {k + 1}/{steps} did "
                    f"not converge (||R||={info.resnorm:.2e}); the "
                    "prescribed boundary displacement likely crushes the "
                    "mesh — results are unreliable")
        if min_detF_fn is not None:
            mdf = float(min_detF_fn(u.detach()))
            if mdf <= 0.0:
                warnings.warn(
                    f"mesh motion inverted elements (min det(F) = "
                    f"{mdf:.3e}); downstream EM/loss values are invalid")
        return u

    return solve_incremental


def make_incremental_em_solver(n_steps: int = 5, damping: float = 0.8):
    """Load-stepped EM continuation: the source tables scaled by
    (k + 1) / n_steps, damped Newton with backtracking in each step."""

    def solve_incremental(op, inputs, u0):
        u = u0
        for k in range(n_steps):
            s = (k + 1) / n_steps
            scaled = dict(inputs)
            scaled["Htable"] = inputs["Htable"] * s
            scaled["Jtable"] = inputs["Jtable"] * s
            u, _, info = op.newton(scaled, u, damping=damping,
                                   line_search="bt")
            if not info.converged and info.resnorm > 1e-6 * max(
                    info.resnorm0, 1.0):
                warnings.warn(
                    f"EM load step {k + 1}/{n_steps} did not converge "
                    f"(||R||={info.resnorm:.2e})")
        return u

    return solve_incremental


def _on_rim(x):
    r = np.hypot(x[0], x[1])
    return (np.isclose(r, RADII["r0"], atol=1e-9)
            | np.isclose(r, RADII["r6"], atol=1e-9))


def build_motor_model(refine: float = 1, iq0: float = 1.0e5,
                      angle0: float = 0.0, frequency: float = 300.0,
                      linear_solver: LinearSolver | None = None,
                      em_load_steps: int = 5, record: bool = False,
                      design_space: str = "basis",
                      ffd_harmonics: int | None = None,
                      mesh=None, device=None):
    """The eager graph model of the motor optimization (Simulator,
    objective_gradient).  Returns (model, dict(mesh, fea_mm, fea_em, uhat,
    A_z, Vmm, Vem, bh)).

    mesh=None uses the procedural polar mesh; an imported Mesh with the
    motor tag semantics (mesh/gmsh_io.import_mesh) runs the import-first
    path.  linear_solver defaults to LinearSolver("scipy"); "block_thomas"
    runs every Newton and adjoint solve through the sweeps K1/K2 on the
    card.  design_space: "basis" (2 dvs) or "edge_deltas" (one (dx, dy)
    per magnet-ring interface node; with ffd_harmonics, a Fourier layer in
    front).  `device` defaults to `config.device` (the card).  record=True
    writes the |B| field at every run to an XDMF series under
    ./records_motor (io/xdmf.py's Recorder; h5py).
    """
    if design_space not in ("edge_deltas", "basis"):
        raise ValueError(f"unknown design_space {design_space!r}")
    device = get_device(device)
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

    res_mm = mesh_motion_residual_form(uhat, uhat_bc)
    res_em = em_residual_form(A_z, uhat, Htable, Jtable, bh)
    solver = linear_solver or LinearSolver(method="scipy")

    # -- mesh-motion problem ------------------------------------------------
    fea_mm = FEA(mesh)
    fea_mm.linear_solver = solver
    fea_mm.custom_solve = make_incremental_mm_solver(
        mesh.min_cell_size(), make_min_detF(mesh, Vmm))
    fea_mm.add_input("uhat_bc", uhat_bc, init_val=0.0)
    fea_mm.add_state("uhat", uhat, res_mm, ["uhat_bc"])
    fea_mm.add_strong_bc(0.0, [_on_rim], Vmm)

    # -- EM problem, chained: uhat is one of its inputs ----------------------
    fea_em = FEA(mesh)
    fea_em.linear_solver = solver
    fea_em.custom_solve = make_incremental_em_solver(em_load_steps)
    fea_em.add_input("uhat", uhat)
    fea_em.add_input("Htable", Htable)
    fea_em.add_input("Jtable", Jtable)
    fea_em.add_state("A_z", A_z, res_em, ["uhat", "Htable", "Jtable"])
    fea_em.add_strong_bc(0.0, [_on_rim], Vem)

    steel = (T.ROTOR_STEEL, T.STATOR_STEEL)
    fea_em.add_output("B_influence_eddy_current", "scalar",
                      b_power_form(A_z, uhat, 2.0, steel), ["A_z", "uhat"])
    fea_em.add_output("B_influence_hysteresis", "scalar",
                      b_power_form(A_z, uhat, 1.76835, steel),
                      ["A_z", "uhat"])
    magnet_tags = tuple(range(T.MAGNET_FIRST, T.MAGNET_LAST + 1))
    winding_tags = tuple(range(T.WINDING_FIRST, T.WINDING_LAST + 1))
    fea_em.add_output("magnet_area", "scalar",
                      area_form(uhat, magnet_tags), ["uhat"])
    fea_em.add_output("winding_area", "scalar",
                      area_form(uhat, winding_tags), ["uhat"])
    fea_em.add_output("steel_area", "scalar", area_form(uhat, steel),
                      ["uhat"])
    fea_em.add_output("torque", "scalar", torque_form(A_z, uhat),
                      ["A_z", "uhat"])
    # |B| projected to CG1
    Vcg1 = FunctionSpace(mesh, ("CG", 1), device=device)
    fea_em.add_field_output("B_magnitude",
                            b_field_output_form(A_z, uhat, Vcg1),
                            ["A_z", "uhat"], record=record)
    recorder = None
    if record:
        from ...io.xdmf import Recorder

        recorder = Recorder("records_motor")
    model = FEAModel(fea=[fea_mm, fea_em], recorder=recorder)

    # pre-operations: shape dv -> [ffd ->] uhat_bc; (iq, angle) -> tables
    pre_ops = []
    if design_space == "edge_deltas":
        scatter, n_dv, _, _ = edge_delta_design_space(mesh, Vmm)
        if ffd_harmonics:
            to_deltas, dv_shape = ffd_shape_parameter_layer(
                mesh, Vmm, ffd_harmonics)
            pre_ops.append(Operation("ffd_model", to_deltas,
                                     ["shape_dv"], ["edge_deltas"]))
            pre_ops.append(Operation("boundary_input_model", scatter,
                                     ["edge_deltas"], ["uhat_bc"]))
        else:
            pre_ops.append(Operation("boundary_input_model", scatter,
                                     ["shape_dv"], ["uhat_bc"]))
            dv_shape = n_dv
    else:
        basis = boundary_displacement_basis(mesh, Vmm)
        pre_ops.append(Operation("boundary_input_model",
                                 lambda dv: basis @ dv, ["shape_dv"],
                                 ["uhat_bc"]))
        dv_shape = 2
    pre_ops.append(Operation("source_tables_model", source_tables,
                             ["iq", "angle"], ["Htable", "Jtable"]))
    model.operations[:0] = pre_ops

    # post-operations: power losses and their sum
    def loss_fn(be, bhyst):
        eddy, hyst = power_losses(be, bhyst, frequency=frequency)
        return eddy, hyst, eddy + hyst

    model.add_op("power_loss_model", loss_fn,
                 ["B_influence_eddy_current", "B_influence_hysteresis"],
                 ["eddy_current_loss", "hysteresis_loss", "loss_sum"])

    model.create_input("shape_dv", shape=dv_shape, val=0.0)
    model.create_input("iq", shape=(), val=iq0)
    model.create_input("angle", shape=(), val=angle0)
    model.add_design_variable("shape_dv", lower=-0.002, upper=0.002)
    model.add_design_variable("iq", lower=0.0, upper=5e5)
    model.add_objective("loss_sum")

    return model, dict(mesh=mesh, fea_mm=fea_mm, fea_em=fea_em, uhat=uhat,
                       A_z=A_z, Vmm=Vmm, Vem=Vem, bh=bh)


def build_motor_jit_step(refine: float = 1, em_load_steps: int = 3,
                         mm_newton_iters: int = 3, em_newton_iters: int = 3,
                         frequency: float = 300.0,
                         factorization: str = "lu", pcg_iters: int = 8,
                         factor_method: str = "thomas",
                         refactor_every: int = 1,
                         device_mesh=None, design_space: str = "basis",
                         mesh=None, block_size: int | None = None,
                         freeze_operator: bool = False, device=None):
    """The motor opt iteration: (shape_dv, iq) -> (loss, (g_dv, g_iq)).

    Returns (step, (dv0, iq0), info); info carries the mesh, the spaces,
    `bt = {"mm": {nb, B, bw}, "em": {nb, B, bw}}` (empty for "lu") and,
    for block Thomas, `jac = {"mm"|"em": (template, jac_blocks(u,
    inputs))}` for checks of the factors the step works with.

    factorization: "lu" (dense Newton, `implicit_solve_dense`; the JAX
    package's default), "inv" (its explicit-inverse variant) or
    "block_thomas" (`implicit_solve_bt`: the sweeps K1/K2 on the card,
    `pcg_iters` PCG iterations per Newton step, Shamanskii reuse with
    `refactor_every` > 1 and `freeze_operator`, blocks of `block_size`).
    design_space: "basis" (2 dvs, radial and tangential) or "edge_deltas"
    (one (dx, dy) per magnet-ring interface node); dv0 is the same
    boundary displacement in both.  mesh=None uses the procedural polar
    mesh; an imported Mesh with the motor tag semantics runs the
    import-first path.  device_mesh: a `parallel.sharding.RankMesh`; the
    residual, Jacobian and loss assembly then run with the cells sharded
    over its ranks (mode a) and both Newton solves as dense LU, run
    replicated; `factorization` is ignored, as in the JAX package.
    `device` defaults to the rank's with a device_mesh, else to
    `config.device` (the card).
    """
    if refactor_every != 1 and (factorization != "block_thomas"
                                or device_mesh is not None):
        raise ValueError("refactor_every > 1 requires "
                         "factorization='block_thomas' without device_mesh")
    if design_space not in ("edge_deltas", "basis"):
        raise ValueError(f"unknown design_space {design_space!r}")
    if device is None and device_mesh is not None:
        device = device_mesh.device
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

    free_mm, bv_mm = bc_arrays(
        [DirichletBC(Vmm, 0.0, where=_on_rim)], Vmm.n_dofs, device)
    free_em, bv_em = bc_arrays(
        [DirichletBC(Vem, 0.0, where=_on_rim)], Vem.n_dofs, device)

    # dv -> uhat_bc; dv0 is the radial/tangential boundary displacement
    # (5e-4, 3e-4) in both spaces, computed on the host as the JAX package
    # computes it
    basis = boundary_displacement_basis(mesh, Vmm)
    dv0_np = np.array([5e-4, 3e-4])
    if design_space == "edge_deltas":
        to_bc, _, _, iface_dofs = edge_delta_design_space(mesh, Vmm)
        dv0_np = (basis.cpu().numpy() @ dv0_np)[iface_dofs.cpu().numpy()]
    else:
        to_bc = lambda dv: basis @ dv  # noqa: E731
    dv0 = torch.as_tensor(dv0_np, dtype=dt, device=device)

    def mm_vals(u, p):
        return {"uhat": u, "uhat_bc": p["uhat_bc"]}

    def em_vals(u, p):
        return {"A_z": u, "uhat": p["uhat"], "Htable": p["Htable"],
                "Jtable": p["Jtable"]}

    def em_scale(p, s):
        return {"uhat": p["uhat"], "Htable": p["Htable"] * s,
                "Jtable": p["Jtable"] * s}

    mm = dict(cf=mm_cf, vals=mm_vals, wrt="uhat", free=free_mm, bv=bv_mm,
              newton_iters=mm_newton_iters, load_steps=2, scale=None)
    em = dict(cf=em_cf, vals=em_vals, wrt="A_z", free=free_em, bv=bv_em,
              newton_iters=em_newton_iters, load_steps=em_load_steps,
              scale=em_scale)
    bt_info, jac_info = {}, {}

    def eddy_fn(vals):  # looked up at each call, as the profiler wraps it
        return eddy_cf.scalar(vals)

    def hyst_fn(vals):
        return hyst_cf.scalar(vals)

    if device_mesh is not None:
        from ...parallel.sharding import (
            sharded_matrix_dense_fn, sharded_scalar_fn, sharded_vector_fn)

        for c in (mm, em):
            c["vector"] = sharded_vector_fn(c["cf"], device_mesh)
            c["dense"] = sharded_matrix_dense_fn(c["cf"], device_mesh,
                                                 c["wrt"])
        eddy_fn = sharded_scalar_fn(eddy_cf, device_mesh)
        hyst_fn = sharded_scalar_fn(hyst_cf, device_mesh)

    def implicit(name, c):
        def residual(u, p):
            return c.get("vector", c["cf"].vector)(c["vals"](u, p))

        counts = dict(newton_iters=c["newton_iters"],
                      load_steps=c["load_steps"], scale_inputs=c["scale"])
        if device_mesh is not None:
            return implicit_solve_dense(
                residual, lambda u, p: c["dense"](c["vals"](u, p)),
                c["free"], c["bv"], **counts)
        if factorization != "block_thomas":
            return implicit_solve_dense(
                residual, lambda u, p: c["cf"].matrix(
                    c["vals"](u, p), c["wrt"]).to_dense(),
                c["free"], c["bv"], factorization=factorization, **counts)

        def jac_blocks(u, p):
            return [(b.A, b.rows, b.cols) for b in c["cf"].matrix(
                c["vals"](u, p), c["wrt"]).blocks]

        tpl = BlockTridiagTemplate(c["cf"].matrix_pattern(c["wrt"]),
                                   free=c["free"].cpu().numpy(),
                                   block=block_size, device=device)
        bt_info[name] = dict(nb=tpl.nb, B=tpl.B, bw=tpl.bw)
        jac_info[name] = (tpl, jac_blocks)
        return implicit_solve_bt(
            residual, jac_blocks, tpl, c["free"], c["bv"],
            pcg_iters=pcg_iters, factor_method=factor_method,
            refactor_every=refactor_every, freeze_operator=freeze_operator,
            **counts)

    solve_mm = implicit("mm", mm)
    solve_em = implicit("em", em)

    def loss_of(dv, iq):
        uh = solve_mm({"uhat_bc": to_bc(dv)},
                      torch.zeros(Vmm.n_dofs, dtype=dt, device=device))
        Ht, Jt = source_tables(iq, torch.zeros((), dtype=dt, device=device))
        az = solve_em({"uhat": uh, "Htable": Ht, "Jtable": Jt},
                      torch.zeros(Vem.n_dofs, dtype=dt, device=device))
        be = eddy_fn({"A_z": az, "uhat": uh})
        bhy = hyst_fn({"A_z": az, "uhat": uh})
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
    info = dict(mesh=mesh, Vmm=Vmm, Vem=Vem, bt=bt_info)
    if jac_info:
        info["jac"] = jac_info
    return step, (dv0, iq0), info
