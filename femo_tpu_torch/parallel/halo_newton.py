"""Distributed Newton solves on the dof-sharded halo layout: mode b inside
the motor step (port of femo_tpu/parallel/halo_newton.py).

Each rank is a process (`launch.spawn`) with a `sharding.RankMesh`.  For
any compiled form (cell, exterior- and interior-facet terms):

  * the halo operator (parallel/halo.py, `HaloShardedOperator.from_terms`)
    lays the dofs out from every term's RCB-ordered, equal-chunk entity
    partition, so the interior-facet Nitsche coupling rides the same
    halo exchanges as the cell terms;
  * each Newton iteration every rank assembles the Jacobian blocks of its
    own entities only (`_Term.matrix_blocks` on its views, masked), one
    element block per term, and solves the constrained system with a
    distributed Krylov method on owned slots: CG (SPD Jacobians, its dots
    on the halo exchanges) or restarted GMRES (nonsymmetric ones, CGS2
    with batched all-reduces), both point-Jacobi preconditioned, each
    product K4 once per term block between a forward and a reverse halo
    exchange;
  * the continuation is graph/implicit.py's (`load_steps` x
    `newton_iters` Newton updates, the inputs scaled by (k // newton_iters
    + 1) / load_steps), and the solve is a `torch.autograd.Function` whose
    backward assembles the Jacobian at the returned state and solves the
    transpose system with the same Krylov method (K4T), then takes the
    residual's VJP in the inputs through the cells-sharded residual (mode
    a, `sharding.sharded_vector_fn`).

`build_motor_halo_step` composes the motor: mesh motion by GMRES (the
Nitsche sliding-interface terms make its Jacobian nonsymmetric), then
magnetostatics by CG, the losses cells-sharded.

The adjoint assembles at the returned state, where the single-device
step's adjoint reuses the last Newton factor (the Jacobian at the state
before the last update): the two gradients agree only once Newton has
converged (n6), and differ by a few 1e-2 at the dryrun's n2, in both
packages.

Departures: the ranks are processes, not `shard_map` devices (see
parallel/halo.py); GMRES orthogonalizes by CGS2 with one all-reduce a
pass (`HaloShardedOperator.gmres`), and CG carries its dots on its
exchanges (`HaloShardedOperator.cg`): the same Krylov spaces, other
rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config
from ..fea.bc import apply_bc, constrain_residual
from ..graph.implicit import _ift_solve, _load_scaler, _vjp_inputs
from .halo import HaloShardedOperator
from .sharding import RankMesh, sharded_scalar_fn, sharded_vector_fn


def _rank_mesh(device_mesh) -> RankMesh:
    if not isinstance(device_mesh, RankMesh):
        raise ValueError("the halo steps are SPMD-only: pass device_mesh, "
                         "a RankMesh of ranks started by launch.spawn")
    return device_mesh


def build_halo_newton_solver(cf, state_name: str, free, bc_values,
                             device_mesh, vals_of=None,
                             newton_iters: int = 3, load_steps: int = 1,
                             scale_inputs=None, cg_rtol: float = 1e-12,
                             cg_maxiter: int = 20000,
                             krylov: str = "cg", restart: int = 50):
    """The distributed implicit solve of one state of a compiled form, on
    this rank of `device_mesh` (every rank calls it, and every function it
    returns, in the same order).

    cf: the CompiledForm of the residual R(u, inputs); state_name: the
    coefficient solved for; vals_of(u, inputs) -> the form's values
    (default {state_name: u, **inputs}); scale_inputs(inputs, s): a load
    step's inputs (default: every input times s).  krylov: "cg" or
    "gmres" (restarted GMRES(restart)); both stop at cg_rtol of ||b|| or
    after cg_maxiter iterations (GMRES: ceil(cg_maxiter / restart)
    cycles).

    Returns (solve, aux): solve(inputs: dict, u0) -> u, differentiable in
    the inputs; aux holds `halo_cg(values, b, transpose=False) -> (x, k)`
    (the Krylov solve of the constrained Jacobian at `values`, or of its
    transpose; k the CG iterations or GMRES cycles), `halo_apply(values,
    x)` (the constrained Jacobian's product), `info` (the layout's L, G,
    n_owned, owned_global and every rank's ghost count, `ghosts`), `op`
    (the HaloShardedOperator) and `counts`, the k of every halo_cg in
    order."""
    if krylov not in ("cg", "gmres"):
        raise ValueError(f"krylov={krylov!r}: 'cg' or 'gmres'")
    mesh = _rank_mesh(device_mesh)
    vals_of = vals_of or (lambda u, p: {state_name: u, **p})
    op = HaloShardedOperator.from_terms(cf.terms, state_name,
                                        cf.form.test.n_dofs, mesh, free=free)
    rfn = sharded_vector_fn(cf, mesh)
    counts = []

    def set_values(values):
        """The rank's masked Jacobian blocks at `values`, one per term,
        as the operator's values."""
        vals = {k: values[k].detach() for k in cf.all_names if k in values}
        with torch.no_grad():
            op.set_elements([
                v.matrix_blocks(vals, "__test__", state_name)[0]
                * m[:, None, None] for v, m in op.views])

    def halo_cg(values, b_rep, transpose: bool = False):
        set_values(values)
        b = torch.where(op.free_l, op.scatter_vector(b_rep), 0.0)
        if krylov == "cg":
            x, k, _ = op.cg(b, rtol=cg_rtol, maxiter=cg_maxiter,
                            transpose=transpose)
        else:
            x, k, _ = op.gmres(b, rtol=cg_rtol, maxiter=cg_maxiter,
                               restart=restart, transpose=transpose)
        counts.append(k)
        return op.gather_vector(x), k

    def halo_apply(values, x_rep):
        set_values(values)
        return op.gather_vector(op.matvec(op.scatter_vector(x_rep)))

    at_iteration = _load_scaler(load_steps, newton_iters, scale_inputs)

    def newton_once(u, p):
        vals = vals_of(u, p)
        Rc = constrain_residual(rfn(vals), u, free, bc_values)
        du, _ = halo_cg(vals, -Rc)
        return apply_bc(u + du, free, bc_values)

    def forward(inputs, u0):
        u = apply_bc(u0, free, bc_values)
        for k in range(load_steps * newton_iters - 1):
            u = newton_once(u, at_iteration(inputs, k))
        return newton_once(u, inputs), None

    def backward(u, inputs, _, ubar):
        # the IFT transpose solve at the returned state, then -psi^T dR/dp
        psi, _ = halo_cg(vals_of(u, inputs), torch.where(free, ubar, 0.0),
                         transpose=True)
        psi = torch.where(free, psi, 0.0)
        return _vjp_inputs(lambda uu, p: rfn(vals_of(uu, p)), u, inputs,
                           psi)

    lay = op.layout
    info = dict(L=lay.L, G=lay.G, n_owned=np.asarray(lay.n_owned),
                owned_global=lay.owned_global, ghosts=op.ghost_counts)
    return _ift_solve(forward, backward), dict(
        halo_cg=halo_cg, halo_apply=halo_apply, info=info, op=op,
        counts=counts)


def build_motor_halo_step(refine: float = 1, em_load_steps: int = 3,
                          mm_newton_iters: int = 3,
                          em_newton_iters: int = 3,
                          frequency: float = 300.0, device_mesh=None,
                          design_space: str = "basis", mesh=None,
                          cg_rtol: float = 1e-12, cg_maxiter: int = 20000):
    """The north-star motor opt iteration with both implicit solves
    distributed, on this rank of `device_mesh` (a RankMesh; every rank
    calls it and the step), on the rank's device: (dv, iq) -> (loss,
    (g_dv, g_iq)), the same on every rank.

    The continuation, Newton counts, forms, BCs, design spaces and losses
    of `build_motor_jit_step`: mesh motion by halo GMRES (2 load steps x
    mm_newton_iters), magnetostatics by halo CG (em_load_steps x
    em_newton_iters, the source tables scaled), the eddy and hysteresis
    functionals cells-sharded.  Returns (step, (dv0, iq0), info); info has
    mesh, Vmm, Vem, mm_halo and em_halo (each solver's `info`), and mm and
    em (each solver's aux)."""
    from ..models.motor.model import em_scale, em_vals, mm_vals, motor_problem
    from ..models.motor.pde import power_losses, source_tables

    device_mesh = _rank_mesh(device_mesh)
    dev, dt = device_mesh.device, config.dtype
    mp = motor_problem(refine, mesh, design_space, dev)
    solve_mm, mm_aux = build_halo_newton_solver(
        mp.mm_cf, "uhat", mp.free_mm, mp.bv_mm, device_mesh,
        vals_of=mm_vals, newton_iters=mm_newton_iters, load_steps=2,
        cg_rtol=cg_rtol, cg_maxiter=cg_maxiter, krylov="gmres")
    solve_em, em_aux = build_halo_newton_solver(
        mp.em_cf, "A_z", mp.free_em, mp.bv_em, device_mesh, vals_of=em_vals,
        newton_iters=em_newton_iters, load_steps=em_load_steps,
        scale_inputs=em_scale, cg_rtol=cg_rtol, cg_maxiter=cg_maxiter,
        krylov="cg")
    eddy_fn = sharded_scalar_fn(mp.eddy_cf, device_mesh)
    hyst_fn = sharded_scalar_fn(mp.hyst_cf, device_mesh)

    def loss_of(dv, iq):
        uh = solve_mm({"uhat_bc": mp.to_bc(dv)},
                      torch.zeros(mp.Vmm.n_dofs, dtype=dt, device=dev))
        Ht, Jt = source_tables(iq, torch.zeros((), dtype=dt, device=dev))
        az = solve_em({"uhat": uh, "Htable": Ht, "Jtable": Jt},
                      torch.zeros(mp.Vem.n_dofs, dtype=dt, device=dev))
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

    iq0 = torch.as_tensor(1e5, dtype=dt, device=dev)
    return step, (mp.dv0, iq0), dict(
        mesh=mp.mesh, Vmm=mp.Vmm, Vem=mp.Vem, mm_halo=mm_aux["info"],
        em_halo=em_aux["info"], mm=mm_aux, em=em_aux)
