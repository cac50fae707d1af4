"""Aeroelastic fluid-structure interaction, workloads W7 (static), W8
(dynamic gust response) and W9 (prescribed aero loads): the port of
femo_tpu/models/fsi.py.

VLM -> RBF force map -> RM shell solve -> RBF displacement map -> lattice
update.

* `build_wing_fsi`: the static coupled problem through the composite op
  (dense, block-Thomas or scipy inner solves), iterated as a damped
  Gauss-Seidel fixed point under the differentiable fixed point of
  graph/fixed_point.py (the reference couples through
  csdl.NonlinearBlockGS, run_aeroelasticity_static_w_feedback.py:346-355).
* `build_fsi_jit_step`: the static coupled optimization iteration at
  reference scale (the 107,520-cell eVTOL wing class,
  run_aeroelasticity_static_w_feedback.py:55).  The RM shell operator is
  linear and fixed for a given thickness, so it is filled and factored
  once per design point; every Gauss-Seidel pass is a VLM solve, a
  right-hand-side assembly and block-Thomas solves (the sweeps K1/K2 on
  CUDA tensors), polished by PCG against the f64 operator.  The coupled
  IFT adjoint reuses the factor (K^T = K), and each of its passes applies
  the constant force-load operator's transpose (one K4T launch per block
  on CUDA tensors) and a vector-Jacobian product through the VLM and the
  RBF maps.
* `DynamicShellFSI` (W8, eager): implicit-midpoint time integration of
  the shell residual (run_aeroelasticity_dynamic.py:197-208),
    v_new = 2 (u_new - u_old)/dt - v_old,
    R = rho t (v_new - v_old)/dt . w + dPsi(u_mid) . w - f_mid . w,
  an outer time loop around an inner FSI fixed point, under the
  1-cosine gust `one_cosine_gust` (reference :126-139); with an
  `aero_forces_fn` (`aero_forces_from_file`: .npz or .h5 restart files)
  the loads are prescribed (W9) and a step is one solve.
* `build_dynamic_fsi_jit_step`: W8 at the reference's dynamic mesh ladder
  (run_aeroelasticity_dynamic.py:51-55).  The midpoint operator
  (2 rho t / dt^2) M + K/2 is constant in time, so it is factored once
  and every step and inner pass is a VLM solve, a right-hand side and a
  polished block-Thomas solve (K1/K2).  Its checkpointed trajectory
  adjoint re-linearizes each step from the stored states and reuses the
  factor (the operator is symmetric); each backward step runs an
  Irons-Tuck relaxed adjoint fixed point whose passes apply Fm^T (K4T)
  and a VJP through the VLM and the RBF maps.  external_loads=True is
  W9: one solve a step each way, and the gradient with respect to the
  load series besides the thickness.

Deliberate departures from the JAX builders, which exist there only for
the TPU runtime: no `pcg_maxiter` depth clamp (the note for an rtol below
1e-9 stays); one factor loop at every size (no `factor_chunked` past 4096
blocks); the adjoint passes run as one host loop (no chunked adjoint
programs); the maps and term data are plain tensors, not program
arguments, so the programs take no `consts`.  `factor_compute_dtype=
"mixed"` computes the plain f64 block inverses, as the shell's does, and
takes no `mixed_ns` / `mixed_tol`.  The dynamic trajectory adjoint keeps
its per-step checkpoints (u, theta, v) on the device, where the JAX
package moves them to the host to free TPU memory (twelve states of the
662,442-dof rung are ~0.2 GB).  Both builders take a `template` (an
earlier build's block-tridiagonal template of the same wing), which the
JAX builders do not.

Factor options of both builders (`_BTPrograms`): `factor_method="cr"`,
block cyclic reduction (batched levels; its solves launch no K1/K2), and
`factor_compute_dtype="float32"`, the guarded f32 Thomas recursion on the
Jacobi-equilibrated operator whose solves run K1/K2 in f32; both are
polished against the f64 operator.  The JAX package refuses "cr" with
"float32", and so does the port.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch.func import jvp

from ..config import config, get_device
from ..fea.assemble import ElementMatrix, compile_form
from ..fea.bc import DirichletBC, apply_bc, constrain_residual
from ..fea.forms import FormDef, dx
from ..fea.project import lumped_mass
from ..fea.space import Function
from ..graph.fixed_point import fixed_point_solve, fixed_point_solve_jit
from ..mesh.generators import create_rectangle_mesh
from ..mesh.mesh import Mesh
from ..ops.block_tridiag import (
    BlockCyclicFactor, BlockThomasFactor, BlockTridiagonalMatrix,
    BlockTridiagTemplate, pcg_fixed, pcg_tol)
from .coupling import NodalMap, force_map_mass_weighted
from .shell import RMShellModel, local_frame, shell_energy_density
from .vlm import VLM, flat_wing_lattice_np

def _wing_shell_system(n_shell, span, chord, E, nu, rho_s, device):
    """The cantilever plate wing: (chord x span) triangles in the z = 0
    plane, the RM shell model and its composite state, clamped at y = 0
    (half wing)."""
    ncs, nss = n_shell
    m2 = create_rectangle_mesh(ncs, nss, 0, 0, chord, span,
                               cell_type="triangle")
    coords3 = np.concatenate([m2.coords, np.zeros((m2.n_nodes, 1))], axis=1)
    mesh = Mesh(coords3, m2.cells, "triangle")
    shell = RMShellModel(mesh, E=E, nu=nu, rho=rho_s, device=device)
    return mesh, shell, shell.make_state(_clamp_bcs(shell))


def _clamp_bcs(shell):
    """u = 0 and theta = 0 at the root, y = 0."""
    def clamp(x):
        return np.isclose(x[1], 0.0)

    return [DirichletBC(shell.Vu, 0.0, where=clamp),
            DirichletBC(shell.Vth, 0.0, where=clamp)]


def _lattice(span, chord, n_vlm):
    """The VLM lattice over the wing planform, y shifted to [0, span]
    like the shell (numpy)."""
    lat = flat_wing_lattice_np(span, chord, *n_vlm)
    lat[..., 1] += span / 2
    return lat


def _vlm_and_maps(mesh, shell, n_vlm, span, chord, rho_air, v_inf):
    """The VLM over the wing planform and the RBF transfer matrices.
    Returns (vlm, lat0, vvec, consts, (disp_map, force_map)); consts holds
    the force map `__fmapW__` (traction = fmapW @ forces, the conservative
    transpose map divided by the nodal tributary area), the displacement
    map `__dmapW__` and the area `__area__`, on the shell's device."""
    dev = shell.Vu.device
    lat_np = _lattice(span, chord, n_vlm)
    disp_map = NodalMap(mesh.coords, lat_np.reshape(-1, 3), kind="gaussian",
                        device=dev)
    force_map = NodalMap(mesh.coords, VLM.bound_midpoints_np(lat_np),
                         kind="gaussian", device=dev)
    area_np = lumped_mass(shell.Vf).cpu().numpy()[0::3]

    def t(a):
        return torch.as_tensor(a, dtype=config.dtype, device=dev)

    consts = {"__fmapW__": t(force_map.W_np.T / area_np[:, None]),
              "__dmapW__": disp_map.W, "__area__": t(area_np)}
    return (VLM(*n_vlm, rho=rho_air), t(lat_np),
            t(np.asarray(v_inf, np.float64)), consts, (disp_map, force_map))


def build_wing_fsi(span=4.0, chord=1.0, n_shell=(8, 12), n_vlm=(3, 8),
                   E=7e10, nu=0.3, thickness=0.01, rho_air=1.225,
                   v_inf=(20.0, 0.0, 2.0), rho_s=2700.0,
                   solve_mode: str = "jit_dense", device=None):
    """Static aeroelastic wing: a cantilever plate wing and a VLM, on
    `device` (default `config.device`, the card).

    The wing midsurface lies in the x (chord) - y (span) plane, clamped at
    y = 0.  solve_mode: "jit_dense" (dense LU) or "jit_bt" (block Thomas,
    K1/K2 on CUDA tensors), one Newton step of the linear shell, under
    `fixed_point_solve_jit`; any other value runs the host Newton loop
    with LinearSolver("scipy") under the eager `fixed_point_solve`.
    Returns a problem dict whose `solve(thickness) -> outputs` is the
    coupled fixed point, differentiable in the thickness."""
    from ..fea.composite import composite_implicit_op
    from ..solvers.linear import LinearSolver

    dev = get_device(device)
    mesh, shell, state = _wing_shell_system(n_shell, span, chord, E, nu,
                                            rho_s, dev)
    shell.thickness.set(thickness)
    if solve_mode in ("jit_dense", "jit_bt"):
        op = composite_implicit_op(
            state, ["thickness", "force"],
            newton_opts={"jit_newton_iters": 1}, mode=solve_mode)
    else:
        op = composite_implicit_op(
            state, ["thickness", "force"],
            linear_solver=LinearSolver(method="scipy"),
            newton_opts={"maxiter": 6})

    ncv, nsv = n_vlm
    vlm, lat0, vvec, consts, (disp_map, force_map) = _vlm_and_maps(
        mesh, shell, n_vlm, span, chord, rho_air, v_inf)
    area_lump = consts["__area__"]  # per-node tributary area
    # traction = (W^T f) / area, in the JAX builder's order of operations
    fmap = force_map_mass_weighted(force_map, area_lump)
    n_lat = (ncv + 1) * (nsv + 1)
    tip = int(np.argmax(mesh.coords[:, 1]))

    def shell_solve(d, tarr):
        nodes = lat0 + d.reshape(ncv + 1, nsv + 1, 3)
        aero = vlm.solve(nodes, vvec)
        traction = fmap(aero["forces"])  # (n_shell_nodes, 3)
        x = op({"thickness": tarr, "force": traction.reshape(-1)},
               state.current().detach())
        return aero, traction, state.split(x)

    def gs_step(dlat_flat, params):
        """One Gauss-Seidel pass: aero(lattice + d) -> shell -> new d."""
        parts = shell_solve(dlat_flat, params["thickness"])[2]
        u_nodes = parts["u"].reshape(-1, 3)[: mesh.n_nodes]
        return disp_map.map_displacements(u_nodes).reshape(-1)

    def solve_coupled(thickness_arr, tol=1e-8, maxiter=60, relax=0.7):
        d0 = torch.zeros(n_lat * 3, dtype=config.dtype, device=dev)
        fp = (fixed_point_solve_jit if solve_mode.startswith("jit")
              else fixed_point_solve)
        d_star = fp(gs_step, d0, {"thickness": thickness_arr}, tol=tol,
                    maxiter=maxiter, relax=relax)
        # the converged quantities, recomputed (differentiable)
        aero, traction, parts = shell_solve(d_star, thickness_arr)
        u_nodes = parts["u"].reshape(-1, 3)[: mesh.n_nodes]
        return dict(
            disp_fluid=d_star, u=parts["u"], theta=parts["theta"],
            tip_disp=u_nodes[tip, 2],
            total_aero_force=aero["total"],
            total_mapped_force=torch.sum(traction * area_lump[:, None],
                                         dim=0))

    return dict(mesh=mesh, shell=shell, state=state, op=op, vlm=vlm,
                lat0=lat0, solve=solve_coupled, v_inf=vvec,
                disp_map=disp_map, force_map=force_map, n_lat=n_lat)


def _template(state, template, n_dofs):
    """The RCM block-tridiagonal template of the (u, theta) composite
    Jacobian, from its pattern (host dofmaps, no assembly), or
    `template`, an earlier build's of the same wing."""
    if template is None:
        return BlockTridiagTemplate(state.jacobian_pattern(),
                                    free=state.free, device=state.device)
    if template.n != n_dofs:
        raise ValueError(f"template is for {template.n} dofs, this wing has "
                         f"{n_dofs}")
    return template


class _BTPrograms:
    """fill + factor of the composite operator (the JAX package's
    `_bt_factor_programs`), as separate stages that share one carry:
    (D, L, U, Sinv, C) for block Thomas, (D, L, U, levels, Dinv_root) for
    block cyclic reduction (`method` "cr").  D/L/U stay in the working
    dtype (f64) whatever the factor: rounding the operator to f32 is what
    the RM composite cannot tolerate, and the PCG polish runs against the
    f64 operator.

    * `compute` None or "mixed": the factor of the raw operator in the
      working dtype, its stored arrays rounded to `store` (kept in the
      working dtype, see `BlockTridiagonalMatrix.factor`); "mixed"
      computes the plain inverses.  (The rounded factor is not
      symmetric, so on ill-conditioned wings the polish stagnates above a
      tight rtol.)
    * `compute` "float32" (Thomas only): the whole recursion in f32 on
      the Jacobi-equilibrated operator S A S, guarded
      (`factor(guard=True)`; `rescued` counts the rescued blocks of the
      last factor), stored in f32, and solved by the f32 sweeps between
      the scalings (`BlockThomasFactor` sweep_dtype, scale, Lfac)."""

    def __init__(self, tpl, jac_blocks, n_dofs, free, bv, store,
                 method="thomas", compute=None):
        self.tpl, self.jac_blocks = tpl, jac_blocks
        self.n_dofs, self.free, self.bv = n_dofs, free, bv
        self.store, self.method, self.compute = store, method, compute
        self.rescued = 0
        self._proto = None

    def fill(self, tarr):
        """The composite Jacobian at u = 0 in block layout: (D, L, U)."""
        dev = self.free.device
        u0 = apply_bc(torch.zeros(self.n_dofs, dtype=config.dtype,
                                  device=dev), self.free, self.bv)
        with torch.no_grad():
            return self.tpl.fill(self.jac_blocks(u0, tarr))

    def matrix(self, D, L, U) -> BlockTridiagonalMatrix:
        if self._proto is None:
            self._proto = BlockTridiagonalMatrix(
                D, L, U, self.tpl.perm_full, self.tpl.n)
        return self._proto._like(D, L, U)

    @staticmethod
    def _equilibrated(D, L, U=None):
        """The symmetric Jacobi scale sb (nb, B) = 1 / sqrt(|diag D|), 1
        where the diagonal is 0 (the JAX package's `_bt_equil`), and the
        blocks of S A S in f32: L alone (what the sweeps read), or D, L
        and U (what the factor reads) when U is given."""
        dg = torch.diagonal(D, dim1=1, dim2=2).abs()
        sb = torch.where(dg > 0, 1.0 / torch.sqrt(torch.where(dg > 0, dg,
                                                              1.0)), 1.0)
        z = torch.zeros_like(sb[:1])
        f = torch.float32
        Ls = (L * sb[:, :, None] * torch.cat([z, sb[:-1]])[:, None, :]).to(f)
        if U is None:
            return sb, Ls
        return ((D * sb[:, :, None] * sb[:, None, :]).to(f), Ls,
                (U * sb[:, :, None] * torch.cat([sb[1:], z])[:, None, :]
                 ).to(f))

    def factor_core(self, D, L, U):
        """The factor of the SPD operator: (Sinv, C), or (levels,
        Dinv_root) for cyclic reduction."""
        with torch.no_grad():
            if self.method == "cr":
                fac = self.matrix(D, L, U).factor_cr(self.store, spd=True)
                return fac.levels, fac.Dinv_root
            if self.compute == "float32":
                fac = self.matrix(*self._equilibrated(D, L, U)).factor(
                    spd=True, guard=True)
                self.rescued = fac.rescued
            else:
                fac = self.matrix(D, L, U).factor(self.store, spd=True)
        return fac.Sinv, fac.C

    def factor(self, tarr):
        D, L, U = self.fill(tarr)
        return (D, L, U) + tuple(self.factor_core(D, L, U))

    def unpack(self, carry):
        """(the f64 operator, the factor's solve object).  For the f32
        factor only the scale and the scaled L are recomputed from the
        carry (the scaled D and U are not needed by the sweeps)."""
        D, L, U, F0, F1 = carry
        mat = self.matrix(D, L, U)
        if self.method == "cr":
            return mat, BlockCyclicFactor(
                mat, F0, F1, 1 << max(mat.nb - 1, 0).bit_length())
        if self.compute != "float32":
            return mat, BlockThomasFactor(mat, F0, F1)
        sb, Ls = self._equilibrated(D, L)
        return mat, BlockThomasFactor(mat, F0, F1, sweep_dtype=torch.float32,
                                      scale=sb, Lfac=Ls)


def _check_factor_options(factor_method, factor_compute_dtype):
    """The builders' factor options, refused as the JAX package refuses
    them."""
    if factor_method not in ("thomas", "cr"):
        raise ValueError(f"factor_method must be 'thomas' or 'cr', "
                         f"got {factor_method!r}")
    if factor_compute_dtype not in (None, "mixed", "float32"):
        raise ValueError(f"factor_compute_dtype must be None, 'mixed' or "
                         f"'float32', got {factor_compute_dtype!r}")
    if factor_method == "cr" and factor_compute_dtype == "float32":
        raise ValueError(
            "factor_compute_dtype='float32' requires factor_method='thomas' "
            "(the CR factor has no equilibrated-scale solve path); "
            "factor_compute_dtype='mixed' works with both")


def _aitken(om, r, r_prev, first):
    """Irons-Tuck relaxation: the secant estimate of the optimal
    relaxation from this pass's residual r and the last one's."""
    if first:
        return om
    dr = r - r_prev
    denom = torch.dot(dr, dr)
    om_a = -om * torch.dot(r_prev, dr) / torch.clamp(
        denom, min=torch.finfo(r.dtype).tiny)
    return torch.where(denom > 0.0, torch.clamp(om_a, 0.05, 1.95), om)


class _FSIStep:
    """The stages of `build_fsi_jit_step`, as methods (the step profiler
    runs each inside its own range)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def zeros(self):
        return torch.zeros(self.n_dofs, dtype=config.dtype, device=self.dev)

    # -- one inner shell solve ---------------------------------------------
    def _rhs(self, tarr, farr):
        """-R_c(u0): the constrained residual at the BC-applied zero
        state (the shell is linear: one Newton step solves it)."""
        u0 = apply_bc(self.zeros(), self.free, self.bv)
        R = self.residual(u0, {"thickness": tarr, "force": farr})
        return u0, -constrain_residual(R, u0, self.free, self.bv)

    def _polish(self, mat, b, x0, slv):
        """PCG against the f64 operator from x0: to `pcg_rtol` (at most
        `pcg_maxiter` iterations) or `pcg_iters` fixed iterations.  Adds
        its preconditioner applications to `stats`."""
        if self.pcg_rtol is not None:
            x, k, _ = pcg_tol(mat, None, b, rtol=self.pcg_rtol,
                              maxiter=self.pcg_maxiter, x0=x0, M=slv)
            self.stats["pcg_iters"].append(k)
            self.stats["precond"] += 1 + k
            return x
        if self.pcg_iters > 0:
            self.stats["precond"] += 1 + self.pcg_iters
            return pcg_fixed(mat, None, b, self.pcg_iters, x0=x0, M=slv)
        return x0

    def inv(self, mat, fac, b):
        """K_c^{-1} b: one factor solve (block Thomas: K1 + K2 on CUDA
        tensors, sweeps "scan" and "pallas" alike; or cyclic reduction)
        and the PCG polish."""
        self.stats["solves"] += 1
        return self._polish(mat, b, fac.solve(b), fac.solve)

    def solve_shell(self, mat, fac, tarr, farr):
        u0, b = self._rhs(tarr, farr)
        return apply_bc(u0 + self.inv(mat, fac, b), self.free, self.bv)

    def traction(self, d):
        """(VLM outputs, nodal traction (n_nodes, 3)) on lattice + d."""
        aero = self.vlm.solve(self.lat0 + d.reshape(self.lat0.shape),
                              self.vvec)
        return aero, self.consts["__fmapW__"] @ aero["forces"]

    def u_nodes(self, x):
        return x[:self.off_th].reshape(-1, 3)[:self.n_nodes]

    def disp(self, x):
        """Lattice displacement of the state x (flat)."""
        return (self.consts["__dmapW__"] @ self.u_nodes(x)).reshape(-1)

    def one_pass(self, mat, fac, tarr, d):
        aero, traction = self.traction(d)
        x = self.solve_shell(mat, fac, tarr, traction.reshape(-1))
        return self.disp(x), x, aero, traction

    # -- the programs ---------------------------------------------------------
    def gs(self, carry, tarr, d):
        """gs_inner relaxed Gauss-Seidel passes from d (no refactor):
        (d_new, rel_delta of the last pass)."""
        mat, fac = self.bt.unpack(carry)
        relax = self.relax
        with torch.no_grad():
            if self.accel == "aitken":
                r_prev = torch.zeros_like(d)
                om = torch.as_tensor(relax, dtype=config.dtype,
                                     device=self.dev)
                for i in range(self.gs_inner):
                    g_new = self.one_pass(mat, fac, tarr, d)[0]
                    r = g_new - d
                    om = _aitken(om, r, r_prev, i == 0)
                    delta = (torch.linalg.norm(r)
                             / (torch.linalg.norm(g_new) + 1e-30))
                    d, r_prev = d + om * r, r
                return d, delta
            delta = torch.zeros((), dtype=config.dtype, device=self.dev)
            for _ in range(self.gs_inner):
                d_new = self.one_pass(mat, fac, tarr, d)[0]
                delta = (torch.linalg.norm(d_new - d)
                         / (torch.linalg.norm(d_new) + 1e-30))
                d = (1.0 - relax) * d + relax * d_new
            return d, delta

    def finalize(self, carry, tarr, d):
        """The converged outputs at d, and the force-conservation pair."""
        mat, fac = self.bt.unpack(carry)
        with torch.no_grad():
            _, x, aero, traction = self.one_pass(mat, fac, tarr, d)
            compliance = self.ccf.scalar(
                {"u": x[:self.off_th], "force": traction.reshape(-1)})
            return dict(
                tip_disp=self.u_nodes(x)[self.tip_idx, 2],
                total_aero_force=aero["total"],
                total_mapped_force=torch.sum(
                    traction * self.consts["__area__"][:, None], dim=0),
                compliance=compliance, x=x)

    # -- coupled adjoint ----------------------------------------------------
    # The converged composite state x* satisfies S(x, t) = 0 with
    #   S(x, t) = constrain(R_shell(x; t, force = trac(x))),
    #   trac(x) = fmapW @ VLM_forces(lat0 + dmapW @ u_nodes(x)).
    # Adjoint: (dS/dx)^T lam = dJ/dx, then dJ/dt = -lam^T dS/dt, with
    # dS/dx = Kc - E and Kc the factored constrained stiffness, so lam is
    # solved by the same relaxed factor-reuse iteration as the forward
    # loop, lam <- Kc^{-1} (g + E^T lam).  R_u is linear in the force, so
    # Fm = dR_u/d(force) is constant (assembled once and cached) and
    #   E^T lam |_free = -(dtrac/dx)^T (Fm^T lam_u),
    # one K4T product and one vector-Jacobian product through the VLM and
    # the RBF maps a pass.  (E^T's other block lives on constrained rows,
    # which feed neither the free iteration nor dJ/dt.)
    def S(self, x, tarr):
        _, traction = self.traction(self.disp(x))
        R = self.residual(x, {"thickness": tarr,
                              "force": traction.reshape(-1)})
        return constrain_residual(R, x, self.free, self.bv)

    def J(self, x):
        if self.objective == "tip":
            return self.u_nodes(x)[self.tip_idx, 2]
        # aeroelastic compliance: the force recomputed from x
        _, traction = self.traction(self.disp(x))
        return self.ccf.scalar({"u": x[:self.off_th],
                                "force": traction.reshape(-1)})

    def fm(self) -> ElementMatrix:
        """Fm = dR_u / d(force) at zero fields, assembled at the first
        call and kept (constant: the force enters R_u linearly)."""
        if self._fm is None:
            zeros = {name: torch.zeros(f.space.n_dofs, dtype=config.dtype,
                                       device=self.dev)
                     for name, f in self.ucf.form.coeffs.items()}
            with torch.no_grad():
                self._fm = self.ucf.matrix(zeros, "force",
                                           self.assembly_chunk)
        return self._fm

    def adjoint(self, carry, tarr, x):
        """Coupled IFT adjoint: (J, dJ/d(thickness), adj_delta), the last
        the relative increment of lambda in the last pass (the adjoint's
        rel_delta).  `adj_passes` passes, reusing the forward factor."""
        mat, fac = self.bt.unpack(carry)
        Fm = self.fm()
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            g = torch.autograd.grad(self.J(xx), xx)[0]
            tv = self.traction(self.disp(xx))[1].reshape(-1)
        with torch.no_grad():
            lam = self.inv(mat, fac, g)

            def G(lam):
                lam_u = torch.where(self.free, lam, 0.0)[:self.off_th]
                (vjp,) = torch.autograd.grad(tv, xx, Fm.rmatvec(lam_u),
                                             retain_graph=True)
                return self.inv(mat, fac, g - vjp)

            relax = self.relax
            r_prev = torch.zeros_like(lam)
            om = torch.as_tensor(relax, dtype=config.dtype, device=self.dev)
            adel = torch.zeros((), dtype=config.dtype, device=self.dev)
            for i in range(self.adj_passes):
                if self.accel == "aitken":
                    r = G(lam) - lam
                    om = _aitken(om, r, r_prev, i == 0)
                    adel = (torch.linalg.norm(r)
                            / (torch.linalg.norm(lam + r) + 1e-30))
                    lam, r_prev = lam + om * r, r
                else:
                    lam_new = (1.0 - relax) * lam + relax * G(lam)
                    adel = (torch.linalg.norm(lam_new - lam)
                            / (torch.linalg.norm(lam_new) + 1e-30))
                    lam = lam_new
            J = self.J(x)
        with torch.enable_grad():
            tt = tarr.detach().requires_grad_(True)
            (dt,) = torch.autograd.grad(self.S(x.detach(), tt), tt, lam)
        return J, -dt, adel

    # -- drivers ------------------------------------------------------------
    def _solve_impl(self, tarr, rounds, report):
        carry = self.bt.factor(tarr)
        d = torch.zeros(self.n_lat * 3, dtype=config.dtype, device=self.dev)
        delta = None
        for r in range(rounds):
            d, delta = self.gs(carry, tarr, d)
            if report:
                print(f"  gs round {r + 1}: rel_delta={float(delta):.3e}")
        out = self.finalize(carry, tarr, d)
        out["rel_delta"] = delta
        out["disp_fluid"] = d  # the converged lattice displacement
        return out, carry

    def solve(self, tarr, rounds=3, report=False):
        """Factor once, run `rounds` x gs_inner Gauss-Seidel passes,
        finalize.  The factor carry is not kept in the output."""
        return self._solve_impl(tarr, rounds, report)[0]

    def solve_with_grad(self, tarr, rounds=3, report=False):
        """One coupled optimization iteration: the forward fixed point and
        the IFT adjoint reusing its factor.  Returns the forward outputs
        plus the objective, d(objective)/d(thickness) over the per-cell
        thickness vector, and adj_delta."""
        out, carry = self._solve_impl(tarr, rounds, report)
        J, dJdt, adj_delta = self.adjoint(carry, tarr, out["x"])
        out["objective"] = J
        out["grad_thickness"] = dJdt
        out["adj_delta"] = adj_delta
        return out


def build_fsi_jit_step(n_shell=(16, 24), n_vlm=(4, 16), span=4.0,
                       chord=1.0, E=7e10, nu=0.3, thickness=0.01,
                       rho_air=1.225, v_inf=(20.0, 0.0, 2.0),
                       rho_s=2700.0, gs_inner=4, relax=0.7,
                       pcg_iters=4, factor_store_dtype="float32",
                       assembly_chunk: int | None = None,
                       sweeps: str = "scan", adj_passes: int = 24,
                       objective: str = "tip",
                       factor_method: str = "thomas",
                       factor_compute_dtype=None,
                       accel: str = "none",
                       pcg_rtol: float | None = None,
                       pcg_maxiter: int = 60, device=None, template=None):
    """The reference-scale static aeroelastic FSI iteration on `device`
    (default `config.device`, the card).

    Stages sharing one factor carry (D, L, U, Sinv, C), or (D, L, U,
    levels, Dinv_root) with factor_method="cr":

      factor(tarr) -> carry            fill + one factor
      gs(carry, tarr, d)               gs_inner damped Gauss-Seidel passes
          -> (d_new, rel_delta)          (VLM + right-hand side + solves
                                         per pass; no refactor)
      finalize(carry, tarr, d)         converged outputs and the force-
          -> outputs dict                conservation pair
      adjoint(carry, tarr, x)          coupled IFT adjoint
          -> (J, dJ/dt, adj_delta)

    (`fill(tarr) -> (D, L, U)` and `factor_core(D, L, U) -> (Sinv, C)` or
    (levels, Dinv_root) are the factor's two halves.)  Matches
    run_aeroelasticity_static_w_feedback.py:346-355 at its :55 mesh scale
    with n_shell=(4, 13440), n_vlm=(4, 32), span=30, thickness=0.05.

    Every inner solve is a block-Thomas solve (K1 then K2 on CUDA
    tensors, for sweeps "scan" and "pallas" alike: the CUDA sweeps are
    the port of the Pallas ones) or a cyclic-reduction solve
    (factor_method="cr"), followed by `pcg_iters` fixed PCG
    iterations or, with `pcg_rtol` set, PCG to that tolerance (at most
    `pcg_maxiter` iterations) against the f64 operator.  `stats` counts
    the inner solves ("solves") and the preconditioner applications of
    the polish ("precond"; "pcg_iters" lists pcg_tol's iteration counts),
    so with Thomas K1/K2 launch solves + precond times each (none with
    "cr").

    factor_method, factor_compute_dtype, factor_store_dtype: see the
    module docstring and `_BTPrograms`; template: the `tpl` of an earlier
    build of the same wing, reused (the build's largest host cost).

    accel="aitken": Irons-Tuck dynamic relaxation on the forward passes
    and the adjoint passes, restarted at each gs() call.
    objective: "tip" (the tip's vertical displacement) or "compliance"
    (the aeroelastic compliance, the force recomputed from the state).
    assembly_chunk: cells per slice of the residual and Jacobian
    assembly; above 30,000 cells it defaults to 8192, which bounds the
    jacfwd intermediates of the whole-mesh Jacobian.
    See the module docstring for the departures from the JAX builder.
    """
    if objective not in ("tip", "compliance"):
        raise ValueError(f"objective must be 'tip' or 'compliance', "
                         f"got {objective!r}")
    _check_factor_options(factor_method, factor_compute_dtype)
    if accel not in ("none", "aitken"):
        raise ValueError(f"accel must be 'none' or 'aitken', got {accel!r}")
    if sweeps not in ("scan", "pallas"):
        raise ValueError(f"sweeps must be 'scan' or 'pallas', got "
                         f"{sweeps!r}")
    if sweeps == "pallas" and factor_method != "thomas":
        raise ValueError("sweeps='pallas' requires factor_method='thomas' "
                         "(the Pallas kernels implement the Thomas sweeps)")
    if sweeps == "pallas" and pcg_iters == 0 and pcg_rtol is None \
            and config.dtype == torch.float64:
        # the JAX package's guard, kept with its argument contract: there
        # the Pallas sweeps are f32 and serve only as a preconditioner
        raise ValueError(
            "sweeps='pallas' in f64 requires pcg_iters > 0: the f32 "
            "sweep result must be polished against the f64 operator")
    dev = get_device(device)
    mesh, shell, state = _wing_shell_system(n_shell, span, chord, E, nu,
                                            rho_s, dev)
    if assembly_chunk is None and mesh.n_cells > 30000:
        assembly_chunk = 8192
    free, bv = state.free, state.bc_values
    n_dofs = state.n_dofs

    def residual(x, p):
        return state.residual(x, p, chunk=assembly_chunk)

    zero_f = torch.zeros(shell.Vf.n_dofs, dtype=config.dtype, device=dev)

    def jac_blocks(x, tarr):
        return state.jacobian_blocks(x, {"thickness": tarr,
                                         "force": zero_f},
                                     chunk=assembly_chunk)

    tpl = _template(state, template, n_dofs)
    bt = _BTPrograms(tpl, jac_blocks, n_dofs, free, bv, factor_store_dtype,
                     factor_method, factor_compute_dtype)
    if pcg_rtol is not None and pcg_rtol < 1e-9:
        # the attainable relative residual is ~eps_f64 * cond, and the
        # composite's cond grows as its cells shrink: the true f64
        # residual of this wing stalls near 2e-4 at 13,440 cells and
        # 1e-2 at 107,520 (tools/fsi_conditioning.py), so tighter
        # targets run every solve to pcg_maxiter
        print(f"[fsi] pcg_rtol={pcg_rtol:g} is below the f64-attainable "
              "floor at shell conditioning; solves will stop on "
              "stagnation/maxiter instead", flush=True)
    vlm, lat0, vvec, consts, _ = _vlm_and_maps(mesh, shell, n_vlm, span,
                                               chord, rho_air, v_inf)
    ucf = compile_form(shell.res_u)
    st = _FSIStep(
        dev=dev, shell=shell, state=state, free=free, bv=bv, n_dofs=n_dofs,
        off_th=shell.Vu.n_dofs, n_nodes=mesh.n_nodes,
        tip_idx=int(np.argmax(mesh.coords[:, 1])), residual=residual,
        bt=bt, vlm=vlm, lat0=lat0, vvec=vvec, consts=consts, ucf=ucf,
        ccf=compile_form(shell.compliance_form),
        n_lat=int(np.prod(lat0.shape[:-1])), gs_inner=gs_inner, relax=relax,
        accel=accel, objective=objective, adj_passes=adj_passes,
        pcg_iters=pcg_iters, pcg_rtol=pcg_rtol, pcg_maxiter=pcg_maxiter,
        assembly_chunk=assembly_chunk, _fm=None,
        stats=dict(solves=0, precond=0, pcg_iters=[]))
    t0 = torch.full((shell.Vt.n_dofs,), thickness, dtype=config.dtype,
                    device=dev)
    return dict(mesh=mesh, shell=shell, state=state, consts=consts,
                factor=bt.factor, fill=bt.fill, factor_core=bt.factor_core,
                gs=st.gs, finalize=st.finalize, adjoint=st.adjoint,
                solve=st.solve, solve_with_grad=st.solve_with_grad,
                t0=t0, n_dofs=n_dofs, n_cells=mesh.n_cells,
                n_panels=n_vlm[0] * n_vlm[1], lat0=lat0, tpl=tpl,
                residual=residual, vlm=vlm, vvec=vvec, ucf=ucf,
                tcf=compile_form(shell.res_th), stats=st.stats,
                assembly_chunk=assembly_chunk, step=st)


# ---------------------------------------------------------------------------
# W8: implicit-midpoint dynamic aeroelasticity, and W9: the same march under
# a prescribed aero-load series
# ---------------------------------------------------------------------------


def one_cosine_gust(t, t0=0.1, duration=0.2, w_gust=2.0):
    """1-cosine vertical gust velocity at time t (a float or a tensor; a
    tensor in the working dtype, on t's device, comes back)."""
    t = torch.as_tensor(t, dtype=config.dtype)
    s = (t - t0) / duration
    inside = (s >= 0) & (s <= 1)
    return torch.where(inside, 0.5 * w_gust * (1 - torch.cos(2 * np.pi * s)),
                       0.0)


def aero_forces_from_file(path: str, times_key: str = "time",
                          forces_key: str = "forces", device=None):
    """An `aero_forces_fn(t) -> (n_pts, 3)` from a precomputed aero-load
    time series on disk (W9: the reference's VPM variant feeds its dynamic
    FSI from restart files, run_aeroelasticity_vpm.py:15-25).  .npz or
    .h5/.hdf5 (h5py) with datasets `time` (n_t,) and `forces` (n_t, n_pts,
    3); sorted by time, interpolated linearly, held constant outside the
    range.  The series lives on `device` (default `config.device`)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".h5", ".hdf5"):
        import h5py

        with h5py.File(path, "r") as f:
            times = np.asarray(f[times_key])
            forces = np.asarray(f[forces_key])
    elif ext == ".npz":
        with np.load(path) as d:
            times, forces = np.asarray(d[times_key]), np.asarray(d[forces_key])
    else:
        raise ValueError(f"unsupported restart-file format: {path}")
    order = np.argsort(times)
    dev = get_device(device)
    tj = torch.as_tensor(times[order], dtype=config.dtype, device=dev)
    fj = torch.as_tensor(forces[order], dtype=config.dtype, device=dev)
    tiny = torch.finfo(tj.dtype).tiny

    def fn(t):
        t = torch.as_tensor(t, dtype=config.dtype, device=dev)
        i = torch.clamp(torch.searchsorted(tj, t), 1, len(tj) - 1)
        t0, t1 = tj[i - 1], tj[i]
        w = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=tiny), 0.0, 1.0)
        return (1.0 - w) * fj[i - 1] + w * fj[i]

    return fn


def synthetic_restart(path, n_pts, t_end, n_samples=24, seed=0):
    """A synthetic VPM-like restart file (.npz) at `path`: a smooth ramp to
    steady lift with a per-revolution oscillation, sampled coarser than the
    structural dt (examples/run_aeroelasticity_vpm.py's writer)."""
    rng = np.random.default_rng(seed)
    times = np.linspace(0.0, t_end, n_samples)
    base = rng.standard_normal((n_pts, 3)) * 0.03
    base[:, 2] += 1.0  # dominant lift
    ramp = 1.0 - np.exp(-times / max(t_end / 4, 1e-9))
    osc = 1.0 + 0.2 * np.sin(2 * np.pi * times / max(t_end / 3, 1e-9))
    series = base[None, :, :] * (40.0 * ramp * osc)[:, None, None]
    np.savez(path, time=times, forces=series)
    return path


def _midpoint_forms(shell, dt):
    """The implicit-midpoint residual of the RM shell over the coefficients
    [u, theta, u_old, theta_old, v_old, thickness, force]:

      R_u = rho t (v_new - v_old)/dt . w + dPsi(u_mid) . w - f . w,
      v_new = 2 (u_new - u_old)/dt - v_old,  u_mid = (u_new + u_old)/2,

    R_theta = dPsi(theta_mid) . w.  Returns (u_old, theta_old, v_old,
    res_u, res_th)."""
    u_old = Function(shell.Vu, "u_old")
    th_old = Function(shell.Vth, "theta_old")
    v_old = Function(shell.Vu, "v_old")
    rho = shell.rho
    E_, nu_, drill_ = shell.E, shell.nu, shell.drill
    dt = float(dt)

    def mid(w):
        return (0.5 * (w.u.val + w.u_old.val), 0.5 * (w.u.grad + w.u_old.grad),
                0.5 * (w.theta.val + w.theta_old.val),
                0.5 * (w.theta.grad + w.theta_old.grad))

    def dpsi_u(w, g):
        frame = local_frame(g.J)
        uv, ug, tv, tg = mid(w)

        def psi(a, b):
            return shell_energy_density(a, b, tv, tg, w.thickness.val, frame,
                                        E_, nu_, drill_)

        return jvp(psi, (uv, ug), (w.v.val, w.v.grad))[1]

    def inertia(w, g):
        accel = (2.0 / dt**2) * (w.u.val - w.u_old.val) \
            - (2.0 / dt) * w.v_old.val
        return rho * w.thickness.val * torch.dot(accel, w.v.val)

    def r_u(w, g):
        return dpsi_u(w, g) + inertia(w, g) - torch.dot(w.force.val, w.v.val)

    def r_th(w, g):
        frame = local_frame(g.J)
        uv, ug, tv, tg = mid(w)

        def psi(a, b):
            return shell_energy_density(uv, ug, a, b, w.thickness.val, frame,
                                        E_, nu_, drill_)

        return jvp(psi, (tv, tg), (w.v.val, w.v.grad))[1]

    coeffs = [shell.u, shell.theta, u_old, th_old, v_old, shell.thickness,
              shell.force]
    return (u_old, th_old, v_old,
            FormDef([dx(r_u, qdeg=4)], coeffs=coeffs, test=shell.Vu),
            FormDef([dx(r_th, qdeg=4)], coeffs=coeffs, test=shell.Vth))


def _clamped_state(shell, res_u, res_th):
    """The (u, theta) composite state of the midpoint forms, clamped at
    y = 0."""
    from ..fea.composite import CompositeState

    return CompositeState([shell.u, shell.theta],
                          {"u": res_u, "theta": res_th}, _clamp_bcs(shell))


class DynamicShellFSI:
    """Implicit-midpoint dynamic aeroelasticity (W8), eager.

    Each time step solves the dynamic shell residual (inertia + stiffness
    at the midpoint) under aero loads from the VLM at the midpoint
    configuration, by an inner fixed point (the reference's custom_solve
    time loop, run_aeroelasticity_dynamic.py:272-391).  `fsi` is a
    `build_wing_fsi` problem; every step's solve is one block-Thomas
    Newton step of the composite op ("jit_bt": K1/K2 on CUDA tensors),
    exact for the linear shell."""

    def __init__(self, fsi: dict, dt: float, fsi_iters: int = 8,
                 gust=one_cosine_gust):
        from ..fea.composite import composite_implicit_op

        self.fsi = fsi
        self.dt = dt
        self.gust = gust
        self.fsi_iters = fsi_iters
        self.shell = shell = fsi["shell"]
        self.state = fsi["state"]
        self.u_old, self.theta_old, self.v_old, res_u, res_th = \
            _midpoint_forms(shell, dt)
        self.dyn_state = _clamped_state(shell, res_u, res_th)
        self.dyn_op = composite_implicit_op(
            self.dyn_state,
            ["u_old", "theta_old", "v_old", "thickness", "force"],
            newton_opts={"jit_newton_iters": 1}, mode="jit_bt")

    def run(self, n_steps: int, thickness_arr=None, report: bool = False,
            aero_forces_fn=None):
        """Time march from rest; returns {"tip_disp": [...], "time": [...]}.

        aero_forces_fn(t) -> (n_force_points, 3): a prescribed aero-load
        series replacing the VLM (W9); the loads are then
        motion-independent and the inner fixed point is one pass."""
        fsi, shell = self.fsi, self.shell
        mesh, vlm, lat0, vvec = fsi["mesh"], fsi["vlm"], fsi["lat0"], \
            fsi["v_inf"]
        disp_map = fsi["disp_map"]
        dev = vvec.device
        fmap = force_map_mass_weighted(fsi["force_map"],
                                       lumped_mass(shell.Vf)[0::3])
        tarr = (thickness_arr if thickness_arr is not None
                else shell.thickness.array)

        def zeros(V):
            return torch.zeros(V.n_dofs, dtype=config.dtype, device=dev)

        u_old, th_old, v_old = zeros(shell.Vu), zeros(shell.Vth), \
            zeros(shell.Vu)
        ez = torch.tensor([0.0, 0.0, 1.0], dtype=config.dtype, device=dev)
        tip = int(np.argmax(mesh.coords[:, 1]))
        history = {"tip_disp": [], "time": []}
        st = self.dyn_state
        x = st.current()
        dt = self.dt
        inner = 1 if aero_forces_fn is not None else self.fsi_iters
        for n in range(n_steps):
            t_mid = (n + 0.5) * dt
            v_now = vvec + ez * torch.as_tensor(
                self.gust(t_mid), dtype=config.dtype, device=dev)
            u_guess = st.split(x)["u"]
            for it in range(inner):
                if aero_forces_fn is not None:
                    forces = torch.as_tensor(aero_forces_fn(t_mid),
                                             dtype=config.dtype, device=dev)
                else:
                    u_mid = (0.5 * (u_guess + u_old)).reshape(
                        -1, 3)[:mesh.n_nodes]
                    d_lat = disp_map.map_displacements(u_mid)
                    forces = vlm.solve(lat0 + d_lat.reshape(lat0.shape),
                                       v_now)["forces"]
                x = self.dyn_op(
                    {"u_old": u_old, "theta_old": th_old, "v_old": v_old,
                     "thickness": tarr, "force": fmap(forces).reshape(-1)},
                    x.detach())
                u_new = st.split(x)["u"]
                delta = float(torch.linalg.norm((u_new - u_guess).detach()))
                u_guess = u_new
                if delta < 1e-9:
                    break
            th_new = st.split(x)["theta"]
            v_new = 2.0 * (u_new - u_old) / dt - v_old
            u_old, th_old, v_old = u_new, th_new, v_new
            w_tip = float(u_new.reshape(-1, 3)[tip, 2])
            history["tip_disp"].append(w_tip)
            history["time"].append((n + 1) * dt)
            if report:
                print(f"  step {n + 1}: t={(n + 1) * dt:.3f} "
                      f"tip={w_tip:.5e} (fsi iters {it + 1})")
        return history


class _DynamicFSIStep(_FSIStep):
    """The stages of `build_dynamic_fsi_jit_step`, as methods (the step
    profiler runs each inside its own range).  The polished solve (`inv`,
    `_polish`), `zeros` and `u_nodes` are _FSIStep's."""

    # -- one implicit-midpoint solve ----------------------------------------
    def params(self, tarr, u_old, th_old, v_old, farr):
        return {"thickness": tarr, "u_old": u_old, "theta_old": th_old,
                "v_old": v_old, "force": farr}

    def rhs(self, tarr, u_old, th_old, v_old, farr):
        """-R_c(u0) of the midpoint residual at the BC-applied zero state
        (linear in u_new: one Newton step solves it)."""
        u0 = apply_bc(self.zeros(), self.free, self.bv)
        R = self.residual(u0, self.params(tarr, u_old, th_old, v_old, farr))
        return u0, -constrain_residual(R, u0, self.free, self.bv)

    def solve_midpoint(self, mat, fac, tarr, u_old, th_old, v_old, traction):
        u0, b = self.rhs(tarr, u_old, th_old, v_old, traction.reshape(-1))
        return apply_bc(u0 + self.inv(mat, fac, b), self.free, self.bv)

    def v_now(self, t_mid):
        return self.vvec + self.ez * torch.as_tensor(
            self.gust(t_mid), dtype=config.dtype, device=self.dev)

    def aero_traction(self, d, v_now):
        """Nodal traction (n_nodes, 3) of the VLM on lattice + d."""
        aero = self.vlm.solve(self.lat0 + d.reshape(self.lat0.shape), v_now)
        return self.consts["__fmapW__"] @ aero["forces"]

    def d_mid(self, x, u_old):
        """The lattice displacement of the midpoint configuration."""
        u_mid = 0.5 * (x[:self.off_th] + u_old)
        return (self.consts["__dmapW__"]
                @ u_mid.reshape(-1, 3)[:self.n_nodes]).reshape(-1)

    def _advance(self, x, u_old, v_old):
        u_new, th_new = x[:self.off_th], x[self.off_th:]
        v_new = 2.0 * (u_new - u_old) / self.dt - v_old
        return u_new, th_new, v_new, self.u_nodes(x)[self.tip_idx, 2]

    # -- the programs ---------------------------------------------------------
    def step(self, carry, tarr, u_old, th_old, v_old, d, t_mid):
        """One W8 time step: fsi_iters passes of VLM at the gusted velocity
        -> traction -> midpoint solve -> lattice at the midpoint
        configuration.  Returns (u_new, th_new, v_new, d_new, tip)."""
        mat, fac = self.bt.unpack(carry)
        with torch.no_grad():
            v_now = self.v_now(t_mid)
            x = self.zeros()
            for _ in range(self.fsi_iters):
                trac = self.aero_traction(d, v_now)
                x = self.solve_midpoint(mat, fac, tarr, u_old, th_old, v_old,
                                        trac)
                d = self.d_mid(x, u_old)
            u_new, th_new, v_new, tip = self._advance(x, u_old, v_old)
            return u_new, th_new, v_new, d, tip

    def step_ext(self, carry, tarr, u_old, th_old, v_old, d, f_mid):
        """One W9 time step: one midpoint solve under the prescribed
        midpoint loads f_mid (n_force_pts, 3); d passes through."""
        mat, fac = self.bt.unpack(carry)
        with torch.no_grad():
            x = self.solve_midpoint(mat, fac, tarr, u_old, th_old, v_old,
                                    self.consts["__fmapW__"] @ f_mid)
            u_new, th_new, v_new, tip = self._advance(x, u_old, v_old)
            return u_new, th_new, v_new, d, tip

    # -- trajectory adjoint ---------------------------------------------------
    # The per-step state equation at the converged inner fixed point:
    #   S_n(x_n; x_{n-1}, v_{n-1}, t) =
    #     constrain(R(x_n; x_{n-1}, v_{n-1}, t, trac(u_mid))),
    # u_mid = (u_n + u_{n-1})/2 driving the VLM traction, with the explicit
    # update v_n = 2 (u_n - u_{n-1})/dt - v_{n-1}.  The dynamic operator
    # A = (2 rho t/dt^2) M + K/2 is constant and symmetric, so every
    # backward step reuses the forward factor; the aero coupling enters
    # the adjoint fixed point as in the static adjoint (Fm^T, one K4T
    # launch, and a VJP through the VLM and the RBF maps per pass).
    def S(self, x_new, x_old, v_old, tarr, t_mid):
        trac = self.aero_traction(self.d_mid(x_new, x_old[:self.off_th]),
                                  self.v_now(t_mid))
        return self.S_ext_trac(x_new, x_old, v_old, tarr, trac)

    def S_ext_trac(self, x_new, x_old, v_old, tarr, trac):
        p = self.params(tarr, x_old[:self.off_th], x_old[self.off_th:], v_old,
                        trac.reshape(-1))
        return constrain_residual(self.residual(x_new, p), x_new, self.free,
                                  self.bv)

    def _fold_v(self, xbar, vbar):
        """The x_n cotangent with the explicit v_n update folded in
        (dv_n/du_n = 2/dt), and vbar padded to the state."""
        pad_v = torch.cat([vbar, vbar.new_zeros(self.n_dofs - self.off_th)])
        return xbar + (2.0 / self.dt) * pad_v, pad_v

    def _vjp_S(self, lam, S_of, x_old, v_old, tarr, *extra):
        """(d S / d(x_old, v_old, tarr, *extra))^T lam."""
        with torch.enable_grad():
            ins = [a.detach().requires_grad_(True)
                   for a in (x_old, v_old, tarr) + extra]
            return torch.autograd.grad(S_of(*ins), ins, lam)

    def adjoint_step(self, carry, tarr, x_new, x_old, v_old, t_mid, xbar,
                     vbar, fm=None):
        """One W8 backward step: (xbar_old, vbar_old, dJ/dt increment,
        adj_delta), adj_delta the relative lambda increment of the last of
        the adj_passes Irons-Tuck passes."""
        mat, fac = self.bt.unpack(carry)
        Fm = self.fm() if fm is None else fm
        xbar_eff, pad_v = self._fold_v(xbar, vbar)
        u_old = x_old[:self.off_th].detach()
        with torch.enable_grad():
            xx = x_new.detach().requires_grad_(True)
            tv = self.aero_traction(self.d_mid(xx, u_old),
                                    self.v_now(t_mid)).reshape(-1)
        with torch.no_grad():
            def G(lam):
                lam_u = torch.where(self.free, lam, 0.0)[:self.off_th]
                (vjp,) = torch.autograd.grad(tv, xx, Fm.rmatvec(lam_u),
                                             retain_graph=True)
                return self.inv(mat, fac, xbar_eff - vjp)

            lam = self.inv(mat, fac, xbar_eff)
            r_prev = torch.zeros_like(lam)
            om = torch.ones((), dtype=config.dtype, device=self.dev)
            adel = torch.zeros((), dtype=config.dtype, device=self.dev)
            for i in range(self.adj_passes):
                r = G(lam) - lam
                om = _aitken(om, r, r_prev, i == 0)
                adel = torch.linalg.norm(r) / (torch.linalg.norm(lam + r)
                                               + 1e-30)
                lam, r_prev = lam + om * r, r
        del tv
        xo_bar, vo_bar, t_bar = self._vjp_S(
            lam, lambda xo, vo, tt: self.S(x_new.detach(), xo, vo, tt, t_mid),
            x_old, v_old, tarr)
        return (-(2.0 / self.dt) * pad_v - xo_bar, -vbar - vo_bar, -t_bar,
                adel)

    def adjoint_step_ext(self, carry, tarr, x_new, x_old, v_old, f_mid, xbar,
                         vbar):
        """One W9 backward step: no aero fixed point (dS/dx_new has no
        traction term), so lambda is one polished solve.  Returns
        (xbar_old, vbar_old, dJ/dt increment, dJ/d(f_mid))."""
        mat, fac = self.bt.unpack(carry)
        xbar_eff, pad_v = self._fold_v(xbar, vbar)
        with torch.no_grad():
            lam = self.inv(mat, fac, xbar_eff)
        fmapW = self.consts["__fmapW__"]
        xo_bar, vo_bar, t_bar, f_bar = self._vjp_S(
            lam, lambda xo, vo, tt, fm: self.S_ext_trac(
                x_new.detach(), xo, vo, tt, fmapW @ fm),
            x_old, v_old, tarr, f_mid)
        return (-(2.0 / self.dt) * pad_v - xo_bar, -vbar - vo_bar, -t_bar,
                -f_bar)

    # -- drivers ------------------------------------------------------------
    def _series(self, forces_series, n_steps):
        if not self.external_loads:
            return None
        if forces_series is None:
            raise ValueError("external_loads build requires forces_series "
                             "(n_steps, n_panels, 3)")
        s = torch.as_tensor(forces_series, dtype=config.dtype,
                            device=self.dev)
        if s.shape[0] < n_steps:
            raise ValueError(f"forces_series has {s.shape[0]} steps, "
                             f"{n_steps} requested")
        return s

    def _march(self, carry, tarr, n_steps, series, report, keep):
        """The forward time march from rest: (tips, checkpoints), the
        per-step states (u, th, v) kept (on the device) when `keep`."""
        u, th, v = (self.zeros()[:self.off_th], self.zeros()[self.off_th:],
                    self.zeros()[:self.off_th])
        d = torch.zeros(self.n_lat * 3, dtype=config.dtype, device=self.dev)
        states = [(u, th, v)] if keep else None
        tips = []
        for n in range(n_steps):
            if series is not None:
                u, th, v, d, tip = self.step_ext(carry, tarr, u, th, v, d,
                                                 series[n])
            else:
                u, th, v, d, tip = self.step(carry, tarr, u, th, v, d,
                                             (n + 0.5) * self.dt)
            if keep:
                states.append((u, th, v))
            tips.append(float(tip))
            if report:
                print(f"  step {n + 1}: t={(n + 1) * self.dt:.3f} "
                      f"tip={tips[-1]:.5e}")
        return tips, states

    def run(self, tarr, n_steps, report=False, forces_series=None):
        """Factor once, march n_steps from rest; returns {"time": [...],
        "tip_disp": [...]}.  With external_loads, forces_series is the
        (n_steps, n_panels, 3) midpoint-sampled load series (W9)."""
        series = self._series(forces_series, n_steps)
        carry = self.bt.factor(tarr)
        tips, _ = self._march(carry, tarr, n_steps, series, report, False)
        return {"time": [(n + 1) * self.dt for n in range(n_steps)],
                "tip_disp": tips}

    def run_with_grad(self, tarr, n_steps, J_of_tips=None, report=False,
                      carry=None, forces_series=None):
        """The gradient of a trajectory functional J(tip_1..tip_N) with
        respect to the per-cell thickness, through the whole time history
        (and, with external_loads, with respect to the load series).

        J_of_tips: a torch function (n_steps,) -> scalar; default the
        smooth max (p-norm, p = 8) of |tip|.  `carry` reuses a factor.
        Returns J, tips, grad_thickness, adj_deltas (backward order; 0.0
        for W9's single solve), forward_s, backward_s, adj_step_s, and
        with external_loads grad_forces (n_steps, n_panels, 3)."""
        import time as _time

        if J_of_tips is None:
            def J_of_tips(tips):
                return torch.mean(torch.abs(tips) ** 8) ** 0.125

        series = self._series(forces_series, n_steps)
        if carry is None:
            carry = self.bt.factor(tarr)
        t_fwd = _time.perf_counter()
        tips, states = self._march(carry, tarr, n_steps, series, report, True)
        forward_s = _time.perf_counter() - t_fwd
        tips_t = torch.tensor(tips, dtype=config.dtype, requires_grad=True)
        with torch.enable_grad():
            J = J_of_tips(tips_t)
            (tipbars,) = torch.autograd.grad(J, tips_t)
        tipbars = tipbars.tolist()

        t_bwd = _time.perf_counter()
        xbar = self.zeros()
        vbar = self.zeros()[:self.off_th]
        tbar = torch.zeros_like(tarr)
        fm = None if series is not None else self.fm()
        adj_deltas, adj_step_s = [], []
        grad_forces = [None] * n_steps
        for n in reversed(range(n_steps)):
            u_n, th_n, _ = states[n + 1]
            u_p, th_p, v_p = states[n]
            x_new, x_old = torch.cat([u_n, th_n]), torch.cat([u_p, th_p])
            xbar = xbar.clone()
            xbar[3 * self.tip_idx + 2] += tipbars[n]
            t_st = _time.perf_counter()
            if series is not None:
                xbar, vbar, tinc, grad_forces[n] = self.adjoint_step_ext(
                    carry, tarr, x_new, x_old, v_p, series[n], xbar, vbar)
                adj_deltas.append(0.0)  # one exact solve: no fixed point
                if self.dev.type == "cuda":
                    torch.cuda.synchronize(self.dev)
            else:
                xbar, vbar, tinc, adel = self.adjoint_step(
                    carry, tarr, x_new, x_old, v_p, (n + 0.5) * self.dt,
                    xbar, vbar, fm)
                adj_deltas.append(float(adel))
            adj_step_s.append(_time.perf_counter() - t_st)
            tbar = tbar + tinc
            if report:
                print(f"  adj step {n + 1}: lambda rel-incr="
                      f"{adj_deltas[-1]:.3e} ({adj_step_s[-1]:.2f} s)")
        out = dict(J=float(J.detach()), tips=np.asarray(tips),
                   grad_thickness=tbar,
                   adj_deltas=adj_deltas, forward_s=forward_s,
                   backward_s=_time.perf_counter() - t_bwd,
                   adj_step_s=adj_step_s)
        if series is not None:
            out["grad_forces"] = torch.stack(grad_forces)
        return out


def build_dynamic_fsi_jit_step(n_shell=(16, 24), n_vlm=(4, 16), span=4.0,
                               chord=1.0, E=7e10, nu=0.3, thickness=0.01,
                               rho_air=1.225, v_inf=(20.0, 0.0, 2.0),
                               rho_s=2700.0, dt=0.01, fsi_iters=3,
                               pcg_iters=4,
                               factor_store_dtype="float32",
                               assembly_chunk: int | None = None,
                               gust=one_cosine_gust,
                               factor_method: str = "thomas",
                               factor_compute_dtype=None,
                               adj_passes: int = 6,
                               external_loads: bool = False,
                               device=None, template=None):
    """Reference-ladder dynamic aeroelasticity (gust response, W8) on
    `device` (default `config.device`, the card), factored once.

    Implicit midpoint (run_aeroelasticity_dynamic.py:197-208): the dynamic
    operator A = (2 rho t / dt^2) M + K/2 is constant in time for a fixed
    thickness and dt, so it is filled and block-Thomas-factored once, and
    every time step and every inner FSI pass is a VLM solve, a
    right-hand-side assembly and one block-Thomas solve (K1 + K2 on CUDA
    tensors) with `pcg_iters` fixed PCG polish iterations against the f64
    operator.  n_shell=(4, 9600), n_vlm=(4, 24), span=21, thickness=0.05
    is bench_scale.py's 77k rung of the reference's dynamic mesh ladder
    (run_aeroelasticity_dynamic.py:51-55): 76,800 cells, 662,442 dofs.

    external_loads=True is W9 (the VPM restart-file regime,
    run_aeroelasticity_vpm.py:15-25): the aero forces are a prescribed
    (n_steps, n_panels, 3) series sampled at the step midpoints instead of
    the coupled VLM, so a step is one midpoint solve; `run` and
    `run_with_grad` then require `forces_series`, and `run_with_grad`
    also returns grad_forces = dJ/d(series).

      factor(tarr) -> carry                       fill + factor
      step(carry, tarr, u, th, v, d, t_mid | f_mid)
          -> (u_new, th_new, v_new, d_new, tip)   one time step
      run(tarr, n_steps, report, forces_series)   the tip history
      run_with_grad(tarr, n_steps, J_of_tips, report, carry, forces_series)
                                                  the checkpointed
                                                  trajectory adjoint
      adjoint_step(...)                           one backward step

    Launches per step: W8 forward fsi_iters polished solves; W8 backward
    1 + adj_passes solves and adj_passes Fm^T products (K4T); W9 one
    solve each way.  With Thomas a polished solve launches K1 and K2 each
    2 + pcg_iters times (one, without the polish; none with "cr");
    `stats` counts the solves ("solves") and the polish's preconditioner
    applications ("precond").

    template: the BlockTridiagTemplate (`tpl`) of an earlier build of the
    same wing, reused instead of recomputed (it is the build's largest host
    cost, and depends on the mesh and the clamp alone).  For
    factor_method and factor_compute_dtype ("mixed" computes the plain
    f64 inverses) and the departures from the JAX builder, see the
    module docstring.
    """
    _check_factor_options(factor_method, factor_compute_dtype)
    dev = get_device(device)
    mesh, shell, _ = _wing_shell_system(n_shell, span, chord, E, nu, rho_s,
                                        dev)
    if assembly_chunk is None and mesh.n_cells > 30000:
        assembly_chunk = 8192
    _, _, _, res_u, res_th = _midpoint_forms(shell, dt)
    state = _clamped_state(shell, res_u, res_th)
    free, bv = state.free, state.bc_values
    n_dofs = state.n_dofs

    def residual(x, p):
        return state.residual(x, p, chunk=assembly_chunk)

    def zeros(V):
        return torch.zeros(V.n_dofs, dtype=config.dtype, device=dev)

    def jac_blocks(x, tarr):
        # the dynamic Jacobian does not depend on the old state or loads
        p = {"thickness": tarr, "u_old": zeros(shell.Vu),
             "theta_old": zeros(shell.Vth), "v_old": zeros(shell.Vu),
             "force": zeros(shell.Vf)}
        return state.jacobian_blocks(x, p, chunk=assembly_chunk)

    tpl = _template(state, template, n_dofs)
    bt = _BTPrograms(tpl, jac_blocks, n_dofs, free, bv, factor_store_dtype,
                     factor_method, factor_compute_dtype)
    vlm, lat0, vvec, consts, _ = _vlm_and_maps(mesh, shell, n_vlm, span,
                                               chord, rho_air, v_inf)
    st = _DynamicFSIStep(
        dev=dev, shell=shell, state=state, free=free, bv=bv, n_dofs=n_dofs,
        off_th=shell.Vu.n_dofs, n_nodes=mesh.n_nodes,
        tip_idx=int(np.argmax(mesh.coords[:, 1])), residual=residual,
        bt=bt, vlm=vlm, lat0=lat0, vvec=vvec, consts=consts,
        ucf=compile_form(res_u), n_lat=int(np.prod(lat0.shape[:-1])),
        dt=float(dt), gust=gust, fsi_iters=fsi_iters, adj_passes=adj_passes,
        external_loads=external_loads, pcg_iters=pcg_iters, pcg_rtol=None,
        assembly_chunk=assembly_chunk, _fm=None,
        ez=torch.tensor([0.0, 0.0, 1.0], dtype=config.dtype, device=dev),
        stats=dict(solves=0, precond=0, pcg_iters=[]))
    t0 = torch.full((shell.Vt.n_dofs,), thickness, dtype=config.dtype,
                    device=dev)
    return dict(mesh=mesh, shell=shell, state=state, consts=consts,
                factor=bt.factor, fill=bt.fill, factor_core=bt.factor_core,
                step=st.step_ext if external_loads else st.step,
                run=st.run, run_with_grad=st.run_with_grad,
                adjoint_step=(st.adjoint_step_ext if external_loads
                              else st.adjoint_step),
                t0=t0, n_dofs=n_dofs, n_cells=mesh.n_cells, dt=float(dt),
                tpl=tpl, n_force_pts=int(consts["__fmapW__"].shape[1]),
                residual=residual, vlm=vlm, vvec=vvec, lat0=lat0,
                ucf=st.ucf, stats=st.stats, assembly_chunk=assembly_chunk,
                dyn=st)
