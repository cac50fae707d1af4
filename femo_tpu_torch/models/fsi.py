"""Static aeroelastic fluid-structure interaction, workload W7 (port of the
static half of femo_tpu/models/fsi.py).

VLM -> RBF force map -> RM shell solve -> RBF displacement map -> lattice
update, iterated as a damped Gauss-Seidel fixed point (the reference
couples through csdl.NonlinearBlockGS,
run_aeroelasticity_static_w_feedback.py:346-355).

* `build_wing_fsi`: the coupled problem through the composite op (dense,
  block-Thomas or scipy inner solves) and the differentiable fixed point
  of graph/fixed_point.py.
* `build_fsi_jit_step`: the coupled optimization iteration at reference
  scale (the 107,520-cell eVTOL wing class,
  run_aeroelasticity_static_w_feedback.py:55).  The RM shell operator is
  linear and fixed for a given thickness, so it is filled and factored
  once per design point; every Gauss-Seidel pass is a VLM solve, a
  right-hand-side assembly and block-Thomas solves (the sweeps K1/K2 on
  CUDA tensors), polished by PCG against the f64 operator.  The coupled
  IFT adjoint reuses the factor (K^T = K), and each of its passes applies
  the constant force-load operator's transpose (one K4T launch per block
  on CUDA tensors) and a vector-Jacobian product through the VLM and the
  RBF maps.

Deliberate departures from the JAX builder, which exist there only for
the TPU runtime: no `pcg_maxiter` depth clamp (the note for an rtol below
1e-9 stays); one factor loop at every size (no `factor_chunked` past 4096
blocks); the adjoint passes run as one host loop (no chunked adjoint
programs); the maps and term data are plain tensors, not program
arguments, so the programs take no `consts`.  `factor_compute_dtype=
"mixed"` computes the plain f64 block inverses, as the shell's does, and
takes no `mixed_ns` / `mixed_tol`.  `factor_method="cr"` and
`factor_compute_dtype="float32"` belong to ROADMAP slice D2b and raise.
The dynamic FSI (W8) and the external-load regime (W9) are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config, get_device
from ..fea.assemble import ElementMatrix, compile_form
from ..fea.bc import DirichletBC, apply_bc, constrain_residual
from ..fea.project import lumped_mass
from ..graph.fixed_point import fixed_point_solve, fixed_point_solve_jit
from ..mesh.generators import create_rectangle_mesh
from ..mesh.mesh import Mesh
from ..ops.block_tridiag import (
    BlockThomasFactor, BlockTridiagonalMatrix, BlockTridiagTemplate,
    pcg_fixed, pcg_tol)
from .coupling import NodalMap, force_map_mass_weighted
from .shell import RMShellModel
from .vlm import VLM, flat_wing_lattice_np

D2B = "ROADMAP slice D2b"


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

    def clamp(x):
        return np.isclose(x[1], 0.0)

    bcs = [DirichletBC(shell.Vu, 0.0, where=clamp),
           DirichletBC(shell.Vth, 0.0, where=clamp)]
    return mesh, shell, shell.make_state(bcs)


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


def _composite_bt_template(state):
    """RCM block-tridiagonal template of the (u, theta) composite
    Jacobian, from its pattern (host dofmaps, no assembly)."""
    return BlockTridiagTemplate(state.jacobian_pattern(), free=state.free,
                                device=state.device)


class _BTPrograms:
    """fill + factor of the composite operator (the JAX package's
    `_bt_factor_programs`, Thomas factor only), as separate stages that
    share the (D, L, U, Sinv, C) carry.  D/L/U stay in the working dtype
    (f64) whatever the factor storage: rounding the operator to f32 is
    what the RM composite cannot tolerate; only the preconditioner's Sinv
    and C are rounded to `store` (kept in the working dtype, see
    `BlockTridiagonalMatrix.factor`), and the PCG polish runs against the
    f64 operator.  (The rounded factor is not symmetric, so on
    ill-conditioned wings the polish stagnates above a tight rtol.)"""

    def __init__(self, tpl, jac_blocks, n_dofs, free, bv, store):
        self.tpl, self.jac_blocks = tpl, jac_blocks
        self.n_dofs, self.free, self.bv = n_dofs, free, bv
        self.store = store
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

    def factor_core(self, D, L, U):
        """(Sinv, C): the block-Thomas factor of the SPD operator."""
        with torch.no_grad():
            fac = self.matrix(D, L, U).factor(self.store, spd=True)
        return fac.Sinv, fac.C

    def factor(self, tarr):
        D, L, U = self.fill(tarr)
        return (D, L, U) + tuple(self.factor_core(D, L, U))

    def unpack(self, carry):
        D, L, U, Sinv, C = carry
        mat = self.matrix(D, L, U)
        return mat, BlockThomasFactor(mat, Sinv, C)


def _unported(factor_method, factor_compute_dtype):
    if factor_method == "cr":
        raise NotImplementedError(
            f"factor_method='cr' (block cyclic reduction) is {D2B}")
    if factor_compute_dtype == "float32":
        raise NotImplementedError(
            "factor_compute_dtype='float32' (the equilibrated f32 factor "
            f"recursion and mixed-dtype sweeps) is {D2B}")


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
        """K_c^{-1} b: one block-Thomas solve (K1 + K2 on CUDA tensors;
        sweeps "scan" and "pallas" alike) and the PCG polish."""
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
        call and kept."""
        if self._fm is None:
            z = lambda V: torch.zeros(V.n_dofs, dtype=config.dtype,  # noqa
                                      device=self.dev)
            sh = self.shell
            with torch.no_grad():
                self._fm = self.ucf.matrix(
                    {"u": z(sh.Vu), "theta": z(sh.Vth),
                     "thickness": z(sh.Vt), "force": z(sh.Vf)}, "force",
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
                       pcg_maxiter: int = 60, device=None):
    """The reference-scale static aeroelastic FSI iteration on `device`
    (default `config.device`, the card).

    Stages sharing one factor carry (D, L, U, Sinv, C):

      factor(tarr) -> carry            fill + one block-Thomas factor
      gs(carry, tarr, d)               gs_inner damped Gauss-Seidel passes
          -> (d_new, rel_delta)          (VLM + right-hand side + solves
                                         per pass; no refactor)
      finalize(carry, tarr, d)         converged outputs and the force-
          -> outputs dict                conservation pair
      adjoint(carry, tarr, x)          coupled IFT adjoint
          -> (J, dJ/dt, adj_delta)

    (`fill(tarr) -> (D, L, U)` and `factor_core(D, L, U) -> (Sinv, C)`
    are the factor's two halves.)  Matches
    run_aeroelasticity_static_w_feedback.py:346-355 at its :55 mesh scale
    with n_shell=(4, 13440), n_vlm=(4, 32), span=30, thickness=0.05.

    Every inner solve is a block-Thomas solve (K1 then K2 on CUDA
    tensors, for sweeps "scan" and "pallas" alike: the CUDA sweeps are
    the port of the Pallas ones) followed by `pcg_iters` fixed PCG
    iterations or, with `pcg_rtol` set, PCG to that tolerance (at most
    `pcg_maxiter` iterations) against the f64 operator.  `stats` counts
    the inner solves ("solves") and the preconditioner applications of
    the polish ("precond"; "pcg_iters" lists pcg_tol's iteration counts),
    so K1/K2 launch solves + precond times each.

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
    if factor_method not in ("thomas", "cr"):
        raise ValueError(f"factor_method must be 'thomas' or 'cr', "
                         f"got {factor_method!r}")
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
    if factor_compute_dtype not in (None, "mixed", "float32"):
        raise ValueError(f"factor_compute_dtype must be None, 'mixed' or "
                         f"'float32', got {factor_compute_dtype!r}")
    _unported(factor_method, factor_compute_dtype)
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

    tpl = _composite_bt_template(state)
    # factor_compute_dtype None or "mixed": the same plain f64 inverses
    bt = _BTPrograms(tpl, jac_blocks, n_dofs, free, bv, factor_store_dtype)
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
