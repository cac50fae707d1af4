"""Reissner-Mindlin shell on arbitrary 3D midsurface meshes (workload W6;
port of femo_tpu/models/shell.py).

Formulation: flat-facet RM with per-quadrature-point local frames from the
geometry Jacobian (g.J).  Fields: midsurface displacement u in CG2(3) and
rotation theta in CG1(3), assembled as a CompositeState (block residual
and Jacobian).  Thickness is a DG0 design field.

Energy density (isotropic CLT): membrane A = E t/(1-nu^2), bending
D = E t^3/(12(1-nu^2)), shear 5/6 G t, drilling penalty alpha G t.  The
residuals are directional derivatives of the energy density,
`torch.func.jvp` inside the integrand (the JAX package's nested
`jax.jvp`), under the assembly's vmap / grad / jacfwd.
Outputs: compliance, mass, elastic energy, von Mises p-norm aggregate.

Every block-Thomas solve of the shell (the compliance step, the
composite op's "jit_bt" mode, the Lanczos modes) runs the sweeps K1/K2 on
CUDA tensors (ops/bt_sweeps.py).  `build_shell_sharded_step` is the
cells-sharded step (mode a, parallel/sharding.py) with a replicated dense
solve.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp

from ..config import config, get_device
from ..fea.assemble import compile_form
from ..fea.bc import DirichletBC
from ..fea.composite import CompositeState, composite_implicit_op
from ..fea.forms import FormDef, ds, dx
from ..fea.space import Function, FunctionSpace


def local_frame(Jg):
    """Orthonormal (t1, t2, n) from the geometry Jacobian (3, 2)."""
    a1 = Jg[:, 0]
    a2 = Jg[:, 1]
    t1 = a1 / torch.linalg.norm(a1)
    nv = torch.linalg.cross(a1, a2)
    n = nv / torch.linalg.norm(nv)
    t2 = torch.linalg.cross(n, t1)
    return t1, t2, n


def _d(gradf, a, b):
    """b . (grad f @ a)."""
    return torch.dot(b, gradf @ a)


def shell_energy_density(uval, ugrad, thval, thgrad, t, frame, E, nu,
                         drill=1.0e-1):
    """RM shell strain energy per unit area at one quadrature point.

    ugrad/thgrad: (3,3) tangential gradients; t: thickness; frame=(t1,t2,n).
    """
    t1, t2, n = frame
    G = E / (2 * (1 + nu))
    A = E * t / (1 - nu**2)
    D = E * t**3 / (12 * (1 - nu**2))
    ks = 5.0 / 6.0

    # membrane strains (tangential)
    e11 = _d(ugrad, t1, t1)
    e22 = _d(ugrad, t2, t2)
    e12 = 0.5 * (_d(ugrad, t1, t2) + _d(ugrad, t2, t1))
    # normal-rotation components phi_a = t_a . theta
    p1 = torch.dot(t1, thval)
    p2 = torch.dot(t2, thval)
    # curvatures
    k11 = _d(thgrad, t1, t1)
    k22 = _d(thgrad, t2, t2)
    k12 = 0.5 * (_d(thgrad, t1, t2) + _d(thgrad, t2, t1))
    # transverse shear gamma_a = d_a w - phi_a
    g1 = _d(ugrad, t1, n) - p1
    g2 = _d(ugrad, t2, n) - p2
    # drilling rotation
    dr = torch.dot(n, thval)

    psi_m = 0.5 * A * ((1 - nu) * (e11**2 + 2 * e12**2 + e22**2)
                       + nu * (e11 + e22) ** 2)
    psi_b = 0.5 * D * ((1 - nu) * (k11**2 + 2 * k12**2 + k22**2)
                       + nu * (k11 + k22) ** 2)
    psi_s = 0.5 * ks * G * t * (g1**2 + g2**2)
    psi_d = 0.5 * drill * G * t * dr**2
    return psi_m + psi_b + psi_s + psi_d


def von_mises_surface(uval, ugrad, thval, thgrad, t, frame, E, nu):
    """von Mises stress at the shell surface z = t/2 (membrane +
    bending)."""
    t1, t2, n = frame
    e11 = _d(ugrad, t1, t1)
    e22 = _d(ugrad, t2, t2)
    e12 = 0.5 * (_d(ugrad, t1, t2) + _d(ugrad, t2, t1))
    k11 = _d(thgrad, t1, t1)
    k22 = _d(thgrad, t2, t2)
    k12 = 0.5 * (_d(thgrad, t1, t2) + _d(thgrad, t2, t1))
    z = t / 2
    C = E / (1 - nu**2)
    s11 = C * ((e11 + z * k11) + nu * (e22 + z * k22))
    s22 = C * ((e22 + z * k22) + nu * (e11 + z * k11))
    s12 = C * (1 - nu) * (e12 + z * k12)
    return torch.sqrt(s11**2 - s11 * s22 + s22**2 + 3 * s12**2 + 1e-20)


class RMShellModel:
    """RM shell problem on a triangle or quad 3D midsurface, on one device
    (default `config.device`, the card).

    Parameters: mesh with 3D coords, material (E, nu, rho), drilling
    penalty, and the tag of boundary edges carrying the per-length
    traction `edge_force` (None: no edge load).  Fields: DG0 thickness,
    CG1(3) per-area traction `force`.
    """

    def __init__(self, mesh, E: float, nu: float, rho: float = 1.0,
                 drill: float = 1e-1, edge_load_tag: int | None = None,
                 device=None):
        if mesh.gdim != 3 or mesh.cell_type not in ("triangle", "quad"):
            raise ValueError("RMShellModel needs a triangle or quad mesh "
                             "with 3D coordinates")
        device = get_device(device)
        self.mesh = mesh
        self.E, self.nu, self.rho = E, nu, rho
        self.drill = drill
        self.Vu = FunctionSpace(mesh, ("CG", 2), ncomp=3, device=device)
        self.Vth = FunctionSpace(mesh, ("CG", 1), ncomp=3, device=device)
        self.Vt = FunctionSpace(mesh, ("DG", 0), device=device)
        self.Vf = FunctionSpace(mesh, ("CG", 1), ncomp=3, device=device)
        self.u = Function(self.Vu, "u")
        self.theta = Function(self.Vth, "theta")
        self.thickness = Function(self.Vt, "thickness")
        self.force = Function(self.Vf, "force")  # per-area traction
        self.edge_load_tag = edge_load_tag
        self.edge_force = Function(self.Vf, "edge_force")  # per length

        E_, nu_, drill_ = E, nu, drill

        def r_u(w, g):
            frame = local_frame(g.J)

            def psi(uv, ug):
                return shell_energy_density(
                    uv, ug, w.theta.val, w.theta.grad, w.thickness.val,
                    frame, E_, nu_, drill_)

            dpsi = jvp(psi, (w.u.val, w.u.grad), (w.v.val, w.v.grad))[1]
            return dpsi - torch.dot(w.force.val, w.v.val)

        def r_th(w, g):
            frame = local_frame(g.J)

            def psi(tv, tg):
                return shell_energy_density(
                    w.u.val, w.u.grad, tv, tg, w.thickness.val,
                    frame, E_, nu_, drill_)

            return jvp(psi, (w.theta.val, w.theta.grad),
                       (w.v.val, w.v.grad))[1]

        coeffs = [self.u, self.theta, self.thickness, self.force]
        u_integrals = [dx(r_u, qdeg=4)]
        if edge_load_tag is not None:
            u_integrals.append(ds(
                lambda w, g: -torch.dot(w.edge_force.val, w.v.val),
                tag=edge_load_tag, qdeg=4))
            coeffs = coeffs + [self.edge_force]
        self.res_u = FormDef(u_integrals, coeffs=coeffs, test=self.Vu)
        self.res_th = FormDef([dx(r_th, qdeg=4)], coeffs=coeffs,
                              test=self.Vth)

        # output functionals
        def compliance(w, g):
            return torch.dot(w.force.val, w.u.val)

        def mass(w, g):
            return rho * w.thickness.val

        def energy(w, g):
            frame = local_frame(g.J)
            return shell_energy_density(
                w.u.val, w.u.grad, w.theta.val, w.theta.grad,
                w.thickness.val, frame, E_, nu_, drill_)

        self.compliance_form = FormDef([dx(compliance, qdeg=4)],
                                       coeffs=[self.u, self.force])
        self.mass_form = FormDef([dx(mass)], coeffs=[self.thickness])
        self.energy_form = FormDef([dx(energy, qdeg=4)], coeffs=coeffs)

    def _svm(self, w, g):
        return von_mises_surface(
            w.u.val, w.u.grad, w.theta.val, w.theta.grad,
            w.thickness.val, local_frame(g.J), self.E, self.nu)

    def pnorm_stress_form(self, p: float = 8.0, m: float = 1.0):
        """p-norm von Mises aggregate integrand: int (svm/m)^p dx;
        aggregate = m * (value)^(1/p)."""
        return FormDef(
            [dx(lambda w, g: (self._svm(w, g) / m) ** p, qdeg=4)],
            coeffs=[self.u, self.theta, self.thickness, self.force])

    def von_mises_field_form(self, V_cg1):
        """1-form for projecting svm onto CG1 (field output)."""
        return FormDef([dx(lambda w, g: self._svm(w, g) * w.v, qdeg=4)],
                       coeffs=[self.u, self.theta, self.thickness],
                       test=V_cg1)

    def make_state(self, bcs):
        """CompositeState over (u, theta)."""
        return CompositeState(
            [self.u, self.theta],
            {"u": self.res_u, "theta": self.res_th}, bcs)

    def energy_estimate(self, state, x, thickness, force):
        """(J(x), J_E(x)) at a composite state x: the compliance and its
        energy estimate J_E = 2 (J(x) - E(x)) = J* - ||x - x*||_K^2 (E the
        strain energy, a sum of squares), second order in x's error where
        J is first order."""
        parts = state.split(x)
        vals = {"u": parts["u"], "theta": parts["theta"],
                "thickness": thickness, "force": force}
        with torch.no_grad():
            J = compile_form(self.compliance_form).scalar(vals)
            E = compile_form(self.energy_form).scalar(vals)
        return float(J), float(2 * J - 2 * E)

    def solve(self, bcs, inputs=None, linear_solver=None,
              newton_opts=None, solve_mode="jit_bt"):
        """Solve the composite (u, theta) state and write it back into the
        fields.  solve_mode "jit_bt" (default: one Newton step through the
        block-Thomas factor, exact for the linear shell) or "jit_dense";
        "eager" (or any given LinearSolver) runs the host Newton loop."""
        from ..solvers.linear import LinearSolver

        state = self.make_state(bcs)
        if solve_mode in ("jit_bt", "jit_dense") and linear_solver is None:
            op = composite_implicit_op(
                state, ["thickness", "force"],
                newton_opts={"jit_newton_iters": 1, **(newton_opts or {})},
                mode=solve_mode)
        else:
            op = composite_implicit_op(
                state, ["thickness", "force"],
                linear_solver=linear_solver or LinearSolver(method="scipy"),
                newton_opts={"maxiter": 10, **(newton_opts or {})})
        x = op(inputs or {}, state.current())
        state.push(x)
        return state, op, x


def modal_operators(shell: RMShellModel, bcs, thickness=None):
    """(state, K, m) of the modal problem: the composite state, its
    stiffness (an ElementMatrix at u = 0) and the lumped mass diagonal
    (translational rho t; rotary rho t^3/12), from the mass matrix's
    DIAGONAL (positive even for CG2, where row-sum lumping gives zero
    vertex masses), HRZ-scaled to keep the total mass per component.
    `thickness` replaces the shell's thickness field first."""
    state = shell.make_state(bcs)
    dev = state.device
    if thickness is not None:
        shell.thickness.array = torch.as_tensor(
            np.asarray(thickness, np.float64), dtype=config.dtype,
            device=dev)
    K_em = state.jacobian(
        torch.zeros(state.n_dofs, dtype=config.dtype, device=dev), {})
    du_ = Function(shell.Vu, "du_")
    dth_ = Function(shell.Vth, "dth_")

    def m_u(w, g):
        return shell.rho * w.thickness.val * torch.dot(w.du_.val, w.v.val)

    def m_th(w, g):
        return (shell.rho * w.thickness.val ** 3 / 12.0
                * torch.dot(w.dth_.val, w.v.val))

    def hrz_diag(integrand, dummy):
        V = dummy.space
        cf = compile_form(FormDef([dx(integrand, qdeg=4)],
                                  coeffs=[dummy, shell.thickness], test=V))
        M = cf.matrix({dummy.name: V.new_array(),
                       "thickness": shell.thickness.array}, dummy.name)
        d = M.diagonal()
        total = torch.sum(M.matvec(V.new_array(1.0)))
        return d * (total / torch.sum(d))

    return state, K_em, torch.cat([hrz_diag(m_u, du_), hrz_diag(m_th, dth_)])


def shell_modal_analysis(shell: RMShellModel, bcs, n_modes: int = 6,
                         thickness=None, method: str = "dense",
                         lanczos_iters: int | None = None, seed: int = 0):
    """Natural frequencies and modes of the RM shell.

    Generalized symmetric eigenproblem K phi = omega^2 M phi with the
    composite (u, theta) stiffness and the lumped mass of
    `modal_operators`, reduced to standard form by the lumped-mass square
    root.  Returns (frequencies_hz (n_modes,), modes (n_dofs, n_modes)).

    method="dense": one `torch.linalg.eigh` on the free dofs (test
    scale).  method="lanczos": shift-invert Lanczos on the block-Thomas
    factor of K; each iteration is one solve (K1/K2 on CUDA tensors).
    Full reorthogonalization; lanczos_iters defaults to
    max(2 n_modes + 16, 40).
    """
    if method not in ("dense", "lanczos"):
        raise ValueError(f"method={method!r}: 'dense' or 'lanczos'")
    state, K_em, m = modal_operators(shell, bcs, thickness)
    dev = state.device
    free_np = state.free.cpu().numpy()
    if method == "lanczos":
        return _modal_lanczos(K_em, m, free_np, n_modes,
                              lanczos_iters or max(2 * n_modes + 16, 40),
                              seed)

    # dense path: reduce to the free dofs (a large-penalty embedding would
    # destroy the relative accuracy of the low eigenvalues)
    K = K_em.to_dense()
    free_idx = torch.as_tensor(np.nonzero(free_np)[0], device=dev)
    Kf = K[free_idx][:, free_idx]
    mf = torch.clamp(m[free_idx], min=1e-30)
    s = 1.0 / torch.sqrt(mf)
    A = (Kf * s[:, None]) * s[None, :]
    A = 0.5 * (A + A.T)
    w2, V = torch.linalg.eigh(A)
    w2 = torch.clamp(w2[:n_modes], min=0.0)
    freqs = torch.sqrt(w2) / (2 * np.pi)
    modes = torch.zeros((state.n_dofs, n_modes), dtype=config.dtype,
                        device=dev)
    modes[free_idx] = s[:, None] * V[:, :n_modes]
    return freqs, modes


def _modal_lanczos(K_em, m, free_np, n_modes, k, seed):
    """Shift-invert (shift 0) Lanczos for the lowest shell modes.

    Standard form A = M^{-1/2} K M^{-1/2}; Lanczos runs on A^{-1} =
    M^{1/2} K^{-1} M^{1/2}, whose largest eigenvalues are the lowest
    omega^2; each application is one block-Thomas solve.  Full
    reorthogonalization, twice, against the stored basis (a preallocated
    (k+1, n) buffer whose unwritten rows are zero, as in the JAX package),
    a breakdown check on the host each iteration.
    """
    from ..ops.block_tridiag import BlockTridiagonalMatrix

    mat = BlockTridiagonalMatrix.from_element_matrix(K_em, free=free_np)
    fac = mat.factor(spd=True)
    dev = m.device
    freet = torch.as_tensor(free_np, device=dev)
    sqrt_m = torch.where(freet, torch.sqrt(torch.clamp(m, min=1e-30)), 0.0)

    n = m.shape[0]
    k = int(min(k, int(free_np.sum())))
    rng = np.random.default_rng(seed)
    v0 = np.where(free_np, rng.standard_normal(n), 0.0)
    v0 = v0 / np.linalg.norm(v0)

    V = torch.zeros((k + 1, n), dtype=config.dtype, device=dev)
    V[0] = torch.as_tensor(v0, dtype=config.dtype, device=dev)
    v_prev = torch.zeros(n, dtype=config.dtype, device=dev)
    beta_prev = torch.zeros((), dtype=config.dtype, device=dev)
    tiny = torch.finfo(config.dtype).tiny
    alphas, betas = [], []
    for j in range(k):
        v = V[j]
        w = sqrt_m * fac.solve(sqrt_m * v)
        alpha = torch.dot(v, w)
        w = w - alpha * v - beta_prev * v_prev
        for _ in range(2):  # full reorthogonalization, twice
            w = w - V.T @ (V @ w)
        beta = torch.linalg.norm(w)
        V[j + 1] = w / torch.clamp(beta, min=tiny)
        v_prev = v
        a, b = float(alpha), float(beta)
        alphas.append(a)
        if j == k - 1 or b < 1e-14 * max(abs(a), 1.0):  # breakdown / room
            break
        betas.append(b)
        beta_prev = beta

    T = np.diag(np.asarray(alphas))
    if betas:
        T += np.diag(betas, 1) + np.diag(betas, -1)
    mu, Y = np.linalg.eigh(T)  # ascending; largest mu = lowest omega^2
    nm = min(n_modes, len(mu))
    sel = np.argsort(mu)[::-1][:nm]
    w2 = 1.0 / np.maximum(mu[sel], 1e-300)
    freqs = torch.as_tensor(np.sqrt(np.maximum(w2, 0.0)) / (2 * np.pi),
                            dtype=config.dtype, device=dev)
    Vm = V[:len(alphas)]  # (k_used, n)
    Z = Vm.T @ torch.as_tensor(Y[:, sel], dtype=config.dtype, device=dev)
    inv_sqrt_m = torch.where(
        freet, 1.0 / torch.clamp(sqrt_m, min=1e-300), 0.0)
    return freqs, inv_sqrt_m[:, None] * Z


def plate_shell(n_shell=(16, 24), span=4.0, chord=1.0, E=7e10, nu=0.3,
                thickness=0.01, device=None):
    """The compliance step's flat rectangular plate: (chord x span)
    triangles in the z = 0 plane, clamped at y = 0.  Returns (shell,
    bcs)."""
    from ..mesh.generators import create_rectangle_mesh
    from ..mesh.mesh import Mesh

    ncs, nss = n_shell
    m2 = create_rectangle_mesh(ncs, nss, 0, 0, chord, span,
                               cell_type="triangle")
    coords3 = np.concatenate([m2.coords, np.zeros((m2.n_nodes, 1))], axis=1)
    mesh = Mesh(coords3, m2.cells, "triangle")
    shell = RMShellModel(mesh, E=E, nu=nu, device=device)
    shell.thickness.set(thickness)

    def clamp(x):
        return np.isclose(x[1], 0.0)

    bcs = [DirichletBC(shell.Vu, 0.0, where=clamp),
           DirichletBC(shell.Vth, 0.0, where=clamp)]
    return shell, bcs


def build_shell_jit_step(n_shell=(16, 24), span=4.0, chord=1.0,
                         E=7e10, nu=0.3, thickness=0.01,
                         pressure=2.0e3, solve_mode="jit_bt",
                         pcg_iters=0, factor_method="thomas",
                         adjoint="refactor", jacobi_scale=False,
                         factor_store_dtype=None, split_programs=False,
                         spd=True, factor_compute_dtype=None,
                         device=None):
    """The shell thickness-optimization iteration at any mesh size:
    thickness -> (compliance, d compliance / d thickness), on `device`
    (default `config.device`, the card).

    n_shell=(24, 400) is the JAX package's reference-scale demonstrator:
    19,200 cells, 147,822 composite dofs, an RCM block-tridiagonal layout
    of nb=289 blocks of B=512.  solve_mode="jit_bt": forward solve and
    IFT adjoint through the block-Thomas factor (K1/K2 on CUDA tensors),
    `pcg_iters` fixed PCG polish steps; "jit_dense": dense LU.

    split_programs=True: the adjoint reuses the forward's factor (A^T = A
    for the energy Hessian).  The JAX package compiles the forward and
    the adjoint as two programs; here it is `implicit_solve_bt`'s
    adjoint="reuse_symmetric", whose arithmetic it is.  It requires
    spd=True, jacobi_scale=False, factor_method="thomas",
    adjoint="refactor" (the JAX package's guard).
    factor_compute_dtype: None or "mixed" (split_programs only).  "mixed"
    is the JAX package's f32-seeded, Newton-Schulz-refined block inverse
    (its mixed_ns / mixed_tol), which exists to get round the TPU's
    emulated f64; the port accepts it and computes the plain f64 inverse
    (a deliberate departure), so it takes neither parameter.
    factor_store_dtype: `BlockTridiagonalMatrix.factor`'s store_dtype.

    Returns (step, t0, info): step(thickness) -> (J, dJ/dt), t0 the
    uniform thickness, info the JAX package's keys (mesh, shell, state,
    n_dofs, n_cells, programs, consts, bt_tpl); programs holds `step` and
    `solve(thickness) -> x`, the step's forward solve alone.
    """
    from ..graph.implicit import implicit_solve_bt, implicit_solve_dense
    from ..ops.block_tridiag import BlockTridiagTemplate

    if solve_mode not in ("jit_bt", "jit_dense"):
        raise ValueError(f"solve_mode={solve_mode!r}: 'jit_bt' or "
                         "'jit_dense'")
    split = split_programs and solve_mode == "jit_bt"
    if factor_compute_dtype is not None and not split:
        raise ValueError("factor_compute_dtype is implemented on the "
                         "split_programs jit_bt path only")
    if split:
        if not spd:
            raise ValueError("split_programs path assumes the symmetric "
                             "(SPD energy-Hessian) shell operator")
        if jacobi_scale or factor_method != "thomas" or adjoint != "refactor":
            raise ValueError(
                "split_programs builds its own forward/adjoint pair and "
                "supports only jacobi_scale=False, factor_method='thomas', "
                "adjoint='refactor' (got jacobi_scale=%r, factor_method=%r, "
                "adjoint=%r)" % (jacobi_scale, factor_method, adjoint))
        if factor_compute_dtype not in (None, "mixed"):
            raise ValueError("shell factor_compute_dtype supports only "
                             "'mixed' (thin-shell conditioning rules out "
                             f"the f32 recursion), got "
                             f"{factor_compute_dtype!r}")
        adjoint = "reuse_symmetric"

    shell, bcs = plate_shell(n_shell, span, chord, E, nu, thickness, device)
    dev = shell.Vu.device
    state = shell.make_state(bcs)
    free, bv = state.free, state.bc_values
    off_th = shell.Vu.n_dofs
    n_dofs = state.n_dofs
    ccf = compile_form(shell.compliance_form)

    # uniform transverse pressure as the nodal traction field
    farr = np.zeros(shell.Vf.n_dofs)
    farr[2::3] = pressure
    force = torch.as_tensor(farr, dtype=config.dtype, device=dev)

    def inputs(p):
        return {"thickness": p["thickness"], "force": force}

    def residual(x, p):
        return state.residual(x, inputs(p))

    def jac_blocks(x, p):
        return state.jacobian_blocks(x, inputs(p))

    def compliance(x):
        return ccf.scalar({"u": x[:off_th], "force": force})

    def zeros():
        return torch.zeros(n_dofs, dtype=config.dtype, device=dev)

    tpl = None
    if solve_mode == "jit_bt":
        tpl = BlockTridiagTemplate(state.jacobian_pattern(), free=free,
                                   device=dev)
        solve = implicit_solve_bt(
            residual, jac_blocks, tpl, free, bv, newton_iters=1,
            pcg_iters=pcg_iters, factor_method=factor_method,
            adjoint=adjoint, jacobi_scale=jacobi_scale,
            factor_store_dtype=factor_store_dtype, spd=spd)
    else:
        solve = implicit_solve_dense(
            residual,
            lambda x, p: state.jacobian(x, inputs(p)).to_dense(),
            free, bv, newton_iters=1)

    def step(tarr):
        t = tarr.detach().requires_grad_(True)
        with torch.enable_grad():
            J = compliance(solve({"thickness": t}, zeros()))
            (g,) = torch.autograd.grad(J, t)
        return J.detach(), g

    def forward(tarr):
        with torch.no_grad():
            return solve({"thickness": tarr}, zeros())

    t0 = torch.full((shell.Vt.n_dofs,), thickness, dtype=config.dtype,
                    device=dev)
    return step, t0, dict(mesh=shell.mesh, shell=shell, state=state,
                          n_dofs=n_dofs, n_cells=shell.mesh.n_cells,
                          programs=dict(step=step, solve=forward),
                          consts={"force": force}, bt_tpl=tpl)


def build_shell_sharded_step(n_shell=(4, 6), span=2.0, chord=1.0,
                             E=7e10, nu=0.3, thickness=0.01,
                             pressure=2.0e3, device_mesh=None, device=None):
    """The cells-sharded CG2CG1 shell compliance step: thickness ->
    (compliance, d compliance / d thickness), the W6 counterpart of the
    sharded motor step.

    With device_mesh (a `parallel.sharding.RankMesh`) the residual,
    Jacobian and compliance assembly run with the entities sharded over
    its ranks and one all-reduce each (mode a); the dense composite (u,
    theta) solve runs replicated on every rank and the IFT adjoint reuses
    its LU factors.  Without one, the same step on one device.  Small
    shapes only (a dense solve): the at-scale step is
    `build_shell_jit_step`.  `device` defaults to the rank's with a
    device_mesh, else to `config.device` (the card).  Returns (step, t0,
    info), info with mesh, shell and n_dofs.
    """
    from ..graph.implicit import implicit_solve_dense

    if device is None and device_mesh is not None:
        device = device_mesh.device
    shell, bcs = plate_shell(n_shell, span, chord, E, nu, thickness, device)
    dev = shell.Vu.device
    state = shell.make_state(bcs)
    free, bv = state.free, state.bc_values
    off_th = shell.Vu.n_dofs
    n_dofs = state.n_dofs
    ucf = compile_form(shell.res_u)
    tcf = compile_form(shell.res_th)
    ccf = compile_form(shell.compliance_form)

    farr = np.zeros(shell.Vf.n_dofs)
    farr[2::3] = pressure
    force = torch.as_tensor(farr, dtype=config.dtype, device=dev)
    cforms = {"u": ucf, "th": tcf}
    if device_mesh is None:
        # looked up at each call, as the profiler wraps them
        rfn = {k: (lambda vals, cf=cf: cf.vector(vals))
               for k, cf in cforms.items()}

        def c_fn(vals):
            return ccf.scalar(vals)

        jfn = {(k, wrt): (lambda vals, cf=cf, wrt=wrt: cf.matrix(
            vals, wrt).to_dense())
            for k, cf in cforms.items() for wrt in ("u", "theta")}
    else:
        from ..parallel.sharding import (
            sharded_matrix_dense_fn, sharded_scalar_fn, sharded_vector_fn)

        rfn = {k: sharded_vector_fn(cf, device_mesh)
               for k, cf in cforms.items()}
        c_fn = sharded_scalar_fn(ccf, device_mesh)
        jfn = {(k, wrt): sharded_matrix_dense_fn(cf, device_mesh, wrt)
               for k, cf in cforms.items() for wrt in ("u", "theta")}

    def values(x, p):
        return {"u": x[:off_th], "theta": x[off_th:],
                "thickness": p["thickness"], "force": force}

    def residual(x, p):
        vals = values(x, p)
        return torch.cat([rfn["u"](vals), rfn["th"](vals)])

    def jac_dense(x, p):
        vals = values(x, p)
        return torch.cat([torch.cat([jfn[(k, "u")](vals),
                                     jfn[(k, "theta")](vals)], dim=1)
                          for k in ("u", "th")])

    solve = implicit_solve_dense(residual, jac_dense, free, bv,
                                 newton_iters=1)

    def step(tarr):
        t = tarr.detach().requires_grad_(True)
        with torch.enable_grad():
            x = solve({"thickness": t},
                      torch.zeros(n_dofs, dtype=config.dtype, device=dev))
            J = c_fn({"u": x[:off_th], "force": force})
            (g,) = torch.autograd.grad(J, t)
        return J.detach(), g

    t0 = torch.full((shell.Vt.n_dofs,), thickness, dtype=config.dtype,
                    device=dev)
    return step, t0, dict(mesh=shell.mesh, shell=shell, n_dofs=n_dofs)
