"""Newton solvers (port of femo_tpu/solvers/newton.py).

* `newton_solve` — damping and backtracking line search.  A host loop:
  each iteration assembles the Jacobian, factors it with the
  LinearSolver and reads the residual norm on the host.  Tolerance
  defaults mirror the reference's SNES settings (atol/rtol 1e-13, at
  most 100 iterations).  The factorization of the last iteration is
  returned for the adjoint.
* `newton_solve_jit` — matrix-free Newton-Krylov: the Jacobian action
  is `torch.func.jvp` of the constrained residual, no matrix is formed.
  The JAX package runs it as one `lax.while_loop`; here it is a host
  loop over device tensors with the same stopping rule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch.func import jvp

from ..config import config
from ..fea.bc import apply_bc, constrain_residual
from .krylov import bicgstab, cg
from .linear import LinearSolver


@dataclass
class NewtonInfo:
    iters: int
    resnorm: float
    resnorm0: float
    converged: bool


def newton_solve(
    res_fn: Callable,
    jac_fn: Callable,
    u0: torch.Tensor,
    free: torch.Tensor,
    bc_values: torch.Tensor,
    linear_solver: LinearSolver | None = None,
    rtol: float | None = None,
    atol: float | None = None,
    maxiter: int | None = None,
    damping: float = 1.0,
    line_search: str | None = None,  # None | "bt" (backtracking)
    report: bool | None = None,
):
    """Damped Newton with strong-BC masking.

    res_fn(u) -> R (n,); jac_fn(u) -> ElementMatrix.
    Returns (u, last Factorization, NewtonInfo); the factorization at the
    last iterate is reused by the adjoint.
    """
    rtol = config.newton_rtol if rtol is None else rtol
    atol = config.newton_atol if atol is None else atol
    maxiter = config.newton_maxiter if maxiter is None else maxiter
    report = config.report if report is None else report
    linear_solver = linear_solver or LinearSolver()

    u = apply_bc(u0, free, bc_values)
    Rc = constrain_residual(res_fn(u), u, free, bc_values)
    rn0 = float(torch.linalg.norm(Rc))
    rn = rn0
    fac = None
    it = 0
    if report:
        print(f"  Newton 0: ||R|| = {rn0:.6e}")
    while it < maxiter and rn > max(atol, rtol * max(rn0, 1e-300)):
        fac = linear_solver.factor(jac_fn(u), free)
        du = fac.solve(-Rc)
        alpha = damping
        if line_search == "bt":
            for _ in range(8):
                u_try = apply_bc(u + alpha * du, free, bc_values)
                R_try = constrain_residual(
                    res_fn(u_try), u_try, free, bc_values)
                rn_try = float(torch.linalg.norm(R_try))
                if rn_try < (1 - 1e-4 * alpha) * rn or rn_try < atol:
                    break
                alpha *= 0.5
            u, Rc, rn = u_try, R_try, rn_try
        else:
            u = apply_bc(u + alpha * du, free, bc_values)
            Rc = constrain_residual(res_fn(u), u, free, bc_values)
            rn = float(torch.linalg.norm(Rc))
        it += 1
        if report:
            print(f"  Newton {it}: ||R|| = {rn:.6e} (alpha={alpha})")
    converged = rn <= max(atol, rtol * max(rn0, 1e-300))
    if fac is None:
        # already converged at entry; factor once for the adjoint
        fac = linear_solver.factor(jac_fn(u), free)
    return u, fac, NewtonInfo(it, rn, rn0, bool(converged))


def newton_solve_jit(
    res_fn: Callable,
    u0: torch.Tensor,
    free: torch.Tensor,
    bc_values: torch.Tensor,
    rtol: float = 1e-10,
    atol: float = 1e-12,
    maxiter: int = 30,
    damping: float = 1.0,
    krylov: str = "cg",
    krylov_rtol: float = 1e-8,
    krylov_maxiter: int = 2000,
    diag_fn: Callable | None = None,
):
    """Matrix-free Newton-Krylov.  Each Krylov matvec is `torch.func.jvp`
    of the constrained residual at the current iterate; diag_fn(u)
    optionally returns the Jacobian diagonal for Jacobi preconditioning.
    Returns (u, ||R_c(u)|| as a tensor, Newton iterations)."""
    solver = cg if krylov == "cg" else bicgstab

    def Rc(u):
        return constrain_residual(res_fn(u), u, free, bc_values)

    u = apply_bc(u0, free, bc_values)
    R = Rc(u)
    rn0 = rn = torch.linalg.norm(R)
    tol = torch.clamp(rtol * rn0, min=atol)
    k = 0
    while k < maxiter and bool(rn > tol):
        def jvp_mv(w, u=u):
            wf = torch.where(free, w, 0.0)
            _, Jw = jvp(Rc, (u,), (wf,))
            return torch.where(free, Jw, w)

        M = None
        if diag_fn is not None:
            d = torch.where(free, diag_fn(u), 1.0)
            d = torch.where(torch.abs(d) > 1e-30, d, 1.0)
            M = lambda x, d=d: x / d  # noqa: E731
        res = solver(jvp_mv, -R, M=M, rtol=krylov_rtol,
                     maxiter=krylov_maxiter)
        u = apply_bc(u + damping * res.x, free, bc_values)
        R = Rc(u)
        rn = torch.linalg.norm(R)
        k += 1
    return u, rn, k
