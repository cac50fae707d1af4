"""Newton solver with damping and backtracking line search (port of
femo_tpu/solvers/newton.py::newton_solve).

A host loop: each iteration assembles the Jacobian, factors it with the
LinearSolver and reads the residual norm on the host.  Tolerance
defaults mirror the reference's SNES settings (atol/rtol 1e-13, at most
100 iterations).  The factorization of the last iteration is returned
for the adjoint.  `newton_solve_jit` (the matrix-free device loop) is not
ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..config import config
from ..fea.bc import apply_bc, constrain_residual
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
