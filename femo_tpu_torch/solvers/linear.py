"""Linear solver dispatch with boundary-condition-constrained operators
(port of femo_tpu/solvers/linear.py).

Backends behind one interface (`solve`, and `solve_t` for the adjoint):

* ``dense`` — densify the element matrix and LU-factor it on the device
  (`torch.linalg.lu_factor`).
* ``cg`` / ``bicgstab`` / ``gmres`` — Krylov on the device with Jacobi
  or Chebyshev preconditioning; the matvecs are ElementMatrix.matvec /
  rmatvec, i.e. the element SpMV kernels K4/K4T on CUDA tensors.
* ``scipy`` — host sparse LU (not differentiable; used only inside the
  implicit solve, whose backward never differentiates through it).
* ``block_thomas`` — RCM + block-tridiagonal Thomas direct solve
  (ops/block_tridiag.py); its solves are the sweep kernels K1/K2 on CUDA
  tensors.
* ``cg_bt`` / ``bicgstab_bt`` / ``gmres_bt`` — Krylov preconditioned by
  the block-Thomas factor; the adjoint's `solve_t` preconditions with the
  factor of the transpose.

The constrained operator is ``A_c = P A P + (I - P)`` with P the
projector onto free dofs.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..config import config
from ..fea.assemble import ElementMatrix
from ..ops.block_tridiag import BlockTridiagFactorization
from .krylov import KRYLOV


def constrained_matvec(matvec: Callable, free: torch.Tensor):
    def mv(x):
        y = matvec(torch.where(free, x, 0.0))
        return torch.where(free, y, x)

    return mv


class Factorization:
    """Solve/solve_t interface over a factorized constrained operator."""

    def solve(self, b: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def solve_t(self, b: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError


class DenseFactorization(Factorization):
    def __init__(self, emat: ElementMatrix, free: torch.Tensor):
        A = emat.to_dense()
        freef = free.to(A.dtype)
        A = A * freef[:, None] * freef[None, :] + torch.diag(1.0 - freef)
        self.lu, self.piv = torch.linalg.lu_factor(A)

    def solve(self, b):
        return torch.linalg.lu_solve(self.lu, self.piv, b[:, None])[:, 0]

    def solve_t(self, b):
        return torch.linalg.lu_solve(self.lu, self.piv, b[:, None],
                                     adjoint=True)[:, 0]


class KrylovFactorization(Factorization):
    def __init__(self, emat: ElementMatrix, free: torch.Tensor, method: str,
                 pc: str | None, rtol, atol, maxiter):
        self.mv = constrained_matvec(emat.matvec, free)
        self.mvt = constrained_matvec(emat.rmatvec, free)
        self.method = method
        self.rtol, self.atol, self.maxiter = rtol, atol, maxiter
        if pc == "jacobi":
            d = torch.where(free, emat.diagonal(), 1.0)
            d = torch.where(torch.abs(d) > 1e-30, d, 1.0)
            dinv = 1.0 / d
            self.M = lambda x: dinv * x
        elif pc and pc.startswith("chebyshev"):
            # "chebyshev" or "chebyshev:<degree>"
            from .precond import chebyshev_preconditioner

            deg = int(pc.split(":")[1]) if ":" in pc else 5
            d = torch.where(free, emat.diagonal(), 1.0)
            self.M = chebyshev_preconditioner(self.mv, d, degree=deg)
        else:
            self.M = None
        self.last_result = None

    def _run(self, mv, b):
        res = KRYLOV[self.method](mv, b, M=self.M, rtol=self.rtol,
                                  atol=self.atol, maxiter=self.maxiter)
        self.last_result = res
        return res.x

    def solve(self, b):
        return self._run(self.mv, b)

    def solve_t(self, b):
        return self._run(self.mvt, b)


class BlockThomasKrylovFactorization(KrylovFactorization):
    """Krylov preconditioned by the block-Thomas factor of the constrained
    operator; `solve_t` preconditions with the factor of its transpose,
    built at the first adjoint solve."""

    def __init__(self, emat, free, method, rtol, atol, maxiter):
        super().__init__(emat, free, method, None, rtol, atol, maxiter)
        self.bt = BlockTridiagFactorization(emat, free)

    def solve(self, b):
        self.M = self.bt._f.solve
        return self._run(self.mv, b)

    def solve_t(self, b):
        self.M = self.bt.transpose_factor().solve
        return self._run(self.mvt, b)


class ScipyLUFactorization(Factorization):
    """Host sparse direct LU."""

    def __init__(self, emat: ElementMatrix, free: torch.Tensor):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        A = emat.to_scipy_csr()
        freem = free.cpu().numpy()
        P = sp.diags(freem.astype(A.dtype))
        Ac = (P @ A @ P + sp.diags((~freem).astype(A.dtype))).tocsc()
        self._lu = spla.splu(Ac)
        self._device = free.device

    def _back(self, x):
        return torch.as_tensor(x, dtype=config.dtype, device=self._device)

    def solve(self, b):
        return self._back(self._lu.solve(b.detach().cpu().numpy()))

    def solve_t(self, b):
        return self._back(self._lu.solve(b.detach().cpu().numpy(),
                                         trans="T"))


class LinearSolver:
    """Configurable linear solver (KSP-options parity).

    method: "auto" | "dense" | "cg" | "bicgstab" | "gmres" | "scipy" |
    "block_thomas" | "cg_bt" | "bicgstab_bt" | "gmres_bt"
    "auto" picks dense direct up to ``config.dense_direct_max_dofs`` and
    bicgstab (or cg if symmetric=True) above.
    """

    def __init__(self, method: str = "auto", pc: str | None = "jacobi",
                 symmetric: bool = False, rtol: float | None = None,
                 atol: float | None = None, maxiter: int | None = None):
        self.method = method
        self.pc = pc
        self.symmetric = symmetric
        self.rtol = config.krylov_rtol if rtol is None else rtol
        self.atol = config.krylov_atol if atol is None else atol
        self.maxiter = config.krylov_maxiter if maxiter is None else maxiter

    def resolve_method(self, n: int) -> str:
        if self.method != "auto":
            return self.method
        if n <= config.dense_direct_max_dofs:
            return "dense"
        return "cg" if self.symmetric else "bicgstab"

    def factor(self, emat: ElementMatrix, free: torch.Tensor) \
            -> Factorization:
        method = self.resolve_method(emat.shape[0])
        if method == "dense":
            return DenseFactorization(emat, free)
        if method == "scipy":
            return ScipyLUFactorization(emat, free)
        if method == "block_thomas":
            return BlockTridiagFactorization(emat, free)
        if method.endswith("_bt") and method[:-3] in KRYLOV:
            return BlockThomasKrylovFactorization(
                emat, free, method[:-3], self.rtol, self.atol, self.maxiter)
        if method not in KRYLOV:
            raise ValueError(f"unknown LinearSolver method {method!r}")
        return KrylovFactorization(emat, free, method, self.pc, self.rtol,
                                   self.atol, self.maxiter)
