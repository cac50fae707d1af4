"""Implicit (IFT) solves (port of femo_tpu/graph/implicit.py).

Each entry point is a `torch.autograd.Function` whose backward pass is
the implicit-function-theorem adjoint: one transpose solve at the
converged state plus a VJP of the residual with respect to the inputs.

* `ImplicitSolveOp` — the eager graph path's op (FEA states).  Mode
  "eager": a host Newton loop (`solvers/newton.py`) with any
  `LinearSolver` backend; the forward pass keeps the last Newton
  factorization on the autograd context (the JAX package keeps it in
  `_fac_stash`) and the backward pass solves with its `solve_t`.  With
  the Krylov backends every matvec of both passes is the element SpMV
  kernel (K4 forward, K4T adjoint) on CUDA tensors; with the block-Thomas
  backends every solve is the sweeps K1/K2.  Mode "jit_dense":
  `implicit_solve_dense` with `jit_newton_iters` Newton iterations (the
  JAX package's jitted mode; nothing is traced here).

* `implicit_solve_dense(...)` — fixed-count Newton with a dense LU of the
  constrained Jacobian, its factors kept for the transpose adjoint solve
  (the port of `implicit_solve_dense_jit`).

* `implicit_solve_jit(...)` — matrix-free Newton-Krylov forward
  (`newton_solve_jit`), CG or BiCGStab transpose adjoint whose matvec is
  a `torch.func.vjp` of the constrained residual at the solution.

* `implicit_solve_bt(...)` — fixed-count Newton through the
  block-tridiagonal template and the block-Thomas factor, with Shamanskii
  factor reuse (`refactor_every`, `freeze_operator`) and Jacobi scaling
  (the port of `implicit_solve_bt_jit`).  Only factor_method="thomas" and
  adjoint="refactor" are ported.
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch
from torch.func import vjp

from ..config import config
from ..fea.assemble import CompiledForm, ElementMatrix
from ..fea.bc import apply_bc, constrain_residual
from ..ops.block_tridiag import BlockThomasFactor, pcg_fixed
from ..solvers.linear import LinearSolver
from ..solvers.krylov import bicgstab, cg
from ..solvers.newton import newton_solve, newton_solve_jit


class ImplicitSolveOp:
    """A differentiable implicit solve u(p) defined by R(u, p) = 0.

    Parameters
    ----------
    cform : CompiledForm of the residual (test space = state space)
    state_name : coefficient name of the state u in the form
    arg_names : names of differentiable input coefficients p
    free, bc_values : strong-BC masking tensors
    linear_solver : LinearSolver used for Newton steps and the adjoint
    newton_opts : dict of newton_solve options
    custom_solve : optional callable (op, inputs: dict, u0) -> u replacing
        the default Newton loop (continuation hooks); it may call
        op.newton(...).
    mode : "eager" | "jit_dense" (dense-LU Newton with a fixed count,
        newton_opts["jit_newton_iters"], default 1)
    """

    def __init__(self, cform: CompiledForm, state_name: str,
                 arg_names: list[str], free, bc_values,
                 linear_solver: LinearSolver | None = None,
                 newton_opts: dict | None = None,
                 custom_solve: Callable | None = None,
                 mode: str = "eager"):
        if mode not in ("eager", "jit_dense"):
            raise ValueError(f"ImplicitSolveOp mode={mode!r}: 'eager' or "
                             "'jit_dense'")
        self.cform = cform
        self.state_name = state_name
        self.arg_names = list(arg_names)
        self.free = free
        self.bc_values = bc_values
        self.linear_solver = linear_solver or LinearSolver()
        self.newton_opts = dict(newton_opts or {})
        self.custom_solve = custom_solve
        self.n_dofs = cform.form.test.n_dofs
        self.mode = mode
        if mode == "jit_dense":
            self._solve = implicit_solve_dense(
                self.residual, lambda u, p: self.jacobian(u, p).to_dense(),
                free, bc_values,
                newton_iters=self.newton_opts.get("jit_newton_iters", 1))
        else:
            self._solve = _ift_solve(self._forward, self._adjoint)

    # -- residual / jacobian helpers -------------------------------------------
    def _values(self, u, inputs: dict):
        vals = {self.state_name: u}
        # fixed coefficients (exact solutions, material fields) default to
        # their Function arrays; differentiable inputs come from `inputs`
        form = self.cform.form
        for name, fobj in {**form.coeffs, **form.globals}.items():
            if name == self.state_name:
                continue
            vals[name] = inputs.get(name, fobj.array)
        return vals

    def residual(self, u, inputs: dict):
        return self.cform.vector(self._values(u, inputs))

    def jacobian(self, u, inputs: dict) -> ElementMatrix:
        return self.cform.matrix(self._values(u, inputs), self.state_name)

    def newton(self, inputs: dict, u0, **overrides):
        """Run the default Newton loop (usable from custom_solve hooks)."""
        opts = {**self.newton_opts, **overrides}
        opts.pop("jit_newton_iters", None)  # jit_dense-mode-only knob
        return newton_solve(lambda u: self.residual(u, inputs),
                            lambda u: self.jacobian(u, inputs), u0,
                            self.free, self.bc_values, self.linear_solver,
                            **opts)

    def _forward(self, inputs, u0):
        if self.custom_solve is not None:
            u = self.custom_solve(self, inputs, u0)
            fac = self.linear_solver.factor(self.jacobian(u, inputs),
                                            self.free)
            return u, fac
        u, fac, info = self.newton(inputs, u0)
        # warn only on a real miss, not a roundoff-floor near-miss of the
        # strict tolerance
        near = 100.0 * max(self.newton_opts.get("atol", 1e-13),
                           1e-12 * max(info.resnorm0, 1e-300))
        if not info.converged and info.resnorm > near:
            warnings.warn(
                f"Newton did not converge for state '{self.state_name}': "
                f"||R||={info.resnorm:.3e} after {info.iters} iters")
        return u, fac

    def _adjoint(self, u, inputs, fac, ubar):
        """The IFT adjoint with the forward pass's last factorization."""
        psi = torch.where(self.free, fac.solve_t(ubar), 0.0)
        return _vjp_inputs(self.residual, u, inputs, psi)

    def __call__(self, inputs: dict, u0=None):
        if u0 is None:
            u0 = torch.zeros(self.n_dofs, dtype=config.dtype,
                             device=self.free.device)
        return self._solve(inputs, u0.detach())


def _ift_solve(forward, backward):
    """solve(inputs: dict, u0) -> u as a `torch.autograd.Function`:
    forward(inputs, u0) -> (u, saved) runs without autograd, and
    backward(u, inputs, saved, ubar) -> dict of input cotangents is the
    IFT adjoint; u0 gets a zero gradient."""

    class _Solve(torch.autograd.Function):
        """(keys, u0, *input tensors in the order of keys) -> u."""

        @staticmethod
        def forward(ctx, keys, u0, *vals):
            u, ctx.extra = forward(dict(zip(keys, vals)), u0)
            ctx.keys = keys
            ctx.save_for_backward(u, *vals)
            return u

        @staticmethod
        def backward(ctx, ubar):
            u, *vals = ctx.saved_tensors
            pbar = backward(u, dict(zip(ctx.keys, vals)), ctx.extra, ubar)
            ctx.extra = None  # one backward per forward
            return (None, torch.zeros_like(u)) + tuple(
                pbar[k] for k in ctx.keys)

    def solve(inputs: dict, u0):
        keys = tuple(inputs)
        return _Solve.apply(keys, u0, *(inputs[k] for k in keys))

    return solve


def _load_scaler(load_steps, newton_iters, scale_inputs):
    """at_iteration(inputs, k): the inputs of Newton iteration k, scaled
    by its load step's factor (k // newton_iters + 1) / load_steps with
    `scale_inputs` (default: every input)."""

    def at_iteration(inputs, k):
        if load_steps == 1:
            return inputs
        s = (k // newton_iters + 1) / load_steps
        if scale_inputs is not None:
            return scale_inputs(inputs, s)
        return {name: v * s for name, v in inputs.items()}

    return at_iteration


def _vjp_inputs(residual_fn, u, inputs, psi):
    """pbar = -psi^T dR/dp through a VJP of the residual."""
    _, vjp_p = vjp(lambda p: residual_fn(u, p), inputs)
    (pbar,) = vjp_p(-psi)
    return pbar


def implicit_solve_dense(residual_fn: Callable, jac_dense_fn: Callable,
                         free, bc_values, newton_iters: int = 1,
                         load_steps: int = 1,
                         scale_inputs: Callable | None = None,
                         factorization: str = "lu"):
    """Differentiable Newton solve of residual_fn(u, inputs) = 0 with a
    dense factorization of the BC-constrained Jacobian
    (jac_dense_fn(u, inputs) -> (n, n)), the port of
    `implicit_solve_dense_jit`.

    `load_steps x newton_iters` Newton iterations; at iteration k the
    inputs are scaled by (k // newton_iters + 1) / load_steps
    (`scale_inputs`, default: every input).  The last iteration runs at
    the full inputs and keeps its factorization for the adjoint, a
    transpose solve with the same factors.  factorization: "lu"
    (`torch.linalg.lu_factor` / `lu_solve`) or "inv" (the explicit
    inverse).  Returns solve(inputs: dict of tensors, u0) -> u.
    """
    if factorization not in ("lu", "inv"):
        raise ValueError(f"factorization={factorization!r}: 'lu' or 'inv'")
    at_iteration = _load_scaler(load_steps, newton_iters, scale_inputs)

    def factor(A):
        if factorization == "inv":
            return torch.linalg.inv(A)
        return torch.linalg.lu_factor(A)

    def fsolve(fac, b, transpose=False):
        if factorization == "inv":
            return (fac.T if transpose else fac) @ b
        return torch.linalg.lu_solve(*fac, b[:, None],
                                     adjoint=transpose)[:, 0]

    def constrained(A):
        fr = free.to(A.dtype)
        return A * fr[:, None] * fr[None, :] + torch.diag(1.0 - fr)

    def newton_once(u, p):
        Rc = constrain_residual(residual_fn(u, p), u, free, bc_values)
        fac = factor(constrained(jac_dense_fn(u, p)))
        return apply_bc(u + fsolve(fac, -Rc), free, bc_values), fac

    def forward(inputs, u0):
        u = apply_bc(u0, free, bc_values)
        for k in range(load_steps * newton_iters - 1):
            u, _ = newton_once(u, at_iteration(inputs, k))
        # the last iterate at full load keeps its factors for the adjoint
        return newton_once(u, inputs)

    def backward(u, inputs, fac, ubar):
        psi = torch.where(free, fsolve(fac, ubar, transpose=True), 0.0)
        return _vjp_inputs(residual_fn, u, inputs, psi)

    return _ift_solve(forward, backward)


def implicit_solve_jit(residual_fn: Callable, free, bc_values,
                       newton_opts: dict | None = None):
    """Differentiable matrix-free solve of residual_fn(u, inputs) = 0:
    `newton_solve_jit` forward; the adjoint solves J^T psi = ubar with CG
    (or BiCGStab, newton_opts["krylov"]) whose matvec is the VJP of the
    constrained residual at u.  newton_opts: newton_solve_jit's options,
    with "krylov", "krylov_rtol" (default 1e-10) and "krylov_maxiter"
    (2000) shared by both passes.  Returns solve(inputs, u0) -> u."""
    opts = dict(newton_opts or {})
    kr = opts.pop("krylov", "cg")
    krylov_rtol = opts.pop("krylov_rtol", 1e-10)
    krylov_maxiter = opts.pop("krylov_maxiter", 2000)
    solver = cg if kr == "cg" else bicgstab

    def forward(inputs, u0):
        u, _, _ = newton_solve_jit(
            lambda uu: residual_fn(uu, inputs), u0, free, bc_values,
            krylov=kr, krylov_rtol=krylov_rtol,
            krylov_maxiter=krylov_maxiter, **opts)
        return u, None

    def backward(u, inputs, _, ubar):
        def Rc(uu):
            return constrain_residual(residual_fn(uu, inputs), uu, free,
                                      bc_values)

        _, vjp_u = vjp(Rc, u)

        def jtv(w):
            (Jtw,) = vjp_u(torch.where(free, w, 0.0))
            return torch.where(free, Jtw, w)

        r = solver(jtv, ubar, rtol=krylov_rtol, maxiter=krylov_maxiter)
        psi = torch.where(free, r.x, 0.0)
        return _vjp_inputs(residual_fn, u, inputs, psi)

    return _ift_solve(forward, backward)


def implicit_solve_bt(residual_fn: Callable, jac_blocks_fn: Callable,
                      template, free, bc_values, newton_iters: int = 1,
                      load_steps: int = 1,
                      scale_inputs: Callable | None = None,
                      pcg_iters: int = 0,
                      factor_method: str = "thomas",
                      adjoint: str = "refactor",
                      jacobi_scale: bool = False,
                      refactor_every: int = 1,
                      freeze_operator: bool = False):
    """Differentiable Newton solve of residual_fn(u, inputs) = 0 (strong
    BCs by row masking) through the block-tridiagonal template, the port
    of `implicit_solve_bt_jit`.  jac_blocks_fn(u, inputs) -> [(A_e, rows,
    cols), ...].  Returns solve(inputs: dict of tensors, u0) -> u.

    Each of the `load_steps x newton_iters` Newton iterations assembles
    the residual, solves with the block-Thomas factor (the sweeps K1/K2 on
    CUDA tensors) and, with `pcg_iters > 0`, polishes the step with
    `pcg_fixed` against the fresh operator.

    jacobi_scale: factor the equilibrated S A S and precondition with
    M(b) = S F'^{-1} S b.

    refactor_every: Shamanskii factor reuse.  The factor is computed only
    on iterations with k % refactor_every == 0; in between, the factor's
    (L, Sinv, C) of the last refactor iteration (and its scale) precondition
    the PCG polish, which runs against the freshly assembled operator, so
    the fixed point is unchanged.  The stale L must stay with its Sinv:
    the forward sweep reads both.  Requires Thomas and pcg_iters > 0.

    freeze_operator: classical Shamanskii.  Fill and factor only on
    refactor iterations; the carried (D, L, U) and factor precondition
    AND serve as the PCG operator; the residual is always fresh.
    Requires refactor_every > 1.  Departure from the JAX package: with
    jacobi_scale it raises ValueError, where the JAX package freezes an
    operator mixing raw D and U with the scaled L.

    The adjoint re-fills the operator at the converged u and factors its
    transpose (adjoint="refactor").  Only factor_method="thomas" and
    adjoint="refactor" are ported.  The JAX package's guard against
    `sweeps="pallas"` in f64 without a PCG polish has no counterpart: the
    Pallas sweeps ran in f32, the port's CUDA sweeps run in the working
    dtype.
    """
    if factor_method != "thomas":
        raise ValueError(f"factor_method={factor_method!r}: only 'thomas' "
                         "is ported")
    if adjoint != "refactor":
        raise ValueError(f"adjoint={adjoint!r}: only 'refactor' is ported")
    refactor_every = int(refactor_every)
    if refactor_every < 1:
        raise ValueError(f"refactor_every must be >= 1, got {refactor_every}")
    if freeze_operator and refactor_every == 1:
        raise ValueError("freeze_operator requires refactor_every > 1 "
                         "(with refactor_every=1 nothing is frozen)")
    if refactor_every > 1 and pcg_iters == 0:
        raise ValueError(
            "refactor_every > 1 requires pcg_iters > 0: intermediate "
            "Newton steps solve with a stale factor and need the "
            "fresh-operator PCG polish to bound their error")
    if freeze_operator and jacobi_scale:
        raise ValueError(
            "freeze_operator with jacobi_scale is refused: the JAX "
            "package's frozen operator would mix raw D and U with the "
            "scaled L")
    at_iteration = _load_scaler(load_steps, newton_iters, scale_inputs)

    def factored(mat, transpose=False):
        """(the factor of mat, or of its equilibrated copy, and the scale
        s, None without jacobi_scale)."""
        smat, s = mat.jacobi_scaled() if jacobi_scale else (mat, None)
        return (smat.factor_t() if transpose else smat.factor()), s

    def scaled(mat, fac, s):
        """The preconditioner solve M(b) = S F^{-1} S b (F^{-1} b unscaled)."""
        if s is None:
            return fac.solve
        return lambda b: mat.scale_vector(fac.solve(mat.scale_vector(b, s)),
                                          s)

    def step(u, Rc, mat, M):
        du = M(-Rc)
        if pcg_iters > 0:
            du = pcg_fixed(mat, None, -Rc, pcg_iters, x0=du, M=M)
        return apply_bc(u + du, free, bc_values)

    def forward(inputs, u0):
        u = apply_bc(u0, free, bc_values)
        carry = None  # (L, Sinv, C, s) or, frozen, (matrix, factor)
        for k in range(load_steps * newton_iters):
            p = at_iteration(inputs, k)
            Rc = constrain_residual(residual_fn(u, p), u, free, bc_values)
            refactor = k % refactor_every == 0
            if freeze_operator:
                if refactor:
                    mat = template.matrix(jac_blocks_fn(u, p))
                    carry = (mat, mat.factor())
                mat, fac = carry
                u = step(u, Rc, mat, fac.solve)
                continue
            mat = template.matrix(jac_blocks_fn(u, p))
            if refactor:
                fac, s = factored(mat)
                carry = (fac.mat.L, fac.Sinv, fac.C, s)
            L, Sinv, C, s = carry
            # the stale factor with the L it was computed from
            fac = BlockThomasFactor(mat._like(mat.D, L, mat.U), Sinv, C)
            u = step(u, Rc, mat, scaled(mat, fac, s))
        return u, None

    def backward(u, inputs, _, ubar):
        mat = template.matrix(jac_blocks_fn(u, inputs))
        M_t = scaled(mat, *factored(mat, transpose=True))
        psi = M_t(ubar)
        if pcg_iters > 0:
            psi = pcg_fixed(mat, None, ubar, pcg_iters, x0=psi,
                            transpose=True, M=M_t)
        psi = torch.where(free, psi, 0.0)
        return _vjp_inputs(residual_fn, u, inputs, psi)

    return _ift_solve(forward, backward)
