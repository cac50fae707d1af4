"""Implicit (IFT) solves (port of femo_tpu/graph/implicit.py).

Two entry points, each a `torch.autograd.Function` whose backward pass is
the implicit-function-theorem adjoint: one transpose solve at the
converged state plus a VJP of the residual with respect to the inputs.

* `ImplicitSolveOp` — the eager graph path's op (FEA states): a host
  Newton loop (`solvers/newton.py`) with any `LinearSolver` backend.  The
  forward pass keeps the last Newton factorization on the autograd
  context (the JAX package keeps it in `_fac_stash`), and the backward
  pass solves with its `solve_t`.  With the Krylov backends every matvec
  of both passes is the element SpMV kernel (K4 forward, K4T adjoint) on
  CUDA tensors.  Only mode="eager" is ported.

* `implicit_solve_bt(...)` — the motor step's configuration of
  `implicit_solve_bt_jit`, through the block-tridiagonal factorization:
  * forward: `load_steps x newton_iters` Newton iterations; each assembles
    the residual and the element Jacobian, fills the block-tridiagonal
    template, block-Thomas factors it and solves with the factor followed
    by `pcg_fixed` against the fresh operator.  The inputs are scaled per
    load step (`scale_inputs`).
  * backward (IFT): re-fill the operator at the converged u, factor its
    transpose, psi = M_t(ubar) polished by a transpose `pcg_fixed`, mask
    psi to the free dofs, and pbar = vjp(residual(u, .), inputs)(-psi) with
    the unscaled inputs; u0 gets a zero gradient.

  Only `refactor_every=1`, `factor_method="thomas"` and
  `adjoint="refactor"` are ported.  The JAX package's guard against
  `sweeps="pallas"` in f64 without a PCG polish (femo_tpu/graph/
  implicit.py:382-389, and femo_tpu/models/fsi.py:695-701) has no
  counterpart: it exists because Mosaic has no f64 and the Pallas sweeps
  ran in f32, whereas the port's CUDA sweeps run in the working dtype, so an
  f64 solve is f64 throughout.
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch
from torch.func import vjp

from ..config import config
from ..fea.assemble import CompiledForm, ElementMatrix
from ..fea.bc import apply_bc, constrain_residual
from ..ops.block_tridiag import pcg_fixed
from ..solvers.linear import LinearSolver
from ..solvers.newton import newton_solve


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
    mode : "eager" (the only mode ported)
    """

    def __init__(self, cform: CompiledForm, state_name: str,
                 arg_names: list[str], free, bc_values,
                 linear_solver: LinearSolver | None = None,
                 newton_opts: dict | None = None,
                 custom_solve: Callable | None = None,
                 mode: str = "eager"):
        if mode != "eager":
            raise NotImplementedError(
                f"ImplicitSolveOp mode={mode!r}: only 'eager' is ported")
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

    def __call__(self, inputs: dict, u0=None):
        if u0 is None:
            u0 = torch.zeros(self.n_dofs, dtype=config.dtype,
                             device=self.free.device)
        keys = tuple(inputs)
        return _ImplicitSolve.apply(self, keys, u0.detach(),
                                    *(inputs[k] for k in keys))


class _ImplicitSolve(torch.autograd.Function):
    """(op, keys, u0, *input tensors in the order of keys) -> u."""

    @staticmethod
    def forward(ctx, op, keys, u0, *vals):
        inputs = dict(zip(keys, vals))
        u, fac = op._forward(inputs, u0)
        ctx.op, ctx.keys, ctx.fac = op, keys, fac
        ctx.save_for_backward(u, *vals)
        return u

    @staticmethod
    def backward(ctx, ubar):
        u, *vals = ctx.saved_tensors
        op = ctx.op
        inputs = dict(zip(ctx.keys, vals))
        psi = ctx.fac.solve_t(ubar)
        ctx.fac = None  # one backward per forward
        psi = torch.where(op.free, psi, 0.0)
        # pbar = -psi^T dR/dp through a VJP of the residual
        _, vjp_p = vjp(lambda p: op.residual(u, p), inputs)
        (pbar,) = vjp_p(-psi)
        return (None, None, torch.zeros_like(u)) + tuple(
            pbar[k] for k in ctx.keys)


def implicit_solve_bt(residual_fn: Callable, jac_blocks_fn: Callable,
                      template, free, bc_values, newton_iters: int = 1,
                      load_steps: int = 1,
                      scale_inputs: Callable | None = None,
                      pcg_iters: int = 0,
                      factor_method: str = "thomas",
                      adjoint: str = "refactor",
                      refactor_every: int = 1):
    """Differentiable Newton solve of residual_fn(u, inputs) = 0 (strong BCs
    by row masking).  jac_blocks_fn(u, inputs) -> [(A_e, rows, cols), ...].
    Returns solve(inputs: dict of tensors, u0) -> u."""
    if factor_method != "thomas":
        raise ValueError(f"factor_method={factor_method!r}: only 'thomas' "
                         "is ported")
    if adjoint != "refactor":
        raise ValueError(f"adjoint={adjoint!r}: only 'refactor' is ported")
    if refactor_every != 1:
        raise ValueError(f"refactor_every={refactor_every}: only 1 is "
                         "ported")

    def scale(inputs, s):
        if scale_inputs is not None:
            return scale_inputs(inputs, s)
        return {k: v * s for k, v in inputs.items()}

    def newton_once(u, p):
        Rc = constrain_residual(residual_fn(u, p), u, free, bc_values)
        mat = template.matrix(jac_blocks_fn(u, p))
        M = mat.factor().solve
        du = M(-Rc)
        if pcg_iters > 0:
            du = pcg_fixed(mat, None, -Rc, pcg_iters, x0=du, M=M)
        return apply_bc(u + du, free, bc_values)

    def forward(inputs, u0):
        u = apply_bc(u0, free, bc_values)
        for k in range(load_steps * newton_iters):
            s = (k // newton_iters + 1) / load_steps
            p = inputs if load_steps == 1 else scale(inputs, s)
            u = newton_once(u, p)
        return u

    def backward(u, inputs, ubar):
        mat = template.matrix(jac_blocks_fn(u, inputs))
        M_t = mat.factor_t().solve
        psi = M_t(ubar)
        if pcg_iters > 0:
            psi = pcg_fixed(mat, None, ubar, pcg_iters, x0=psi,
                            transpose=True, M=M_t)
        psi = torch.where(free, psi, 0.0)
        _, vjp_p = vjp(lambda p: residual_fn(u, p), inputs)
        (pbar,) = vjp_p(-psi)
        return pbar

    class _Solve(torch.autograd.Function):
        """Positional form of the solve: (u0, *input tensors) -> u, the
        inputs in the order of `keys`."""

        @staticmethod
        def forward(ctx, keys, u0, *vals):
            inputs = dict(zip(keys, vals))
            u = forward(inputs, u0)
            ctx.keys = keys
            ctx.save_for_backward(u, *vals)
            return u

        @staticmethod
        def backward(ctx, ubar):
            u, *vals = ctx.saved_tensors
            inputs = dict(zip(ctx.keys, vals))
            pbar = backward(u, inputs, ubar)
            return (None, torch.zeros_like(u)) + tuple(
                pbar[k] for k in ctx.keys)

    def solve(inputs: dict, u0):
        keys = tuple(inputs)
        return _Solve.apply(keys, u0, *(inputs[k] for k in keys))

    return solve
