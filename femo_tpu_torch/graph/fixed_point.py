"""Differentiable fixed-point (Gauss-Seidel) coupling operator (port of
femo_tpu/graph/fixed_point.py).

The counterpart of the reference's coupled-FSI implicit operation
(`create_implicit_operation` + `csdl.NonlinearBlockGS(maxiter=100)`,
run_aeroelasticity_static_w_feedback.py:346-355).

Forward: damped Picard iteration x <- (1-w) x + w G(x, p) until the step
is small.  Backward (a `torch.autograd.Function`): the IFT adjoint of
x* = G(x*, p) is psi = ubar + (dG/dx)^T psi, solved by the same
fixed-point iteration with vector-Jacobian products (a Neumann series:
it converges whenever the forward iteration contracts); then
pbar = (dG/dp)^T psi.

Both solvers loop on the host and read the step norm there once per
iteration.  `fixed_point_solve_jit` keeps the JAX package's name for its
`lax.while_loop` version: the same arithmetic and stopping rule
(`||x - x_prev|| > tol * max(1, ||x||)`, at most `maxiter`), with a
relaxed adjoint; `fixed_point_solve` is the eager one, with its own rule
and an unrelaxed adjoint, as in the JAX package.

params is a dict of tensors; x a flat tensor (stack coupled fields into
one vector, as models/fsi.py does with the lattice displacement).
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch

from .implicit import repeated_backward


def _eager_forward(step_fn, x0, params, tol, maxiter, relax, report):
    x = x0
    err = float("inf")
    for it in range(maxiter):
        x_new = step_fn(x, params)
        err = float(torch.linalg.norm(x_new - x))
        x = (1 - relax) * x + relax * x_new
        scale = float(torch.linalg.norm(x)) + 1e-30
        if report:
            print(f"  fixed-point {it}: ||dx|| = {err:.3e}")
        if err <= tol * max(1.0, scale):
            break
    else:
        warnings.warn(f"fixed point did not converge: ||dx||={err:.3e} "
                      f"after {maxiter} iterations")
    return x


def _eager_adjoint(vjp_x, ubar, tol, maxiter, relax):
    psi = ubar
    for _ in range(maxiter):
        psi_new = ubar + vjp_x(psi)
        dn = float(torch.linalg.norm(psi_new - psi))
        psi = psi_new
        if dn <= tol * (float(torch.linalg.norm(psi)) + 1e-30):
            break
    return psi


def _jit_forward(step_fn, x0, params, tol, maxiter, relax, report):
    x, xp, it = x0, x0 + 1.0, 0
    while it < maxiter and float(torch.linalg.norm(x - xp)) > tol * max(
            1.0, float(torch.linalg.norm(x))):
        xn = step_fn(x, params)
        x, xp, it = (1.0 - relax) * x + relax * xn, x, it + 1
    return x


def _jit_adjoint(vjp_x, ubar, tol, maxiter, relax):
    psi, pp, it = ubar, ubar + 1.0, 0
    while it < maxiter and float(torch.linalg.norm(psi - pp)) > tol * max(
            1.0, float(torch.linalg.norm(psi))):
        psi, pp, it = ((1.0 - relax) * psi + relax * (ubar + vjp_x(psi)),
                       psi, it + 1)
    return psi


class _FixedPoint(torch.autograd.Function):
    """(opts, x0, *param values) -> x*, with the IFT adjoint as backward."""

    @staticmethod
    def forward(ctx, opts, x0, *pvals):
        step_fn, keys, forward, _, tol, maxiter, relax, report = opts
        params = dict(zip(keys, pvals))
        with torch.no_grad():
            x = forward(step_fn, x0, params, tol, maxiter, relax, report)
        ctx.opts = opts
        ctx.save_for_backward(x, *pvals)
        return x

    @staticmethod
    def backward(ctx, ubar):
        step_fn, keys, _, adjoint, tol, maxiter, relax, _ = ctx.opts
        x, *pvals = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            pp = [p.detach().requires_grad_(p.is_floating_point())
                  for p in pvals]
            with repeated_backward():  # vjp_x runs backward per iteration
                y = step_fn(xx, dict(zip(keys, pp)))

            def vjp_x(psi):
                (g,) = torch.autograd.grad(y, xx, psi, retain_graph=True,
                                           allow_unused=True)
                return torch.zeros_like(psi) if g is None else g

            psi = adjoint(vjp_x, ubar, tol, maxiter, relax)
            need = [p for p, n in zip(pp, ctx.needs_input_grad[2:]) if n]
            grads = iter(torch.autograd.grad(y, need, psi, allow_unused=True)
                         if need else ())
        pbar = [next(grads) if n else None for n in ctx.needs_input_grad[2:]]
        return (None, None, *pbar)


def _solve(step_fn, x0, params, tol, maxiter, relax, report, forward,
           adjoint):
    keys = list(params)
    opts = (step_fn, keys, forward, adjoint, tol, maxiter, relax, report)
    return _FixedPoint.apply(opts, x0.detach(), *[params[k] for k in keys])


def fixed_point_solve(step_fn: Callable, x0, params: dict,
                      tol: float = 1e-10, maxiter: int = 100,
                      relax: float = 1.0, report: bool = False):
    """Solve x = step_fn(x, params) with a differentiable fixed point.

    step_fn may contain implicit solves with their own adjoints (each
    Gauss-Seidel pass re-runs the inner solvers, like the reference's
    NonlinearBlockGS over VLM + shell).  Stops when ||G(x) - x|| <=
    tol * max(1, ||x||); warns after `maxiter` passes without.  The
    adjoint iteration is unrelaxed and stops when its increment is below
    tol * ||psi||."""
    return _solve(step_fn, x0, params, tol, maxiter, relax, report,
                  _eager_forward, _eager_adjoint)


def fixed_point_solve_jit(step_fn: Callable, x0, params: dict,
                          tol: float = 1e-10, maxiter: int = 100,
                          relax: float = 1.0):
    """The JAX package's device-loop fixed point, as host loops: damped
    Picard forward, relaxed Neumann-series IFT adjoint, each stopping when
    the norm of its last (damped) increment is <= tol * max(1, norm) or
    after `maxiter` passes.  Each pass reads one norm on the host."""
    return _solve(step_fn, x0, params, tol, maxiter, relax, False,
                  _jit_forward, _jit_adjoint)
