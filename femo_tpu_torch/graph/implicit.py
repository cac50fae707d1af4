"""Implicit (IFT) solve through the block-tridiagonal factorization (port
of femo_tpu/graph/implicit.py::implicit_solve_bt_jit, the motor step's
configuration).

`implicit_solve_bt(...)` returns `solve(inputs, u0) -> u`, a
`torch.autograd.Function` application:

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

from typing import Callable

import torch
from torch.func import vjp

from ..fea.bc import apply_bc, constrain_residual
from ..ops.block_tridiag import pcg_fixed


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
