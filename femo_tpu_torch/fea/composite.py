"""Composite (multi-field) implicit states: block residuals and Jacobians
(port of femo_tpu/fea/composite.py).

A CompositeState concatenates independent fields (each with its own
FunctionSpace) into one state vector.  Each field's residual is an
ordinary 1-form against that field's test space; the block Jacobian is an
ElementMatrix whose row and column indices carry the field offsets, so
the dense, Krylov and block-tridiagonal machinery applies unchanged.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import config
from .assemble import CompiledForm, ElementMatrix, MatBlock, compile_form
from .bc import DirichletBC
from .forms import FormDef
from .space import Function


class CompositeState:
    """Fields stacked into one monolithic state vector.

    Parameters
    ----------
    fields : list of Function, the sub-states in stacking order (all on
        one device)
    residuals : dict field_name -> FormDef (1-form against that field's
        space); each form may reference every field plus extra inputs.
    bcs : list of DirichletBC on any field's space.
    """

    def __init__(self, fields: Sequence[Function],
                 residuals: dict[str, FormDef],
                 bcs: Sequence[DirichletBC] = ()):
        self.fields = list(fields)
        self.names = [f.name for f in fields]
        self.device = self.fields[0].space.device
        self.offsets: dict[str, int] = {}
        off = 0
        for f in fields:
            self.offsets[f.name] = off
            off += f.space.n_dofs
        self.n_dofs = off
        self.residual_forms = {k: residuals[k] for k in self.names}
        self.cforms: dict[str, CompiledForm] = {
            k: compile_form(v) for k, v in self.residual_forms.items()}

        free = np.ones(self.n_dofs, bool)
        vals = np.zeros(self.n_dofs)
        for bc in bcs:
            for f in self.fields:
                if bc.space is f.space:
                    o = self.offsets[f.name]
                    free[o + bc.dofs] = False
                    vals[o + bc.dofs] = bc.values
        self.free = torch.as_tensor(free, device=self.device)
        self.bc_values = torch.as_tensor(vals, dtype=config.dtype,
                                         device=self.device)
        # the Jacobian's (row field, column field, term) layout: offset
        # rows/cols and K4's plan per term, made once; and the owner
        # tables of `diagonal` / `to_dense`, shared by every Jacobian
        self._layout = None
        self._matrix_cache: dict = {}

    # -- split/concat -------------------------------------------------------------
    def split(self, x) -> dict[str, torch.Tensor]:
        return {f.name: x[self.offsets[f.name]:
                          self.offsets[f.name] + f.space.n_dofs]
                for f in self.fields}

    def concat(self, parts: dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([parts[f.name] for f in self.fields])

    def current(self) -> torch.Tensor:
        return self.concat({f.name: f.array for f in self.fields})

    def push(self, x):
        """Write a solution back into the field Functions."""
        for name, part in self.split(x).items():
            self.fields[self.names.index(name)].array = part

    # -- assembly ------------------------------------------------------------------
    def _values(self, x, inputs: dict):
        vals = {}
        for cf in self.cforms.values():
            form = cf.form
            for name, fobj in {**form.coeffs, **form.globals}.items():
                vals.setdefault(name, fobj.array)
        vals.update(inputs or {})
        vals.update(self.split(x))  # state fields always win
        return vals

    def residual(self, x, inputs: dict | None = None,
                 chunk: int | None = None):
        """The stacked residual; `chunk` entities at a time when it is set
        (CompiledForm.vector)."""
        vals = self._values(x, inputs or {})
        return torch.cat([
            self.cforms[name].vector(
                {k: vals[k] for k in self.cforms[name].all_names}, chunk)
            for name in self.names])

    def _pairs(self):
        """(row field, column field) of each Jacobian block, in the JAX
        package's order: rows outer, columns inner, columns that the row
        form does not read skipped."""
        return [(r, c) for r in self.names for c in self.names
                if c in self.cforms[r].form.coeffs]

    def layout(self):
        """[(row field, column field, term, rows, cols, plan), ...]: the
        offset index tensors of every term of every block."""
        if self._layout is None:
            from ..ops.spmv import ElementSpMVPlan

            lay = []
            for r, c in self._pairs():
                cf = self.cforms[r]
                for t in cf.terms:
                    rows = t._rows("__test__") + self.offsets[r]
                    cols = t._rows(c) + self.offsets[c]
                    lay.append((r, c, t, rows, cols, ElementSpMVPlan(
                        rows, cols, self.n_dofs, self.n_dofs)))
            self._layout = lay
        return self._layout

    def jacobian_blocks(self, x, inputs: dict | None = None,
                        chunk: int | None = None):
        """[(A_e, rows, cols), ...] of the composite Jacobian; `chunk`
        entities at a time when it is set."""
        vals = self._values(x, inputs or {})
        out = []
        for r, c, t, rows, cols, _ in self.layout():
            cf = self.cforms[r]
            A, _, _ = t.matrix_blocks({k: vals[k] for k in cf.all_names},
                                      "__test__", c, chunk)
            out.append((A, rows, cols))
        return out

    def jacobian(self, x, inputs: dict | None = None) -> ElementMatrix:
        blocks = [MatBlock(A, rows, cols, plan=lay[5])
                  for (A, rows, cols), lay in zip(
                      self.jacobian_blocks(x, inputs), self.layout())]
        return ElementMatrix(blocks, self.n_dofs, self.n_dofs,
                             cache=self._matrix_cache)

    def jacobian_pattern(self) -> ElementMatrix:
        """Pattern-only composite Jacobian (host dofmaps, broadcast-zero
        values, offsets applied): BlockTridiagTemplate prototypes without
        any device assembly."""
        blocks = []
        for r, c in self._pairs():
            roff, coff = self.offsets[r], self.offsets[c]
            for b in self.cforms[r].matrix_pattern(c).blocks:
                blocks.append(MatBlock(b.A, np.asarray(b.rows) + roff,
                                       np.asarray(b.cols) + coff))
        return ElementMatrix(blocks, self.n_dofs, self.n_dofs)


def composite_implicit_op(state: CompositeState, arg_names: Sequence[str],
                          linear_solver=None, newton_opts=None,
                          custom_solve=None, mode: str = "eager"):
    """An ImplicitSolveOp over a CompositeState, with the same IFT
    adjoint.  mode: "eager" (host Newton with `linear_solver`),
    "jit_dense" (dense LU, `newton_opts["jit_newton_iters"]` Newton
    iterations) or "jit_bt" (the block-tridiagonal template and
    block-Thomas factor, `newton_opts["pcg_iters"]` PCG polish steps;
    its solves are the sweeps K1/K2 on CUDA tensors)."""
    from ..graph.implicit import (ImplicitSolveOp, _ift_solve,
                                  implicit_solve_bt, implicit_solve_dense)
    from ..ops.block_tridiag import BlockTridiagTemplate
    from ..solvers.linear import LinearSolver

    if mode not in ("eager", "jit_dense", "jit_bt"):
        raise ValueError(f"composite_implicit_op mode={mode!r}: 'eager', "
                         "'jit_dense' or 'jit_bt'")
    op = ImplicitSolveOp.__new__(ImplicitSolveOp)
    op.cform = None
    op.state_name = "+".join(state.names)
    op.arg_names = list(arg_names)
    op.free = state.free
    op.bc_values = state.bc_values
    op.linear_solver = linear_solver or LinearSolver()
    op.newton_opts = dict(newton_opts or {})
    op.custom_solve = custom_solve
    op.n_dofs = state.n_dofs
    op.mode = mode
    # the composite residual and Jacobian replace the single-form ones
    op.residual = state.residual
    op.jacobian = state.jacobian

    iters = op.newton_opts.get("jit_newton_iters", 1)
    if mode == "jit_dense":
        op._solve = implicit_solve_dense(
            op.residual, lambda u, p: op.jacobian(u, p).to_dense(),
            op.free, op.bc_values, newton_iters=iters)
    elif mode == "jit_bt":
        tpl = BlockTridiagTemplate(state.jacobian_pattern(),
                                   free=state.free, device=state.device)
        op._solve = implicit_solve_bt(
            op.residual, state.jacobian_blocks, tpl, op.free,
            op.bc_values, newton_iters=iters,
            pcg_iters=op.newton_opts.get("pcg_iters", 0))
    else:
        op._solve = _ift_solve(op._forward, op._adjoint)
    return op
