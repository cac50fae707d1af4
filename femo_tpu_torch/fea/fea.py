"""FEA problem registry: named inputs, states, outputs, BCs, solve dispatch
(port of femo_tpu/fea/fea.py).

The same registry dicts (inputs_dict / states_dict / outputs_dict /
outputs_field_dict), reference flags (PDE_SOLVER, REPORT, record,
initialize, linear_problem, custom_solve, opt_iter, initial_solve) and
method names as the JAX package.  Each state becomes an ImplicitSolveOp
(graph/implicit.py), built at its first solve, in `solve_mode` "eager"
(host Newton with the LinearSolver) or "jit_dense" (fixed-count dense-LU
Newton).  Field outputs are projected to CG1 (fea/project.py) by the
FEAModel.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from .assemble import compile_form
from .bc import DirichletBC, bc_arrays
from .forms import FormDef, GlobalCoefficient
from .space import Function, FunctionSpace


class FEA:
    """A PDE problem: inputs -> implicit states -> output functionals."""

    def __init__(self, mesh):
        self.mesh = mesh

        self.inputs_dict: dict[str, dict] = {}
        self.states_dict: dict[str, dict] = {}
        self.outputs_dict: dict[str, dict] = {}
        self.outputs_field_dict: dict[str, dict] = {}
        self.bc: list[DirichletBC] = []

        # reference flags
        self.PDE_SOLVER = "Newton"  # "Newton" | "SNES" (SNES => backtracking)
        self.REPORT = False
        self.custom_solve: Callable | None = None
        self.opt_iter = 0
        self.initial_solve = True
        self.initialize = False
        self.record = False
        self.recorder_path = "records"
        self.linear_problem = False
        self.solve_mode = "eager"  # "eager" | "jit_dense"

        # solver knobs beyond the reference
        # imported here: solvers/ and graph/ import fea/, whose package
        # imports this module
        from ..solvers.linear import LinearSolver

        self.linear_solver = LinearSolver()
        self.newton_opts: dict = {}

    # -- registration -----------------------------------------------------------
    def add_input(self, name: str, function, init_val=None,
                  record: bool = False):
        """function: a Function or GlobalCoefficient.  init_val: optional
        scalar fill value; None leaves the array untouched."""
        if name in self.inputs_dict:
            raise ValueError(f"input '{name}' already registered")
        function.rename(name)
        if isinstance(function, GlobalCoefficient):
            self.inputs_dict[name] = dict(
                function=function, function_space=None,
                shape=int(function.array.numel()), record=False)
            return
        if init_val is not None and np.isscalar(init_val):
            function.set(init_val)
        self.inputs_dict[name] = dict(
            function=function,
            function_space=function.space,
            shape=function.space.n_dofs,
            record=record or self.record,
        )

    def add_state(self, name: str, function: Function,
                  residual_form: FormDef, arguments: Sequence[str],
                  record: bool = False, newton_opts: dict | None = None,
                  linear_solver: LinearSolver | None = None):
        function.rename(name)
        if residual_form.test is None:
            residual_form.test = function.space
        self.states_dict[name] = dict(
            function=function,
            residual_form=residual_form,
            function_space=function.space,
            shape=function.space.n_dofs,
            arguments=list(arguments),
            record=record or self.record,
            newton_opts=newton_opts,
            linear_solver=linear_solver,
            op=None,  # built lazily (BCs may be added after)
        )

    def add_output(self, name: str, type: str = "scalar",
                   form: FormDef | None = None,
                   arguments: Sequence[str] = ()):
        self.outputs_dict[name] = dict(
            form=form,
            shape=1,
            arguments=list(arguments),
        )

    def add_field_output(self, name: str, form: FormDef,
                         arguments: Sequence[str], record: bool = False):
        """Project a form's integrand to CG1: `form` is a 1-form against a
        CG1 test space, on whose device the output lives."""
        if form.test is None:
            raise ValueError("a field output's form needs its CG1 test "
                             "space")
        V = FunctionSpace(self.mesh, ("CG", 1), device=form.test.device)
        self.outputs_field_dict[name] = dict(
            form=form,
            func=Function(V, name),
            shape=V.n_dofs,
            arguments=list(arguments),
            record=record or self.record,
        )

    def add_strong_bc(self, value, locate_BC_list=None, function_space=None,
                      bc: DirichletBC | None = None, component=None):
        """Register strong Dirichlet BCs.  value: scalar, array or
        Function; locate_BC_list: dof-index arrays or geometric
        predicates."""
        if bc is not None:
            self.bc.append(bc)
            return
        V = function_space
        if V is None:
            raise ValueError("function_space required")
        if isinstance(value, Function):
            varr = value.array.detach().cpu().numpy()
        else:
            varr = value
        for loc in locate_BC_list:
            if callable(loc):
                dofs = V.locate_dofs_geometrical(loc, component=component)
            else:
                dofs = np.asarray(loc, np.int32)
            vals = varr[dofs] if isinstance(varr, np.ndarray) and \
                varr.ndim == 1 and len(varr) == V.n_dofs else varr
            self.bc.append(DirichletBC(V, vals, dofs=dofs))

    # -- solve dispatch -----------------------------------------------------------
    @staticmethod
    def _space_equiv(a, b) -> bool:
        """Functional equivalence of two FunctionSpaces: same mesh object,
        same element family/degree/ncomp.  BCs registered on an
        equal-but-distinct space instance must still apply."""
        return a is b or (
            a.mesh is b.mesh
            and a.element.family == b.element.family
            and a.element.degree == b.element.degree
            and a.element.ncomp == b.element.ncomp)

    def _check_bcs_match_states(self):
        """Raise if any registered BC matches no state's function space."""
        spaces = [s["function_space"] for s in self.states_dict.values()]
        for b in self.bc:
            if not any(self._space_equiv(b.space, V) for V in spaces):
                raise ValueError(
                    "a strong BC was registered on a function space "
                    f"({b.space.element.family}{b.space.element.degree}, "
                    f"ncomp={b.space.element.ncomp}) that matches no "
                    "state's space — it would be silently dropped")

    def _state_op(self, name: str) -> ImplicitSolveOp:
        from ..graph.implicit import ImplicitSolveOp

        s = self.states_dict[name]
        if s["op"] is None:
            self._check_bcs_match_states()
            V = s["function_space"]
            bcs = [b for b in self.bc if self._space_equiv(b.space, V)]
            free, bvals = bc_arrays(bcs, V.n_dofs, V.device)
            nopts = dict(self.newton_opts)
            if self.PDE_SOLVER == "SNES":
                nopts.setdefault("line_search", "bt")
            nopts.setdefault("report", self.REPORT)
            if s["newton_opts"]:
                nopts.update(s["newton_opts"])
            if self.linear_problem:
                nopts.setdefault("maxiter", 2)
                nopts.setdefault("jit_newton_iters", 1)
            s["op"] = ImplicitSolveOp(
                compile_form(s["residual_form"]), name, s["arguments"],
                free, bvals,
                linear_solver=s["linear_solver"] or self.linear_solver,
                newton_opts=nopts,
                custom_solve=self.custom_solve,
                mode=self.solve_mode,
            )
        return s["op"]

    def solve(self, state_name: str, inputs: dict | None = None):
        """Solve one state in place (forward only)."""
        s = self.states_dict[state_name]
        op = self._state_op(state_name)
        inputs = inputs or {}
        vals = {}
        for a in s["arguments"]:
            if a in inputs:
                vals[a] = inputs[a]
            elif a in self.inputs_dict:
                vals[a] = self.inputs_dict[a]["function"].array
            elif a in self.states_dict:
                vals[a] = self.states_dict[a]["function"].array
        u0 = (s["function"].space.new_array(0.1) if self.initialize
              else s["function"].array)
        u = op(vals, u0).detach()
        s["function"].array = u
        return u

    def evaluate_output(self, name: str, values: dict | None = None):
        o = self.outputs_dict[name]
        v = o["form"].values()
        if values:
            v.update({k: values[k] for k in v if k in values})
        return compile_form(o["form"]).scalar(v)
