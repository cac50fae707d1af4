"""Model composition: chained operations, FEA solves, output functionals
(port of femo_tpu/graph/model.py).

A Model is an ordered list of named operations executed eagerly on
tensors, wired by name; the whole composite is differentiable by
`torch.autograd` because implicit solves are `torch.autograd.Function`s
with IFT backward passes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from ..config import config, get_device
from ..fea.assemble import compile_form
from ..fea.fea import FEA
from ..fea.project import project_form


@dataclass
class Operation:
    """A named op: fn(*input arrays) -> output array or tuple."""

    name: str
    fn: Callable
    inputs: list[str]
    outputs: list[str]


class Model:
    """Ordered eager computation over a dict of named tensors on one
    device (default `config.device`, the card).

    `pure` is set by the Simulator while it evaluates derivatives: state
    operations then leave their Functions' warm starts untouched, as the
    JAX package's pure mode does."""

    def __init__(self, device=None):
        self.device = get_device(device)
        self.operations: list[Operation] = []
        self.design_variables: dict[str, dict] = {}
        self.objective: dict | None = None
        self.constraints: dict[str, dict] = {}
        self.defaults: dict[str, torch.Tensor] = {}
        self.pure = False

    # -- construction -----------------------------------------------------------
    def add_op(self, name: str, fn: Callable, inputs: Sequence[str],
               outputs: Sequence[str]):
        """fn takes positional arrays in `inputs` order, returns array or
        tuple matching `outputs`."""
        self.operations.append(
            Operation(name, fn, list(inputs), list(outputs)))
        return self

    def create_input(self, name: str, shape=None, val=0.0):
        """CSDL create_input parity: declares a default value."""
        if np.isscalar(val):
            if shape is None:
                raise ValueError("need shape for scalar default")
            val = np.full(shape, val)
        self.defaults[name] = torch.as_tensor(
            np.asarray(val, np.float64), dtype=config.dtype,
            device=self.device)
        return self

    def add_design_variable(self, name: str, lower=None, upper=None,
                            scaler=1.0, shape=None, val=None):
        if val is not None:
            self.create_input(name, shape, val)
        self.design_variables[name] = dict(
            lower=lower, upper=upper, scaler=scaler)

    def add_objective(self, name: str, scaler=1.0):
        self.objective = dict(name=name, scaler=scaler)

    def add_constraint(self, name: str, lower=None, upper=None, equals=None,
                       scaler=1.0):
        self.constraints[name] = dict(
            lower=lower, upper=upper, equals=equals, scaler=scaler)

    # -- execution ----------------------------------------------------------------
    def evaluate(self, values: dict | None = None) -> dict:
        """Run all operations; returns the full variable dict."""
        vals = dict(self.defaults)
        if values:
            vals.update(values)
        for op in self.operations:
            out = op.fn(*[vals[k] for k in op.inputs])
            if len(op.outputs) == 1:
                out = (out,)
            for k, v in zip(op.outputs, out):
                vals[k] = v
        return vals

    def __call__(self, values: dict | None = None) -> dict:
        return self.evaluate(values)


class FEAModel(Model):
    """Model auto-populated from a list of FEA problems: one operation per
    state, per scalar output and per field output (projected to CG1),
    wired by argument names.  Its device is that of the first problem's
    first state space unless given."""

    def __init__(self, fea: list[FEA] | FEA, recorder=None, device=None):
        fea_list = [fea] if isinstance(fea, FEA) else list(fea)
        if device is None:
            spaces = [s["function_space"] for f in fea_list
                      for s in f.states_dict.values()]
            device = spaces[0].device if spaces else None
        super().__init__(device)
        self.fea_list = fea_list
        self.recorder = recorder
        for f in self.fea_list:
            self._add_fea(f)

    def _add_fea(self, fea: FEA):
        for iname, i in fea.inputs_dict.items():
            if iname not in self.defaults:
                self.defaults[iname] = i["function"].array

        for sname, s in fea.states_dict.items():
            def make_state_fn(fea=fea, sname=sname, s=s):
                def state_fn(*args):
                    op = fea._state_op(sname)
                    inputs = dict(zip(s["arguments"], args))
                    u0 = (s["function"].space.new_array(0.1)
                          if fea.initialize else s["function"].array)
                    u = op(inputs, u0)
                    # persist the warm start and write the recorder,
                    # except while derivatives are evaluated
                    if not self.pure:
                        s["function"].array = u.detach()
                        if self.recorder is not None and s["record"]:
                            self.recorder.write(
                                sname, s["function"], fea.opt_iter)
                    return u

                return state_fn

            self.add_op(f"{sname}_state_model", make_state_fn(),
                        s["arguments"], [sname])

        for oname, o in fea.outputs_dict.items():
            def make_out_fn(o=o):
                cf = compile_form(o["form"])

                def out_fn(*args):
                    named = dict(zip(o["arguments"], args))
                    vals = o["form"].values()
                    vals.update(
                        {k: v for k, v in named.items() if k in vals})
                    return cf.scalar(vals)

                return out_fn

            self.add_op(f"{oname}_output_model", make_out_fn(),
                        o["arguments"], [oname])

        for oname, o in fea.outputs_field_dict.items():
            def make_field_fn(fea=fea, oname=oname, o=o):
                def field_fn(*args):
                    named = dict(zip(o["arguments"], args))
                    vals = o["form"].values()
                    vals.update(
                        {k: v for k, v in named.items() if k in vals})
                    arr = project_form(o["form"], o["func"].space, vals)
                    if not self.pure:
                        o["func"].array = arr.detach()
                        if self.recorder is not None and o["record"]:
                            self.recorder.write(oname, o["func"],
                                                fea.opt_iter)
                    return arr

                return field_fn

            self.add_op(f"{oname}_field_output_model", make_field_fn(),
                        o["arguments"], [oname])
