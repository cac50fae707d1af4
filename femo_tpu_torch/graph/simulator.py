"""Simulator: eager execution and total derivatives over a Model (port of
femo_tpu/graph/simulator.py).

`sim[name]` get/set, `run()`, `compute_totals()`, `objective_gradient()`,
`check_totals()`, the graph summary (`analytics=True`,
`visualize_implementation`) and `dump_gradient_fields`.  Total
derivatives are `torch.autograd` over the composed model; implicit solves
contribute their IFT backward passes.  Everything runs eagerly: the JAX
package's `jax.jit` cache and its trace fallback have no counterpart,
because nothing is traced, and `jit=True` is accepted and does nothing.

Side effects: `run()` persists each state's warm start (and writes
recorders); derivative evaluations run the model in pure mode, which
leaves them untouched, as in the JAX package.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..config import config
from .model import Model


class Simulator:
    """analytics=True prints the op graph's summary after every `run()`.
    jit is taken for the JAX package's signature: the port is eager, so
    it changes nothing."""

    def __init__(self, model: Model, analytics: bool = False,
                 jit: bool = False):
        self.model = model
        self.values: dict[str, torch.Tensor] = dict(model.defaults)
        self.outputs: dict[str, torch.Tensor] = {}
        self.analytics = analytics
        self.jit = jit

    # -- value access (sim['f'] parity) -----------------------------------------
    def __getitem__(self, name):
        v = self.outputs[name] if name in self.outputs else self.values[name]
        return v.detach().cpu().numpy()

    def __setitem__(self, name, val):
        self.values[name] = torch.as_tensor(
            np.asarray(val, np.float64), dtype=config.dtype,
            device=self.model.device)

    # -- execution -----------------------------------------------------------------
    def run(self):
        with torch.no_grad():
            self.outputs = self.model.evaluate(self.values)
        if self.analytics:
            print(self._graph_summary())
        return self.outputs

    # -- graph introspection ---------------------------------------------------
    def _graph_summary(self) -> str:
        m = self.model
        lines = [f"model graph: {len(m.operations)} operations, "
                 f"{len(m.design_variables)} design variable(s), "
                 f"{len(m.constraints)} constraint(s), "
                 f"objective={m.objective['name'] if m.objective else None}"]
        for op in m.operations:
            outs = []
            for o in op.outputs:
                v = self.outputs.get(o)
                shp = tuple(v.shape) if v is not None else "?"
                outs.append(f"{o}{shp}")
            lines.append(f"  {op.name}: ({', '.join(op.inputs)}) -> "
                         f"{', '.join(outs)}")
        return "\n".join(lines)

    def visualize_implementation(self, path: str | None = None) -> str:
        """Text rendering of the op graph (the reference's N2-diagram
        toggle): runs the model first if it has no outputs, prints the
        summary, writes it to `path` if given, and returns it."""
        if not self.outputs:
            self.run()
        s = self._graph_summary()
        if path:
            with open(path, "w") as f:
                f.write(s + "\n")
        print(s)
        return s

    @contextlib.contextmanager
    def _pure(self):
        prev = self.model.pure
        self.model.pure = True
        try:
            yield
        finally:
            self.model.pure = prev

    def _evaluate(self, wrt_vals: dict) -> dict:
        """The model at the current values with `wrt_vals` replacing some,
        in pure mode."""
        vals = dict(self.values)
        vals.update(wrt_vals)
        with self._pure():
            return self.model.evaluate(vals)

    def _leaves(self, wrt_list):
        return {w: self.values[w].detach().clone().requires_grad_(True)
                for w in wrt_list}

    def compute_totals(self, of, wrt):
        """d(of)/d(wrt) of scalar outputs by reverse mode.
        Returns {(of, wrt): tensor}."""
        of_list = [of] if isinstance(of, str) else list(of)
        wrt_list = [wrt] if isinstance(wrt, str) else list(wrt)
        totals = {}
        for o in of_list:
            leaves = self._leaves(wrt_list)
            with torch.enable_grad():
                val = torch.sum(self._evaluate(leaves)[o])
                grads = torch.autograd.grad(
                    val, [leaves[w] for w in wrt_list], allow_unused=True)
            for w, g in zip(wrt_list, grads):
                totals[(o, w)] = (torch.zeros_like(leaves[w]) if g is None
                                  else g)
        return totals

    def objective_gradient(self, of, wrt_list):
        """(value, grad dict, all model outputs) in one reverse pass."""
        leaves = self._leaves(wrt_list)
        with torch.enable_grad():
            out = self._evaluate(leaves)
            val = torch.sum(out[of])
            grads = torch.autograd.grad(
                val, [leaves[w] for w in wrt_list], allow_unused=True)
        grads = {w: (torch.zeros_like(leaves[w]) if g is None else g)
                 for w, g in zip(wrt_list, grads)}
        return (val.detach(), grads,
                {k: v.detach() for k, v in out.items()})

    def check_totals(self, of=None, wrt=None, step=1e-6, compact_print=True):
        """FD-vs-adjoint verification: forward differences of every
        component against the reverse-mode totals."""
        of = of or self.model.objective["name"]
        wrt_list = ([wrt] if isinstance(wrt, str) else
                    wrt or list(self.model.design_variables.keys()))
        totals = self.compute_totals(of, wrt_list)
        report = {}
        base_vals = {w: self.values[w] for w in wrt_list}

        def f(vals):
            with torch.no_grad():
                return float(torch.sum(self._evaluate(vals)[of]))

        base = f(base_vals)
        for w in wrt_list:
            an = totals[(of, w)].detach().cpu().numpy()
            fd = np.zeros_like(an)
            x0 = base_vals[w].detach().cpu().numpy()
            for i in range(x0.size):
                xp = x0.copy()
                xp.flat[i] += step
                vals = dict(base_vals)
                vals[w] = torch.as_tensor(xp, dtype=config.dtype,
                                          device=self.model.device)
                fd.flat[i] = (f(vals) - base) / step
            denom = max(np.linalg.norm(an), 1e-300)
            rel = np.linalg.norm(an - fd) / denom
            report[(of, w)] = dict(analytic=an, fd=fd, rel_error=rel)
            if compact_print:
                print(f"check_totals d({of})/d({w}): rel FD error = {rel:.3e}")
        return report

    def dump_gradient_fields(self, of, wrt, space, path, step=1e-6):
        """Write the analytic, finite-difference and error gradient FIELDS
        d(of)/d(wrt) to XDMF (three Functions on `space`) for visual
        checks.  `wrt` must be a dof-vector design variable on `space`
        (one FD evaluation per dof, as check_totals); raises ValueError
        when the gradient's size is not the space's dof count.  Returns
        the check_totals report entry for (of, wrt)."""
        from ..fea.space import Function
        from ..io.xdmf import XDMFWriter

        rep = self.check_totals(of, [wrt], step=step,
                                compact_print=False)[(of, wrt)]
        an, fd = rep["analytic"].ravel(), rep["fd"].ravel()
        if an.size != space.n_dofs:
            raise ValueError(
                f"gradient d({of})/d({wrt}) has {an.size} entries, but "
                f"space has {space.n_dofs} dofs — pass the design "
                f"variable's own FunctionSpace")
        with XDMFWriter(path, space.mesh) as w:
            for name, arr in ((f"d{of}_d{wrt}_analytic", an),
                              (f"d{of}_d{wrt}_fd", fd),
                              (f"d{of}_d{wrt}_error", an - fd)):
                w.write_function(Function(space, name, arr))
        return rep
