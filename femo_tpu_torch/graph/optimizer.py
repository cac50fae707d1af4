"""Optimizer drivers over a Simulator (port of femo_tpu/graph/
optimizer.py): OptimizationProblem, SLSQP, LBFGSB, ExternalDriver and the
SNOPT slot.

The optimizer runs on the host (scipy, or an external binding through
ExternalDriver's optimizer-neutral callbacks), as in the JAX package; the
objective and its IFT adjoint gradient come from the Simulator's
`objective_gradient` on the model's device.  Scaler semantics match CSDL:
the optimizer sees ``value * scaler``.  LBFGSB keeps no dense n x n work
array (SLSQP keeps ~10.5 n^2 values), so it is the driver for problems
with many design variables, such as W1's 135,200 controls at nel=260.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import config


def _host(t) -> np.ndarray:
    """A tensor (or array) as a host numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class OptimizationProblem:
    """Flattens the Simulator's design variables into scipy's x-vector."""

    def __init__(self, simulator, problem_name: str = "problem"):
        self.sim = simulator
        self.model = simulator.model
        self.problem_name = problem_name
        self.dv_names = list(self.model.design_variables.keys())
        self.dv_shapes = {
            n: tuple(self.sim.values[n].shape) for n in self.dv_names}
        self.dv_sizes = {
            n: int(np.prod(self.dv_shapes[n]) or 1) for n in self.dv_names}
        self.nx = sum(self.dv_sizes.values())
        self.history: list[dict] = []
        # called with the new history record after every objective
        # evaluation (dashboard hooks, recorders)
        self.callbacks: list = []

    # -- flatten/unflatten ---------------------------------------------------------
    # The optimizer sees x = value * dv_scaler (CSDL scaler semantics).
    def _dv_scaler(self, n):
        return self.model.design_variables[n].get("scaler", 1.0) or 1.0

    def pack(self, values: dict) -> np.ndarray:
        return np.concatenate(
            [_host(values[n]).reshape(-1) * self._dv_scaler(n)
             for n in self.dv_names])

    def unpack(self, x: np.ndarray) -> dict:
        out, i = {}, 0
        for n in self.dv_names:
            k = self.dv_sizes[n]
            out[n] = torch.as_tensor(
                x[i : i + k].reshape(self.dv_shapes[n]) / self._dv_scaler(n),
                dtype=config.dtype, device=self.model.device)
            i += k
        return out

    @property
    def x0(self) -> np.ndarray:
        return self.pack(self.sim.values)

    def bounds(self):
        lo, hi = [], []
        for n in self.dv_names:
            dv = self.model.design_variables[n]
            k = self.dv_sizes[n]
            s = self._dv_scaler(n)
            lo += [dv["lower"] * s if dv["lower"] is not None
                   else -np.inf] * k
            hi += [dv["upper"] * s if dv["upper"] is not None
                   else np.inf] * k
        return np.array(lo), np.array(hi)

    # -- objective/constraint callbacks ---------------------------------------------
    def _set_x(self, x):
        for n, v in self.unpack(x).items():
            self.sim.values[n] = v

    def objective_and_grad(self, x):
        self._set_x(x)
        of = self.model.objective["name"]
        sc = self.model.objective["scaler"]
        val, grads, out = self.sim.objective_gradient(of, self.dv_names)
        g = np.concatenate(
            [_host(grads[n]).reshape(-1) / self._dv_scaler(n)
             for n in self.dv_names])
        rec = {"iter": len(self.history), "obj": float(val),
               "time": time.time(),
               "dvs": {n: _host(self.sim.values[n]).copy()
                       for n in self.dv_names},
               "constraints": {c: _host(out[c]).astype(float)
                               for c in self.model.constraints if c in out}}
        self.history.append(rec)
        for cb in self.callbacks:
            cb(rec)
        return float(val) * sc, g * sc

    def constraint_and_jac(self, name):
        cinfo = self.model.constraints[name]
        sc = cinfo["scaler"]

        def cval(x):
            self._set_x(x)
            out = self.sim.run()
            v = np.atleast_1d(_host(out[name]).astype(float))
            if cinfo["equals"] is not None:
                return (v - cinfo["equals"]) * sc
            return v * sc

        def cjac(x):
            self._set_x(x)
            totals = self.sim.compute_totals(name, self.dv_names)
            row = np.concatenate(
                [_host(totals[(name, n)]).reshape(-1)
                 / self._dv_scaler(n) for n in self.dv_names])
            return row[None, :] * sc

        return cval, cjac

    def check_first_derivatives(self, x=None, step: float = 1e-6,
                                n_dirs: int = 3, seed: int = 0,
                                compact_print: bool = True):
        """FD-vs-adjoint check of the objective (and constraint) gradients
        in random directions at x (modOpt
        `optimizer.check_first_derivatives` parity, reference toggles at
        run_poisson_opt.py:231-233).  Returns {name: rel_error}."""
        x = self.x0 if x is None else np.asarray(x, float)
        rng = np.random.default_rng(seed)
        report = {}

        def check(val_fn, grad_at_x, name):
            errs = []
            base = val_fn(x)
            for _ in range(n_dirs):
                d = rng.standard_normal(self.nx)
                d /= np.linalg.norm(d)
                fd = (np.asarray(val_fn(x + step * d))
                      - np.asarray(base)) / step
                an = grad_at_x @ d
                denom = max(float(np.linalg.norm(np.atleast_1d(an))), 1e-30)
                errs.append(float(np.linalg.norm(
                    np.atleast_1d(an - fd))) / denom)
            rel = max(errs)
            report[name] = rel
            if compact_print:
                print(f"check_first_derivatives[{name}]: "
                      f"max rel FD error = {rel:.3e}")

        # FD probes evaluate the objective WITHOUT the adjoint gradient, and
        # without appending history records / firing dashboard callbacks
        # (probe points are not design iterations)
        of = self.model.objective["name"]
        of_sc = self.model.objective["scaler"]

        def obj_only(xv):
            self._set_x(xv)
            return float(self.sim.run()[of]) * of_sc

        saved_cbs, self.callbacks = self.callbacks, []
        n_hist = len(self.history)
        try:
            _, g0 = self.objective_and_grad(x)
            del self.history[n_hist:]
            check(obj_only, g0, "objective")
            for cname in self.model.constraints:
                cval, cjac = self.constraint_and_jac(cname)
                check(cval, cjac(x), cname)
        finally:
            self.callbacks = saved_cbs
            self._set_x(x)  # restore
        return report


class SLSQP:
    """scipy SLSQP driver (modOpt SLSQP parity, ftol/maxiter knobs)."""

    def __init__(self, prob: OptimizationProblem, ftol=1e-9, maxiter=100):
        self.prob = prob
        self.ftol = ftol
        self.maxiter = maxiter
        self.result = None

    def solve(self):
        from scipy.optimize import minimize

        prob = self.prob
        lo, hi = prob.bounds()
        bounds = None
        if np.isfinite(lo).any() or np.isfinite(hi).any():
            bounds = list(zip(lo, hi))
        cons = []
        for cname, cinfo in prob.model.constraints.items():
            cval, cjac = prob.constraint_and_jac(cname)
            if cinfo["equals"] is not None:
                cons.append({"type": "eq", "fun": cval, "jac": cjac})
            else:
                if cinfo["lower"] is not None:
                    lo_c = cinfo["lower"] * cinfo["scaler"]
                    cons.append({
                        "type": "ineq",
                        "fun": lambda x, f=cval, l=lo_c: f(x) - l,
                        "jac": cjac,
                    })
                if cinfo["upper"] is not None:
                    hi_c = cinfo["upper"] * cinfo["scaler"]
                    cons.append({
                        "type": "ineq",
                        "fun": lambda x, f=cval, h=hi_c: h - f(x),
                        "jac": lambda x, j=cjac: -j(x),
                    })
        self.result = minimize(
            prob.objective_and_grad, prob.x0, jac=True, method="SLSQP",
            bounds=bounds, constraints=cons,
            options={"ftol": self.ftol, "maxiter": self.maxiter},
        )
        prob._set_x(self.result.x)
        prob.sim.run()
        return self.result

    def print_results(self):
        r = self.result
        print(f"SLSQP: success={r.success} iters={r.nit} f={r.fun:.6e}")


class LBFGSB:
    """Bound-constrained quasi-Newton driver (scipy L-BFGS-B) for large
    unconstrained or bound-only problems."""

    def __init__(self, prob: OptimizationProblem, ftol=1e-12, gtol=1e-10,
                 maxiter=200):
        self.prob = prob
        self.ftol, self.gtol, self.maxiter = ftol, gtol, maxiter
        self.result = None

    def solve(self):
        from scipy.optimize import minimize

        prob = self.prob
        lo, hi = prob.bounds()
        bounds = list(zip(lo, hi))
        self.result = minimize(
            prob.objective_and_grad, prob.x0, jac=True, method="L-BFGS-B",
            bounds=bounds,
            options={"ftol": self.ftol, "gtol": self.gtol,
                     "maxiter": self.maxiter},
        )
        prob._set_x(self.result.x)
        prob.sim.run()
        return self.result


class ExternalDriver:
    """Binding hook for external optimizers (modOpt/SNOPT parity).

    `driver_factory(callbacks, **driver_opts) -> driver`, where
    `callbacks` is a plain dict exposing the problem in optimizer-neutral
    form::

        {
          "x0": ndarray, "lower": ndarray, "upper": ndarray,
          "objective": f(x) -> float,
          "objective_gradient": g(x) -> ndarray,
          "constraints": [
            {"name": str, "fun": c(x) -> ndarray, "jac": J(x) -> ndarray,
             "lower": float|None, "upper": float|None,
             "equals": float|None},
          ],
        }

    and `driver.solve() -> x_opt`.  The optimum is written back into the
    Simulator, which runs once more there.
    """

    def __init__(self, prob: OptimizationProblem, driver_factory=None,
                 **driver_opts):
        self.prob = prob
        self.driver_opts = driver_opts
        self.driver_factory = driver_factory
        self.result = None

    def callbacks(self) -> dict:
        prob = self.prob
        lo, hi = prob.bounds()

        def objective(x):
            return prob.objective_and_grad(np.asarray(x, float))[0]

        def gradient(x):
            return prob.objective_and_grad(np.asarray(x, float))[1]

        cons = []
        for cname, cinfo in prob.model.constraints.items():
            cval, cjac = prob.constraint_and_jac(cname)
            cons.append({
                "name": cname, "fun": cval, "jac": cjac,
                "lower": cinfo.get("lower"), "upper": cinfo.get("upper"),
                "equals": cinfo.get("equals"),
            })
        return {"x0": prob.x0, "lower": lo, "upper": hi,
                "objective": objective, "objective_gradient": gradient,
                "constraints": cons}

    def _finish(self, x_opt):
        """Write the optimum back into the Simulator and run it there."""
        self.prob._set_x(np.asarray(x_opt, float))
        self.prob.sim.run()

    def solve(self):
        if self.driver_factory is None:
            raise ValueError("no external driver_factory supplied")
        driver = self.driver_factory(self.callbacks(), **self.driver_opts)
        x_opt = np.asarray(driver.solve(), float)
        self._finish(x_opt)
        self.result = getattr(driver, "result", x_opt)
        return self.result


class SNOPT(ExternalDriver):
    """SNOPT driver slot (reference run_motor_opt.py:373-380).

    A `modopt` binding with SNOPT is driven through the ExternalDriver
    callbacks, the Major_* options passed through as given.  Without a
    binding, SNOPT warns and runs scipy SLSQP with the tolerances
    translated (Major_optimality -> ftol, Major_iterations -> maxiter), as
    the JAX class does, so run scripts that ask for SNOPT run everywhere.
    """

    def __init__(self, prob: OptimizationProblem,
                 Major_iterations: int = 100,
                 Major_optimality: float = 1e-8,
                 Major_feasibility: float = 1e-6,
                 append2file: bool = False, **kw):
        super().__init__(prob)
        self.opts = dict(Major_iterations=Major_iterations,
                         Major_optimality=Major_optimality,
                         Major_feasibility=Major_feasibility,
                         append2file=append2file, **kw)

    @staticmethod
    def _find_binding():
        try:
            from modopt import SNOPT as _S  # noqa: F401

            return "modopt"
        except Exception:
            pass
        try:
            import snopt  # noqa: F401

            return "snopt"
        except Exception:
            return None

    def solve(self):
        binding = self._find_binding()
        if binding is None:
            import warnings

            warnings.warn(
                "SNOPT binding not available; falling back to scipy SLSQP "
                "with translated tolerances")
            self.result = SLSQP(self.prob,
                                ftol=self.opts["Major_optimality"],
                                maxiter=self.opts["Major_iterations"]).solve()
            return self.result
        if binding == "modopt":
            from modopt import SNOPT as _SNOPT

            x_opt = np.asarray(_SNOPT(self.callbacks(), **self.opts).solve(),
                               float)
            self._finish(x_opt)
            self.result = x_opt
            return self.result
        # the JAX package has no driver for a bare `snopt` module either
        raise NotImplementedError(binding)

    def print_results(self):
        r = self.result
        if hasattr(r, "success"):
            print(f"SNOPT(fallback SLSQP): success={r.success} "
                  f"iters={r.nit} f={r.fun:.6e}")
        else:
            print(f"SNOPT: {r}")
