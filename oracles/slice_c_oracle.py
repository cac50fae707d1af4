"""The JAX package's f64 reference values for the small workloads (W1
with weak BCs, the jitted Poisson step, W2, W10 shape gradients, W4 SIMP
topology) at the sizes chip_smoke.py drives the PyTorch/CUDA port at.

    JAX_PLATFORMS=cpu PYTHONPATH=. python oracles/slice_c_oracle.py

Runs femo_tpu on the CPU in f64 and writes oracles/slice_c_oracle.npz.
Each entry is stored beside the configuration it was computed for
(`<key>_config`, a JSON string), which chip_smoke.py checks before it
gates on the values:

* w1_weak: `build_fea(nel=260, weak_bc=True, sym=True)`, FEAModel with
  f = 0.5, objective l2_functional (scaler 1e5): `Simulator.run` and
  `objective_gradient` (loss, gradient, BiCGStab iteration counts), with
  `LinearSolver("bicgstab_bt")`, BiCGStab preconditioned by the
  block-Thomas factor: with the default BiCGStab + Jacobi the Nitsche
  system (beta = 0.1) does not converge in either package (10,000
  iterations, unconverged, already at nel=128);
* w2: nonlinear Poisson -lap u + u^3 = f with symmetric Nitsche terms
  (beta 10) and PDE_SOLVER="SNES", built as
  tests/test_nonlinear_poisson.py builds it, f = 1.0, objective J: run
  and objective_gradient;
* jit_step: `build_jit_opt_step(nel=260, solver="cg")` at f0, and
  `__graft_entry__.entry()` (nel=32, dense) at its f0: value and
  gradient;
* shape: `shape_gradient` of the energy functional of
  tests/test_shape_derivative.py (Dirichlet energy of u = x^2 + y/2 plus
  0.1 u h on the boundary) on the nel=260 unit square;
* topopt: `build_topopt_model(160, 80)` at the uniform density 0.4 with
  the default LinearSolver (BiCGStab + Jacobi above 4096 dofs): run and
  objective_gradient (compliance, gradient, avg_density); and the
  example's 40 x 20 with solve_mode="jit_dense" through SLSQP(maxiter=15),
  its first and last compliance.

    JAX_PLATFORMS=cpu PYTHONPATH=. python oracles/slice_c_oracle.py w2

recomputes only the named entries and keeps the others of the file.
The whole run took 134 s on one CPU host (w1_weak 25 s, w2 22 s,
jit_step 33 s, entry 1 s, shape 10 s, topopt 13 s, topopt_slsqp 29 s;
each entry's seconds are printed and stored under `seconds`).  W2 runs
at nel=260 (its JAX side takes 22 s, not the 5 minutes that would call
for nel=128); W4 at 160 x 80 converges with the default solver.
"""

import json
import os
import sys
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from femo_tpu.fea import (  # noqa: E402
    FEA, FormDef, Function, FunctionSpace, create_unit_square_mesh, dot, ds,
    dx, grad)
from femo_tpu.fea.shape import (  # noqa: E402
    shape_functional, shape_gradient)
from femo_tpu.graph.model import FEAModel  # noqa: E402
from femo_tpu.graph.optimizer import OptimizationProblem, SLSQP  # noqa: E402
from femo_tpu.graph.simulator import Simulator  # noqa: E402
from femo_tpu.models.poisson import (  # noqa: E402
    build_fea, build_jit_opt_step)
from femo_tpu.models.topopt import build_topopt_model  # noqa: E402
from femo_tpu.solvers import linear  # noqa: E402
from femo_tpu.solvers.linear import LinearSolver  # noqa: E402

import __graft_entry__  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "slice_c_oracle.npz")
PI = np.pi
CONFIGS = {
    "w1_weak": dict(nel=260, weak_bc=True, sym=True, f=0.5,
                    objective="l2_functional", scaler=1e5,
                    linear_solver="bicgstab_bt"),
    "w2": dict(nel=260, sym=True, beta=10.0, pde_solver="SNES", f=1.0,
               objective="J"),
    "jit_step": dict(nel=260, solver="cg", f=0.5),
    "entry": dict(nel=32, solver="dense", f=0.5),
    "shape": dict(nel=260, functional="energy", u="x^2 + y/2",
                  ds="0.1 u h"),
    "topopt": dict(num_el_x=160, num_el_y=80, density=0.4,
                   linear_solver="auto"),
    "topopt_slsqp": dict(num_el_x=40, num_el_y=20,
                         solve_mode="jit_dense", maxiter=15, ftol=1e-9),
}


def w2_fea(nel, sym=True, beta=10.0):
    """tests/test_nonlinear_poisson.py's `build`."""
    mesh = create_unit_square_mesh(nel)
    mesh.mark_boundary_facets(1)
    V = FunctionSpace(mesh, ("CG", 1))
    W = FunctionSpace(mesh, ("DG", 0))
    u, f = Function(V, "u"), Function(W, "f")
    sgn = 1.0 if sym else -1.0

    def interior(w, g):
        return dot(grad(w.u), grad(w.v)) + w.u**3 * w.v - w.f * w.v

    def boundary(w, g):
        ue = jnp.sin(2 * PI * g.x[0]) * jnp.sin(PI * g.x[1])
        r = (-dot(grad(w.u), g.n) * w.v
             + sgn * (ue - w.u) * dot(grad(w.v), g.n))
        if sym:
            r = r + beta / g.h * (w.u - ue) * w.v
        return r

    residual = FormDef([dx(interior), ds(boundary, tag=1)], coeffs=[u, f],
                       test=V)
    u_ex = Function(V, "u_ex").interpolate(
        lambda x: np.sin(2 * PI * x[0]) * np.sin(PI * x[1]))
    obj = FormDef(
        [dx(lambda w, g: 0.5 * (w.u - w.u_ex) ** 2 + 3e-7 * w.f**2)],
        coeffs=[u, u_ex, f])
    fea = FEA(mesh)
    fea.PDE_SOLVER = "SNES"
    fea.add_input("f", f)
    fea.add_state("u", u, residual, ["f"])
    fea.add_output("J", "scalar", obj, ["u", "f"])
    return fea, W


def run_and_gradient(fea, W, of, f0, scaler=1.0, iters=None):
    model = FEAModel(fea=[fea])
    model.create_input("f", shape=W.n_dofs, val=f0)
    model.add_design_variable("f")
    model.add_objective(of, scaler=scaler)
    sim = Simulator(model)
    sim.run()
    run_iters = list(iters or [])
    if iters is not None:
        iters.clear()
    val, grads, _ = sim.objective_gradient(of, ["f"])
    grad_iters = list(iters or [])
    if iters is not None:
        iters.clear()
    return float(val), np.asarray(grads["f"]), run_iters, grad_iters


def krylov_logger():
    """A list that records the iterations of every Krylov solve."""
    iters = []
    for name, fn in list(linear.KRYLOV.items()):
        def logged(*a, _fn=fn, **kw):
            res = _fn(*a, **kw)
            iters.append(int(res.iters))
            return res
        linear.KRYLOV[name] = logged
    return iters


def w1_weak(c, iters):
    fea, d = build_fea(nel=c["nel"], weak_bc=True, sym=c["sym"])
    fea.linear_solver = LinearSolver(c["linear_solver"])
    val, g, ri, gi = run_and_gradient(fea, d["W"], c["objective"], c["f"],
                                      c["scaler"], iters)
    return dict(w1_weak_loss=val, w1_weak_grad=g,
                w1_weak_run_krylov_iters=np.array(ri),
                w1_weak_grad_krylov_iters=np.array(gi))


def w2(c, iters):
    fea, W = w2_fea(c["nel"], c["sym"], c["beta"])
    val, g, ri, gi = run_and_gradient(fea, W, c["objective"], c["f"],
                                      iters=iters)
    return dict(w2_loss=val, w2_grad=g, w2_run_krylov_iters=np.array(ri),
                w2_grad_krylov_iters=np.array(gi))


def jit_step(c, iters):
    step, f0 = build_jit_opt_step(nel=c["nel"], solver=c["solver"])
    val, g = step(f0)
    return dict(jit_step_loss=float(val), jit_step_grad=np.asarray(g))


def entry(c, iters):
    fn, args = __graft_entry__.entry()
    val, g = fn(*args)
    return dict(entry_loss=float(val), entry_grad=np.asarray(g))


def shape(c, iters):
    mesh = create_unit_square_mesh(c["nel"])
    mesh.mark_boundary_facets(1)
    V = FunctionSpace(mesh, ("CG", 1))
    u = Function(V, "u").interpolate(lambda x: x[0] ** 2 + 0.5 * x[1])
    form = FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.u))),
                    ds(lambda w, g: 0.1 * w.u * g.h, tag=1)], coeffs=[u])
    # shape_gradient's jax.grad, jitted (eager it dispatches op by op);
    # checked against the eager call
    sg = np.asarray(jax.jit(jax.grad(shape_functional(form)))(
        jnp.asarray(mesh.coords), form.values()))
    np.testing.assert_allclose(sg, np.asarray(shape_gradient(form)),
                               rtol=0, atol=1e-13 * np.abs(sg).max())
    return dict(shape_grad=sg)


def topopt(c, iters):
    model, fea, d = build_topopt_model(c["num_el_x"], c["num_el_y"])
    sim = Simulator(model)
    o = sim.run()
    ri = list(iters)
    iters.clear()
    val, grads, _ = sim.objective_gradient("compliance",
                                           ["density_unfiltered"])
    gi = list(iters)
    iters.clear()
    return dict(topopt_compliance=float(val),
                topopt_grad=np.asarray(grads["density_unfiltered"]),
                topopt_avg_density=float(o["avg_density"]),
                topopt_run_krylov_iters=np.array(ri),
                topopt_grad_krylov_iters=np.array(gi),
                topopt_n_dofs=d["V"].n_dofs)


def topopt_slsqp(c, iters):
    model, fea, d = build_topopt_model(c["num_el_x"], c["num_el_y"])
    fea.solve_mode = c["solve_mode"]
    sim = Simulator(model, jit=True)
    c0 = float(sim.run()["compliance"])
    prob = OptimizationProblem(sim, "topo")
    SLSQP(prob, ftol=c["ftol"], maxiter=c["maxiter"]).solve()
    return dict(topopt_slsqp_c0=c0,
                topopt_slsqp_c1=float(sim.outputs["compliance"]),
                topopt_slsqp_avg_density=float(sim.outputs["avg_density"]))


def main(keys):
    unknown = set(keys) - set(CONFIGS)
    if unknown:
        raise SystemExit(f"unknown entries {sorted(unknown)}; known: "
                         f"{list(CONFIGS)}")
    out, seconds = {}, {}
    if os.path.exists(OUT):
        with np.load(OUT) as old:
            out = {k: old[k] for k in old.files}
        seconds = json.loads(str(out.pop("seconds", "{}")))
    iters = krylov_logger()
    t_all = time.time()
    for key in keys:
        t0 = time.time()
        iters.clear()
        vals = globals()[key](CONFIGS[key], iters)
        seconds[key] = time.time() - t0
        out.update(vals)
        out[f"{key}_config"] = json.dumps(CONFIGS[key], sort_keys=True)
        shown = {k: (v if np.ndim(v) == 0 else
                     f"|{np.linalg.norm(v)!r}| ({np.size(v)})"
                     if np.size(v) > 8 else list(np.asarray(v)))
                 for k, v in vals.items()}
        print(f"{key} ({seconds[key]:.1f} s): {shown}", flush=True)
    out["seconds"] = json.dumps(seconds)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB) in "
          f"{time.time() - t_all:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:] or list(CONFIGS))
