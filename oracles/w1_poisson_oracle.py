"""The JAX package's f64 reference values for the W1 Poisson optimization
at nel=260, which chip_smoke.py holds the PyTorch/CUDA port to.

    JAX_PLATFORMS=cpu PYTHONPATH=. python oracles/w1_poisson_oracle.py

Runs femo_tpu (CPU, f64) along the path chip_smoke.py drives in the port:
`build_fea(nel=260)`, FEAModel with f = 0.5, objective l2_functional
(scaler 1e5), `Simulator.run()` and `objective_gradient`; the
manufactured-solution forward solve of tests/test_poisson_opt.py (source
sin(pi x) sin(pi y)) at nel=260 with its L2 error against u_ex; and
`SLSQP(maxiter=3)` on the same model at nel=32.  SLSQP does not run at
nel=260: scipy's SLSQP keeps dense work arrays of about 10.5 n^2 values
for n design variables, 1.4 TiB for the 135,200 controls.  Writes the
loss, the gradient dJ/df (135,200 values), the error norm, the Krylov
iteration counts and the SLSQP objectives to
oracles/w1_poisson_nel260.npz and prints the scalars.
"""

import os
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from femo_tpu.fea import Function, errorNorm  # noqa: E402
from femo_tpu.graph.model import FEAModel  # noqa: E402
from femo_tpu.graph.optimizer import OptimizationProblem, SLSQP  # noqa: E402
from femo_tpu.graph.simulator import Simulator  # noqa: E402
from femo_tpu.models.poisson import build_fea  # noqa: E402
from femo_tpu.solvers import linear  # noqa: E402

NEL = 260
NEL_OPT = 32  # SLSQP: 2,048 controls
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   f"w1_poisson_nel{NEL}.npz")


def model_at(nel):
    fea, d = build_fea(nel=nel)
    model = FEAModel(fea=[fea])
    model.create_input("f", shape=d["W"].n_dofs, val=0.5)
    model.add_design_variable("f")
    model.add_objective("l2_functional", scaler=1e5)
    return Simulator(model), d


def main():
    iters = []  # (method, iterations) of every Krylov solve, in order
    for name, fn in list(linear.KRYLOV.items()):
        def logged(*a, _fn=fn, _name=name, **kw):
            res = _fn(*a, **kw)
            iters.append(int(res.iters))
            return res
        linear.KRYLOV[name] = logged

    t0 = time.time()
    sim, d = model_at(NEL)
    sim.run()
    run_iters = list(iters)
    iters.clear()
    val, grads, _ = sim.objective_gradient("l2_functional", ["f"])
    grad_iters = list(iters)
    iters.clear()

    sim_opt, _ = model_at(NEL_OPT)
    sim_opt.run()
    prob = OptimizationProblem(sim_opt, "poisson_opt")
    res = SLSQP(prob, ftol=1e-13, maxiter=3).solve()
    slsqp_obj = np.array([h["obj"] for h in prob.history])

    fea_m, dm = build_fea(nel=NEL)
    f_src = Function(dm["f"].space).interpolate(
        lambda x: np.sin(np.pi * x[0]) * np.sin(np.pi * x[1]))
    fea_m.solve("u", {"f": f_src.array})
    err = errorNorm(dm["u_ex"], dm["u"])

    g = np.asarray(grads["f"])
    np.savez_compressed(
        OUT, loss=float(val), grad=g, error_norm=err,
        run_krylov_iters=np.array(run_iters),
        grad_krylov_iters=np.array(grad_iters),
        slsqp_obj=slsqp_obj, slsqp_fun=float(res.fun),
        slsqp_nit=int(res.nit))
    print(f"nel={NEL}: {d['V'].n_dofs} CG1 dofs, {d['W'].n_dofs} DG0 "
          f"controls ({time.time() - t0:.1f} s)")
    print(f"loss {float(val)!r}, |grad| {float(np.linalg.norm(g))!r}")
    print(f"Krylov iterations: run {run_iters}, objective_gradient "
          f"{grad_iters}")
    print(f"SLSQP(maxiter=3) at nel={NEL_OPT}: nit {res.nit}, objectives "
          f"{[float(v) for v in slsqp_obj]}")
    print(f"manufactured solution errorNorm {err!r}")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
