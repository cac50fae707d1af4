"""Hermite-beam thickness optimization (W3; port of
examples/run_thickness_opt_cantilever_beam.py).

python -m femo_tpu_torch.examples.run_thickness_opt_cantilever_beam
"""

import argparse

import numpy as np

from femo_tpu_torch.graph.model import FEAModel
from femo_tpu_torch.graph.optimizer import OptimizationProblem, SLSQP
from femo_tpu_torch.graph.simulator import Simulator
from femo_tpu_torch.models.beam import OPENMDAO_THICK_REF, build_beam_problem


def main(argv=None):
    argparse.ArgumentParser().parse_args(argv)  # no options, as the JAX one
    nel = 50
    fea, d = build_beam_problem(nel=nel)
    fea.linear_problem = True
    fea.solve_mode = "jit_dense"
    model = FEAModel(fea=[fea])
    model.create_input("thickness", shape=nel, val=0.1)
    model.add_design_variable("thickness", lower=1e-2, upper=10.0,
                              scaler=10.0)
    model.add_objective("compliance", scaler=1e-4)
    model.add_constraint("volume", equals=0.001 * 10, scaler=1e2)
    sim = Simulator(model, jit=True)
    sim.run()

    prob = OptimizationProblem(sim, "beam_thickness_opt")
    opt = SLSQP(prob, ftol=1e-10, maxiter=200)
    r = opt.solve()
    t = sim["thickness"]
    err = float(np.abs(t - OPENMDAO_THICK_REF).max())
    print("=" * 40)
    print(f"SLSQP iters: {r.nit}  compliance: {sim['compliance']}")
    print("max |t - OpenMDAO reference|:", err)
    return {"nit": int(r.nit), "compliance": float(sim["compliance"]),
            "thickness": t, "max_abs_vs_openmdao": err}


if __name__ == "__main__":
    main()
