"""Poisson source-control optimization (W1; port of
examples/run_poisson_opt.py).

python -m femo_tpu_torch.examples.run_poisson_opt --nel 16
"""

import argparse

from femo_tpu_torch.fea import errorNorm
from femo_tpu_torch.graph.model import FEAModel
from femo_tpu_torch.graph.optimizer import OptimizationProblem, SLSQP
from femo_tpu_torch.graph.simulator import Simulator
from femo_tpu_torch.models.poisson import build_fea


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nel", type=int, default=16)
    p.add_argument("--maxiter", type=int, default=100)
    p.add_argument("--record", action="store_true")
    args = p.parse_args(argv)

    fea, d = build_fea(nel=args.nel)
    model = FEAModel(fea=[fea])
    model.create_input("f", shape=d["W"].n_dofs, val=0.086)
    model.add_design_variable("f")
    model.add_objective("l2_functional", scaler=1e5)
    sim = Simulator(model)
    sim.run()

    prob = OptimizationProblem(sim, "poisson_opt")
    SLSQP(prob, ftol=1e-13, maxiter=args.maxiter).solve()

    obj = sim["l2_functional"]
    print("=" * 40)
    print("Objective value:", obj)
    d["f"].array = sim.values["f"]
    e_f = errorNorm(d["f_ex"], d["f"])
    e_u = errorNorm(d["u_ex"], d["u"])
    print("Error in controls:", e_f)
    print("Error in states:  ", e_u)
    if args.record:
        from femo_tpu_torch.io.xdmf import XDMFWriter

        with XDMFWriter("solutions/state_u.xdmf", d["mesh"]) as x:
            x.write_function(d["u"])
    return {"objective": float(obj), "error_controls": e_f,
            "error_states": e_u}


if __name__ == "__main__":
    main()
