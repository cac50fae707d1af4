"""SIMP topology optimization of a 2D cantilever (W4; port of
examples/run_topo_opt_cantilever_beam.py).

python -m femo_tpu_torch.examples.run_topo_opt_cantilever_beam --nelx 40 --nely 20
"""

import argparse

from femo_tpu_torch.graph.optimizer import OptimizationProblem, SLSQP
from femo_tpu_torch.graph.simulator import Simulator
from femo_tpu_torch.models.topopt import build_topopt_model


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nelx", type=int, default=40)
    p.add_argument("--nely", type=int, default=20)
    p.add_argument("--maxiter", type=int, default=60)
    p.add_argument("--method", default="SIMP", choices=["SIMP", "RAMP"])
    args = p.parse_args(argv)

    model, fea, d = build_topopt_model(args.nelx, args.nely,
                                       method=args.method)
    fea.solve_mode = "jit_dense"
    sim = Simulator(model, jit=True)
    c0 = float(sim.run()["compliance"])
    SLSQP(OptimizationProblem(sim, "topo"), ftol=1e-9,
          maxiter=args.maxiter).solve()
    c = float(sim.outputs["compliance"])
    avg = float(sim.outputs["avg_density"])
    print("=" * 40)
    print(f"compliance: {c0:.4f} -> {c:.4f}")
    print(f"avg density: {avg:.4f}")
    return {"initial_compliance": c0, "compliance": c, "avg_density": avg}


if __name__ == "__main__":
    main()
