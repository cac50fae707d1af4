"""Shell thickness optimization: minimize mass subject to tip-displacement
and aggregated-stress constraints (W6, the run_pav_shell.py pattern; port
of examples/run_shell_thickness_opt.py).

python -m femo_tpu_torch.examples.run_shell_thickness_opt
"""

import argparse

import numpy as np
import torch

from femo_tpu_torch.config import config, get_device
from femo_tpu_torch.fea.assemble import compile_form
from femo_tpu_torch.fea.bc import DirichletBC
from femo_tpu_torch.fea.composite import composite_implicit_op
from femo_tpu_torch.graph.model import Model
from femo_tpu_torch.graph.optimizer import OptimizationProblem, SLSQP
from femo_tpu_torch.graph.simulator import Simulator
from femo_tpu_torch.mesh.generators import create_rectangle_mesh
from femo_tpu_torch.mesh.mesh import Mesh
from femo_tpu_torch.models.shell import RMShellModel
from femo_tpu_torch.solvers.linear import LinearSolver


def main(argv=None):
    argparse.ArgumentParser().parse_args(argv)  # no options, as the JAX one
    dev = get_device()
    # plate wing: 4m span, 1m chord, aluminum-like
    L, b = 4.0, 1.0
    m2 = create_rectangle_mesh(4, 12, 0, 0, b, L, cell_type="triangle")
    coords3 = np.concatenate([m2.coords, np.zeros((m2.n_nodes, 1))], axis=1)
    mesh = Mesh(coords3, m2.cells, "triangle")
    shell = RMShellModel(mesh, E=7e10, nu=0.3, rho=2700.0)
    shell.thickness.set(0.01)
    # distributed lift-like load
    farr = np.zeros(shell.Vf.n_dofs)
    farr[2::3] = 400.0  # N/m^2 upward
    shell.force.array = torch.as_tensor(farr, dtype=config.dtype,
                                        device=dev)

    clamp = lambda x: np.isclose(x[1], 0.0)  # noqa: E731
    bcs = [DirichletBC(shell.Vu, 0.0, where=clamp),
           DirichletBC(shell.Vth, 0.0, where=clamp)]
    state = shell.make_state(bcs)
    op = composite_implicit_op(state, ["thickness"],
                               linear_solver=LinearSolver(method="scipy"),
                               newton_opts={"maxiter": 4})
    mcf = compile_form(shell.mass_form)
    pcf = compile_form(shell.pnorm_stress_form(p=8.0, m=1e6))
    tip = int(np.argmax(mesh.coords[:, 1]))

    model = Model()

    def solve_op(t):
        x = op({"thickness": t}, state.current().detach())
        parts = state.split(x)
        return parts["u"], parts["theta"]

    model.add_op("rm_shell", solve_op, ["thickness"], ["u", "theta"])
    model.add_op("mass", lambda t: mcf.scalar({"thickness": t}),
                 ["thickness"], ["mass"])
    model.add_op("tip_disp", lambda u: u.reshape(-1, 3)[tip, 2],
                 ["u"], ["tip_disp"])
    model.add_op(
        "pnorm_stress",
        lambda u, th, t: 1e6 * pcf.scalar(
            {"u": u, "theta": th, "thickness": t,
             "force": shell.force.array}) ** (1 / 8.0),
        ["u", "theta", "thickness"], ["pnorm_stress"])

    model.create_input("thickness", shape=shell.Vt.n_dofs, val=0.01)
    model.add_design_variable("thickness", lower=5e-4, upper=0.05,
                              scaler=100.0)
    model.add_objective("mass", scaler=0.1)
    model.add_constraint("tip_disp", upper=0.05, scaler=20.0)
    model.add_constraint("pnorm_stress", upper=30e6, scaler=1e-7)

    sim = Simulator(model)
    out = sim.run()
    init = {k: float(out[k]) for k in ("mass", "tip_disp", "pnorm_stress")}
    print(f"initial: mass {init['mass']:.2f} kg, "
          f"tip {init['tip_disp']*1e3:.2f} mm, "
          f"stress {init['pnorm_stress']/1e6:.2f} MPa")

    prob = OptimizationProblem(sim, "shell_thickness_opt")
    r = SLSQP(prob, ftol=1e-8, maxiter=25).solve()
    out = sim.outputs
    fin = {k: float(out[k]) for k in ("mass", "tip_disp", "pnorm_stress")}
    t = sim["thickness"]
    print("=" * 40)
    print(f"iters {r.nit} | mass {fin['mass']:.2f} kg | "
          f"tip {fin['tip_disp']*1e3:.2f} mm | "
          f"stress {fin['pnorm_stress']/1e6:.2f} MPa")
    print(f"thickness range [{t.min()*1e3:.2f}, {t.max()*1e3:.2f}] mm "
          f"(root thicker than tip: "
          f"{t[:8].mean() > t[-8:].mean()})")
    return {"nit": int(r.nit), "initial": init, **fin, "thickness": t}


if __name__ == "__main__":
    main()
