"""EM motor shape/current optimization (W5; port of
examples/run_motor_opt.py).

python -m femo_tpu_torch.examples.run_motor_opt --refine 0.5 --maxiter 10 \
    [--driver snopt] [--dash dash_motor]
python -m femo_tpu_torch.examples.run_motor_opt --jit --refine 4 [--msh gen]

--jit keeps f64 on the card with factorization="block_thomas" (the sweeps
K1/K2 in every Newton and adjoint solve).  The JAX script drops to f32
there only because a TPU emulates f64; on the CPU both scripts use dense
LU.
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from femo_tpu_torch.config import config, get_device
from femo_tpu_torch.graph.optimizer import OptimizationProblem, SLSQP, SNOPT
from femo_tpu_torch.graph.simulator import Simulator
from femo_tpu_torch.models.motor.model import (
    build_motor_jit_step, build_motor_model)


def run_jit(args):
    """Optimization over the motor step: every (loss, grad) evaluation is
    one call of build_motor_jit_step's step (continuation + Newton + IFT
    adjoint through both states); scipy's L-BFGS-B only orchestrates."""
    from scipy.optimize import minimize

    dev = get_device()
    on_card = dev.type == "cuda"
    mesh = _imported_mesh(args) if args.msh is not None else None
    step, (dv0, iq0), d = build_motor_jit_step(
        refine=args.refine, em_load_steps=3, mm_newton_iters=3,
        em_newton_iters=3, mesh=mesh,
        factorization="block_thomas" if on_card else "lu")
    if d.get("bt"):
        print("RCM bandwidth (mm/em):", d["bt"])

    history = []

    def fun(x):
        t0 = time.perf_counter()
        v, (gdv, giq) = step(
            torch.as_tensor(x[:2], dtype=config.dtype, device=dev),
            torch.as_tensor(x[2], dtype=config.dtype, device=dev))
        g = np.concatenate([gdv.detach().cpu().numpy().astype(float),
                            [float(giq)]])
        history.append((float(v), time.perf_counter() - t0))
        return float(v), g

    x0 = np.concatenate([dv0.detach().cpu().numpy().astype(float),
                         [float(iq0)]])
    scale = np.array([1e3, 1e3, 1e-5])  # O(1) scaling for scipy
    # valid (non-crushing) shape range and current window, as in the
    # eager example's design-variable bounds
    bounds = list(zip(np.array([-1e-3, -1e-3, 0.5e5]) * scale,
                      np.array([1e-3, 1e-3, 2.0e5]) * scale))

    def fun_s(y):
        v, g = fun(y / scale)
        return v, g / scale

    r = minimize(fun_s, x0 * scale, jac=True, method="L-BFGS-B",
                 bounds=bounds, options=dict(maxiter=args.maxiter))
    mean_ms = np.mean([t for _, t in history[1:]]) * 1e3
    print("=" * 40)
    print(f"jit-mode optimization ({'card f64' if on_card else 'CPU f64'}, "
          f"refine={args.refine}): {len(history)} evaluations")
    print(f"loss: {history[0][0]:.6e} -> {r.fun:.6e}")
    print(f"mean step wall-clock: {mean_ms:.1f} ms")
    print("x* (dv0, dv1, iq):", r.x / scale)
    return {"evaluations": len(history),
            "losses": [v for v, _ in history],
            "seconds": [t for _, t in history], "loss": float(r.fun),
            "x": r.x / scale, "nit": int(r.nit), "mean_step_ms": mean_ms,
            "bt": d.get("bt")}


def _imported_mesh(args):
    """Import-first path: load the mesh and its .ini association table;
    --msh gen writes the unstructured motor .msh first (to a temporary
    directory)."""
    from femo_tpu_torch.mesh.gmsh_io import (
        import_mesh, read_association_table)

    path = args.msh
    if path == "gen":
        from femo_tpu_torch.models.motor.unstructured import write_motor_msh

        path = os.path.join(tempfile.mkdtemp(), "motor.msh")
        write_motor_msh(path, refine=args.refine, seed=0)
    mesh = import_mesh(path)
    ini = os.path.splitext(path)[0] + ".ini"
    if os.path.exists(ini):
        table = read_association_table(ini)
        print(f"imported {mesh} with {len(table)}-entry association table")
    return mesh


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--refine", type=float, default=0.5)
    p.add_argument("--maxiter", type=int, default=10)
    p.add_argument("--msh", default=None,
                   help="run from an imported gmsh .msh instead of the "
                        "procedural mesh ('gen' generates the "
                        "unstructured motor mesh first); jit mode only")
    p.add_argument("--driver", choices=["slsqp", "snopt"], default="slsqp")
    p.add_argument("--dash", default=None,
                   help="directory for per-iteration dashboard PNG frames "
                        "(lsdo_dash parity)")
    p.add_argument("--jit", action="store_true",
                   help="drive the motor step (build_motor_jit_step) "
                        "instead of the eager graph")
    args = p.parse_args(argv)

    if args.jit:
        return run_jit(args)

    model, d = build_motor_model(refine=args.refine, em_load_steps=3)
    # keep within the valid (non-crushing) shape range
    model.design_variables["shape_dv"].update(lower=-1e-3, upper=1e-3)
    model.add_constraint("magnet_area", lower=7e-4, scaler=1e3)
    sim = Simulator(model)
    sim["shape_dv"] = np.array([2e-4, 0.0])
    out = sim.run()
    loss0 = float(out["loss_sum"])
    print("initial loss_sum:", loss0)

    prob = OptimizationProblem(sim, "motor_opt")
    dash = None
    if args.dash:
        from femo_tpu_torch.graph.dashboard import Dashboard

        dash = Dashboard(prob, outdir=args.dash)
    if args.driver == "snopt":
        # SNOPT binding hook; falls back to SLSQP when no binding is
        # installed
        r = SNOPT(prob, Major_iterations=args.maxiter,
                  Major_optimality=1e-8).solve()
    else:
        r = SLSQP(prob, ftol=1e-8, maxiter=args.maxiter).solve()
    summary = dash.finalize() if dash is not None else None
    if summary is not None:
        print("dashboard:", summary)
    res = {"initial_loss_sum": loss0,
           "loss_sum": float(sim.outputs["loss_sum"]), "nit": int(r.nit),
           "shape_dv": sim["shape_dv"], "iq": float(sim["iq"]),
           "magnet_area": float(sim.outputs["magnet_area"]),
           "winding_area": float(sim.outputs["winding_area"]),
           "dashboard": summary}
    print("=" * 40)
    print("final loss_sum:", res["loss_sum"], "| iters:", res["nit"])
    print("shape_dv:", res["shape_dv"], "iq:", res["iq"])
    print("areas: magnet", res["magnet_area"], "winding",
          res["winding_area"])
    return res


if __name__ == "__main__":
    main()
