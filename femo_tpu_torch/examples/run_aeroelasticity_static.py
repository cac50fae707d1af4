"""Static aeroelastic wing (W7; port of
examples/run_aeroelasticity_static.py).

python -m femo_tpu_torch.examples.run_aeroelasticity_static [--check-totals] [--opt]

--check-totals checks d(tip)/d(thickness) THROUGH the coupled VLM <-> shell
Gauss-Seidel loop, the gradient by torch.autograd through the
differentiable fixed point, against central differences, and writes the
analytic / FD / error gradient fields to XDMF (h5py).

--opt runs a coupled thickness OPTIMIZATION (minimize structural volume
s.t. tip deflection <= 80% of the uniform-thickness baseline) with SLSQP,
every constraint gradient from build_fsi_jit_step's solve_with_grad
(factor-once Gauss-Seidel forward, factor-reuse IFT adjoint).
"""

import argparse

import numpy as np
import torch

from femo_tpu_torch.models.fsi import build_wing_fsi
from femo_tpu_torch.utils.profiling import Timer


def _host(t):
    return t.detach().cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-totals", action="store_true")
    ap.add_argument("--opt", action="store_true")
    ap.add_argument("--maxiter", type=int, default=30)
    ap.add_argument("--out", default="fsi_gradients")
    args = ap.parse_args(argv)

    if args.opt:
        return run_coupled_opt(maxiter=args.maxiter)

    fsi = build_wing_fsi(n_shell=(6, 10), n_vlm=(3, 8))
    with Timer("Coupled FSI solve"):
        out = fsi["solve"](fsi["shell"].thickness.array)
    res = {"tip_disp": float(out["tip_disp"]),
           "total_aero_force": _host(out["total_aero_force"]),
           "total_mapped_force": _host(out["total_mapped_force"])}
    print("=" * 40)
    print("tip deflection:", res["tip_disp"])
    print("total aero force:  ", res["total_aero_force"])
    print("total mapped force:", res["total_mapped_force"],
          "(conservation check, run_pav_shell.py:433-438 parity)")

    if args.check_totals:
        shell = fsi["shell"]
        solve = fsi["solve"]

        def tip_of_t(tarr):
            return solve(tarr, tol=1e-12, maxiter=200)["tip_disp"]

        t0 = shell.thickness.array.detach()
        with Timer("Coupled adjoint d(tip)/d(thickness)"):
            tl = t0.clone().requires_grad_(True)
            with torch.enable_grad():
                (g,) = torch.autograd.grad(tip_of_t(tl), tl)
            g = _host(g)
        h = 1e-5
        fd = np.zeros_like(g)
        with Timer(f"Central differences over {g.size} thickness dofs"), \
                torch.no_grad():
            for i in range(g.size):
                tp, tm = t0.clone(), t0.clone()
                tp[i] += h
                tm[i] -= h
                fd[i] = (float(tip_of_t(tp)) - float(tip_of_t(tm))) / (2 * h)
        err = np.abs(g - fd)
        rel = np.linalg.norm(err) / max(np.linalg.norm(fd), 1e-30)
        print(f"check_totals[tip_disp wrt thickness]: "
              f"||analytic - FD|| / ||FD|| = {rel:.3e}")

        # dump analytic / FD / error gradient FIELDS (DG0 per-cell) to XDMF
        from femo_tpu_torch.fea.space import Function
        from femo_tpu_torch.io.xdmf import XDMFWriter

        with XDMFWriter(args.out + ".xdmf", fsi["mesh"]) as w:
            for name, arr in (("grad_analytic", g), ("grad_fd", fd),
                              ("grad_error", err)):
                w.write_function(Function(shell.Vt, name, arr))
        print(f"gradient fields written to {args.out}.xdmf")
        res.update(grad=g, grad_fd=fd, check_totals_rel=rel)
    return res


def run_coupled_opt(n_shell=(6, 10), n_vlm=(3, 8), maxiter=10):
    """Volume-min thickness optimization through the coupled loop."""
    from scipy.optimize import minimize

    from femo_tpu_torch.config import config
    from femo_tpu_torch.fea.project import lumped_mass
    from femo_tpu_torch.models.fsi import build_fsi_jit_step

    jit = build_fsi_jit_step(n_shell=n_shell, n_vlm=n_vlm,
                             factor_store_dtype=None, pcg_iters=2,
                             gs_inner=10, relax=0.7, adj_passes=40)
    dev = jit["t0"].device
    t0 = _host(jit["t0"])
    # per-dof tributary area for the (linear) volume objective
    area = _host(lumped_mass(jit["shell"].Vt))
    vol0 = float(area @ t0)

    def dev_t(t):
        return torch.as_tensor(t, dtype=config.dtype, device=dev)

    with Timer("baseline coupled solve + adjoint"):
        out0 = jit["solve_with_grad"](dev_t(t0), rounds=8)
    tip0 = float(out0["tip_disp"])
    tip_lim = 0.8 * tip0
    print(f"baseline: tip {tip0:.5f}, volume {vol0:.6f}; "
          f"constraint tip <= {tip_lim:.5f}")

    cache = {}

    def tip_and_grad(t):
        key = t.tobytes()
        if key not in cache:
            out = jit["solve_with_grad"](dev_t(t), rounds=8)
            cache.clear()
            cache[key] = (float(out["tip_disp"]),
                          _host(out["grad_thickness"]))
        return cache[key]

    # normalized objective/constraint (SLSQP is scale-sensitive)
    res = minimize(
        lambda t: (float(area @ t) / vol0, area / vol0),
        t0, jac=True, method="SLSQP",
        constraints=[{"type": "ineq",
                      "fun": lambda t: (tip_lim - tip_and_grad(t)[0]) / tip0,
                      "jac": lambda t: -tip_and_grad(t)[1] / tip0}],
        bounds=[(0.2 * t0[0], 5.0 * t0[0])] * t0.size,
        options={"maxiter": maxiter, "ftol": 1e-8})

    tip_f, _ = tip_and_grad(res.x)
    vol_f = float(area @ res.x)
    print("=" * 40)
    print(f"SLSQP ({res.nit} iters): volume {vol0:.6f} -> {vol_f:.6f} "
          f"({100 * (vol_f / vol0 - 1):+.2f}%), tip {tip0:.5f} -> "
          f"{tip_f:.5f} (limit {tip_lim:.5f})")
    assert tip_f <= tip_lim * 1.01, "tip constraint violated"
    return {"nit": int(res.nit), "volume0": vol0, "volume": vol_f,
            "tip0": tip0, "tip": tip_f, "tip_limit": tip_lim,
            "thickness": res.x}


if __name__ == "__main__":
    main()
