"""The JAX package's f64 reference values for the W6 Reissner-Mindlin
shell, at the sizes chip_smoke.py and tests/test_torch_shell*.py drive
the PyTorch/CUDA port at.

    JAX_PLATFORMS=cpu PYTHONPATH=. python oracles/shell_oracle.py

Runs femo_tpu on the CPU in f64 and writes oracles/shell_oracle.npz.
Each entry is stored beside the configuration it was computed for
(`<key>_config`, a JSON string), which chip_smoke.py and the tests check
before they compare:

* a, b: `build_shell_jit_step(n_shell=(24, 400), ...)` in the f64
  configuration (split_programs, pcg_iters=2) and in the JAX package's
  TPU production configuration (split_programs, spd, f32 factor
  storage, pcg_iters=4): compliance and the 19,200-value DG0 thickness
  gradient at the uniform thickness, and the energy estimate J_E =
  2 (J - E) at the forward's solution (second order in its error, where
  J is first order: at this size the solves stall at f64's residual
  floor); a_jacobi (the fused step on the
  equilibrated factor) and b_mixed (f32 storage of the mixed inverses)
  beside them: each pair is two correct solves of one system, whose
  distance is the JAX package's own spread at this size;
* full_residual: the composite residual at a random state (seed 3,
  scale 1e-3) at (24, 400), the operator without a solve;
* modal: `shell_modal_analysis(n_modes=6, method="lanczos")` on the same
  (24, 400) plate (40 iterations), and again with 60 iterations: a
  frequency is held only where the two runs agree (`modal_converged`);
  the Rayleigh quotients of the modes from their strain energy
  (`modal_freqs_rq`, second order in the modes' error);
* module: `ShellModule` on the (16, 24) plate with a grid of aero points
  under a vertical load: `Simulator.run` outputs, then
  `objective_gradient` of compliance and of the p-norm stress with
  respect to thickness, with the default jit_bt solve and again
  (`module_dense_*`) with jit_dense, whose spread bounds the comparison;
  module_small: the same at (4, 6) for the CPU tests;
* step_*: every `tests/test_shell_step_paths.py` configuration at (6, 8):
  compliance and gradient; step_cr the fused step with block cyclic
  reduction;
* assembly: the shell residuals and the four Jacobian blocks (u-u, u-theta,
  theta-u, theta-theta) at random states on the (6, 8) plate and on 4 x 4
  Scordelis-Lo roofs of triangles and quads, inputs included;
  edge: the edge-loaded `ds` residual of a 16 x 2 plate;
* cantilever: the 12 x 2 cantilever plate of tests/test_shell.py solved
  with the default jit_bt op, the composite adjoint gradient of
  compliance with respect to thickness, and the dense and Lanczos
  frequencies (4 modes) and dense modes.

    JAX_PLATFORMS=cpu PYTHONPATH=. python oracles/shell_oracle.py modal

recomputes only the named entries and keeps the others of the file.  The
whole run's seconds are printed and stored under `seconds`, per entry.
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

from femo_tpu.fea import assemble_vector  # noqa: E402
from femo_tpu.fea.assemble import compile_form  # noqa: E402
from femo_tpu.fea.bc import DirichletBC  # noqa: E402
from femo_tpu.graph.simulator import Simulator  # noqa: E402
from femo_tpu.mesh.generators import create_rectangle_mesh  # noqa: E402
from femo_tpu.mesh.mesh import Mesh  # noqa: E402
from femo_tpu.models.shell import (  # noqa: E402
    RMShellModel, build_shell_jit_step, shell_modal_analysis)
from femo_tpu.models.shell_module import ShellModule  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "shell_oracle.npz")
FULL = dict(n_shell=[24, 400])
STEP_PATHS = {  # tests/test_shell_step_paths.py, baseline first
    "base": {},
    "reuse": dict(adjoint="reuse_symmetric", pcg_iters=2),
    "split": dict(split_programs=True, pcg_iters=2),
    "split_f32": dict(split_programs=True, pcg_iters=4,
                      factor_store_dtype="float32"),
    "jacobi": dict(jacobi_scale=True, pcg_iters=2),
    "dense": dict(solve_mode="jit_dense"),
    "mixed_f32": dict(split_programs=True, pcg_iters=4,
                      factor_compute_dtype="mixed",
                      factor_store_dtype="float32"),
    "mixed": dict(split_programs=True, pcg_iters=2,
                  factor_compute_dtype="mixed"),
}
MODULE = dict(n_shell=[16, 24], span=4.0, chord=1.0, E=7e10, nu=0.3,
              thickness=0.01, n_aero=[8, 12], force_z=-80.0)
CONFIGS = {
    "a": dict(FULL, split_programs=True, pcg_iters=2),
    "b": dict(FULL, split_programs=True, spd=True,
              factor_store_dtype="float32", pcg_iters=4),
    "a_jacobi": dict(FULL, jacobi_scale=True, pcg_iters=2),
    "b_mixed": dict(FULL, split_programs=True, pcg_iters=4,
                    factor_compute_dtype="mixed",
                    factor_store_dtype="float32"),
    "full_residual": dict(FULL, seed=3, scale=1e-3),
    "modal": dict(FULL, n_modes=6, method="lanczos", lanczos_iters=40,
                  seed=0, check_iters=60),
    "module": MODULE,
    "module_small": dict(MODULE, n_shell=[4, 6], n_aero=[3, 4]),
    **{f"step_{k}": dict(kw, n_shell=[6, 8]) for k, kw in STEP_PATHS.items()},
    # block cyclic reduction through the fused step (not a STEP_PATHS
    # entry: the spreads between those paths set the tests' bars)
    "step_cr": dict(n_shell=[6, 8], factor_method="cr"),
    "assembly": dict(plate=[6, 8], roof=4, seed=0),
    "edge": dict(n=[16, 2], L=10.0, b=1.0, t=0.1, E=1e6, seed=1),
    "cantilever": dict(n=[12, 2], L=10.0, b=1.0, t=0.1, E=1e6, q=1e-3,
                       n_modes=4),
}


def _np(a):
    return np.asarray(a, np.float64)


def plate(nx, ny, x1, y1):
    m2 = create_rectangle_mesh(nx, ny, 0, 0, x1, y1, cell_type="triangle")
    return Mesh(np.concatenate([m2.coords, np.zeros((m2.n_nodes, 1))], 1),
                m2.cells, "triangle")


def roof(n, cell_type):
    """The Scordelis-Lo roof of tests/test_shell.py on n x n cells."""
    R, L, phi_max = 25.0, 50.0, np.deg2rad(40.0)
    m2 = create_rectangle_mesh(n, n, -phi_max, 0.0, phi_max, L,
                               cell_type=cell_type)
    phi, y = m2.coords[:, 0], m2.coords[:, 1]
    return Mesh(np.stack([R * np.sin(phi), y, R * np.cos(phi)], axis=1),
                m2.cells, cell_type)


def step(c):
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in c.items()}
    s, t0, _ = build_shell_jit_step(**kw)
    v, g = s(t0)
    return float(v), _np(g)


def split_step(c, key):
    """J and gradient of a split_programs step, and the energy estimate
    J_E = 2 (J(x) - E(x)) at the forward's solution x (E the strain
    energy): J_E = J* - ||x - x*||_K^2, second order in x's error."""
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in c.items()}
    s, t0, info = build_shell_jit_step(**kw)
    v, g = s(t0)
    _, x, _ = info["programs"]["fwd"](t0, info["consts"])
    parts = info["state"].split(x)
    force = info["consts"]["force"]
    E = compile_form(info["shell"].energy_form).scalar(
        {"u": parts["u"], "theta": parts["theta"], "thickness": t0,
         "force": force})
    C = compile_form(info["shell"].compliance_form).scalar(
        {"u": parts["u"], "force": force})
    return {f"{key}_J": float(v), f"{key}_grad": _np(g),
            f"{key}_JE": float(2 * C - 2 * E)}


def a(c):
    return split_step(c, "a")


def b(c):
    return split_step(c, "b")


def a_jacobi(c):
    J, g = step(c)
    return dict(a_jacobi_J=J, a_jacobi_grad=g)


def b_mixed(c):
    J, g = step(c)
    return dict(b_mixed_J=J, b_mixed_grad=g)


def full_residual(c):
    _, t0, info = build_shell_jit_step(n_shell=tuple(c["n_shell"]))
    x = c["scale"] * np.random.default_rng(c["seed"]).standard_normal(
        info["n_dofs"])
    r = info["state"].residual(jnp.asarray(x), {
        "thickness": t0, "force": info["consts"]["force"]})
    return dict(full_residual_r=_np(r))


def modal(c):
    _, _, info = build_shell_jit_step(n_shell=tuple(c["n_shell"]))
    shell = info["shell"]
    clamp = lambda x: np.isclose(x[1], 0.0)
    bcs = [DirichletBC(shell.Vu, 0.0, where=clamp),
           DirichletBC(shell.Vth, 0.0, where=clamp)]
    out = {}
    ecf = compile_form(shell.energy_form)
    for key, it in (("modal_freqs", c["lanczos_iters"]),
                    ("modal_freqs_check", c["check_iters"])):
        f, modes = shell_modal_analysis(shell, bcs, n_modes=c["n_modes"],
                                        method=c["method"],
                                        lanczos_iters=it, seed=c["seed"])
        out[key] = _np(f)
    # Rayleigh quotients from the strain energy, phi^T K phi = 2 E(phi)
    # (a sum of squares: no cancellation), over phi^T M phi = 1 (the
    # modes are M-orthonormal by construction)
    rq = []
    for j in range(modes.shape[1]):
        parts = info["state"].split(modes[:, j])
        E = ecf.scalar({"u": parts["u"], "theta": parts["theta"],
                        "thickness": shell.thickness.array,
                        "force": shell.force.array})
        rq.append(np.sqrt(2 * float(E)) / (2 * np.pi))
    out["modal_freqs_rq"] = np.asarray(rq)
    out["modal_converged"] = (np.abs(out["modal_freqs"]
                                     - out["modal_freqs_check"])
                              <= 1e-9 * out["modal_freqs_check"])
    return out


def _module(c, prefix):
    nx, ny = c["n_shell"]
    mesh = plate(nx, ny, c["chord"], c["span"])
    shell = RMShellModel(mesh, E=c["E"], nu=c["nu"])
    shell.thickness.set(c["thickness"])
    clamp = lambda x: np.isclose(x[1], 0.0)
    bcs = [DirichletBC(shell.Vu, 0.0, where=clamp),
           DirichletBC(shell.Vth, 0.0, where=clamp)]
    xs = np.linspace(0.05, 0.95, c["n_aero"][0]) * c["chord"]
    ys = np.linspace(0.05, 0.95, c["n_aero"][1]) * c["span"]
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], axis=1)
    F = np.zeros((len(pts), 3))
    F[:, 2] = c["force_z"]
    out = {}
    for mode, name in (("jit_bt", prefix), ("jit_dense", f"{prefix}_dense")):
        sim = Simulator(ShellModule(shell, bcs, pts, solve_mode=mode))
        sim["nodal_forces"] = F
        run = sim.run()
        out.update({f"{name}_{k}": _np(run[k]) for k in (
            "mass", "compliance", "elastic_energy", "pnorm_stress",
            "nodal_displacements", "von_mises")})
        for of in ("compliance", "pnorm_stress"):
            val, grads, _ = sim.objective_gradient(of, ["thickness"])
            out[f"{name}_{of}_value"] = _np(val)
            out[f"{name}_{of}_grad"] = _np(grads["thickness"])
        shell.u.set(0.0)
        shell.theta.set(0.0)
    return out


def module(c):
    return _module(c, "module")


def module_small(c):
    return _module(c, "module_small")


def _assembly_case(mesh, rng, prefix):
    shell = RMShellModel(mesh, E=7e10, nu=0.3)
    vals = {"u": 1e-3 * rng.standard_normal(shell.Vu.n_dofs),
            "theta": 1e-3 * rng.standard_normal(shell.Vth.n_dofs),
            "thickness": 0.01 + 1e-3 * rng.random(shell.Vt.n_dofs),
            "force": rng.standard_normal(shell.Vf.n_dofs)}
    jv = {k: jnp.asarray(v) for k, v in vals.items()}
    out = {f"{prefix}_in_{k}": v for k, v in vals.items()}
    for rname, form in (("u", shell.res_u), ("theta", shell.res_th)):
        cf = compile_form(form)
        out[f"{prefix}_r_{rname}"] = _np(cf.vector(jv))
        for cname in ("u", "theta"):
            (blk,) = cf.matrix(jv, cname).blocks
            out[f"{prefix}_A_{rname}_{cname}"] = _np(blk.A)
    return out


def assembly(c):
    rng = np.random.default_rng(c["seed"])
    out = _assembly_case(plate(*c["plate"], 1.0, 4.0), rng, "asm_plate")
    for ct in ("triangle", "quad"):
        out.update(_assembly_case(roof(c["roof"], ct), rng, f"asm_roof_{ct}"))
    return out


def edge(c):
    nx, ny = c["n"]
    mesh = plate(nx, ny, c["L"], c["b"])
    mesh.mark_boundary_facets(1, predicate=lambda x: np.isclose(x[0], c["L"]))
    shell = RMShellModel(mesh, E=c["E"], nu=0.0, edge_load_tag=1)
    shell.thickness.set(c["t"])
    rng = np.random.default_rng(c["seed"])
    ef = rng.standard_normal(shell.Vf.n_dofs)
    shell.edge_force.array = jnp.asarray(ef)
    return dict(edge_in_force=ef,
                edge_r_u=_np(assemble_vector(shell.res_u)))


def cantilever(c):
    nx, ny = c["n"]
    mesh = plate(nx, ny, c["L"], c["b"])
    shell = RMShellModel(mesh, E=c["E"], nu=0.0)
    shell.thickness.set(c["t"])
    farr = np.zeros(shell.Vf.n_dofs)
    farr[2::3] = -c["q"]
    shell.force.array = jnp.asarray(farr)
    clamp = lambda x: np.isclose(x[0], 0.0)
    bcs = [DirichletBC(shell.Vu, 0.0, where=clamp),
           DirichletBC(shell.Vth, 0.0, where=clamp)]
    state, op, x = shell.solve(bcs)
    ccf = compile_form(shell.compliance_form)

    def compliance_of_t(tarr):
        xx = op({"thickness": tarr}, jax.lax.stop_gradient(state.current()))
        return ccf.scalar({"u": state.split(xx)["u"],
                           "force": shell.force.array})

    Jc, g = jax.value_and_grad(compliance_of_t)(shell.thickness.array)
    f_d, m_d = shell_modal_analysis(shell, bcs, n_modes=c["n_modes"],
                                    method="dense")
    f_l, m_l = shell_modal_analysis(shell, bcs, n_modes=c["n_modes"],
                                    method="lanczos")
    return dict(cant_x=_np(x), cant_J=float(Jc), cant_grad=_np(g),
                cant_freqs_dense=_np(f_d), cant_modes_dense=_np(m_d),
                cant_freqs_lanczos=_np(f_l), cant_modes_lanczos=_np(m_l))


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
    t_all = time.time()
    for key in keys:
        t0 = time.time()
        if key.startswith("step_"):
            J, g = step(CONFIGS[key])
            vals = {f"{key}_J": J, f"{key}_grad": g}
        else:
            vals = globals()[key](CONFIGS[key])
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
