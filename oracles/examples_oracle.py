"""The JAX package's f64 values for the run scripts and the L-BFGS-B runs
that the PyTorch/CUDA port's scripts (femo_tpu_torch/examples/) are held
to, by tests/test_torch_examples.py and tests/test_torch_optimizer_drivers.py
on the CPU and by chip_smoke.py's `run_scripts` phase on the card.

    JAX_PLATFORMS=cpu PYTHONPATH=. python oracles/examples_oracle.py [key ...]

Each entry runs one of the JAX package's own `examples/run_*.py` the way
it runs from the command line (its `main()` with `sys.argv` set to the
entry's arguments, in a temporary working directory), or, for the
`w1_lbfgsb_*` entries, the graph API with `LBFGSB`.  While it runs, every
`scipy.optimize.minimize` call is recorded (femo_tpu_torch/tools/
minimize_log.py, numpy only): the objective at every evaluation as the
optimizer sees it (`<key>_f`), the first gradient (`<key>_g0`), the final
point (`<key>_x`), the evaluation and iteration counts (`<key>_nfev`,
`<key>_nit`) and the final value (`<key>_fun`).  Beside them: the last
Simulator's scalar outputs (`<key>_out_<name>`) and design variables
(`<key>_dv_<name>`), the script's standard output (`<key>_stdout`),
values the scripts print only rounded, taken at full precision from the
objects they build (`<key>_...` below), `<key>_config` (the arguments,
JSON) and `<key>_seconds`.

* motor_jit_r4: `run_motor_opt.py --jit --refine 4 --maxiter 3`.  On the
  CPU the JAX script picks dense LU, which does not fit at refine 4
  (~74,000 mesh-motion dofs); this entry runs the script's TPU branch,
  `factorization="block_thomas"`, in f64, which is what the port runs on
  the card.
* motor_jit_r05: `--jit --refine 0.5 --maxiter 2`, dense LU as the script
  picks on the CPU (the port's CPU test).
* motor_snopt_r1: `run_motor_opt.py --refine 1 --driver snopt --maxiter
  1`: no SNOPT binding, so SNOPT warns and runs SLSQP.
* w1_lbfgsb_nel260 / w1_lbfgsb_nel8: W1 (`build_fea`, f = 0.5, objective
  l2_functional with scaler 1e5) through `LBFGSB(maxiter=5)`.
* motor_record_r05: `build_motor_model(record=True)` (refine 0.5, 2 EM
  load steps, LinearSolver("scipy"), shape_dv (5e-4, 3e-4)) and one
  `Simulator.run()`: the recorder's XDMF text (`<key>_xdmf`) and every
  HDF5 dataset (`<key>_h5/<path>`).
* roof: besides the script's values (one block-Thomas step, unpolished),
  the same roof solved exactly (`solve_mode="jit_dense"`, dense LU):
  `roof_exact_deflection`, `roof_exact_compliance`,
  `roof_exact_shape_grad`; the script's own distance from them is the
  JAX package's spread between its two solves of one system.
* the other keys: each small script at the arguments of the port's tests.

Each entry is saved as soon as it is done; named entries are recomputed
and the others of the file kept.  Run one process at a time: each
rewrites the whole file.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys
import tempfile
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from femo_tpu_torch.tools.minimize_log import minimize_log  # noqa: E402

OUT = os.path.join(ROOT, "oracles", "examples_oracle.npz")

SCRIPTS = {
    "motor_jit_r4": ("run_motor_opt", ["--jit", "--refine", "4",
                                       "--maxiter", "3"]),
    "motor_jit_r05": ("run_motor_opt", ["--jit", "--refine", "0.5",
                                        "--maxiter", "2"]),
    "motor_snopt_r1": ("run_motor_opt", ["--refine", "1", "--driver",
                                         "snopt", "--maxiter", "1"]),
    "poisson": ("run_poisson_opt", ["--nel", "8", "--maxiter", "10"]),
    "poisson32": ("run_poisson_opt", ["--nel", "32", "--maxiter", "5"]),
    "nonlinear_poisson": ("run_nonlinear_poisson_opt",
                          ["--nel", "8", "--maxiter", "10"]),
    "topo": ("run_topo_opt_cantilever_beam", ["--nelx", "12", "--nely", "6",
                                              "--maxiter", "5"]),
    "beam": ("run_thickness_opt_cantilever_beam", []),
    "shell_thickness": ("run_shell_thickness_opt", []),
    "shell_modal": ("run_shell_modal", ["--nx", "2", "--ny", "8",
                                        "--n-modes", "4"]),
    "roof": ("run_shape_opt_roof", ["--n", "6"]),
    "aero_static": ("run_aeroelasticity_static", []),
    "aero_dynamic": ("run_aeroelasticity_dynamic", ["--nsteps", "3"]),
    "aero_vpm": ("run_aeroelasticity_vpm", ["--nsteps", "3"]),
}
W1 = {"w1_lbfgsb_nel260": dict(nel=260, maxiter=5),
      "w1_lbfgsb_nel8": dict(nel=8, maxiter=5)}
# build_motor_model(record=True): the eager_r05 configuration of
# oracles/motor_oracle.py, one Simulator.run() in a temporary directory
RECORD = {"motor_record_r05": dict(refine=0.5, em_load_steps=2,
                                   linear_solver="scipy",
                                   shape_dv=[5e-4, 3e-4])}


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Captured:
    """Objects the script builds, kept by wrappers put into its module."""

    def __init__(self):
        self.sims, self.values = [], {}


def hook(mod, name, cap):
    """Wrap what the script builds so that its full-precision values can
    be read after main() returns."""
    if hasattr(mod, "Simulator"):
        cls = mod.Simulator

        def sim(*a, **kw):
            s = cls(*a, **kw)
            cap.sims.append(s)
            return s
        mod.Simulator = sim
    if name == "run_motor_opt":
        import femo_tpu.models.motor.model as mm

        build = mm.build_motor_jit_step

        def jit_step(*a, **kw):
            if kw.get("refine", 1) >= 4:
                kw["factorization"] = "block_thomas"
            cap.values["factorization"] = kw.get("factorization")
            return build(*a, **kw)
        return [(mm, "build_motor_jit_step", jit_step)]
    if name == "run_aeroelasticity_static":
        build = mod.build_wing_fsi

        def wing(*a, **kw):
            fsi = build(*a, **kw)
            solve = fsi["solve"]

            def recorded(*sa, **skw):
                out = solve(*sa, **skw)
                if "tip_disp" not in cap.values:
                    for k in ("tip_disp", "total_aero_force",
                              "total_mapped_force"):
                        cap.values[k] = np.asarray(out[k], float)
                return out
            fsi["solve"] = recorded
            return fsi
        mod.build_wing_fsi = wing
    if name in ("run_aeroelasticity_dynamic", "run_aeroelasticity_vpm"):
        cls = mod.DynamicShellFSI

        class Dyn(cls):
            def run(self, *a, **kw):
                hist = super().run(*a, **kw)
                cap.values["tip_disp"] = np.asarray(hist["tip_disp"], float)
                return hist
        mod.DynamicShellFSI = Dyn
    if name == "run_shell_modal":
        import femo_tpu.models.shell as sh

        modal = sh.shell_modal_analysis

        def recorded(*a, **kw):
            f, modes = modal(*a, **kw)
            cap.values[f"freq_{kw.get('method')}"] = np.asarray(f, float)
            return f, modes
        return [(sh, "shell_modal_analysis", recorded)]
    if name == "run_shape_opt_roof":
        grad, scal = mod.shape_gradient, mod.assemble_scalar
        cls = mod.RMShellModel

        class Shell(cls):
            """The script's shell; at its solve, the same roof is also
            solved exactly (dense LU) on a second shell, whose values are
            kept."""

            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self._args = (a, kw)
                cap.values["shell"] = self

            def solve(self, bcs, **kw):
                a, akw = self._args
                exact = cls(*a, **akw)
                exact.thickness.array = self.thickness.array
                exact.force.array = self.force.array
                from femo_tpu.fea.bc import DirichletBC

                spaces = {id(self.Vu): exact.Vu, id(self.Vth): exact.Vth}
                exact.solve([DirichletBC(spaces[id(b.space)], 0.0,
                                         dofs=b.dofs) for b in bcs],
                            solve_mode="jit_dense")
                cap.values["exact_deflection"] = roof_deflection(exact)
                cap.values["exact_compliance"] = float(
                    scal(exact.compliance_form))
                cap.values["exact_shape_grad"] = np.asarray(
                    grad(exact.compliance_form), float)
                return super().solve(bcs, **kw)

        def shape_gradient(*a, **kw):
            g = grad(*a, **kw)
            cap.values["shape_grad"] = np.asarray(g, float)
            return g

        def assemble_scalar(*a, **kw):
            v = scal(*a, **kw)
            cap.values["compliance"] = float(v)
            return v
        mod.RMShellModel, mod.shape_gradient = Shell, shape_gradient
        mod.assemble_scalar = assemble_scalar
    return []


def roof_deflection(shell):
    """run_shape_opt_roof.py's free-edge midspan deflection, unrounded."""
    R, L, phi_max = 25.0, 50.0, np.deg2rad(40.0)
    w = np.asarray(shell.u.array).reshape(-1, 3)[:, 2]
    c = shell.Vu.scalar_dof_coords
    tgt = np.array([R * np.sin(phi_max), L / 2, R * np.cos(phi_max)])
    return float(w[np.argmin(np.linalg.norm(c - tgt, axis=1))])


def run_script(key):
    name, argv = SCRIPTS[key]
    mod = load_example(name)
    cap = Captured()
    patches = hook(mod, name, cap)
    saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
    for m, a, fn in patches:
        setattr(m, a, fn)
    buf = io.StringIO()
    cwd, argv0 = os.getcwd(), sys.argv
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            sys.argv = [f"{name}.py"] + argv
            with minimize_log() as calls, contextlib.redirect_stdout(buf):
                mod.main()
    finally:
        os.chdir(cwd)
        sys.argv = argv0
        for m, a, fn in saved:
            setattr(m, a, fn)
    text = buf.getvalue()
    print(text, end="")
    vals = {f"{key}_stdout": text}
    if calls:
        vals.update(optimizer_values(key, calls))
    if cap.sims:
        sim = cap.sims[-1]
        for k, v in sim.outputs.items():
            a = np.asarray(v, float)
            if a.size == 1:
                vals[f"{key}_out_{k}"] = float(a.reshape(()))
        for k in sim.model.design_variables:
            vals[f"{key}_dv_{k}"] = np.asarray(sim.values[k], float)
    for k, v in cap.values.items():
        if k == "shell":
            vals[f"{key}_deflection"] = roof_deflection(v)
        elif v is not None:
            vals[f"{key}_{k}"] = v
    return vals, {"script": f"examples/{name}.py", "argv": argv}


def optimizer_values(key, calls):
    if len(calls) != 1:
        raise AssertionError(f"{key}: {len(calls)} minimize calls")
    c = calls[0]
    out = {f"{key}_f": np.asarray(c["f"]), f"{key}_x": c["x"],
           f"{key}_nfev": c["nfev"], f"{key}_nit": c["nit"],
           f"{key}_fun": c["fun"],
           f"{key}_method": c["method"]}
    if c["g0"] is not None:
        out[f"{key}_g0"] = c["g0"]
    print(f"{key}: {c['method']} nfev {c['nfev']} nit {c['nit']}, f "
          f"{c['f']!r}", flush=True)
    return out


def run_w1(key):
    from femo_tpu.graph.model import FEAModel
    from femo_tpu.graph.optimizer import LBFGSB, OptimizationProblem
    from femo_tpu.graph.simulator import Simulator
    from femo_tpu.models.poisson import build_fea

    c = W1[key]
    fea, d = build_fea(nel=c["nel"])
    model = FEAModel(fea=[fea])
    model.create_input("f", shape=d["W"].n_dofs, val=0.5)
    model.add_design_variable("f")
    model.add_objective("l2_functional", scaler=1e5)
    sim = Simulator(model)
    sim.run()
    prob = OptimizationProblem(sim, "poisson_lbfgsb")
    with minimize_log() as calls:
        LBFGSB(prob, maxiter=c["maxiter"]).solve()
    vals = optimizer_values(key, calls)
    vals[f"{key}_obj"] = np.array([h["obj"] for h in prob.history])
    vals[f"{key}_out_l2_functional"] = float(sim.outputs["l2_functional"])
    return vals, dict(c, api="build_fea -> FEAModel(f=0.5, scaler 1e5) -> "
                      "Simulator -> OptimizationProblem -> LBFGSB")


def run_record(key):
    import h5py

    from femo_tpu.graph.simulator import Simulator
    from femo_tpu.models.motor.model import build_motor_model
    from femo_tpu.solvers.linear import LinearSolver

    c = RECORD[key]
    cwd = os.getcwd()
    vals = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            model, _ = build_motor_model(
                refine=c["refine"], em_load_steps=c["em_load_steps"],
                linear_solver=LinearSolver(method=c["linear_solver"]),
                record=True)
            sim = Simulator(model)
            sim["shape_dv"] = np.array(c["shape_dv"])
            sim.run()
            model.recorder.close()
            base = os.path.join(tmp, "records_motor", "record_B_magnitude")
            vals[f"{key}_files"] = json.dumps(sorted(
                os.listdir(os.path.join(tmp, "records_motor"))))
            vals[f"{key}_xdmf"] = open(base + ".xdmf").read()
            with h5py.File(base + ".h5", "r") as f:
                f.visititems(lambda n, o: vals.__setitem__(
                    f"{key}_h5/{n}", o[()]) if isinstance(o, h5py.Dataset)
                    else None)
    finally:
        os.chdir(cwd)
    print(f"{key}: {sorted(vals)}", flush=True)
    return vals, dict(c, api="build_motor_model(record=True) -> "
                      "Simulator.run()")


def main(names):
    keys = list(SCRIPTS) + list(W1) + list(RECORD)
    unknown = set(names) - set(keys)
    if unknown:
        raise SystemExit(f"unknown entries {sorted(unknown)}; known: {keys}")
    values = {}
    if os.path.exists(OUT):
        with np.load(OUT) as old:
            values.update({k: old[k] for k in old.files})
    for key in keys:
        if names and key not in names:
            continue
        t0 = time.time()
        vals, cfg = (run_w1(key) if key in W1 else run_record(key)
                     if key in RECORD else run_script(key))
        vals[f"{key}_config"] = json.dumps(cfg)
        vals[f"{key}_seconds"] = time.time() - t0
        values = {k: v for k, v in values.items()
                  if not k.startswith(f"{key}_")}
        values.update(vals)
        np.savez_compressed(OUT, **values)
        print(f"  {key}: {vals[f'{key}_seconds']:.1f} s; wrote {OUT}",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
