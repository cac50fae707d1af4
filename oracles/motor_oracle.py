"""The JAX package's f64 reference values for the motor configurations
that chip_smoke.py drives in the PyTorch/CUDA port beyond the oracle
configuration of experiments/motor_latency_oracle.json.

    JAX_PLATFORMS=cpu PYTHONPATH=. python oracles/motor_oracle.py [name ...]

Runs femo_tpu (CPU, f64) and writes oracles/motor_oracle.npz: for each
configuration below the loss, g_dv and g_iq of one motor step at its dv0
and iq0 (`<name>_loss`, `<name>_g_dv`, `<name>_g_iq`), and `configs`, the
keyword arguments of each as JSON.

* r1_re3, r4_re3: bench.py's ladder configuration at refine 1 and 4 —
  block Thomas with Shamanskii factor reuse (`refactor_every=3`), edge
  deltas, 3 EM load steps, 3+3 Newton iterations, 8 PCG iterations.
* r1_re3_freeze: bench.py's refine-1 rung, the same with
  `freeze_operator=True` (refine 1 only, as bench.py gates it).
* r4_cr: the configuration of experiments/motor_latency_oracle.json at
  refine 4 with block cyclic reduction (`factor_method="cr"`) in place of
  the block-Thomas factor.
* r1_lu: the dense-LU branch (`factorization="lu"`) at refine 1, the same
  counts.
* r1_basis: the 2-dof design space at refine 1, block Thomas,
  `refactor_every=1`.
* unstructured_r1: the step on the unstructured mesh of
  `write_motor_msh(refine=1, seed=0)` read back by `import_mesh`, in the
  configuration of experiments/motor_latency_oracle.json.
* eager_r1: the eager graph model `build_motor_model(refine=1,
  em_load_steps=3)` with `LinearSolver(method="scipy")` at shape_dv =
  (5e-4, 3e-4): the outputs of `Simulator.run()` (`eager_r1_<output>`,
  the |B| field as `eager_r1_B_magnitude`) and
  `objective_gradient("loss_sum", ["shape_dv", "iq"])`.
* r05_re3, r05_re3_freeze, r05_lu and eager_r05: the same at refine 0.5
  (the eager model with 2 EM load steps), the port's CPU tests'
  reference values (tests/test_torch_motor.py,
  tests/test_torch_motor_model.py): compiling these JAX configurations
  takes longer than the tests' time allows.

Each configuration is saved as soon as it is done, refine 4 last.  Named
configurations are recomputed and the others of the file kept.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from femo_tpu.graph.simulator import Simulator  # noqa: E402
from femo_tpu.mesh.gmsh_io import import_mesh  # noqa: E402
from femo_tpu.models.motor.model import (  # noqa: E402
    build_motor_jit_step, build_motor_model)
from femo_tpu.models.motor.unstructured import write_motor_msh  # noqa: E402
from femo_tpu.solvers.linear import LinearSolver  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "motor_oracle.npz")
BENCH = dict(em_load_steps=3, mm_newton_iters=3, em_newton_iters=3,
             factorization="block_thomas", pcg_iters=8,
             design_space="edge_deltas", refactor_every=3)
ORACLE_CFG = dict(BENCH, refactor_every=1)
STEPS = {
    "r05_re3": dict(BENCH, refine=0.5),
    "r05_re3_freeze": dict(BENCH, refine=0.5, freeze_operator=True),
    "r05_lu": dict(BENCH, refine=0.5, factorization="lu", refactor_every=1),
    "r1_re3": dict(BENCH, refine=1),
    "r1_re3_freeze": dict(BENCH, refine=1, freeze_operator=True),
    "r1_lu": dict(BENCH, refine=1, factorization="lu", refactor_every=1),
    "r1_basis": dict(ORACLE_CFG, refine=1, design_space="basis"),
    "unstructured_r1": dict(ORACLE_CFG, mesh="write_motor_msh(refine=1, "
                            "seed=0)"),
    "r4_re3": dict(BENCH, refine=4),
    "r4_cr": dict(ORACLE_CFG, refine=4, factor_method="cr"),
}
EAGER = {
    "eager_r05": dict(refine=0.5, em_load_steps=2, linear_solver="scipy",
                      shape_dv=[5e-4, 3e-4]),
    "eager_r1": dict(refine=1, em_load_steps=3, linear_solver="scipy",
                     shape_dv=[5e-4, 3e-4]),
}
OUTPUTS = ("loss_sum", "torque", "magnet_area", "winding_area",
           "steel_area", "eddy_current_loss", "hysteresis_loss")


def step_values(name, kw):
    kw = dict(kw)
    if "mesh" in kw:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "motor_u.msh")
            write_motor_msh(path, refine=1, seed=0)
            kw["mesh"] = import_mesh(path)
    step, (dv0, iq0), info = build_motor_jit_step(**kw)
    loss, (g_dv, g_iq) = step(dv0, iq0)
    out = {f"{name}_loss": float(loss), f"{name}_g_dv": np.asarray(g_dv),
           f"{name}_g_iq": float(g_iq)}
    print(f"{name}: loss {float(loss)!r}, |g_dv| "
          f"{np.linalg.norm(np.asarray(g_dv)):.12e} ({g_dv.shape[0]}), "
          f"g_iq {float(g_iq)!r}, bt {info.get('bt')}", flush=True)
    return out


def eager_values(name, kw):
    model, _ = build_motor_model(
        refine=kw["refine"], em_load_steps=kw["em_load_steps"],
        linear_solver=LinearSolver(method=kw["linear_solver"]))
    sim = Simulator(model)
    sim["shape_dv"] = np.array(kw["shape_dv"])
    out = sim.run()
    vals = {f"{name}_{k}": float(out[k]) for k in OUTPUTS}
    vals[f"{name}_B_magnitude"] = np.asarray(out["B_magnitude"])
    val, grads, _ = sim.objective_gradient("loss_sum", ["shape_dv", "iq"])
    vals[f"{name}_loss"] = float(val)
    vals[f"{name}_g_dv"] = np.asarray(grads["shape_dv"])
    vals[f"{name}_g_iq"] = float(grads["iq"])
    print(f"{name}: {({k: vals[k] for k in vals if np.ndim(vals[k]) == 0})}"
          f", g_dv {vals[f'{name}_g_dv']!r}", flush=True)
    return vals


def main(names):
    configs = dict(STEPS, **EAGER)
    unknown = set(names) - set(configs)
    if unknown:
        raise SystemExit(f"unknown configurations {sorted(unknown)}; known: "
                         f"{list(configs)}")
    values = {"configs": json.dumps(configs)}
    seconds = {}
    if names and os.path.exists(OUT):
        with np.load(OUT) as old:
            values.update({k: old[k] for k in old.files
                           if k not in ("configs", "seconds")})
            seconds = json.loads(str(old["seconds"]))
    refine4 = [n for n in STEPS if n.startswith("r4_")]
    jobs = [(n, lambda n=n: step_values(n, STEPS[n])) for n in STEPS
            if n not in refine4]
    jobs += [(n, lambda n=n: eager_values(n, EAGER[n])) for n in EAGER]
    jobs += [(n, lambda n=n: step_values(n, STEPS[n])) for n in refine4]
    for name, fn in jobs:
        if names and name not in names:
            continue
        t0 = time.time()
        values.update(fn())
        seconds[name] = time.time() - t0
        values["seconds"] = json.dumps(seconds)
        np.savez(OUT, **values)
        print(f"  {name}: {seconds[name]:.1f} s; wrote {OUT}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
