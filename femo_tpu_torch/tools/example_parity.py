"""Hold a run of one of the port's scripts (femo_tpu_torch/examples/) to the
JAX package's run of its own script at the same arguments, read from
oracles/examples_oracle.npz (written by oracles/examples_oracle.py).
Used by tests/test_torch_examples.py on the CPU and by chip_smoke.py's
`run_scripts` phase on the card.

    oracle = load_oracle()
    res, calls = run_example(oracle, "poisson")
    errors = check_example(oracle, "poisson", res, calls)  # raises if off

Bars: where the script optimizes, the evaluation count is equal, every
objective value (as the optimizer sees it) within 1e-8 and the final
design within 1e-6, relative in the 2-norm; the values the script returns
are held at 1e-8 (scalars) and 1e-6 (vectors, the first gradient); the
eager motor's loss and evaluations at 1e-7.  The eager motor runs one
SLSQP iteration (motor_snopt_r1): after it both shape variables sit near
their bound, and a second step frees one of them by ~1e-7, which one
following from differences far below the bars.  Two scripts cannot be
held whole, in either package, and are held to what their runs do fix:

* topo: SLSQP's first step puts most densities on their bounds, where a
  last-bit difference in the volume constraint (active at the start)
  moves the step; from there on no two implementations follow one path.
  Held: the first evaluation (1e-8), its gradient (1e-6), and the port's
  compliance at the JAX run's final design against the JAX run's (1e-8).
* roof: the script solves the shell with one unpolished block-Thomas
  step, which is off the system's exact solution by 6e-5 to 2e-4 in both
  packages.  Held, as tools/shell_parity.py does for the shell: each
  value within 10x the JAX package's own spread between that solve and
  its exact (dense LU) solve of the same system.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os

import numpy as np

from .minimize_log import minimize_log

ORACLE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "oracles", "examples_oracle.npz")

# oracle key -> {value the port's main returns: (oracle suffix, kind)};
# kind "s": a scalar, "v": a vector (BARS); "spread": 10x the JAX
# package's spread between the script's solve and its exact solve (oracle
# `<key>_exact_<suffix>`), at least 1e-12
CHECKS = {
    "poisson": {"objective": ("out_l2_functional", "s")},
    "poisson32": {"objective": ("out_l2_functional", "s")},
    "nonlinear_poisson": {"objective": ("out_J", "s")},
    "topo": {"compliance": ("out_compliance", "s"),
             "avg_density": ("out_avg_density", "s")},
    "beam": {"compliance": ("out_compliance", "s"),
             "thickness": ("dv_thickness", "v")},
    "shell_thickness": {"mass": ("out_mass", "s"),
                        "tip_disp": ("out_tip_disp", "s"),
                        "pnorm_stress": ("out_pnorm_stress", "s"),
                        "thickness": ("dv_thickness", "v")},
    "shell_modal": {"freq_dense": ("freq_dense", "v"),
                    "freq_lanczos": ("freq_lanczos", "v")},
    "roof": {"deflection": ("deflection", "spread"),
             "compliance": ("compliance", "spread"),
             "shape_grad": ("shape_grad", "spread")},
    "aero_static": {"tip_disp": ("tip_disp", "s"),
                    "total_aero_force": ("total_aero_force", "v"),
                    "total_mapped_force": ("total_mapped_force", "v")},
    "aero_dynamic": {"tip_disp": ("tip_disp", "v")},
    "aero_vpm": {"tip_disp": ("tip_disp", "v")},
    # --jit: dense LU on the CPU, as the JAX script picks there
    "motor_jit_r05": {"losses": ("f", "v"), "loss": ("fun", "s"),
                      "evaluations": ("nfev", "s")},
    # the eager motor through SNOPT's SLSQP fallback (on the card): loss
    # 1e-7, design 1e-6
    "motor_snopt_r1": {"loss_sum": ("out_loss_sum", "s7"),
                       "shape_dv": ("dv_shape_dv", "v"),
                       "iq": ("dv_iq", "v")},
}
BARS = {"s": 1e-8, "s7": 1e-7, "v": 1e-6}
# scripts whose optimizer path is held only over its first evaluations
# (how many), then at the JAX run's final design (`at_jax_design`)
FIRST_STEP_ONLY = {"topo": 1}
# check_optimizer's bars where they differ from its defaults
OPT_BARS = {"motor_snopt_r1": {"f": 1e-7}}


def load_oracle(path: str = ORACLE) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def rel(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def config(oracle, key) -> dict:
    return json.loads(str(oracle[f"{key}_config"]))


def run_example(oracle, key, argv=None):
    """The port's script of an oracle entry, at the entry's arguments (or
    `argv`); returns (what main returns, the optimizer records)."""
    cfg = config(oracle, key)
    name = os.path.splitext(os.path.basename(cfg["script"]))[0]
    mod = importlib.import_module(f"femo_tpu_torch.examples.{name}")
    with minimize_log() as calls:
        res = mod.main(list(cfg["argv"] if argv is None else argv))
    return res, calls


def check_optimizer(oracle, key, calls, bars=None) -> dict:
    """The optimizer's run against the entry's: evaluation count, every
    objective value, the first gradient and the final point.  `bars`
    overrides {"f": 1e-8, "g0": 1e-6, "x": 1e-6}; raises if one is
    missed, returns the readings."""
    bars = dict({"f": 1e-8, "g0": 1e-6, "x": 1e-6}, **(bars or {}))
    if f"{key}_nfev" not in oracle:
        if calls:
            raise AssertionError(f"{key}: the JAX script ran no optimizer")
        return {}
    if len(calls) != 1:
        raise AssertionError(f"{key}: {len(calls)} optimizer runs")
    c = calls[0]
    if key in FIRST_STEP_ONLY:
        return check_first_step(oracle, key, c, bars)
    if c["method"] != str(oracle[f"{key}_method"]):
        raise AssertionError(f"{key}: method {c['method']}")
    want_f = np.asarray(oracle[f"{key}_f"])
    if c["nfev"] != int(oracle[f"{key}_nfev"]):
        raise AssertionError(f"{key}: {c['nfev']} evaluations, JAX "
                             f"{int(oracle[f'{key}_nfev'])}; f {c['f']} vs "
                             f"{list(want_f)}")
    f_rel = np.abs(np.array(c["f"]) - want_f) / np.maximum(np.abs(want_f),
                                                           1e-300)
    out = {"nfev": c["nfev"], "f": float(f_rel.max()),
           "f_first": float(f_rel[0]),
           "x": rel(c["x"], oracle[f"{key}_x"])}
    if f"{key}_g0" in oracle:
        out["g0"] = rel(c["g0"], oracle[f"{key}_g0"])
    missed = {k: v for k, v in out.items() if k in bars and v > bars[k]}
    if missed:
        raise AssertionError(f"{key}: optimizer run off the JAX run's "
                             f"{missed} (bars {bars}); f {c['f']} vs "
                             f"{list(want_f)}")
    return out


def check_first_step(oracle, key, c, bars) -> dict:
    """The first FIRST_STEP_ONLY[key] evaluations and the first gradient
    against the JAX run's; the rest of the path is compared by
    `at_jax_design`.  Readings of the whole path are returned beside
    them, unchecked."""
    n = FIRST_STEP_ONLY[key]
    want_f = np.asarray(oracle[f"{key}_f"])
    head = np.abs(np.array(c["f"][:n]) - want_f[:n]) / np.abs(want_f[:n])
    out = {"f_first": float(head.max()),
           "g0": rel(c["g0"], oracle[f"{key}_g0"]),
           "path_nfev": [c["nfev"], int(oracle[f"{key}_nfev"])],
           "path_f_last": [c["f"][-1], float(want_f[-1])],
           "path_f_last_rel": abs(c["f"][-1] - want_f[-1]) / abs(want_f[-1]),
           "path_x": rel(c["x"], oracle[f"{key}_x"])}
    if not (len(c["f"]) >= n and out["f_first"] <= bars["f"]
            and out["g0"] <= bars["g0"]):
        raise AssertionError(f"{key}: first evaluation off the JAX run's: "
                             f"{out} (bars {bars})")
    return out


def at_jax_design(oracle, key) -> float:
    """The port's model at the JAX run's final design: its objective
    output relative to the JAX run's there (topo: compliance)."""
    from ..graph.simulator import Simulator
    from ..models.topopt import build_topopt_model

    if key != "topo":
        raise ValueError(f"{key}: no model at the JAX run's design")
    a = config(oracle, key)["argv"]
    arg = dict(zip(a[0::2], a[1::2]))
    model, fea, _ = build_topopt_model(int(arg["--nelx"]),
                                       int(arg["--nely"]))
    fea.solve_mode = "jit_dense"
    sim = Simulator(model)
    sim["density_unfiltered"] = np.asarray(oracle[f"{key}_x"])
    out = "compliance"
    got = float(sim.run()[out])
    want = float(oracle[f"{key}_out_{out}"])
    return abs(got - want) / abs(want)


@contextlib.contextmanager
def first_evaluation(module):
    """Within the block, the script module's SLSQP stops at its first
    evaluation: scipy's SLSQP with maxiter=0 and no constraint evaluates
    the objective and its gradient at x0 once; the model then runs at x0,
    as SLSQP.solve ends (the shell thickness script: its 25 iterations of
    host Newton take minutes).  That evaluation is the first of the JAX
    package's whole run: `check_prefix` holds it."""
    cls = module.SLSQP

    class FirstEvaluation(cls):
        def solve(self):
            from scipy.optimize import minimize

            prob = self.prob
            self.result = minimize(prob.objective_and_grad, prob.x0,
                                   jac=True, method="SLSQP",
                                   options={"maxiter": 0})
            prob._set_x(self.result.x)
            prob.sim.run()
            return self.result

    module.SLSQP = FirstEvaluation
    try:
        yield
    finally:
        module.SLSQP = cls


def check_prefix(oracle, key, calls) -> dict:
    """A run stopped early against the first evaluations of the JAX
    package's whole run: each objective (1e-8), the first gradient
    (1e-6)."""
    (c,) = calls
    want = np.asarray(oracle[f"{key}_f"])
    n = c["nfev"]
    if not 1 <= n < len(want):
        raise AssertionError(f"{key}: {n} evaluations")
    f_rel = np.abs(np.array(c["f"]) - want[:n]) / np.abs(want[:n])
    out = {"nfev": n, "f": float(f_rel.max()),
           "g0": rel(c["g0"], oracle[f"{key}_g0"])}
    if not (out["f"] <= 1e-8 and out["g0"] <= 1e-6):
        raise AssertionError(f"{key}: first evaluations off the JAX run's: "
                             f"{out}; f {c['f']} vs {list(want[:n])}")
    return out


def check_example(oracle, key, res, calls) -> dict:
    """check_optimizer, then every value of CHECKS[key] against the JAX
    script's; raises if one is off, returns the readings."""
    out = check_optimizer(oracle, key, calls, OPT_BARS.get(key))
    if key in FIRST_STEP_ONLY:
        out["at_jax_design"] = at_jax_design(oracle, key)
        bar = OPT_BARS.get(key, {}).get("f", BARS["s"])
        if not out["at_jax_design"] <= bar:
            raise AssertionError(f"{key}: the objective at the JAX run's "
                                 f"final design off by "
                                 f"{out['at_jax_design']:.3e} (bar {bar:.0e})")
        return out
    for name, (suffix, kind) in CHECKS[key].items():
        want = oracle[f"{key}_{suffix}"]
        e = rel(res[name], want)
        out[name] = e
        bar = BARS.get(kind)
        if kind == "spread":
            bar = max(10 * rel(want, oracle[f"{key}_exact_{suffix}"]), 1e-12)
            out[f"{name}_bar"] = bar
        if not e <= bar:
            raise AssertionError(
                f"{key}: {name} {res[name]!r} vs JAX {want!r}: rel {e:.3e} "
                f"(bar {bar:.0e})")
    return out
