"""Parity of the port's W1 Poisson source-control optimization through the
graph API (femo_tpu_torch.models.poisson, fea.fea, graph.*) with the
JAX package, f64, CPU.

Both packages build W1 (CG1 state, DG0 control, strong BCs, L2 tracking
+ Tikhonov) on the same mesh and run `Simulator.run` and
`compute_totals` at f = 0.5, through the dense path (nel=8) and through
BiCGStab + Jacobi (nel=12, forced with `fea.linear_solver`).  Dense: the
same LU solve, loss to 1e-12 and gradient to 1e-10.  BiCGStab: both stop
at the 1e-12 Krylov tolerance, whose residual each package reaches by
its own rounding, so loss to 1e-9 and gradient to 1e-7.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from femo_tpu.fea import (
    FormDef as JFormDef, Function as JFunction, dx as jdx,
    assemble_vector as jassemble_vector, errorNorm as jerror_norm)
from femo_tpu.graph.model import FEAModel as JFEAModel
from femo_tpu.graph.optimizer import (
    OptimizationProblem as JProblem, SLSQP as JSLSQP)
from femo_tpu.graph.simulator import Simulator as JSimulator
from femo_tpu.models.poisson import build_fea as jbuild_fea
from femo_tpu.solvers.linear import LinearSolver as JLinearSolver

import femo_tpu_torch
from femo_tpu_torch.config import config
from femo_tpu_torch.convert import (
    array_from_jax, function_from_jax, step_inputs)
from femo_tpu_torch.fea.bc import bc_arrays
from femo_tpu_torch.fea.assemble import assemble_vector
from femo_tpu_torch.fea.forms import FormDef, GlobalCoefficient, dx
from femo_tpu_torch.fea.space import Function, FunctionSpace
from femo_tpu_torch.fea.utils import errorNorm
from femo_tpu_torch.graph.implicit import ImplicitSolveOp
from femo_tpu_torch.graph.model import FEAModel, Model
from femo_tpu_torch.graph.optimizer import OptimizationProblem, SLSQP
from femo_tpu_torch.graph.simulator import Simulator
from femo_tpu_torch.mesh.generators import create_unit_square_mesh
from femo_tpu_torch.models.motor.model import build_motor_jit_step
from femo_tpu_torch.models.poisson import build_fea, build_jit_opt_step
from femo_tpu_torch.solvers.linear import LinearSolver

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PI = np.pi
# (nel, forced LinearSolver method or None, loss tol, gradient tol)
CASES = {"dense": (8, None, 1e-12, 1e-10),
         "bicgstab": (12, "bicgstab", 1e-9, 1e-7)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _sim(build, FM, Sim, LS, nel, method, **kw):
    fea, d = build(nel=nel, **kw)
    if method is not None:
        fea.linear_solver = LS(method=method)
    model = FM(fea=[fea])
    model.create_input("f", shape=d["W"].n_dofs, val=0.5)
    model.add_design_variable("f")
    model.add_objective("l2_functional", scaler=1e5)
    return Sim(model), d


@pytest.fixture(scope="module")
def w1():
    """Both packages' W1 runs and totals for every case, made once."""
    out = {}
    for case, (nel, method, _, _) in CASES.items():
        js, jd = _sim(jbuild_fea, JFEAModel, JSimulator, JLinearSolver,
                      nel, method)
        ts, td = _sim(build_fea, FEAModel, Simulator, LinearSolver, nel,
                      method, device="cpu")
        js.run()
        ts.run()
        jg = js.compute_totals("l2_functional", "f")[("l2_functional", "f")]
        tg = ts.compute_totals("l2_functional", "f")[("l2_functional", "f")]
        out[case] = dict(js=js, jd=jd, ts=ts, td=td, jg=np.asarray(jg),
                         tg=tg.numpy())
    return out


def test_dg0_space_and_interpolation_match_jax(w1):
    jd, td = w1["dense"]["jd"], w1["dense"]["td"]
    np.testing.assert_array_equal(td["W"].dofmap, jd["W"].dofmap)
    np.testing.assert_array_equal(td["W"].scalar_dof_coords,
                                  jd["W"].scalar_dof_coords)
    for name in ("u_ex", "f_ex"):
        np.testing.assert_array_equal(td[name].array.numpy(),
                                      np.asarray(jd[name].array))
    f = function_from_jax(jd["f_ex"], td["W"])
    assert f.name == "f_ex"
    np.testing.assert_array_equal(f.array.numpy(),
                                  np.asarray(jd["f_ex"].array))


@pytest.mark.parametrize("case", list(CASES))
def test_run_and_totals_match_jax(w1, case):
    _, _, ltol, gtol = CASES[case]
    r = w1[case]
    jl, tl = float(r["js"]["l2_functional"]), float(r["ts"]["l2_functional"])
    assert abs(tl - jl) / abs(jl) < ltol
    assert _rel(r["ts"]["u"], r["js"]["u"]) < gtol
    assert _rel(r["tg"], r["jg"]) < gtol


@pytest.mark.parametrize("case", list(CASES))
def test_objective_gradient_is_the_run_and_totals(w1, case):
    """objective_gradient returns the run's loss and compute_totals'
    gradient, and (pure mode) leaves the state's warm start as run()
    left it."""
    ts, td = w1[case]["ts"], w1[case]["td"]
    u_before = td["u"].array.clone()
    val, grads, out = ts.objective_gradient("l2_functional", ["f"])
    assert abs(float(val) - float(ts["l2_functional"])) \
        <= 1e-12 * abs(float(val))
    assert _rel(grads["f"].numpy(), w1[case]["tg"]) < 1e-10
    assert torch.equal(td["u"].array, u_before)
    assert set(out) >= {"f", "u", "l2_functional"}


def test_manufactured_solution():
    """tests/test_poisson_opt.py's forward solve at nel=16: -lap(u) = f
    with the sin-sin source; errorNorm < 5e-3 and, in L2 and H1, equal to
    the JAX package's to 1e-10."""
    src = lambda x: np.sin(PI * x[0]) * np.sin(PI * x[1])  # noqa: E731
    jfea, jd = jbuild_fea(nel=16)
    jf = JFunction(jd["f"].space).interpolate(src)
    jfea.solve("u", {"f": jf.array})
    fea, d = build_fea(nel=16, device="cpu")
    f = Function(d["W"]).interpolate(src)
    fea.solve("u", {"f": f.array})
    assert errorNorm(d["u_ex"], d["u"]) < 5e-3
    for norm in ("L2", "H1"):
        jerr = jerror_norm(jd["u_ex"], jd["u"], norm)
        assert abs(errorNorm(d["u_ex"], d["u"], norm) - jerr) <= 1e-10 * jerr


@pytest.mark.parametrize("opts", [
    {"line_search": "bt"}, {"damping": 0.5}, {"PDE_SOLVER": "SNES"},
    {"custom_solve": True}])
def test_newton_options_match_jax(opts):
    """The host Newton loop's options (backtracking, damping, the SNES
    flag, a custom_solve hook calling op.newton) give the JAX package's
    state at nel=4, and evaluate_output its output."""
    us, outs = [], []
    for build, kw in ((jbuild_fea, {}), (build_fea, {"device": "cpu"})):
        fea, d = build(nel=4, **kw)
        if "PDE_SOLVER" in opts:
            fea.PDE_SOLVER = opts["PDE_SOLVER"]
        elif "custom_solve" in opts:
            fea.custom_solve = lambda op, p, u0: op.newton(p, u0)[0]
        else:
            fea.newton_opts = dict(opts)
        fea.inputs_dict["f"]["function"].set(0.5)
        fea.solve("u")
        us.append(np.asarray(d["u"].array))
        outs.append(float(fea.evaluate_output("l2_functional")))
    assert _rel(us[1], us[0]) < 1e-12
    assert abs(outs[1] - outs[0]) <= 1e-12 * abs(outs[0])


def test_assemble_vector_matches_jax(w1):
    """The W1 residual at the converged state, through assemble_vector."""
    jd, td = w1["dense"]["jd"], w1["dense"]["td"]
    jform = w1["dense"]["js"].model.fea_list[0].states_dict["u"][
        "residual_form"]
    form = w1["dense"]["ts"].model.fea_list[0].states_dict["u"][
        "residual_form"]
    u = np.array(jd["u"].array)
    r = assemble_vector(form, {"u": torch.as_tensor(u)}).numpy()
    jr = np.asarray(jassemble_vector(jform, {"u": jd["u"].array}))
    assert np.linalg.norm(r - jr) <= 1e-12 * np.linalg.norm(jr)


def test_check_totals_matches_finite_differences():
    sim, _ = _sim(build_fea, FEAModel, Simulator, LinearSolver, 6, None,
                  device="cpu")
    sim.run()
    report = sim.check_totals("l2_functional", "f", step=1e-7,
                              compact_print=False)
    assert report[("l2_functional", "f")]["rel_error"] < 1e-6


@pytest.mark.parametrize("constrained", [False, True])
def test_slsqp_iterations_match_jax(constrained):
    """Two SLSQP iterations from the same start (nel=8; nel=4 with a lower
    bound on the objective as an inequality constraint): every objective
    evaluation agrees with the JAX run's to 1e-9 relative (gradients
    agree to ~1e-15, so scipy takes the same steps)."""
    objs = []
    for build, FM, Sim, Prob, Opt, kw in (
            (jbuild_fea, JFEAModel, JSimulator, JProblem, JSLSQP, {}),
            (build_fea, FEAModel, Simulator, OptimizationProblem, SLSQP,
             {"device": "cpu"})):
        sim, _ = _sim(build, FM, Sim, None, 4 if constrained else 8, None,
                      **kw)
        if constrained:
            sim.model.add_constraint("l2_functional", lower=1e-5,
                                     scaler=1e5)
        sim.run()
        prob = Prob(sim, "poisson_opt")
        Opt(prob, ftol=1e-13, maxiter=2).solve()
        objs.append(np.array([h["obj"] for h in prob.history]))
    assert len(objs[0]) == len(objs[1]) >= 3
    assert _rel(objs[1], objs[0]) < 1e-9
    assert objs[1][-1] < objs[1][0]


def test_check_first_derivatives():
    """The optimizer-side FD check in three seeded directions at nel=6:
    forward differences (step 1e-6 on the scaled variables) differ from
    the adjoint gradient by ~1.1e-5, their truncation error, in both
    packages alike."""
    reports = []
    for build, FM, Sim, Prob, kw in (
            (jbuild_fea, JFEAModel, JSimulator, JProblem, {}),
            (build_fea, FEAModel, Simulator, OptimizationProblem,
             {"device": "cpu"})):
        sim, _ = _sim(build, FM, Sim, None, 6, None, **kw)
        sim.run()
        prob = Prob(sim, "poisson_opt")
        reports.append(prob.check_first_derivatives(step=1e-6,
                                                    compact_print=False))
        assert prob.history == []  # probes are not design iterations
    jrel, rel = reports[0]["objective"], reports[1]["objective"]
    assert rel < 2e-5
    assert abs(rel - jrel) <= 1e-6 * jrel


def _mesh():
    return create_unit_square_mesh(2)


@pytest.mark.parametrize("entry", [
    lambda: FunctionSpace(_mesh(), ("CG", 1)),
    lambda: GlobalCoefficient("g", 1.0),
    lambda: bc_arrays([], 3),
    lambda: build_fea(nel=2),
    lambda: Model(),
    lambda: array_from_jax(np.zeros(3)),
    lambda: step_inputs(np.zeros(2), 0.0),
    lambda: build_motor_jit_step(refine=0.5),
])
def test_default_device_is_the_card(entry):
    """Entry points default to config.device, the card: on a machine
    without one the call fails; it never runs on the CPU instead."""
    assert config.device == "cuda"
    if torch.cuda.is_available():
        assert femo_tpu_torch.get_device().type == "cuda"
        entry()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


def test_unported_options_raise():
    # weak_bc is ported (tests/test_torch_weak_bc.py); sharded assembly
    # takes a RankMesh (tests/test_torch_sharding.py)
    with pytest.raises(TypeError, match="device_mesh"):
        build_jit_opt_step(nel=2, device_mesh=object(), device="cpu")
    fea, d = build_fea(nel=2, device="cpu")
    # a field output needs its CG1 test space
    with pytest.raises(ValueError, match="test space"):
        fea.add_field_output("p", FormDef([dx(lambda w, g: w.u)],
                                          coeffs=[d["u"]]), ["u"])
    with pytest.raises(ValueError, match="jit_dense"):
        ImplicitSolveOp(None, "u", ["f"], None, None, mode="jit")


def test_jit_dense_mode_and_field_output_match_jax():
    """solve_mode="jit_dense" (a fixed-count dense-LU Newton, one
    iteration for this linear problem) gives the eager solve's state and
    the JAX package's (1e-12); a field output projecting the state to CG1
    gives the JAX package's (1e-12) and persists on its Function."""
    f = np.random.default_rng(4).standard_normal(2 * 6 * 6)
    fea, d = build_fea(nel=6, device="cpu")
    u_eager = fea.solve("u", {"f": torch.as_tensor(f)}).numpy()
    outs = []
    for lib, build, FD, dx_, Model_, arr in (
            ("port", lambda: build_fea(nel=6, device="cpu"), FormDef, dx,
             FEAModel, torch.as_tensor),
            ("jax", lambda: jbuild_fea(nel=6), JFormDef, jdx, JFEAModel,
             jnp.asarray)):
        fea2, d2 = build()
        fea2.solve_mode = "jit_dense"
        fea2.add_field_output(
            "u_cg1", FD([dx_(lambda w, g: w.u * w.u * w.v)],
                        coeffs=[d2["u"]], test=d2["V"]), ["u"])
        out = Model_(fea=[fea2]).evaluate({"f": arr(f)})
        outs.append((np.asarray(out["u"]), np.asarray(out["u_cg1"]),
                     fea2.outputs_field_dict["u_cg1"]["func"].array))
    (u, p, pf), (ju, jp, _) = outs
    assert np.linalg.norm(u - ju) <= 1e-12 * np.linalg.norm(ju)
    assert np.linalg.norm(u - u_eager) <= 1e-12 * np.linalg.norm(ju)
    assert np.linalg.norm(p - jp) <= 1e-12 * np.linalg.norm(jp)
    np.testing.assert_array_equal(pf.numpy(), p)


def test_w1_modules_import_no_jax():
    code = ("import sys\n"
            "import femo_tpu_torch.models.poisson, "
            "femo_tpu_torch.graph.simulator, femo_tpu_torch.graph.optimizer, "
            "femo_tpu_torch.fea.utils, femo_tpu_torch.ops.spmv, "
            "femo_tpu_torch.models.fsi\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'femo_tpu.')) or m == 'femo_tpu']\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
